"""20 Newsgroups + GloVe helpers with the reference python binding's API
(``bigdl_tpu/dataset/news20.py``).

Parity: ``dl/src/main/python/dataset/news20.py`` (``get_news20`` returning
``[(text, label)]`` with 1-based labels from sorted class directories,
``get_glove_w2v`` yielding a word->vector dict).  Download is delegated to
``base.maybe_download`` (local-first; see there for offline behavior).

Companion helpers for the conv text classifier
(``example/textclassification.py``, which reads staged files from its
``baseDir`` directly) and for notebook-style use of the reference's
20-Newsgroups recipe.
"""

from __future__ import annotations

import os
import tarfile
import tempfile
import zipfile
from typing import Dict, List, Tuple

import numpy as np

from bigdl_tpu_torch.dataset import base

NEWS20_URL = ("http://qwone.com/~jason/20Newsgroups/"
              "20news-19997.tar.gz")
GLOVE_URL = "http://nlp.stanford.edu/data/glove.6B.zip"

CLASS_NUM = 20


def download_news20(dest_dir: str) -> str:
    """Ensure the extracted ``20_newsgroup`` tree exists under
    ``dest_dir``; returns the extracted directory."""
    archive = base.maybe_download("20news-19997.tar.gz", dest_dir,
                                  NEWS20_URL)
    extracted = os.path.join(dest_dir, "20_newsgroup")
    if not os.path.exists(extracted):
        with tarfile.open(archive, "r:gz") as tar:
            tar.extractall(dest_dir, filter="data")
        # canonical archive extracts to 20_newsgroups; normalise the name
        alt = os.path.join(dest_dir, "20_newsgroups")
        if not os.path.exists(extracted) and os.path.exists(alt):
            os.rename(alt, extracted)
    return extracted


def download_glove_w2v(dest_dir: str) -> str:
    """Ensure the extracted glove.6B vectors exist under ``dest_dir``;
    returns the extracted directory."""
    archive = base.maybe_download("glove.6B.zip", dest_dir, GLOVE_URL)
    extracted = os.path.join(dest_dir, "glove.6B")
    if not os.path.exists(extracted):
        with zipfile.ZipFile(archive) as zf:
            zf.extractall(extracted)
    return extracted


def _default_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "news20")


def get_news20(source_dir: str = None) -> List[Tuple[str, int]]:
    """[(text_content, label)] with labels 1..20 assigned by sorted
    class-directory order (the reference's labeling contract); the files
    live under ``source_dir`` (the reference's ``/tmp/news20/``: here
    ``news20`` in the temporary directory)."""
    source_dir = source_dir or _default_dir()
    news_dir = download_news20(source_dir)
    texts: List[Tuple[str, int]] = []
    label_id = 0
    for name in sorted(os.listdir(news_dir)):
        path = os.path.join(news_dir, name)
        if not os.path.isdir(path):
            continue   # stray files must not consume label ids
        label_id += 1
        for fname in sorted(os.listdir(path)):
            if not fname.isdigit():
                continue
            with open(os.path.join(path, fname), encoding="latin-1") as f:
                texts.append((f.read(), label_id))
    return texts


def get_glove_w2v(source_dir: str = None,
                  dim: int = 100) -> Dict[str, np.ndarray]:
    """word -> float32 vector dict from ``glove.6B.<dim>d.txt``."""
    source_dir = source_dir or _default_dir()
    glove_dir = download_glove_w2v(source_dir)
    w2v: Dict[str, np.ndarray] = {}
    with open(os.path.join(glove_dir, f"glove.6B.{dim}d.txt"),
              encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip().split(" ")
            w2v[parts[0]] = np.asarray(parts[1:], np.float32)
    return w2v
