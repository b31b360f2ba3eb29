"""High-level batch-inference API (``bigdl_tpu/api.py``).

Parity: ``DLClassifier.scala`` — model inference over a row stream, with a
fixed ``batch_shape`` whose tail chunk is zero-padded up to the batch size.
The forward runs under ``torch.inference_mode()`` on the classifier's device
(``device=``, CUDA by default, never a silent CPU fallback), the argmax is
taken on the device and the host fetches ``bsz`` int32s.  CUDA work is
asynchronous, so up to ``pipeline_depth`` chunks are in flight before the
oldest chunk's predictions are fetched.

``quantize=`` (``"w8"``/``"int8"``, ``"w8a8"`` with ``calibration_rows``,
``"w4"``/``"int4"``, ``"f8"``/``"fp8"``) serves a private packed copy of the
model (``ops.quant.quantize_model``, fp leaves cast to ``compute_dtype``);
the caller's model keeps its fp weights.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch

from bigdl_tpu_torch.core.device import resolve_device, synchronize
from bigdl_tpu_torch.core.precision import mixed_forward
from bigdl_tpu_torch.ops import quant


class DLClassifier:
    """Batched classification inference over a row stream.

    ``batch_shape`` is the full input batch shape including the leading
    batch dim.  ``transform`` yields one output row per input row with the
    1-based predicted class under ``predict_col``.  The model is moved to
    ``device`` and put in eval mode in place.  With ``quantize=`` the
    forward runs ``self.qmodel``, the packed copy; ``"w8a8"`` calibrates its
    activation scales on ``calibration_rows`` first.
    """

    def __init__(self, model, batch_shape,
                 features_col: str = "features",
                 predict_col: str = "predict",
                 pipeline_depth: int = 2,
                 compute_dtype=None,
                 device="cuda",
                 quantize: Optional[str] = None,
                 calibration_rows: Optional[Iterable[Any]] = None,
                 mesh=None,
                 sharding=None):
        if mesh is not None or sharding is not None:
            if quantize is not None:
                raise NotImplementedError(
                    "quantize= with mesh= or sharding=: a quantized-inference "
                    "classifier serves unsharded (a packed copy has no "
                    "partition rules), and mesh=/sharding= come with the "
                    "parallel-strategies slice of the port")
            raise NotImplementedError(
                "mesh= and sharding= come with the parallel-strategies "
                "slice of the port")
        self.device = resolve_device(device)
        self.model = model.to(self.device).evaluate()
        self.batch_shape = tuple(int(d) for d in batch_shape)
        self.features_col = features_col
        self.predict_col = predict_col
        self.compute_dtype = compute_dtype
        # depth=1: dispatch, then fetch the same chunk (least memory);
        # depth>=2 overlaps chunk k+1's upload and forward with chunk k
        self.pipeline_depth = max(1, int(pipeline_depth))
        mode = quant.normalize_mode(quantize)
        self.quantize = mode
        self.qmodel = None
        if mode is not None:
            quant.check_mode(mode, quantize)
            calib = None
            if mode == "w8a8":
                rows = list(calibration_rows or ())
                if not rows:
                    raise ValueError(
                        "quantize='w8a8' needs calibration_rows: a few "
                        "representative feature rows to fix the per-tensor "
                        "activation scales (weight-only quantization is "
                        "quantize='w8')")
                cal = []
                for i, r in enumerate(rows):
                    f = self._features(r)
                    msg = self._row_mismatch(f, f"calibration row {i}")
                    if msg is not None:
                        raise ValueError(msg)
                    cal.append(f.reshape(self.batch_shape[1:]))
                calib = quant.calibrate(self.model, [np.stack(cal)])
            self.qmodel = quant.quantize_model(self.model, mode, calib=calib,
                                               cast_rest=compute_dtype)

    # -- internals ----------------------------------------------------------

    def _features(self, row) -> np.ndarray:
        if isinstance(row, dict):
            row = row[self.features_col]
        return np.asarray(row, np.float32)

    def _row_mismatch(self, f: np.ndarray,
                      label: str = "row") -> Optional[str]:
        """The shared shape-contract check of ``_pack`` and serving
        admission: the error text when ``f`` cannot fill one row of the
        batch shape, else None."""
        per_row = self.batch_shape[1:]
        per_row_size = int(np.prod(per_row)) if per_row else 1
        if int(f.size) != per_row_size:
            return (f"{label} has shape {tuple(f.shape)} "
                    f"({f.size} elements) but the compiled batch shape "
                    f"{self.batch_shape} expects per-row shape "
                    f"{per_row} ({per_row_size} elements)")
        return None

    def _pack(self, chunk: List[Any], base: int = 0,
              size: Optional[int] = None) -> torch.Tensor:
        """Host side of a dispatch: validate, stack, pad the tail, cast.
        ``size`` overrides the target batch size (the serving bucket
        ladder packs through here at its rung sizes)."""
        rows = []
        for i, r in enumerate(chunk):
            f = self._features(r)
            msg = self._row_mismatch(f, f"row {base + i}")
            if msg is not None:
                raise ValueError(msg)
            rows.append(f.reshape(-1))
        feats = np.stack(rows)
        n = feats.shape[0]
        bsz = self.batch_shape[0] if size is None else int(size)
        if n > bsz:
            raise ValueError(f"{n} rows do not fit a batch of {bsz}")
        if n < bsz:
            pad = np.zeros((bsz - n,) + feats.shape[1:], np.float32)
            feats = np.concatenate([feats, pad])
        x = torch.from_numpy(feats.reshape((bsz,) + self.batch_shape[1:]))
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)   # halve the upload wire
        return x

    def _run(self, x: torch.Tensor) -> torch.Tensor:
        """Device forward of one packed batch; returns the 1-based int32
        predictions ON the device (not yet fetched).  Inference mode is
        thread-local, so it is entered here, in whichever thread runs the
        forward."""
        with torch.inference_mode():
            x = x.to(self.device, non_blocking=True)
            if self.qmodel is not None:
                # the packed copy carries its serving dtypes (a tree cast
                # would cast the f32 scales); _pack cast the input
                y = self.qmodel(x)
            elif self.compute_dtype is not None:
                y = mixed_forward(self.model, x, self.compute_dtype)
            else:
                y = self.model(x)
            if y.dim() == 1:      # single-output head: (bsz,) -> (bsz, 1)
                y = y[:, None]
            return torch.argmax(y, dim=-1).to(torch.int32) + 1

    def synchronize(self) -> None:
        synchronize(self.device)

    # -- public surface ------------------------------------------------------

    def transform(self, rows: Iterable[Any]) -> Iterator[Dict[str, Any]]:
        """Map a row stream to rows with a ``predict`` column added."""
        bsz = self.batch_shape[0]
        pending: deque = deque()      # (chunk, device preds) in flight

        def chunks():
            base = 0
            chunk: List[Any] = []
            for row in rows:
                chunk.append(row)
                if len(chunk) == bsz:
                    yield base, chunk
                    base += bsz
                    chunk = []
            if chunk:
                yield base, chunk

        for base, chunk in chunks():
            pending.append((chunk, self._run(self._pack(chunk, base))))
            if len(pending) >= self.pipeline_depth:
                yield from self._emit(*pending.popleft())
        while pending:
            yield from self._emit(*pending.popleft())

    def _emit(self, chunk: List[Any], preds_dev) -> Iterator[Dict[str, Any]]:
        preds = preds_dev.cpu().numpy()[:len(chunk)]
        for row, p in zip(chunk, preds):
            out = dict(row) if isinstance(row, dict) else \
                {self.features_col: row}
            out[self.predict_col] = int(p)
            yield out

    def predict(self, rows: Iterable[Any]) -> np.ndarray:
        """Just the 1-based class predictions, as one array."""
        return np.asarray([r[self.predict_col] for r in self.transform(rows)])
