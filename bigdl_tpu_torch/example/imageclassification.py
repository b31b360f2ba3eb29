"""ImagePredictor: batch image classification over a folder of images
(``bigdl_tpu/example/imageclassification.py``).

Parity: ``example/imageclassification/ImagePredictor.scala`` and
``MlUtils.scala``: load a model, run the BGR pipeline over local images and
emit the top-N classes (1-based) of each file.  The reference drives a
Spark-ML ``DLClassifier`` over a DataFrame; here the images are decoded,
resized, cropped and normalized on the host and each batch's forward runs
on ``device``:

    python -m bigdl_tpu_torch.example.imageclassification -f <images> \\
        --modelType caffe --caffeDefPath deploy.prototxt \\
        --modelPath alexnet.caffemodel --topN 5
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def main(argv=None, device="cuda"):
    """[(file, [top-N classes])] in file-name order, the forward on
    ``device`` (CUDA by default; without CUDA it raises unless asked for
    the CPU)."""
    from bigdl_tpu_torch.core.device import resolve_device
    from bigdl_tpu_torch.dataset import (BGRImgCropper, BGRImgNormalizer,
                                         LocalImgReader)
    from bigdl_tpu_torch.example.loadmodel import load_model
    from bigdl_tpu_torch.models import AlexNet
    from bigdl_tpu_torch.utils.log import init_logging

    p = argparse.ArgumentParser("image-predictor")
    p.add_argument("-f", "--folder", required=True,
                   help="folder of image files to classify")
    p.add_argument("--modelPath", required=True)
    p.add_argument("--modelType", default="bigdl",
                   help="torch | caffe | bigdl")
    p.add_argument("--caffeDefPath", default=None)
    p.add_argument("-b", "--batchSize", type=int, default=32)
    p.add_argument("--imageSize", type=int, default=227)
    p.add_argument("--topN", type=int, default=1)
    args = p.parse_args(argv)
    device = resolve_device(device)

    init_logging()
    mtype = args.modelType if args.modelType in ("caffe", "torch") \
        else "bigdl"
    model = load_model(mtype, args.modelPath, args.caffeDefPath,
                       device, lambda: AlexNet(1000))
    model.evaluate()

    files = [os.path.join(args.folder, f)
             for f in sorted(os.listdir(args.folder))
             if os.path.isfile(os.path.join(args.folder, f))]
    reader = LocalImgReader(256, normalize=1.0)
    crop = BGRImgCropper(args.imageSize, args.imageSize, center=True)
    norm = BGRImgNormalizer((123, 117, 104), (1, 1, 1))

    results = []
    for start in range(0, len(files), args.batchSize):
        chunk = files[start:start + args.batchSize]
        imgs = list(norm.apply(crop.apply(
            reader.apply((f, 0.0) for f in chunk))))
        batch = np.stack([i.data.transpose(2, 0, 1) for i in imgs])
        with torch.inference_mode():
            out = model(torch.from_numpy(batch.astype(np.float32))
                        .to(device))
            top = (out.topk(args.topN, dim=1).indices + 1).cpu().tolist()
        for f, classes in zip(chunk, top):
            results.append((f, classes))
            print(f"{os.path.basename(f)}: {classes}")
    return results


if __name__ == "__main__":
    main()
