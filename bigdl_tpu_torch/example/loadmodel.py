"""ModelValidator: load a Caffe, Torch7 or port model and validate it on an
ImageNet-style ``<folder>/val`` tree (``bigdl_tpu/example/loadmodel.py``).

Parity: ``example/loadmodel/ModelValidator.scala:37-160`` and the
preprocessors in ``example/loadmodel/DatasetUtil.scala`` (AlexNet: a
per-pixel mean file and a 227 centre crop; Inception: a 224 crop and the
(123, 117, 104) channel means; ResNet: a 224 crop and torchvision's
normalization).  The images are decoded, resized and cropped on the host
(``dataset/image.py``); the forward runs on ``device``:

    python -m bigdl_tpu_torch.example.loadmodel -f <folder> -m inception \\
        -t caffe --caffeDefPath deploy.prototxt --modelPath m.caffemodel
"""

from __future__ import annotations

import argparse
import os


def _preprocessor(model_name: str, folder: str, batch_size: int,
                  mean_file=None):
    from bigdl_tpu_torch.dataset import (BGRImgCropper, BGRImgNormalizer,
                                         BGRImgPixelNormalizer,
                                         BGRImgToBatch, DataSet,
                                         LocalImgReader, image_folder_paths)
    val_path = os.path.join(folder, "val")
    paths = image_folder_paths(val_path)
    base = DataSet.array(paths)
    if model_name == "alexnet":
        from bigdl_tpu_torch.utils.file import File
        means = File.load(mean_file)
        return base >> LocalImgReader(256, normalize=1.0) >> \
            BGRImgPixelNormalizer(means) >> \
            BGRImgCropper(227, 227, center=True) >> BGRImgToBatch(batch_size)
    if model_name == "inception":
        return base >> LocalImgReader(256, normalize=1.0) >> \
            BGRImgCropper(224, 224, center=True) >> \
            BGRImgNormalizer((123, 117, 104), (1, 1, 1)) >> \
            BGRImgToBatch(batch_size)
    if model_name == "resnet":
        return base >> LocalImgReader(256, normalize=255.0) >> \
            BGRImgCropper(224, 224, center=True) >> \
            BGRImgNormalizer((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)) >> \
            BGRImgToBatch(batch_size, to_rgb=True)
    raise SystemExit(f"unknown model name {model_name}")


def load_model(model_type: str, model_path: str, caffe_def_path, device,
               arch=None):
    """The model of ``-t caffe|torch|bigdl`` on ``device``: a Caffe model's
    weights go into ``arch()`` (built on ``device`` first), a ``.t7`` or a
    ``Module.save`` file loads onto it."""
    import bigdl_tpu_torch.nn as nn
    if model_type == "caffe":
        if arch is None:
            raise SystemExit("a Caffe model loads into alexnet or inception")
        return nn.load_caffe(arch().to(device), caffe_def_path, model_path)
    if model_type == "torch":
        return nn.load_torch(model_path, device)
    if model_type == "bigdl":
        return nn.load(model_path, device)
    raise SystemExit("only torch, caffe or bigdl supported")


def main(argv=None, device="cuda"):
    """Top-1 and Top-5 of the model on ``<folder>/val`` on ``device`` (CUDA
    by default; without CUDA it raises unless asked for the CPU)."""
    from bigdl_tpu_torch.core.device import resolve_device
    from bigdl_tpu_torch.models import AlexNet, Inception_v1
    from bigdl_tpu_torch.optim import (LocalValidator, Top1Accuracy,
                                       Top5Accuracy)
    from bigdl_tpu_torch.utils.log import init_logging

    p = argparse.ArgumentParser("model-validator")
    p.add_argument("-f", "--folder", default="./")
    p.add_argument("-m", "--modelName", required=True,
                   help="alexnet | inception | resnet")
    p.add_argument("-t", "--modelType", required=True,
                   help="torch | caffe | bigdl")
    p.add_argument("--caffeDefPath", default=None)
    p.add_argument("--modelPath", required=True)
    p.add_argument("-b", "--batchSize", type=int, default=32)
    p.add_argument("--meanFile", default=None)
    args = p.parse_args(argv)
    device = resolve_device(device)

    init_logging()
    name, mtype = args.modelName.lower(), args.modelType.lower()
    arch = {"alexnet": lambda: AlexNet(1000),
            "inception": lambda: Inception_v1(1000)}.get(name)
    model = load_model(mtype, args.modelPath, args.caffeDefPath, device,
                       arch)
    dataset = _preprocessor(name, args.folder, args.batchSize,
                            args.meanFile)
    model.evaluate()
    results = LocalValidator(model, dataset, device).test(
        [Top1Accuracy(), Top5Accuracy()])
    for method, r in zip(("Top1Accuracy", "Top5Accuracy"), results):
        print(f"{method} is {r}")
    return results


if __name__ == "__main__":
    main()
