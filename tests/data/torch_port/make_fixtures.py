"""Writes the JPEG fixtures of the port's native decode tests (seeded, with
PIL): photo-like RGB images (smooth gradients under mild noise) at three
sizes, a greyscale one, a 4:4:4 one, and a PNG file under a ``.jpg`` name.

    python tests/data/torch_port/make_fixtures.py
"""

import io
import os

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))


def photo(h, w, seed):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([yy * 255 / h, xx * 255 / w,
                    (yy + xx) * 255 / (h + w)], axis=-1)
    img = img + 40 * np.sin(xx / 9.0 + seed)[..., None] + \
        rng.randint(0, 12, (h, w, 3))
    return img.clip(0, 255).astype(np.uint8)


def main():
    specs = [("rgb_240x320.jpg", photo(240, 320, 1), "RGB", {}),
             ("rgb_384x512.jpg", photo(384, 512, 2), "RGB", {}),
             ("rgb_300x257.jpg", photo(300, 257, 3), "RGB",
              {"subsampling": 0}),
             ("grey_150x200.jpg", photo(150, 200, 4)[..., 0], "L", {})]
    for name, arr, mode, kw in specs:
        Image.fromarray(arr, mode).save(os.path.join(HERE, name), "JPEG",
                                        quality=85, **kw)
    buf = io.BytesIO()
    Image.fromarray(photo(40, 60, 5)).save(buf, "PNG")
    with open(os.path.join(HERE, "png_named.jpg"), "wb") as f:
        f.write(buf.getvalue())


if __name__ == "__main__":
    main()
