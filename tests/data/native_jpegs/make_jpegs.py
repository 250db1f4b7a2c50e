"""Regenerate the JPEG files beside this script: smooth RGB images of
various sizes (each side >= 256 px) made from a numpy seed and encoded
with PIL at quality 90.  The native I/O tests pack them into records;
the files are committed so that the tests need no PIL.

``samplings/`` holds small JPEGs of every chroma sampling the JPEG route
on the card takes (4:4:4, 4:2:2, 4:2:0, grayscale, progressive), odd,
narrow and tiny sizes among them, of noise from a numpy seed.

    python tests/data/native_jpegs/make_jpegs.py
"""
import os

import numpy as np
from PIL import Image

SIZES = [(256, 256), (256, 320), (300, 256), (288, 352), (320, 260),
         (260, 300), (256, 384), (352, 288)]


def image(rs, h, w):
    """A smooth image: a low-frequency noise field upsampled bilinearly,
    plus gradients, so it compresses to a few KB."""
    coarse = rs.rand(8, 8, 3) * 255
    small = Image.fromarray(coarse.astype(np.uint8)).resize(
        (w, h), Image.BILINEAR)
    px = np.asarray(small).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    px[..., 0] = 0.7 * px[..., 0] + 0.3 * (255 * yy / h)
    px[..., 2] = 0.7 * px[..., 2] + 0.3 * (255 * xx / w)
    return px.clip(0, 255).astype(np.uint8)


# name, (h, w), PIL's save options (None: grayscale, PIL's defaults)
SAMPLINGS = [("444", (41, 63), dict(subsampling=0)),
             ("422", (33, 101), dict(subsampling=1)),
             ("420-odd", (51, 57), dict(subsampling=2)),
             ("420-tiny", (3, 5), dict(subsampling=2)),
             ("422-narrow", (9, 4), dict(subsampling=1)),
             ("progressive", (40, 47), dict(progressive=True)),
             ("gray", (30, 31), None)]


def main():
    here = os.path.dirname(os.path.abspath(__file__))
    rs = np.random.RandomState(21)
    for i, (h, w) in enumerate(SIZES):
        Image.fromarray(image(rs, h, w)).save(
            os.path.join(here, "img%02d.jpg" % i), quality=90)
    rs = np.random.RandomState(6)
    os.makedirs(os.path.join(here, "samplings"), exist_ok=True)
    for name, shape, kw in SAMPLINGS:
        px = (rs.rand(*shape, 3) * 255).astype(np.uint8)
        path = os.path.join(here, "samplings", name + ".jpg")
        if kw is None:
            Image.fromarray(px[..., 0], "L").save(path)
        else:
            Image.fromarray(px).save(path, quality=80, **kw)


if __name__ == "__main__":
    main()
