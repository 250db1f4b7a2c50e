"""Regenerate the JPEG files beside this script: smooth RGB images of
various sizes (each side >= 256 px) made from a numpy seed and encoded
with PIL at quality 90.  The native I/O tests pack them into records;
the files are committed so that the tests need no PIL.

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


def main():
    here = os.path.dirname(os.path.abspath(__file__))
    rs = np.random.RandomState(21)
    for i, (h, w) in enumerate(SIZES):
        Image.fromarray(image(rs, h, w)).save(
            os.path.join(here, "img%02d.jpg" % i), quality=90)


if __name__ == "__main__":
    main()
