"""Regenerate ``decoded.npz`` beside this script: the pixels of each
committed JPEG, here and in ``samplings/``, as the port's host loader
decodes them (libjpeg through ``mxnet_tpu_torch.native_io.decode_jpeg``:
(h, w, 3) uint8 RGB), one array a file, named by its stem.  They are
the reference that nvjpeg's decode on the card is held to, on a machine
that has no libjpeg.

    python tests/data/native_jpegs/make_decoded.py
"""
import glob
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))

from mxnet_tpu_torch import native_io  # noqa: E402


def decoded():
    """{stem: pixels} of every JPEG beside this script and in
    ``samplings/``."""
    out = {}
    for path in sorted(glob.glob(os.path.join(HERE, "*.jpg"))) + sorted(
            glob.glob(os.path.join(HERE, "samplings", "*.jpg"))):
        with open(path, "rb") as f:
            out[os.path.splitext(os.path.basename(path))[0]] = \
                native_io.decode_jpeg(f.read())
    return out


def main():
    np.savez_compressed(os.path.join(HERE, "decoded.npz"), **decoded())


if __name__ == "__main__":
    main()
