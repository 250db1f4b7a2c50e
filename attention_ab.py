#!/usr/bin/env python3
"""Time one checkout's attention kernels on the card, with chip_smoke.py's
inputs and timer, so that two designs compare within one run.

    python3 attention_ab.py [TREE]    # TREE: a directory holding a
                                      # checkout's mxnet_tpu_torch (default:
                                      # this script's own)

Builds TREE's ``paged_attention`` and ``flash_attention``, holds each
against its plain version once, then times, with ``chip_smoke.time_ms``:

* ``paged_attention`` on the cases of chip_smoke's ``kernel time
  paged_attention`` rows (16 slots x 12 heads x 64, contexts 1..1024,
  scattered pages; C = 1, 9, 32);
* ``flash_attention`` at the kernel search's shape (B 4, T 1024, H 12,
  D 64, causal, chip_smoke's inputs) with every tile TREE compiles.

Prints the card's line from nvidia-smi and one JSON line.  To compare two
trees, run them in turns on one machine (A, B, B, A): only times taken
on one card at one power limit compare.  Needs one CUDA card.
"""
import json
import os
import sys

import numpy as np

import chip_smoke as cs


def main(tree):
    import torch
    if not torch.cuda.is_available():
        print("attention_ab: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(tree))
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    ck.build(["paged_attention", "flash_attention"])
    flush = torch.zeros(256 * 2 ** 20 // 4, dtype=torch.float32, device=dev)

    paged, err = {}, 0.0
    for c in (1, 9, 32):
        case = cs.paged_time_case(torch, dev, c)
        args = cs.paged_args(case)
        out = ck.paged_attention(*args)
        ref = ck.paged_attention_reference(*args)
        err = max(err, (out - ref).abs().max().item())
        paged["C=%d" % c] = cs.time_ms(
            torch, lambda: ck.paged_attention(*args), flush)

    q, k, v = cs.flash_inputs(torch, dev, 42, *cs.FLASH_SHAPE)
    ref = ck.flash_attention_reference(q, k, v, causal=True)
    flash = {}
    for bq, bk in ck.FLASH_TILES:
        out = ck.flash_attention(q, k, v, causal=True, block_q=bq,
                                 block_k=bk)
        err = max(err, (out - ref).abs().max().item())
        flash["%dx%d" % (bq, bk)] = cs.time_ms(
            torch, lambda: ck.flash_attention(q, k, v, causal=True,
                                              block_q=bq, block_k=bk), flush)
    best = min(flash, key=flash.get)
    print("card: %s" % cs.nvidia_smi_line())
    print(json.dumps({
        "tree": tree, "kernels": os.path.relpath(ck.__file__),
        "max_abs_err": err, "paged_ms": paged,
        "flash_best": {"tile": best, "ms": flash[best]},
        "flash_ms": flash}))
    if not (np.isfinite(err) and err < 1e-3):
        print("attention_ab: a kernel disagrees with its plain version "
              "(max_abs_err %.3g)" % err, file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else
                  os.path.dirname(os.path.abspath(__file__))))
