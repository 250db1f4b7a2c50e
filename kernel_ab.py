#!/usr/bin/env python3
"""Time one checkout's hand-written kernels on the card, with chip_smoke.py's
inputs and timer, so that two designs compare within one run.

    python3 kernel_ab.py [TREE] [--kernels paged,flash,correlation]
                         [--dtype float32|float16|bfloat16]
        # TREE: a directory holding a checkout's mxnet_tpu_torch
        # (default: this script's own); --kernels: which rows (default all);
        # --dtype: the operands' dtype, cast from chip_smoke's float32
        # inputs (default float32)

Builds TREE's kernels, holds each against its plain version once (within
1e-3: absolute for float32 attention, relative to max(1, max|plain|) for
correlation, as chip_smoke's CORR_TOL_REL scales it; 16-bit outputs
within one unit in the last place, ``HALF_ULP[dtype] * max(1,
max|plain|)``), then times, with ``chip_smoke.time_ms`` (the L2 flushed
by a 256 MB read and a spin kernel queued before each timed call):

* ``paged_attention`` on the cases of chip_smoke's ``kernel time
  paged_attention`` rows (16 slots x 12 heads x 64, contexts 1..1024,
  scattered pages; C = 1, 9, 32);
* ``flash_attention`` at the kernel search's shape (B 4, T 1024, H 12,
  D 64, causal, chip_smoke's inputs) with every tile TREE compiles;
* ``correlation`` at FlowNetC's and PWC-Net's shapes (chip_smoke's
  ``FLOWNETC`` and ``PWCNET``), multiply and absolute difference.

Prints the card's line from nvidia-smi and one JSON line.  To compare two
trees, run them in turns on one machine (A, B, B, A): only times taken
on one card at one power limit compare.  Needs one CUDA card.
"""
import argparse
import json
import os
import sys

import numpy as np

import chip_smoke as cs

ALL = ("paged", "flash", "correlation")


def rel_err(out, ref, scaled=True):
    """max|out - ref| in float32, over max(1, max|ref|) when ``scaled``
    (correlation, and every 16-bit output)."""
    out, ref = out.float(), ref.float()
    err = (out - ref).abs().max().item()
    return err / max(1.0, ref.abs().max().item()) if scaled else err


def paged_rows(torch, ck, dev, flush, dt):
    times, err = {}, 0.0
    for c in (1, 9, 32):
        case = cs.paged_time_case(torch, dev, c)
        args = cs.half_args(torch, cs.paged_args(case), dt)
        out = ck.paged_attention(*args)
        ref = ck.paged_attention_reference(*args)
        err = max(err, rel_err(out, ref, dt != torch.float32))
        times["C=%d" % c] = cs.time_ms(
            torch, lambda: ck.paged_attention(*args), flush)
    return {"paged_ms": times}, err


def flash_rows(torch, ck, dev, flush, dt):
    q, k, v = cs.half_args(torch, cs.flash_inputs(torch, dev, 42,
                                                  *cs.FLASH_SHAPE), dt)
    ref = ck.flash_attention_reference(q, k, v, causal=True)
    times, err = {}, 0.0
    for bq, bk in ck.FLASH_TILES:
        out = ck.flash_attention(q, k, v, causal=True, block_q=bq,
                                 block_k=bk)
        err = max(err, rel_err(out, ref, dt != torch.float32))
        times["%dx%d" % (bq, bk)] = cs.time_ms(
            torch, lambda: ck.flash_attention(q, k, v, causal=True,
                                              block_q=bq, block_k=bk), flush)
    best = min(times, key=times.get)
    return {"flash_best": {"tile": best, "ms": times[best]},
            "flash_ms": times}, err


def correlation_rows(torch, ck, dev, flush, dt):
    times, err = {}, 0.0
    for name, g in (("flownetc", cs.FLOWNETC), ("pwcnet", cs.PWCNET)):
        a, b = cs.half_args(torch, cs.corr_inputs(
            torch, dev, 300, g["n"], g["c"], g["h"], g["w"]), dt)
        for mult in (True, False):
            out = ck.correlation(a, b, g["m"], g["s2"], mult)
            ref = ck.correlation_reference(a, b, g["m"], g["s2"], mult)
            err = max(err, rel_err(out, ref))
            times["%s %s" % (name, "multiply" if mult else "abs")] = \
                cs.time_ms(torch, lambda: ck.correlation(
                    a, b, g["m"], g["s2"], mult), flush)
    return {"correlation_ms": times}, err


def main(argv):
    parser = argparse.ArgumentParser()
    parser.add_argument("tree", nargs="?",
                        default=os.path.dirname(os.path.abspath(__file__)))
    parser.add_argument("--kernels", default=",".join(ALL))
    parser.add_argument("--dtype", default="float32",
                        choices=("float32", "float16", "bfloat16"))
    args = parser.parse_args(argv)
    kernels = args.kernels.split(",")
    if set(kernels) - set(ALL):
        parser.error("--kernels takes %s" % ",".join(ALL))
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.tree))
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    dt = getattr(torch, args.dtype)
    names = {"paged": "paged_attention", "flash": "flash_attention",
             "correlation": "correlation"}
    ck.build([names[k] for k in kernels])
    flush = torch.zeros(256 * 2 ** 20 // 4, dtype=torch.float32, device=dev)
    rows = {"paged": paged_rows, "flash": flash_rows,
            "correlation": correlation_rows}
    result, err = {"tree": args.tree, "dtype": args.dtype,
                   "kernels": os.path.relpath(ck.__file__)}, 0.0
    for k in kernels:
        got, e = rows[k](torch, ck, dev, flush, dt)
        result.update(got)
        err = max(err, e)
    result["max_err"] = err
    print("card: %s" % cs.nvidia_smi_line())
    print(json.dumps(result))
    tol = 1e-3 if dt == torch.float32 else ck.HALF_ULP[dt]
    if not (np.isfinite(err) and err <= tol):
        print("kernel_ab: a kernel disagrees with its plain version "
              "(max_err %.3g, tol %.3g)" % (err, tol), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
