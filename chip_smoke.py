#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``mxnet_tpu_torch``).

    python3 chip_smoke.py        # from the root of a checkout, one CUDA card

Phases, in order; any failure exits nonzero:

1. environment: the card's name and power limit, torch/CUDA versions,
   TF32 off for matmul and cuDNN;
2. build: every hand-written kernel compiled from ``mxnet_tpu_torch/csrc``
   with nvcc for sm_90a;
3. kernels: each kernel against its plain PyTorch version on the card at
   the serving path's shapes and at ragged ones, with the tolerance each
   case states; kernel, plain version and one library call timed;
4. serve VGG-16 at full width (224x224x3, 1000 classes, 138 M float32
   parameters from a numpy seed): checkpoint pair -> ServeEngine with the
   fused serving pipeline on the default device -> 32 requests from 4
   client threads, each answer held against an unfused Predictor, the
   kernels' launch counts read around exactly this run;
5. the ``kernels`` JSON line, then the ``{"ok": true, ...}`` line.
"""
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

# H100 SXM published peaks at 700 W (NVIDIA data sheet): HBM3 bandwidth and
# float32 outside the tensor cores (the kernels here run no tensor cores)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

REPLACES = {"fused_fc_epilogue": "mxnet_tpu/ops/pallas_kernels.py:347"}


def fail(msg):
    raise RuntimeError("chip_smoke: " + msg)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, flush, iters=20):
    """Median device time of fn() in ms, CUDA events around each call.
    Before each call (outside the timed span) a read of a 256 MB buffer
    leaves the 50 MB L2 holding clean, unrelated lines: the weights
    arrive cold, as they do in a forward pass."""
    fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.sum()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in zip(starts, ends)]))


def fc_bound_ms(x, w, b, out):
    nbytes = sum(t.numel() * t.element_size() for t in (x, w, out)) \
        + (b.numel() * b.element_size() if b is not None else 0)
    flops = 2.0 * x.shape[0] * w.shape[0] * x.shape[1]
    return 1e3 * max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS)


# ---------------------------------------------------------------------------
# phase 3: fused_fc_epilogue against its plain version

def kernel_phase(torch, ck):
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1234)

    def uniform(shape, scale, dtype=torch.float32):
        t = torch.rand(shape, generator=gen, device=dev) * 2 - 1
        return (t * scale).to(dtype)

    def inputs(m, k, n, dtype=torch.float32, bias=True):
        x = uniform((m, k), 1.0, dtype)
        w = uniform((n, k), 1.0 / math.sqrt(k), dtype)
        b = uniform((n,), 0.1) if bias else None
        return x, w, b

    # Float tolerances.  The kernel and the plain version both sum K
    # float32 products, in different orders (per-lane strided partial sums
    # and a warp tree in the kernel, cuBLAS's own split in the plain
    # version); the difference grows like sqrt(K) * 2^-24 times the
    # partial sums, which are O(1) here: under 1e-5 at K = 25088.  float32
    # outputs: 1e-4 * max(1, max|plain|).  16-bit outputs: that float32
    # difference can flip the last bit of the rounded result, so one ulp of
    # the largest output: 2^-7 * max(1, max|plain|) for bfloat16 (8-bit
    # mantissa), 2^-10 for float16.
    tol_rel = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7,
               torch.float16: 2.0 ** -10}
    cases = [("fc6", 8, 25088, 4096, "relu", torch.float32, True),
             ("fc7", 8, 4096, 4096, "relu", torch.float32, True),
             ("m1", 1, 4096, 4096, "relu", torch.float32, True)]
    cases += [("ragged-" + act, 3, 784, 10, act, torch.float32, True)
              for act in ("none", "relu", "sigmoid", "tanh", "softrelu")]
    cases += [("scalar-path", 5, 1001, 37, "tanh", torch.float32, True),
              ("no-bias", 8, 4096, 512, "relu", torch.float32, False),
              ("bf16", 8, 4096, 4096, "relu", torch.bfloat16, True),
              ("fp16", 8, 4096, 4096, "sigmoid", torch.float16, True)]
    main_err = 0.0
    for name, m, k, n, act, dtype, bias in cases:
        x, w, b = inputs(m, k, n, dtype, bias)
        out = ck.fused_fc_epilogue(x, w, b, act)
        ref = ck.fused_fc_epilogue_reference(x, w, b, act)
        torch.cuda.synchronize()
        if out.dtype != ref.dtype or out.shape != ref.shape:
            fail("%s: kernel gave %s %s, plain %s %s" % (
                name, out.dtype, tuple(out.shape), ref.dtype,
                tuple(ref.shape)))
        err = (out.float() - ref.float()).abs().max().item()
        tol = tol_rel[dtype] * max(1.0, ref.float().abs().max().item())
        print("kernel check %-16s M=%-2d K=%-5d N=%-4d %-8s %-14s "
              "max_abs_err=%.3g tol=%.3g" % (name, m, k, n, act, dtype,
                                             err, tol))
        if not err <= tol:
            fail("%s: max_abs_err %.3g > tol %.3g" % (name, err, tol))
        if name in ("fc6", "fc7"):
            main_err = max(main_err, err)

    # int8 requantize: small integer x and W make every float32 sum exact,
    # and out_scale 2 puts odd sums on .5 ties; the codes must be equal
    # (divide, round half to even, clamp)
    for act in ("none", "relu"):
        gi = torch.Generator(device=dev).manual_seed(7)
        x = torch.randint(-3, 4, (8, 512), generator=gi, device=dev).float()
        w = torch.randint(-2, 3, (64, 512), generator=gi, device=dev).float()
        b = torch.randint(-5, 6, (64,), generator=gi, device=dev).float()
        q = ck.fused_fc_epilogue(x, w, b, act, out_scale=2.0)
        qr = ck.fused_fc_epilogue_reference(x, w, b, act, out_scale=2.0)
        torch.cuda.synchronize()
        sums = torch.matmul(x.double(), w.double().t()) + b.double()
        ties = int((sums.remainder(2.0) == 1.0).sum().item())
        same = bool(torch.equal(q, qr)) and q.dtype == torch.int8
        print("kernel check int8-%-11s codes equal=%s (%d of %d sums on a "
              ".5 tie, %d codes clamped)" % (
                  act, same, ties, q.numel(),
                  int((qr.abs() == 127).sum().item())))
        if not same:
            fail("int8 %s: codes differ at %d places" % (
                act, int((q != qr).sum().item())))

    # timing at the serving path's shapes (bucket 8, float32, relu)
    flush = torch.zeros(256 * 2 ** 20 // 4, dtype=torch.float32, device=dev)
    rows = []
    for name, k in (("fc6", 25088), ("fc7", 4096)):
        x, w, b = inputs(8, k, 4096)
        out = ck.fused_fc_epilogue(x, w, b, "relu")
        row = {
            "shape": name, "M": 8, "K": k, "N": 4096,
            "ms": time_ms(torch, lambda: ck.fused_fc_epilogue(
                x, w, b, "relu"), flush),
            "plain_ms": time_ms(torch, lambda: ck.fused_fc_epilogue_reference(
                x, w, b, "relu"), flush),
            "library_ms": time_ms(torch, lambda: torch.relu_(
                torch.addmm(b, x, w.t())), flush),
            "bound_ms": fc_bound_ms(x, w, b, out),
        }
        row["bound_share"] = row["bound_ms"] / row["ms"]
        print("kernel time %s: %s" % (name, json.dumps(row)))
        rows.append(row)
    del flush
    return {"max_abs_err": main_err,
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "library_ms": sum(r["library_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "rows": rows}


# ---------------------------------------------------------------------------
# phase 4: serve VGG-16

def xavier_params(sym, shapes, seed):
    """Uniform weights at Xavier(factor_type='in', magnitude=6) scale,
    sqrt(6 / fan_in), which keeps the activation scale through the relu
    stack; biases U(-0.01, 0.01) so the bias epilogue does work."""
    rng = np.random.default_rng(seed)
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    params = {}
    for name, shape in zip(sym.list_arguments(), arg_shapes):
        if name in shapes:
            continue
        scale = 0.01 if len(shape) == 1 else \
            math.sqrt(6.0 / float(np.prod(shape[1:])))
        params[name] = (rng.random(shape, dtype=np.float32) * 2 - 1) * \
            np.float32(scale)
    return params


def serve_phase(torch, mt, ck, image=224, classes=1000, n_requests=32,
                n_threads=4, seed=0):
    sym = mt.models.get_vgg(num_classes=classes)
    shapes = {"data": (1, 3, image, image), "softmax_label": (1,)}
    t0 = time.perf_counter()
    params = xavier_params(sym, shapes, seed)
    n_params = sum(v.size for v in params.values())
    print("serve: VGG-16 %dx%dx3, %d classes, %d parameters made in %.1f s"
          % (image, image, classes, n_params, time.perf_counter() - t0))
    rng = np.random.default_rng(seed + 1)
    items = [rng.random((3, image, image), dtype=np.float32)
             for _ in range(n_requests)]
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "vgg16")
        t0 = time.perf_counter()
        mt.model.save_checkpoint(
            prefix, 0, sym,
            {k: mt.nd.array(v, ctx=mt.cpu()) for k, v in params.items()}, {})
        print("serve: checkpoint pair written in %.1f s"
              % (time.perf_counter() - t0))
        t0 = time.perf_counter()
        engine = mt.serve.ServeEngine.from_checkpoint(
            prefix, 0, shapes, fuse=True)
    try:
        print("serve: engine built and warmed (buckets %s) in %.1f s"
              % (engine.buckets, time.perf_counter() - t0))
        fused = [n["op"] for n in json.loads(
            engine._predictor.symbol.tojson())["nodes"]]
        if fused.count("_fused_FullyConnected") != 2:
            fail("serving graph has %d _fused_FullyConnected nodes, want 2"
                 % fused.count("_fused_FullyConnected"))
        answers = [None] * n_requests
        errors = []

        def client(idx):
            try:
                futs = [(i, engine.submit(items[i]))
                        for i in range(idx, n_requests, n_threads)]
                for i, f in futs:
                    answers[i] = f.result(timeout=120)
            except Exception as e:          # reported below, fails the run
                errors.append(repr(e))

        batches_before = engine.stats.report()["batches"]
        ck.reset_launches()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall = time.perf_counter() - t0
        launches = dict(ck.LAUNCHES)
        if errors or any(t.is_alive() for t in threads):
            fail("client errors: %s" % errors)
        report = engine.stats.report()
    finally:
        engine.close()
    batches = report["batches"] - batches_before
    print("serve: %d requests in %.3f s = %.2f req/s; latency p50 %.3f ms "
          "p99 %.3f ms; %d batches, bucket hits %s, occupancy %.3f, pad "
          "waste %.3f" % (n_requests, wall, n_requests / wall,
                          report["latency_p50_ms"], report["latency_p99_ms"],
                          batches, report["bucket_hits"],
                          report["batch_occupancy"],
                          report["pad_waste_frac"]))
    print("serve: launches %s over %d batches" % (launches, batches))
    if batches < 1 or launches["fused_fc_epilogue"] != 2 * batches:
        fail("fused_fc_epilogue launched %d times for %d batches, want 2 "
             "per batch" % (launches["fused_fc_epilogue"], batches))

    # reference: the same parameters, no pass pipeline, on the card, so
    # fc6/fc7 + relu run as torch.matmul + add + relu
    ref_pred = mt.Predictor(sym.tojson(), params,
                            {"data": (8, 3, image, image),
                             "softmax_label": (8,)})
    refs = []
    for i in range(0, n_requests, 8):
        refs.extend(ref_pred.predict(np.stack(items[i:i + 8])))
    del ref_pred
    # Tolerance: both sides compute in float32 (TF32 off) but in other
    # orders: the fc kernel's K split against cuBLAS, and cuDNN's algorithm
    # per batch size (1..8 in the engine, 8 in the reference); float32
    # rounding differences stay near 1e-6 relative through 16 layers, so
    # rtol 1e-3, atol 1e-6 on the softmax output holds every answer while
    # any wrong layer moves the logits by far more.
    worst = 0.0
    for i, (a, r) in enumerate(zip(answers, refs)):
        if a is None or a.shape != (classes,) or not np.all(np.isfinite(a)):
            fail("answer %d malformed: %r" % (i, a))
        if not np.allclose(a, r, rtol=1e-3, atol=1e-6):
            fail("answer %d differs from the unfused reference: max abs "
                 "err %.3g" % (i, np.abs(a - r).max()))
        worst = max(worst, float(np.abs(a - r).max()))
    top = [int(np.argmax(a)) for a in answers]
    same_top = sum(int(t == int(np.argmax(r))) for t, r in zip(top, refs))
    print("serve: all %d answers match the unfused reference (max abs err "
          "%.3g, top-1 equal %d/%d, top-1 prob max %.4f)"
          % (n_requests, worst, same_top, n_requests,
             max(float(np.max(a)) for a in answers)))
    profile_forward(torch, engine._predictor,
                    {"data": (8, 3, image, image), "softmax_label": (8,)},
                    np.stack(items[:8]))
    return {"launches": launches, "batches": batches}


def profile_forward(torch, predictor, shapes, data, reps=3):
    """Where one bucket-8 forward of the fused serving graph spends its
    time: wall per forward (synchronized), device time by kernel from
    torch.profiler, and the device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile
    predictor.reshape(shapes)
    predictor.set_input("data", data)
    predictor.forward()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        predictor.forward()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / reps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            predictor.forward()
        torch.cuda.synchronize()
    from torch.autograd import DeviceType
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue                  # host ops: their kernels are listed
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0))
        if t > 0:
            rows.append((t / 1e3 / reps, e.key))
    rows.sort(reverse=True)
    device = sum(t for t, _ in rows)
    print("profile: bucket-8 forward %.3f ms wall (no profiler); device "
          "time %.3f ms per forward, busy share %.3f"
          % (wall, device, device / wall if wall else 0.0))
    for t, key in rows[:10]:
        print("profile:   %8.3f ms  %5.1f%%  %s"
              % (t, 100.0 * t / device if device else 0.0, key[:90]))
    groups = {}
    for t, key in rows:
        name = key.lower()
        group = ("fc_epilogue" if "fc_epilogue" in name else
                 "convolution" if any(s in name for s in (
                     "fprop", "fft", "conv", "pointwise_mult_and_sum")) else
                 "pooling" if "pool" in name else
                 "elementwise" if "elementwise" in name else "other")
        groups[group] = groups.get(group, 0.0) + t
    for group, t in sorted(groups.items(), key=lambda kv: -kv[1]):
        print("profile: group %-12s %8.3f ms  %5.1f%%"
              % (group, t, 100.0 * t / device if device else 0.0))
    gflop = conv_gflop(predictor.symbol, shapes)
    conv_ms = groups.get("convolution", 0.0)
    print("profile: convolutions %.1f GFLOP per forward, %.1f TFLOP/s over "
          "their device time (float32 peak 67)"
          % (gflop, gflop / conv_ms if conv_ms else 0.0))


def conv_gflop(symbol, shapes):
    """Convolution work of one forward: 2 * output elements * (C/g*kh*kw)."""
    internals = symbol.get_internals()
    _, outs, _ = internals.infer_shape(**shapes)
    args = dict(zip(symbol.list_arguments(), symbol.infer_shape(**shapes)[0]))
    total = 0.0
    for (node, _i), oshape in zip(internals._heads, outs):
        if node.op is not None and node.op.name in (
                "Convolution", "_fused_Convolution"):
            wshape = args[node.inputs[1][0].name]
            total += 2.0 * np.prod(oshape) * np.prod(wshape[1:])
    return total / 1e9


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        import mxnet_tpu_torch as mt
        from mxnet_tpu_torch.ops import cuda_kernels as ck
    except ImportError as e:
        print("chip_smoke: cannot import mxnet_tpu_torch (%s); run it from "
              "the root of a checkout" % e, file=sys.stderr)
        return 2

    # phase 1: environment
    smi = nvidia_smi_line()
    print("card: %s" % smi)
    print("torch %s, CUDA %s, python %s" % (
        torch.__version__, torch.version.cuda, sys.version.split()[0]))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("allow_tf32: matmul=%s cudnn=%s" % (
        torch.backends.cuda.matmul.allow_tf32,
        torch.backends.cudnn.allow_tf32))

    # phase 2: build
    t0 = time.perf_counter()
    logs = ck.build()
    print("build: %s in %.1f s" % (sorted(ck.SOURCES),
                                   time.perf_counter() - t0))
    for name, log in logs.items():
        regs = [int(w) for line in log.splitlines() if "Used" in line
                for w, nxt in zip(line.split(), line.split()[1:])
                if nxt.startswith("registers")]
        spills = [int(w) for line in log.splitlines() if "spill" in line
                  for w, nxt in zip(line.split(), line.split()[1:])
                  if nxt == "bytes"]
        print("build %s: %d kernel instantiations, registers max %d, "
              "spill/stack bytes max %d" % (name, len(regs), max(regs or [0]),
                                            max(spills or [0])))

    # phase 3: kernels against their plain versions
    fc = kernel_phase(torch, ck)

    # phase 4: the serving path
    served = serve_phase(torch, mt, ck)

    # phase 5: results
    kernels = [{
        "name": "fused_fc_epilogue", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/" + ck.SOURCES["fused_fc_epilogue"],
        "replaces": REPLACES["fused_fc_epilogue"],
        "launches": served["launches"]["fused_fc_epilogue"],
        "max_abs_err": fc["max_abs_err"],
        "ms": fc["ms"], "plain_ms": fc["plain_ms"],
        "bound_ms": fc["bound_ms"], "bound_by": "bytes",
        "library_ms": fc["library_ms"],
    }]
    missing = [k for k in ck.SOURCES
               if k not in [e["name"] for e in kernels]]
    if missing:
        fail("kernels not held against their plain versions: %s" % missing)
    print("kernel times are one bucket-8 batch's fc6 + fc7 launches")
    print(json.dumps({"kernels": kernels}))
    print("card: %s" % smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
