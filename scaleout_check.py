#!/usr/bin/env python3
"""Two checks of the port's data-parallel training beyond phase 21 of
chip_smoke.py, on ResNet-50 at a global batch of 128 (chip_smoke's
``resnet_setup``, seed 21; bench.py's SGD), held against one rank's
``Module.fit`` on the same global batches with phase 21 (b)'s gates.

    python3 scaleout_check.py faults
        One card, two ranks sharing it (gloo by the backend rule):
        ``fit(kvstore="dist_sync")`` and ``fit(mesh=dp=2)``, as they are
        and with a fault planted in the rank processes at run time (no
        file changes): the gradient all-reduce dropped, or BatchNorm
        normalizing by each rank's own statistics.  Prints every reading
        beside its gate; fails if the clean run misses a gate or a
        faulty one meets them all.

    python3 scaleout_check.py nccl
        Four cards, one rank each, NCCL by the backend rule:
        ``fit(kvstore="dist_sync")``, ``fit(mesh=dp=4)`` and the latter
        under ``MXNET_SHARD_WEIGHT_UPDATE=1``, every rank on the default
        context ``gpu(0)``, which must resolve to its own card.  Each
        route must capture its step once, collectives inside; a replay's
        NCCL kernels are counted and timed; dist_sync and the mesh agree
        bitwise; each route's first step against one rank's.

    --cpu   the same control flow on the CPU over gloo, with a small
            BatchNorm net at batch 16: a dry run, gates printed only.

Gates (phase 21 (b)): the first step's update and moving-statistics
change, relative L2 against one rank's, at most SCALE_RATIO times what
the data nudged by one ulp moves them by; the ranks' params and moving
statistics equal after the last step.  The numbers go to stdout.
"""
import argparse
import os
import sys
import time

import numpy as np

import chip_smoke as cs

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 21
FAULTS = ("none", "no-gradient-all-reduce", "per-rank-batchnorm")
NCCL_RANKS = 4


def deterministic(torch):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True


def setup(mt, cpu):
    """chip_smoke's ResNet-50 setup, or on the CPU a small BatchNorm net
    at batch 16 in the same form."""
    if not cpu:
        return cs.resnet_setup(mt, cs.SCALE_STEPS, SEED)
    S = mt.sym
    net = S.Convolution(S.Variable("data"), kernel=(3, 3), pad=(1, 1),
                        num_filter=8, name="c1")
    net = S.Activation(S.BatchNorm(net, name="bn1"), act_type="relu")
    net = S.Pooling(net, kernel=(2, 2), stride=(2, 2), pool_type="max")
    net = S.FullyConnected(S.Flatten(net), num_hidden=10, name="fc")
    sym = S.SoftmaxOutput(net, name="softmax")
    b, shape = 16, (16, 3, 8, 8)
    init = mt.mod.Module(sym, context=mt.cpu())
    init.bind([("data", shape)], [("softmax_label", (b,))])
    mt.random.seed(SEED)
    init.init_params(mt.init.Xavier(factor_type="in", magnitude=2.34))
    arg0, aux0 = init.get_params()
    rng = np.random.default_rng(SEED + 1)
    batches = [mt.io.DataBatch(
        data=[mt.nd.array(rng.random(shape, dtype=np.float32),
                          ctx=mt.cpu())],
        label=[mt.nd.array(rng.integers(0, 10, b).astype(np.float32),
                           ctx=mt.cpu())], pad=0)
        for _ in range(cs.SCALE_STEPS)]
    return sym, arg0, aux0, batches, [("data", shape)], \
        [("softmax_label", (b,))]


def run_fit(mt, su, ctx, feed, pd, pl, kv="local", mesh=None):
    """-> (module, host params after the first step)."""
    sym, arg0, aux0 = su[:3]
    first = []
    mod = mt.mod.Module(sym, context=ctx)
    mod.fit(cs.batch_iter(mt, feed, pd, pl), num_epoch=1, kvstore=kv,
            mesh=mesh, optimizer_params=dict(cs.TRAIN_OPT),
            arg_params=arg0, aux_params=aux0,
            batch_end_callback=lambda p: first.append(cs.host_params(mod))
            if p.nbatch == 0 else None)
    return mod, first[0]


def reference(cpu):
    """One rank on the global batches, and the one-ulp nudge's drift."""
    import torch
    import mxnet_tpu_torch as mt
    deterministic(torch)
    su = setup(mt, cpu)
    ctx = mt.cpu() if cpu else mt.gpu(0)
    batches, pd, pl = su[3:]
    nudged = [mt.io.DataBatch(
        data=[mt.nd.array(np.nextafter(bt.data[0].asnumpy(),
                                       np.float32(np.inf)), ctx=mt.cpu())],
        label=bt.label, pad=0) for bt in batches]
    mod, pn_first = run_fit(mt, su, ctx, nudged, pd, pl)
    pn = cs.host_params(mod)
    mod, one_first = run_fit(mt, su, ctx, batches, pd, pl)
    one = cs.host_params(mod)
    del mod
    init = ({k: v.asnumpy() for k, v in su[1].items()},
            {k: v.asnumpy() for k, v in su[2].items()})
    return {"one": one, "one_first": one_first, "init": init,
            "nudge_first": [cs.first_step_l2(pn_first[i], one_first[i],
                                             init[i]) for i in (0, 1)],
            "nudge": [cs.rel_l2([pn[i]], [one[i]]) for i in (0, 1)],
            "update": [cs.rel_l2([init[i]], [one[i]]) for i in (0, 1)]}


def plant(fault):
    """Break this rank process's copy of the port in memory."""
    from mxnet_tpu_torch.ops import nn
    from mxnet_tpu_torch.parallel import collectives as C
    if fault == "no-gradient-all-reduce":
        C.all_reduce_coalesced_ = lambda tensors, axis: None
    elif fault == "per-rank-batchnorm":
        own = object()
        all_reduce_, apply = C.all_reduce_, nn._DPBatchNorm.apply
        C.all_reduce_ = lambda x, axis: x if axis is own \
            else all_reduce_(x, axis)
        nn._DPBatchNorm.apply = lambda x, w, b, eps, axis: apply(
            x, w, b, eps, own)


def rank_fits(cpu, routes, fault="none", profile=False):
    """On one rank: each route's fit over the global batches (dist_sync
    fed this rank's rows, a mesh fed them all); -> its results."""
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.dist import boot
    deterministic(torch)
    plant(fault)
    W, r = boot.world_size(), boot.rank()
    su = setup(mt, cpu)
    batches, pd, pl = su[3:]
    b = pd[0][1][0] // W
    local = [mt.io.DataBatch(
        data=[mt.nd.array(bt.data[0].asnumpy()[r * b:(r + 1) * b],
                          ctx=mt.cpu())],
        label=[mt.nd.array(bt.label[0].asnumpy()[r * b:(r + 1) * b],
                           ctx=mt.cpu())], pad=0) for bt in batches]
    lpd = [("data", (b,) + pd[0][1][1:])]
    lpl = [("softmax_label", (b,))]
    ctx = mt.cpu() if cpu else mt.gpu(0)
    out = {"boot": boot.describe(), "backend": boot.backend()}
    for name in routes:
        if name.endswith("shard"):
            os.environ["MXNET_SHARD_WEIGHT_UPDATE"] = "1"
        if name == "dist_sync":
            mod, first = run_fit(mt, su, ctx, local, lpd, lpl,
                                 kv="dist_sync")
        else:
            mod, first = run_fit(mt, su, ctx, batches, pd, pl,
                                 mesh=mt.parallel.make_mesh("dp=%d" % W))
        os.environ.pop("MXNET_SHARD_WEIGHT_UPDATE", None)
        params = cs.host_params(mod)
        res = {"params": params if r == 0 else None,
               "first": first if r == 0 else None,
               "digest": cs.param_digest(params),
               "device": str(mod._fused.device),
               "stats": mod._fused.stats.report()}
        if profile:
            feed = local if name == "dist_sync" else batches
            bufs = mod._fused.make_batch(feed[0])
            wall, device, rows = cs.device_profile(
                torch, lambda: mod._fused.step(bufs), reps=5)
            nccl = [(t, k, n) for t, k, n in rows if "nccl" in k.lower()]
            res.update(wall_ms=wall, device_ms=device,
                       img_s=pd[0][1][0] / (wall / 1e3),
                       nccl_ms=sum(t for t, _, _ in nccl),
                       nccl_launches=sum(n for _, _, n in nccl),
                       nccl_kernels=sorted({k[:60] for _, k, _ in nccl}))
        out[name] = res
        del mod
        if not cpu:
            torch.cuda.empty_cache()
    return out


def readings(ranks, name, ref):
    rd = cs.fit_readings(ranks, name, ref["one"], ref["one_first"],
                         ref["init"])
    rd["same"] = all(r[name]["digest"] == ranks[0][name]["digest"]
                     for r in ranks)
    gate = [cs.SCALE_RATIO * x for x in ref["nudge_first"]]
    tripped = [g for g, bad in (
        ("first-step update", rd["first"][0] > gate[0]),
        ("first-step moving statistics", rd["first"][1] > gate[1]),
        ("ranks agree", not rd["same"])) if bad]
    return {"first": rd["first"], "gates": gate, "same": rd["same"],
            "steps": rd["steps"], "tripped": tripped,
            "worst": [(k, v) for v, k in rd["worst"]]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("faults", "nccl"))
    ap.add_argument("--cpu", action="store_true")
    a = ap.parse_args()
    import torch
    from mxnet_tpu_torch.dist.spawn import run_ranks
    from mxnet_tpu_torch.module.fused import WARMUP_STEPS
    if not a.cpu and not torch.cuda.is_available():
        sys.exit("scaleout_check: torch sees no CUDA device (--cpu for a "
                 "dry run)")
    smi = "cpu" if a.cpu else cs.nvidia_smi_line()
    print("scaleout_check %s on %s" % (a.mode, smi))
    t0 = time.perf_counter()
    ref = reference(a.cpu)
    print("one rank, batch %d, %d steps: the one-ulp nudge moves the "
          "first step's update and moving-statistics change by %.3g, "
          "%.3g (gates %g x those), the last step's params and moving "
          "statistics by %.3g, %.3g; the %d steps' update %.3g, %.3g "
          "(relative L2)" % (
              cs.RESNET_BATCH if not a.cpu else 16, cs.SCALE_STEPS,
              ref["nudge_first"][0], ref["nudge_first"][1], cs.SCALE_RATIO,
              ref["nudge"][0], ref["nudge"][1], cs.SCALE_STEPS,
              ref["update"][0], ref["update"][1]))
    target = os.path.join(ROOT, "scaleout_check.py") + ":rank_fits"
    bad = []
    if a.mode == "faults":
        routes = ("dist_sync", "mesh-dp2")
        for fault in FAULTS:
            ranks = run_ranks(target, 2, args=(a.cpu, routes, fault),
                              timeout=600)
            for name in routes:
                rd = readings(ranks, name, ref)
                print("fault %-22s %-9s first step: update %.3g, moving "
                      "statistics %.3g (gates %.3g, %.3g); ranks agree %s; "
                      "reading: after %d steps %.3g, %.3g; gates tripped "
                      "%s; %s" % (fault, name, rd["first"][0],
                                  rd["first"][1], rd["gates"][0],
                                  rd["gates"][1], rd["same"],
                                  cs.SCALE_STEPS, rd["steps"][0],
                                  rd["steps"][1], rd["tripped"] or "none",
                                  ranks[0]["boot"]))
                if (fault == "none") == bool(rd["tripped"]):
                    bad.append("%s/%s" % (fault, name))
    else:
        W = NCCL_RANKS
        routes = ("dist_sync", "mesh", "mesh-shard")
        ranks = run_ranks(target, W, args=(a.cpu, routes, "none",
                                           not a.cpu), timeout=600)
        print(ranks[0]["boot"])
        if not a.cpu and any(r["backend"] != "nccl" for r in ranks):
            bad.append("backend")
        for name in routes:
            rd = readings(ranks, name, ref)
            devices = [r[name]["device"] for r in ranks]
            stats = ranks[0][name]["stats"]
            rd.update(devices=devices, stats=stats)
            for key in ("img_s", "wall_ms", "device_ms", "nccl_ms",
                        "nccl_launches", "nccl_kernels"):
                if key in ranks[0][name]:
                    rd[key] = [r[name][key] for r in ranks]
            print("nccl %-10s W=%d devices %s, step %s; first step: update "
                  "%.3g, moving statistics %.3g (gates %.3g, %.3g); ranks "
                  "agree %s; reading: after %d steps %.3g, %.3g" % (
                      name, W, devices, stats, rd["first"][0],
                      rd["first"][1], rd["gates"][0], rd["gates"][1],
                      rd["same"], cs.SCALE_STEPS, rd["steps"][0],
                      rd["steps"][1]))
            if "img_s" in rd:
                print("nccl %-10s a replay: %s ms wall, %s ms device, "
                      "%.1f img/s (rank 0), NCCL kernels %s launches, %s "
                      "ms (%s); card %s" % (
                          name, ["%.3f" % x for x in rd["wall_ms"]],
                          ["%.3f" % x for x in rd["device_ms"]],
                          rd["img_s"][0], rd["nccl_launches"],
                          ["%.3f" % x for x in rd["nccl_ms"]],
                          rd["nccl_kernels"][0], smi))
            if rd["tripped"]:
                bad.append(name)
            if not a.cpu:
                want = ["cuda:%d" % i for i in range(W)]
                captured = stats == {
                    "captures": 1, "replays": cs.SCALE_STEPS - WARMUP_STEPS,
                    "eager_steps": WARMUP_STEPS}
                if devices != want or not captured or \
                        not all(n > 0 for n in rd["nccl_launches"]):
                    bad.append(name + " capture/devices")
        routes_same = cs.bitwise(ranks[0]["dist_sync"]["params"][0],
                                 ranks[0]["mesh"]["params"][0]) and \
            cs.bitwise(ranks[0]["dist_sync"]["params"][1],
                       ranks[0]["mesh"]["params"][1])
        shard_same = cs.bitwise(ranks[0]["mesh-shard"]["params"][0],
                                ranks[0]["mesh"]["params"][0])
        print("nccl dist_sync and mesh bitwise %s (gate); mesh-shard and "
              "mesh params bitwise %s (reading)" % (routes_same, shard_same))
        if not routes_same:
            bad.append("routes")
    print("scaleout_check: %.1f s; %s" % (
        time.perf_counter() - t0,
        "failed: %s" % bad if bad else "every gate held"))
    if bad and not a.cpu:
        sys.exit(1)


if __name__ == "__main__":
    main()
