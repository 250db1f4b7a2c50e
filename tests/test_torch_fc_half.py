"""float16 and bfloat16 in the port's fused_fc_epilogue against the JAX
package's, on the CPU.

x and W of one 16-bit dtype run the tensor-core instance of
``csrc/fc_epilogue.cu`` on the card: 16-byte loads of W rows and x rows
straight into the m16n8k16 fragments under a fixed permutation of K,
float32 sums, stream-K units over the launcher's plan of warps, each
tile's pieces summed in warp order by a second kernel, then the epilogue,
rounded once.
Here, on CPU tensors, the wrapper takes its plain version, which is held
to the JAX Pallas kernel run with ``interpret=True`` in the same dtype,
within one unit in the dtype's last place at the outputs' scale,
``HALF_ULP[dtype] * max(1, max|jax|)`` (both sides round float32 sums
that differ by a few float32 ulps).  A numpy emulation of the kernel
(:func:`_emulate`: the fragments as the lanes load them, the units, the
pieces, the reduction and the epilogue, with the constants read from the
source) is held to the plain version within that ulp at the plan's warps
and at other splits, and writes each output once.  Also: the route rule,
the launch plan (:func:`_plan`, the launcher's ``tc_plan``) at VGG-16's
fc6 and fc7, and a narrow fused MLP bound in float16 through
``simple_bind`` against the JAX package's.
"""
import json
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu.ops.pallas_kernels import fused_fc_epilogue as pallas_fc
from mxnet_tpu.passes.quantize import \
    build_serving_pipeline as jax_serving_pipeline

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import cuda_kernels as ck
from mxnet_tpu_torch.passes.quantize import build_serving_pipeline

ACTS = ["none", "relu", "sigmoid", "tanh", "softrelu"]
DTYPES = {"float16": (torch.float16, jnp.float16),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}

with open(os.path.join(ck._CSRC, ck.SOURCES["fused_fc_epilogue"])) as _f:
    SOURCE = _f.read()
CONST = {k: int(v) for k, v in re.findall(
    r"^constexpr int (k\w+) = (\d+);", SOURCE, re.M)}
SMS = CONST["kTcSMs"]           # the H100 SXM's SMs, as the plan counts them
WARPS = SMS * CONST["kTcWarpsPerSM"]        # kTcWarps


def _plan(m, n, k):
    """fc_epilogue.cu's tc_plan and tc_workspace_bytes for x (m, k) and w
    (n, k): ``units`` T (8-row x blocks x 16-column tiles x 32-K chunks),
    ``warps`` min(kTcWarps, T), warp i taking units [i T / warps, (i + 1)
    T / warps); ``pieces``, the most warps one tile's units meet (each
    leaves the tile a 16 x 8 float32 piece); ``workspace_bytes``."""
    rows, cols = CONST["kTcRows"], CONST["kTcCols"]
    tiles = -(-m // cols) * -(-n // rows)
    kc = -(-k // CONST["kTcChunk"])
    units = tiles * kc
    warps = min(WARPS, units)
    seg = units // warps                   # the fewest units a warp takes
    pieces = -(-(kc - 1) // seg) + 1
    return {"units": units, "tiles": tiles, "chunks": kc, "warps": warps,
            "pieces": pieces,
            "workspace_bytes": tiles * pieces * rows * cols * 4}


def _inputs(m, k, n, dt, seed, bias=True):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (m, k)).astype(np.float32)
    w = (rng.uniform(-1, 1, (n, k)) / np.sqrt(k)).astype(np.float32)
    b = rng.uniform(-0.5, 0.5, (n,)).astype(np.float32) if bias else None
    return (torch.from_numpy(x).to(dt), torch.from_numpy(w).to(dt),
            None if b is None else torch.from_numpy(b).to(dt))


def _ulp_tol(ref, dt):
    return ck.HALF_ULP[dt] * max(1.0, float(ref.float().abs().max()))


# ---------------------------------------------------------------------------
# (a) the plain version against the Pallas kernel in the same dtype

@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("act", ACTS)
def test_half_plain_version_matches_pallas_interpret(act, bias, dt):
    tdt, jdt = DTYPES[dt]
    x, w, b = _inputs(8, 256, 256, tdt, seed=ACTS.index(act), bias=bias)
    want = pallas_fc(jnp.asarray(x.float().numpy()).astype(jdt),
                     jnp.asarray(w.float().numpy()).astype(jdt),
                     None if b is None else
                     jnp.asarray(b.float().numpy()).astype(jdt),
                     act, interpret=True)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = ck.fused_fc_epilogue(x, w, b, act)
    assert got.dtype == tdt and got.shape == want.shape == (8, 256)
    tol = ck.HALF_ULP[tdt] * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got.float().numpy() - want).max()) <= tol


# ---------------------------------------------------------------------------
# (b) the tensor-core instance, emulated

def _k_order():
    """koff[s][slot]: the K offset within a 32-K chunk that m16n8k16 step
    s's slot holds.  Lane (g, t) loads K 8t..8t+7 as four registers of
    two elements (x, y, z, w); step s takes registers 2s (slots 2t, 2t+1:
    a0, a1, b0) and 2s + 1 (slots 2t+8, 2t+9: a2, a3, b1)."""
    koff = np.full((2, 16), -1)
    for t in range(4):
        for s in range(2):
            for half, reg in enumerate((2 * s, 2 * s + 1)):
                for j in range(2):
                    koff[s, 2 * t + 8 * half + j] = 8 * t + 2 * reg + j
    return koff


def _owner(f, total, warps):
    """The warp whose units hold unit f (fc_epilogue.cu tc_owner)."""
    return ((f + 1) * warps - 1) // total


def _emulate(x, w, b, act, out_scale=None, warps=None):
    """The tensor-core instance's arithmetic in numpy: warp by warp (the
    plan's, or ``warps``), its units' chunks as m16n8k16 products of the
    fragments the lanes load (float32 sums), each tile's piece at the
    warp's rank among the warps that meet the tile, then the reduction
    kernel's sum in warp order and the epilogue.  -> (out, writes a piece
    slot got, writes an output got)."""
    rows, cols = CONST["kTcRows"], CONST["kTcCols"]
    chunk, unroll = CONST["kTcChunk"], CONST["kTcUnroll"]
    m, k = x.shape
    n = w.shape[0]
    plan = _plan(m, n, k)
    warps = plan["warps"] if warps is None else warps
    nt, kc = -(-n // rows), -(-k // chunk)
    tiles = -(-m // cols) * nt
    total = tiles * kc
    seg = total // warps
    pieces = -(-(kc - 1) // seg) + 1
    if warps == plan["warps"]:
        assert pieces == plan["pieces"] and plan["workspace_bytes"] == \
            tiles * pieces * rows * cols * 4
    # zero-padded to whole tiles and chunks: what the masked loads give
    xp = np.zeros((-(-m // cols) * cols, kc * chunk), np.float32)
    wp = np.zeros((nt * rows, kc * chunk), np.float32)
    xp[:m, :k] = x.float().numpy()
    wp[:n, :k] = w.float().numpy()
    koff = _k_order()
    part = np.full((tiles, pieces, 32, 4), np.nan, np.float32)
    slot_writes = np.zeros((tiles, pieces), np.int64)
    for gw in range(warps):
        f, hi = gw * total // warps, (gw + 1) * total // warps
        while f < hi:
            tile = f // kc
            ch0, ch1 = f - tile * kc, min(kc, hi - tile * kc)
            n0, m0 = (tile % nt) * rows, (tile // nt) * cols
            acc = np.zeros((rows, cols), np.float32)
            for ch in range(ch0, ch1, unroll):
                for c in range(ch, min(ch + unroll, ch1)):
                    for s in range(2):
                        ks = c * chunk + koff[s]
                        a = wp[n0:n0 + rows][:, ks]             # 16 x 16
                        bb = xp[m0:m0 + cols][:, ks].T          # 16 x 8
                        acc = (acc + a @ bb).astype(np.float32)
            # lane (g, t) keeps c0..c3: rows g, g + 8 by cols 2t, 2t + 1
            frag = np.empty((32, 4), np.float32)
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for e in range(4):
                    frag[lane, e] = acc[g + 8 * (e >> 1), 2 * t + (e & 1)]
            rank = gw - _owner(tile * kc, total, warps)
            part[tile, rank] = frag
            slot_writes[tile, rank] += 1
            f = tile * kc + ch1
    flat = part.reshape(tiles, pieces, 128)
    out = np.zeros((m, n), np.float32)
    out_writes = np.zeros((m, n), np.int64)
    for mi in range(m):
        for ni in range(n):
            tile = (mi // cols) * nt + ni // rows
            r, c = ni % rows, mi % cols
            at = ((r % 8) * 4 + c // 2) * 4 + (r // 8) * 2 + c % 2
            count = _owner((tile + 1) * kc - 1, total, warps) - \
                _owner(tile * kc, total, warps) + 1
            v = np.float32(0)
            for j in range(count):
                v = np.float32(v + flat[tile, j, at])
            out[mi, ni] = v
            out_writes[mi, ni] += 1
    y = torch.from_numpy(out)
    if b is not None:
        y = y + b.float()
    if act != "none":
        y = ck.ACTIVATIONS[act](y)
    y = y.to(x.dtype) if out_scale is None else ck.requantize(y, out_scale)
    return y, slot_writes, out_writes


def test_the_k_order_is_a_permutation_of_the_chunk():
    koff = _k_order()
    assert sorted(koff.ravel().tolist()) == list(range(CONST["kTcChunk"]))
    # the emulation's fragments follow the source's register order
    assert "{ra[i].x, rb[i].x, ra[i].y, rb[i].y}" in SOURCE
    assert "{ra[i].z, rb[i].z, ra[i].w, rb[i].w}" in SOURCE
    assert "mma_16<E>(acc, lo, rx[i].x, rx[i].y)" in SOURCE
    assert "mma_16<E>(acc, hi4, rx[i].z, rx[i].w)" in SOURCE


# (M, N, K, warps): the plan's warps at every shape (K 784 and 1000 leave
# a ragged last chunk; a K % 8 != 0 such as 1001 takes the SIMT route,
# test_route_rule), and 7 warps at the small ones, whose long units cross
# tiles and leave several pieces a tile
EMULATED = ([(m, n, k, None) for m in (1, 3, 8, 9, 33) for n in (10, 37, 256)
             for k in (784, 1000)]
            + [(m, n, k, 7) for m in (1, 3, 9) for n in (10, 37)
               for k in (784, 1000)])


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("m,n,k,warps", EMULATED)
def test_emulated_instance_matches_the_plain_version(m, n, k, warps, dt):
    tdt = DTYPES[dt][0]
    x, w, b = _inputs(m, k, n, tdt, seed=m + n + k)
    got, slots, outs = _emulate(x, w, b, "relu", warps=warps)
    ref = ck.fused_fc_epilogue_reference(x, w, b, "relu")
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert (outs == 1).all()                   # each output written once
    assert slots.max() == 1                    # each piece slot at most once
    err = float((got.float() - ref.float()).abs().max())
    assert err <= _ulp_tol(ref, tdt), err


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("act", ACTS)
def test_emulated_splits_match_the_plain_version(act, dt):
    # one warp (no split), 5 (units crossing tiles) and the plan's: each
    # sums K in another order, every one within the ulp
    tdt = DTYPES[dt][0]
    x, w, b = _inputs(9, 784, 37, tdt, seed=5)
    ref = ck.fused_fc_epilogue_reference(x, w, b, act)
    for warps in (1, 5, None):
        got, slots, outs = _emulate(x, w, b, act, warps=warps)
        assert (outs == 1).all() and slots.max() == 1
        assert float((got.float() - ref.float()).abs().max()) <= \
            _ulp_tol(ref, tdt)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("act,scale", [("none", 2.0), ("relu", 2.0),
                                       ("none", 0.7)])
def test_emulated_int8_codes_equal_the_plain_version(act, scale, dt):
    # small integers are exact in both dtypes and their float32 sums
    # exact; scale 2 puts the odd sums on .5 ties
    tdt = DTYPES[dt][0]
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randint(-3, 4, (8, 512)).astype(np.float32))
    w = torch.from_numpy(rng.randint(-2, 3, (24, 512)).astype(np.float32))
    b = torch.from_numpy(rng.randint(-5, 6, (24,)).astype(np.float32))
    x, w = x.to(tdt), w.to(tdt)
    got, _, outs = _emulate(x, w, b, act, out_scale=scale, warps=9)
    want = ck.fused_fc_epilogue_reference(x, w, b, act, out_scale=scale)
    assert got.dtype == want.dtype == torch.int8 and (outs == 1).all()
    assert torch.equal(got, want)
    assert torch.equal(ck.fused_fc_epilogue(x, w, b, act, out_scale=scale),
                       want)


# ---------------------------------------------------------------------------
# the route rule and the source

def test_route_rule():
    """The launcher's rule: x and W of one 16-bit dtype, K > 0, K % 8 ==
    0, both 16-byte aligned take the tensor cores and a workspace; every
    other call (float32, mixed pairs, K 1001, a 2-byte view) a SIMT
    instance and none.  On the card, chip_smoke.py's phase 3 holds each
    of its cases' routes through fc_workspace_bytes."""
    rule = SOURCE[SOURCE.index("bool tc_route("):]
    rule = rule[:rule.index("}")]
    assert "return x_dtype == w_dtype && x_dtype != 0 && K > 0 && " \
        "K % 8 == 0 &&" in rule
    assert "mxtt::aligned(x, 16) && mxtt::aligned(w, 16);" in rule
    assert "if (M <= 0 || N <= 0 || !tc_route(x, w, K, x_dtype, w_dtype)) " \
        "return 0;" in SOURCE
    h16 = torch.float16
    # the workspace is the launcher's answer: CUDA operands only
    with pytest.raises(MXNetError, match="CUDA"):
        ck.fc_workspace_bytes(torch.zeros(4, 64, dtype=h16),
                              torch.zeros(8, 64, dtype=h16))
    # the plain version takes every route's shapes on the CPU
    y = ck.fused_fc_epilogue(torch.ones(3, 1001, dtype=h16),
                             torch.ones(5, 1001, dtype=h16) / 1001, None,
                             "relu")
    assert y.dtype == h16 and torch.equal(y, torch.ones(3, 5, dtype=h16))


def test_source_names_the_rule_and_takes_elem_conversions():
    assert "bool tc_route(" in SOURCE
    assert "K > 0 && K % 8 == 0" in SOURCE
    assert "mxtt::aligned(x, 16) && mxtt::aligned(w, 16)" in SOURCE
    assert "const bool tc = tc_route(x, w, K, x_dtype, w_dtype);" in SOURCE
    assert '#include "attention.cuh"' in SOURCE     # mma_16, elem.cuh
    assert "using mxtt::from_f32;" in SOURCE and \
        "using mxtt::to_f32;" in SOURCE
    assert "__half2float" not in SOURCE and "__float2half_rn" not in SOURCE
    assert "mma.sync.aligned" not in SOURCE         # attention.cuh's mma_16
    with open(os.path.join(ck._CSRC, "elem.cuh")) as f:
        assert "fc_epilogue" in f.read()
    assert (CONST["kTcRows"], CONST["kTcCols"], CONST["kTcChunk"]) == \
        (16, 8, 32)
    assert "constexpr int kTcWarps = kTcSMs * kTcWarpsPerSM;" in SOURCE
    # no float atomics, no shared memory on the tensor-core route
    tc = SOURCE[SOURCE.index("// the tensor-core instance\n"):
                SOURCE.index("// launchers")]
    assert "atomicAdd" not in tc and "__shared__" not in tc
    assert "griddepcontrol.wait" in tc and \
        "cudaLaunchAttributeProgrammaticStreamSerialization" in tc


# ---------------------------------------------------------------------------
# (c) the launch plan at VGG-16's fc6 and fc7

def _sm_units(m, n, k):
    """Units an SM streams when the grid's blocks of kTcWarpsPerSM warps
    fill the SMs in turn (block b on SM b mod 132)."""
    plan = _plan(m, n, k)
    warps, total = plan["warps"], plan["units"]
    i = np.arange(warps + 1, dtype=np.int64)
    per_warp = np.diff(i * total // warps)
    kw = CONST["kTcWarpsPerSM"]
    blocks = -(-warps // kw)
    per_block = np.add.reduceat(per_warp, np.arange(0, warps, kw))
    assert per_block.size == blocks
    return np.bincount(np.arange(blocks) % SMS, weights=per_block,
                       minlength=SMS), per_warp


@pytest.mark.parametrize("layer,k", [("fc6", 25088), ("fc7", 4096)])
@pytest.mark.parametrize("m", list(range(1, 9)))
def test_plan_spreads_the_stream_evenly(m, layer, k):
    n = 4096
    plan = _plan(m, n, k)
    assert plan == _plan(8, n, k)               # bucket 1..8: one plan
    assert plan["units"] == 256 * (k // 32) and plan["tiles"] == 256
    assert plan["warps"] == WARPS == 1056
    assert plan["pieces"] == 6
    # chip_smoke.FC_HALF_WORKSPACE: the launcher's answer on the card
    assert plan["workspace_bytes"] == 256 * 6 * 512 == 786432
    sm, per_warp = _sm_units(m, n, k)
    mean = plan["units"] / SMS
    assert per_warp.max() - per_warp.min() <= 1
    assert sm.max() <= 1.05 * mean and sm.min() >= 0.95 * mean, \
        (sm.min(), sm.max(), mean)
    blocks = -(-plan["warps"] // CONST["kTcWarpsPerSM"])
    assert blocks <= 65535 and CONST["kTcWarpsPerSM"] * 32 <= 1024
    assert -(-m * n // 256) <= 65535            # the reduction's grid
    # no shared memory: well within the 227 KB a block may use
    assert "__shared__" not in SOURCE[SOURCE.index(
        "// the tensor-core instance\n"):SOURCE.index("// launchers")]


def test_plan_depends_on_the_shape_alone_and_covers_every_unit():
    for m, n, k in ((1, 10, 8), (3, 37, 784), (33, 256, 1000),
                    (9, 4096, 4096), (200, 1000, 4096)):
        plan = _plan(m, n, k)
        assert 1 <= plan["warps"] <= min(WARPS, plan["units"])
        i = np.arange(plan["warps"] + 1, dtype=np.int64)
        bounds = i * plan["units"] // plan["warps"]
        assert bounds[0] == 0 and bounds[-1] == plan["units"]
        assert (np.diff(bounds) >= 1).all()
        # the most warps a tile's chunks meet fits the tile's slot
        kc = plan["chunks"]
        owner = ((np.arange(plan["units"]) + 1) * plan["warps"] - 1) \
            // plan["units"]
        per_tile = owner.reshape(plan["tiles"], kc)
        assert (per_tile[:, -1] - per_tile[:, 0] + 1).max() <= \
            plan["pieces"]


# ---------------------------------------------------------------------------
# (d) a fused MLP bound in float16, against the JAX package's

# Each layer's output: the port rounds float32 sums once to float16 (the
# kernel's plain version); the JAX package's fused FullyConnected on the
# CPU takes its jnp body, which rounds the product and then the bias add
# to float16.  Values below 1 through three layers: at most six float16
# roundings apart, each half an ulp (2^-11 at 1), carried on by weights
# of scale 1/sqrt(fan-in): atol 4 * 2^-10, while a wrong layer, layout or
# dtype path moves the outputs by O(0.1).
MLP_HALF_ATOL = 4 * 2.0 ** -10


def _mlp(pkg):
    data = pkg.sym.Variable("data")
    h = pkg.sym.FullyConnected(data, num_hidden=48, name="fc1")
    h = pkg.sym.Activation(h, act_type="relu", name="relu1")
    h = pkg.sym.FullyConnected(h, num_hidden=40, name="fc2")
    h = pkg.sym.Activation(h, act_type="relu", name="relu2")
    return pkg.sym.FullyConnected(h, num_hidden=10, name="fc3")


def test_fused_mlp_in_float16_through_simple_bind():
    shapes = {"data": (8, 64)}
    rng = np.random.RandomState(11)
    with mx.name.NameManager():
        jsym = _mlp(mx)
    with mt.name.NameManager():
        tsym = _mlp(mt)
    arg_shapes, _, _ = tsym.infer_shape(**shapes)
    params = {name: (rng.uniform(-1, 1, shape) /
                     np.sqrt(shape[-1])).astype(np.float16)
              for name, shape in zip(tsym.list_arguments(), arg_shapes)
              if name != "data"}
    x = rng.uniform(-1, 1, shapes["data"]).astype(np.float16)
    outs = []
    for pkg, sym, pipe in (
            (mx, jsym, jax_serving_pipeline(fuse=True, ctx=mx.cpu())),
            (mt, tsym, build_serving_pipeline(fuse=True, ctx=mt.cpu()))):
        fsym, fparams = pipe.run(sym, {k: pkg.nd.array(v, ctx=pkg.cpu())
                                       for k, v in params.items()})
        ops = [n["op"] for n in json.loads(fsym.tojson())["nodes"]]
        assert ops.count("_fused_FullyConnected") == 2
        ex = fsym.simple_bind(pkg.cpu(), grad_req="null",
                              type_dict={a: np.float16
                                         for a in fsym.list_arguments()},
                              **shapes)
        ex.copy_params_from(dict(fparams), {}, allow_extra_params=True)
        outs.append(ex.forward(is_train=False, data=x)[0].asnumpy())
    want, got = outs
    assert got.dtype == want.dtype == np.float16 and got.shape == (8, 10)
    np.testing.assert_allclose(got.astype(np.float32),
                               want.astype(np.float32), rtol=0,
                               atol=MLP_HALF_ATOL)
