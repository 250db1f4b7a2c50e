"""float16 and bfloat16 in the port's attention and correlation kernels
against the JAX package's, on the CPU.

The JAX kernels take any float dtype: each operand is upcast to float32 as
it is loaded, the arithmetic is float32, and the output is rounded once to
q's (a's) dtype.  The port's correlation kernel does the same for
``|a - b|`` (``csrc/elem.cuh``); its flash, paged and correlation kernels
multiply 16-bit operands on the tensor cores (``csrc/attention.cuh``: q·k
and a·b in one 16-bit product, p·v in two, p split into ``rn(p)`` and
``rn(p - rn(p))`` in v's dtype, float32 sums), which ``chip_smoke.py``
phase 28 holds on the card within one unit in the last place of the
float32 instance's output.  Here, on
CPU tensors, the port's wrappers take their plain versions; each is held,
in float16 and bfloat16, to the JAX Pallas kernel run with
``interpret=True`` in the same dtype, within one unit in the dtype's last
place at the outputs' scale, ``HALF_ULP[dtype] * max(1, max|jax|)``
(2^-10 for float16, 2^-7 for bfloat16): both sides round float32 results
that differ by a few float32 ulps.  So are plain-PyTorch emulations of the
16-bit kernels' arithmetic (:func:`_emulate_16bit`,
:func:`_emulate_corr_16bit`), which show that the one-ulp gate holds for
the design and not only for the card's sums.
Also: operands of mixed float dtypes; the ``Correlation`` op bound in
float16 through ``simple_bind(type_dict=)`` against the JAX op (its lax
lowering on the CPU); a bfloat16 ``KVBlockPool`` view; the wrappers'
dtype checks and C interfaces; the 16-bit kernels' sources; the kernel
search without ``ml_dtypes``.
"""
import os
import re
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu.autotune import kernelsearch as jax_ks
from mxnet_tpu.ops.pallas_kernels import (_paged_attention_dense,
                                          correlation as pallas_corr,
                                          flash_attention as pallas_flash,
                                          paged_attention as pallas_paged)

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.autotune import kernelsearch as ks
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import cuda_kernels as ck
from mxnet_tpu_torch.serve import KVBlockPool

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = {"float16": (torch.float16, jnp.float16),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _to_jax(t):
    """A torch tensor as a jax array of the same dtype and values."""
    jdt = {torch.float16: jnp.float16, torch.bfloat16: jnp.bfloat16,
           torch.float32: jnp.float32, torch.int32: jnp.int32}[t.dtype]
    return jnp.asarray(t.float().numpy() if t.is_floating_point()
                       else t.numpy()).astype(jdt)


def _assert_ulp(got, want, dtype):
    """got (torch) within one unit in the last place of want (jax)."""
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.dtype == dtype and got.shape == want.shape
    tol = ck.HALF_ULP[dtype] * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got.float().numpy() - want).max())
    assert err <= tol, (err, tol)


def _randn(shape, dtype, seed):
    return torch.from_numpy(np.random.RandomState(seed).randn(*shape)
                            .astype(np.float32)).to(dtype)


# ---------------------------------------------------------------------------
# flash_attention

@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t", [64, 77])
def test_flash_half_matches_pallas_interpret(dt, causal, t):
    tdt, jdt = DTYPES[dt]
    q, k, v = (_randn((2, t, 2, 16), tdt, s) for s in range(3))
    got = ck.flash_attention(q, k, v, causal=causal)
    want = pallas_flash(*(_to_jax(x) for x in (q, k, v)), causal=causal,
                        block_q=32, block_k=32, interpret=True)
    assert want.dtype == jdt
    _assert_ulp(got, want, tdt)


# ---------------------------------------------------------------------------
# paged_attention

def _paged_inputs(dtype, c=3, bt=4, h=2, d=8, blocks=12, seed=0):
    """Lengths straddling blocks and an empty slot; unassigned entries at
    the sentinel row ``blocks``, which holds large finite values the
    lengths must mask; physical blocks out of order."""
    rng = np.random.RandomState(seed)
    lengths = np.array([5, 13, 0, 9], np.int32)
    s, max_b = len(lengths), 4
    pages = np.full((s, max_b), blocks, np.int32)
    order = rng.permutation(blocks)
    nxt = 0
    for i, n in enumerate(lengths):
        for b in range(-(-int(n) // bt)):
            pages[i, b] = order[nxt]
            nxt += 1
    k_pool = _randn((blocks + 1, bt, h, d), dtype, seed + 1)
    v_pool = _randn((blocks + 1, bt, h, d), dtype, seed + 2)
    k_pool[blocks] = 1e3
    v_pool[blocks] = 1e3
    q = _randn((s, c, h, d), dtype, seed + 3)
    q_pos = lengths[:, None] - c + np.arange(c, dtype=np.int32)[None]
    return [q, k_pool, v_pool, torch.from_numpy(pages),
            torch.from_numpy(lengths), torch.from_numpy(q_pos)]


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("c", [1, 3])
def test_paged_half_matches_pallas_walk_and_dense(dt, causal, c):
    tdt, jdt = DTYPES[dt]
    args = _paged_inputs(tdt, c=c, seed=c)
    got = ck.paged_attention(*args, causal=causal)
    jargs = [_to_jax(a) for a in args]
    walk = pallas_paged(*jargs[:5], q_pos=jargs[5], causal=causal,
                        interpret=True)
    dense = _paged_attention_dense(*jargs, causal=causal)
    assert walk.dtype == dense.dtype == jdt
    _assert_ulp(got, walk, tdt)
    _assert_ulp(got, dense, tdt)
    assert (got[2] == 0).all()                   # the empty slot


@pytest.mark.parametrize("dt", list(DTYPES))
def test_paged_over_a_half_pool_view(dt):
    """paged_attention over KVBlockPool.add_view(dtype=) on the host, every
    slot at the page table's capacity, against the JAX page walk."""
    tdt, _ = DTYPES[dt]
    slots, per_slot, bt, h, d = 3, 4, 4, 2, 8
    pool = KVBlockPool(slots, per_slot, block_tokens=bt, device="cpu")
    pool.add_view("lm", 2, h, d, dtype=tdt)
    for s in range(slots):
        assert pool.reserve(s, per_slot)
        pool.ensure(s, per_slot * bt)
    kv_k, kv_v = pool.view("lm")
    assert kv_k.dtype == kv_v.dtype == tdt
    assert pool.device_bytes() == 2 * kv_k.numel() * 2
    kv_k.copy_(_randn(kv_k.shape, torch.float32, 7))
    kv_v.copy_(_randn(kv_v.shape, torch.float32, 8))
    pages = torch.from_numpy(pool.page_table().copy())
    lengths = torch.full((slots,), per_slot * bt, dtype=torch.int32)
    q = _randn((slots, 2, h, d), tdt, 9)
    q_pos = lengths[:, None] - 2 + torch.arange(2, dtype=torch.int32)[None]
    args = [q, kv_k[1], kv_v[1], pages, lengths, q_pos]
    got = ck.paged_attention(*args)
    jargs = [_to_jax(a) for a in args]
    want = pallas_paged(*jargs[:5], q_pos=jargs[5], interpret=True)
    _assert_ulp(got, want, tdt)


# ---------------------------------------------------------------------------
# the 16-bit flash and paged kernels' arithmetic, emulated

LOG2E = np.float32(1.4426950408889634)


def _emulate_16bit(q, k, v, mask, tile, split):
    """The 16-bit kernels' arithmetic in plain PyTorch.  q (..., R, D),
    k and v (..., K, D) of one 16-bit dtype, taken exactly in float32;
    mask (..., R, K) the keys each row sees.  S = q·kᵀ in float32 (each
    product of two 16-bit values is exact) times scale·log2 e; keys walked
    in tiles of ``tile`` with an online softmax in log2 units (the row's
    running max, the isinf guards); with ``split`` each tile's float32 p
    goes into P·V as two parts in v's dtype, ``rn(p)`` and ``rn(p -
    rn(p))``, the small part first, as attention_tile_16 multiplies it
    (without, p stays float32, as the paged kernel's one-row path keeps
    it); l sums the float32 p, is clamped at 1e-20, and the output is
    rounded once to v's dtype."""
    dt = v.dtype
    qf, kf, vf = q.float(), k.float(), v.float()
    scale_log2 = np.float32(np.float32(1.0 / np.sqrt(q.shape[-1])) * LOG2E)
    s = torch.where(mask, (qf @ kf.transpose(-1, -2)) * scale_log2,
                    torch.tensor(-np.inf))
    m = torch.full(s.shape[:-1], -np.inf)
    l = torch.zeros(s.shape[:-1])
    o = torch.zeros(s.shape[:-1] + (v.shape[-1],))
    for k0 in range(0, s.shape[-1], tile):
        st, vt = s[..., k0:k0 + tile], vf[..., k0:k0 + tile, :]
        new_m = torch.maximum(m, st.amax(-1))
        safe = torch.where(torch.isinf(new_m), 0.0, new_m)
        corr = torch.where(torch.isinf(m), 0.0, torch.exp2(m - safe))
        p = torch.where(torch.isinf(st), 0.0,
                        torch.exp2(st - safe[..., None]))
        l = l * corr + p.sum(-1)
        o = o * corr[..., None]
        if split:
            hi = p.to(dt).float()
            lo = (p - hi).to(dt).float()
            o = o + lo @ vt
            o = o + hi @ vt
        else:
            o = o + p @ vt
        m = new_m
    return (o / l.clamp_min(1e-20)[..., None]).to(dt)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t,block_k", [(64, 32), (77, 32), (77, 64)],
                         ids=["T64", "ragged-T77", "ragged-T77-bk64"])
def test_flash_16bit_arithmetic_within_one_ulp_of_pallas(dt, causal, t,
                                                         block_k):
    tdt, _ = DTYPES[dt]
    q, k, v = (_randn((2, t, 2, 16), tdt, 20 + s) for s in range(3))
    mask = torch.ones(t, t, dtype=torch.bool)
    if causal:
        mask = mask.tril()
    got = _emulate_16bit(*(x.permute(0, 2, 1, 3) for x in (q, k, v)),
                         mask, block_k, split=True).permute(0, 2, 1, 3)
    want = pallas_flash(*(_to_jax(x) for x in (q, k, v)), causal=causal,
                        block_q=32, block_k=32, interpret=True)
    _assert_ulp(got, want, tdt)


def _paged_wide(dtype, c, seed):
    """Slots whose contexts straddle several 32-key chunks, an empty slot,
    unassigned page entries at the sentinel block (large finite values
    the lengths must mask), blocks out of order; bt 8, 10 blocks a slot."""
    rng = np.random.RandomState(seed)
    lengths = np.array([37, 70, 0, 80], np.int32)
    s, max_b, bt, blocks, h, d = len(lengths), 10, 8, 30, 2, 16
    pages = np.full((s, max_b), blocks, np.int32)
    order = rng.permutation(blocks)
    nxt = 0
    for i, n in enumerate(lengths):
        for b in range(-(-int(n) // bt)):
            pages[i, b] = order[nxt]
            nxt += 1
    k_pool = _randn((blocks + 1, bt, h, d), dtype, seed + 1)
    v_pool = _randn((blocks + 1, bt, h, d), dtype, seed + 2)
    k_pool[blocks] = 1e3
    v_pool[blocks] = 1e3
    q = _randn((s, c, h, d), dtype, seed + 3)
    q_pos = lengths[:, None] - c + np.arange(c, dtype=np.int32)[None]
    return [q, k_pool, v_pool, torch.from_numpy(pages),
            torch.from_numpy(lengths), torch.from_numpy(q_pos)]


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("c", [1, 32])
def test_paged_16bit_arithmetic_within_one_ulp_of_pallas(dt, causal, c):
    """The paged kernel's 16-bit arithmetic over the gathered context: two
    16-bit parts of p at C = 32 (its tensor-core row tile), float32 p at
    C = 1 (its one-row path), 32-key chunks."""
    tdt, _ = DTYPES[dt]
    args = _paged_wide(tdt, c, seed=30 + c)
    q, k_pool, v_pool, pages, lengths, q_pos = args
    n, bt = k_pool.shape[:2]
    s_, _, h, d = q.shape
    safe = pages.long().clamp(0, n - 1)
    kg, vg = (p[safe].reshape(s_, -1, h, d).permute(0, 2, 1, 3)
              for p in (k_pool, v_pool))
    keys = torch.arange(kg.shape[2])
    mask = (keys[None, :] < lengths.long()[:, None])[:, None, None, :]
    if causal:
        mask = mask & (keys[None, None, :]
                       <= q_pos.long()[:, :, None])[:, None]
    got = _emulate_16bit(q.permute(0, 2, 1, 3), kg, vg, mask, 32,
                         split=c > 1).permute(0, 2, 1, 3)
    jargs = [_to_jax(a) for a in args]
    want = pallas_paged(*jargs[:5], q_pos=jargs[5], causal=causal,
                        interpret=True)
    _assert_ulp(got, want, tdt)
    assert (got[2] == 0).all()                   # the empty slot


def test_16bit_kernels_multiply_16bit_operands_from_16bit_stages():
    """The 16-bit flash, paged and correlation paths: m16n8k16 products
    in float16 and bfloat16 (one for q·k and for a·b, two for p·v) on
    fragments read through ldmatrix from stages in the operands' type,
    filled by cp.async; no staging through float32 registers (the stage_f32
    that correlation used is gone from elem.cuh)."""
    def read(name):
        with open(os.path.join(ck._CSRC, name)) as f:
            return f.read()
    header = read("attention.cuh")
    for e in ("f16.f16", "bf16.bf16"):
        assert "mma.sync.aligned.m16n8k16.row.col.f32.%s.f32" % e in header
    assert "ldmatrix.sync.aligned.m8n8.x4.shared.b16" in header
    assert "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16" in header
    step = header[header.index("void attention_tile_16("):]
    assert step.count("mma_16<E>(o[") == 4         # p·v: two parts a tile
    assert step.count("mma_16<E>(s[") == 2         # q·k: one product
    assert "split16<E>(" in step and "split_tf32" not in step
    flash, paged = read("flash_attention.cu"), read("paged_attention.cu")
    for text, stage in ((flash, "E* ks = ring + "),
                        (paged, "P* ks = stages + ")):
        assert "mxtt::attention_tile_16<" in text
        assert "stage_f32" not in text
        assert stage in text and "cp_async16(ks + " in text
        assert "constexpr int kHalfStages = " in text
    corr = read("correlation.cu")
    assert "stage_f32" not in corr and "stage_f32" not in read("elem.cuh")
    # attention.cuh's copies, ldmatrix and mma_16, no copies of them
    assert '#include "attention.cuh"' in corr
    assert "asm volatile" not in corr
    tc = corr[corr.index("correlation_tc_kernel(const E*"):]
    tc = tc[:tc.index("\n}\n")]
    assert "E* smem = reinterpret_cast<E*>(corr_smem);" in tc
    # 16-bit stages by 16-byte cp.async copies of a and b
    assert "stage_lines<kAS, kTcCols / 8>(buf, an," in tc
    assert "stage_lines<kBS, kWC / 8>(buf + a_elems, bn," in tc
    lines = corr[corr.index("void stage_lines(E* dst"):]
    assert "stage_copy<8>(dst + line * kStride" in lines[:lines.index("\n}\n")]
    assert tc.count("mxtt::ldmatrix_x4_trans(") == 2
    assert "mxtt::ldmatrix_x2_trans(bf," in tc
    assert tc.count("mxtt::mma_16<E>(acc[") == 3
    copy = corr[corr.index("void stage_copy(E* dst"):]
    copy = copy[:copy.index("\n}\n")]
    for size in ("16", "8", "4"):
        assert "mxtt::cp_async%s(dst, src, valid);" % size in copy
    # 16-bit multiplies take the tensor-core instance wherever it plans one
    launch = corr[corr.index('extern "C" int mxtt_correlation('):]
    assert launch.index("if (dtype != 0 && is_multiply) {") < \
        launch.index("tc_plan(a, b, N, H, W, D2, ng, s2)") < \
        launch.index("rb_plan(D2, ng, s2, vec, esize)")


# ---------------------------------------------------------------------------
# correlation

@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("is_mult", [True, False])
@pytest.mark.parametrize("m,stride2", [(2, 1), (3, 2), (12, 2)])
def test_correlation_half_matches_pallas_interpret(dt, is_mult, m, stride2):
    """Windows with D2^2 <= 169: the JAX wrapper runs its kernel there
    (and falls back to lax above)."""
    tdt, jdt = DTYPES[dt]
    rng = np.random.RandomState(m)
    a, b = (torch.from_numpy(rng.rand(2, 5, 7, 9).astype(np.float32))
            .to(tdt) for _ in range(2))
    got = ck.correlation(a, b, m, stride2, is_mult)
    want = pallas_corr(_to_jax(a), _to_jax(b), m, stride2, is_mult,
                       interpret=True)
    assert want is not None and want.dtype == jdt
    _assert_ulp(got, want, tdt)


def _emulate_corr_16bit(a, b, m, s2):
    """The tensor-core correlation's arithmetic in plain PyTorch: a and b
    of one 16-bit dtype, taken exactly in float32, channels zero-padded to
    a multiple of 16 and b zero outside the image; for each displacement
    the products a·b (exact in float32) summed 16 channels at a step in
    float32, the steps added in channel order, the sum divided by C and
    rounded once to the dtype."""
    n, c, h, w = a.shape
    ng, d2 = ck.correlation_geometry(m, s2)
    cp = -(-c // 16) * 16
    af = torch.zeros((n, cp, h, w))
    af[:, :c] = a.float()
    bp = torch.zeros((n, cp, h + 2 * m, w + 2 * m))
    bp[:, :c, m:m + h, m:m + w] = b.float()
    outs = []
    for i in range(d2):
        oy = m + (i - ng) * s2
        for j in range(d2):
            ox = m + (j - ng) * s2
            prod = af * bp[:, :, oy:oy + h, ox:ox + w]
            steps = prod.view(n, cp // 16, 16, h, w).sum(2)
            acc = torch.zeros((n, h, w))
            for k in range(cp // 16):
                acc = acc + steps[:, k]
            outs.append(acc / c)
    return torch.stack(outs, 1).to(a.dtype)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("m,stride2,c", [(3, 1, 19), (3, 1, 40), (6, 1, 40),
                                         (4, 2, 19), (4, 2, 40),
                                         (12, 2, 19)])
def test_correlation_16bit_arithmetic_within_one_ulp_of_pallas(dt, m,
                                                               stride2, c):
    """Windows with D2^2 <= 169 (the JAX kernel's unroll bound), C no
    multiple of 16."""
    tdt, _ = DTYPES[dt]
    a, b = (_randn((2, c, 7, 11), tdt, 40 + s) for s in range(2))
    got = _emulate_corr_16bit(a, b, m, stride2)
    want = pallas_corr(_to_jax(a), _to_jax(b), m, stride2, True,
                       interpret=True)
    assert want is not None
    _assert_ulp(got, want, tdt)


# The JAX op on the CPU takes its lax lowering: in float16 it rounds each
# product, each partial channel sum and the division by C to float16, the
# port's plain version rounds once.  With C = 3 channels of values in
# [0, 1) that is at most four float16 roundings of values below 2, each
# half an ulp (2^-11 at 1, 2^-10 at 2): atol 4 * 2^-10.
CORR_OP_HALF_ATOL = 4 * 2.0 ** -10


@pytest.mark.parametrize("params", [
    dict(kernel_size=1, max_displacement=2, stride1=1, stride2=2,
         pad_size=2),
    dict(kernel_size=1, max_displacement=3, stride1=1, stride2=1,
         pad_size=3, is_multiply=False)], ids=["multiply-s2", "abs-s1"])
def test_correlation_op_in_float16_through_simple_bind(params):
    rng = np.random.RandomState(3)
    feed = {"data1": rng.rand(2, 3, 7, 9).astype(np.float16),
            "data2": rng.rand(2, 3, 7, 9).astype(np.float16)}
    shapes = {k: v.shape for k, v in feed.items()}
    types_ = {k: np.float16 for k in feed}
    outs = []
    for pkg in (mx, mt):
        sym = pkg.sym.Correlation(pkg.sym.Variable("data1"),
                                  pkg.sym.Variable("data2"), name="corr",
                                  **params)
        ex = sym.simple_bind(pkg.cpu(), grad_req="null", type_dict=types_,
                             **shapes)
        outs.append(ex.forward(is_train=False, **feed)[0].asnumpy())
    want, got = outs
    assert got.dtype == want.dtype == np.float16
    np.testing.assert_allclose(got.astype(np.float32),
                               want.astype(np.float32), rtol=0,
                               atol=CORR_OP_HALF_ATOL)


# ---------------------------------------------------------------------------
# mixed float dtypes: each operand upcast on load, out in q's (a's) dtype

def test_mixed_dtypes_match_jax():
    h16, b16 = torch.float16, torch.bfloat16
    q, k, v = (_randn((1, 40, 2, 8), t, s) for s, t in
               enumerate((h16, b16, torch.float32)))
    got = ck.flash_attention(q, k, v, causal=True)
    want = pallas_flash(_to_jax(q), _to_jax(k), _to_jax(v), causal=True,
                        block_q=8, block_k=8, interpret=True)
    _assert_ulp(got, want, h16)
    args = _paged_inputs(b16)
    args[1], args[2] = args[1].to(h16), args[2].float()
    got = ck.paged_attention(*args)
    jargs = [_to_jax(a) for a in args]
    want = pallas_paged(*jargs[:5], q_pos=jargs[5], interpret=True)
    _assert_ulp(got, want, b16)
    rng = np.random.RandomState(4)
    a = torch.from_numpy(rng.rand(1, 4, 6, 8).astype(np.float32)).to(b16)
    b = torch.from_numpy(rng.rand(1, 4, 6, 8).astype(np.float32))
    got = ck.correlation(a, b, 2, 1)
    want = pallas_corr(_to_jax(a), _to_jax(b), 2, 1, interpret=True)
    _assert_ulp(got, want, b16)


# ---------------------------------------------------------------------------
# the wrappers' dtype checks and the kernels' C interfaces

def test_float_operands_take_three_dtypes_and_upcast_mixed_ones():
    x = torch.zeros(2, 3)
    for dt, code in ((torch.float32, 0), (torch.float16, 1),
                     (torch.bfloat16, 2)):
        ts, got = ck._float_operands("k", ((x.to(dt), "a"), (x.to(dt), "b")))
        assert got == code and all(t.dtype == dt for t in ts)
    ts, code = ck._float_operands("k", ((x.half(), "a"),
                                        (x.bfloat16(), "b")))
    assert code == 0 and all(t.dtype == torch.float32 for t in ts)
    for bad in (torch.float64, torch.int32):
        with pytest.raises(MXNetError, match="torch.float32 or "
                           "torch.float16 or torch.bfloat16"):
            ck._float_operands("k", ((x, "a"), (x.to(bad), "b")))
    with pytest.raises(MXNetError, match="contiguous"):
        ck._float_operands("k", ((torch.zeros(3, 2).half().t(), "a"),))
    assert ck.KERNEL_DTYPES == (torch.float32, torch.float16,
                                torch.bfloat16)


@pytest.mark.parametrize("dt,code", [(torch.float16, 1),
                                     (torch.bfloat16, 2)])
@pytest.mark.parametrize("q_float32", [False, True])
def test_paged_launch_passes_the_dtype_code(monkeypatch, dt, code,
                                            q_float32):
    """The pools' code, then q's: q's own dtype, or float32 (code 0) for
    a q upcast over a 16-bit pool, whose output is float32."""
    calls = []

    class Lib:
        def mxtt_paged_attention(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(ck, "_library", lambda name: Lib())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=0))
    args = _paged_inputs(dt)
    if q_float32:
        args[0] = args[0].float()
    ck.reset_launches()
    out = ck._launch_paged(*args, True, 2, 32)
    assert out.dtype == args[0].dtype and ck.LAUNCHES["paged_attention"] == 1
    # (..., causal, scale, dtype, q_dtype, part_keys, n_part, device, stream)
    assert calls[0][-6:-2] == (code, 0 if q_float32 else code, 32, 2)


@pytest.mark.parametrize("name,fn", [("paged_attention",
                                      "mxtt_paged_attention"),
                                     ("flash_attention",
                                      "mxtt_flash_attention"),
                                     ("correlation", "mxtt_correlation")])
def test_sources_take_a_dtype_and_declare_it(name, fn):
    with open(os.path.join(ck._CSRC, ck.SOURCES[name])) as f:
        text = f.read()
    sig = re.search(r'extern "C" int %s\(([^)]*)\)' % fn, text).group(1)
    assert "int dtype" in sig
    assert '#include "elem.cuh"' in text
    for e in ("__half", "__nv_bfloat16"):       # an instance of each type
        assert re.search(r"<%s>|\b%s\{\}" % (e, e), text)
    n_args = len([a for a in sig.split(",") if a.strip()])

    class Fn:
        argtypes = None
        restype = None

    lib = types.SimpleNamespace(mxtt_error_string=Fn())
    setattr(lib, fn, Fn())
    ck._declare(name, lib)
    assert len(getattr(lib, fn).argtypes) == n_args
    with open(os.path.join(ck._CSRC, "elem.cuh")) as f:
        elem = f.read()
    for conv in ("__half2float", "__bfloat162float", "__float2half_rn",
                 "__float2bfloat16_rn"):
        assert conv in elem
    cmd = ck.nvcc_command(os.path.join(ck._CSRC, ck.SOURCES[name]), "x.so")
    assert "--split-compile=4" in cmd


# ---------------------------------------------------------------------------
# the kernel search: classes as the JAX package spells them, no ml_dtypes

@pytest.mark.parametrize("port_dt,jax_dt", [
    (torch.float16, np.float16), ("float16", np.float16),
    (np.float16, np.float16), (torch.bfloat16, jnp.bfloat16),
    ("bfloat16", jnp.bfloat16)])
def test_classes_equal_the_jax_packages(port_dt, jax_dt):
    assert ks.flash_class(200, 64, True, port_dt) == \
        jax_ks.flash_class(200, 64, True, jax_dt)
    assert ks.paged_class(16, 64, False, port_dt) == \
        jax_ks.paged_class(16, 64, False, jax_dt)
    assert ks.fc_class(4096, 4096, "relu", False, port_dt) == \
        jax_ks.fc_class(4096, 4096, "relu", False, jax_dt)
    assert ks._itemsize(port_dt) == 2


def test_half_searches_without_ml_dtypes(tmp_path):
    """A fresh process that imports the port with jax and ml_dtypes
    blocked (as on a machine with numpy but neither) runs bfloat16 and
    float16 searches on the host and stores each winner under its
    dtype's class."""
    code = textwrap.dedent('''
        import importlib.abc, json, sys

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "ml_dtypes"):
                    raise ImportError("blocked: " + name)

        sys.meta_path.insert(0, Block())
        import numpy as np
        import torch
        import mxnet_tpu_torch as mx
        from mxnet_tpu_torch.autotune import kernelsearch as ks
        cpu = torch.device("cpu")
        out = {}
        for dt in (torch.bfloat16, "bfloat16", np.float16):
            name = ks._dtype_name(dt)
            f = ks.search_flash(1, 16, 1, 8, causal=True, dtype=dt,
                                ctx=mx.cpu(), trials=1)
            p = ks.search_paged(2, 1, 2, 8, n_blocks=9, bt=4, dtype=dt,
                                ctx=mx.cpu(), trials=1)
            c = ks.search_fc(2, 8, 4, dtype=dt, ctx=mx.cpu(), trials=1)
            assert ks.best_config(ks.flash_class(16, 8, True, dt),
                                  cpu) == f
            assert ks.best_config(ks.paged_cap_class(4, 8, True, dt, 16),
                                  cpu) == p
            out[name] = [f, p, c, ks._itemsize(dt)]
        assert not any(m.split(".")[0] in ("jax", "ml_dtypes")
                       for m in sys.modules)
        print("R" + json.dumps(out))
    ''')
    env = dict(os.environ, PYTHONPATH=ROOT,
               MXNET_AUTOTUNE_DIR=str(tmp_path / "at"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    import json
    got = json.loads(res.stdout.split("R", 1)[1])
    assert sorted(got) == ["bfloat16", "float16"]
    for name, (f, p, c, size) in got.items():
        assert (f["block_q"], f["block_k"]) in ck.FLASH_TILES or \
            f["block_q"] in ck.FLASH_BLOCK_Q
        assert p["part_keys"] in ck.PAGED_PART_KEYS
        assert c["block_n"] == ck.FC_DEFAULT_TILE and size == 2
