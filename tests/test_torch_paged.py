"""The port's paged LLM serving against the JAX package's, on the CPU.

* ``paged_attention``: on CPU tensors the port's wrapper takes its plain
  version (``paged_attention_reference``); here it is held to the JAX
  package's Pallas page-walk kernel in interpret mode and to its dense
  gather reference, over causal/non-causal, dense-stripe/scattered page
  tables, ragged lengths straddling blocks, sentinel entries, an empty
  slot, and C = 1 and C > 1.  Tolerance rtol 1e-5, atol 1e-6: both sides
  sum at most a few dozen float32 products per score in other orders.
  The CUDA kernel's split-K arithmetic (partials per partition of
  logical keys, merged in partition order) is modelled in torch and held
  to the same reference at the partitions' edges.  The CUDA kernel is
  held to the same plain version on the card by ``chip_smoke.py``.
* the model: ``init_lm_params`` bitwise, ``lm_forward`` logits and one
  ``paged_step`` within rtol 1e-5, atol 1e-6.
* the engine: the JAX engine's token streams on the mixed-length flood,
  exactly, paged, dense-stripe and speculative; and the engine's
  behaviour (pool accounting, exhaustion, eos, validation, overload,
  close), ported from ``tests/test_paged.py``.
"""
import math
import os
import time
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops.pallas_kernels import (_paged_attention_dense,
                                          paged_attention as pallas_paged)
from mxnet_tpu.serve import PagedDecodeEngine as JaxPagedEngine
from mxnet_tpu.serve.paged import model as jax_model
from mxnet_tpu.serve.paged.engine import _paged_step as jax_paged_step
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import cuda_kernels as ck
from mxnet_tpu_torch.serve import (KVBlockPool, LMConfig, PagedDecodeEngine,
                                   ServeClosedError, ServeError,
                                   ServeOverloadError, ServeRequestError,
                                   init_lm_params)
from mxnet_tpu_torch.serve.paged import (causal_attend, lm_forward,
                                         paged_step, param_bytes)

RTOL, ATOL = 1e-5, 1e-6
CFG = LMConfig(vocab=64, dim=32, heads=4, layers=2, max_context=96)
JAX_CFG = jax_model.LMConfig(*CFG)


def _prompts(n, seed=7, lens=(3, 17, 33, 5, 26, 48, 1, 12)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab, size=lens[i % len(lens)])
            .astype(np.int64) for i in range(n)]


def _engine(params, **kw):
    kw.setdefault("num_slots", 4)
    kw.setdefault("block_tokens", 8)
    kw.setdefault("chunk_tokens", 16)
    kw.setdefault("name", "torch-paged")
    return PagedDecodeEngine(params, CFG, ctx=mt.cpu(), **kw)


def _run_all(eng, prompts, max_new=24):
    futs = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    return [f.result(timeout=120) for f in futs]


@pytest.fixture(scope="module")
def params():
    return init_lm_params(CFG, seed=0)


@pytest.fixture(scope="module")
def jax_streams(params):
    """The JAX package's paged engine on the flood: the ground truth."""
    eng = JaxPagedEngine(params, JAX_CFG, num_slots=4, block_tokens=8,
                         chunk_tokens=16, num_blocks=30, name="jax-ref")
    try:
        return _run_all(eng, _prompts(8))
    finally:
        eng.close()


@pytest.fixture(scope="module")
def dense_streams(params):
    eng = _engine(params, paged=False, name="torch-dense")
    try:
        return _run_all(eng, _prompts(8))
    finally:
        eng.close()


# ---------------------------------------------------------------------------
# paged_attention

def _paged_setup(seed=0, c=4, scatter=True, bt=8, h=2, d=16, blocks=16):
    """The ``tests/test_pallas.py`` recipe with an empty fourth slot:
    lengths that straddle block boundaries, unassigned entries at the
    sentinel ``blocks`` (the pool's scratch row), physical blocks out of
    order (scatter) or as contiguous stripes."""
    rng = np.random.RandomState(seed)
    lengths = np.array([5, 19, 12, 0], np.int32)
    s, max_b = len(lengths), 4
    k_pool = rng.randn(blocks + 1, bt, h, d).astype(np.float32)
    v_pool = rng.randn(blocks + 1, bt, h, d).astype(np.float32)
    pages = np.full((s, max_b), blocks, np.int32)
    order = rng.permutation(blocks) if scatter else np.arange(blocks)
    nxt = 0
    for i in range(s):
        for b in range(-(-int(lengths[i]) // bt)):
            pages[i, b] = order[nxt]
            nxt += 1
    q = rng.randn(s, c, h, d).astype(np.float32)
    q_pos = (lengths[:, None] - c + np.arange(c, dtype=np.int32)[None, :])
    return q, k_pool, v_pool, pages, lengths, q_pos.astype(np.int32)


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("c", [1, 4])
@pytest.mark.parametrize("scatter", [False, True], ids=["dense", "scatter"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_plain_version_matches_pallas_interpret(causal, scatter, c):
    args = _paged_setup(c=c, scatter=scatter, seed=c)
    want = np.asarray(pallas_paged(*map(jnp.asarray, args), causal=causal,
                                   interpret=True))
    dense = np.asarray(_paged_attention_dense(*map(jnp.asarray, args),
                                              causal=causal))
    ref = ck.paged_attention_reference(*_torch(*args), causal=causal)
    ck.reset_launches()
    out = ck.paged_attention(*_torch(*args), causal=causal)
    assert ck.LAUNCHES["paged_attention"] == 0      # CPU: plain version
    assert torch.equal(out, ref)
    assert ref.dtype == torch.float32 and ref.shape == args[0].shape
    np.testing.assert_allclose(ref.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ref.numpy(), dense, rtol=RTOL, atol=ATOL)
    assert np.all(ref.numpy()[3] == 0)              # the empty slot


def test_plain_version_engine_window_rows():
    # an engine window: rows past a slot's valid count sit at position 0
    # (they attend key 0 only) and C exceeds some slots' lengths; the
    # default q_pos is the last C positions
    q, k_pool, v_pool, pages, lengths, _ = _paged_setup(c=9, seed=5)
    q_pos = np.zeros((4, 9), np.int32)
    q_pos[0, :5] = np.arange(5)
    q_pos[1, :3] = [16, 17, 18]
    q_pos[2, :] = np.arange(3, 12)
    args = (q, k_pool, v_pool, pages, lengths, q_pos)
    want = np.asarray(pallas_paged(*map(jnp.asarray, args), causal=True,
                                   interpret=True))
    ref = ck.paged_attention_reference(*_torch(*args), causal=True)
    assert np.all(np.isfinite(ref.numpy()))
    np.testing.assert_allclose(ref.numpy(), want, rtol=RTOL, atol=ATOL)
    tq, tk, tv, tp, tl = _torch(q, k_pool, v_pool, pages, lengths)
    default = ck.paged_attention(tq, tk, tv, tp, tl)
    want = np.asarray(pallas_paged(*map(jnp.asarray, args[:5]),
                                   interpret=True))
    np.testing.assert_allclose(default.numpy(), want, rtol=RTOL, atol=ATOL)


def test_plain_version_layout_invariant():
    """The same logical K/V laid out as stripes and scattered gives
    bitwise the same output: the property that makes the dense-stripe and
    paged engines emit identical tokens."""
    rng = np.random.RandomState(1)
    blocks, bt, h, d, s, c = 12, 8, 2, 16, 2, 3
    lengths = np.array([21, 9], np.int32)
    rows = [rng.randn(bt, h, d).astype(np.float32) for _ in range(blocks)]
    q = rng.randn(s, c, h, d).astype(np.float32)
    q_pos = (lengths[:, None] - c + np.arange(c)[None, :]).astype(np.int32)
    outs = []
    for order in (np.arange(blocks), rng.permutation(blocks)):
        pool = np.zeros((blocks + 1, bt, h, d), np.float32)
        pages = np.full((s, 4), blocks, np.int32)
        nxt = 0
        for i in range(s):
            for b in range(-(-int(lengths[i]) // bt)):
                pool[order[nxt]] = rows[sum(
                    -(-int(lengths[j]) // bt) for j in range(i)) + b]
                pages[i, b] = order[nxt]
                nxt += 1
        outs.append(ck.paged_attention(*_torch(q, pool, pool, pages,
                                               lengths, q_pos)))
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("bad", ["q_rank", "pool", "pages", "q_pos"])
def test_wrapper_rejects_bad_arguments(bad):
    q, k, v, pages, lengths, q_pos = _torch(*_paged_setup())
    if bad == "q_rank":
        q = q[0]
    elif bad == "pool":
        v = v[:, :4]
    elif bad == "pages":
        pages = pages[:2]
    else:
        q_pos = q_pos[:, :2]
    with pytest.raises(mt.MXNetError):
        ck.paged_attention(q, k, v, pages, lengths, q_pos)


def test_kernel_source_targets_hopper():
    src = os.path.join(ck._CSRC, ck.SOURCES["paged_attention"])
    with open(src) as f:
        text = f.read()
    assert 'extern "C" int mxtt_paged_attention(' in text
    assert "pallas_kernels.py:220" in text          # names the TPU kernel
    assert "atomic" not in text.replace("no atomics", "")
    cmd = ck.nvcc_command(src, "/dev/null")
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    assert ck._lib_path("paged_attention") != \
        ck._lib_path("fused_fc_epilogue")
    # split-K with a merge kernel, a cp.async ring, P from shared memory
    # the partition length is an argument the wrapper passes (searched)
    assert "int part_keys, int n_part" in text and \
        ck.PAGED_PARTITION_KEYS in ck.PAGED_PART_KEYS
    assert "constexpr int kTileQ = %d;" % ck.PAGED_TILE_Q in text
    assert "paged_attention_merge_kernel" in text
    assert '#include "attention.cuh"' in text and "cp_async16(" in text
    assert "mxtt::attention_tile<" in text           # flash's key-tile step
    assert "constexpr int kStages = 2;" in text and "__ldg(k_pool" not in text
    assert "__shfl_sync(kFull, sc[r]" not in text    # no shuffle per key


def test_launch_counted_once_per_kernel_call(monkeypatch):
    """The count rises where the kernel is launched, once per call, with
    or without the split-K merge kernel behind it; the plain version on
    CPU tensors counts nothing."""
    calls = []

    class Lib:
        def mxtt_paged_attention(self, *args):
            calls.append(args[-3])                 # n_part
            return 0

    monkeypatch.setattr(ck, "_library", lambda name: Lib())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=0))
    args = _torch(*_edge_setup(16, 1, seed=5))
    ck.reset_launches()
    for n_part in (1, 3):
        ck._launch_paged(*args, True, n_part)
    assert calls == [1, 3] and ck.LAUNCHES["paged_attention"] == 2
    ck.paged_attention(*args)
    assert ck.LAUNCHES["paged_attention"] == 2


def test_partitions_follow_shapes_only():
    """Split-K while one row tile covers the window (decode, speculative
    verify); one pass once the row tiles spread the work (prefill)."""
    p = ck.PAGED_PARTITION_KEYS
    assert ck.paged_partitions(1, 64 * 16) == -(-1024 // p)
    for c in (1, 9, ck.PAGED_TILE_Q):
        assert ck.paged_partitions(c, p) == 1
        assert ck.paged_partitions(c, p + 1) == 2
        assert ck.paged_partitions(c, 1) == 1
    for c in (ck.PAGED_TILE_Q + 1, 32):
        assert ck.paged_partitions(c, 64 * 16) == 1


def _split_k_attention(q, k_pool, v_pool, pages, lengths, q_pos, causal,
                       part_keys):
    """The split-K kernel's arithmetic in torch: each slot's logical keys
    (gathered through the clamped page table) cut into ``part_keys``-key
    partitions; per partition the partial (m, l, acc) with masked keys at
    -inf, scores and maxima in log2 units as the kernel keeps them; the
    partials merged in partition order, l clamped at 1e-20 once at the
    end."""
    n, bt = k_pool.shape[0], k_pool.shape[1]
    s_, c, h, d = q.shape
    cap = pages.shape[1] * bt
    safe = pages.long().clamp(0, n - 1)
    kg = k_pool[safe].reshape(s_, cap, h, d)
    vg = v_pool[safe].reshape(s_, cap, h, d)
    sc = torch.einsum("schd,skhd->shck", q, kg) * (math.log2(math.e)
                                                   / math.sqrt(d))
    key = torch.arange(cap)
    seen = (key[None, :] < lengths.long()[:, None])[:, None, None, :]
    if causal:
        seen = seen & (key[None, None, :] <= q_pos.long()[:, :, None])[:, None]
    sc = torch.where(seen, sc, -math.inf)
    parts = []
    for lo in range(0, cap, part_keys):
        blk = sc[..., lo:lo + part_keys]
        m = blk.amax(-1, keepdim=True)
        e = torch.where(torch.isinf(blk), 0.0,
                        torch.exp2(blk - torch.where(torch.isinf(m), 0.0, m)))
        parts.append((m, e.sum(-1, keepdim=True),
                      torch.einsum("shck,skhd->shcd", e,
                                   vg[:, lo:lo + part_keys])))
    mx = torch.stack([m for m, _, _ in parts]).amax(0)
    safe_m = torch.where(torch.isinf(mx), 0.0, mx)
    l = torch.zeros_like(mx)
    acc = torch.zeros_like(parts[0][2])
    for m, lp, ap in parts:                          # in partition order
        f = torch.where(torch.isinf(m), 0.0, torch.exp2(m - safe_m))
        l = l + lp * f
        acc = acc + ap * f
    return (acc / l.clamp_min(1e-20)).permute(0, 2, 1, 3)


def _edge_setup(part, c, seed, bt=8, h=2, d=16):
    """Slots at the partitions' edges: lengths of exactly P, P - 1 and
    P + 1, a causal window straddling a boundary, an empty slot beside one
    at the page table's full width; scattered blocks and a sentinel row of
    large finite values past every length."""
    rng = np.random.RandomState(seed)
    max_b = -(-(3 * part) // bt)
    cap = max_b * bt
    lengths = np.array([part, part - 1, part + 1, 0, cap, part + c // 2 + 1,
                        2 * part + 3], np.int32)
    need = [-(-int(n) // bt) for n in lengths]
    blocks = sum(need)
    k_pool = rng.randn(blocks + 1, bt, h, d).astype(np.float32)
    v_pool = rng.randn(blocks + 1, bt, h, d).astype(np.float32)
    k_pool[blocks] = v_pool[blocks] = 1e4
    pages = np.full((len(lengths), max_b), blocks, np.int32)
    order = rng.permutation(blocks)
    nxt = 0
    for i, nb in enumerate(need):
        pages[i, :nb] = order[nxt:nxt + nb]
        nxt += nb
    q = rng.randn(len(lengths), c, h, d).astype(np.float32)
    q_pos = np.zeros((len(lengths), c), np.int32)
    for i, n in enumerate(lengths):            # the engine's window rows
        nv = min(c, int(n))
        q_pos[i, :nv] = n - nv + np.arange(nv)
    return q, k_pool, v_pool, pages, lengths, q_pos


@pytest.mark.parametrize("part", [16, ck.PAGED_PARTITION_KEYS])
@pytest.mark.parametrize("c,causal", [(1, True), (9, True), (32, True),
                                      (9, False)])
def test_split_k_matches_dense_reference_at_partition_edges(part, c, causal):
    args = _edge_setup(part, c, seed=c + part)
    want = np.asarray(_paged_attention_dense(*map(jnp.asarray, args),
                                             causal=causal))
    got = _split_k_attention(*_torch(*args), causal=causal, part_keys=part)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert np.all(got.numpy()[3] == 0)             # the empty slot
    q_pos = args[5]
    if c > 1:                                      # a window straddles P
        assert q_pos[5, 0] < part <= q_pos[5, -1]
    # the port's plain version agrees with the same reference
    ref = ck.paged_attention(*_torch(*args), causal=causal)
    np.testing.assert_allclose(ref.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("c", [1, 9, 32])
def test_split_k_is_layout_invariant(c):
    """Partitions cut logical keys, so the same logical cache laid out
    in any order of blocks gives bitwise the same split-K output."""
    q, k_pool, v_pool, pages, lengths, q_pos = _edge_setup(16, c, seed=3)
    blocks = k_pool.shape[0] - 1                   # the sentinel stays last
    perm = np.random.RandomState(c).permutation(blocks)
    moved_k, moved_v = k_pool.copy(), v_pool.copy()
    moved_k[perm], moved_v[perm] = k_pool[:blocks], v_pool[:blocks]
    moved_pages = np.where(pages < blocks,
                           perm[np.minimum(pages, blocks - 1)], pages)
    outs = [_split_k_attention(*_torch(q, kp, vp, pg, lengths, q_pos),
                               causal=True, part_keys=16)
            for kp, vp, pg in ((k_pool, v_pool, pages),
                               (moved_k, moved_v, moved_pages))]
    assert torch.equal(outs[0], outs[1])


# ---------------------------------------------------------------------------
# model

def test_init_lm_params_bitwise_equal_jax():
    for kw in ({"seed": 0}, {"seed": 3, "scale": 0.005}):
        got = init_lm_params(CFG, **kw)
        want = jax_model.init_lm_params(JAX_CFG, **kw)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype == np.float32
            assert np.array_equal(got[k], want[k]), k
    draft_cfg = CFG._replace(layers=1)
    base = init_lm_params(CFG, seed=0)
    got = init_lm_params(draft_cfg, seed=1, embed=base["embed"])
    want = jax_model.init_lm_params(jax_model.LMConfig(*draft_cfg), seed=1,
                                    embed=base["embed"])
    assert all(np.array_equal(got[k], want[k]) for k in want)
    with pytest.raises(ValueError):
        init_lm_params(CFG._replace(heads=5))


def _jax_causal_attend(layer, q, k, v):
    d = q.shape[-1]
    s = jnp.einsum("sqhd,skhd->shqk", q, k) / math.sqrt(d)
    c = q.shape[1]
    s = jnp.where(jnp.tril(jnp.ones((c, c), bool)), s, -jnp.inf)
    p = jnp.exp(s - s.max(-1, keepdims=True))
    p = p / p.sum(-1, keepdims=True)
    return jnp.einsum("shqk,skhd->sqhd", p, v)


def test_lm_forward_matches_jax(params):
    rng = np.random.RandomState(4)
    tokens = rng.randint(0, CFG.vocab, (2, 11)).astype(np.int32)
    # the second row's positions run past max_context: both clip
    positions = np.stack([np.arange(11), np.arange(90, 101)]).astype(
        np.int32)
    want = np.asarray(jax_model.lm_forward(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(tokens),
        jnp.asarray(positions), _jax_causal_attend, JAX_CFG))
    tp = mt.convert.convert_lm_params(params, "cpu")
    got = lm_forward(tp, torch.from_numpy(tokens),
                     torch.from_numpy(positions), causal_attend, CFG)
    assert got.shape == (2, 11, CFG.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_paged_step_matches_jax(params):
    """One mixed window through both packages' step functions: argmax
    tokens equal, the appended K/V equal within tolerance, the sentinel
    row the only place invalid positions touched."""
    rng = np.random.RandomState(6)
    layers, n, bt, h, d = CFG.layers, 12, 8, CFG.heads, CFG.head_dim
    kv_k = rng.randn(layers, n + 1, bt, h, d).astype(np.float32)
    kv_v = rng.randn(layers, n + 1, bt, h, d).astype(np.float32)
    pages = np.array([[3, 7, 1, n], [0, 5, n, n], [n, n, n, n]], np.int32)
    cache = np.array([14, 5, 0], np.int32)
    n_valid = np.array([5, 1, 0], np.int32)
    c = 5
    tokens = rng.randint(0, CFG.vocab, (3, c)).astype(np.int32)
    positions = np.zeros((3, c), np.int32)
    for i in range(3):
        positions[i, :n_valid[i]] = cache[i] + np.arange(n_valid[i])
    lengths = cache + n_valid
    jt, jk, jv = jax_paged_step(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(kv_k),
        jnp.asarray(kv_v), jnp.asarray(tokens), jnp.asarray(pages),
        jnp.asarray(positions), jnp.asarray(n_valid), jnp.asarray(lengths),
        cfg=JAX_CFG, use_kernel=False)
    tk, tv = torch.from_numpy(kv_k.copy()), torch.from_numpy(kv_v.copy())
    toks = paged_step(mt.convert.convert_lm_params(params, "cpu"), tk, tv,
                      *_torch(tokens, pages, positions, n_valid, lengths),
                      cfg=CFG, use_kernel=False)
    assert toks.dtype == torch.int32
    assert np.array_equal(toks.numpy()[n_valid[:, None] > np.arange(c)],
                          np.asarray(jt)[n_valid[:, None] > np.arange(c)])
    real = slice(0, n)          # the sentinel row's contents are scratch
    np.testing.assert_allclose(tk.numpy()[:, real], np.asarray(jk)[:, real],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tv.numpy()[:, real], np.asarray(jv)[:, real],
                               rtol=RTOL, atol=ATOL)
    untouched = [b for b in range(n) if b not in (7, 1, 0)]
    assert np.array_equal(tk.numpy()[:, untouched], kv_k[:, untouched])


def test_convert_lm_params_keeps_names_and_values(params):
    out = mt.convert.convert_lm_params(params, mt.cpu())
    assert sorted(out) == sorted(params)
    for k, v in params.items():
        assert out[k].device.type == "cpu" and out[k].dtype == torch.float32
        assert np.array_equal(out[k].numpy(), v)
        assert not np.shares_memory(out[k].numpy(), v)
    assert param_bytes(out) == sum(v.nbytes for v in params.values())


# ---------------------------------------------------------------------------
# the engine against the JAX engine

def test_paged_engine_matches_jax_engine(params, jax_streams):
    eng = _engine(params, num_blocks=30, name="torch-paged-parity")
    try:
        assert not eng.use_kernel and eng.device.type == "cpu"
        ck.reset_launches()
        got = _run_all(eng, _prompts(8))
        rep = eng.stats.report()
        assert eng.forward_counts["target"] > 2
    finally:
        eng.close()
    assert ck.LAUNCHES["paged_attention"] == 0
    for i, (a, b) in enumerate(zip(jax_streams, got)):
        assert a.dtype == b.dtype == np.int32
        assert np.array_equal(a, b), (i, a, b)
    assert rep["kind"] == "paged" and rep["completed"] == 8
    assert rep["dropped_streams"] == 0 and rep["kv_blocks"] == 30
    assert rep["prefill_tokens"] == sum(len(p) for p in _prompts(8))


def test_dense_stripe_engine_matches_jax_engine(jax_streams, dense_streams):
    for a, b in zip(jax_streams, dense_streams):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("draft_kind", ["shared-embed-1-layer", "unrelated"])
def test_spec_decode_token_identical(params, dense_streams, draft_kind):
    """Speculative decode emits the plain-decode streams whether the
    draft agrees with the target (a 1-layer draft sharing its embedding
    and positions, as bench_llm.py builds it) or not."""
    draft_cfg = CFG._replace(layers=1)
    if draft_kind == "unrelated":
        draft = init_lm_params(draft_cfg, seed=99)
    else:
        draft = init_lm_params(draft_cfg, seed=1, embed=params["embed"])
        draft["pos"] = params["pos"].copy()
    eng = _engine(params, num_blocks=40, draft_params=draft,
                  draft_cfg=draft_cfg, spec_k=4, name="torch-spec")
    try:
        got = _run_all(eng, _prompts(8))
        rep = eng.stats.report()
        counts = dict(eng.forward_counts)
    finally:
        eng.close()
    for a, b in zip(dense_streams, got):
        assert np.array_equal(a, b)
    assert rep["spec_rounds"] > 0 and counts["draft"] > 0
    assert rep["spec_proposed"] >= rep["spec_accepted"] >= 0


def test_chunked_prefill_long_prompt(params):
    long_p = _prompts(1, seed=11, lens=(72,))[0]
    short_p = _prompts(1, seed=12, lens=(2,))[0]
    base = _engine(params, paged=False, name="torch-chunk-base")
    try:
        want = _run_all(base, [long_p, short_p], max_new=12)
    finally:
        base.close()
    eng = _engine(params, num_blocks=24, name="torch-chunk")
    try:
        got = _run_all(eng, [long_p, short_p], max_new=12)
        rep = eng.stats.report()
    finally:
        eng.close()
    assert all(np.array_equal(a, b) for a, b in zip(want, got))
    assert rep["prefill_tokens"] == len(long_p) + len(short_p)
    assert rep["inter_token_p99_ms"] > 0


# ---------------------------------------------------------------------------
# engine behaviour (ported from tests/test_paged.py)

def test_pool_reserve_ensure_release_invariants():
    pool = KVBlockPool(num_slots=2, max_blocks_per_slot=4, num_blocks=6,
                       block_tokens=8, device="cpu")
    assert pool.blocks_for(1) == 1 and pool.blocks_for(8) == 1
    assert pool.blocks_for(9) == 2 and pool.blocks_for(32) == 4
    assert pool.available_blocks() == 6 and pool.sentinel == 6
    assert np.all(pool.page_table() == pool.sentinel)
    assert pool.page_table().dtype == np.int32
    assert pool.reserve(0, 4)
    assert pool.available_blocks() == 2
    assert not pool.reserve(1, 3)
    assert pool.reserve(1, 2)
    assert pool.used_blocks() == 0
    pool.ensure(0, 9)
    assert pool.used_blocks() == 2
    assert all(0 <= int(b) < 6 for b in pool.page_table()[0, :2])
    pool.ensure(0, 9)
    assert pool.used_blocks() == 2
    with pytest.raises(ServeError):
        pool.ensure(1, 32)
    with pytest.raises(ServeError):
        pool.reserve(0, 5)
    pool.release(0)
    assert pool.used_blocks() == 0 and pool.available_blocks() == 4
    assert np.all(pool.page_table()[0] == pool.sentinel)
    pool.release(1)
    assert pool.available_blocks() == 6


def test_pool_geometry_dense_mode_and_views(monkeypatch):
    with pytest.raises(ServeError):
        KVBlockPool(2, 4, num_blocks=3, block_tokens=8, device="cpu")
    with pytest.raises(ServeError):
        KVBlockPool(2, 4, num_blocks=6, block_tokens=8, dense=True,
                    device="cpu")
    with pytest.raises(ServeError):
        KVBlockPool(2, 4, block_tokens=0, device="cpu")
    dense = KVBlockPool(2, 4, block_tokens=8, dense=True, device="cpu")
    assert dense.num_blocks == 8
    assert np.array_equal(dense.page_table()[1], np.arange(4, 8))
    assert dense.reserve(0, 4) and dense.reserve(0, 4)
    dense.release(0)
    assert np.array_equal(dense.page_table()[0], np.arange(0, 4))
    pool = KVBlockPool(2, 4, num_blocks=6, block_tokens=8, device="cpu")
    pool.add_view("target", layers=2, heads=4, head_dim=8)
    with pytest.raises(ServeError):
        pool.add_view("target", 2, 4, 8)
    k, v = pool.view("target")
    assert k.shape == (2, 7, 8, 4, 8) and k.dtype == torch.float32
    assert k.device.type == "cpu" and k.is_contiguous()
    assert pool.device_bytes() == 2 * (2 * 7 * 8 * 4 * 8 * 4)
    monkeypatch.setenv("MXNET_KVPOOL_BLOCK_TOKENS", "4")
    monkeypatch.setenv("MXNET_KVPOOL_BLOCKS", "13")
    pool = KVBlockPool(2, 4, device="cpu")
    assert pool.block_tokens == 4 and pool.num_blocks == 13


def test_pool_default_device_is_the_current_context():
    """Like every entry point of the port, the pool defaults to the
    current context (``gpu(0)``) and raises without a card; a context
    scope picks the device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: gpu(0) is valid")
    with pytest.raises(mt.MXNetError, match="no CUDA device"):
        KVBlockPool(2, 4, num_blocks=6, block_tokens=8)
    with mt.cpu():
        pool = KVBlockPool(2, 4, num_blocks=6, block_tokens=8)
    assert pool.device.type == "cpu"


def test_pool_exhaustion_queues_never_drops(params):
    prompts = _prompts(12)
    dense = _engine(params, paged=False, queue_depth=16,
                    name="torch-exhaust-base")
    try:
        want = _run_all(dense, prompts, max_new=16)
    finally:
        dense.close()
    eng = _engine(params, num_blocks=14, queue_depth=16,
                  name="torch-exhaust")
    try:
        got = _run_all(eng, prompts, max_new=16)
        rep = eng.stats.report()
    finally:
        eng.close()
    assert all(np.array_equal(a, b) for a, b in zip(want, got))
    assert rep["completed"] == 12
    assert rep["dropped_streams"] == 0 and rep["failed"] == 0
    assert 0 < rep["kv_utilization_peak"] <= 1.0


def test_eos_at_max_new_and_submit_validation(params):
    eng = _engine(params, num_blocks=30)
    try:
        for bad in ([], [[1, 2]], [0.5], [CFG.vocab], [-1]):
            with pytest.raises(ServeRequestError):
                eng.submit(bad)
        with pytest.raises(ServeRequestError):
            eng.submit([1], max_new_tokens=0)
        with pytest.raises(ServeRequestError):
            eng.submit(np.ones(60, np.int64), max_new_tokens=60)
        p = _prompts(1)[0]
        full = [int(t) for t in eng.generate(p, timeout=120,
                                             max_new_tokens=8)]
        assert len(full) == 8
        k = max(i for i, t in enumerate(full) if t not in full[:i])
        got = eng.generate(p, timeout=120, max_new_tokens=k + 1,
                           eos_id=full[k])
        assert np.array_equal(got, np.asarray(full[:k + 1], np.int32))
        rep = eng.stats.report()
        assert rep["outstanding"] == 0 and rep["failed"] == 0
    finally:
        eng.close()


def test_overload_and_closed_fast_fail(params):
    eng = _engine(params, num_slots=1, num_blocks=13, queue_depth=2,
                  name="torch-overload")
    hog = eng.submit([1], max_new_tokens=64)
    t0 = time.perf_counter()
    while eng.pending_requests() > 0:
        assert time.perf_counter() - t0 < 10, "hog never admitted"
        time.sleep(0.005)
    queued = [eng.submit([2], max_new_tokens=64) for _ in range(2)]
    with pytest.raises(ServeOverloadError):
        eng.submit([3], max_new_tokens=4)
    assert eng.stats.report()["overloaded"] == 1
    for f in [hog] + queued:
        f.result(timeout=120)
    eng.close()
    with pytest.raises(ServeClosedError):
        eng.submit([1], max_new_tokens=4)
    eng.close()


def test_close_no_drain_fails_streams_and_releases_pool(params):
    eng = _engine(params, num_slots=2, num_blocks=26, name="torch-nodrain")
    futs = [eng.submit(p, max_new_tokens=32) for p in _prompts(4)]
    eng.close(drain=False)
    failed = 0
    for f in futs:
        try:
            f.result(timeout=60)
        except ServeClosedError:
            failed += 1
    assert failed >= 1
    assert eng.pool.used_blocks() == 0
    assert eng.pool.available_blocks() == 26
    assert not eng._thread.is_alive()


def test_device_bytes_counts_pool_and_draft(params):
    draft = init_lm_params(CFG, seed=1)
    eng = _engine(params, num_blocks=30, draft_params=draft,
                  draft_cfg=CFG, spec_k=2, name="torch-bytes")
    try:
        assert eng.device_bytes() == (param_bytes(eng._params)
                                      + eng.pool.device_bytes()
                                      + param_bytes(eng._spec.params))
        assert eng.pool.device_bytes() == \
            2 * 2 * (CFG.layers * 31 * 8 * CFG.heads * CFG.head_dim * 4)
    finally:
        eng.close()


def test_env_knobs(params, monkeypatch):
    monkeypatch.setenv("MXNET_SERVE_SLOTS", "2")
    monkeypatch.setenv("MXNET_SERVE_MAX_TOKENS", "3")
    monkeypatch.setenv("MXNET_PAGED_CHUNK", "8")
    monkeypatch.setenv("MXNET_KVPOOL_BLOCK_TOKENS", "4")
    monkeypatch.setenv("MXNET_SPEC_DECODE_K", "2")
    eng = PagedDecodeEngine(params, CFG, draft_params=params,
                            draft_cfg=CFG, ctx=mt.cpu(), name="torch-env")
    try:
        assert eng.num_slots == 2 and eng.max_new_tokens == 3
        assert eng.chunk == 8 and eng.spec_k == 2
        assert eng.pool.block_tokens == 4
        assert len(eng.generate([1], timeout=120)) == 3
    finally:
        eng.close()


def test_warmup_runs_every_width_on_the_decode_thread(params):
    draft_cfg = CFG._replace(layers=1)
    eng = _engine(params, num_blocks=30, draft_cfg=draft_cfg, spec_k=3,
                  draft_params=init_lm_params(draft_cfg, seed=2))
    try:
        # C = 1 and C = chunk, target and draft, before any request
        assert eng.forward_counts == {"target": 2, "draft": 2}
        k, _ = eng.pool.view("target")
        assert torch.count_nonzero(k[:, :eng.pool.num_blocks]) == 0
    finally:
        eng.close()


def test_use_kernel_cannot_be_forced_on_the_cpu(params):
    with pytest.raises(ServeError, match="CUDA"):
        _engine(params, use_kernel=True)


def test_default_device_raises_without_card(params):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: gpu(0) is valid")
    with pytest.raises(mt.MXNetError, match="no CUDA device"):
        PagedDecodeEngine(params, CFG)
