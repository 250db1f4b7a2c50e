"""The port's flash_attention, kernel search and autotune store against the
JAX package's.

On the CPU the port's ``flash_attention`` takes its plain version
(``flash_attention_reference``); here it is held to the JAX package's
Pallas kernel run in interpret mode and to its ``attention_reference``, at
the JAX package's own tolerance for the flash kernel (atol 2e-5,
``tests/test_pallas.py``).  The CUDA kernel's arithmetic, 3xTF32
products on the tensor cores, is emulated in torch and held to the same
tolerance; one-pass TF32 is shown to miss it.  The search, the store and the cost model are
held to the JAX package's records and numbers.  The CUDA kernel itself is
held to the same plain version on the card by ``chip_smoke.py``.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.autotune import costmodel as jax_cm
from mxnet_tpu.autotune import kernelsearch as jax_ks
from mxnet_tpu.autotune import store as jax_store
from mxnet_tpu.ops.pallas_kernels import flash_attention as pallas_flash
from mxnet_tpu.parallel.ring import attention_reference as jax_attention

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.autotune import costmodel as cm
from mxnet_tpu_torch.autotune import kernelsearch as ks
from mxnet_tpu_torch.autotune import store
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import cuda_kernels as ck

ATOL = 2e-5
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _isolated_store(tmp_path, monkeypatch):
    """Own store, cold model memo and cold winner cache per test (the
    winner cache memoizes negative lookups)."""
    monkeypatch.setenv("MXNET_AUTOTUNE_DIR", str(tmp_path))
    monkeypatch.delenv("MXNET_KERNEL_SEARCH", raising=False)
    for mod in (cm, jax_cm):
        with mod._model_lock:
            mod._MODELS.clear()
    with ks._cache_lock:
        ks._best_cache.clear()
    yield
    for mod in (cm, jax_cm):
        with mod._model_lock:
            mod._MODELS.clear()
    with ks._cache_lock:
        ks._best_cache.clear()


def _qkv(b, t, h, d, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, t, h, d).astype(np.float32) for _ in range(3)]


def _port(q, k, v, **kw):
    return ck.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), **kw).numpy()


# ---------------------------------------------------------------------------
# flash_attention against the JAX package


@pytest.mark.parametrize("causal", [False, True])
def test_flash_matches_pallas_interpret_and_reference(causal):
    q, k, v = _qkv(2, 256, 2, 32)
    want = np.asarray(pallas_flash(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal,
                                   interpret=True))
    ref = np.asarray(jax_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal))
    got = _port(q, k, v, causal=causal)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("t", [1, 7, 33, 100, 129])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_odd_lengths_match_pallas_interpret(t, causal):
    q = np.random.RandomState(0).randn(2, t, 2, 16).astype(np.float32)
    want = np.asarray(pallas_flash(jnp.asarray(q), jnp.asarray(q),
                                   jnp.asarray(q), causal=causal,
                                   interpret=True))
    got = _port(q, q, q, causal=causal)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def _tf32(x):
    """x rounded to TF32 as ``cvt.rna.tf32.f32`` does: the 13 low mantissa
    bits dropped, to nearest with ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm(a, b, passes):
    """``a @ b`` the way the kernel multiplies on the tensor cores: each
    operand split into a TF32 high part and a TF32 remainder, then
    float32 sums of TF32 products -- hi·hi + hi·lo + lo·hi (3xTF32) or
    hi·hi alone (one-pass TF32)."""
    ah, bh = _tf32(a), _tf32(b)
    if passes == 1:
        return ah @ bh
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _tf32_attention(q, k, v, causal, passes):
    """The kernel's attention arithmetic in torch: S = Q·Kᵀ and P·V
    through :func:`_mm`, P unnormalised (exp of S minus the row max), the
    row sum clamped at 1e-20 and divided out at the end."""
    q, k, v = (torch.from_numpy(x).permute(0, 2, 1, 3) for x in (q, k, v))
    t, d = q.shape[2], q.shape[3]
    s = _mm(q, k.transpose(-1, -2), passes) / np.float32(np.sqrt(d))
    if causal:
        s = s.masked_fill(~torch.ones(t, t, dtype=torch.bool).tril(),
                          -np.inf)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    out = _mm(p, v, passes) / p.sum(-1, keepdim=True).clamp_min(1e-20)
    return out.permute(0, 2, 1, 3).numpy()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(2, 40, 2, 16), (1, 256, 2, 64)],
                         ids=["small", "T256-D64"])
def test_3xtf32_arithmetic_matches_pallas_interpret(shape, causal):
    """The kernel's 3xTF32 products hold the JAX package's tolerance."""
    q, k, v = _qkv(*shape, seed=11)
    want = np.asarray(pallas_flash(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal,
                                   interpret=True))
    got = _tf32_attention(q, k, v, causal, passes=3)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_one_pass_tf32_misses_the_tolerance(causal):
    """Why three passes: one TF32 product per float32 product keeps about
    three decimal digits and lands outside atol 2e-5 at D = 64."""
    q, k, v = _qkv(1, 256, 2, 64, seed=11)
    want = np.asarray(pallas_flash(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal,
                                   interpret=True))
    err1 = np.abs(_tf32_attention(q, k, v, causal, passes=1) - want).max()
    err3 = np.abs(_tf32_attention(q, k, v, causal, passes=3) - want).max()
    assert err1 > 10 * ATOL and err3 < ATOL


def test_tf32_rounding_is_nearest_ties_away():
    # TF32 keeps 10 mantissa bits: the ulp at 1 is 2^-10, so 2^-11 is a tie
    x = torch.tensor([1.0, 1.0 + 2 ** -11, -(1.0 + 2 ** -11),
                      1.0 + 2 ** -12, 1.0 + 3 * 2 ** -12], dtype=torch.float32)
    want = torch.tensor([1.0, 1.0 + 2 ** -10, -(1.0 + 2 ** -10), 1.0,
                         1.0 + 2 ** -10])
    got = _tf32(x)
    assert torch.equal(got, want)
    assert (got.view(torch.int32) & 0x1FFF == 0).all()
    # hi + lo carries 22 of float32's 24 mantissa bits
    r = torch.from_numpy(np.random.RandomState(0).randn(1000)
                         .astype(np.float32))
    hi = _tf32(r)
    rel = ((hi + _tf32(r - hi)) - r).abs() / r.abs()
    assert rel.max() < 2.0 ** -21


def test_attention_reference_matches_jax():
    q, k, v = _qkv(1, 9, 3, 8, seed=5)
    for causal in (False, True):
        want = np.asarray(jax_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal=causal))
        got = mt.parallel.attention_reference(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            causal=causal).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_flash_tiles_resolve_and_clamp():
    f32 = torch.float32
    assert ck.FLASH_DEFAULT_TILE in ck.FLASH_TILES
    assert ck.flash_tiles(1024, 64, True, f32, CPU) == ck.FLASH_DEFAULT_TILE
    assert ck.flash_tiles(20, 64, True, f32, CPU) == (64, 32)
    assert ck.flash_tiles(1, 64, False, f32, CPU) == (64, 32)
    assert ck.flash_tiles(100, 64, False, f32, CPU, 128, 64) == (128, 64)
    assert ck.flash_tiles(1024, 64, True, f32, CPU, 128, 32) == (128, 32)
    for bad in ((16, 32), (64, 128), (48, 64), (64, 16)):
        with pytest.raises(MXNetError):
            ck.flash_tiles(1024, 64, True, f32, CPU, *bad)
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 8, 1, 4))
    with pytest.raises(MXNetError):
        ck.flash_attention(q, k, v, block_q=32)


def test_flash_wrapper_rejects_bad_shapes_and_counts_nothing_on_cpu():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 8, 2, 4))
    with pytest.raises(MXNetError):
        ck.flash_attention(q, k[:, :7], v)
    with pytest.raises(MXNetError):
        ck.flash_attention(q[0], k[0], v[0])
    ck.reset_launches()
    out = ck.flash_attention(q, k, v, causal=True)
    assert torch.equal(out, ck.flash_attention_reference(q, k, v, True))
    assert ck.LAUNCHES == {name: 0 for name in ck.SOURCES}


def test_flash_source_builds_for_hopper_with_every_tile():
    src = os.path.join(ck._CSRC, ck.SOURCES["flash_attention"])
    with open(src) as f:
        text = f.read()
    with open(os.path.join(ck._CSRC, "attention.cuh")) as f:
        header = f.read()
    assert 'extern "C" int mxtt_flash_attention(' in text
    assert "pallas_kernels.py:73" in text             # names the TPU kernel
    assert "atomic" not in text.replace("no atomics", "") + header
    for bq, bk in ck.FLASH_TILES:
        assert "FLASH_TILE(%d, %d)" % (bq, bk) in text
    # 3xTF32 on the tensor cores, K/V through a cp.async ring
    # the key-tile step lives in the header the paged kernel shares
    assert '#include "attention.cuh"' in text
    assert "mxtt::attention_tile<" in text and "mma_3xtf32(" in header
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in header
    assert "cvt.rna.tf32.f32" in header and "cp.async.cg" in header
    assert "constexpr int kStages = 2;" in text and "__ldg(k" not in text
    cmd = ck.nvcc_command(src, "/dev/null")
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    assert len({ck._lib_path(n) for n in ck.SOURCES}) == len(ck.SOURCES)


# ---------------------------------------------------------------------------
# shape classes, store, cost model: equal to the JAX package's


@pytest.mark.parametrize("args", [(40, 8, False), (200, 64, True),
                                  (256, 64, True), (257, 64, True),
                                  (1024, 64, True), (1, 128, False)])
def test_flash_class_equals_jax(args):
    t, d, causal = args
    want = jax_ks.flash_class(t, d, causal, np.float32)
    assert ks.flash_class(t, d, causal, np.float32) == want
    assert ks.flash_class(t, d, causal, torch.float32) == want


def test_flash_class_pow2_buckets_and_other_classes_equal_jax():
    assert ks.flash_class(200, 8, False, np.float32) \
        == ks.flash_class(256, 8, False, np.float32)
    assert ks.flash_class(257, 8, False, np.float32) \
        != ks.flash_class(256, 8, False, np.float32)
    assert ks.fc_class(4096, 25088, "relu", False, torch.float32) == \
        jax_ks.fc_class(4096, 25088, "relu", False, np.float32)
    assert ks.paged_class(16, 64, True, torch.float32) == \
        jax_ks.paged_class(16, 64, True, np.float32)


def test_jax_store_record_loads_in_port_and_back(tmp_path):
    log = [({"block_q": 64, "block_k": 64, "_feat": [1.0] * 18,
             "est_s": 1e-4}, 3e-4),
           ({"block_q": 16, "block_k": 32, "parity": False}, -1.0)]
    key = "k" * 64
    jax_store.save_config(key, {"block_q": 64, "block_k": 64}, 3e-4,
                          meta={"class": ["flash", "float32", 64, 8, True]},
                          log=log, model_version=jax_cm.COSTMODEL_VERSION)
    with open(jax_store.config_path(key)) as f:
        written = json.load(f)
    assert store.config_path(key) == jax_store.config_path(key)
    got = store.load_config(key, model_version=cm.COSTMODEL_VERSION)
    assert got == written
    # and a record the port writes loads in the JAX package, unchanged
    key2 = "p" * 64
    store.save_config(key2, {"block_q": 32, "block_k": 128}, 1e-3,
                      meta={"backend": "torch-cpu/x1"}, log=log,
                      model_version=cm.COSTMODEL_VERSION)
    with open(store.config_path(key2)) as f:
        written2 = json.load(f)
    assert jax_store.load_config(
        key2, model_version=jax_cm.COSTMODEL_VERSION) == written2


def test_store_default_dir_and_cap(tmp_path, monkeypatch):
    monkeypatch.delenv("MXNET_AUTOTUNE_DIR")
    assert store.store_dir().endswith(
        os.path.join(".cache", "mxnet_tpu_torch", "autotune"))
    monkeypatch.setenv("MXNET_AUTOTUNE_DIR", str(tmp_path))
    monkeypatch.setenv("MXNET_AUTOTUNE_STORE_MAX", "2")
    for i in range(4):
        store.save_config("key%d" % i, {"x": i}, 1.0)
        os.utime(store.config_path("key%d" % i), (i, i))
    assert len(store.list_configs()) == 2 and "key3" in store.list_configs()


def test_costmodel_matches_jax(monkeypatch):
    assert cm.FEATURE_NAMES == jax_cm.FEATURE_NAMES
    assert cm.COSTMODEL_VERSION == jax_cm.COSTMODEL_VERSION
    rng = np.random.RandomState(3)
    feats = [cm.features(gflops=g, hbm_gb=h, block_q=bq, block_k=bk,
                         inv_k=1.0 / k, superstep_k=k, unroll=u,
                         pad_waste=pw, fuse=fu, quant_ops=qo, remat=rm)
             for g, h, bq, bk, k, u, pw, fu, qo, rm in zip(
                 rng.uniform(0, 50, 12), rng.uniform(0, 2, 12),
                 rng.choice([16, 32, 64], 12), rng.choice([32, 64], 12),
                 rng.randint(1, 9, 12), rng.randint(1, 4, 12),
                 rng.uniform(0, 0.5, 12), rng.randint(0, 2, 12),
                 rng.randint(0, 4, 12), rng.randint(0, 2, 12))]
    samples = [(f, float(c)) for f, c in zip(
        feats, rng.uniform(1e-4, 1e-2, len(feats)))]
    for peak in (("67", "3350", "450"), ("100", "800", "50")):
        for name, val in zip(("MXNET_PEAK_TFLOPS", "MXNET_HBM_GBPS",
                              "MXNET_ICI_GBPS"), peak):
            monkeypatch.setenv(name, val)
        for f in feats:
            assert cm.analytic_cost(f) == jax_cm.analytic_cost(f)
        mine = cm.CostModel("b").fit(samples)
        theirs = jax_cm.CostModel("b").fit(samples)
        assert mine.trained and theirs.trained
        np.testing.assert_array_equal(mine.coef, theirs.coef)
        assert mine.rank(feats) == theirs.rank(feats)
        for f in feats:
            assert mine.predict(f) == theirs.predict(f)


def test_costmodel_defaults_are_the_h100s(monkeypatch):
    for name in ("MXNET_PEAK_TFLOPS", "MXNET_HBM_GBPS", "MXNET_ICI_GBPS"):
        monkeypatch.delenv(name, raising=False)
    assert (cm.PEAK_TFLOPS, cm.HBM_GBPS) == (67.0, 3350.0)
    # 6.7 GFLOP at 67 TFLOP/s plus 3.35 GB at 3,350 GB/s
    f = cm.features(gflops=6.7, hbm_gb=3.35)
    np.testing.assert_allclose(cm.analytic_cost(f), 1e-4 + 1e-3, rtol=1e-9)


def test_backend_descriptor_names_framework_and_device():
    assert mt.autotune.backend_descriptor("cpu") == "torch-cpu/x1"
    key = mt.autotune.tuning_key("kernelsearch:flash", ("flash",),
                                 device="cpu")
    assert key != jax_ks._class_key(("flash",))


# ---------------------------------------------------------------------------
# the search


def test_search_flash_persists_and_reloads():
    cls = ks.flash_class(40, 8, False, np.float32)
    assert ks.best_config(cls, device=CPU) is None   # nothing persisted yet
    with ks._cache_lock:                             # drop the negative memo
        ks._best_cache.clear()
    cands = ks.flash_candidates(40)
    assert cands == [{"block_q": 64, "block_k": bk} for bk in (32, 64)]
    assert len(ks.flash_candidates(1024)) == len(ck.FLASH_TILES)
    win = ks.search_flash(1, 40, 1, 8, causal=False, trials=1, shortlist=1,
                          ctx=mt.cpu())
    assert set(win) == {"block_q", "block_k"} and win in cands
    first = mt.autotune.recent_stats()[-1].report()
    assert first["source"] == "measured"
    assert first["calls"] == {"gate": 2, "featurize": 2, "measure": 1}
    assert ks.best_config(cls, device=CPU) == win
    doc = store.load_config(ks._class_key(cls, CPU),
                            model_version=cm.COSTMODEL_VERSION)
    assert doc["config"] == win and doc["meta"]["measured"] == 1
    assert doc["meta"]["space_size"] == len(cands)
    assert doc["meta"]["backend"] == "torch-cpu/x1"
    assert doc["meta"]["class"] == list(cls)
    # second search: a store hit, zero gate, featurize or measure calls
    win2 = ks.search_flash(1, 40, 1, 8, causal=False, trials=1, shortlist=1,
                           ctx=mt.cpu())
    second = mt.autotune.recent_stats()[-1].report()
    assert win2 == win and second["source"] == "cache"
    assert second["calls"] == {"gate": 0, "featurize": 0, "measure": 0}


def test_search_flash_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(MXNetError):
        ks.search_flash(1, 40, 1, 8)


def test_search_flash_gate_excludes_parity_failures(monkeypatch):
    """A candidate whose output misses the plain version is logged and can
    never win, even though the cost model ranks it first."""
    real = ck.flash_attention
    fails_before = ks.parity_fail_total()

    def sabotaged(q, k, v, causal=False, block_q=None, block_k=None):
        out = real(q, k, v, causal, block_q, block_k)
        return out + 1e-3 if block_k == 64 else out

    monkeypatch.setattr(ck, "flash_attention", sabotaged)
    win = ks.search_flash(1, 40, 1, 8, causal=True, trials=1, shortlist=2,
                          ctx=mt.cpu())
    assert win == {"block_q": 64, "block_k": 32}    # the 64-key tile gated
    assert ks.parity_fail_total() == fails_before + 1
    cls = ks.flash_class(40, 8, True, np.float32)
    doc = store.load_config(ks._class_key(cls, CPU),
                            model_version=cm.COSTMODEL_VERSION)
    gated = [(c, s) for c, s in doc["log"] if c.get("parity") is False]
    assert len(gated) == 1 and all(s == -1.0 for _c, s in gated)
    assert {c["block_k"] for c, _s in gated} == {64}
    # every candidate failing: an error, never a winner that was not gated
    monkeypatch.setattr(ck, "flash_attention",
                        lambda *a, **kw: real(*a, **kw) + 1.0)
    with pytest.raises(MXNetError):
        ks.search_flash(1, 40, 1, 8, causal=False, trials=1, ctx=mt.cpu())
    assert ks.parity_fail_total() == fails_before + 1 + 2


def test_call_time_resolution_is_opt_in(monkeypatch):
    win = ks.search_flash(1, 40, 1, 8, causal=True, trials=1, shortlist=1,
                          ctx=mt.cpu())
    f32 = torch.float32
    # knob off: the call site never consults the store
    assert ck._searched_flash(40, 8, True, f32, CPU) is None
    assert ck.flash_tiles(40, 8, True, f32, CPU) == ck.FLASH_DEFAULT_TILE
    # knob on: the persisted winner resolves at call time ...
    monkeypatch.setenv("MXNET_KERNEL_SEARCH", "1")
    assert ck._searched_flash(40, 8, True, f32, CPU) == win
    assert ck.flash_tiles(40, 8, True, f32, CPU) == (win["block_q"],
                                                     win["block_k"])
    # ... T buckets to the class (T=33 shares T=40's pow2 class) ...
    assert ck._searched_flash(33, 8, True, f32, CPU) == win
    # ... an unsearched class resolves to None, and an explicit tile wins
    assert ck._searched_flash(40, 8, False, f32, CPU) is None
    assert ck.flash_tiles(40, 8, True, f32, CPU, 64, 32) == (64, 32)
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 40, 1, 8, seed=1))
    via_winner = ck.flash_attention(q, k, v, causal=True)
    explicit = ck.flash_attention(q, k, v, causal=True,
                                  block_q=win["block_q"],
                                  block_k=win["block_k"])
    assert torch.equal(via_winner, explicit)
    want = np.asarray(jax_attention(*(jnp.asarray(x.numpy())
                                      for x in (q, k, v)), causal=True))
    np.testing.assert_allclose(via_winner.numpy(), want, rtol=0, atol=ATOL)


def test_stale_winner_takes_the_default_tile(monkeypatch):
    """A store written for an older tile set names a tile that is no
    longer compiled: the call path treats it as no winner and runs the
    default tile; the next search re-searches and overwrites it."""
    cls = ks.flash_class(40, 8, True, np.float32)
    key = ks._class_key(cls, CPU)
    store.save_config(key, {"block_q": 16, "block_k": 32}, 1e-4,
                      meta={"class": list(cls)},
                      model_version=cm.COSTMODEL_VERSION)
    monkeypatch.setenv("MXNET_KERNEL_SEARCH", "1")
    f32 = torch.float32
    assert ks.best_config(cls, device=CPU) == {"block_q": 16, "block_k": 32}
    assert ck._searched_flash(40, 8, True, f32, CPU) is None
    assert ck.flash_tiles(40, 8, True, f32, CPU) == ck.FLASH_DEFAULT_TILE
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 40, 1, 8, seed=2))
    out = ck.flash_attention(q, k, v, causal=True)
    assert torch.equal(out, ck.flash_attention_reference(q, k, v, True))
    win = ks.search_flash(1, 40, 1, 8, causal=True, trials=1, shortlist=1,
                          ctx=mt.cpu())
    assert mt.autotune.recent_stats()[-1].report()["source"] == "measured"
    assert (win["block_q"], win["block_k"]) in ck.FLASH_TILES
    assert ck._searched_flash(40, 8, True, f32, CPU) == win
    assert ks.flash_class(40, 8, True, torch.float32) == \
        jax_ks.flash_class(40, 8, True, np.float32)


def test_library_digest_follows_included_headers(tmp_path):
    """An edit to a header a source includes changes the library's path,
    so the stale library is never loaded; sources that do not include it
    keep theirs."""
    csrc = tmp_path / "csrc"
    import shutil
    shutil.copytree(ck._CSRC, str(csrc))
    before = {n: ck._lib_path(n, csrc=str(csrc)) for n in ck.SOURCES}
    assert before == {n: ck._lib_path(n) for n in ck.SOURCES}
    # a header no source includes: every library keeps its path
    (csrc / "unused.cuh").write_bytes(b"// not included\n")
    assert {n: ck._lib_path(n, csrc=str(csrc)) for n in ck.SOURCES} == \
        before
    # attention.cuh: every source includes it (fc_epilogue.cu for mma_16)
    header = csrc / "attention.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = {n: ck._lib_path(n, csrc=str(csrc)) for n in ck.SOURCES}
    for n in ("flash_attention", "paged_attention", "correlation",
              "fused_fc_epilogue"):
        assert after[n] != before[n]


def test_autotuner_select_best_and_store_hit():
    at = mt.autotune
    assert at.select_best([({"a": 1}, 2.0), ({"a": 2}, 1.0),
                           ({"a": 3}, 1.0)]) == ({"a": 2}, 1.0)
    with pytest.raises(MXNetError):
        at.select_best([])
    seen = []

    def measure(cfg):
        seen.append(cfg["a"])
        return {1: 0.3, 2: 0.1, 3: 0.2}[cfg["a"]]

    cands = [{"a": 1}, {"a": 2}, {"a": 3}]
    tuner = at.Autotuner("test:toy", "toy-key")
    assert tuner.tune(cands, measure) == ({"a": 2}, 0.1)
    again = at.Autotuner("test:toy", "toy-key")
    assert again.tune(cands, measure) == ({"a": 2}, 0.1)
    assert seen == [1, 2, 3] and again.stats.report()["source"] == "cache"


@pytest.mark.parametrize("env,flag", [(None, None), ("1", None),
                                      ("joint", None), ("0", None),
                                      (None, True), (None, "joint"),
                                      (None, ""), ("joint", False)])
def test_enabled_and_mode_equal_jax(monkeypatch, env, flag):
    import mxnet_tpu.autotune as jax_at
    if env is None:
        monkeypatch.delenv("MXNET_AUTOTUNE", raising=False)
    else:
        monkeypatch.setenv("MXNET_AUTOTUNE", env)
    assert mt.autotune.mode(flag) == jax_at.mode(flag)
    if not isinstance(flag, str):
        assert mt.autotune.enabled(flag) == jax_at.enabled(flag)
