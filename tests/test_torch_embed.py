"""The sparse embedding engine in the port (``mxnet_tpu_torch.embed``,
``_sparse_embedding``, the fused step's lazy row update, ``device_embed``
and ``ServeEngine(embed_dedup=)``) against the JAX package, on the CPU.

At the reference tests' sizes (``tests/test_embed.py``: vocab 48, dim 8),
the same numpy-seeded ids, tables and gradients go through both
packages:

* ``dedup_ids`` (uniq and inv), ``resolve_cap`` and the sentinel folding
  of negative and high out-of-vocabulary ids equal exactly; lookups
  bitwise (a gather and a mask), scatter-adds within rtol 1e-6, atol
  1e-7 (float32 sums in other orders);
* the lazy row update (``sparse_apply_rows``, ``EmbeddingTable.update``,
  ``device_embed`` pushes) within rtol 1e-6, atol 1e-7, with the rows no
  id names bitwise unchanged, momentum included;
* ``Module.fit`` of the reference's rec model with ``MXNET_EMBED_SPARSE``
  unset (both packages' default: the lazy update) from one set of
  parameters: parameters within rtol 1e-5, atol 1e-6 after 8 steps;
  superstep 4 bitwise equal to K=1; pad ids never touch row 0 or row
  ``vocab - 1``;
* a checkpoint of a sparse fit written by either package, resumed by the
  other: the same trajectory within rtol 1e-5, atol 1e-6;
* ``SparseEmbedPass``'s graph equal to the reference's, and
  ``ServeEngine(embed_dedup=True)`` answers against a serial batch-1
  ``Predictor`` within rtol 1e-5, atol 1e-6.
"""
import json
import os
import shutil

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu import embed as jembed
from mxnet_tpu_torch import embed
from mxnet_tpu_torch.base import MXNetError

VOCAB, DIM = 48, 8
RTOL, ATOL = 1e-6, 1e-7
FIT_RTOL, FIT_ATOL = 1e-5, 1e-6


def _jnp(a):
    import jax.numpy as jnp
    return jnp.asarray(a)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _rand_ids(rng, shape, vocab=VOCAB):
    return rng.randint(0, vocab, size=shape).astype(np.int32)


# -- the functional core -----------------------------------------------------

def _id_cases():
    rng = np.random.RandomState(0)
    pads = _rand_ids(rng, (40,))
    pads[::5] = -1
    pads[3] = VOCAB + 7
    pads[11] = VOCAB
    full = np.concatenate([np.arange(VOCAB), [-1]]).astype(np.int32)
    return {"random": (_rand_ids(rng, (5, 7)), None),
            "tight-cap": (_rand_ids(rng, (64,), vocab=10), 10),
            "pads-and-oov": (pads, None),
            "full-vocab-plus-pad": (full, None),
            "float-ids": (_rand_ids(rng, (16,)).astype(np.float32), None)}


@pytest.mark.parametrize("case", sorted(_id_cases()))
def test_dedup_ids_and_lookup_match_reference(case):
    ids, cap = _id_cases()[case]
    rng = np.random.RandomState(1)
    W = rng.randn(VOCAB, DIM).astype(np.float32)
    flat = ids.reshape(-1)
    k = embed.resolve_cap(cap, flat.size, VOCAB)
    assert k == jembed.resolve_cap(cap, flat.size, VOCAB)
    ju, ji = jembed.dedup_ids(_jnp(flat), k, sentinel=VOCAB)
    tu, ti = embed.dedup_ids(torch.as_tensor(flat), k, VOCAB)
    assert tu.dtype == torch.int32
    np.testing.assert_array_equal(_np(tu), _np(ju))
    np.testing.assert_array_equal(_np(ti), _np(ji))
    jo, _, _ = jembed.dedup_lookup(_jnp(W), _jnp(ids), cap=cap)
    to, _, _ = embed.dedup_lookup(torch.as_tensor(W), torch.as_tensor(ids),
                                  cap=cap)
    assert np.isfinite(_np(to)).all()
    np.testing.assert_array_equal(_np(to), _np(jo))
    np.testing.assert_array_equal(
        _np(embed.naive_lookup(torch.as_tensor(W), torch.as_tensor(ids))),
        _np(jembed.naive_lookup(_jnp(W), _jnp(ids))))


def test_dedup_truncation_reads_nan_as_the_reference():
    """A cap below the batch's distinct ids is a wrong-result choice in
    both packages: the first ``cap`` values are kept, the others' inv
    runs past the buffer and the lookup reads NaN there."""
    ids = np.array([5, 1, 9, 1, 3, 9], np.int32)
    ju, ji = jembed.dedup_ids(_jnp(ids), 2, sentinel=VOCAB)
    tu, ti = embed.dedup_ids(torch.as_tensor(ids), 2, VOCAB)
    np.testing.assert_array_equal(_np(tu), _np(ju))
    np.testing.assert_array_equal(_np(ti), _np(ji))
    W = np.ones((VOCAB, DIM), np.float32)
    out = _np(embed.dedup_lookup(torch.as_tensor(W), torch.as_tensor(ids),
                                 cap=1)[0])
    want = np.asarray(jembed.dedup_lookup(_jnp(W), _jnp(ids), cap=1)[0])
    np.testing.assert_array_equal(np.isnan(out), np.isnan(want))
    assert np.isnan(out).any()


def test_scatter_adds_match_reference():
    rng = np.random.RandomState(1)
    ids = _rand_ids(rng, (64,))
    ids[::9] = -1
    g = rng.randn(64, DIM).astype(np.float32)
    ju, ji = jembed.dedup_ids(_jnp(ids), 64, sentinel=VOCAB)
    tu, ti = embed.dedup_ids(torch.as_tensor(ids), 64, VOCAB)
    np.testing.assert_allclose(
        _np(embed.dedup_scatter_add(torch.as_tensor(g), ti, 64)),
        _np(jembed.dedup_scatter_add(_jnp(g), ji, 64)),
        rtol=RTOL, atol=RTOL)
    naive_t = _np(embed.naive_scatter_add(torch.zeros(VOCAB, DIM),
                                          torch.as_tensor(ids),
                                          torch.as_tensor(g)))
    naive_j = np.asarray(jembed.naive_scatter_add(
        _jnp(np.zeros((VOCAB, DIM), np.float32)), _jnp(ids), _jnp(g)))
    np.testing.assert_allclose(naive_t, naive_j, rtol=RTOL, atol=RTOL)
    # a negative id drops: it never wraps onto row vocab-1
    out = _np(embed.naive_scatter_add(torch.zeros(VOCAB, DIM),
                                      torch.tensor([-1, 2]),
                                      torch.ones(2, DIM)))
    assert (out[VOCAB - 1] == 0).all() and (out[2] == 1).all()


def _opt_pair(name, **kw):
    return (getattr(jmx.optimizer, name)(**kw),
            getattr(mx.optimizer, name)(**kw))


@pytest.mark.parametrize("opt,kw", [
    ("SGD", {"learning_rate": 0.5, "momentum": 0.9, "wd": 1e-3}),
    ("SGD", {"learning_rate": 0.5}),
    ("Adam", {"learning_rate": 0.1}),
    ("AdaGrad", {"learning_rate": 0.1}),
    ("NAG", {"learning_rate": 0.1, "momentum": 0.9})])
def test_table_update_matches_reference(opt, kw):
    """Three deduped lazy updates of padded id batches: rows and slots
    within tolerance of the reference's table, rows no batch names
    bitwise at their start values."""
    rng = np.random.RandomState(2)
    W = rng.randn(VOCAB, DIM).astype(np.float32)
    jo, to = _opt_pair(opt, **kw)
    jt = jembed.EmbeddingTable(VOCAB, DIM, initializer=W, optimizer=jo)
    tt = embed.EmbeddingTable(VOCAB, DIM, initializer=W, optimizer=to,
                              ctx=mx.cpu())
    named = set()
    for step in range(3):
        ids = _rand_ids(rng, (4, 3), vocab=VOCAB - 8)
        ids[:, 2] = -1
        named |= set(ids[ids >= 0].tolist())
        g = rng.randn(4, 3, DIM).astype(np.float32)
        jt.update(ids, g)
        tt.update(ids, g)
    np.testing.assert_allclose(tt.as_numpy(), jt.as_numpy(), rtol=RTOL,
                               atol=RTOL)
    jl = jax_leaves(jt.state()["slots"])
    tl = [_np(x) for x in _leaves(tt.state()["slots"])]
    assert len(jl) == len(tl)
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=RTOL)
    untouched = sorted(set(range(VOCAB)) - named)
    assert VOCAB - 1 in untouched
    np.testing.assert_array_equal(tt.as_numpy()[untouched], W[untouched])
    for leaf in tl:
        assert (leaf[untouched] == 0).all()
    assert tt._t == jt._t == 3


def _leaves(x):
    if x is None:
        return []
    if isinstance(x, (tuple, list)):
        return [a for e in x for a in _leaves(e)]
    return [x]


def jax_leaves(x):
    return [np.asarray(a) for a in _leaves(x)]


def test_slot_leaves_row_shaped_and_refusals():
    for opt in (mx.optimizer.SGD(momentum=0.9), mx.optimizer.Adam(),
                mx.optimizer.AdaGrad(), mx.optimizer.NAG(momentum=0.9),
                mx.optimizer.SGD()):
        init, _ = opt.fused_update_fn()
        assert embed.slot_leaves_row_shaped(init, VOCAB, DIM)
    init, _ = mx.optimizer.RMSProp().fused_update_fn()
    assert embed.slot_leaves_row_shaped(init, VOCAB, DIM)
    with pytest.raises(MXNetError, match="fused"):
        embed.EmbeddingTable(VOCAB, DIM, ctx=mx.cpu(),
                             optimizer=mx.optimizer.SGLD())
    # a mesh of one rank holds the whole table; the port cuts rows only
    one = embed.EmbeddingTable(VOCAB, DIM, mesh="dp=1", ctx=mx.cpu())
    assert tuple(one.rows.shape) == (VOCAB, DIM)
    with pytest.raises(MXNetError, match="rows over one mesh axis"):
        embed.EmbeddingTable(VOCAB, DIM, mesh="dp=1", spec=(None, "dp"),
                             ctx=mx.cpu())


def test_table_lookup_combiners_accumulate_and_cap_guard(monkeypatch):
    rng = np.random.RandomState(3)
    W = rng.randn(VOCAB, DIM).astype(np.float32)
    jt = jembed.EmbeddingTable(VOCAB, DIM, initializer=W)
    tt = embed.EmbeddingTable(VOCAB, DIM, initializer=W, ctx=mx.cpu())
    ids = np.array([[3, 7, -1, -1], [7, 7, 7, VOCAB], [-1, -1, -1, -1]],
                   np.int32)
    for comb in (None, "sum", "mean"):
        np.testing.assert_allclose(_np(tt.lookup(ids, combiner=comb)),
                                   np.asarray(jt.lookup(ids, combiner=comb)),
                                   rtol=RTOL, atol=RTOL, err_msg=str(comb))
    vals = rng.randn(5, DIM).astype(np.float32)
    acc_ids = np.array([-1, 3, 3, VOCAB + 2, 0])
    jt.accumulate(acc_ids, vals)
    tt.accumulate(acc_ids, vals)
    np.testing.assert_allclose(tt.as_numpy(), jt.as_numpy(), rtol=RTOL,
                               atol=RTOL)
    np.testing.assert_array_equal(tt.as_numpy()[VOCAB - 1], W[VOCAB - 1])
    # an explicit cap below the batch's distinct ids raises, pads free
    capped = embed.EmbeddingTable(VOCAB, DIM, unique_cap=2, ctx=mx.cpu())
    capped.lookup(np.array([1, 2, -1, -1, VOCAB]))
    with pytest.raises(MXNetError, match="distinct ids"):
        capped.lookup(np.array([1, 2, 3, 4]))
    monkeypatch.setenv("MXNET_EMBED_CHECK_CAP", "0")
    unchecked = embed.EmbeddingTable(VOCAB, DIM, unique_cap=2,
                                     initializer=W, ctx=mx.cpu())
    junchecked = jembed.EmbeddingTable(VOCAB, DIM, unique_cap=2,
                                       initializer=W)
    np.testing.assert_array_equal(
        _np(unchecked.lookup(np.array([1, 2, 3, 4]))),
        np.asarray(junchecked.lookup(np.array([1, 2, 3, 4]))))
    with pytest.raises(MXNetError, match="no optimizer"):
        tt.update(np.array([1]), np.ones((1, DIM), np.float32))
    rep = mx.profiler.embed_report()
    assert any("embed_weight" in v["tables"] for v in rep.values())
    assert "dedup" in mx.profiler.embed_report_str()


def test_negative_pad_ids_never_corrupt_last_row():
    rng = np.random.RandomState(9)
    W = rng.randn(VOCAB, DIM).astype(np.float32)
    t = embed.EmbeddingTable(
        VOCAB, DIM, initializer=W, ctx=mx.cpu(),
        optimizer=mx.optimizer.SGD(momentum=0.9, learning_rate=0.5))
    ids = np.array([[5, -1, -1], [9, -1, VOCAB]], np.int32)
    t.update(ids, np.ones((2, 3, DIM), np.float32))
    after = t.as_numpy()
    np.testing.assert_array_equal(after[0], W[0])
    np.testing.assert_array_equal(after[VOCAB - 1], W[VOCAB - 1])
    assert not np.allclose(after[5], W[5])
    t2 = embed.EmbeddingTable(VOCAB, DIM, initializer=W, ctx=mx.cpu())
    t2.accumulate(np.array([-1, -1, 3]), np.ones((3, DIM), np.float32))
    a2 = t2.as_numpy()
    np.testing.assert_array_equal(a2[VOCAB - 1], W[VOCAB - 1])
    np.testing.assert_array_equal(a2[0], W[0])
    assert (_np(t2.lookup(np.array([[-1]]))) == 0).all()


def test_table_rearm_restore_and_step_counter():
    rng = np.random.RandomState(10)
    W = rng.randn(VOCAB, DIM).astype(np.float32)
    ids = np.array([1, 2, 1], np.int32)
    g = np.ones((3, DIM), np.float32)

    def mk(momentum=0.9):
        return embed.EmbeddingTable(
            VOCAB, DIM, initializer=W, ctx=mx.cpu(),
            optimizer=mx.optimizer.SGD(momentum=momentum,
                                       learning_rate=0.1))
    # re-arming takes the new optimizer's hyperparameters
    t = mk()
    t.update(ids, g)
    t.restore({"rows": W, "slots": np.zeros_like(W), "t": 0})
    t.set_optimizer(mx.optimizer.SGD(momentum=0.5, learning_rate=0.1))
    t.update(ids, g)
    t.update(ids, g)
    ref = mk(0.5)
    ref.update(ids, g)
    ref.update(ids, g)
    np.testing.assert_array_equal(t.as_numpy(), ref.as_numpy())
    # a slot-less tree re-arms fresh slots and t = 0
    src = embed.EmbeddingTable(VOCAB, DIM, initializer=W, ctx=mx.cpu())
    assert src.state()["slots"] is None
    dst = mk()
    dst.restore({"rows": W, "t": 5000})
    assert dst._t == 0
    dst.update(ids, g)
    fresh = mk()
    fresh.update(ids, g)
    np.testing.assert_array_equal(dst.as_numpy(), fresh.as_numpy())
    # a failed update leaves the step count alone
    a = embed.EmbeddingTable(VOCAB, DIM, ctx=mx.cpu(),
                             optimizer=mx.optimizer.Adam(learning_rate=0.1))
    with pytest.raises(Exception):
        a.update(np.array([1, 2]), np.ones((2, DIM + 1), np.float32))
    assert a._t == 0
    a.update(np.array([1, 2]), np.ones((2, DIM), np.float32))
    assert a._t == 1
    a.set_optimizer(mx.optimizer.Adam(learning_rate=0.05))
    assert a._t == 0


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_table_state_crosses_packages(writer):
    """A table trained in one package restores into the other
    (``convert.convert_embed_state`` for the JAX package's tree) and
    both continue with the same update."""
    rng = np.random.RandomState(12)
    W = rng.randn(VOCAB, DIM).astype(np.float32)
    ids = np.array([[1, 4, 4], [9, -1, 2]], np.int32)
    g = rng.randn(2, 3, DIM).astype(np.float32)
    jt = jembed.EmbeddingTable(VOCAB, DIM, initializer=W,
                               optimizer=jmx.optimizer.Adam(0.1))
    tt = embed.EmbeddingTable(VOCAB, DIM, initializer=W, ctx=mx.cpu(),
                              optimizer=mx.optimizer.Adam(0.1))
    src = jt if writer == "jax" else tt
    src.update(ids, g)
    if writer == "jax":
        tt.restore(mx.convert.convert_embed_state(jt.state(), mx.cpu()))
    else:
        jt.restore(tt.state())
    assert jt._t == tt._t == 1
    np.testing.assert_allclose(tt.as_numpy(), jt.as_numpy(), rtol=RTOL,
                               atol=RTOL)
    jt.update(ids, g)
    tt.update(ids, g)
    np.testing.assert_allclose(tt.as_numpy(), jt.as_numpy(), rtol=RTOL,
                               atol=RTOL)


# -- the fused step ----------------------------------------------------------

def _rec_symbol(pkg, vocab=VOCAB, dim=DIM, unique_cap=None, tied=False):
    attr = {"__embed_unique__": str(unique_cap)} if unique_cap else None
    w = pkg.sym.Variable("embed_weight", attr=attr)
    ids = pkg.sym.Variable("ids")
    net = pkg.sym.Embedding(ids, weight=w, input_dim=vocab,
                            output_dim=dim, name="embed")
    net = pkg.sym.Flatten(net)
    if tied:
        net = pkg.sym.FullyConnected(net, weight=w, num_hidden=dim,
                                     no_bias=True, name="tied")
    net = pkg.sym.FullyConnected(net, num_hidden=16, name="fc1")
    net = pkg.sym.Activation(net, act_type="relu")
    return pkg.sym.SoftmaxOutput(
        pkg.sym.FullyConnected(net, num_hidden=2, name="fc2"),
        name="softmax")


def test_find_sparse_embeds_eligibility(monkeypatch):
    args = (["ids"], ["embed_weight", "fc1_weight"])
    found = embed.find_sparse_embeds(_rec_symbol(mx), *args)
    assert set(found) == {"embed_weight"}
    sp = found["embed_weight"]
    assert (sp.ids_name, sp.vocab, sp.dim, sp.cap) == ("ids", VOCAB, DIM,
                                                       None)
    assert embed.find_sparse_embeds(
        _rec_symbol(mx, unique_cap=12), *args)["embed_weight"].cap == 12
    assert embed.find_sparse_embeds(_rec_symbol(mx, tied=True), *args) == {}
    assert embed.find_sparse_embeds(_rec_symbol(mx), ["ids"],
                                    ["fc1_weight"]) == {}
    assert embed.find_sparse_embeds(_rec_symbol(mx), ["other"],
                                    ["embed_weight"]) == {}
    monkeypatch.setenv("MXNET_EMBED_SPARSE", "0")
    assert embed.find_sparse_embeds(_rec_symbol(mx), *args) == {}


def _params0(vocab=VOCAB, seed=4):
    rng = np.random.RandomState(seed)
    return {"embed_weight": (rng.randn(vocab, DIM) * 0.5).astype(np.float32),
            "fc1_weight": (rng.randn(16, 4 * DIM) * 0.3).astype(np.float32),
            "fc1_bias": np.zeros(16, np.float32),
            "fc2_weight": (rng.randn(2, 16) * 0.3).astype(np.float32),
            "fc2_bias": np.zeros(2, np.float32)}


def _fit(pkg, X, momentum=0.9, superstep=None, num_epoch=2, batch=16,
         checkpoint=None, resume=False, vocab=VOCAB, unique_cap=None):
    pkg.random.seed(5)
    y = (np.abs(X).sum(axis=1) % 2).astype(np.float32)
    it = pkg.io.NDArrayIter(X, y, batch_size=batch, data_name="ids")
    ctx = pkg.cpu(0)
    mod = pkg.mod.Module(_rec_symbol(pkg, vocab=vocab,
                                     unique_cap=unique_cap),
                         data_names=("ids",), context=ctx)
    mod.fit(it, num_epoch=num_epoch, superstep=superstep,
            optimizer_params={"learning_rate": 0.5, "momentum": momentum},
            arg_params={k: pkg.nd.array(v, ctx=ctx)
                        for k, v in _params0(vocab).items()},
            checkpoint=checkpoint, resume=resume)
    return mod, {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def _ids(n=64, vocab=VOCAB, seed=0):
    return _rand_ids(np.random.RandomState(seed), (n, 4),
                     vocab=vocab).astype(np.float32)


def test_fused_sparse_fit_is_the_references_lazy_default(monkeypatch):
    """The repair: with MXNET_EMBED_SPARSE unset both packages train the
    table with the lazy row update.  Batch 2 names none of batch 1's
    rows, so under momentum 0.9 those rows keep, through step 2, the
    weights step 1 gave them (a dense update would move them again by
    their momentum), and the whole fit matches the reference."""
    monkeypatch.delenv("MXNET_EMBED_SPARSE", raising=False)
    rng = np.random.RandomState(1)
    X = np.concatenate([_rand_ids(rng, (16, 4), vocab=24),
                        _rand_ids(rng, (16, 4), vocab=24) + 24]
                       ).astype(np.float32)
    one, p1 = _fit(mx, X[:16], num_epoch=1)
    two, p2 = _fit(mx, X, num_epoch=1)
    assert set(two._fused.sparse_embeds) == {"embed_weight"}
    first = np.unique(X[:16].astype(np.int64))
    np.testing.assert_array_equal(p2["embed_weight"][first],
                                  p1["embed_weight"][first])
    second = np.unique(X[16:].astype(np.int64))
    assert not np.allclose(p2["embed_weight"][second],
                           p1["embed_weight"][second])
    _, want = _fit(jmx, X, num_epoch=1)
    for k in want:
        np.testing.assert_allclose(p2[k], want[k], rtol=FIT_RTOL,
                                   atol=FIT_ATOL, err_msg=k)


def test_fused_sparse_fit_matches_reference_over_epochs():
    X = _ids()
    mod, got = _fit(mx, X, num_epoch=3)
    assert mod._fused.stats.eager_steps == 12
    _, want = _fit(jmx, X, num_epoch=3)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=FIT_RTOL,
                                   atol=FIT_ATOL, err_msg=k)
    stats = mod._fused.embed_stats
    assert stats is not None and stats.dedup_ratio() > 1.0
    rep = mx.profiler.embed_report()
    mine = [v for k, v in rep.items() if k.startswith("fused#")]
    assert any("embed_weight" in m["tables"] for m in mine)


def test_fused_sparse_plain_sgd_equals_dense(monkeypatch):
    """Without momentum or weight decay the lazy update is the dense one
    restricted to the touched rows; MXNET_EMBED_SPARSE=0 is the dense
    path."""
    X = _ids()
    mod_s, p_s = _fit(mx, X, momentum=0.0)
    monkeypatch.setenv("MXNET_EMBED_SPARSE", "0")
    mod_d, p_d = _fit(mx, X, momentum=0.0)
    assert mod_s._fused.sparse_embeds and mod_d._fused.sparse_embeds == {}
    for k in p_d:
        np.testing.assert_allclose(p_s[k], p_d[k], rtol=2e-5, atol=1e-6,
                                   err_msg=k)


def test_fused_sparse_superstep_bitwise_and_unique_cap():
    X = _ids()
    m1, p1 = _fit(mx, X)
    m4, p4 = _fit(mx, X, superstep=4)
    assert m4._superstep_runs
    for k in p1:
        np.testing.assert_array_equal(p1[k], p4[k], err_msg=k)
    for a, b in zip(_leaves(m1._fused.state["opt"]["embed_weight"]),
                    _leaves(m4._fused.state["opt"]["embed_weight"])):
        np.testing.assert_array_equal(_np(a), _np(b))
    # a declared cap that covers the batch trains the same as the worst
    # case
    X10 = _ids(vocab=10)
    mc, pc = _fit(mx, X10, vocab=10, unique_cap=10)
    assert mc._fused.sparse_embeds["embed_weight"].cap == 10
    _, pw = _fit(mx, X10, vocab=10)
    for k in pc:
        np.testing.assert_array_equal(pc[k], pw[k], err_msg=k)


def test_fused_sparse_pad_ids_freeze_last_row():
    X = _ids(vocab=VOCAB - 2)
    X[:, 2:] = -1
    X[X == 0] = 1
    X[5, 3] = VOCAB + 3                      # a high out-of-vocab id
    mod, got = _fit(mx, X)
    assert mod._fused.sparse_embeds
    w0 = _params0()["embed_weight"]
    named = np.unique(X[(X >= 0) & (X < VOCAB)].astype(np.int64))
    unnamed = np.setdiff1d(np.arange(VOCAB), named)
    assert VOCAB - 1 in unnamed and 0 in unnamed
    np.testing.assert_array_equal(got["embed_weight"][unnamed],
                                  w0[unnamed])
    assert not np.allclose(got["embed_weight"][named], w0[named])
    assert np.isfinite(got["embed_weight"]).all()
    _, want = _fit(jmx, X)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=FIT_RTOL,
                                   atol=FIT_ATOL, err_msg=k)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_sparse_checkpoint_resumes_in_the_other_package(tmp_path, writer):
    wpkg, rpkg = (jmx, mx) if writer == "jax" else (mx, jmx)
    X = _ids()
    store = str(tmp_path / "store")
    with wpkg.checkpoint.CheckpointManager(store, save_every_steps=3,
                                           keep_last_n=None) as mgr:
        _fit(wpkg, X, num_epoch=1, checkpoint=mgr)
    shutil.rmtree(os.path.join(store, mx.checkpoint.step_dir_name(4)))
    assert mx.checkpoint.latest_step(store) == 3
    with rpkg.checkpoint.CheckpointManager(store, keep_last_n=None) as mgr:
        _, got = _fit(rpkg, X, num_epoch=2, checkpoint=mgr, resume=True)
    _, want = _fit(jmx, X, num_epoch=2)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=FIT_RTOL,
                                   atol=FIT_ATOL, err_msg=k)


# -- kvstore ------------------------------------------------------------------

def test_kvstore_device_embed_matches_reference_store():
    rng = np.random.RandomState(0)
    W = rng.randn(VOCAB, DIM).astype(np.float32)
    stores = {}
    for pkg in (jmx, mx):
        kv = pkg.kvstore.create("device_embed", **(
            {"ctx": mx.cpu()} if pkg is mx else {}))
        assert kv.type == "device_embed"
        kv.init("table", pkg.nd.array(W, ctx=pkg.cpu()), sparse=True)
        kv.init(3, pkg.nd.array(np.ones((4, 4), np.float32), ctx=pkg.cpu()))
        assert kv.is_sparse_key("table") and not kv.is_sparse_key(3)
        out = pkg.nd.zeros((4, 4), ctx=pkg.cpu())
        kv.push(3, pkg.nd.array(np.full((4, 4), 2.0, np.float32),
                                ctx=pkg.cpu()))
        kv.pull(3, out=out)
        assert (out.asnumpy() == 2.0).all()
        ids = np.array([5, 9, 5, VOCAB + 1], np.float32)
        pulled = pkg.nd.zeros((4, DIM), ctx=pkg.cpu())
        kv.row_sparse_pull("table", out=pulled,
                           row_ids=pkg.nd.array(ids, ctx=pkg.cpu()))
        assert (pulled.asnumpy()[3] == 0).all()
        kv.push("table", (pkg.nd.array(ids[:3], ctx=pkg.cpu()),
                          pkg.nd.array(np.ones((3, DIM), np.float32),
                                       ctx=pkg.cpu())))
        kv.set_optimizer(pkg.optimizer.SGD(learning_rate=0.5,
                                           momentum=0.9))
        for _ in range(2):
            kv.push("table", (np.array([1, 2, 1, -1]),
                              rng.randn(4, DIM).astype(np.float32)))
        full = pkg.nd.zeros((VOCAB, DIM), ctx=pkg.cpu())
        kv.pull("table", out=full)
        stores[pkg.__name__] = (kv, pulled.asnumpy(), full.asnumpy())
        rng = np.random.RandomState(0)
        rng.randn(VOCAB, DIM)
    (jkv, jp, jf), (tkv, tp, tf) = stores["mxnet_tpu"], \
        stores["mxnet_tpu_torch"]
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_allclose(tf, jf, rtol=RTOL, atol=RTOL)
    np.testing.assert_array_equal(tf[10:], W[10:])
    # save/load round trip, and the state crosses to the other store
    host = {k: mx.convert.convert_embed_state(v, mx.cpu())
            for k, v in jkv.save_state().items()}
    kv2 = mx.kvstore.create("device_embed", ctx=mx.cpu())
    kv2.init("table", mx.nd.array(W, ctx=mx.cpu()), sparse=True)
    kv2.set_optimizer(mx.optimizer.SGD(learning_rate=0.5, momentum=0.9))
    kv2.load_state(host)
    np.testing.assert_allclose(kv2.table("table").as_numpy(), jf,
                               rtol=RTOL, atol=RTOL)


def test_kvstore_device_embed_auto_threshold_and_errors(monkeypatch):
    monkeypatch.setenv("MXNET_EMBED_SPARSE_BOUND", "16")
    kv = mx.kv.create("device_embed", ctx=mx.cpu())
    kv.init("big", mx.nd.array(np.zeros((16, 4), np.float32), ctx=mx.cpu()))
    kv.init("small", mx.nd.array(np.zeros((15, 4), np.float32),
                                 ctx=mx.cpu()))
    assert kv.is_sparse_key("big") and not kv.is_sparse_key("small")
    with pytest.raises(MXNetError, match="row-sparse form"):
        kv.push("big", mx.nd.array(np.zeros((16, 4), np.float32),
                                   ctx=mx.cpu()))
    with pytest.raises(MXNetError, match="dense key"):
        kv.row_sparse_pull("small", out=mx.nd.zeros((1, 4), ctx=mx.cpu()),
                           row_ids=mx.nd.array([0.0], ctx=mx.cpu()))
    with pytest.raises(MXNetError, match="not a sparse"):
        kv.table("small")


# -- serving ------------------------------------------------------------------

def test_sparse_embedding_op_and_pass_match_reference():
    assert "_sparse_embedding" in mx.ops.list_ops()
    with jmx.name.NameManager():
        jnet = _rec_symbol(jmx)
    net = mx.sym.load_json(jnet.tojson())
    p = mx.passes.SparseEmbedPass()
    out, _ = p.apply(net, None)
    assert p.summary["rewritten"] == 1
    jout, _ = jmx.passes.SparseEmbedPass().apply(jnet, None)
    assert json.loads(out.tojson())["nodes"] == \
        json.loads(jout.tojson())["nodes"]
    assert out.list_arguments() == net.list_arguments()
    # the op alone, padded ids included, against the reference op
    rng = np.random.RandomState(5)
    W = rng.randn(VOCAB, DIM).astype(np.float32)
    ids = _rand_ids(rng, (3, 5))
    ids[0, :2] = -1
    ids[2, 4] = VOCAB + 9
    res = []
    for pkg in (jmx, mx):
        d = pkg.sym.Variable("data")
        s = pkg.sym._sparse_embedding(d, input_dim=VOCAB, output_dim=DIM,
                                      unique_cap=0, name="se")
        ctx = pkg.cpu()
        exe = s.bind(ctx, {"data": pkg.nd.array(ids, ctx=ctx),
                           "se_weight": pkg.nd.array(W, ctx=ctx)})
        res.append(exe.forward()[0].asnumpy())
    np.testing.assert_array_equal(res[1], res[0])
    assert (res[1][0, :2] == 0).all() and (res[1][2, 4] == 0).all()


def _serve_params(rng, L):
    return {"embed_weight": rng.randn(VOCAB, DIM).astype(np.float32),
            "fc1_weight": (rng.randn(16, L * DIM) * 0.1).astype(np.float32),
            "fc1_bias": np.zeros(16, np.float32),
            "fc2_weight": (rng.randn(2, 16) * 0.1).astype(np.float32),
            "fc2_bias": np.zeros(2, np.float32)}


def test_serve_engine_embed_dedup_parity():
    rng = np.random.RandomState(6)
    net = _rec_symbol(mx)
    L = 4
    params = _serve_params(rng, L)
    eng = mx.serve.ServeEngine(net, dict(params),
                               {"ids": (4, L), "softmax_label": (4,)},
                               type_dict={"ids": np.int32},
                               embed_dedup=True, dev_type="cpu",
                               name="rec_test")
    names = [p.name for p in eng.pipeline.passes]
    assert "sparse_embed" in names and "fuse_epilogue" in names
    pred = mx.Predictor(net.tojson(), dict(params),
                        {"ids": (1, L), "softmax_label": (1,)},
                        dev_type="cpu", type_dict={"ids": np.int32})
    jpred = jmx.predictor.Predictor(net.tojson(), dict(params),
                                    {"ids": (1, L), "softmax_label": (1,)},
                                    type_dict={"ids": np.int32})
    reqs = [_rand_ids(rng, (L,)) for _ in range(8)]
    try:
        futs = [eng.submit(r) for r in reqs]
        outs = [f.result(timeout=30) for f in futs]
    finally:
        eng.close()
    for r, o in zip(reqs, outs):
        pred.set_input("ids", r[None])
        pred.forward()
        np.testing.assert_allclose(o, pred.get_output(0)[0], rtol=1e-5,
                                   atol=1e-6)
        jpred.set_input("ids", r[None])
        jpred.forward()
        np.testing.assert_allclose(o, jpred.get_output(0)[0], rtol=1e-5,
                                   atol=1e-6)


def test_serve_engine_embed_dedup_env_default(monkeypatch):
    monkeypatch.setenv("MXNET_EMBED_DEDUP", "1")
    rng = np.random.RandomState(11)
    L = 4
    eng = mx.serve.ServeEngine(_rec_symbol(mx), _serve_params(rng, L),
                               {"ids": (2, L), "softmax_label": (2,)},
                               type_dict={"ids": np.int32}, dev_type="cpu",
                               name="env_dedup")
    try:
        assert any(p.name == "sparse_embed" for p in eng.pipeline.passes)
    finally:
        eng.close()
    pipe = mx.passes.default_inference_pipeline(embed_dedup=12)
    (sp,) = [p for p in pipe.passes if p.name == "sparse_embed"]
    assert sp.unique_cap == 12
    monkeypatch.delenv("MXNET_EMBED_DEDUP")
    assert not any(p.name == "sparse_embed" for p in
                   mx.passes.build_serving_pipeline(ctx=mx.cpu()).passes)


def test_id_valued_inputs_matches_reference():
    assert mx.symbol.id_valued_inputs(_rec_symbol(mx)) == \
        jmx.symbol.id_valued_inputs(_rec_symbol(jmx)) == {"ids"}


def test_fused_sparse_speculation_discard_and_commit():
    """Outputs read between a train forward and update() run the sparse
    step early; a new forward discards it (the table and its momentum
    put back), and a committed early step equals the plain step."""
    X = _ids()
    y = (X.sum(axis=1) % 2).astype(np.float32)
    batches = list(mx.io.NDArrayIter(X, y, batch_size=16, data_name="ids"))

    def module():
        mod = mx.mod.Module(_rec_symbol(mx), data_names=("ids",),
                            context=mx.cpu())
        mod.bind([("ids", (16, 4))], [("softmax_label", (16,))])
        mod.init_params(arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                                    for k, v in _params0().items()})
        mod.init_optimizer(optimizer_params={"learning_rate": 0.5,
                                             "momentum": 0.9})
        assert mod._fused.sparse_embeds
        return mod
    spec, plain = module(), module()
    start = {k: v.asnumpy() for k, v in spec.get_params()[0].items()}
    spec.forward(batches[0], is_train=True)
    spec.get_outputs()[0].asnumpy()
    assert spec._fused_next is not None
    spec.forward(batches[1], is_train=True)       # discards the early step
    for k, v in spec._fused.state["params"].items():
        np.testing.assert_array_equal(v.detach().numpy(), start[k])
    assert (spec._fused.state["opt"]["embed_weight"] == 0).all()
    spec.update()
    spec.forward(batches[2], is_train=True)
    spec.get_outputs()[0].asnumpy()               # early, then committed
    spec.update()
    for b in (batches[1], batches[2]):
        plain.forward(b, is_train=True)
        plain.backward()
        plain.update()
    for k, v in plain.get_params()[0].items():
        np.testing.assert_array_equal(spec.get_params()[0][k].asnumpy(),
                                      v.asnumpy(), err_msg=k)


# -- over a dp axis and row-sharded (ranks: test_torch_multichip.py) ---------
#
# The port's side runs in W gloo ranks (``dist.spawn.run_ranks`` with
# ``test_torch_multichip.embed_rank``), each fed the global batch, W = 2
# and 4; the JAX side is the package's one-device run, which its own
# ``tests/test_embed.py:210-238, 328-337`` holds equal to its sharded one.

MULTICHIP = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "test_torch_multichip.py")
MESH_RTOL, MESH_ATOL = 2e-5, 1e-6          # tests/test_embed.py:335
_JAX_MESH = {}


@pytest.fixture(scope="module")
def emb_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("embed_mesh"))


@pytest.fixture(scope="module")
def emb2(emb_dir):
    from mxnet_tpu_torch.dist.spawn import run_ranks
    return run_ranks(MULTICHIP + ":embed_rank", 2, args=(2, emb_dir),
                     timeout=120)


@pytest.fixture(scope="module")
def emb4(emb_dir):
    from mxnet_tpu_torch.dist.spawn import run_ranks
    return run_ranks(MULTICHIP + ":embed_rank", 4, args=(4, emb_dir),
                     timeout=120)


@pytest.fixture
def emb(request, emb2, emb4):
    return {2: emb2, 4: emb4}[request.param]


def _mc():
    from mxnet_tpu_torch.dist.spawn import load_target
    return load_target(MULTICHIP + ":rec_fit").__globals__


def _jax_rec_fit():
    if "fit" not in _JAX_MESH:
        _JAX_MESH["fit"] = _mc()["rec_fit"](jmx)[1]
    return _JAX_MESH["fit"]


def _mesh_close(got, want, what):
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=MESH_RTOL,
                                   atol=MESH_ATOL, err_msg="%s %s"
                                   % (what, k))


@pytest.mark.parametrize("emb", [2, 4], indirect=True)
def test_fused_sparse_over_dp_is_one_devices_lazy_fit(emb):
    """The repair: fit(mesh="dp=W") keeps the table on the lazy row
    update (the global batch's dedup, its row gradients summed over dp),
    and every rank's params equal the JAX package's one-device lazy fit
    at the reference's own tolerance.  The dense training the parent
    gave over dp differed by 4.5e-3 in the table."""
    want = _jax_rec_fit()
    for rank in emb:
        assert rank["dp_sparse"] == ["embed_weight"]
        _mesh_close(rank["dp"], want, "dp")


@pytest.mark.parametrize("emb", [2, 4], indirect=True)
def test_fused_row_sharded_table_is_one_devices_fit(emb):
    """sharding={"embed_weight": ("dp", None)}: each rank stores vocab/W
    rows, still on the lazy update, and the fit equals one device's; at
    W = 4 also on a dp=2 x tp=2 mesh (reference test_embed.py:328)."""
    want = _jax_rec_fit()
    W = len(emb)
    for rank in emb:
        assert rank["rows_sparse"] == ["embed_weight"]
        assert rank["rows_shape"] == (48 // W, DIM)
        _mesh_close(rank["rows"], want, "rows")
        if W == 4:
            _mesh_close(rank["rows_dptp"], want, "rows dp x tp")


@pytest.mark.parametrize("emb", [2, 4], indirect=True)
def test_row_sharded_save_restores_onto_other_mesh_and_one_process(emb):
    """Each rank writes its rows; the step restores bitwise onto another
    layout (dp=2 x tp=2 from dp=4, the replicated table from dp=2) and
    into one process (reference test_embed.py:517)."""
    saved = emb[0]["ck_saved"]
    for rank in emb:
        for k in saved:
            np.testing.assert_array_equal(rank["ck_saved"][k], saved[k])
            np.testing.assert_array_equal(rank["ck_other_mesh"][k],
                                          saved[k], err_msg=k)
    with mx.cpu():
        _, one = _mc()["rec_fit"](mx, num_epoch=1,
                                  checkpoint=emb[0]["ck_dir"], resume=True)
    for k in saved:
        np.testing.assert_array_equal(one[k], saved[k], err_msg=k)


def _jax_table_run(W):
    if ("table", W) in _JAX_MESH:
        return _JAX_MESH[("table", W)]
    table, ids, g = _mc()["table_inputs"](W)
    sgd = dict(learning_rate=0.1, momentum=0.9)
    t = jembed.EmbeddingTable(VOCAB, DIM, initializer=table,
                              optimizer=jmx.optimizer.SGD(**sgd))
    out = {"lookup": np.asarray(t.lookup(ids)),
           "mean": np.asarray(t.lookup(ids, combiner="mean"))}
    for k in range(2):
        t.update(ids, g[k])
    out["updated"], out["slots"] = t.as_numpy(), np.asarray(t.slots)
    acc = jembed.EmbeddingTable(VOCAB, DIM, initializer=table)
    acc.accumulate(ids, g[0])
    out["accumulated"] = acc.as_numpy()
    kv = jmx.kvstore.create("device_embed")
    kv.init("table", jmx.nd.array(table), sparse=True)
    kv.set_optimizer(jmx.optimizer.SGD(**sgd))
    kv.push("table", (ids.reshape(-1), g[0].reshape(-1, DIM)))
    pulled = jmx.nd.zeros((ids.size, DIM))
    kv.row_sparse_pull("table", out=pulled, row_ids=ids.reshape(-1))
    full = jmx.nd.zeros((VOCAB, DIM))
    kv.pull("table", out=full)
    out["kv"] = (pulled.asnumpy(), full.asnumpy())
    _JAX_MESH[("table", W)] = out
    return out


@pytest.mark.parametrize("emb", [2, 4], indirect=True)
def test_row_sharded_table_is_one_devices_table(emb):
    """EmbeddingTable(mesh=, spec="dp"): each rank holds vocab/W rows and
    passes its own ids; lookups (out-of-range ids included) equal one
    device's over the ranks' ids concatenated, bitwise, and two momentum
    updates and an accumulate equal it within the table tolerance; the
    whole state restores onto a dp x tp mesh cut over tp."""
    W = len(emb)
    want = _jax_table_run(W)
    np.testing.assert_array_equal(
        np.concatenate([r["table"]["lookup"] for r in emb]), want["lookup"])
    np.testing.assert_array_equal(
        np.concatenate([r["table"]["mean"] for r in emb]), want["mean"])
    for rank in emb:
        t = rank["table"]
        assert t["block"] == (VOCAB // W, DIM)
        assert t["other_block"] == (VOCAB // 2, DIM)
        for key in ("updated", "other", "accumulated"):
            np.testing.assert_allclose(t[key], want[key] if key != "other"
                                       else want["updated"], rtol=RTOL,
                                       atol=RTOL, err_msg=key)
        np.testing.assert_allclose(t["state"]["slots"], want["slots"],
                                   rtol=RTOL, atol=RTOL)
        assert t["state"]["t"] == 2


@pytest.mark.parametrize("emb", [2, 4], indirect=True)
def test_device_embed_with_mesh_is_one_devices_store(emb):
    """kvstore.create("device_embed", mesh=, spec=): each rank pushes
    and pulls its own ids; the pushes are summed as one device's store
    applies the whole batch."""
    W = len(emb)
    jp, jf = _jax_table_run(W)["kv"]
    np.testing.assert_array_equal(
        np.concatenate([r["table"]["kv"][0] for r in emb]), jp)
    for rank in emb:
        pulled, full, block = rank["table"]["kv"]
        assert block == (VOCAB // W, DIM)
        np.testing.assert_allclose(full, jf, rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("emb", [2, 4], indirect=True)
def test_row_sharded_table_refusals_match_reference(emb):
    """The reference's refusals (test_embed.py:242-248): a vocab the axis
    does not divide, and spec= without mesh=."""
    from jax.sharding import Mesh
    import jax
    for rank in emb:
        ref = rank["table"]["refusals"]
        assert "divisible" in ref["divisible"]
        assert ref["no mesh"] == "EmbeddingTable spec= without mesh="
    with pytest.raises(jmx.base.MXNetError, match="divisible"):
        jembed.EmbeddingTable(VOCAB + 1, DIM, mesh=Mesh(
            np.array(jax.devices()[:2]), ("dp",)), spec="dp")
    with pytest.raises(jmx.base.MXNetError,
                       match="EmbeddingTable spec= without mesh="):
        jembed.EmbeddingTable(VOCAB, DIM, spec="dp")
    with pytest.raises(MXNetError, match="EmbeddingTable spec= without"):
        embed.EmbeddingTable(VOCAB, DIM, spec="dp", ctx=mx.cpu())
