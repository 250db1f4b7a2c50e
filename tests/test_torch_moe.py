"""Routed Mixture-of-Experts in the port (``mxnet_tpu_torch.moe`` and
the ``_moe_*`` ops) against the JAX package, on the CPU.

At the reference tests' sizes (``tests/test_moe.py``: 4 experts, k 2,
hidden 16, 6 features, decode vocab 13), the same numpy-seeded inputs go
through both packages:

* ``route``: slots, counts, assigned, hits and dropped equal exactly
  (with ties, with drops, renormalized); combine weights and the aux loss
  within rtol 1e-6 (softmax and the mean sum in other orders);
* dispatch and combine: the expert buffer and the combined rows within
  rtol 1e-6, sentinel rows zero;
* each op's forward and gradient through a bound executor within rtol
  1e-5, atol 1e-6;
* ``MoEFeedForward`` through ``Module.fit`` (cf 0 and cf 0.5, SGD with
  momentum, the aux loss trained) from one set of parameters: parameters
  after 8 steps within rtol 1e-4, atol 1e-5 (float32 sums in other
  orders, carried on by momentum), and ``superstep=4`` bitwise equal to
  K=1 in the port;
* ``MoEServeParityPass`` in the serving pipeline, and
  ``DecodeEngine(moe_hits_state=)`` streams equal to the reference
  engine's, token for token, with the hits sampled into
  ``moe_report()``.
"""
import importlib
import os
import json
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx

# the packages export functions named like these modules
jrouter = importlib.import_module("mxnet_tpu.moe.router")
jdispatch = importlib.import_module("mxnet_tpu.moe.dispatch")
trouter = importlib.import_module("mxnet_tpu_torch.moe.router")
tdispatch = importlib.import_module("mxnet_tpu_torch.moe.dispatch")

E, K, HID = 4, 2, 16
FIT_OPT = {"learning_rate": 0.1, "momentum": 0.9}
RTOL, ATOL = 1e-4, 1e-5


def _jnp(a):
    import jax.numpy as jnp
    return jnp.asarray(a)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# -- routing ------------------------------------------------------------------

def test_resolve_capacity_matches_reference():
    for cf, t, e, k in ((0.0, 64, 4, 2), (None, 64, 4, 2), (1.0, 64, 4, 2),
                        (1.25, 256, 8, 2), (0.01, 64, 4, 2),
                        (100.0, 64, 4, 2), (1.25, 8192, 8, 1)):
        assert trouter.resolve_capacity(cf, t, e, k) == \
            jrouter.resolve_capacity(cf, t, e, k)
    assert trouter.resolve_capacity(1.25, 8192, 8, 1) == 1280


def _logits(case):
    rng = np.random.RandomState(1)
    if case == "ties":
        return np.zeros((32, E), np.float32)
    if case == "row-ties":
        base = rng.randn(4, E).astype(np.float32)
        base[:, 1] = base[:, 2]              # two experts tied per row
        return np.repeat(base, 8, axis=0)
    return rng.randn(32, E).astype(np.float32)


@pytest.mark.parametrize("case,cap,renorm", [
    ("random", 32, False), ("random", 5, False), ("random", 3, True),
    ("ties", 32, False), ("ties", 6, False), ("row-ties", 32, False),
    ("row-ties", 7, True)])
def test_route_matches_reference(case, cap, renorm):
    logits = _logits(case)
    want = jrouter.route(_jnp(logits), K, cap, renormalize=renorm)
    got = trouter.route(torch.as_tensor(logits), K, cap,
                        renormalize=renorm)
    assert got.slot.dtype == torch.int32
    for field in ("slot", "counts", "assigned", "hits", "dropped"):
        np.testing.assert_array_equal(_np(getattr(got, field)),
                                      _np(getattr(want, field)),
                                      err_msg=field)
    for field in ("weight", "aux"):
        np.testing.assert_allclose(_np(getattr(got, field)),
                                   _np(getattr(want, field)),
                                   rtol=1e-6, atol=1e-7, err_msg=field)
    if cap < 32:
        assert float(got.dropped) > 0 or case.startswith("row")
    if case == "ties":
        assert float(got.aux) == pytest.approx(1.0, abs=1e-6)


def test_top_k_orders_ties_by_lower_index():
    g = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.4, 0.1]])
    vals, idx = trouter.top_k(g, 2)
    assert idx.tolist() == [[0, 1], [1, 2]]


@pytest.mark.parametrize("cap", [32, 2])
def test_dispatch_combine_match_reference(cap):
    T, D = 32, 8
    rng = np.random.RandomState(2)
    x = rng.randn(T, D).astype(np.float32)
    logits = rng.randn(T, E).astype(np.float32)
    plan_j = jrouter.route(_jnp(logits), K, cap)
    plan_t = trouter.route(torch.as_tensor(logits), K, cap)
    buf_j = jdispatch.dispatch(_jnp(x), plan_j.slot, E, cap)
    buf_t = tdispatch.dispatch(torch.as_tensor(x), plan_t.slot, E, cap)
    np.testing.assert_array_equal(_np(buf_t), _np(buf_j))
    counts = _np(plan_t.counts)
    for e in range(E):
        assert np.all(_np(buf_t)[e, int(counts[e]):] == 0.0)
    out = rng.randn(E, cap, D).astype(np.float32)
    back_j = jdispatch.combine(_jnp(out), plan_j.slot, plan_j.weight, E,
                               cap)
    back_t = tdispatch.combine(torch.as_tensor(out), plan_t.slot,
                               plan_t.weight, E, cap)
    np.testing.assert_allclose(_np(back_t), _np(back_j), rtol=1e-6,
                               atol=1e-7)
    # a dropped token reads exactly zero, whatever the weight says
    ones = torch.ones(E, cap, D)
    back = _np(tdispatch.combine(ones, plan_t.slot,
                                 torch.ones_like(plan_t.weight), E, cap))
    gone = (_np(plan_t.slot) == E * cap).all(axis=1)
    assert np.all(back[gone] == 0.0)


# -- the ops, forward and gradient ------------------------------------------

def _ops_net(pkg, cf, act="relu", no_bias=False, renorm=False):
    data = pkg.sym.Variable("data")
    logits = pkg.sym.Variable("logits")
    disp = pkg.sym._moe_dispatch(data, logits, num_experts=E, k=K,
                                 capacity_factor=cf, renormalize=renorm,
                                 name="d")
    w1 = pkg.sym.Variable("w1")
    w2 = pkg.sym.Variable("w2")
    args = [disp[0], w1] + ([] if no_bias else [pkg.sym.Variable("b1")]) \
        + [w2] + ([] if no_bias else [pkg.sym.Variable("b2")])
    ffn = pkg.sym._moe_expert_ffn(*args, num_hidden=HID, act_type=act,
                                  no_bias=no_bias, name="f")
    out = pkg.sym._moe_combine(ffn, disp[1], disp[2], name="c")
    return pkg.sym.Group([out, disp[3], disp[4], disp[5], disp[2]])


@pytest.mark.parametrize("cf,act,no_bias,renorm", [
    (0.0, "relu", False, False), (0.5, "relu", False, False),
    (0.5, "tanh", True, True), (1.0, "softrelu", False, False)])
def test_ops_forward_and_gradient_match_reference(cf, act, no_bias, renorm):
    T, D = 16, 6
    rng = np.random.RandomState(3)
    vals = {"data": rng.randn(T, D).astype(np.float32),
            "logits": rng.randn(T, E).astype(np.float32),
            "w1": (rng.randn(E, D, HID) * 0.3).astype(np.float32),
            "w2": (rng.randn(E, HID, D) * 0.3).astype(np.float32)}
    if not no_bias:
        vals["b1"] = (rng.randn(E, HID) * 0.1).astype(np.float32)
        vals["b2"] = (rng.randn(E, D) * 0.1).astype(np.float32)
    head = [rng.randn(T, D).astype(np.float32),
            np.ones(1, np.float32), np.zeros(E, np.float32),
            np.zeros((T, E), np.float32), np.zeros((T, K), np.float32)]
    res = {}
    for pkg in (jmx, mx):
        sym = _ops_net(pkg, cf, act, no_bias, renorm)
        ctx = pkg.cpu()
        args = {k: pkg.nd.array(v, ctx=ctx) for k, v in vals.items()}
        grads = {k: pkg.nd.zeros(v.shape, ctx=ctx) for k, v in vals.items()}
        exe = sym.bind(ctx, args, args_grad=grads)
        outs = [o.asnumpy() for o in exe.forward(is_train=True)]
        exe.backward([pkg.nd.array(h, ctx=ctx,
                                   dtype=o.dtype) for h, o in zip(head, outs)])
        res[pkg.__name__] = (outs, {k: g.asnumpy() for k, g in grads.items()},
                             sym.infer_shape(**{k: v.shape for k, v in
                                                vals.items()}),
                             sym.infer_type(data=np.float32))
    (jo, jg, js, jt), (to, tg, ts, tt) = res["mxnet_tpu"], \
        res["mxnet_tpu_torch"]
    assert ts == js and tt == jt
    assert to[4].dtype == np.int32
    np.testing.assert_array_equal(to[4], jo[4])          # slots
    np.testing.assert_array_equal(to[2], jo[2])          # counts
    np.testing.assert_array_equal(to[3], jo[3])          # hits
    for a, b in zip(to[:2], jo[:2]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    for k in vals:
        np.testing.assert_allclose(tg[k], jg[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_registered_ops_and_symbol_json_cross_over():
    for name in ("_moe_dispatch", "_moe_expert_ffn", "_moe_combine"):
        assert name in mx.ops.list_ops()
    with jmx.name.NameManager():
        jnet = _moe_net(jmx, cf=0.5)
    with mx.name.NameManager():
        tnet = _moe_net(mx, cf=0.5)
    assert json.loads(tnet.tojson()) == json.loads(jnet.tojson())
    back = mx.sym.load_json(jnet.tojson())
    assert back.list_arguments() == jnet.list_arguments()
    assert back.list_outputs() == jnet.list_outputs()
    again = jmx.sym.load_json(tnet.tojson())
    assert again.list_arguments() == tnet.list_arguments()
    # expert_axis stamps the reference's sharding attrs
    ep = mx.moe.MoEFeedForward(mx.sym.Variable("data"), num_hidden=HID,
                               num_experts=E, k=K, expert_axis="ep")
    attrs = ep.attr_dict()
    assert attrs["moe_experts_i2h_weight"]["__sharding__"] == \
        "ep,None,None"
    assert attrs["moe_experts_h2o_bias"]["__sharding__"] == "ep,None"


# -- training -----------------------------------------------------------------

def _moe_net(pkg, cf=0.0, name="moe"):
    net = pkg.moe.MoEFeedForward(pkg.sym.Variable("data"), num_hidden=HID,
                                 num_experts=E, k=K, capacity_factor=cf,
                                 name=name)
    net = pkg.sym.FullyConnected(net, num_hidden=2, name="head")
    return pkg.moe.with_aux_loss(pkg.sym.SoftmaxOutput(net, name="softmax"))


def _moe_metric(pkg):
    return pkg.metric.CompositeEvalMetric(
        [pkg.metric.OutputSlice("acc", 0, 1),
         pkg.metric.OutputMean(1, name="moe_aux")])


def _data(pkg, batch_size=16, n=64, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6).astype(np.float32)
    y = (X.sum(axis=1) > 0).astype(np.float32)
    return pkg.io.NDArrayIter(X, y, batch_size=batch_size)


def _params0(seed=4):
    rng = np.random.RandomState(seed)

    def g(*s):
        return (rng.randn(*s) * 0.3).astype(np.float32)
    return {"moe_gate_weight": g(E, 6),
            "moe_experts_i2h_weight": g(E, 6, HID),
            "moe_experts_i2h_bias": g(E, HID) * 0.1,
            "moe_experts_h2o_weight": g(E, HID, 6),
            "moe_experts_h2o_bias": g(E, 6) * 0.1,
            "head_weight": g(2, 6), "head_bias": np.zeros(2, np.float32)}


def _fit(pkg, cf, superstep=None, num_epoch=2):
    pkg.random.seed(7)
    ctx = pkg.cpu(0)
    mod = pkg.mod.Module(_moe_net(pkg, cf=cf), context=ctx)
    met = _moe_metric(pkg)
    mod.fit(_data(pkg), num_epoch=num_epoch, eval_metric=met,
            optimizer_params=dict(FIT_OPT), superstep=superstep,
            arg_params={k: pkg.nd.array(v, ctx=ctx)
                        for k, v in _params0().items()})
    return mod, met, {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


@pytest.mark.parametrize("cf", [0.0, 0.5])
def test_moe_fit_matches_reference(cf):
    _, jmet, want = _fit(jmx, cf)
    tmod, tmet, got = _fit(mx, cf)
    assert tmod._fused is not None and tmod._fused.stats.eager_steps == 8
    assert set(tmod._fused.moe_blocks) == {"moe_dispatch"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    (jn, jv), (tn, tv) = jmet.get(), tmet.get()
    assert jn == tn
    np.testing.assert_allclose(tv, jv, rtol=1e-5)


def test_superstep4_bitwise_with_aux_metric():
    m1, met1, p1 = _fit(mx, 0.5)
    m4, met4, p4 = _fit(mx, 0.5, superstep=4)
    assert m4._superstep_runs
    for k in p1:
        np.testing.assert_array_equal(p1[k], p4[k], err_msg=k)
    assert met1.get() == met4.get()
    s1 = m1._fused.state["opt"]
    s4 = m4._fused.state["opt"]
    for k in s1:
        np.testing.assert_array_equal(_np(s1[k]), _np(s4[k]), err_msg=k)


def test_untouched_expert_rows_bitwise_frozen():
    """The reference's steering: expert 3's gate scores -5 x, so it never
    makes the top 2 on positive features; a fused step leaves its stacked
    rows bitwise while the routed experts move."""
    rng = np.random.RandomState(3)
    X = rng.rand(32, 6).astype(np.float32)
    y = (X.sum(axis=1) > 3).astype(np.float32)
    it = mx.io.NDArrayIter(X, y, batch_size=32)
    mod = mx.mod.Module(_moe_net(mx), context=mx.cpu(0))
    mod.bind(it.provide_data, it.provide_label)
    params = _params0()
    wg = np.zeros((E, 6), np.float32)
    for e in range(E):
        wg[e, e] = 5.0
    wg[3, 3] = -5.0
    params["moe_gate_weight"] = wg
    mod.init_params(arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                                for k, v in params.items()})
    mod.init_optimizer(optimizer_params={"learning_rate": 0.1,
                                         "momentum": 0.9, "wd": 0.0})
    before = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    mod.forward(next(iter(it)), is_train=True)
    mod.backward()
    mod.update()
    after = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    assert mod._fused is not None
    for name in ("moe_experts_i2h_weight", "moe_experts_i2h_bias",
                 "moe_experts_h2o_weight", "moe_experts_h2o_bias"):
        np.testing.assert_array_equal(before[name][3], after[name][3],
                                      err_msg=name)
        assert not np.array_equal(before[name][:3], after[name][:3]), name


def test_moe_stats_registered_and_reported():
    mod, _, _ = _fit(mx, 0.5, num_epoch=1)
    f = mod._fused
    (name, spec), = f.moe_blocks.items()
    assert (spec.num_experts, spec.k, spec.capacity_factor) == (E, K, 0.5)
    f.moe_stats.note_counts(name, np.array([8.0, 4.0, 2.0, 2.0]), 1.0)
    rep = mx.profiler.moe_report()
    mine = [v for k, v in sorted(rep.items()) if k.startswith("fused#")]
    assert mine and mine[-1]["blocks"][name]["routed"] == 16.0
    assert mine[-1]["blocks"][name]["imbalance"] == 2.0
    assert name in mx.profiler.moe_report_str()
    # the counts head of the block is an (E,) output of the dispatch
    net = _moe_net(mx, cf=0.5)
    (counts,) = mx.moe.count_symbols(net)
    assert counts.infer_shape(data=(16, 6))[1] == [(E,)]
    assert mx.moe.with_aux_loss(mx.sym.Variable("x")).list_outputs() == \
        ["x"]


# -- serving ------------------------------------------------------------------

SV_VOCAB, SV_EMB = 13, 8


def test_serve_parity_pass_pins_capacity(monkeypatch):
    net = _moe_net(mx, cf=0.5)
    spec0, = mx.moe.find_moe_blocks(net).values()
    assert spec0.capacity_factor == 0.5
    out, _ = mx.passes.default_inference_pipeline().run(net, {})
    spec, = mx.moe.find_moe_blocks(out).values()
    assert (spec.capacity_factor, spec.num_experts, spec.k) == (0.0, E, K)
    p = mx.passes.MoEServeParityPass()
    p.apply(out, {})
    assert p.summary["rewritten"] == 0
    # the same rewrite as the reference's pass, node for node
    from mxnet_tpu.passes import MoEServeParityPass as JPass
    with jmx.name.NameManager():
        jnet = _moe_net(jmx, cf=0.5)
    jout, _ = JPass().apply(jnet, {})
    tout, _ = mx.passes.MoEServeParityPass().apply(
        mx.sym.load_json(jnet.tojson()), {})
    assert json.loads(tout.tojson())["nodes"] == \
        json.loads(jout.tojson())["nodes"]
    monkeypatch.setenv("MXNET_MOE_SERVE_EXACT", "0")
    out2, _ = mx.passes.default_inference_pipeline().run(net, {})
    spec2, = mx.moe.find_moe_blocks(out2).values()
    assert spec2.capacity_factor == 0.5


def _decode_net(pkg, cf):
    tok = pkg.sym.Variable("data")
    hits = pkg.sym.Variable("moe_hits")
    emb = pkg.sym.Flatten(pkg.sym.Embedding(
        tok, input_dim=SV_VOCAB, output_dim=SV_EMB, name="emb"))
    net = pkg.moe.MoEFeedForward(emb, num_hidden=HID, num_experts=E, k=K,
                                 capacity_factor=cf, name="dmoe")
    logits = pkg.sym.FullyConnected(net, num_hidden=SV_VOCAB, name="out")
    return pkg.sym.Group([logits,
                          hits + pkg.moe.hit_symbols(logits)[0]])


def _decode_params(seed=4):
    rng = np.random.RandomState(seed)

    def g(*s):
        return (rng.randn(*s) * 0.5).astype(np.float32)
    return {"emb_weight": g(SV_VOCAB, SV_EMB),
            "dmoe_gate_weight": g(E, SV_EMB),
            "dmoe_experts_i2h_weight": g(E, SV_EMB, HID),
            "dmoe_experts_i2h_bias": np.zeros((E, HID), np.float32),
            "dmoe_experts_h2o_weight": g(E, HID, SV_EMB),
            "dmoe_experts_h2o_bias": np.zeros((E, SV_EMB), np.float32),
            "out_weight": g(SV_VOCAB, SV_EMB),
            "out_bias": np.zeros(SV_VOCAB, np.float32)}


def test_decode_engine_streams_match_reference():
    """Routed decode through DecodeEngine (the serving pipeline pins
    capacity to no-drop): each stream, run one at a time in both
    packages, is the reference's token for token, and the sampled hits
    count every routed token-choice of every slot."""
    params = _decode_params()
    rng = np.random.RandomState(9)
    prompts = [rng.randint(0, SV_VOCAB, 1 + rng.randint(0, 3))
               for _ in range(6)]
    kw = dict(num_slots=2, state_shapes={"moe_hits": (E,)},
              moe_hits_state="moe_hits", moe_stats_every=1)
    teng = mx.serve.DecodeEngine(
        _decode_net(mx, 0.5), dict(params), dev_type="cpu",
        pipeline=mx.passes.default_inference_pipeline(),
        name="moe-decode-t", **kw)
    jeng = jmx.serve.DecodeEngine(
        _decode_net(jmx, 0.5), dict(params),
        pipeline=jmx.passes.default_inference_pipeline(),
        name="moe-decode-j", **kw)
    try:
        first = teng.generate(prompts[0], timeout=60, max_new_tokens=4)
        steps = teng.stats.report()["steps"]
        # the stream resolves inside its last step, before that step's
        # sample: wait for the sample of every step
        deadline = time.monotonic() + 30
        while teng.moe_stats.report()["blocks"]["moe_hits"]["steps"] \
                < steps and time.monotonic() < deadline:
            time.sleep(0.01)
        # one stream alone: every step routes K choices for both slots
        rep = mx.profiler.moe_report()
        mine = [v for k, v in sorted(rep.items()) if "moe-decode-t" in k]
        assert mine[-1]["blocks"]["moe_hits"]["routed"] == \
            K * 2 * steps
        assert mine[-1]["blocks"]["moe_hits"]["dropped"] == 0
        for p in prompts:
            got = teng.generate(p, timeout=60, max_new_tokens=6)
            want = jeng.generate(p, timeout=60, max_new_tokens=6)
            np.testing.assert_array_equal(got, want)
        futs = [teng.submit(p, max_new_tokens=6) for p in prompts]
        outs = [f.result(timeout=120) for f in futs]
        assert all(len(o) == 6 for o in outs)
        np.testing.assert_array_equal(
            teng.generate(prompts[0], timeout=60, max_new_tokens=4), first)
    finally:
        teng.close()
        jeng.close()
    assert "moe_hits" in mx.profiler.moe_report_str()
    with pytest.raises(mx.serve.ServeError, match="not a declared state"):
        mx.serve.DecodeEngine(_decode_net(mx, 0.0), dict(params),
                              num_slots=2, state_shapes={"moe_hits": (E,)},
                              moe_hits_state="nope", dev_type="cpu",
                              name="moe-decode-bad")


def test_moe_checkpoint_pair_crosses_packages(tmp_path):
    """A routed model's checkpoint pair (the stacked expert tensors
    among its params) written by the JAX package serves in the port,
    and ``convert_params`` carries the same arrays across: the port's
    forward equals the reference's within rtol 1e-5, atol 1e-6."""
    prefix = str(tmp_path / "moe")
    with jmx.name.NameManager():
        net = _moe_net(jmx, cf=0.5)
    params = _params0()
    jmx.model.save_checkpoint(prefix, 0, net,
                              {k: jmx.nd.array(v) for k, v in params.items()},
                              {})
    x = np.random.RandomState(8).randn(16, 6).astype(np.float32)
    shapes = {"data": (16, 6), "softmax_label": (16,)}
    want = jmx.predictor.Predictor(open(prefix + "-symbol.json").read(),
                                   dict(params), shapes)
    want.set_input("data", x)
    want.forward()
    sym, arg, aux = mx.model.load_checkpoint(prefix, 0, ctx=mx.cpu())
    assert arg["moe_experts_i2h_weight"].shape == (E, 6, HID)
    assert arg["moe_experts_h2o_weight"].shape == (E, HID, 6)
    conv, _ = mx.convert.convert_params(
        {"arg:" + k: v for k, v in params.items()}, ctx=mx.cpu())
    for k in params:
        np.testing.assert_array_equal(conv[k].asnumpy(), arg[k].asnumpy())
    got = mx.Predictor(sym.tojson(), {k: v.asnumpy() for k, v in
                                      arg.items()}, shapes, dev_type="cpu")
    got.set_input("data", x)
    got.forward()
    for i in range(2):
        np.testing.assert_allclose(got.get_output(i), want.get_output(i),
                                   rtol=1e-5, atol=1e-6)


# -- expert parallelism over dp x ep (rank processes) -----------------------------

MULTICHIP = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "test_torch_multichip.py")


@pytest.mark.parametrize("cf", [0.0, 0.5])
def test_dp_ep_mesh_matches_single_device_and_shards(cf):
    """``test_moe.py``'s dp=2 x ep=2 case on four gloo ranks: each rank
    holds 2 of the 4 experts at rest, the params after 8 steps are
    within rtol 1e-4 / atol 1e-5 of the JAX package's dp=2 x ep=2 run
    and of its one-device run; the global routing of a batch cut over
    dp=4 gives the JAX package's slots, counts and drops exactly, and
    its aux loss within rtol 1e-6."""
    import jax
    import jax.numpy as jnp
    from mxnet_tpu_torch.dist.spawn import run_ranks
    from mxnet_tpu.moe.router import resolve_capacity as jcap
    spawn = importlib.import_module("mxnet_tpu_torch.dist.spawn")
    mc = spawn.load_target(MULTICHIP + ":moe_fit").__globals__
    ranks = run_ranks(MULTICHIP + ":moe_rank", 4, args=(4, cf),
                      timeout=180)
    _, one = mc["moe_fit"](jmx, cf)
    mesh = jmx.parallel.make_mesh([("dp", 2), ("ep", 2)],
                                  devices=jax.devices()[:4])
    _, want = mc["moe_fit"](jmx, cf, mesh, "ep")
    logits = mc["route_logits"]()
    plan = jrouter.route(jnp.asarray(logits), K,
                         jcap(cf, logits.shape[0], E, K))
    for rank in ranks:
        assert rank["experts"] == (2, 6, HID)
        for ref in (want, one):
            for k in ref:
                np.testing.assert_allclose(rank["params"][k], ref[k],
                                           rtol=RTOL, atol=ATOL, err_msg=k)
        np.testing.assert_array_equal(rank["slot"], np.asarray(plan.slot))
        np.testing.assert_array_equal(rank["counts"],
                                      np.asarray(plan.counts))
        assert rank["dropped"] == float(plan.dropped)
        np.testing.assert_allclose(rank["aux"], float(plan.aux), rtol=1e-6)
