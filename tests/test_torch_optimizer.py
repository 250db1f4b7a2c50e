"""The port's optimizers, schedulers and initializers against the JAX
package's.

Every optimizer runs 5 steps on the same seeded weights and gradients in
both packages, once through ``get_updater`` (the classic per-index
update) and once through its fused form (``fused_update_fn``, written in
place in the port, with lr and t as device scalars), with weight decay,
``rescale_grad``, ``clip_gradient``, ``lr_mult``/``wd_mult`` from symbol
attributes (resolved through ``param_idx2name``) and a
``FactorScheduler``.  Tolerance: rtol 1e-5, atol 1e-6 (float32 updates
of O(1) weights; the two packages round the same formulas in other
orders only where the scalar factors fold).  The deterministic
initializers must give exactly the reference's values; the random ones
the reference's scale.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

RTOL, ATOL = 1e-5, 1e-6
STEPS = 5
NAMES = ["fc_weight", "fc_bias", "w2"]
SHAPES = [(4, 3), (4,), (2, 5)]

OPTIMIZERS = [
    ("sgd", {"momentum": 0.0}),
    ("sgd", {"momentum": 0.9}),
    ("nag", {"momentum": 0.9}),
    ("ccsgd", {"momentum": 0.5}),
    ("adam", {}),
    ("adagrad", {"eps": 1e-6}),
    ("rmsprop", {"gamma1": 0.9, "gamma2": 0.8}),
    ("adadelta", {"rho": 0.8}),
    ("test", {}),
]
IDS = ["%s-%s" % (n, "-".join("%s%s" % kv for kv in sorted(k.items())))
       for n, k in OPTIMIZERS]


def _symbol(s):
    """A graph whose arguments carry lr_mult/wd_mult attributes."""
    data = s.Variable("data")
    w2 = s.Variable("w2", lr_mult=2.0, wd_mult=0.5)
    fc = s.FullyConnected(data, num_hidden=4, name="fc")
    return s.Group([fc, s.FullyConnected(data, weight=w2, num_hidden=2,
                                         no_bias=True, name="fc2")])


def _make(pkg, name, kwargs, clip):
    sched = pkg.lr_scheduler.FactorScheduler(step=2, factor=0.5)
    return pkg.optimizer.create(
        name, rescale_grad=0.5, wd=0.01, clip_gradient=clip,
        learning_rate=0.1, lr_scheduler=sched, sym=_symbol(pkg.sym),
        param_idx2name=dict(enumerate(NAMES)), **kwargs)


def _data(seed):
    rng = np.random.RandomState(seed)
    ws = [rng.uniform(-1, 1, s).astype(np.float32) for s in SHAPES]
    gs = [[rng.uniform(-3, 3, s).astype(np.float32) for s in SHAPES]
          for _ in range(STEPS)]
    return ws, gs


def _classic(pkg, name, kwargs, clip, ws, gs):
    opt = _make(pkg, name, kwargs, clip)
    upd = pkg.optimizer.get_updater(opt)
    cpu = pkg.cpu()
    weights = [pkg.nd.array(w, ctx=cpu) for w in ws]
    for step in gs:
        for i, g in enumerate(step):
            upd(i, pkg.nd.array(g, ctx=cpu), weights[i])
    return [w.asnumpy() for w in weights], opt


def _fused_jax(name, kwargs, clip, ws, gs):
    opt = _make(jmx, name, kwargs, clip)
    init, update = opt.fused_update_fn()
    ws = [jnp.asarray(w) for w in ws]
    states = [init(w) for w in ws]
    for t, step in enumerate(gs, 1):
        opt.num_update = t
        lr = opt.base_lr()
        for i, g in enumerate(step):
            g = jnp.asarray(g) * opt.rescale_grad
            if clip is not None:
                g = jnp.clip(g, -clip, clip)
            ws[i], states[i] = update(ws[i], g, states[i],
                                      jnp.float32(lr * opt._name_lr_mult(
                                          NAMES[i])),
                                      opt._name_wd(NAMES[i]), t)
    return [np.asarray(w) for w in ws]


def _fused_port(name, kwargs, clip, ws, gs):
    opt = _make(tmx, name, kwargs, clip)
    init, update = opt.fused_update_fn()
    ws = [torch.from_numpy(w.copy()) for w in ws]
    states = [init(w) for w in ws]
    lr_t = torch.zeros(())
    t_t = torch.zeros(())
    for t, step in enumerate(gs, 1):
        opt.num_update = t
        lr_t.fill_(opt.base_lr())
        t_t.add_(1)
        for i, g in enumerate(step):
            g = torch.from_numpy(g) * opt.rescale_grad
            if clip is not None:
                g = torch.clamp(g, -clip, clip)
            update(ws[i], g, states[i], lr_t * opt._name_lr_mult(NAMES[i]),
                   opt._name_wd(NAMES[i]), t_t)
    return [w.numpy() for w in ws]


@pytest.mark.parametrize("clip", [None, 1.0], ids=["noclip", "clip1"])
@pytest.mark.parametrize("name,kwargs", OPTIMIZERS, ids=IDS)
def test_classic_update_matches_jax(name, kwargs, clip):
    ws, gs = _data(7)
    want, jopt = _classic(jmx, name, kwargs, clip, ws, gs)
    got, topt = _classic(tmx, name, kwargs, clip, ws, gs)
    for n, a, b in zip(NAMES, got, want):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=n)
    assert topt.num_update == jopt.num_update
    assert topt._index_update_count == jopt._index_update_count
    assert topt.base_lr() == jopt.base_lr()


@pytest.mark.parametrize("clip", [None, 1.0], ids=["noclip", "clip1"])
@pytest.mark.parametrize("name,kwargs", OPTIMIZERS, ids=IDS)
def test_fused_update_matches_jax(name, kwargs, clip):
    ws, gs = _data(8)
    want = _fused_jax(name, kwargs, clip, ws, gs)
    got = _fused_port(name, kwargs, clip, ws, gs)
    for n, a, b in zip(NAMES, got, want):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=n)


def test_fused_and_classic_forms_agree():
    """Without clipping (the reference's Test optimizer ignores it in its
    classic form) the two forms are the same update.  Tolerance rtol
    1e-4, atol 1e-5: the classic form folds its scalar factors (Adam's
    bias correction, lr * wd) in float64 on the host, the fused form in
    float32 on the device, in both packages."""
    for name, kwargs in OPTIMIZERS:
        ws, gs = _data(9)
        classic, _ = _classic(tmx, name, kwargs, None, ws, gs)
        fused = _fused_port(name, kwargs, None, ws, gs)
        for a, b in zip(classic, fused):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5,
                                       err_msg=name)


def test_name_rules_and_registry_match_jax():
    for pkg in (jmx, tmx):
        opt = _make(pkg, "sgd", {}, None)
        assert opt.lr_mult == {"w2": 2.0} and opt.wd_mult == {"w2": 0.5}
        assert [opt._get_wd(i) for i in range(3)] == [0.01, 0.0, 0.005]
        assert [opt._name_lr_mult(n) for n in NAMES] == [1.0, 1.0, 2.0]
        assert opt.fused_hparams == ("momentum",)
    assert sorted(tmx.optimizer.Optimizer.opt_registry) == \
        sorted(jmx.optimizer.Optimizer.opt_registry)
    assert tmx.optimizer.create("sglD").fused_update_fn() is None
    with pytest.raises(ValueError):
        tmx.optimizer.create("nosuch")


def test_sgld_adds_its_own_noise_to_the_reference_step():
    """SGLD's noise comes from mx.random, not the reference's stream: the
    step is w - lr/2 (g + wd w) plus N(0, sqrt(lr)) drawn from the
    seeded host generator."""
    ws, gs = _data(10)
    opt = tmx.optimizer.create("sgld", learning_rate=0.04, wd=0.1)
    upd = tmx.optimizer.get_updater(opt)
    w = tmx.nd.array(ws[0], ctx=tmx.cpu())
    tmx.random.seed(5)
    upd(0, tmx.nd.array(gs[0][0], ctx=tmx.cpu()), w)
    tmx.random.seed(5)
    noise = tmx.random.normal(0, 0.2, shape=SHAPES[0],
                              ctx=tmx.cpu()).asnumpy()
    want = ws[0] - 0.02 * (gs[0][0] + 0.1 * ws[0]) + noise
    np.testing.assert_allclose(w.asnumpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["factor", "multifactor"])
def test_lr_schedulers_match_jax(kind):
    def make(pkg):
        if kind == "factor":
            s = pkg.lr_scheduler.FactorScheduler(step=3, factor=0.7)
        else:
            s = pkg.lr_scheduler.MultiFactorScheduler(step=[2, 5, 9],
                                                      factor=0.5)
        s.base_lr = 0.3
        return s
    a, b = make(jmx), make(tmx)
    assert [a(n) for n in range(15)] == [b(n) for n in range(15)]
    assert a.state_dict() == b.state_dict()


DETERMINISTIC = [
    ("Zero", {}, ["fc_weight", "x_bias", "odd"], (3, 4)),
    ("One", {}, ["fc_weight", "bn_gamma", "odd"], (3, 4)),
    ("Uniform", {}, ["fc_bias", "bn_gamma", "bn_beta", "bn_moving_mean",
                     "bn_moving_var", "rnn_moving_avg"], (3, 4)),
    ("Uniform", {}, ["upsampling0_weight"], (2, 2, 4, 4)),
]


@pytest.mark.parametrize("case", DETERMINISTIC,
                         ids=["zero", "one", "dispatch", "bilinear"])
def test_deterministic_initializers_equal_jax(case):
    cls, kwargs, names, shape = case
    for name in names:
        got = tmx.nd.array(np.full(shape, 7.0), ctx=tmx.cpu())
        want = jmx.nd.array(np.full(shape, 7.0))
        getattr(tmx.init, cls)(**kwargs)(name, got)
        getattr(jmx.init, cls)(**kwargs)(name, want)
        np.testing.assert_array_equal(got.asnumpy(), want.asnumpy(),
                                      err_msg=name)


def test_unknown_name_raises_in_both():
    for pkg in (jmx, tmx):
        arr = pkg.nd.zeros((2,), ctx=pkg.cpu())
        with pytest.raises(ValueError, match="Unknown initialization"):
            pkg.init.Uniform()("odd_name", arr)


def test_load_and_mixed_equal_jax():
    rng = np.random.RandomState(1)
    src = {"arg:fc_weight": rng.rand(3, 4).astype(np.float32),
           "fc_bias": rng.rand(3).astype(np.float32)}
    for pkg in (jmx, tmx):
        params = {k: pkg.nd.array(v, ctx=pkg.cpu()) for k, v in src.items()}
        init = pkg.init.Mixed(["fc_.*", ".*"],
                              [pkg.init.Load(params), pkg.init.One()])
        out = {}
        for name, shape in (("fc_weight", (3, 4)), ("fc_bias", (3,)),
                            ("other_weight", (2,))):
            arr = pkg.nd.zeros(shape, ctx=pkg.cpu())
            init(name, arr)
            out[name] = arr.asnumpy()
        if pkg is jmx:
            want = out
    for name in want:
        np.testing.assert_array_equal(out[name], want[name])
    with pytest.raises(tmx.MXNetError, match="Shape mismatch"):
        tmx.init.Load({"a_weight": tmx.nd.zeros((2,), ctx=tmx.cpu())})(
            "a_weight", tmx.nd.zeros((3,), ctx=tmx.cpu()))


def test_orthogonal_equals_jax_from_one_numpy_seed():
    for rand_type in ("uniform", "normal"):
        np.random.seed(4)
        want = jmx.nd.zeros((4, 6))
        jmx.init.Orthogonal(rand_type=rand_type)("w_weight", want)
        np.random.seed(4)
        got = tmx.nd.zeros((4, 6), ctx=tmx.cpu())
        tmx.init.Orthogonal(rand_type=rand_type)("w_weight", got)
        np.testing.assert_allclose(got.asnumpy(), want.asnumpy(),
                                   rtol=1e-6, atol=1e-7)


XAVIER = [("uniform", "avg", 3), ("gaussian", "in", 2), ("uniform", "out", 1),
          ("gaussian", "avg", 3)]


@pytest.mark.parametrize("rnd_type,factor_type,mag", XAVIER)
def test_xavier_scale_equals_jax(rnd_type, factor_type, mag):
    """Same shape and factor: the same distribution (draws differ)."""
    shape = (64, 32, 3, 3)
    fan_in, fan_out = 32 * 9, 64 * 9
    factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
              "out": fan_out}[factor_type]
    scale = np.sqrt(mag / factor)
    tmx.random.seed(3)
    jmx.random.seed(3)
    for pkg in (tmx, jmx):
        arr = pkg.nd.zeros(shape, ctx=pkg.cpu())
        pkg.init.Xavier(rnd_type, factor_type, mag)("c_weight", arr)
        a = arr.asnumpy()
        if rnd_type == "uniform":
            assert np.abs(a).max() <= scale
            np.testing.assert_allclose(a.std(), scale / np.sqrt(3),
                                       rtol=0.02)
        else:
            np.testing.assert_allclose(a.std(), scale, rtol=0.02)
        assert abs(a.mean()) < 0.02 * scale


def test_msra_prelu_matches_xavier_gaussian_scale():
    for pkg in (tmx, jmx):
        m = pkg.init.MSRAPrelu(factor_type="in", slope=0.1)
        assert (m.rnd_type, m.factor_type) == ("gaussian", "in")
        assert m.magnitude == 2.0 / (1 + 0.1 ** 2)


def test_random_streams_follow_the_seed():
    cpu = tmx.cpu()
    tmx.random.seed(42)
    a = tmx.random.uniform(-1, 2, shape=(1000,), ctx=cpu).asnumpy()
    n = tmx.random.normal(1.0, 2.0, shape=(4000,), ctx=cpu).asnumpy()
    k = tmx.random.randint(3, 9, shape=(500,), ctx=cpu).asnumpy()
    tmx.random.seed(42)
    assert np.array_equal(a, tmx.random.uniform(-1, 2, shape=(1000,),
                                                ctx=cpu).asnumpy())
    assert a.min() >= -1 and a.max() < 2 and abs(a.mean() - 0.5) < 0.1
    assert abs(n.mean() - 1.0) < 0.15 and abs(n.std() - 2.0) < 0.1
    assert k.dtype == np.int32 and k.min() >= 3 and k.max() <= 8
    out = tmx.nd.zeros((3, 2), ctx=cpu)
    assert tmx.random.uniform(out=out) is out and out.asnumpy().any()
    tmx.random.seed(7)
    x = np.random.rand()
    jmx.random.seed(7)
    assert x == np.random.rand()
