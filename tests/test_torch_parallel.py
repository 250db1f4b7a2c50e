"""The port's scale-out core (``mxnet_tpu_torch.parallel``) against the
JAX package's, on the CPU.

The JAX side runs in this process on ``tests/conftest.py``'s 8 virtual
CPU devices, one process driving them all under GSPMD / ``shard_map``.
The port runs one rank per device: its side runs in W gloo processes
(``dist.spawn.run_ranks`` with this file's ``rank_suite``), each fed the
same numpy-seeded global inputs and keeping its slice, once for W = 2
and once for W = 4 (module fixtures).  Tolerances are stated at each
check: 1e-4 max abs on params after 4 steps (the reference's own
``test_dp_train_step_dp8_matches_single`` bound) and on ``fit``'s
per-step losses, 1e-5 on pipeline and attention outputs.

The mesh helpers run in this process against the JAX package's on the
same arguments, errors matched by type and message.  This file's
top level imports neither jax nor the JAX package, so the rank
processes load it without them.
"""
import os

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import parallel as tpar
from mxnet_tpu_torch.base import MXNetError as TError
from mxnet_tpu_torch.parallel import PartitionSpec as TP

HERE = os.path.abspath(__file__)
SUITE_TIMEOUT = 150


def _jax():
    import jax
    import jax.numpy as jnp
    import mxnet_tpu as jmx
    from mxnet_tpu import parallel as jpar
    return jax, jnp, jmx, jpar


# -- inputs shared by both packages ------------------------------------------

def mlp_sym(mx):
    data = mx.sym.Variable("data")
    h = mx.sym.Activation(
        mx.sym.FullyConnected(data, num_hidden=8, name="fc1"),
        act_type="relu")
    return mx.sym.SoftmaxOutput(
        mx.sym.FullyConnected(h, num_hidden=2, name="fc2"), name="softmax")


def norm_sym(normalization):
    """The MLP with SoftmaxOutput's batch or valid normalization (labels
    of -1 ignored): gradients scaled by the global batch's counts."""
    def build(mx):
        data = mx.sym.Variable("data")
        h = mx.sym.Activation(
            mx.sym.FullyConnected(data, num_hidden=8, name="fc1"),
            act_type="relu")
        return mx.sym.SoftmaxOutput(
            mx.sym.FullyConnected(h, num_hidden=2, name="fc2"),
            name="softmax", normalization=normalization, use_ignore=True,
            ignore_label=-1)
    build.__name__ = "norm_sym_" + normalization
    return build


def kl_sym(mx):
    """IdentityAttachKLSparseReg (its rho a mean over the batch) between
    a sigmoid layer and the head."""
    data = mx.sym.Variable("data")
    h = mx.sym.Activation(mx.sym.FullyConnected(data, num_hidden=8,
                                                name="fc1"),
                          act_type="sigmoid")
    h = mx.sym.IdentityAttachKLSparseReg(h, sparseness_target=0.2,
                                         penalty=0.01, name="kl")
    return mx.sym.SoftmaxOutput(
        mx.sym.FullyConnected(h, num_hidden=2, name="fc2"), name="softmax")


def makeloss_sym(normalization):
    """MakeLoss over a square, batch or valid (elements above 0.5)
    normalization: the counts are the global batch's."""
    def build(mx):
        fc = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=2,
                                   name="fc1")
        return mx.sym.MakeLoss(mx.sym.square(fc), name="loss",
                               normalization=normalization,
                               valid_thresh=0.5)
    build.__name__ = "makeloss_sym_" + normalization
    return build


def kl_params(rng):
    return mlp_params(rng), {"kl_moving_avg": np.full(8, 0.2, np.float32)}


def makeloss_params(rng):
    return {"fc1_weight": rng.randn(2, 6).astype(np.float32) * 0.3,
            "fc1_bias": np.zeros(2, np.float32)}


def ignore_batches(rng, steps=4):
    """mlp_batches with about a third of the labels -1 (ignored)."""
    out = mlp_batches(rng, steps)
    for b in out:
        b["softmax_label"][rng.rand(16) < 0.35] = -1
    return out


def mlp_params(rng):
    return {"fc1_weight": rng.randn(8, 6).astype(np.float32) * 0.1,
            "fc1_bias": np.zeros(8, np.float32),
            "fc2_weight": rng.randn(2, 8).astype(np.float32) * 0.1,
            "fc2_bias": np.zeros(2, np.float32)}


def mlp_batches(rng, steps=4):
    out = []
    for _ in range(steps):
        X = rng.randn(16, 6).astype(np.float32)
        out.append({"data": X,
                    "softmax_label": (X.sum(axis=1) > 0).astype(np.float32)})
    return out


def bn_sym(mx):
    data = mx.sym.Variable("data")
    c = mx.sym.Convolution(data, kernel=(3, 3), num_filter=4, pad=(1, 1),
                           name="conv")
    b = mx.sym.BatchNorm(c, fix_gamma=False, name="bn")
    a = mx.sym.Activation(b, act_type="relu")
    p = mx.sym.Pooling(a, kernel=(2, 2), stride=(2, 2), pool_type="avg")
    f = mx.sym.FullyConnected(mx.sym.Flatten(p), num_hidden=3, name="fc")
    return mx.sym.SoftmaxOutput(f, name="softmax")


def bn_params(rng):
    arg = {"conv_weight": rng.randn(4, 2, 3, 3).astype(np.float32) * 0.3,
           "conv_bias": rng.randn(4).astype(np.float32) * 0.5,
           "bn_gamma": np.ones(4, np.float32),
           "bn_beta": np.zeros(4, np.float32),
           "fc_weight": rng.randn(3, 36).astype(np.float32) * 0.2,
           "fc_bias": np.zeros(3, np.float32)}
    aux = {"bn_moving_mean": np.zeros(4, np.float32),
           "bn_moving_var": np.ones(4, np.float32)}
    return arg, aux


def bn_batches(rng, steps=4):
    # shifted, scaled data: per-rank statistics would differ widely from
    # the global batch's
    return [{"data": (rng.randn(16, 2, 6, 6) * 2 + 1).astype(np.float32),
             "softmax_label": rng.randint(0, 3, 16).astype(np.float32)}
            for _ in range(steps)]


def stage_fn_torch(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def pipe_inputs(S, seed=0, M=8, B=2, D=8):
    rng = np.random.RandomState(seed)
    return ({"w": (rng.randn(S, D, D) * 0.3).astype(np.float32),
             "b": (rng.randn(S, D) * 0.1).astype(np.float32)},
            rng.randn(M, B, D).astype(np.float32))


def gpipe_inputs(S, seed=1, M=4, B=8, D=8):
    rng = np.random.RandomState(seed)
    stages = {"w": (rng.randn(S, D, D) * 0.3).astype(np.float32),
              "b": np.zeros((S, D), np.float32)}
    tail = {"w": (rng.randn(D, 1) * 0.3).astype(np.float32)}
    X = rng.randn(B * M, D).astype(np.float32)
    return stages, tail, X, (X.sum(axis=1) > 0).astype(np.float32)


def gpipe_loss_torch(tail, h, labels):
    return ((h @ tail["w"])[:, 0] - labels).pow(2).mean()


def attn_inputs(seed=0, B=2, T=32, H=4, D=8):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, T, H, D).astype(np.float32) for _ in range(3)]


FIT_STEPS = 4


def fit_inputs():
    rng = np.random.RandomState(7)
    arg, aux = bn_params(rng)
    X = (rng.randn(16 * FIT_STEPS, 2, 6, 6) * 2 + 1).astype(np.float32)
    y = rng.randint(0, 3, 16 * FIT_STEPS).astype(np.float32)
    return arg, aux, X, y


def run_fit(mx, mesh, arg, aux, X, y, ctx, **kw):
    """Module.fit over ``mesh`` with per-step losses recorded (from the
    running cross-entropy) and the final params."""
    losses, cum = [], []

    def record(param):
        cum.append(float(param.eval_metric.get()[1]))
        k = len(cum)
        losses.append(k * cum[-1] - (k - 1) * (cum[-2] if k > 1 else 0.0))
    it = mx.io.NDArrayIter(X, y, batch_size=16)
    mod = mx.mod.Module(bn_sym(mx), context=ctx)
    mod.fit(it, num_epoch=1, mesh=mesh, eval_metric="ce",
            arg_params={k: mx.nd.array(v) for k, v in arg.items()},
            aux_params={k: mx.nd.array(v) for k, v in aux.items()},
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            batch_end_callback=record, **kw)
    a, x = mod.get_params()
    params = {k: v.asnumpy() for k, v in list(a.items()) + list(x.items())}
    return losses, params, cum[-1]


# -- the port's side, on each rank -------------------------------------------

def _dp_port(sym_fn, params_fn, batches_fn, W, shard=False, remat=False,
             compute_dtype=None):
    if shard:
        os.environ["MXNET_SHARD_WEIGHT_UPDATE"] = "1"
    try:
        rng = np.random.RandomState(3)
        p = params_fn(rng)
        arg, aux = p if isinstance(p, tuple) else (p, {})
        step = tpar.DPTrainStep(sym_fn(tmx), tpar.make_mesh([("dp", W)]),
                                learning_rate=0.5, momentum=0.9,
                                weight_decay=1e-3, ctx=tmx.cpu(),
                                remat=remat, compute_dtype=compute_dtype)
    finally:
        os.environ.pop("MXNET_SHARD_WEIGHT_UPDATE", None)
    state = step.init(arg, aux)
    outs = None
    for b in batches_fn(rng):
        state, outs = step(state, step.shard_batch(b))
    res = step.params_numpy(state)
    res.update({k: v.cpu().numpy() for k, v in state["aux"].items()})
    return res, outs[0].numpy()


def rank_suite(W):
    """Every port-side result at world size W, on this rank."""
    out = {}
    with tmx.cpu():
        out["dp_mlp"] = _dp_port(mlp_sym, mlp_params, mlp_batches, W)
        out["dp_mlp_shard"] = _dp_port(mlp_sym, mlp_params, mlp_batches, W,
                                       shard=True)
        out["dp_mlp_remat"] = _dp_port(mlp_sym, mlp_params, mlp_batches, W,
                                       remat=True)
        out["dp_bn"] = _dp_port(bn_sym, bn_params, bn_batches, W)
        out["dp_bf16"] = _dp_port(mlp_sym, mlp_params, mlp_batches, W,
                                  compute_dtype="bfloat16")
        for norm in ("batch", "valid"):
            out["dp_norm", norm] = _dp_port(norm_sym(norm), mlp_params,
                                            ignore_batches, W)
            out["dp_makeloss", norm] = _dp_port(
                makeloss_sym(norm), makeloss_params, mlp_batches, W)
        out["dp_kl"] = _dp_port(kl_sym, kl_params, mlp_batches, W)
        out["dp_bn_shard"] = _dp_port(bn_sym, bn_params, bn_batches, W,
                                      shard=True)
        params, micros = pipe_inputs(W)
        out["pipe"] = tpar.pipeline_apply(
            stage_fn_torch, tpar.make_mesh([("pp", W)]),
            {k: torch.tensor(v) for k, v in params.items()},
            torch.tensor(micros)).numpy()
        stages, tail, X, y = gpipe_inputs(W)
        step = tpar.GPipeTrainStep(stage_fn_torch, gpipe_loss_torch,
                                   tpar.make_mesh([("pp", W)]), num_micro=4,
                                   learning_rate=0.1, ctx=tmx.cpu())
        st = step.init(stages, tail)
        loss, grads = step.loss_and_grads(st, X, y)
        out["gpipe_grads"] = (float(loss), step.stacked(grads["stages"]),
                              grads["tail"]["w"].numpy())
        losses = []
        for _ in range(8):
            st, loss = step(st, X, y)
            losses.append(float(loss))
        out["gpipe_losses"] = losses
        mesh = tpar.make_mesh([("sp", W)])
        q, k, v = (torch.tensor(a) for a in attn_inputs())
        for impl in ("ring", "ulysses"):
            for causal in (False, True):
                fn = tpar.make_ring_attention(mesh, causal=causal, impl=impl)
                out["attn", impl, causal] = fn(q, k, v).numpy()
        # the gradient of a long sequence: this rank's shards
        ax = mesh.axis("sp")
        q, k, v = (torch.tensor(a) for a in attn_inputs(1, B=1, T=128 * W))
        w = torch.tensor(np.random.RandomState(5).randn(*q.shape)
                         .astype(np.float32))
        tl = q.shape[1] // W
        sl = slice(ax.index * tl, (ax.index + 1) * tl)
        for impl in ("ring", "ulysses"):
            leaves = [x[:, sl].clone().requires_grad_(True)
                      for x in (q, k, v)]
            fn = tpar.ring_attention if impl == "ring" \
                else tpar.ulysses_attention
            o = fn(*leaves, ax, causal=True)
            (o * w[:, sl]).sum().backward()
            out["attn_grad", impl] = [
                tpar.collectives.all_gather(x.grad, ax, dim=1).numpy()
                for x in leaves]
        if W == 2:
            out["fit_mesh"] = run_fit(tmx, tpar.make_mesh("dp=2"),
                                      *fit_inputs(), ctx=tmx.cpu())
            out["fit_mesh_superstep"] = run_fit(
                tmx, tpar.make_mesh("dp=2"), *fit_inputs(), ctx=tmx.cpu(),
                superstep=2)
    return out


@pytest.fixture(scope="module")
def port2():
    from mxnet_tpu_torch.dist.spawn import run_ranks
    return run_ranks(HERE + ":rank_suite", 2, args=(2,),
                     timeout=SUITE_TIMEOUT)


@pytest.fixture(scope="module")
def port4():
    from mxnet_tpu_torch.dist.spawn import run_ranks
    return run_ranks(HERE + ":rank_suite", 4, args=(4,),
                     timeout=SUITE_TIMEOUT)


@pytest.fixture
def port(request, port2, port4):
    return {2: port2, 4: port4}[request.param]


# -- the JAX package's side ---------------------------------------------------

_JAX_CACHE = {}


def _dp_jax(sym_fn, params_fn, batches_fn, dp, compute_dtype=None):
    key = (sym_fn.__name__, batches_fn.__name__, dp, compute_dtype)
    if key in _JAX_CACHE:
        return _JAX_CACHE[key]
    jax, jnp, jmx, jpar = _jax()
    rng = np.random.RandomState(3)
    p = params_fn(rng)
    arg, aux = p if isinstance(p, tuple) else (p, {})
    mesh = jpar.make_mesh([("dp", dp)], devices=jax.devices()[:dp])
    step = jpar.DPTrainStep(sym_fn(jmx), mesh, learning_rate=0.5,
                            momentum=0.9, weight_decay=1e-3,
                            compute_dtype=compute_dtype and
                            getattr(jnp, compute_dtype))
    state = step.init(arg, aux)
    key0 = jax.random.PRNGKey(0)
    outs = None
    for b in batches_fn(rng):
        state, outs = step(state, step.shard_batch(b), rng=key0)
    res = {k: np.asarray(v) for k, v in state["params"].items()}
    res.update({k: np.asarray(v) for k, v in state["aux"].items()})
    _JAX_CACHE[key] = (res, np.asarray(outs[0]))
    return _JAX_CACHE[key]


def _close(a, b, tol, what):
    assert set(a) == set(b), (sorted(a), sorted(b))
    for k in a:
        err = float(np.abs(np.asarray(a[k]) - np.asarray(b[k])).max())
        assert err < tol, (what, k, err)


# -- mesh helpers --------------------------------------------------------------

R8 = list(range(8))


def _mesh_case(pkg, case, monkeypatch):
    """One mesh-helper case on one package; -> a comparable value or
    the (type name, message) of what it raised."""
    par = pkg["par"]
    dev = pkg["devices"]
    P = par.PartitionSpec
    try:
        if case == "axes":
            m = par.make_mesh([("dp", 4), ("tp", 2)], devices=dev)
            return dict(m.shape), tuple(m.devices.shape)
        if case == "absorb":
            return dict(par.make_mesh([("dp", -1), ("tp", 2)],
                                      devices=dev).shape)
        if case == "too_many":
            par.make_mesh([("dp", 16)], devices=dev)
        if case == "two_absorb":
            par.make_mesh([("dp", -1), ("tp", -1)], devices=dev)
        if case == "zero":
            par.make_mesh("dp=0", devices=dev)
        if case == "negative":
            par.make_mesh([("dp", -2)], devices=dev)
        if case == "string":
            return dict(par.make_mesh("dp=2,tp=2", devices=dev).shape)
        if case == "parse":
            return (par.parse_mesh_spec("dp=4,tp=2"),
                    par.parse_mesh_spec("dp=-1"))
        if case == "parse_bad":
            par.parse_mesh_spec("dp:4")
        if case == "parse_empty":
            par.parse_mesh_spec("")
        if case == "env":
            monkeypatch.setenv("MXNET_MESH", "dp=8")
            got = dict(par.mesh_from_env(devices=dev).shape)
            monkeypatch.setenv("MXNET_MESH", "")
            return got, par.mesh_from_env(devices=dev)
        if case == "normalize":
            return (tuple(par.normalize_spec(None)),
                    tuple(par.normalize_spec(P("dp", None))),
                    tuple(par.normalize_spec("None,tp")),
                    tuple(par.normalize_spec(("tp", None))))
        if case == "normalize_bad":
            par.normalize_spec(3.14)
        if case == "attrs":
            mx = pkg["mx"]
            w = mx.sym.Variable("fc_weight", attr={"__sharding__": "None,tp"})
            net = mx.sym.FullyConnected(mx.sym.Variable("data"), weight=w,
                                        num_hidden=8, name="fc")
            return tuple(par.sharding_attrs(net)["fc_weight"])
        if case == "dp_sharding":
            m = par.make_mesh([("dp", 8)], devices=dev)
            return tuple(par.dp_sharding(m).spec), \
                tuple(par.replicated(m).spec)
        if case == "product":
            m = par.make_mesh([("dp", 4), ("tp", 2)], devices=dev)
            par.validate_spec("w", P(("dp", "tp")), m, shape=(16,))
            par.validate_spec("w", P(("dp", "tp")), m, shape=(12,))
        if case == "overlong":
            m = par.make_mesh([("tp", 2)], devices=dev)
            par.validate_spec("b", P("tp", None), m, shape=(8,))
        if case == "unknown_axis":
            m = par.make_mesh([("tp", 2)], devices=dev)
            par.validate_spec("b", P("dp"), m, shape=(8,))
        if case == "mesh_axes":
            from importlib import import_module
            mod = import_module(par.__name__ + ".mesh")
            return mod.mesh_axes(par.make_mesh([("dp", 4), ("tp", 2)],
                                               devices=dev))
        return "no result"
    except (ValueError, pkg["error"]) as e:
        kind = "MXNetError" if isinstance(e, pkg["error"]) else \
            type(e).__name__
        return kind, str(e)


MESH_CASES = ["axes", "absorb", "too_many", "two_absorb", "zero", "negative",
              "string", "parse", "parse_bad", "parse_empty", "env",
              "normalize", "normalize_bad", "attrs", "dp_sharding",
              "product", "overlong", "unknown_axis", "mesh_axes"]


@pytest.mark.parametrize("case", MESH_CASES)
def test_mesh_helpers_match_reference(case, monkeypatch):
    """The port's mesh helpers give the JAX package's results and raise
    its errors, type and message (a mesh of 8 ranks against 8 devices;
    the messages name sizes, never devices)."""
    jax, _jnp, jmx, jpar = _jax()
    from mxnet_tpu.base import MXNetError as JError
    ref = _mesh_case({"par": jpar, "devices": jax.devices(), "mx": jmx,
                      "error": JError}, case, monkeypatch)
    got = _mesh_case({"par": tpar, "devices": R8, "mx": tmx,
                      "error": TError}, case, monkeypatch)
    assert got == ref, (case, got, ref)


def test_mesh_default_is_the_group():
    """Without ``devices`` a mesh lays out the ranks of the group: one
    in a process that never joined one, which builds no group."""
    import torch.distributed as dist
    before = dist.is_initialized()
    m = tpar.make_mesh("dp=-1")
    assert dict(m.shape) == {"dp": 1}
    assert m.devices.tolist() == [0]
    assert dist.is_initialized() == before
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        tpar.make_mesh("dp=2")


# -- DPTrainStep ---------------------------------------------------------------

@pytest.mark.parametrize("port", [2, 4], indirect=True)
def test_dp_train_step_matches_reference(port):
    """MLP, 4 steps: dp=W in the port equals the JAX package's dp=8 and
    dp=1 (params, max abs 1e-4), every rank the same; the outputs of the
    last step are the global batch's."""
    r8, o8 = _dp_jax(mlp_sym, mlp_params, mlp_batches, 8)
    r1, _ = _dp_jax(mlp_sym, mlp_params, mlp_batches, 1)
    for rank in port:
        got, outs = rank["dp_mlp"]
        _close(got, r8, 1e-4, "dp vs jax dp8")
        _close(got, r1, 1e-4, "dp vs jax dp1")
        assert outs.shape == o8.shape == (16, 2)
        assert np.abs(outs - o8).max() < 1e-4


@pytest.mark.parametrize("port", [2, 4], indirect=True)
def test_dp_train_step_batchnorm_global_statistics(port):
    """Conv + BatchNorm, 4 steps: the port's dp=W equals the JAX
    package's dp=8, params AND moving statistics (max abs 1e-4), because
    BatchNorm normalizes with the global batch's statistics; per-rank
    statistics (a plain F.batch_norm on each slice) miss by far more."""
    ref, _ = _dp_jax(bn_sym, bn_params, bn_batches, 8)
    for rank in port:
        got, _ = rank["dp_bn"]
        _close(got, ref, 1e-4, "bn dp vs jax dp8")
    assert "bn_moving_var" in ref and \
        np.abs(ref["bn_moving_var"] - 1).max() > 0.1


@pytest.mark.parametrize("port", [2, 4], indirect=True)
@pytest.mark.parametrize("net", ["mlp", "bn"])
def test_dp_sharded_weight_update_matches_reference(port, net):
    """MXNET_SHARD_WEIGHT_UPDATE=1 (reduce-scatter, update this rank's
    rows, all-gather) gives the replicated update's params: the JAX
    package's dp=8 within 1e-4."""
    fns = {"mlp": (mlp_sym, mlp_params, mlp_batches),
           "bn": (bn_sym, bn_params, bn_batches)}[net]
    ref, _ = _dp_jax(*fns, 8)
    for rank in port:
        got, _ = rank["dp_%s_shard" % net]
        _close(got, ref, 1e-4, "shard %s" % net)


@pytest.mark.parametrize("port", [2, 4], indirect=True)
@pytest.mark.parametrize("norm", ["batch", "valid"])
def test_dp_loss_normalization_over_the_global_batch(port, norm):
    """SoftmaxOutput's batch and valid normalizations (a third of the
    labels ignored) and MakeLoss's divide by the global batch's counts
    over dp: the JAX package's dp=8 within 1e-4."""
    ref, _ = _dp_jax(norm_sym(norm), mlp_params, ignore_batches, 8)
    for rank in port:
        _close(rank["dp_norm", norm][0], ref, 1e-4, "normalization " + norm)
    ref, _ = _dp_jax(makeloss_sym(norm), makeloss_params, mlp_batches, 8)
    for rank in port:
        _close(rank["dp_makeloss", norm][0], ref, 1e-4, "MakeLoss " + norm)


@pytest.mark.parametrize("port", [2, 4], indirect=True)
def test_dp_kl_sparse_reg_over_the_global_batch(port):
    """IdentityAttachKLSparseReg's rho is the global batch's mean over
    dp: params and moving_avg equal the JAX package's dp=8 (1e-4)."""
    ref, _ = _dp_jax(kl_sym, kl_params, mlp_batches, 8)
    for rank in port:
        _close(rank["dp_kl"][0], ref, 1e-4, "kl")


@pytest.mark.parametrize("port", [2, 4], indirect=True)
def test_dp_bfloat16_compute_matches_reference(port):
    """compute_dtype bfloat16 (float32 master params and momentum, labels
    uncast) against the JAX package's bfloat16 dp=8 after 4 steps at lr
    0.5: within 5e-3 max abs, three times the JAX package's own bfloat16
    run's distance from its float32 run (1.7e-3: bfloat16 keeps 8 bits
    of mantissa, and the two packages round the products' sums at other
    points); and the port's bfloat16 run is not its float32 run."""
    ref, _ = _dp_jax(mlp_sym, mlp_params, mlp_batches, 8, "bfloat16")
    for rank in port:
        got = rank["dp_bf16"][0]
        assert all(v.dtype == np.float32 for v in got.values())
        _close(got, ref, 5e-3, "bf16")
        f32 = rank["dp_mlp"][0]
        assert max(float(np.abs(got[k] - f32[k]).max()) for k in f32) > 1e-4


@pytest.mark.parametrize("port", [2, 4], indirect=True)
def test_dp_remat_equals_plain(port):
    """remat=True (the whole loss recomputed in the backward) gives the
    plain step's params (1e-6)."""
    for rank in port:
        _close(rank["dp_mlp_remat"][0], rank["dp_mlp"][0], 1e-6, "remat")


def test_dp_param_specs_over_other_axes_refused():
    mesh = tpar.make_mesh([("dp", 1)])
    with pytest.raises(NotImplementedError, match="item 10b"):
        tpar.DPTrainStep(mlp_sym(tmx), mesh, ctx=tmx.cpu(),
                         param_specs={"fc1_weight": TP("tp", None)})


# -- pipeline -------------------------------------------------------------------

@pytest.mark.parametrize("port", [2, 4], indirect=True)
def test_pipeline_apply_matches_reference(port):
    """pp=W stages, M=8 microbatches: the JAX package's pipeline_apply on
    a pp=W mesh of the virtual devices (max abs 1e-5)."""
    jax, jnp, _jmx, jpar = _jax()
    W = len(port)
    params, micros = pipe_inputs(W)
    mesh = jpar.make_mesh([("pp", W)], devices=jax.devices()[:W])

    def stage(p, x):
        return jnp.tanh(x @ p["w"] + p["b"])
    ref = np.asarray(jpar.pipeline_apply(
        stage, mesh, {k: jnp.asarray(v) for k, v in params.items()},
        jnp.asarray(micros)))
    for rank in port:
        assert rank["pipe"].shape == ref.shape
        assert np.abs(rank["pipe"] - ref).max() < 1e-5


@pytest.mark.parametrize("port", [2, 4], indirect=True)
def test_gpipe_gradients_match_sequential(port):
    """GPipeTrainStep's loss and gradients (stage grads all-gathered to
    the stacked form, the tail's) equal one process's autograd through
    the S stages in sequence (max abs 1e-5); 8 steps lower the loss."""
    W = len(port)
    stages, tail, X, y = gpipe_inputs(W)
    w = torch.tensor(stages["w"], requires_grad=True)
    b = torch.tensor(stages["b"], requires_grad=True)
    tw = torch.tensor(tail["w"], requires_grad=True)
    h = torch.tensor(X)
    for s in range(W):
        h = stage_fn_torch({"w": w[s], "b": b[s]}, h)
    loss = gpipe_loss_torch({"w": tw}, h, torch.tensor(y))
    loss.backward()
    for rank in port:
        got_loss, g_stages, g_tail = rank["gpipe_grads"]
        assert abs(got_loss - float(loss.detach())) < 1e-5
        assert np.abs(g_stages["w"] - w.grad.numpy()).max() < 1e-5
        assert np.abs(g_stages["b"] - b.grad.numpy()).max() < 1e-5
        assert np.abs(g_tail - tw.grad.numpy()).max() < 1e-5
        losses = rank["gpipe_losses"]
        assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_pipeline_errors_match_reference():
    """A stacked leading dim that is not the stage count, and a batch
    the microbatches do not divide, raise ValueError as the JAX
    package's do."""
    mesh = tpar.make_mesh([("pp", 4)], devices=range(4))
    with pytest.raises(ValueError, match="pipeline stages 4"):
        tpar.pipeline_apply(stage_fn_torch, mesh,
                            {"w": torch.zeros(3, 4, 4),
                             "b": torch.zeros(3, 4)}, torch.zeros(8, 2, 4))
    step = tpar.GPipeTrainStep(stage_fn_torch, lambda t, h, l: h.sum(),
                               mesh, num_micro=4, ctx=tmx.cpu())
    with pytest.raises(ValueError, match="divisible by num_micro=4"):
        step(None, np.zeros((6, 8), np.float32), np.zeros(6, np.float32))


# -- ring / Ulysses attention -----------------------------------------------------

@pytest.mark.parametrize("port", [2, 4], indirect=True)
@pytest.mark.parametrize("impl", ["ring", "ulysses"])
@pytest.mark.parametrize("causal", [False, True])
def test_sequence_parallel_attention_matches_reference(port, impl, causal):
    """sp=W: the port's make_ring_attention over global (B, T, H, D)
    equals the JAX package's on an sp=W mesh of the virtual devices
    (float32, max abs 1e-5) on every rank."""
    jax, jnp, _jmx, jpar = _jax()
    from mxnet_tpu.parallel.ring import make_ring_attention
    W = len(port)
    mesh = jpar.make_mesh([("sp", W)], devices=jax.devices()[:W])
    q, k, v = (jnp.asarray(a) for a in attn_inputs())
    ref = np.asarray(make_ring_attention(mesh, causal=causal,
                                         impl=impl)(q, k, v))
    for rank in port:
        got = rank["attn", impl, causal]
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() < 1e-5


@pytest.mark.parametrize("port", [2, 4], indirect=True)
@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_sequence_parallel_attention_gradient(port, impl):
    """The gradient of a long causal sequence (T = 128 W) through ring
    and Ulysses attention equals attention_reference's autograd on one
    process (max abs 1e-5)."""
    W = len(port)
    q, k, v = (torch.tensor(a).requires_grad_(True)
               for a in attn_inputs(1, B=1, T=128 * W))
    w = torch.tensor(np.random.RandomState(5).randn(*q.shape)
                     .astype(np.float32))
    (tpar.attention_reference(q, k, v, causal=True) * w).sum().backward()
    for rank in port:
        for got, ref in zip(rank["attn_grad", impl], (q, k, v)):
            assert np.abs(got - ref.grad.numpy()).max() < 1e-5


def test_ulysses_needs_divisible_heads():
    class _Axis:
        size, index = 3, 0
    x = torch.zeros(1, 4, 4, 2)
    with pytest.raises(ValueError, match="divisible"):
        tpar.ulysses_attention(x, x, x, _Axis())


# -- Module.fit(mesh=) ----------------------------------------------------------

def test_fit_mesh_dp2_matches_reference(port2):
    """Module.fit(mesh=make_mesh("dp=2")) on two ranks, each fed the
    global batches, equals the JAX package's fit(mesh=dp=2) on the
    virtual mesh: per-step losses and the final params and moving
    statistics within 1e-4 (the two-process gate of the reference's
    test_dist_mesh.py, held here against its single-process side)."""
    jax, _jnp, jmx, jpar = _jax()
    arg, aux, X, y = fit_inputs()
    ref_losses, ref_params, _ = run_fit(jmx, jpar.make_mesh("dp=2"), arg,
                                        aux, X, y, jmx.cpu())
    assert len(ref_losses) == FIT_STEPS
    for rank in port2:
        losses, params, _ = rank["fit_mesh"]
        assert np.abs(np.array(losses) - np.array(ref_losses)).max() < 1e-4
        _close(params, ref_params, 1e-4, "fit mesh")


def test_fit_mesh_superstep_equals_single_steps(port2):
    """fit(mesh=dp=2, superstep=2): two steps a drain over megabatches
    of which each rank keeps its rows, the metric reduced on the device
    over the gathered outputs and labels: the params and the epoch's
    cross-entropy of the one-step fit (1e-6)."""
    for rank in port2:
        _, params, ce = rank["fit_mesh"]
        s_losses, s_params, s_ce = rank["fit_mesh_superstep"]
        assert len(s_losses) == FIT_STEPS // 2
        _close(s_params, params, 1e-6, "superstep")
        assert abs(s_ce - ce) < 1e-6
