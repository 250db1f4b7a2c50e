"""Model state sharded over a mesh in the port (``fit(mesh=, sharding=)``,
``Executor.set_mesh``, ``ServeEngine(mesh=, param_specs=)``, multi-process
checkpoints) against the JAX package's ``tests/test_multichip.py``, on
the CPU.

The JAX side runs in this process on ``tests/conftest.py``'s 8 virtual
CPU devices under GSPMD.  The port runs one rank per device: its side
runs in W gloo processes (``dist.spawn.run_ranks`` with this file's
``rank_suite``), each fed the same numpy-seeded global batches and
holding only its shards, once for W = 2 (``dp=1,tp=2``) and once for
W = 4 (``dp=2,tp=2``).  Both packages start from the same numpy
parameters.  Tolerances are the reference tests' own: 1e-4 max abs on
params after 2 epochs (8 steps), 1e-5 on served outputs.

This file's top level imports neither jax nor the JAX package, so the
rank processes load it without them (``test_torch_moe.py`` and
``test_torch_checkpoint.py`` spawn their multi-rank cases from here).
"""
import os

import numpy as np
import pytest

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError as TError
from mxnet_tpu_torch.analysis.pytest_plugin import (  # noqa: E402,F401
    _mxnet_analysis_guard)  # the port's leak guard and lock recorder

HERE = os.path.abspath(__file__)
SUITE_TIMEOUT = 180
OPT = {"learning_rate": 0.5, "momentum": 0.9}
TOL = 1e-4
SERVE_TOL = 1e-5
SERVE_SHAPES = {"data": (1, 6), "softmax_label": (1,)}
TP_SPECS = {"fc1_weight": ("tp", None), "fc1_bias": ("tp",)}


# -- inputs shared by both packages ------------------------------------------

def mlp(mx, attr=False):
    data = mx.sym.Variable("data")
    w = mx.sym.Variable("fc1_weight", attr={"__sharding__": "tp,None"}) \
        if attr else None
    fc1 = mx.sym.FullyConnected(data, weight=w, num_hidden=8, name="fc1") \
        if attr else mx.sym.FullyConnected(data, num_hidden=8, name="fc1")
    h = mx.sym.Activation(fc1, act_type="relu")
    return mx.sym.SoftmaxOutput(
        mx.sym.FullyConnected(h, num_hidden=2, name="fc2"), name="softmax")


def params0():
    rng = np.random.RandomState(5)
    return {"fc1_weight": (rng.randn(8, 6) * 0.3).astype(np.float32),
            "fc1_bias": (rng.randn(8) * 0.1).astype(np.float32),
            "fc2_weight": (rng.randn(2, 8) * 0.3).astype(np.float32),
            "fc2_bias": np.zeros(2, np.float32)}


def data(mx, batch_size=16):
    rng = np.random.RandomState(0)
    X = rng.randn(64, 6).astype(np.float32)
    y = (X.sum(axis=1) > 0).astype(np.float32)
    return mx.io.NDArrayIter(X, y, batch_size=batch_size)


def nobias_fit(mx, P, mesh=None, specs=None):
    """The MLP with fc2 without a bias: cut on its inputs, its output is
    a partial sum that the SoftmaxOutput's entry sums."""
    data_ = mx.sym.Variable("data")
    h = mx.sym.Activation(mx.sym.FullyConnected(data_, num_hidden=8,
                                                name="fc1"),
                          act_type="relu")
    net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
        h, num_hidden=2, no_bias=True, name="fc2"), name="softmax")
    ctx = mx.cpu(0)
    arg = {k: v for k, v in params0().items() if k != "fc2_bias"}
    mod = mx.mod.Module(net, context=ctx)
    mod.fit(data(mx), num_epoch=2, optimizer_params=dict(OPT), mesh=mesh,
            sharding=specs_of(P, specs),
            arg_params={k: mx.nd.array(v, ctx=ctx) for k, v in arg.items()})
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def conv_net(mx):
    """Convolution -> relu -> Pooling -> Flatten -> Reshape -> FC: with
    the filters cut and the FC row-parallel, the cut rides through every
    op to the FC's partial sums."""
    data = mx.sym.Variable("data")
    c = mx.sym.Convolution(data, kernel=(3, 3), num_filter=4, pad=(1, 1),
                           name="conv")
    p = mx.sym.Pooling(mx.sym.Activation(c, act_type="relu"),
                       kernel=(2, 2), stride=(2, 2), pool_type="max")
    f = mx.sym.Reshape(mx.sym.Flatten(p), shape=(0, -1))
    return mx.sym.SoftmaxOutput(
        mx.sym.FullyConnected(f, num_hidden=2, name="fc"), name="softmax")


CONV_SPECS = {"conv_weight": ("tp", None, None, None), "conv_bias": ("tp",),
              "fc_weight": (None, "tp")}


def conv_fit(mx, P, mesh=None, specs=None):
    rng = np.random.RandomState(8)
    arg = {"conv_weight": (rng.randn(4, 2, 3, 3) * 0.3).astype(np.float32),
           "conv_bias": (rng.randn(4) * 0.1).astype(np.float32),
           "fc_weight": (rng.randn(2, 36) * 0.3).astype(np.float32),
           "fc_bias": np.zeros(2, np.float32)}
    X = rng.randn(32, 2, 6, 6).astype(np.float32)
    y = rng.randint(0, 2, 32).astype(np.float32)
    ctx = mx.cpu(0)
    mod = mx.mod.Module(conv_net(mx), context=ctx)
    mod.fit(mx.io.NDArrayIter(X, y, batch_size=16), num_epoch=2,
            optimizer_params=dict(OPT), mesh=mesh,
            sharding=specs_of(P, specs),
            arg_params={k: mx.nd.array(v, ctx=ctx) for k, v in arg.items()})
    return mod, {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def dropout_fit(mesh=None, specs=None):
    """The MLP with Dropout(0.5) after fc1's relu, in the port (the two
    packages draw other random streams)."""
    from mxnet_tpu_torch.parallel import PartitionSpec
    h = tmx.sym.Dropout(tmx.sym.Activation(tmx.sym.FullyConnected(
        tmx.sym.Variable("data"), num_hidden=8, name="fc1"),
        act_type="relu"), p=0.5)
    net = tmx.sym.SoftmaxOutput(tmx.sym.FullyConnected(
        h, num_hidden=2, name="fc2"), name="softmax")
    with tmx.cpu():
        tmx.random.seed(3)
        mod = tmx.mod.Module(net, context=tmx.cpu(0))
        mod.fit(data(tmx), num_epoch=2, optimizer_params=dict(OPT),
                mesh=mesh, sharding=specs_of(PartitionSpec, specs),
                arg_params={k: tmx.nd.array(v, ctx=tmx.cpu())
                            for k, v in params0().items()})
        return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def int8_row(mesh=None):
    """``_fused_FullyConnected`` with relu and the int8 epilogue, its
    weight cut on dim 1 (row-parallel: codes from the summed product);
    -> the int8 codes of one forward."""
    from mxnet_tpu_torch.parallel import PartitionSpec
    sym = tmx.sym._fused_FullyConnected(tmx.sym.Variable("data"),
                                        num_hidden=16, act_type="relu",
                                        out_scale=0.02, name="f")
    rng = np.random.RandomState(12)
    ex = sym.simple_bind(tmx.cpu(), grad_req="null", data=(8, 24))
    ex.copy_params_from({
        "f_weight": tmx.nd.array(rng.randn(16, 24).astype(np.float32)
                                 * 0.2, ctx=tmx.cpu()),
        "f_bias": tmx.nd.array(rng.randn(16).astype(np.float32) * 0.1,
                               ctx=tmx.cpu())})
    if mesh is not None:
        ex.set_mesh(mesh, param_specs={"f_weight": PartitionSpec(None,
                                                                 "tp")})
    x = rng.randn(8, 24).astype(np.float32)
    return ex.forward(data=tmx.nd.array(x, ctx=tmx.cpu()))[0].asnumpy()


def serve_inputs(n=10, seed=1):
    return np.random.RandomState(seed).randn(n, 6).astype(np.float32)


def specs_of(P, specs):
    return None if specs is None else {k: P(*v) for k, v in specs.items()}


def fit(mx, P, mesh=None, specs=None, num_epoch=2, attr=False, **kw):
    """Module.fit of the MLP from params0; -> the module and its host
    params."""
    ctx = mx.cpu(0)
    mod = mx.mod.Module(mlp(mx, attr), context=ctx)
    mod.fit(data(mx), num_epoch=num_epoch, optimizer_params=dict(OPT),
            mesh=mesh, sharding=specs_of(P, specs),
            arg_params={k: mx.nd.array(v, ctx=ctx)
                        for k, v in params0().items()}, **kw)
    return mod, {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


# -- the port's side, on each rank ---------------------------------------------

def _port_fit(mesh, specs=None, shard_update=False, **kw):
    from mxnet_tpu_torch.parallel import PartitionSpec
    if shard_update:
        os.environ["MXNET_SHARD_WEIGHT_UPDATE"] = "1"
    try:
        with tmx.cpu():
            return fit(tmx, PartitionSpec, mesh, specs, **kw)
    finally:
        os.environ.pop("MXNET_SHARD_WEIGHT_UPDATE", None)


def _shapes(mod, group="params"):
    from mxnet_tpu_torch.checkpoint.snapshot import map_structure
    return {k: map_structure(lambda t: tuple(t.shape), v)
            for k, v in mod._fused.state[group].items()}


def _serve_rank(prefix, mesh, specs, fuse):
    """Every rank builds the engine; rank 0 serves and reports."""
    from mxnet_tpu_torch.dist import boot
    from mxnet_tpu_torch.parallel import PartitionSpec
    out = {}
    xs = serve_inputs()
    with tmx.serve.ServeEngine.from_checkpoint(
            prefix, 0, input_shapes=SERVE_SHAPES, batch_buckets=(1, 2, 4),
            mesh=mesh, param_specs=specs_of(PartitionSpec, specs),
            dev_type="cpu", fuse=fuse, name="serve_mesh") as eng:
        out["w"] = eng._predictor._exec.arg_dict["fc1_weight"].shape
        if boot.rank() == 0:
            out["one"] = [eng.predict(x) for x in xs]
            out["many"] = [f.result(timeout=30)
                           for f in eng.submit_many(xs)]
        else:
            try:
                eng.predict(xs[0])
            except tmx.serve.ServeError as e:
                out["follower"] = str(e)
        out["version"] = eng.reload_from_checkpoint(prefix, 0)
        out["w2"] = eng._predictor._exec.arg_dict["fc1_weight"].shape
        if boot.rank() == 0:
            out["reloaded"] = [eng.predict(x) for x in xs]
    return out


def rank_suite(W, tmp):
    """Every port-side result at world size W (dp = W/2, tp = 2)."""
    from mxnet_tpu_torch.parallel import collectives as C
    from mxnet_tpu_torch.dist import boot
    dp = W // 2
    mesh = "dp=%d,tp=2" % dp
    out = {}
    from mxnet_tpu_torch.parallel import PartitionSpec
    C.reset_stats()
    with tmx.cpu():
        _, out["conv"] = conv_fit(tmx, PartitionSpec, mesh, CONV_SPECS)
    out["conv_stats"] = {k: dict(v) for k, v in C.STATS["by_op"].items()}
    C.reset_stats()
    with tmx.cpu():
        out["nobias"] = nobias_fit(tmx, PartitionSpec, mesh,
                                   {"fc2_weight": (None, "tp")})
    out["nobias_stats"] = {k: dict(v) for k, v in C.STATS["by_op"].items()}
    out["dropout"] = dropout_fit(mesh, TP_SPECS)
    out["dropout_dp"] = dropout_fit(mesh)
    if W == 2:
        out["dropout_dp2"] = dropout_fit("dp=2")
    out["int8"] = int8_row(tmx.parallel.make_mesh("tp=%d" % W))
    C.reset_stats()
    mod, out["tp"] = _port_fit(mesh, TP_SPECS)
    out["tp_shapes"] = (_shapes(mod), _shapes(mod, "opt"))
    out["tp_stats"] = {k: dict(v) for k, v in C.STATS["by_op"].items()}
    mod, out["attr"] = _port_fit(mesh, attr=True)
    out["attr_specs"] = {k: tuple(v) for k, v in
                         mod._fused.param_specs.items()}
    out["attr_shapes"] = _shapes(mod)
    mod, out["update"] = _port_fit(mesh, {"fc1_weight": ("tp", None)},
                                   shard_update=True)
    out["update_opt"] = _shapes(mod, "opt")
    out["update_on"] = mod._fused.shard_update
    mod, out["dp_spec"] = _port_fit(mesh, {"fc1_weight": (None, "dp")},
                                    shard_update=True)
    out["dp_spec_shapes"] = (_shapes(mod), _shapes(mod, "opt"))
    # the re-mesh: dp=W, then dp x tp with a spec, the state carried
    mod, _ = _port_fit("dp=%d" % W, num_epoch=1)
    t0 = mod._fused_t
    from mxnet_tpu_torch.parallel import PartitionSpec
    mod.set_mesh(mesh, sharding={"fc1_weight": PartitionSpec(None, "tp")})
    mom = mod._fused.state["opt"]["fc1_weight"]
    out["remesh_t"] = (t0, mod._fused_t)
    out["remesh_mom"] = (tuple(mom.shape), float(mom.abs().max()))
    with tmx.cpu():
        mod.fit(data(tmx), begin_epoch=1, num_epoch=2,
                optimizer_params=dict(OPT))
    out["remesh"] = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    # a checkpoint under dp x tp, resumed onto dp=W
    ck = os.path.join(tmp, "ck%d" % W)
    _port_fit(mesh, {"fc1_weight": (None, "tp")}, num_epoch=1,
              checkpoint=ck)
    step = tmx.checkpoint.latest_step(ck)
    out["ck_files"] = sorted(os.listdir(os.path.join(
        ck, tmx.checkpoint.step_dir_name(step))))
    _, out["ck_resumed"] = _port_fit("dp=%d" % W, num_epoch=2,
                                     checkpoint=ck, resume=True)
    # score on a dp mesh
    mod, _ = _port_fit("dp=%d" % W)
    with tmx.cpu():
        out["score"] = dict(mod.score(data(tmx), "acc"))
    if W == 4:
        try:
            _port_fit("dp=1,tp=4", {"fc2_weight": ("tp", None)})
        except TError as e:
            out["indivisible"] = str(e)
    # serving: a pair written by rank 0
    prefix = os.path.join(tmp, "serve%d" % W, "m")
    if boot.rank() == 0:
        os.makedirs(os.path.dirname(prefix), exist_ok=True)
        tmx.model.save_checkpoint(
            prefix, 0, mlp(tmx), {k: tmx.nd.array(v, ctx=tmx.cpu())
                                  for k, v in params0().items()}, {})
    C.barrier(tmx.parallel.make_mesh([("w", W)]).axis("w"))
    out["serve_tp"] = _serve_rank(prefix, "tp=%d" % W if W == 2 else mesh,
                                  TP_SPECS if W == 2
                                  else {"fc1_weight": (None, "tp")}, False)
    if W == 2:
        out["serve_fused"] = _serve_rank(
            prefix, "tp=2", dict(TP_SPECS, fc2_weight=(None, "tp")), True)
    return out


@pytest.fixture(scope="module")
def port_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("multichip"))


@pytest.fixture(scope="module")
def port2(port_dir):
    from mxnet_tpu_torch.dist.spawn import run_ranks
    return run_ranks(HERE + ":rank_suite", 2, args=(2, port_dir),
                     timeout=SUITE_TIMEOUT)


@pytest.fixture(scope="module")
def port4(port_dir):
    from mxnet_tpu_torch.dist.spawn import run_ranks
    return run_ranks(HERE + ":rank_suite", 4, args=(4, port_dir),
                     timeout=SUITE_TIMEOUT)


@pytest.fixture
def port(request, port2, port4):
    return {2: port2, 4: port4}[request.param]


# -- the JAX package's side -----------------------------------------------------

_JAX = {}


def jax_fit(mesh_axes=None, specs=None, shard_update=False, num_epoch=2):
    """The JAX package's fit on the first devices of its 8 (cached)."""
    key = (mesh_axes, tuple(sorted((specs or {}).items())), shard_update,
           num_epoch)
    if key in _JAX:
        return _JAX[key]
    import jax
    import mxnet_tpu as jmx
    from jax.sharding import PartitionSpec
    mesh = None
    if mesh_axes:
        n = int(np.prod([s for _, s in mesh_axes]))
        mesh = jmx.parallel.make_mesh(list(mesh_axes),
                                      devices=jax.devices()[:n])
    old = os.environ.get("MXNET_SHARD_WEIGHT_UPDATE")
    if shard_update:
        os.environ["MXNET_SHARD_WEIGHT_UPDATE"] = "1"
    try:
        _JAX[key] = fit(jmx, PartitionSpec, mesh, specs,
                        num_epoch=num_epoch)[1]
    finally:
        if old is None:
            os.environ.pop("MXNET_SHARD_WEIGHT_UPDATE", None)
        else:
            os.environ["MXNET_SHARD_WEIGHT_UPDATE"] = old
    return _JAX[key]


def _close(a, b, tol, what):
    assert set(a) == set(b), (sorted(a), sorted(b))
    for k in a:
        err = float(np.abs(np.asarray(a[k]) - np.asarray(b[k])).max())
        assert err < tol, (what, k, err)


def _axes(W):
    return (("dp", W // 2), ("tp", 2))


# -- fit(mesh=, sharding=) -----------------------------------------------------

@pytest.mark.parametrize("port", [2, 4], indirect=True)
def test_tp_with_specs_matches_and_shards(port):
    """``dp4_tp2_with_specs_matches_and_shards`` at dp = W/2 x tp = 2:
    params within 1e-4 of the JAX package's run on the same mesh and of
    its one-device run; each rank holds (4, 6) of fc1_weight and its
    momentum at rest."""
    W = len(port)
    want = jax_fit(_axes(W), TP_SPECS)
    one = jax_fit()
    for rank in port:
        _close(rank["tp"], want, TOL, "tp vs jax mesh")
        _close(rank["tp"], one, TOL, "tp vs jax one device")
        params, opt = rank["tp_shapes"]
        assert params["fc1_weight"] == (4, 6) and params["fc1_bias"] == (4,)
        assert opt["fc1_weight"] == (4, 6)
        assert params["fc2_weight"] == (2, 8)
        # fc1's output stays cut through the relu; fc2 gathers it
        assert rank["tp_stats"]["FullyConnected"]["all_gather"] == 8


@pytest.mark.parametrize("port", [2, 4], indirect=True)
def test_get_params_gathers_sharded_state(port):
    """The host dict holds the whole weight, equal on every rank."""
    for rank in port:
        assert rank["tp"]["fc1_weight"].shape == (8, 6)
        np.testing.assert_array_equal(rank["tp"]["fc1_weight"],
                                      port[0]["tp"]["fc1_weight"])


@pytest.mark.parametrize("port", [2, 4], indirect=True)
def test_sharding_via_symbol_attr(port):
    W = len(port)
    one = jax_fit()
    for rank in port:
        assert rank["attr_specs"]["fc1_weight"][:1] == ("tp",)
        assert rank["attr_shapes"]["fc1_weight"] == (4, 6)
        _close(rank["attr"], one, TOL, "attr vs jax one device")
        _close(rank["attr"], rank["tp"], TOL, "attr vs map")
    assert W in (2, 4)


def test_shard_weight_update_generalizes_to_mesh(port4):
    """MXNET_SHARD_WEIGHT_UPDATE on dp=2 x tp=2: fc1_bias (8,), unspecced,
    keeps its rows of dp in its momentum (4,); fc1_weight's momentum
    keeps the tp cut (4, 6); params within 1e-4 of the JAX package's
    run of the same setting."""
    want = jax_fit(_axes(4), {"fc1_weight": ("tp", None)}, True)
    for rank in port4:
        assert rank["update_on"]
        assert rank["update_opt"]["fc1_bias"] == (4,)
        assert rank["update_opt"]["fc1_weight"] == (4, 6)
        _close(rank["update"], want, TOL, "shard update")


def test_shard_update_with_dp_spec_no_duplicate_axis(port4):
    """A spec spending dp on dim 1 gets no second dp from the update."""
    one = jax_fit()
    want = jax_fit(_axes(4), {"fc1_weight": (None, "dp")}, True)
    for rank in port4:
        params, opt = rank["dp_spec_shapes"]
        assert params["fc1_weight"] == (8, 3) and opt["fc1_weight"] == (8, 3)
        _close(rank["dp_spec"], one, TOL, "dp spec vs one device")
        _close(rank["dp_spec"], want, TOL, "dp spec vs jax")


@pytest.mark.parametrize("port", [2, 4], indirect=True)
def test_set_mesh_mid_training_carries_optimizer_state(port):
    """dp=W for epoch 0, then dp x tp with fc1_weight cut on dim 1: the
    step count and the momentum carry over, and the run equals the JAX
    package's uninterrupted one-device run."""
    one = jax_fit()
    for rank in port:
        assert rank["remesh_t"] == (4, 4)
        shape, mom_max = rank["remesh_mom"]
        assert shape == (8, 3) and mom_max > 0, "momentum zeroed"
        _close(rank["remesh"], one, TOL, "re-mesh")


@pytest.mark.parametrize("port", [2, 4], indirect=True)
def test_checkpoint_resume_onto_different_mesh(port):
    """Saved under dp x tp after epoch 0 (each rank its own shards, once
    over the world), resumed under dp=W: equal to the JAX package's
    uninterrupted dp=W run."""
    W = len(port)
    want = jax_fit((("dp", W),))
    files = port[0]["ck_files"]
    assert "index.json" in files and "COMMIT" in files
    assert sum(f.startswith("params.fc1_weight.") for f in files) == 2
    assert sum(f.startswith("params.fc2_weight.") for f in files) == 1
    assert {f.split(".")[-3] for f in files if f.endswith(".npy")} == \
        {"p0", "p1"}
    for rank in port:
        _close(rank["ck_resumed"], want, TOL, "resume")


@pytest.mark.parametrize("port", [2, 4], indirect=True)
def test_score_on_mesh_matches(port):
    with tmx.cpu():
        from mxnet_tpu_torch.parallel import PartitionSpec
        mod, _ = fit(tmx, PartitionSpec)
        want = dict(mod.score(data(tmx), "acc"))
    for rank in port:
        assert abs(rank["score"]["accuracy"] - want["accuracy"]) < 1e-6


def test_indivisible_param_dim_refused(port4):
    import mxnet_tpu as jmx
    import jax
    from jax.sharding import PartitionSpec
    with pytest.raises(jmx.base.MXNetError, match="divisible") as jerr:
        fit(jmx, PartitionSpec,
            jmx.parallel.make_mesh([("dp", 2), ("tp", 4)],
                                   devices=jax.devices()),
            {"fc2_weight": ("tp", None)})
    for rank in port4:
        assert "divisible" in rank["indivisible"]
        assert "fc2_weight" in rank["indivisible"]
    assert "fc2_weight" in str(jerr.value)


@pytest.mark.parametrize("port", [2, 4], indirect=True)
def test_conv_channels_cut_through_pool_flatten_reshape(port):
    """Convolution with its filters cut, then relu, max pooling, Flatten
    and Reshape keep the cut to a row-parallel FC: nothing is gathered
    (one all-reduce a step at the FC), and the params are within 1e-4 of
    the JAX package's one-device fit."""
    import mxnet_tpu as jmx
    from jax.sharding import PartitionSpec
    _, want = conv_fit(jmx, PartitionSpec)
    for rank in port:
        _close(rank["conv"], want, TOL, "conv tp")
        assert rank["conv_stats"] == {"FullyConnected": {"all_reduce": 4}}


@pytest.mark.parametrize("port", [2, 4], indirect=True)
def test_row_parallel_without_bias_hands_on_a_partial_sum(port):
    """A row-parallel FC without a bias leaves its partial sums to the
    consumer: the SoftmaxOutput's entry all-reduces them (one a step);
    params within 1e-4 of the JAX package's one-device fit."""
    import mxnet_tpu as jmx
    from jax.sharding import PartitionSpec
    want = nobias_fit(jmx, PartitionSpec)
    for rank in port:
        _close(rank["nobias"], want, TOL, "partial sum")
        assert rank["nobias_stats"] == {
            "FullyConnected": {"narrow": 8},
            "SoftmaxOutput": {"all_reduce": 8}}


@pytest.mark.parametrize("port", [2, 4], indirect=True)
def test_dropout_on_a_cut_value_draws_one_devices_mask(port):
    """Dropout between a column- and a row-parallel FC keeps the cut and
    draws the whole mask: the run equals the same mesh's run without
    specs, and the port's one-rank run (1e-6; the row-parallel FC sums
    its partial products in another order).  Over dp each rank draws its
    rows of the global batch's mask, so dp=2 (with tp=2 or alone) equals
    one device too."""
    one = dropout_fit()
    for rank in port:
        _close(rank["dropout"], rank["dropout_dp"], 1e-6, "dropout tp")
        _close(rank["dropout"], one, 1e-6, "dropout vs one rank")
        if "dropout_dp2" in rank:
            _close(rank["dropout_dp2"], one, 1e-6, "dropout dp=2 vs one")


@pytest.mark.parametrize("port", [2, 4], indirect=True)
def test_fused_fc_row_parallel_requantizes_the_sum(port):
    """The fused FC's int8 epilogue under row-parallel: the codes come
    from the summed product, equal to one device's."""
    want = int8_row()
    assert want.dtype == np.int8 and np.abs(want).max() > 10
    for rank in port:
        np.testing.assert_array_equal(rank["int8"], want)


# -- refusals on one rank ----------------------------------------------------------

def _one_rank_fit(mesh, specs):
    from mxnet_tpu_torch.parallel import PartitionSpec
    with tmx.cpu():
        fit(tmx, PartitionSpec, mesh, specs, num_epoch=1)


@pytest.mark.parametrize("mesh,specs,match", [
    ("dp=1", {"fc9_weight": ("dp",)}, "no bound parameter"),
    ("dp=1", {"fc1_weight": ("tp", None)}, "axes"),
    ("tp=1", None, "dp"),
])
def test_spec_refusals_match_reference(mesh, specs, match):
    """The reference's unknown name, unknown axis and no-dp refusals,
    with its messages."""
    with pytest.raises(TError, match=match):
        _one_rank_fit(mesh, specs)


def test_sharding_auto_names_item_10c(tmp_path, monkeypatch):
    """``sharding="auto"`` on ``dp=1``: no model axis, so the shard
    search's one candidate is ``dp``, nothing is sharded, the winner is
    stored, and the fit equals the one with no specs."""
    monkeypatch.setenv("MXNET_AUTOTUNE_DIR", str(tmp_path))
    ctx = tmx.cpu(0)
    with tmx.cpu():
        mod = tmx.mod.Module(mlp(tmx), context=ctx)
        mod.fit(data(tmx), num_epoch=1, optimizer_params=dict(OPT),
                mesh="dp=1", sharding="auto",
                arg_params={k: tmx.nd.array(v, ctx=ctx)
                            for k, v in params0().items()})
        _, want = fit(tmx, None, "dp=1", None, num_epoch=1)
    assert mod._fused.param_specs == {}
    got = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    from mxnet_tpu_torch.autotune import store
    docs = [store.load_config(k) for k in store.list_configs()
            if k.startswith("shardsearch-")]
    assert [d["config"]["specs"] for d in docs] == [{}]


def test_serve_param_specs_without_mesh_refused(tmp_path):
    from mxnet_tpu_torch.parallel import PartitionSpec
    prefix = str(tmp_path / "m")
    tmx.model.save_checkpoint(prefix, 0, mlp(tmx), {
        k: tmx.nd.array(v, ctx=tmx.cpu()) for k, v in params0().items()}, {})
    with pytest.raises(tmx.serve.ServeError, match="mesh"):
        tmx.serve.ServeEngine.from_checkpoint(
            prefix, 0, input_shapes=SERVE_SHAPES, dev_type="cpu",
            param_specs={"fc1_weight": PartitionSpec("tp", None)})


def test_executor_set_mesh_training_refused():
    it = data(tmx)
    mod = tmx.mod.Module(mlp(tmx), context=tmx.cpu(0))
    mod.bind(it.provide_data, it.provide_label, for_training=True)
    mod.init_params()
    with pytest.raises(TError, match="inference-only"):
        mod._exec_group.execs[0].set_mesh(tmx.parallel.make_mesh("tp=1"))


def test_remesh_on_one_rank_keeps_the_train_state():
    """fit, set_mesh("dp=1"), fit: the step count stays 4 and the run
    equals an uninterrupted one, as in the JAX package."""
    from mxnet_tpu_torch.parallel import PartitionSpec
    with tmx.cpu():
        _, want = fit(tmx, PartitionSpec)
        mod, _ = fit(tmx, PartitionSpec, num_epoch=1)
        assert mod._fused_t == 4
        mod.set_mesh("dp=1")
        assert mod._fused_t == 4
        mod.fit(data(tmx), begin_epoch=1, num_epoch=2,
                optimizer_params=dict(OPT))
        got = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    _close(got, want, 1e-7, "re-mesh on one rank")
    _close(got, jax_fit(), TOL, "re-mesh vs jax")


# -- the tp ServeEngine -------------------------------------------------------------

def _jax_serve(mesh=None, specs=None, fuse=None):
    """The JAX package's engine's answers (one device, or its tp engine
    on the first devices of its 8)."""
    key = ("serve", mesh, tuple(sorted((specs or {}).items())), fuse)
    if key in _JAX:
        return _JAX[key]
    import tempfile
    import mxnet_tpu as jmx
    from jax.sharding import PartitionSpec
    d = tempfile.mkdtemp(prefix="jserve")
    prefix = os.path.join(d, "m")
    jmx.model.save_checkpoint(prefix, 0, mlp(jmx), {
        k: jmx.nd.array(v) for k, v in params0().items()}, {})
    with jmx.serve.ServeEngine.from_checkpoint(
            prefix, 0, input_shapes=SERVE_SHAPES, batch_buckets=(1, 2, 4),
            mesh=mesh, param_specs=specs_of(PartitionSpec, specs),
            fuse=fuse) as ref:
        _JAX[key] = [ref.predict(x) for x in serve_inputs()]
    return _JAX[key]


def _served_close(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert np.abs(a - b).max() < SERVE_TOL


def test_serve_tp_parity_and_reload(port2):
    """tp=2 with fc1 cut on its features (and, fused, fc2 on its inputs:
    the row-parallel fused FC sums its partial products over the ranks):
    outputs within 1e-5 of the JAX package's one-device engine and of
    its tp engine on the same specs, one request at a time and batched;
    a reload keeps the layout and the outputs; a follower refuses
    requests."""
    for key, specs, fuse in (
            ("serve_tp", TP_SPECS, False),
            ("serve_fused", dict(TP_SPECS, fc2_weight=(None, "tp")), True)):
        r0 = port2[0][key]
        for want in (_jax_serve(), _jax_serve("tp=2", specs, fuse)):
            for name in ("one", "many", "reloaded"):
                _served_close(r0[name], want)
        for rank in port2:
            assert rank[key]["w"] == (4, 6) and rank[key]["w2"] == (4, 6)
            assert rank[key]["version"] == 1
        assert "follows" in port2[1][key]["follower"]


def test_serve_dp_mesh_batches_shard(port4):
    """dp=2 x tp=2, fc1_weight cut on dim 1: a batch of 4 splits over
    dp, outputs within 1e-5 of the JAX package's engine."""
    want = _jax_serve()
    r0 = port4[0]["serve_tp"]
    _served_close(r0["many"], want)
    _served_close(r0["one"], want)
    for rank in port4:
        assert rank["serve_tp"]["w"] == (8, 3)


# -- multi-rank targets of test_torch_moe.py and test_torch_checkpoint.py -----

MOE_E, MOE_K, MOE_HID = 4, 2, 16


def moe_params():
    rng = np.random.RandomState(4)

    def g(*s):
        return (rng.randn(*s) * 0.3).astype(np.float32)
    return {"moe_gate_weight": g(MOE_E, 6),
            "moe_experts_i2h_weight": g(MOE_E, 6, MOE_HID),
            "moe_experts_i2h_bias": g(MOE_E, MOE_HID) * 0.1,
            "moe_experts_h2o_weight": g(MOE_E, MOE_HID, 6),
            "moe_experts_h2o_bias": g(MOE_E, 6) * 0.1,
            "head_weight": g(2, 6), "head_bias": np.zeros(2, np.float32)}


def moe_fit(mx, cf, mesh=None, expert_axis=None):
    """MoEFeedForward through Module.fit from moe_params; -> (module,
    host params)."""
    ctx = mx.cpu(0)
    net = mx.moe.MoEFeedForward(mx.sym.Variable("data"),
                                num_hidden=MOE_HID, num_experts=MOE_E,
                                k=MOE_K, capacity_factor=cf, name="moe",
                                expert_axis=expert_axis)
    net = mx.sym.FullyConnected(net, num_hidden=2, name="head")
    net = mx.moe.with_aux_loss(mx.sym.SoftmaxOutput(net, name="softmax"))
    mod = mx.mod.Module(net, context=ctx)
    met = mx.metric.CompositeEvalMetric(
        [mx.metric.OutputSlice("acc", 0, 1),
         mx.metric.OutputMean(1, name="moe_aux")])
    mod.fit(data(mx), num_epoch=2, eval_metric=met, mesh=mesh,
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            arg_params={k: mx.nd.array(v, ctx=ctx)
                        for k, v in moe_params().items()})
    return mod, {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def route_logits(T=64, seed=9):
    return (np.random.RandomState(seed).randn(T, MOE_E) * 2).astype(
        np.float32)


def moe_rank(W, cf):
    """dp = W/2 x ep = 2: the fit's params and expert shards, and the
    global routing of this rank's rows of route_logits over dp = W."""
    import torch
    from mxnet_tpu_torch.moe.router import resolve_capacity, route
    from mxnet_tpu_torch.parallel import collectives as C
    out = {}
    with tmx.cpu():
        mod, out["params"] = moe_fit(tmx, cf, "dp=%d,ep=2" % (W // 2), "ep")
    out["experts"] = tuple(
        mod._fused.state["params"]["moe_experts_i2h_weight"].shape)
    logits = route_logits()
    ax = tmx.parallel.make_mesh([("dp", W)]).axis("dp")
    n = logits.shape[0] // W
    mine = torch.tensor(logits[ax.index * n:(ax.index + 1) * n])
    cap = resolve_capacity(cf, logits.shape[0], MOE_E, MOE_K)
    plan = route(mine, MOE_K, cap, dp=ax)
    out["slot"] = C.all_gather(plan.slot, ax).numpy()
    out["counts"] = plan.counts.numpy()
    out["dropped"] = float(plan.dropped)
    out["aux"] = float(plan.aux)
    return out


def ckpt_save_rank(store):
    """dp=2 x tp=2 with fc1_weight cut on dim 1 and the sharded update,
    one epoch saved; -> the host params."""
    return _port_fit("dp=2,tp=2", {"fc1_weight": (None, "tp")},
                     shard_update=True, num_epoch=1, checkpoint=store)[1]


def ckpt_restore_rank(store):
    """A dp=1 x tp=2 module with fc1_weight cut on dim 0 restores
    ``store``'s newest step, each rank reading its slices; -> (host
    params, the live shard's shape, the step count)."""
    from mxnet_tpu_torch.parallel import PartitionSpec
    with tmx.cpu():
        mod = tmx.mod.Module(mlp(tmx), context=tmx.cpu(0))
        it = data(tmx)
        mod.set_mesh("dp=1,tp=2",
                     sharding={"fc1_weight": PartitionSpec("tp", None)})
        mod.bind(it.provide_data, it.provide_label)
        mod.init_params(tmx.init.Uniform(0.1))
        mod.init_optimizer(optimizer_params=dict(OPT))
        with tmx.checkpoint.CheckpointManager(store, keep_last_n=None) as m:
            tmx.checkpoint.restore_module(m, mod)
        return ({k: v.asnumpy() for k, v in mod.get_params()[0].items()},
                tuple(mod._fused.state["params"]["fc1_weight"].shape),
                mod._fused_t)


# -- embeddings over dp (test_torch_embed.py holds these to the JAX package) --

EMB_V, EMB_D = 48, 8
EMB_OPT = {"learning_rate": 0.5, "momentum": 0.9}


def rec_symbol(mx):
    """``tests/test_embed.py``'s rec model: ids -> Embedding -> two FCs."""
    ids = mx.sym.Variable("ids")
    net = mx.sym.Embedding(ids, weight=mx.sym.Variable("embed_weight"),
                           input_dim=EMB_V, output_dim=EMB_D, name="embed")
    net = mx.sym.FullyConnected(mx.sym.Flatten(net), num_hidden=16,
                                name="fc1")
    net = mx.sym.Activation(net, act_type="relu")
    return mx.sym.SoftmaxOutput(
        mx.sym.FullyConnected(net, num_hidden=2, name="fc2"),
        name="softmax")


def rec_params():
    rng = np.random.RandomState(4)
    return {"embed_weight":
            (rng.randn(EMB_V, EMB_D) * 0.5).astype(np.float32),
            "fc1_weight": (rng.randn(16, 4 * EMB_D) * 0.3).astype(np.float32),
            "fc1_bias": np.zeros(16, np.float32),
            "fc2_weight": (rng.randn(2, 16) * 0.3).astype(np.float32),
            "fc2_bias": np.zeros(2, np.float32)}


def rec_ids(n=64):
    return np.random.RandomState(0).randint(
        0, EMB_V, size=(n, 4)).astype(np.int32).astype(np.float32)


def rec_fit(mx, mesh=None, sharding=None, num_epoch=3, **kw):
    """The rec model's fit from ``rec_params`` (batch 16, lr 0.5,
    momentum 0.9), every rank fed the global batch; -> (module, host
    params)."""
    mx.random.seed(5)
    X = rec_ids()
    y = (np.abs(X).sum(axis=1) % 2).astype(np.float32)
    it = mx.io.NDArrayIter(X, y, batch_size=16, data_name="ids")
    ctx = mx.cpu(0)
    mod = mx.mod.Module(rec_symbol(mx), data_names=("ids",), context=ctx)
    mod.fit(it, num_epoch=num_epoch, optimizer_params=dict(EMB_OPT),
            arg_params={k: mx.nd.array(v, ctx=ctx)
                        for k, v in rec_params().items()},
            mesh=mesh, sharding=sharding, **kw)
    return mod, {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def table_inputs(W):
    """Global ids (out-of-range ones included), two steps' gradients and
    the table's init, and this rank's rows of the ids; shared with the
    JAX side."""
    rng = np.random.RandomState(4)
    table = rng.randn(EMB_V, EMB_D).astype(np.float32)
    ids = rng.randint(0, EMB_V, size=(8, 4))
    ids[0, 3], ids[5, 1], ids[6, 0] = -1, EMB_V, EMB_V + 9
    g = rng.randn(2, 8, 4, EMB_D).astype(np.float32)
    return table, ids, g


def _table_rank(W):
    from mxnet_tpu_torch import embed
    from mxnet_tpu_torch.dist import boot
    from mxnet_tpu_torch.parallel import make_mesh
    table, ids, g = table_inputs(W)
    r, n = boot.rank(), 8 // W
    mine = slice(r * n, (r + 1) * n)
    mesh = make_mesh("dp=%d" % W)

    def sgd():
        return tmx.optimizer.SGD(learning_rate=0.1, momentum=0.9)
    out = {}
    t = embed.EmbeddingTable(EMB_V, EMB_D, mesh=mesh, spec="dp",
                             initializer=table, optimizer=sgd())
    out["block"] = tuple(t.rows.shape)
    out["lookup"] = t.lookup(ids[mine]).numpy()
    out["mean"] = t.lookup(ids[mine], combiner="mean").numpy()
    for k in range(2):
        t.update(ids[mine], g[k][mine])
    out["updated"] = t.as_numpy()
    st = t.state()
    out["state"] = {"rows": st["rows"], "slots": st["slots"],
                    "t": int(st["t"])}
    # onto another mesh: the rows cut over tp of a dp x tp mesh
    other = embed.EmbeddingTable(
        EMB_V, EMB_D, mesh=make_mesh("dp=%d,tp=2" % (W // 2)), spec="tp",
        optimizer=sgd())
    other.restore(st)
    out["other_block"] = tuple(other.rows.shape)
    out["other"] = other.as_numpy()
    acc = embed.EmbeddingTable(EMB_V, EMB_D, mesh=mesh, initializer=table)
    acc.accumulate(ids[mine], g[0][mine])
    out["accumulated"] = acc.as_numpy()
    kv = tmx.kvstore.create("device_embed", mesh=mesh, spec="dp")
    kv.init("table", tmx.nd.array(table), sparse=True)
    kv.set_optimizer(sgd())
    kv.push("table", (ids[mine].reshape(-1), g[0][mine].reshape(-1, EMB_D)))
    pulled = tmx.nd.zeros((n * 4, EMB_D))
    kv.row_sparse_pull("table", out=pulled, row_ids=ids[mine].reshape(-1))
    full = tmx.nd.zeros((EMB_V, EMB_D))
    kv.pull("table", out=full)
    out["kv"] = (pulled.asnumpy(), full.asnumpy(),
                 tuple(kv.table("table").rows.shape))
    refusals = {}
    for what, kw in (("divisible", dict(vocab=EMB_V + 1, mesh=mesh,
                                        spec="dp")),
                     ("no mesh", dict(vocab=EMB_V, spec="dp"))):
        try:
            embed.EmbeddingTable(kw.pop("vocab"), EMB_D, **kw)
        except TError as e:
            refusals[what] = str(e)
    out["refusals"] = refusals
    return out


def embed_rank(W, tmp):
    """Every port-side embedding result at world size W."""
    from mxnet_tpu_torch.parallel import PartitionSpec as P
    rows = {"embed_weight": P("dp", None)}
    out = {}
    with tmx.cpu():
        mod, out["dp"] = rec_fit(tmx, "dp=%d" % W)
        out["dp_sparse"] = sorted(mod._fused.sparse_embeds)
        mod, out["rows"] = rec_fit(tmx, "dp=%d" % W, rows)
        out["rows_sparse"] = sorted(mod._fused.sparse_embeds)
        out["rows_shape"] = tuple(
            mod._fused.state["params"]["embed_weight"].shape)
        if W == 4:
            _, out["rows_dptp"] = rec_fit(tmx, "dp=2,tp=2", rows)
        ck = os.path.join(tmp, "emb%d" % W)
        _, out["ck_saved"] = rec_fit(tmx, "dp=%d" % W, rows, num_epoch=1,
                                     checkpoint=ck)
        # onto dp x tp (W = 4) or the replicated table (W = 2)
        _, out["ck_other_mesh"] = rec_fit(
            tmx, "dp=2,tp=2" if W == 4 else "dp=2",
            rows if W == 4 else None, num_epoch=1, checkpoint=ck,
            resume=True)
        out["ck_dir"] = ck
        out["table"] = _table_rank(W)
    return out


# -- the feed under a mesh (test_torch_feed.py holds these) -------------------

def _feed_fit(mesh, prefetch, superstep=None, pipeline=None):
    """The MLP from ``params0`` over ``mesh`` (None: one rank), fed the
    global batch of 16 by ``fit`` over an ``NDArrayIter``, or one epoch
    by hand (``pipeline``): each batch through a ``DevicePutStage`` onto
    the step's ``batched_sharding()`` (``"stage"``) or as it comes
    (``"whole"``); -> (host params, bytes (the stage) or rows (the
    prefetcher) the feed staged, the prefetcher's batches)."""
    seen = []
    with tmx.cpu():
        it = data(tmx)
        mod = tmx.mod.Module(mlp(tmx), context=tmx.cpu(0))
        wrap = mod.prefetch_to_device

        def keep(*a, **kw):
            seen.append(wrap(*a, **kw))
            return seen[-1]
        mod.prefetch_to_device = keep
        if pipeline:
            from mxnet_tpu_torch import feed
            mod.bind(it.provide_data, it.provide_label)
            mod.init_params(arg_params={
                k: tmx.nd.array(v, ctx=tmx.cpu())
                for k, v in params0().items()})
            mod.set_mesh(mesh)
            mod.init_optimizer(optimizer_params=dict(OPT))
            stage = feed.DevicePutStage(
                lambda: mod._fused.batched_sharding())
            stage.stats = feed.PipelineStats("rows").stage("h2d")
            staged = []
            for b in it:
                if pipeline == "whole":
                    staged.append(b)
                    continue
                out = stage.process((b.data[0].asnumpy(),
                                     b.label[0].asnumpy(), 0))
                db = tmx.io.DataBatch([tmx.nd.NDArray(out[0])],
                                      [tmx.nd.NDArray(out[1])], pad=0)
                db.rows_cut = out.rows_cut
                staged.append(db)
            for db in staged:
                mod.forward_backward(db)
                mod.update()
            nbytes = stage.stats.snapshot().get("bytes", 0)
            return ({k: v.asnumpy() for k, v in
                     mod.get_params()[0].items()}, nbytes, len(staged))
        mod.fit(it, num_epoch=2, optimizer_params=dict(OPT), mesh=mesh,
                prefetch_to_device=prefetch, superstep=superstep,
                arg_params={k: tmx.nd.array(v, ctx=tmx.cpu())
                            for k, v in params0().items()})
        params = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    h2d = seen[0].stats.report()["h2d"] if seen else {}
    return params, h2d.get("bytes", 0), h2d.get("items", 0)


def feed_rank(W):
    """Every port-side feed result at world size W (``dp=W``)."""
    mesh = "dp=%d" % W
    return {"plain": _feed_fit(mesh, False),
            "prefetch": _feed_fit(mesh, True),
            "mega_plain": _feed_fit(mesh, False, superstep=2),
            "mega": _feed_fit(mesh, True, superstep=2),
            "stage": _feed_fit(mesh, False, pipeline="stage"),
            "whole": _feed_fit(mesh, False, pipeline="whole"),
            "augment": augment_fit(mesh)}


def augment_fit(mesh=None):
    """Eight steps of a small net on uint8 HWC batches of 16 through the
    fused step's augmentation prologue (random crop and mirror), every
    rank fed the global batch; -> (host params, the draws of each step:
    this rank's rows)."""
    from mxnet_tpu_torch import feed
    from mxnet_tpu_torch.io import DataBatch
    spec = feed.AugmentSpec((3, 4, 4), (6, 6, 3), rand_crop=True,
                            rand_mirror=True, mean_rgb=(120, 110, 100),
                            scale=1 / 64.0)
    rng = np.random.RandomState(2)
    X = rng.randint(0, 256, (128, 6, 6, 3)).astype(np.uint8)
    y = (X.reshape(128, -1).mean(axis=1) > 127.5).astype(np.float32)
    net = tmx.sym.SoftmaxOutput(tmx.sym.FullyConnected(
        tmx.sym.Flatten(tmx.sym.Variable("data")), num_hidden=2,
        name="fc"), name="softmax")
    w0 = {"fc_weight": (rng.randn(2, 48) * 0.1).astype(np.float32),
          "fc_bias": np.zeros(2, np.float32)}
    with tmx.cpu():
        tmx.random.seed(9)
        mod = tmx.mod.Module(net, context=tmx.cpu(0))
        mod.set_mesh(mesh)
        mod.bind([("data", (16, 3, 4, 4))], [("softmax_label", (16,))])
        mod.init_params(arg_params={k: tmx.nd.array(v, ctx=tmx.cpu())
                                    for k, v in w0.items()})
        mod.init_optimizer(optimizer_params=dict(OPT))
        mod._fused.set_device_augment(spec)
        mod._fused.augment_probe = []
        for i in range(0, 128, 16):
            import torch
            mod.forward_backward(DataBatch(
                [tmx.nd.NDArray(torch.from_numpy(X[i:i + 16].copy()))],
                [tmx.nd.NDArray(torch.from_numpy(y[i:i + 16].copy()))]))
            mod.update()
        draws = [tuple(t.numpy() for t in d)
                 for _x, d, _o in mod._fused.augment_probe]
        return ({k: v.asnumpy() for k, v in mod.get_params()[0].items()},
                draws)
