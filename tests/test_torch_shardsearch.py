"""The shard search (``sharding="auto"``, ``mxnet_tpu_torch.dist.
shardsearch``) against the JAX package's (CPU, small sizes).

``enumerate_candidates`` gives the reference's names and specs exactly
(``==``) over several shape sets and meshes, indivisible dims included;
the fingerprint moves with the shapes, the axes, the card's name and the
world size.  Two gloo ranks at dp=1 x tp=2 search an MLP: both install
the same specs, only rank 0 writes the store, the first step matches one
process's at the multichip tests' tolerance (1e-4), a second pair of
processes resolves from the store with no trial built, and the
shortlist is scored from the in-process memo, with no second eager step.
"""
import os
from collections import OrderedDict

import numpy as np
import pytest

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.dist import shardsearch as ss

HERE = os.path.abspath(__file__)
TOL = 1e-4
OPT = {"learning_rate": 0.5, "momentum": 0.9}


class _Mesh:
    """Anything with an ordered ``shape`` (both packages' functions read
    only that)."""

    def __init__(self, **axes):
        self.shape = OrderedDict(axes)


SHAPE_SETS = [
    ({"fc1_weight": (8, 6), "fc1_bias": (8,), "fc2_weight": (2, 8),
      "fc2_bias": (2,)}, _Mesh(dp=1, tp=2)),
    ({"a_weight": (6, 10), "b_weight": (12, 4), "c_bias": (12,),
      "d_weight": (3, 3, 5, 5), "e_weight": (7, 8)}, _Mesh(dp=2, tp=4)),
    ({"a_weight": (6, 12), "b_weight": (12, 6), "c_weight": (5, 7),
      "d_weight": (18, 4, 2)}, _Mesh(dp=2, tp=2, mp=3)),
    ({"a_weight": (4, 4)}, _Mesh(dp=4)),
    ({"a_weight": (4, 4), "b_weight": (3, 5)}, _Mesh(dp=2, tp=1)),
    ({"a_weight": (3, 5), "b_weight": (5, 3)}, _Mesh(dp=1, tp=2)),
]


@pytest.mark.parametrize("shapes,mesh", SHAPE_SETS)
def test_candidates_equal_the_references(shapes, mesh):
    from mxnet_tpu.dist.shardsearch import enumerate_candidates as ref
    got = ss.enumerate_candidates(shapes, mesh)
    assert got == ref(shapes, mesh)
    assert got[0] == ("dp", {})


def test_fingerprint_moves_with_what_changes_the_answer(monkeypatch):
    from mxnet_tpu_torch.parallel import make_mesh
    sym = _mlp()
    shapes = dict(SHAPE_SETS[0][0])
    one = make_mesh([("dp", 1)])
    base = ss.fingerprint(sym, shapes, one)
    assert base.startswith("shardsearch-")
    assert ss.fingerprint(sym, shapes, one) == base
    other = dict(shapes, fc2_weight=(4, 8))
    assert ss.fingerprint(sym, other, one) != base
    assert ss.fingerprint(sym, shapes,
                          make_mesh([("dp", 1), ("tp", 1)])) != base
    monkeypatch.setattr(ss, "_device_name", lambda device=None: "NVIDIA H100")
    assert ss.fingerprint(sym, shapes, one) != base
    monkeypatch.setattr(ss, "_device_name", lambda device=None: "cpu")
    assert ss.fingerprint(sym, shapes, one) == base
    monkeypatch.setattr(ss, "_world_size", lambda: 2)
    assert ss.fingerprint(sym, shapes, one) != base


def test_disabled_search_resolves_to_none(monkeypatch):
    monkeypatch.setenv("MXNET_DIST_SHARDSEARCH", "0")
    assert ss.resolve_auto(object(), None) is None


# -- two gloo ranks -----------------------------------------------------------

def _mlp():
    data = tmx.sym.Variable("data")
    h = tmx.sym.Activation(tmx.sym.FullyConnected(data, num_hidden=8,
                                                  name="fc1"),
                           act_type="relu")
    # the search's trials draw masks too: the step after it must draw
    # what a run without the search draws
    h = tmx.sym.Dropout(h, p=0.5)
    return tmx.sym.SoftmaxOutput(
        tmx.sym.FullyConnected(h, num_hidden=2, name="fc2"), name="softmax")


def _params0():
    rng = np.random.RandomState(5)
    return {"fc1_weight": (rng.randn(8, 6) * 0.3).astype(np.float32),
            "fc1_bias": (rng.randn(8) * 0.1).astype(np.float32),
            "fc2_weight": (rng.randn(2, 8) * 0.3).astype(np.float32),
            "fc2_bias": np.zeros(2, np.float32)}


def _batch():
    rng = np.random.RandomState(0)
    X = rng.randn(16, 6).astype(np.float32)
    y = (X.sum(axis=1) > 0).astype(np.float32)
    return tmx.io.DataBatch(data=[tmx.nd.array(X, ctx=tmx.cpu())],
                            label=[tmx.nd.array(y, ctx=tmx.cpu())])


def _one_step(mesh=None, sharding=None):
    """Bind the MLP from the same params and take one step; -> the
    module and its (gathered) host params."""
    ctx = tmx.cpu(0)
    tmx.random.seed(3)
    mod = tmx.mod.Module(_mlp(), context=ctx)
    mod.bind([("data", (16, 6))], [("softmax_label", (16,))])
    mod.init_params(arg_params={k: tmx.nd.array(v, ctx=ctx)
                                for k, v in _params0().items()})
    if mesh is not None:
        mod.set_mesh(mesh, sharding=sharding)
    mod.init_optimizer(optimizer_params=dict(OPT))
    mod.forward_backward(_batch())
    mod.update()
    return mod, {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def search_rank(store):
    """One rank's ``sharding="auto"`` resolution and first step."""
    from mxnet_tpu_torch.autotune import store as st
    from mxnet_tpu_torch.dist import boot
    os.environ["MXNET_AUTOTUNE_DIR"] = store
    ss.COUNTS.update(trials=0, feature_steps=0)
    ss._FEATURES.clear()
    saves = []
    real_save = st.save_config

    def save(*a, **kw):
        saves.append(boot.rank())
        return real_save(*a, **kw)
    st.save_config = save
    try:
        with tmx.cpu():
            mod, params = _one_step("dp=1,tp=2", "auto")
    finally:
        st.save_config = real_save
    shapes = {k: tuple(v.shape) for k, v in _params0().items()}
    return {"rank": boot.rank(), "saves": saves,
            "specs": {k: tuple(v) for k, v in
                      mod._fused.param_specs.items()},
            "counts": dict(ss.COUNTS), "memo": len(ss._FEATURES),
            "cands": len(ss.enumerate_candidates(
                shapes, tmx.parallel.make_mesh("dp=1,tp=2"))),
            "params": params}


def test_two_ranks_search_install_one_winner_and_resolve_from_store(
        tmp_path, monkeypatch):
    from mxnet_tpu_torch.dist.spawn import run_ranks
    monkeypatch.setenv("MXNET_DIST_SHARDSEARCH_SHORTLIST", "2")
    monkeypatch.setenv("MXNET_DIST_SHARDSEARCH_STEPS", "2")
    store = str(tmp_path / "store")
    first = run_ranks(HERE + ":search_rank", 2, args=(store,), timeout=240)
    a, b = first
    assert a["specs"] == b["specs"]
    assert a["saves"] == [0] and b["saves"] == []
    assert a["cands"] == 5
    for r in first:
        # every candidate scored once; the shortlist's second trials
        # took their features from the memo
        assert r["counts"] == {"trials": 5 + 2, "feature_steps": 5}
        assert r["memo"] == 5
    from mxnet_tpu_torch.autotune import store as st
    monkeypatch.setenv("MXNET_AUTOTUNE_DIR", store)
    docs = [st.load_config(k) for k in st.list_configs()
            if k.startswith("shardsearch-")]
    assert len(docs) == 1
    winner = {k: tuple(tuple(e) if isinstance(e, list) else e
                       for e in v)
              for k, v in docs[0]["config"]["specs"].items()}
    assert winner == a["specs"]
    log = docs[0]["log"]
    assert len(log) == 5 and sum(1 for _, s in log if s > 0) == 2
    # the winner's first step equals one process's
    with tmx.cpu():
        _, want = _one_step()
    for k in want:
        for r in first:
            np.testing.assert_allclose(r["params"][k], want[k], rtol=TOL,
                                       atol=TOL)
    second = run_ranks(HERE + ":search_rank", 2, args=(store,),
                       timeout=240)
    for r in second:
        assert r["counts"] == {"trials": 0, "feature_steps": 0}
        assert r["specs"] == a["specs"] and r["saves"] == []
