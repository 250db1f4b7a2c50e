"""The port's kvstore local modes against the JAX package's, on the CPU.

``test_kvstore.py``'s local cases run in both packages on the same
seeded values and must give equal results: pushes of several values sum
in list order onto the first value's device, so the sums are equal bit
for bit.  Distinct ``cpu(i)`` contexts stand for several devices.  Then
``model._create_kvstore``'s auto-select rule (``local`` becomes
``local_update_cpu`` below 16M elements in the largest parameter, else
``local_allreduce_cpu``) and the modes that wait for later slices.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

SHAPE = (4, 4)
KEYS = [5, 7, 11]


def _vals(seed, n):
    rng = np.random.RandomState(seed)
    return [rng.randn(*SHAPE).astype(np.float32) for _ in range(n)]


def _nd(pkg, a, i=0):
    return pkg.nd.array(a, ctx=pkg.cpu(i))


def _init(pkg, kind="local"):
    kv = pkg.kv.create(kind)
    kv.init(3, pkg.nd.zeros(SHAPE, ctx=pkg.cpu()))
    kv.init(KEYS, [pkg.nd.zeros(SHAPE, ctx=pkg.cpu())] * len(KEYS))
    return kv


def _case_single(pkg, kind):
    kv = _init(pkg, kind)
    kv.push(3, _nd(pkg, _vals(0, 1)[0]))
    out = pkg.nd.zeros(SHAPE, ctx=pkg.cpu())
    kv.pull(3, out=out)
    return [out.asnumpy()]


def _case_init(pkg, kind):
    kv = pkg.kv.create(kind)
    kv.init(3, _nd(pkg, _vals(1, 1)[0]) * 4)
    out = pkg.nd.zeros(SHAPE, ctx=pkg.cpu())
    kv.pull(3, out=out)
    return [out.asnumpy()]


def _case_list(pkg, kind):
    kv = _init(pkg, kind)
    kv.push(KEYS, [_nd(pkg, v) for v in _vals(2, len(KEYS))])
    outs = [pkg.nd.zeros(SHAPE, ctx=pkg.cpu()) for _ in KEYS]
    kv.pull(KEYS, out=outs)
    return [o.asnumpy() for o in outs]


def _case_aggregator(pkg, kind):
    kv = _init(pkg, kind)
    vals = [_nd(pkg, v, i) for i, v in enumerate(_vals(3, 4))]
    kv.push(3, vals)
    kv.pull(3, out=vals)
    got = [v.asnumpy() for v in vals]
    many = [[_nd(pkg, v, i) for i, v in enumerate(_vals(4 + k, 4))]
            for k in range(len(KEYS))]
    kv.push(KEYS, many)
    kv.pull(KEYS, out=many)
    return got + [v.asnumpy() for vv in many for v in vv]


def _case_updater(pkg, kind):
    kv = _init(pkg, kind)

    def updater(key, recv, local):
        local += recv
    kv._set_updater(updater)
    vals = [[_nd(pkg, v, i) for i, v in enumerate(_vals(10 + k, 4))]
            for k in range(len(KEYS))]
    for _ in range(4):
        kv.push(KEYS, vals)
    kv.pull(KEYS, out=vals)
    return [v.asnumpy() for vv in vals for v in vv]


def _case_optimizer(pkg, kind):
    kv = pkg.kv.create(kind)
    kv.init(0, _nd(pkg, _vals(20, 1)[0]))
    kv.set_optimizer(pkg.optimizer.SGD(learning_rate=0.5, rescale_grad=0.25,
                                       wd=1e-3, momentum=0.9))
    for v in _vals(21, 3):
        kv.push(0, [_nd(pkg, v, 0), _nd(pkg, v * 2, 1)])
    out = pkg.nd.zeros(SHAPE, ctx=pkg.cpu())
    kv.pull(0, out=out)
    return [out.asnumpy()]


CASES = {"single": _case_single, "init": _case_init, "list": _case_list,
         "aggregator": _case_aggregator, "updater": _case_updater,
         "set_optimizer": _case_optimizer}
KINDS = ["local", "local_update_cpu", "local_allreduce_cpu", "device",
         "local_allreduce_device"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_local_modes_equal_jax(case, kind):
    got = CASES[case](tmx, kind)
    want = CASES[case](jmx, kind)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_type_rank_and_workers():
    for kind in KINDS:
        kv = tmx.kv.create(kind)
        assert (kv.type, kv.rank, kv.num_workers) == (kind, 0, 1)
        kv.barrier()
    assert tmx.create_kvstore is tmx.kvstore.create
    with pytest.raises(tmx.MXNetError, match="unknown kvstore"):
        tmx.kv.create("nope")
    # one process: the dist store over a world-1 group (reference
    # test_dist_sync_tpu_single_process); the group goes with the test
    from mxnet_tpu_torch.dist import boot
    try:
        kv = tmx.kv.create("dist_sync")
        assert (kv.type, kv.rank, kv.num_workers) == ("dist_sync", 0, 1)
    finally:
        boot.shutdown()
    assert tmx.kv.create("device_embed", ctx=tmx.cpu()).type == \
        "device_embed"
    kv = tmx.kv.create("local")
    with pytest.raises(tmx.MXNetError, match="not been initialized"):
        kv.push(9, tmx.nd.zeros(SHAPE, ctx=tmx.cpu()))


def test_push_is_a_fault_point():
    kv = _init(tmx)
    tmx.faults.install("seed=1,rate=1.0,kinds=error,points=kvstore.push")
    try:
        with pytest.raises(tmx.faults.InjectedFault):
            kv.push(3, tmx.nd.ones(SHAPE, ctx=tmx.cpu()))
    finally:
        tmx.faults.clear()


@pytest.mark.parametrize("largest,want", [
    (2048 * 1000, "local_update_cpu"),          # ResNet-50's fc weight
    (4096 * 25088, "local_allreduce_cpu"),      # VGG-16's fc6 weight
    (16 * 1024 * 1024 - 1, "local_update_cpu"),
    (16 * 1024 * 1024, "local_allreduce_cpu")])
def test_create_kvstore_auto_select(largest, want):
    class P:
        shape = (largest,)
    params = {"w": P(), "b": type("B", (), {"shape": (7,)})()}
    for pkg in (tmx, jmx):
        kv, on_kv = pkg.model._create_kvstore("local", 2, params)
        assert kv.type == want
        assert on_kv == (want == "local_update_cpu")
    for pkg in (tmx, jmx):
        assert pkg.model._create_kvstore("local", 1, params) == (None, False)
        assert pkg.model._create_kvstore(None, 2, params) == (None, False)
        kv, on_kv = pkg.model._create_kvstore("device", 2, params)
        assert kv.type == "device" and on_kv
        kv, on_kv = pkg.model._create_kvstore(
            pkg.kv.create("local_allreduce_device"), 1, params)
        assert kv.type == "local_allreduce_device" and not on_kv
    with pytest.raises(TypeError):
        tmx.model._create_kvstore(3, 2, params)


def test_param_idx2name_equals_jax():
    names = ["a", "b", "c"]
    for ndev in (1, 3):
        for on_kv in (True, False):
            assert tmx.model._param_idx2name(names, ndev, on_kv) == \
                jmx.model._param_idx2name(names, ndev, on_kv)
