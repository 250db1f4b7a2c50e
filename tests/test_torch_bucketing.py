"""Sequence-model training in the port against the JAX package, on the
CPU: ``BucketingModule.fit`` over the PTB LSTM (buckets 3/5/7), the
fused ``Module`` path for the LSTM and the GRU, shared binding and the
borrowed optimizer, and checkpoints crossing both ways.

The model is ``lstm_unroll`` at 2 layers, 16 hidden, 16 embed, vocab 50,
batch 4; the parameters come from a checkpoint the JAX package writes
(uniform from a numpy seed), the token ids from a numpy seed, labels the
ids shifted by one as ``example/rnn/bucket_io.py`` makes them.  Both
packages train the same 8 batches with SGD (lr 0.1, momentum 0.9, wd
1e-5, the example's settings); tolerance rtol 1e-4, atol 1e-5 on the
parameters after the 8 steps: float32 sums run in other orders in XLA
and in PyTorch's CPU kernels, and momentum carries each step's last-bit
differences on.

Both packages' fused steps train an ``Embedding`` table whose ids are a
data input through the deduped lazy row update (``embed/``), which
updates only the rows a batch touches, momentum and weight decay
included; both run here under that default.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu.models as jmodels
import mxnet_tpu_torch as tmx

L, H, E, V, B = 2, 16, 16, 50, 4
BUCKETS = (3, 5, 7)
OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-5}
RTOL, ATOL = 1e-4, 1e-5
STATE_NAMES = (["l%d_init_c" % i for i in range(L)]
               + ["l%d_init_h" % i for i in range(L)])
GRU_STATE_NAMES = ["l%d_init_h" % i for i in range(L)]


def _states(model_fn):
    return GRU_STATE_NAMES if model_fn == "gru_unroll" else STATE_NAMES


def _models(pkg):
    return jmodels if pkg is jmx else tmx.models


def _sym_gen(pkg, model_fn="lstm_unroll"):
    def gen(seq_len):
        sym = getattr(_models(pkg), model_fn)(L, seq_len, V, H, E, V)
        return sym, tuple(["data"] + _states(model_fn)), ("softmax_label",)
    return gen


def _state_shapes(batch=B, model_fn="lstm_unroll"):
    return [(n, (batch, H)) for n in _states(model_fn)]


class _BucketIter:
    """A fixed plan of (bucket, ids) batches with the reference's
    ``BucketSentenceIter`` surface: labels are the ids shifted by one,
    the init states zeros."""

    def __init__(self, pkg, plan, batch=B, model_fn="lstm_unroll"):
        self.pkg, self.plan, self.batch_size = pkg, plan, batch
        self.states = _state_shapes(batch, model_fn)
        self.default_bucket_key = max(BUCKETS)
        self.provide_data = [("data", (batch, self.default_bucket_key))] \
            + self.states
        self.provide_label = [("softmax_label",
                               (batch, self.default_bucket_key))]
        self._pos = 0

    def reset(self):
        self._pos = 0

    def __iter__(self):
        return self

    def __next__(self):
        if self._pos >= len(self.plan):
            raise StopIteration
        key, ids = self.plan[self._pos]
        self._pos += 1
        label = np.zeros_like(ids)
        label[:, :-1] = ids[:, 1:]
        nd = self.pkg.nd
        data = [nd.array(ids, ctx=self.pkg.cpu())] + [
            nd.zeros(s, ctx=self.pkg.cpu()) for _, s in self.states]
        return self.pkg.io.DataBatch(
            data=data, label=[nd.array(label, ctx=self.pkg.cpu())], pad=0,
            bucket_key=key,
            provide_data=[("data", (self.batch_size, key))] + self.states,
            provide_label=[("softmax_label", (self.batch_size, key))])

    next = __next__


def _plan(seed=0, n=8):
    rng = np.random.RandomState(seed)
    keys = [BUCKETS[i % len(BUCKETS)] for i in rng.permutation(n)]
    return [(k, rng.randint(0, V, (B, k)).astype(np.float32)) for k in keys]


def _checkpoint(tmp_path, model_fn="lstm_unroll", seed=3):
    """A checkpoint written by the JAX package: -> prefix."""
    sym = getattr(jmodels, model_fn)(L, max(BUCKETS), V, H, E, V)
    shapes = dict([("data", (B, max(BUCKETS))),
                   ("softmax_label", (B, max(BUCKETS)))]
                  + _state_shapes(model_fn=model_fn))
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    rng = np.random.RandomState(seed)
    params = {n: jmx.nd.array(rng.uniform(-0.3, 0.3, s).astype(np.float32))
              for n, s in zip(sym.list_arguments(), arg_shapes)
              if n not in shapes}
    prefix = str(tmp_path / model_fn)
    jmx.model.save_checkpoint(prefix, 0, sym, params, {})
    return prefix


def _load(pkg, prefix):
    _, arg, aux = pkg.model.load_checkpoint(prefix, 0) if pkg is jmx \
        else pkg.model.load_checkpoint(prefix, 0, ctx=pkg.cpu())
    return arg, aux


def _host(params):
    return {k: v.asnumpy() for k, v in params.items()}


def _bucketing_fit(pkg, prefix, plan, num_epoch=1, prepare=False):
    arg, aux = _load(pkg, prefix)
    mod = pkg.mod.BucketingModule(_sym_gen(pkg), default_bucket_key=max(
        BUCKETS), context=pkg.cpu())
    it = _BucketIter(pkg, plan)
    if prepare:
        mod.bind(it.provide_data, it.provide_label)
        mod.init_params(arg_params=arg, aux_params=aux)
        mod.prepare([(k, [("data", (B, k))] + _state_shapes(),
                      [("softmax_label", (B, k))]) for k in BUCKETS])
    ces = []
    mod.fit(it, num_epoch=num_epoch, eval_metric="ce", optimizer="sgd",
            optimizer_params=dict(OPT), arg_params=arg, aux_params=aux,
            batch_end_callback=lambda p: ces.append(
                p.eval_metric.get()[1]))
    return mod, _host(mod.get_params()[0]), ces


def _assert_params_close(got, want, rtol=RTOL, atol=ATOL):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("prepare", [False, True],
                         ids=["lazy-binds", "prepare"])
def test_bucketing_fit_matches_jax(tmp_path, prepare):
    """8 steps over buckets 3/5/7 from the JAX package's checkpoint: the
    parameters and the per-batch cross-entropy of both packages agree."""
    prefix = _checkpoint(tmp_path)
    plan = _plan()
    _, want, want_ce = _bucketing_fit(jmx, prefix, plan, prepare=prepare)
    mod, got, got_ce = _bucketing_fit(tmx, prefix, plan, prepare=prepare)
    _assert_params_close(got, want)
    np.testing.assert_allclose(got_ce, want_ce, rtol=RTOL)
    assert sorted(mod._buckets) == sorted(BUCKETS)


def test_bucket_modules_share_storage_and_the_optimizer(tmp_path):
    prefix = _checkpoint(tmp_path)
    mod, _, _ = _bucketing_fit(tmx, prefix, _plan(n=6))
    default = mod._buckets[max(BUCKETS)]
    others = [m for k, m in mod._buckets.items() if k != max(BUCKETS)]
    for name in default._param_names:
        ptrs = {m._exec_group.execs[0].arg_dict[name]._get().data_ptr()
                for m in mod._buckets.values()}
        gptrs = {m._exec_group.execs[0].grad_dict[name]._get().data_ptr()
                 for m in mod._buckets.values()}
        assert len(ptrs) == 1 and len(gptrs) == 1, name
    for m in others:
        assert m._borrowed_optimizer and m._optimizer is default._optimizer
        assert m._updater is default._updater
        assert m._arg_params is default._arg_params
        assert m._fused is None
    # the shared parent left the fused path when it lent its arrays
    assert default._lent_exec_group and default._fused is None
    assert not default._fusable()
    # one optimizer state per parameter, shared by every bucket
    assert sorted(default._updater.states) == list(
        range(len(default._param_names)))


def test_bucketing_lends_after_fused_steps(tmp_path):
    """A default bucket that took fused steps before a sibling appears
    hands its params and momentum to the classic path (the JAX package
    does the same)."""
    prefix = _checkpoint(tmp_path)
    rng = np.random.RandomState(6)
    plan = [(7, rng.randint(0, V, (B, 7)).astype(np.float32))
            for _ in range(2)] + _plan(n=3, seed=7)
    _, want, _ = _bucketing_fit(jmx, prefix, plan)
    mod, got, _ = _bucketing_fit(tmx, prefix, plan)
    _assert_params_close(got, want)
    default = mod._buckets[7]
    assert default._fused is None and default._lent_exec_group
    # the first three batches are bucket 7's: three fused steps, then
    # bucket 5 binds on the default module and the rest is classic
    assert [k for k, _ in plan[:4]] == [7, 7, 7, 5]
    assert default._fused_t == 3


def _module_fit(pkg, prefix, model_fn, seq_len, batches):
    arg, aux = _load(pkg, prefix)
    sym, data_names, label_names = _sym_gen(pkg, model_fn)(seq_len)
    mod = pkg.mod.Module(sym, data_names=data_names, label_names=label_names,
                         context=pkg.cpu())
    it = _BucketIter(pkg, [(seq_len, ids) for ids in batches],
                     model_fn=model_fn)
    mod.fit(it, num_epoch=1, eval_metric="ce", optimizer="sgd",
            optimizer_params=dict(OPT), arg_params=arg, aux_params=aux)
    return mod, _host(mod.get_params()[0])


@pytest.mark.parametrize("model_fn", ["lstm_unroll", "lstm_unroll_scan",
                                     "gru_unroll"])
def test_fused_module_fit_matches_jax(tmp_path, model_fn):
    """Module.fit at one sequence length, the port on its fused step (run
    eagerly on the CPU), 8 steps against the JAX package."""
    prefix = _checkpoint(tmp_path, model_fn="gru_unroll"
                         if model_fn == "gru_unroll" else "lstm_unroll")
    rng = np.random.RandomState(11)
    batches = [rng.randint(0, V, (B, 7)).astype(np.float32)
               for _ in range(8)]
    _, want = _module_fit(jmx, prefix, model_fn, 7, batches)
    mod, got = _module_fit(tmx, prefix, model_fn, 7, batches)
    assert mod._fused is not None
    assert mod._fused.stats.report()["eager_steps"] == 8
    _assert_params_close(got, want)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_cross_both_ways(tmp_path, writer):
    """A BucketingModule checkpoint written by one package loads in the
    other, in the unrolled and the RNN-op form, with the same outputs."""
    prefix = _checkpoint(tmp_path)
    plan = _plan(n=3, seed=9)
    src = jmx if writer == "jax" else tmx
    dst = tmx if writer == "jax" else jmx
    mod, params, _ = _bucketing_fit(src, prefix, plan)
    out = str(tmp_path / "trained")
    if src is tmx:
        mod.save_checkpoint(out, 1, save_optimizer_states=False)
    else:
        mod.save_checkpoint(out, 1)
    ids = np.random.RandomState(12).randint(0, V, (B, 5)).astype(np.float32)
    outs = []
    for pkg, model_fn in ((src, "lstm_unroll"), (dst, "lstm_unroll"),
                         (dst, "lstm_unroll_scan")):
        _, arg, aux = pkg.model.load_checkpoint(out, 1) if pkg is jmx \
            else pkg.model.load_checkpoint(out, 1, ctx=pkg.cpu())
        np.testing.assert_array_equal(arg["embed_weight"].asnumpy(),
                                      params["embed_weight"])
        sym = getattr(_models(pkg), model_fn)(L, 5, V, H, E, V)
        m = pkg.mod.Module(sym, data_names=["data"] + STATE_NAMES,
                           context=pkg.cpu())
        m.bind([("data", (B, 5))] + _state_shapes(),
               [("softmax_label", (B, 5))], for_training=False)
        m.set_params(arg, aux)
        batch = pkg.io.DataBatch(
            data=[pkg.nd.array(ids, ctx=pkg.cpu())]
            + [pkg.nd.zeros((B, H), ctx=pkg.cpu()) for _ in STATE_NAMES],
            label=[pkg.nd.zeros((B, 5), ctx=pkg.cpu())])
        m.forward(batch, is_train=False)
        outs.append(m.get_outputs()[0].asnumpy())
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(outs[2], outs[0], rtol=1e-4, atol=1e-6)


def test_bucketing_unported_options_raise():
    mod = tmx.mod.BucketingModule(_sym_gen(tmx), default_bucket_key=7,
                                  context=tmx.cpu())
    it = _BucketIter(tmx, _plan(n=1))
    mod.bind(it.provide_data, it.provide_label)
    with pytest.raises(NotImplementedError, match="item 11"):
        mod.precompile({})
    # install_monitor is ported: it installs on every bucket bound so far
    mon = tmx.Monitor(1)
    mod.install_monitor(mon)
    assert mon.exes == [m._exec_group.execs[0]
                        for m in mod._buckets.values()]
    assert all(m._monitor_installed and m._fused is None
               for m in mod._buckets.values())
    assert tmx.mod.BucketingModule is mod.__class__
    assert torch.is_tensor(mod._curr_module._exec_group.execs[0]
                           .arg_dict["embed_weight"]._get())
