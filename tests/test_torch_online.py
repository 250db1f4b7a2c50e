"""mxnet_tpu_torch.online, the continuous-training loop, against the JAX
package's (CPU, small sizes).

The 19 tests of ``tests/test_online.py`` carried to the port: exact
sampling, the SEALED two-step publish, torn-shard quarantine, resume
indexing, the router seam with its reported rate, cursor-exact replay,
cumulative trainer rounds, the gate's decisions and records, embed
freshness, promotion parity under decode traffic, and the chaos-tested
loop bitwise equal to a fault-free run.  Added: shards sealed by either
package replay through the other's ``replay_source`` batch for batch
(``==``), and ``PromotionGate.decide`` and ``freshen_embed`` equal the
JAX package's on the same numpy inputs (``==``).
"""
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import faults, online, serve
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.faults import Backoff, FaultPlan, InjectedFault, Rule
from mxnet_tpu_torch.online import (CaptureWriter, OnlineTrainer,
                                    PromotionGate, UnsealedShardError,
                                    freshen_embed)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clear_plan():
    with mx.cpu():
        yield
    faults.clear()


def _mlp():
    data = mx.sym.Variable("data")
    fc = mx.sym.FullyConnected(data, num_hidden=3, name="fc")
    return mx.sym.SoftmaxOutput(fc, name="softmax")


def _init_params(seed=7):
    rng = np.random.RandomState(seed)
    return {"fc_weight": mx.nd.array(
        rng.uniform(-0.05, 0.05, (3, 6)).astype(np.float32)),
        "fc_bias": mx.nd.zeros((3,))}


def _fill(writer, n=32, seed=0, dim=6, classes=3):
    rng = np.random.RandomState(seed)
    for i in range(n):
        writer.offer(rng.uniform(size=(dim,)).astype(np.float32),
                     np.float32(i % classes))
    writer.flush()


# -- capture -----------------------------------------------------------------

def test_capture_sampling_is_exact_and_deterministic(tmp_path):
    w = CaptureWriter(str(tmp_path), sample=0.25, shard_items=4,
                      fresh=True)
    kept = [w.offer(np.float32(i), np.float32(0)) for i in range(40)]
    w.flush()
    assert sum(kept) == 10                      # exactly rate * offered
    # every-Nth accumulator, not a coin flip: the pattern is periodic
    assert kept[:8] == [False, False, False, True] * 2
    r = w.report()
    assert r["offered"] == 40 and r["kept"] == 10
    assert r["kept_frac"] == 0.25
    assert r["items_sealed"] + r["pending"] == 10


def test_capture_seal_two_step_publish(tmp_path):
    w = CaptureWriter(str(tmp_path), sample=1.0, shard_items=8,
                      fresh=True)
    _fill(w, n=20)
    sealed = online.sealed_shards(str(tmp_path))
    assert [os.path.basename(p) for p in sealed] == [
        "shard-00000000.npz", "shard-00000001.npz", "shard-00000002.npz"]
    for p in sealed:
        assert online.is_sealed(p)
        meta = json.load(open(online.seal_path(p)))
        assert meta["items"] in (8, 4)
    # no tmp wreckage after clean publishes
    assert not [f for f in os.listdir(str(tmp_path)) if ".tmp-" in f]


def test_capture_torn_shard_stays_unsealed_and_writer_dies_loud(tmp_path):
    faults.install(FaultPlan([
        Rule(points="online.capture@seal", kinds="torn", after=1,
             max_faults=1)], seed=3))
    w = CaptureWriter(str(tmp_path), sample=1.0, shard_items=4,
                      fresh=True)
    rng = np.random.RandomState(0)
    with pytest.raises(InjectedFault):
        for i in range(12):
            w.offer(rng.uniform(size=(6,)).astype(np.float32),
                    np.float32(i % 3))
    # shard 0 sealed, shard 1 published-but-torn (no marker)
    sealed = online.sealed_shards(str(tmp_path))
    assert [os.path.basename(p) for p in sealed] == ["shard-00000000.npz"]
    torn = online.shard_path(str(tmp_path), 1)
    assert os.path.exists(torn) and not online.is_sealed(torn)
    # the writer remembers: no further capture, flush re-raises
    with pytest.raises(InjectedFault):
        w.offer(np.zeros(6, np.float32), np.float32(0))
    with pytest.raises(InjectedFault):
        w.flush()
    assert w.report()["errored"]


def test_capture_fresh_vs_resume_indexing(tmp_path):
    w = CaptureWriter(str(tmp_path), sample=1.0, shard_items=4,
                      fresh=True)
    _fill(w, n=8)
    # default: continue past the highest existing index
    w2 = CaptureWriter(str(tmp_path), sample=1.0, shard_items=4)
    _fill(w2, n=4)
    names = [os.path.basename(p)
             for p in online.sealed_shards(str(tmp_path))]
    assert names == ["shard-00000000.npz", "shard-00000001.npz",
                     "shard-00000002.npz"]
    # fresh=True wipes
    w3 = CaptureWriter(str(tmp_path), sample=1.0, shard_items=4,
                       fresh=True)
    assert online.sealed_shards(str(tmp_path)) == []
    _fill(w3, n=4)
    assert [os.path.basename(p) for p in
            online.sealed_shards(str(tmp_path))] == ["shard-00000000.npz"]


def test_capture_transform_shapes_the_label(tmp_path):
    w = CaptureWriter(str(tmp_path), sample=1.0, shard_items=4,
                      fresh=True,
                      transform=lambda d, o: (d, np.argmax(o)))
    for i in range(4):
        scores = np.eye(3, dtype=np.float32)[i % 3]
        w.offer(np.zeros(6, np.float32), scores)
    w.flush()
    _data, label = online.load_shard(
        online.sealed_shards(str(tmp_path))[0])
    assert label.tolist() == [0, 1, 2, 0]


# -- replay ------------------------------------------------------------------

def test_replay_refuses_unsealed_shard(tmp_path):
    w = CaptureWriter(str(tmp_path), sample=1.0, shard_items=4,
                      fresh=True)
    _fill(w, n=8)
    victim = online.sealed_shards(str(tmp_path))[1]
    os.unlink(online.seal_path(victim))         # simulate a torn tail
    with pytest.raises(UnsealedShardError):
        online.load_shard(victim)
    # the listing never offers it, so the pipeline trains on shard 0 only
    it = online.replay_pipeline(str(tmp_path), batch_size=4)
    batches = 0
    try:
        while True:
            it.next()
            batches += 1
    except StopIteration:
        pass
    it.close()
    assert batches == 1


def test_replay_restore_is_cursor_exact(tmp_path):
    w = CaptureWriter(str(tmp_path), sample=1.0, shard_items=8,
                      fresh=True)
    _fill(w, n=24)
    it = online.replay_pipeline(str(tmp_path), batch_size=4)
    first = [it.next() for _ in range(3)]
    st = it.state()
    expect = it.next()
    it.close()
    it2 = online.replay_pipeline(str(tmp_path), batch_size=4)
    it2.restore(st)
    got = it2.next()
    it2.close()
    assert np.array_equal(expect.data[0].asnumpy(),
                          got.data[0].asnumpy())
    assert np.array_equal(expect.label[0].asnumpy(),
                          got.label[0].asnumpy())
    assert first[0].data[0].shape == (4, 6)


def test_replay_snapshot_is_pinned_at_construction(tmp_path):
    w = CaptureWriter(str(tmp_path), sample=1.0, shard_items=4,
                      fresh=True)
    _fill(w, n=8)
    factory, n_items = online.replay_source(str(tmp_path))
    assert n_items == 8
    # shards sealed AFTER the snapshot belong to the next round
    _fill(CaptureWriter(str(tmp_path), sample=1.0, shard_items=4), n=4)
    assert sum(1 for _ in factory()) == 8
    assert len(online.sealed_shards(str(tmp_path))) == 3


# -- router capture seam -----------------------------------------------------

def test_router_capture_rate_verifiable_from_reports(tmp_path):
    net, init = _mlp(), _init_params()
    w = CaptureWriter(str(tmp_path), sample=0.5, shard_items=8,
                      fresh=True,
                      transform=lambda d, o: (d, np.argmax(o)))

    def factory(i):
        return serve.ServeEngine(net, dict(init), {"data": (4, 6)},
                                 name="cap-rep%d" % i, warmup=False,
                                 dev_type="cpu")
    router = serve.ServeRouter(factory, replicas=2, capture=w,
                               name="cap-router")
    try:
        rng = np.random.RandomState(1)
        for i in range(40):   # closed loop: completion order = offer order
            router.submit(
                rng.uniform(size=(6,)).astype(np.float32)).result(
                timeout=30)
        router.capture_sync(timeout=30)
        rep = router.stats.report()
        assert rep["completed"] == 40
        assert rep["captured"] == 20 and rep["capture_errors"] == 0
        assert rep["capture_rate"] == pytest.approx(0.5)
        # mirrored onto the engines: sum of per-replica captured
        eng_captured = sum(row["engine"]["captured"]
                           for row in rep["per_replica"].values())
        assert eng_captured == 20
    finally:
        router.close()
    w.flush()
    assert w.report()["kept"] == 20
    assert sum(json.load(open(online.seal_path(p)))["items"]
               for p in online.sealed_shards(str(tmp_path))) == 20


def test_router_capture_failure_never_reaches_clients(tmp_path):
    net, init = _mlp(), _init_params()
    faults.install(FaultPlan([
        Rule(points="online.capture@seal", kinds="torn",
             max_faults=1)], seed=5))
    w = CaptureWriter(str(tmp_path), sample=1.0, shard_items=2,
                      fresh=True)

    def factory(i):
        return serve.ServeEngine(net, dict(init), {"data": (4, 6)},
                                 name="swallow-rep%d" % i, warmup=False,
                                 dev_type="cpu")
    router = serve.ServeRouter(factory, replicas=1, capture=w,
                               name="swallow-router")
    try:
        rng = np.random.RandomState(2)
        for _ in range(8):    # every request succeeds for the client
            router.submit(
                rng.uniform(size=(6,)).astype(np.float32)).result(
                timeout=30)
        router.capture_sync(timeout=30)
        rep = router.stats.report()
        assert rep["completed"] == 8
        assert rep["capture_errors"] >= 1
    finally:
        router.close()
    with pytest.raises(InjectedFault):   # ...but the loop dies loud
        w.flush()


# -- trainer -----------------------------------------------------------------

def test_trainer_rounds_resume_and_reenter_idempotently(tmp_path):
    cap, ck = str(tmp_path / "cap"), str(tmp_path / "ck")
    w = CaptureWriter(cap, sample=1.0, shard_items=8, fresh=True)
    _fill(w, n=32)
    tr = OnlineTrainer(_mlp(), cap, ck, batch_size=8,
                       optimizer_params=(("learning_rate", 0.05),),
                       arg_params=_init_params())
    r1 = tr.round(num_epoch=2)
    assert r1["step"] == 8                      # 4 batches * 2 epochs
    # re-entering a finished round is a no-op (crash-restart shape)
    assert tr.round(num_epoch=2)["step"] == 8
    assert tr.round(num_epoch=3)["step"] == 12
    rep = tr.report()
    assert rep["rounds"] == 3 and rep["last_step"] == 12


def test_trainer_empty_capture_fails_loud(tmp_path):
    cap, ck = str(tmp_path / "cap"), str(tmp_path / "ck")
    os.makedirs(cap)
    tr = OnlineTrainer(_mlp(), cap, ck, batch_size=8,
                       arg_params=_init_params())
    with pytest.raises(MXNetError, match="no sealed capture shards"):
        tr.round(num_epoch=1)


# -- gate / promote ----------------------------------------------------------

def test_gate_decides_with_reasons():
    y = np.array([0, 1, 2, 0, 1, 2, 0, 1])
    right = np.eye(3, dtype=np.float32)[y]          # 100% correct
    wrong = np.eye(3, dtype=np.float32)[(y + 1) % 3]
    gate = PromotionGate(min_improve=0.0, max_drift=1.0)
    up = gate.decide(wrong, right, y)
    assert up["promote"] and up["improvement"] == 1.0
    down = gate.decide(right, wrong, y)
    assert not down["promote"]
    assert any("PROMOTE_MIN" in r for r in down["reasons"])
    drifty = PromotionGate(min_improve=-1.0, max_drift=0.5)
    d = drifty.decide(right, wrong, y)
    assert not d["promote"] and any("MAX_DRIFT" in r for r in d["reasons"])
    assert d["drift"] == 1.0
    rep = gate.report()
    assert rep["decisions"] == 2
    assert rep["promoted"] == 1 and rep["quarantined"] == 1


def test_gate_env_knobs(monkeypatch):
    monkeypatch.setenv("MXNET_ONLINE_PROMOTE_MIN", "0.25")
    monkeypatch.setenv("MXNET_ONLINE_MAX_DRIFT", "0.75")
    gate = PromotionGate()
    assert gate.min_improve == 0.25 and gate.max_drift == 0.75


def test_quarantine_writes_reasoned_record(tmp_path):
    dec = {"promote": False, "reasons": ["improvement -0.2 < 0.0"],
           "improvement": -0.2, "drift": 0.1}
    online.quarantine(str(tmp_path), dec)
    rec = online.read_record(str(tmp_path), online.QUARANTINED_RECORD)
    assert rec["action"] == "quarantine"
    assert rec["decision"]["reasons"] == dec["reasons"]


def test_freshen_embed_carries_live_tail_rows():
    cand = {"embed_weight": np.ones((4, 3), np.float32),
            "fc_weight": np.zeros((2, 2), np.float32)}
    live = {"embed_weight": np.concatenate(
        [np.full((4, 3), 2.0, np.float32),
         np.full((2, 3), 7.0, np.float32)]),
        "fc_weight": np.full((2, 2), 9.0, np.float32)}
    out = freshen_embed(cand, live)
    assert out["embed_weight"].shape == (6, 3)
    # candidate's trained rows win; live's NEW rows carry forward
    assert (out["embed_weight"][:4] == 1.0).all()
    assert (out["embed_weight"][4:] == 7.0).all()
    assert (out["fc_weight"] == 0.0).all()      # same shape: untouched
    with pytest.raises(MXNetError, match="missing"):
        freshen_embed(cand, live, keys=["nope"])


def test_gate_journal_context_rides_the_decision(tmp_path, monkeypatch):
    from mxnet_tpu_torch.trace import journal
    path = str(tmp_path / "run.jsonl")
    monkeypatch.setenv("MXNET_TRACE_JOURNAL", path)
    journal.write_journal_line(path, 100)
    journal.write_journal_line(path, 150)
    gate = PromotionGate(min_improve=-1.0, max_drift=1.0)
    y = np.array([0, 1])
    dec = gate.decide(np.eye(3)[y], np.eye(3)[y], y)
    assert dec["journal"]["last_step"] == 150
    assert dec["journal"]["step_delta"] == 50


# -- promotion parity under concurrent DecodeEngine traffic ------------------

_VOCAB, _EMB, _HID = 11, 6, 8


def _decode_symbol():
    """One recurrent decode step (test_decode.py idiom): tok -> embed;
    h' = tanh(W_ih e + W_hh h); outputs [logits, h']."""
    tok = mx.sym.Variable("data")
    h = mx.sym.Variable("h")
    emb = mx.sym.Embedding(tok, input_dim=_VOCAB, output_dim=_EMB,
                           name="emb")
    emb = mx.sym.Flatten(emb)
    z = mx.sym.FullyConnected(emb, num_hidden=_HID, name="ih") + \
        mx.sym.FullyConnected(h, num_hidden=_HID, name="hh")
    h_next = mx.sym.Activation(z, act_type="tanh")
    logits = mx.sym.FullyConnected(h_next, num_hidden=_VOCAB, name="out")
    return mx.sym.Group([logits, h_next])


def _decode_params(seed):
    rng = np.random.RandomState(seed)

    def g(*s):
        return (rng.randn(*s) * 0.5).astype(np.float32)

    return {"emb_weight": g(_VOCAB, _EMB),
            "ih_weight": g(_HID, _EMB),
            "ih_bias": np.zeros(_HID, np.float32),
            "hh_weight": g(_HID, _HID),
            "hh_bias": np.zeros(_HID, np.float32),
            "out_weight": g(_VOCAB, _HID),
            "out_bias": np.zeros(_VOCAB, np.float32)}


def _tokens(engine, prompt, n=6):
    return [int(t) for t in
            engine.submit(np.asarray(prompt, np.int32),
                          max_new_tokens=n).result(timeout=60)]


@pytest.mark.filterwarnings("ignore::DeprecationWarning")
def test_rolling_restart_promotion_parity_under_decode_traffic():
    """Satellite: in-flight streams finish on the weights they started
    with; post-promotion streams are token-exact vs a fresh engine on
    the new weights — across a ROUTER promotion, with traffic running
    throughout."""
    sym = _decode_symbol()
    params_a, params_b = _decode_params(1), _decode_params(2)
    kw = dict(state_shapes={"h": (_HID,)}, num_slots=4,
              max_new_tokens=8, warmup=False, dev_type="cpu")

    ref_a = serve.DecodeEngine(sym, params_a, name="ref-a", **kw)
    ref_b = serve.DecodeEngine(sym, params_b, name="ref-b", **kw)
    prompts = [[1, 2], [3], [2, 4, 1], [0, 3]]
    try:
        want_a = [_tokens(ref_a, p) for p in prompts]
        want_b = [_tokens(ref_b, p) for p in prompts]
        assert want_a != want_b      # the promotion is observable
    finally:
        ref_a.close()
        ref_b.close()

    router = serve.ServeRouter(
        lambda i: serve.DecodeEngine(sym, dict(params_a),
                                     name="par-rep%d" % i, **kw),
        replicas=2, name="parity-router")
    stop = threading.Event()
    background = {"done": 0, "failed": 0}

    def traffic():
        k = 0
        while not stop.is_set():
            try:
                router.submit(np.asarray(prompts[k % 4], np.int32),
                              max_new_tokens=4).result(timeout=60)
                background["done"] += 1
            except Exception:
                background["failed"] += 1
            k += 1
    t = threading.Thread(target=traffic, name="parity-traffic")
    t.start()
    try:
        # in-flight across the swap: submitted before, read after
        inflight = [router.submit(np.asarray(p, np.int32),
                                  max_new_tokens=6)
                    for p in prompts]
        router.rolling_restart(reload=params_b, timeout=120)
        got_inflight = [[int(x) for x in f.result(timeout=60)]
                        for f in inflight]
        # streams admitted before the drain finished under SOME single
        # weights version — old or new, never a mix
        for got, a, b in zip(got_inflight, want_a, want_b):
            assert got == a or got == b
        got_after = [_tokens(router, p) for p in prompts]
        assert got_after == want_b
    finally:
        stop.set()
        t.join(timeout=60)
        router.close()
    assert background["failed"] == 0 and background["done"] > 0


# -- THE acceptance: the whole loop, chaos-tested, bitwise -------------------

_CHAOS_LOOP = """
import json, os, sys, threading
sys.path.insert(0, %(root)r)
import numpy as np
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import faults, online, serve
from mxnet_tpu_torch.base import atomic_local_write

cap_dir, ck_dir, markers, out_path = sys.argv[1:5]
chaos = len(sys.argv) > 5 and sys.argv[5] == "chaos"
mx.cpu().__enter__()     # the whole loop on the host

def once(name):
    try:
        os.close(os.open(os.path.join(markers, name),
                         os.O_CREAT | os.O_EXCL | os.O_WRONLY))
        return True
    except FileExistsError:
        return False

if chaos:
    faults.install(faults.FaultPlan([
        # attempt 0: tear the second shard between publish and SEALED —
        # the flood finishes (clients never fail) but flush dies loud
        faults.Rule(points="online.capture@seal", kinds="torn",
                    attempts=[0], after=1, max_faults=1),
        # attempt 1: SIGKILL the training worker mid-commit-protocol
        faults.Rule(points="checkpoint.commit@after_rename",
                    kinds="crash", attempts=[1], max_faults=1),
        # attempt 2: crash mid-promotion (candidate loaded, restart
        # not yet begun) — the re-run re-gates and re-lands
        faults.Rule(points="online.promote@restart", kinds="crash",
                    attempts=[2], max_faults=1),
    ], seed=11))

mx.random.seed(123)
net = mx.sym.SoftmaxOutput(
    mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=3,
                          name="fc"), name="softmax")
init = {"fc_weight": mx.nd.array(
    np.random.RandomState(7).uniform(-0.05, 0.05, (3, 6))
    .astype(np.float32)), "fc_bias": mx.nd.zeros((3,))}

def factory(i):
    return serve.ServeEngine(net, dict(init), {"data": (4, 6)},
                             name="loop-rep%%d" %% i, warmup=False,
                             dev_type="cpu")

# -- phase 1: live router flood feeds capture (exactly once on disk) --------
if not os.path.exists(os.path.join(markers, "capture_done")):
    writer = online.CaptureWriter(
        cap_dir, sample=0.5, shard_items=8, fresh=True,
        transform=lambda d, o: (d, np.argmax(o)))
    router = serve.ServeRouter(factory, replicas=2, capture=writer,
                               name="loop-capture")
    flood = np.random.RandomState(5).uniform(
        size=(64, 6)).astype(np.float32)
    try:
        # closed loop: completion (= capture) order is submission order,
        # so a re-capture after a torn attempt reproduces the shards
        for i in range(64):
            router.submit(flood[i]).result(timeout=60)
    finally:
        router.close()
    writer.flush()          # raises if a shard tore -> restart, re-capture
    once("capture_done")

# -- phase 2: supervised fine-tune (cumulative target: idempotent) ----------
shards = online.sealed_shards(cap_dir)
assert len(shards) == 4, shards
trainer = online.OnlineTrainer(
    net, cap_dir, ck_dir, batch_size=8, optimizer="sgd",
    optimizer_params=(("learning_rate", 0.05), ("momentum", 0.9)),
    arg_params=init, checkpoint_every=3, context=mx.cpu(0))
cand = trainer.round(num_epoch=2, shards=shards)

# -- phase 3: gated promotion under live traffic, zero drops ----------------
hold = np.random.RandomState(9).uniform(size=(16, 6)).astype(np.float32)
hold_y = np.random.RandomState(10).randint(0, 3, 16)
router = serve.ServeRouter(factory, replicas=2, name="loop-promote")
try:
    live_scores = np.stack([
        np.asarray(router.submit(hold[i]).result(timeout=60))
        for i in range(16)])
    cand_engine = serve.ServeEngine.from_checkpoint_dir(
        ck_dir, net, {"data": (4, 6)}, warmup=False, name="loop-cand",
        dev_type="cpu")
    try:
        cand_scores = np.stack([
            np.asarray(cand_engine.submit(hold[i]).result(timeout=60))
            for i in range(16)])
    finally:
        cand_engine.close()
    gate = online.PromotionGate(min_improve=-1.0, max_drift=1.0)
    decision = gate.decide(live_scores, cand_scores, hold_y)
    assert decision["promote"], decision

    stop = threading.Event()
    drops = {"n": 0, "done": 0}
    def traffic():
        k = 0
        while not stop.is_set():
            try:
                router.submit(hold[k %% 16]).result(timeout=60)
                drops["done"] += 1
            except Exception:
                drops["n"] += 1
            k += 1
    t = threading.Thread(target=traffic, name="promote-traffic")
    t.start()
    try:
        record = gate.apply(decision, router, ck_dir, timeout=120)
    finally:
        stop.set()
        t.join(timeout=60)
    post = np.stack([
        np.asarray(router.submit(hold[i]).result(timeout=60))
        for i in range(16)])
finally:
    router.close()
assert np.allclose(post, cand_scores, atol=1e-5)

with atomic_local_write(out_path, "w") as f:
    json.dump({"dropped": drops["n"], "served": drops["done"],
               "step": record["step"], "decision": decision,
               "shards": [os.path.basename(s) for s in shards]}, f)
sys.exit(0)
"""


def _tree_equal(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            _tree_equal(a[k], b[k], path + "/" + str(k))
        return
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _tree_equal(x, y, "%s[%d]" % (path, i))
        return
    if a is None:
        assert b is None, path
        return
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                  err_msg=path)


def test_chaos_online_loop_is_bitwise(tmp_path):
    """The acceptance scenario: serve -> capture -> fine-tune
    -> gated promotion, supervised, under a schedule that tears a
    capture shard (attempt 0), SIGKILLs the trainer mid-commit
    (attempt 1) and crashes mid-promotion (attempt 2) — zero dropped
    requests, and the promoted checkpoint bitwise equal to the
    fault-free run."""
    from mxnet_tpu_torch import checkpoint as ck
    script = tmp_path / "loop_child.py"
    script.write_text(_CHAOS_LOOP % {"root": ROOT})
    env = dict(os.environ)
    env.pop("MXNET_FAULTS", None)

    # fault-free reference (same seeds, fresh process)
    ref = {k: str(tmp_path / ("ref_" + k)) for k in ("cap", "ck", "mk")}
    for d in ref.values():
        os.makedirs(d)
    ref_out = str(tmp_path / "ref.json")
    res = subprocess.run(
        [sys.executable, str(script), ref["cap"], ref["ck"], ref["mk"],
         ref_out], env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr

    # chaos run under the supervisor
    cha = {k: str(tmp_path / ("cha_" + k)) for k in ("cap", "ck", "mk")}
    for d in cha.values():
        os.makedirs(d)
    cha_out = str(tmp_path / "cha.json")
    sup = faults.Supervisor(
        [sys.executable, str(script), cha["cap"], cha["ck"], cha["mk"],
         cha_out, "chaos"],
        max_restarts=4, backoff=Backoff(base_s=0.05, jitter=0.0),
        timeout_s=240.0, checkpoint_dir=cha["ck"],
        name="chaos-online")
    assert sup.run() == 0
    r = sup.stats.report()
    # torn capture, SIGKILL mid-commit, crash mid-promotion, then clean
    assert r["restarts"] == 3, r

    ref_doc = json.load(open(ref_out))
    cha_doc = json.load(open(cha_out))
    assert ref_doc["dropped"] == 0 and cha_doc["dropped"] == 0
    assert cha_doc["served"] >= 0 and ref_doc["step"] == cha_doc["step"]
    assert ref_doc["shards"] == cha_doc["shards"]

    # identical capture shards (torn attempt recaptured cleanly) ...
    for name in ref_doc["shards"]:
        a = open(os.path.join(ref["cap"], name), "rb").read()
        b = open(os.path.join(cha["cap"], name), "rb").read()
        assert a == b, "capture shard %s diverged" % name

    # ... and a bitwise-identical promoted train state
    ref_mgr = ck.CheckpointManager(ref["ck"], keep_last_n=None)
    cha_mgr = ck.CheckpointManager(cha["ck"], keep_last_n=None)
    try:
        assert ref_mgr.latest_step() == cha_mgr.latest_step() == \
            ref_doc["step"]
        ref_tree, ref_meta = ref_mgr.restore()
        cha_tree, cha_meta = cha_mgr.restore()
        _tree_equal(ref_tree, cha_tree)
        for k in ("global_step", "epoch", "nbatch"):
            assert ref_meta.get(k) == cha_meta.get(k), k
    finally:
        ref_mgr.close()
        cha_mgr.close()
    for d in (ref["ck"], cha["ck"]):
        rec = online.read_record(d, online.PROMOTED_RECORD)
        assert rec["action"] == "promote"
        assert rec["step"] == ref_doc["step"]


# -- added: the two packages' files and decisions ----------------------------

def _jax_online():
    from mxnet_tpu import online as jonline
    return jonline


def _batches(it):
    out = []
    try:
        while True:
            b = it.next()
            out.append((b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad))
    except StopIteration:
        pass
    it.close()
    return out


@pytest.mark.parametrize("sealer", ["jax", "torch"])
def test_shards_sealed_by_either_package_replay_in_the_other(tmp_path,
                                                             sealer):
    jonline = _jax_online()
    w_pkg, r_pkg = (jonline, online) if sealer == "jax" \
        else (online, jonline)
    d = str(tmp_path / "cap")
    w = w_pkg.CaptureWriter(d, sample=0.75, shard_items=5, fresh=True,
                            transform=lambda x, o: (x, np.argmax(o)))
    rng = np.random.RandomState(4)
    for i in range(23):
        w.offer(rng.uniform(size=(6,)).astype(np.float32),
                np.eye(3, dtype=np.float32)[i % 3])
    w.flush()
    shards = r_pkg.sealed_shards(d)
    assert shards == w_pkg.sealed_shards(d) and len(shards) == 4
    fr, nr = r_pkg.replay_source(d)
    fw, nw = w_pkg.replay_source(d)
    assert nr == nw == 17
    got, want = list(fr()), list(fw())
    assert len(got) == len(want)
    for (a, la), (b, lb) in zip(got, want):
        assert np.array_equal(a, b) and a.dtype == b.dtype
        assert np.array_equal(la, lb) and la.dtype == lb.dtype
    for p in shards:
        assert json.load(open(r_pkg.seal_path(p))) == \
            json.load(open(w_pkg.seal_path(p)))
    # the port's pipeline over the other package's shards, batch for batch
    it = online.replay_pipeline(d, batch_size=4)
    flat = np.stack([x for x, _ in want])
    labels = np.stack([lab for _, lab in want]).astype(np.float32)
    for i, (x, lab, pad) in enumerate(_batches(it)):
        n = 4 - pad
        assert np.array_equal(x[:n], flat[4 * i:4 * i + n])
        assert np.array_equal(lab[:n].reshape(-1),
                              labels[4 * i:4 * i + n].reshape(-1))


@pytest.mark.parametrize("min_improve,max_drift", [
    (0.0, 1.0), (0.05, 1.0), (-1.0, 0.3), (0.2, 0.2)])
def test_gate_decides_as_the_reference(min_improve, max_drift):
    jonline = _jax_online()
    rng = np.random.RandomState(11)
    live = rng.randn(40, 5).astype(np.float32)
    cand = live + rng.randn(40, 5).astype(np.float32) * 0.8
    y = rng.randint(0, 5, 40)
    got = PromotionGate(min_improve, max_drift).decide(live, cand, y)
    want = jonline.PromotionGate(min_improve, max_drift).decide(
        live, cand, y)
    assert got == want


def test_freshen_embed_equals_the_references():
    jonline = _jax_online()
    rng = np.random.RandomState(2)
    cand = {"embed_weight": rng.randn(5, 4).astype(np.float32),
            "other_weight": rng.randn(3, 4).astype(np.float32),
            "bias": rng.randn(4).astype(np.float32)}
    live = {"embed_weight": rng.randn(9, 4).astype(np.float32),
            "other_weight": rng.randn(2, 4).astype(np.float32),
            "bias": rng.randn(4).astype(np.float32)}
    for keys in (None, ["embed_weight"]):
        got = freshen_embed(cand, live, keys=keys)
        want = jonline.freshen_embed(cand, live, keys=keys)
        assert sorted(got) == sorted(want)
        for k in want:
            assert np.array_equal(np.asarray(got[k]), np.asarray(want[k]))
