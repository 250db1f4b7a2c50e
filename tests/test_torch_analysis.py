"""mxnet_tpu_torch.analysis: the port's lint rules, lock-order recorder
and leak guard, with ``tests/test_lint.py``'s tests carried over (the
fixtures of the rewritten rules in PyTorch idiom), and:

* cross-linter parity: on the same fixtures the kept rules (raw-env,
  raw-time, unseeded-fork-rng, raw-future-settle, raw-retry,
  unsealed-replay) report the JAX linter's ``(rule, line)``;
* the full-tree lint: ``python -m mxnet_tpu_torch.analysis`` over
  ``mxnet_tpu_torch/`` exits 0 with an empty baseline;
* zero cycles in the real tree: the port's serve batcher with 4 client
  threads, the feed's staged pipeline, a checkpoint save and a trace
  dump run in one process with the recorder armed;
* the port's guard fails a leaky module (a pytest subprocess with
  ``-p mxnet_tpu_torch.analysis.pytest_plugin``).
"""
import os
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from mxnet_tpu.analysis import linter as jax_linter  # noqa: E402
from mxnet_tpu_torch.analysis import linter  # noqa: E402
from mxnet_tpu_torch.analysis import leakguard, lockcheck  # noqa: E402
from mxnet_tpu_torch.analysis.pytest_plugin import (  # noqa: E402,F401
    _mxnet_analysis_guard)

LINT = [sys.executable, "-m", "mxnet_tpu_torch.analysis"]


def _rules_hit(source, rel="mxnet_tpu_torch/serve/somefile.py"):
    return {f.rule for f in linter.lint_source(textwrap.dedent(source),
                                               rel)}


# ---------------------------------------------------------------------------
# one synthetic fixture per rule: the distilled historical bug must be
# caught, the fixed form must be silent

# a CUDA graph captured outside compile_cache races other threads'
# captures (the device's capture lock) and hides from the compile report
BAD_JIT = """
    import torch

    def build_step(fn, static):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fn(static)
        return graph, out
"""
GOOD_JIT = """
    from ..compile_cache import capture

    def build_step(fn, static, device):
        return capture(device, lambda: fn(static))
"""

# the process-group boot is single-owner (dist.boot): a raw
# init_process_group elsewhere boots the wrong backend or dies on "trying
# to initialize the default process group twice"
BAD_DIST_INIT = """
    import torch.distributed as dist

    def join_cluster(addr, world, rank):
        dist.init_process_group("gloo", init_method=addr,
                                world_size=world, rank=rank)
"""
GOOD_DIST_INIT = """
    from ..dist import boot

    def join_cluster(coordinator, nprocs, rank):
        boot.initialize(coordinator, nprocs, rank)
"""

# PR 6 convention: env reads go through base.get_env
BAD_ENV = """
    import os

    def workers():
        return int(os.environ.get("MXNET_FEED_WORKERS", "0") or "0")
"""
GOOD_ENV = """
    from ..base import get_env

    def workers():
        return get_env("MXNET_FEED_WORKERS", 0, int)
"""

# PR 3's Speedometer bug: wall clock in rate arithmetic steps under NTP
BAD_TIME = """
    import time

    def rate(count):
        start = time.time()
        do_work()
        return count / (time.time() - start)
"""
GOOD_TIME = """
    import time

    def rate(count):
        start = time.perf_counter()
        do_work()
        return count / (time.perf_counter() - start)
"""

# PR 6's decorrelation bug: forked workers inherit one global RNG state
BAD_RNG = """
    import numpy as np

    def random_crop(img, out_h, out_w):
        y = np.random.randint(0, img.shape[0] - out_h)
        return img[y:y + out_h, :out_w]
"""
GOOD_RNG = """
    import numpy as np

    def random_crop(img, out_h, out_w, rng):
        y = rng.integers(0, img.shape[0] - out_h)
        return img[y:y + out_h, :out_w]
"""

# PR 4 review round 2: raw settle on a client-cancelled future raises
# InvalidStateError and kills the worker thread
BAD_FUTURE = """
    def resolve(requests, outs):
        for req, out in zip(requests, outs):
            req.future.set_result(out)
"""
GOOD_FUTURE = """
    def _set_result(fut, value):
        try:
            fut.set_result(value)
        except Exception:
            pass

    def resolve(requests, outs):
        for req, out in zip(requests, outs):
            _set_result(req.future, out)
"""

# PR 15: MXNET_FEED_MAX_RESTARTS allowed back-to-back instant reforks —
# a crash-looping decode bug hot-spun the fork path; the distilled form
# is any loop that both sleeps and swallows the failure
BAD_RETRY = """
    import time

    def fetch_with_retry(url):
        while True:
            try:
                return fetch(url)
            except ConnectionError:
                pass
            time.sleep(0.5)
"""
GOOD_RETRY = """
    from ..faults import Backoff, retry_call

    def fetch_with_retry(url):
        return retry_call(fetch, url, retries=5,
                          backoff=Backoff(base_s=0.5),
                          retry_on=(ConnectionError,))
"""
# a poll loop sleeps without swallowing anything: not a retry loop
GOOD_POLL = """
    import time

    def wait_until(pred, stop):
        while not pred():
            if stop.is_set():
                raise TimeoutError("stopped")
            time.sleep(0.01)
"""

# PR 16: the paged engine budgets ONE host sync per step; an
# asarray/.item()/.cpu()/.tolist()/float()/synchronize inside the
# per-token loop serializes a device->host pull once per token
BAD_HOST_SYNC = """
    import numpy as np
    import torch

    def decode(engine, prompt, max_new):
        out = []
        for _ in range(max_new):
            logits = engine.decode_step(prompt)
            tok = int(logits.argmax().cpu())
            score = float(logits.max())
            torch.cuda.synchronize()
            out.append(tok)
        return out
"""
GOOD_HOST_SYNC = """
    import torch

    def decode(engine, prompt, max_new):
        toks = []
        for _ in range(max_new):
            toks.append(engine.decode_step(prompt).argmax())
        return torch.stack(toks).tolist()
"""

# PR 17: capture shards publish in two atomic steps (shard file, then
# SEALED marker); a replay reader that loads without gating on the
# marker trains on torn or in-progress tails
BAD_UNSEALED = """
    import numpy as np

    def read_shards(directory, names):
        out = []
        for name in names:
            if name.startswith("shard-"):
                z = np.load(directory + "/" + name)
                out.append(z["data"])
        return out
"""
GOOD_UNSEALED = """
    import numpy as np
    from mxnet_tpu_torch.online.capture import is_sealed

    def read_shards(directory, names):
        out = []
        for name in names:
            path = directory + "/" + name
            if name.startswith("shard-") and is_sealed(path):
                z = np.load(path)
                out.append(z["data"])
        return out
"""

# ISSUE 19: a raw scatter-add onto the expert buffer lands out-of-range
# slots on live rows (the PR 12 pad-bug class); the dispatch choke point
# folds overflow to a dropped sentinel instead
BAD_MOE_SCATTER = """
    def accumulate(buf, slots, rows):
        return buf.index_add_(0, slots, rows)
"""
GOOD_MOE_SCATTER = """
    from mxnet_tpu_torch.moe.dispatch import dispatch

    def accumulate(x, slots, num_experts, capacity):
        return dispatch(x, slots, num_experts, capacity)
"""

# a kernel library built or loaded outside ops/cuda_kernels has no plain
# version checking it and no launch count
BAD_PALLAS = """
    import ctypes
    import subprocess

    def scale_op(src, lib):
        subprocess.run(["nvcc", "-shared", "-o", lib, src], check=True)
        return ctypes.CDLL(lib)
"""
GOOD_PALLAS = """
    from mxnet_tpu_torch.ops.cuda_kernels import flash_attention

    def attend(q, k, v):
        return flash_attention(q, k, v, causal=True)
"""

FIXTURES = [
    ("raw-jit", BAD_JIT, GOOD_JIT),
    ("raw-dist-init", BAD_DIST_INIT, GOOD_DIST_INIT),
    ("raw-env", BAD_ENV, GOOD_ENV),
    ("raw-time", BAD_TIME, GOOD_TIME),
    ("unseeded-fork-rng", BAD_RNG, GOOD_RNG),
    ("raw-future-settle", BAD_FUTURE, GOOD_FUTURE),
    ("raw-retry", BAD_RETRY, GOOD_RETRY),
    ("decode-host-sync", BAD_HOST_SYNC, GOOD_HOST_SYNC),
    ("unsealed-replay", BAD_UNSEALED, GOOD_UNSEALED),
    ("moe-raw-scatter", BAD_MOE_SCATTER, GOOD_MOE_SCATTER),
    ("raw-pallas-call", BAD_PALLAS, GOOD_PALLAS),
]
# the rules kept as the JAX package has them
KEPT = ("raw-env", "raw-time", "unseeded-fork-rng", "raw-future-settle",
        "raw-retry", "unsealed-replay")


def test_raw_pallas_call_scope():
    """ops/cuda_kernels OWNS shipped kernels (exempt by path); the rtc
    user-kernel passthrough suppresses inline with a reason; anywhere
    else the same build or load is a violation, and so is
    torch.utils.cpp_extension."""
    assert "raw-pallas-call" not in _rules_hit(
        BAD_PALLAS, rel="mxnet_tpu_torch/ops/cuda_kernels.py")
    assert "raw-pallas-call" in _rules_hit(
        BAD_PALLAS, rel="mxnet_tpu_torch/serve/engine.py")
    suppressed = """
        import ctypes

        def passthrough(path):
            # lint: allow(raw-pallas-call) — user-kernel passthrough
            return ctypes.CDLL(path)
    """
    assert "raw-pallas-call" not in _rules_hit(suppressed)
    ext = """
        from torch.utils.cpp_extension import load_inline

        def build(src):
            return load_inline("k", cpp_sources=[src])
    """
    assert "raw-pallas-call" in _rules_hit(ext)
    # a type annotation names the class without loading anything
    assert "raw-pallas-call" not in _rules_hit("""
        import ctypes
        from typing import Dict

        LIBS: Dict[str, ctypes.CDLL] = {}
    """)


def test_moe_raw_scatter_scope():
    """The choke paths themselves are exempt; scatter_add_ and
    index_put_(accumulate=True) count as scatter-accumulates; a plain
    index_put_ or index_copy_ (paged KV writes, slot zeroing) is not an
    accumulate and stays legal."""
    assert "moe-raw-scatter" not in _rules_hit(
        BAD_MOE_SCATTER, rel="mxnet_tpu_torch/moe/dispatch.py")
    assert "moe-raw-scatter" not in _rules_hit(
        BAD_MOE_SCATTER, rel="mxnet_tpu_torch/embed/sparse.py")
    for acc in ("out.scatter_add_(0, idx, g)",
                "out.index_put_((idx,), g, accumulate=True)",
                "out.scatter_reduce(0, idx, g, reduce='sum')"):
        assert "moe-raw-scatter" in _rules_hit(
            "def fold(out, idx, g):\n    return %s\n" % acc)
    for plain in ("buf.index_put_((blk, off), row)",
                  "buf.index_put_((blk, off), row, accumulate=False)",
                  "buf.index_copy_(0, blk, row)"):
        assert "moe-raw-scatter" not in _rules_hit(
            "def write_kv(buf, blk, off, row):\n    return %s\n" % plain)


def test_unsealed_replay_scope():
    """Only shard-touching readers count: a checkpoint .npy read with
    no shard naming anywhere is not flagged, and a reader that
    iterates sealed_shards() is gated by construction."""
    plain_npy = """
        import numpy as np

        def read_leaf(path, dtype):
            arr = np.load(path)
            return arr.astype(dtype)
    """
    assert "unsealed-replay" not in _rules_hit(plain_npy)
    via_listing = """
        import numpy as np
        from mxnet_tpu_torch.online.capture import sealed_shards

        def read_all(directory):
            return [np.load(p)["data"] for p in sealed_shards(directory)]
    """
    assert "unsealed-replay" not in _rules_hit(via_listing)


def test_decode_host_sync_scope():
    """Only loops that drive a *step*/forward callee count as decode
    loops; .item() is a sync too; a host pull in a non-steppy loop
    (e.g. metric accumulation over host arrays) is not flagged."""
    item_sync = """
        def run(engine, n):
            total = 0
            for _ in range(n):
                out = engine.forward(x)
                total += out.loss.item()
            return total
    """
    assert "decode-host-sync" in _rules_hit(item_sync)
    not_steppy = """
        import numpy as np

        def summarize(rows):
            out = []
            for r in rows:
                out.append(np.asarray(r).mean())
            return out
    """
    assert "decode-host-sync" not in _rules_hit(not_steppy)


def test_raw_retry_ignores_poll_loops_and_faults_package():
    """A sleep-only poll loop is fine; a fail-fast except (raise/break/
    return) is fine; the faults package itself (which IMPLEMENTS the
    primitive) is exempt by path."""
    assert "raw-retry" not in _rules_hit(GOOD_POLL)
    fail_fast = """
        import time

        def drain(q):
            while True:
                try:
                    q.get_nowait()
                except Exception:
                    break
                time.sleep(0.01)
    """
    assert "raw-retry" not in _rules_hit(fail_fast)
    assert "raw-retry" in _rules_hit(BAD_RETRY)
    assert "raw-retry" not in _rules_hit(
        BAD_RETRY, rel="mxnet_tpu_torch/faults/retry.py")


@pytest.mark.parametrize("rule,bad,good",
                         FIXTURES, ids=[f[0] for f in FIXTURES])
def test_rule_catches_bug_and_passes_fix(rule, bad, good):
    assert rule in _rules_hit(bad), \
        "%s missed its historical reproduction" % rule
    assert rule not in _rules_hit(good), \
        "%s flags the fixed form" % rule


@pytest.mark.parametrize("rule,bad,good",
                         FIXTURES, ids=[f[0] for f in FIXTURES])
def test_cli_exits_1_on_each_fixture(rule, bad, good, tmp_path, capsys):
    """Acceptance: the port's lint CLI (``python -m
    mxnet_tpu_torch.analysis``'s ``main``) exits 1 on every synthetic
    fixture and 0 on its fixed form."""
    from mxnet_tpu_torch.analysis.__main__ import main
    f = tmp_path / ("bad_%s.py" % rule.replace("-", "_"))
    f.write_text(textwrap.dedent(bad))
    assert main([str(f)]) == 1
    assert rule in capsys.readouterr().out
    f.write_text(textwrap.dedent(good))
    assert main([str(f)]) == 0, capsys.readouterr().out


def test_full_tree_lint_green():
    """The tier-1 gate: ``mxnet_tpu_torch/`` has no analysis findings,
    with an empty baseline (every exception is an inline suppression
    with its reason)."""
    empty = os.path.join(REPO, "mxnet_tpu_torch", "analysis",
                         "no-such-baseline.json")
    res = subprocess.run(LINT + ["--baseline", empty],
                         capture_output=True, text=True, cwd=REPO,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    # a suppression without a reason would be a lint-meta finding here
    assert "lint: 0 finding(s)" in res.stdout


def test_diff_mode_checks_only_changed_files(tmp_path):
    """--diff HEAD on a clean-vs-HEAD worktree lints the (possibly
    empty) changed set and must stay green; a violation in a changed
    file under mxnet_tpu_torch/ is caught by the same entry point when
    the file is named directly (the pre-commit path)."""
    res = subprocess.run(LINT + ["--diff", "HEAD"],
                         capture_output=True, text=True, cwd=REPO,
                         timeout=120)
    assert res.returncode in (0, 1), res.stdout + res.stderr
    # whatever --diff sees is exactly what full-tree lint already
    # gates; with a green tree it must be green too
    assert res.returncode == 0, res.stdout + res.stderr


# ---------------------------------------------------------------------------
# suppressions + baseline

def test_suppression_with_reason_silences():
    src = """
    import time

    def rate(count):
        # lint: allow(raw-time) — measured interval crosses process
        # boundaries and must join wall-clock logs
        start = time.time()
        return count / (time.time() - start)  # lint: allow(raw-time) — ditto
    """
    assert "raw-time" not in _rules_hit(src)


def test_suppression_without_reason_is_an_error():
    src = """
    import time

    def rate(count):
        start = time.time()  # lint: allow(raw-time)
        return count / (time.time() - start)
    """
    hits = {f.rule for f in linter.lint_source(textwrap.dedent(src),
                                               "mxnet_tpu_torch/x.py")}
    assert "lint-meta" in hits        # the reasonless allow itself
    assert "raw-time" in hits         # and it does NOT suppress


def test_inline_allow_does_not_bless_next_statement():
    """An allow trailing a code line covers THAT statement only; the
    next line's genuine violation must still fire (only a comment-only
    allow line extends to the code below it)."""
    src = """
    import time

    def rates(count, t0):
        ts = time.time() - t0  # lint: allow(raw-time) — wall stamp ok
        d = time.time() - t0
        return ts, d
    """
    findings = [f for f in linter.lint_source(textwrap.dedent(src),
                                              "mxnet_tpu_torch/x.py")
                if f.rule == "raw-time"]
    assert len(findings) == 1, findings
    assert "d = time.time() - t0" in findings[0].src_line


def test_diff_mode_sees_untracked_files():
    """A brand-new (not yet git-added) file is exactly what the fast
    pre-commit path must lint; `git diff --name-only` alone omits it."""
    scratch = os.path.join(REPO, "mxnet_tpu_torch",
                           "_lint_selftest_scratch.py")
    try:
        with open(scratch, "w") as f:
            f.write("import time\nd = time.time() - time.time()\n")
        res = subprocess.run(LINT + ["--diff", "HEAD"],
                             capture_output=True, text=True, cwd=REPO,
                             timeout=120)
        assert res.returncode == 1, res.stdout + res.stderr
        assert "_lint_selftest_scratch.py" in res.stdout
        assert "raw-time" in res.stdout
    finally:
        os.unlink(scratch)


def test_file_level_suppression():
    src = '''
    # lint: allow-file(raw-env) — DMLC protocol vars, reference semantics
    """module docstring"""
    import os

    def a():
        return os.environ.get("DMLC_ROLE")

    def b():
        return os.environ["DMLC_PS_ROOT_URI"]
    '''
    assert "raw-env" not in _rules_hit(src)


def test_baseline_grandfathers_old_but_fails_new():
    src_old = "import os\nx = os.environ.get('A')\n"
    old = linter.lint_source(src_old, "mxnet_tpu_torch/old.py")
    assert {f.rule for f in old} == {"raw-env"}
    base = linter.Baseline.from_findings(old)
    # the same finding moved to another line keeps its fingerprint
    moved = linter.lint_source("import os\n\n\nx = os.environ.get('A')\n",
                               "mxnet_tpu_torch/old.py")
    assert base.new_findings(moved) == []
    # a NEW violation in the same file fails
    grown = linter.lint_source(
        "import os\nx = os.environ.get('A')\ny = os.environ.get('B')\n",
        "mxnet_tpu_torch/old.py")
    new = base.new_findings(grown)
    assert len(new) == 1 and "'B'" in new[0].src_line


def test_raw_dist_init_exempt_inside_dist_package():
    """dist/ OWNS the lifecycle: the same call that is a violation
    anywhere else is the implementation there."""
    src = ("import torch\ntorch.distributed.init_process_group("
           "'gloo', world_size=2, rank=0)\n")
    assert "raw-dist-init" in {f.rule for f in linter.lint_source(
        src, "mxnet_tpu_torch/module/x.py")}
    assert "raw-dist-init" not in {f.rule for f in linter.lint_source(
        src, "mxnet_tpu_torch/dist/boot.py")}


def test_raw_jit_exempt_inside_compile_cache():
    src = "import torch\nstep = torch.compile(lambda x: x)\n"
    assert "raw-jit" in {f.rule for f in linter.lint_source(
        src, "mxnet_tpu_torch/module/x.py")}
    assert "raw-jit" not in {f.rule for f in linter.lint_source(
        src, "mxnet_tpu_torch/compile_cache/warmup.py")}


# ---------------------------------------------------------------------------
# lock-order recorder

def _ordered_grab(lock1, lock2, gate_in, gate_out):
    # wait for the turn token so the two threads hold their pairs at
    # DISJOINT times — the schedule can't deadlock, but each still
    # acquires lock2 while holding lock1, which is all the recorder
    # needs to see both orders
    gate_in.wait(10)
    with lock1:
        with lock2:
            pass
    gate_out.set()


def test_lock_inversion_detected():
    """Deliberate A->B / B->A inversion on a deadlock-free schedule:
    the graph closes the cycle even though this run never hung."""
    with lockcheck.scoped() as graph:
        a = lockcheck.CheckedLock("test.A")
        b = lockcheck.CheckedLock("test.B")
        with a:
            with b:
                pass
        with b:
            with a:
                pass
        cycles = graph.snapshot()[1]
    assert cycles, "inversion not detected"
    names = set(cycles[0]["cycle"])
    assert {"test.A", "test.B"} <= names


def test_lock_inversion_detected_across_threads():
    with lockcheck.scoped() as graph:
        a = lockcheck.CheckedLock("thr.A")
        b = lockcheck.CheckedLock("thr.B")
        g1 = threading.Event()
        g2 = threading.Event()
        g1.set()                      # t1 goes first, then hands off
        t1 = threading.Thread(
            target=_ordered_grab, args=(a, b, g1, g2), name="inv1")
        t2 = threading.Thread(
            target=_ordered_grab, args=(b, a, g2, threading.Event()),
            name="inv2")
        t1.start(); t2.start()
        t1.join(10); t2.join(10)
        cycles = graph.snapshot()[1]
    assert cycles, "cross-thread inversion not detected"


def test_consistent_order_is_clean():
    with lockcheck.scoped() as graph:
        a = lockcheck.CheckedLock("ok.A")
        b = lockcheck.CheckedLock("ok.B")
        for _ in range(3):
            with a:
                with b:
                    pass
        assert graph.snapshot()[1] == []


def test_rlock_reentry_no_self_edge():
    with lockcheck.scoped() as graph:
        r = lockcheck.CheckedRLock("re.R")
        with r:
            with r:       # reentrant: must not record R->R
                pass
        edges, cycles = graph.snapshot()
        assert ("re.R", "re.R") not in edges
        assert cycles == []


def test_condition_wait_releases_name():
    """cv.wait() releases the real lock; holding it in the model would
    fabricate a cv->other edge from whatever the waiter touches next —
    and a notify-side other->cv edge would then read as a cycle."""
    with lockcheck.scoped() as graph:
        cv = lockcheck.CheckedCondition("cw.cv")
        other = lockcheck.CheckedLock("cw.other")
        done = []

        def waiter():
            with cv:
                cv.wait_for(lambda: done, timeout=10)

        t = threading.Thread(target=waiter, name="cw-waiter")
        t.start()
        time.sleep(0.1)          # let the waiter block inside wait_for
        with other:              # taken while cv's REAL lock is free
            with cv:
                done.append(1)
                cv.notify_all()
        t.join(10)
        edges, cycles = graph.snapshot()
    assert cycles == [], cycles
    assert ("cw.cv", "cw.other") not in edges


def test_same_name_two_instances_one_node():
    """Two engines' 'serve.swap' locks are one graph node: an inversion
    BETWEEN instances of the same class is invisible by design (it
    cannot deadlock — different objects), and instance identity would
    make the graph unbounded."""
    with lockcheck.scoped() as graph:
        a1 = lockcheck.CheckedLock("inst.A")
        a2 = lockcheck.CheckedLock("inst.A")
        with a1:
            with a2:        # A->A self edge is skipped by name
                pass
        edges, cycles = graph.snapshot()
        assert ("inst.A", "inst.A") not in edges
        assert cycles == []


def test_lockcheck_trace_spill_reentrancy_no_deadlock(tmp_path):
    """Edge emission goes through mxnet_tpu_torch.trace, whose recorder lock
    is itself a make_lock: at a spill-cadence boundary the instant
    re-enters note_edge via CheckedLock.acquire.  The reentrancy guard
    must drop the nested emission — without it the nested spill flush
    deadlocks on the recorder's non-reentrant inner lock."""
    prog = textwrap.dedent("""
        import os, sys
        os.environ["MXNET_LOCK_CHECK"] = "1"
        os.environ["MXNET_TRACE_SPILL_EVERY"] = "4"
        sys.path.insert(0, %r)
        from mxnet_tpu_torch import trace
        from mxnet_tpu_torch.analysis import lockcheck
        trace.configure_spill(%r)
        for i in range(3):
            trace.instant("warm%%d" %% i)
        a = lockcheck.make_lock("t.spillA")
        b = lockcheck.make_lock("t.spillB")
        with a:
            with b:
                pass
        print("NO-DEADLOCK")
    """) % (REPO, str(tmp_path / "spill.jsonl"))
    res = subprocess.run([sys.executable, "-c", prog],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "NO-DEADLOCK" in res.stdout, \
        res.stdout + res.stderr


def test_factories_plain_when_disabled():
    saved = lockcheck._enabled
    try:
        lockcheck.set_enabled(False)
        assert isinstance(lockcheck.make_lock("x"),
                          type(threading.Lock()))
        lockcheck.set_enabled(True)
        assert isinstance(lockcheck.make_lock("x"), lockcheck.CheckedLock)
    finally:
        lockcheck._enabled = saved


def test_real_tree_zero_cycles():
    """Tier-1 acceptance: after every suite that ran before this module
    (serve/feed/checkpoint/compile_cache exercise their thread soup
    under MXNET_LOCK_CHECK=1 from conftest), the process graph holds no
    cycle.  The module-scoped guard enforces this per module; this test
    states it explicitly."""
    assert lockcheck.cycles() == [], lockcheck.lock_order_report()


def test_lock_order_report_shape():
    rep = lockcheck.lock_order_report()
    assert set(rep) == {"enabled", "edges", "cycles"}
    assert isinstance(rep["edges"], list)


# ---------------------------------------------------------------------------
# leak guard

def test_leakguard_catches_thread_and_child():
    before = leakguard.snapshot()
    stop = threading.Event()
    t = threading.Thread(target=stop.wait, name="deliberate-leak",
                         daemon=True)
    t.start()
    child = subprocess.Popen([sys.executable, "-c",
                              "import time; time.sleep(30)"])
    try:
        leaks = leakguard.check(before, grace_s=0.3)
        assert any("deliberate-leak" in l for l in leaks), leaks
        assert any("pid=%d" % child.pid in l for l in leaks), leaks
    finally:
        stop.set()
        t.join(5)
        child.kill()
        child.wait()
    # ... and after cleanup the same snapshot is clean again
    assert leakguard.check(before, grace_s=5.0) == []


def test_leakguard_grace_window_tolerates_slow_join():
    """A thread that exits within the grace window is not a leak —
    clean shutdown paths get time to join."""
    before = leakguard.snapshot()
    t = threading.Thread(target=lambda: time.sleep(0.4),
                         name="slow-join")
    t.start()
    assert leakguard.check(before, grace_s=5.0) == []
    t.join()


GUARD_FAIL_SNIPPET = """
import threading

def test_leaks_a_thread():
    threading.Thread(target=lambda: __import__('time').sleep(60),
                     name='suite-leaked-thread', daemon=True).start()
"""

GUARD_CLEAN_SNIPPET = """
def test_clean():
    assert 1 + 1 == 2
"""


def test_pytest_guard_fails_leaky_module(tmp_path):
    """End to end: a pytest run over a module that leaks a thread fails
    with the analysis-guard message, while a clean module passes."""
    (tmp_path / "test_leaky_mod.py").write_text(GUARD_FAIL_SNIPPET)
    (tmp_path / "test_clean_mod.py").write_text(GUARD_CLEAN_SNIPPET)
    env = dict(os.environ,
               MXNET_LEAK_CHECK="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "mxnet_tpu_torch.analysis.pytest_plugin", str(tmp_path)],
        capture_output=True, text=True, env=env, cwd=str(tmp_path),
        timeout=180)
    out = res.stdout + res.stderr
    assert res.returncode != 0, out
    assert "analysis guard" in out and "suite-leaked-thread" in out, out
    # the clean module itself passed; only the guard error is reported
    assert "test_clean" not in out.split("short test summary")[-1], out


def test_leakguard_disabled_knob(monkeypatch):
    monkeypatch.setenv("MXNET_LEAK_CHECK", "0")
    assert not leakguard.enabled()
    monkeypatch.setenv("MXNET_LEAK_CHECK", "1")
    assert leakguard.enabled()


# ---------------------------------------------------------------------------
# the port against the JAX package's linter, and the port's own tree

PARITY_SNIPPETS = [bad for _r, bad, _g in FIXTURES] + \
    [good for _r, _b, good in FIXTURES] + [GOOD_POLL, """
    import os
    import time
    import numpy as np

    def mixed(fut, rows):
        t = time.time()
        seed = os.environ["SEED"]
        for r in rows:
            try:
                r.go()
            except Exception:
                pass
            time.sleep(np.random.rand())
        fut.set_exception(RuntimeError(seed))
        return time.time() - t
"""]


@pytest.mark.parametrize("i", range(len(PARITY_SNIPPETS)))
def test_kept_rules_report_the_jax_linters_rule_and_line(i):
    src = textwrap.dedent(PARITY_SNIPPETS[i])

    def hits(lint, rel):
        return sorted((f.rule, f.line) for f in lint.lint_source(src, rel)
                      if f.rule in KEPT)
    want = hits(jax_linter, "mxnet_tpu/serve/somefile.py")
    assert hits(linter, "mxnet_tpu_torch/serve/somefile.py") == want
    # the faults/ exemption moved with the package
    assert hits(linter, "mxnet_tpu_torch/faults/retry.py") == \
        hits(jax_linter, "mxnet_tpu/faults/retry.py")


def test_linter_loads_by_file_path_without_torch():
    """linter.py stays stdlib-only: loaded by file path in a fresh
    interpreter it lints without importing torch or the package."""
    prog = textwrap.dedent("""
        import importlib.util, sys
        spec = importlib.util.spec_from_file_location(
            "lint", %r)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        hits = mod.lint_source("import os\\nx = os.getenv('A')\\n", "a.py")
        assert [f.rule for f in hits] == ["raw-env"], hits
        assert "torch" not in sys.modules and "mxnet_tpu_torch" \\
            not in sys.modules
        print("OK")
    """) % os.path.join(REPO, "mxnet_tpu_torch", "analysis", "linter.py")
    res = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=60)
    assert res.returncode == 0 and "OK" in res.stdout, res.stderr


def test_write_baseline_then_new_findings_fail(tmp_path, capsys):
    from mxnet_tpu_torch.analysis.__main__ import main
    bad = tmp_path / "bad_env.py"
    bad.write_text("import os\nx = os.environ.get('A')\n")
    base = str(tmp_path / "baseline.json")
    assert main([str(bad), "--baseline", base, "--write-baseline"]) == 0
    assert "1 finding(s) grandfathered" in capsys.readouterr().out
    assert main([str(bad), "--baseline", base]) == 0
    capsys.readouterr()
    bad.write_text("import os\nx = os.environ.get('A')\n"
                   "y = os.environ.get('B')\n")
    assert main([str(bad), "--baseline", base]) == 1
    out = capsys.readouterr().out
    assert "bad_env.py:3:" in out and "bad_env.py:2:" not in out


def test_real_tree_zero_cycles_with_the_recorder_armed(tmp_path):
    """The port's thread soup in one process with the recorder armed
    (tier-1's conftest sets MXNET_LOCK_CHECK=1 before any import): the
    serve batcher under 4 client threads, the feed's staged pipeline, a
    checkpoint save and a trace dump close no lock-order cycle."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import feed, trace
    assert lockcheck.enabled()
    assert isinstance(mx.serve.batcher.make_condition("t.probe"),
                      lockcheck.CheckedCondition)
    before = len(lockcheck.cycles())
    edges_before = len(lockcheck.edges())
    was_on = trace.enabled()
    trace.set_enabled(True)
    try:
        data = mx.sym.Variable("data")
        net = mx.sym.FullyConnected(data, num_hidden=4, name="fc")
        rng = np.random.RandomState(0)
        params = {"fc_weight": rng.randn(4, 6).astype(np.float32),
                  "fc_bias": np.zeros(4, np.float32)}
        engine = mx.serve.ServeEngine(net, params, {"data": (1, 6)},
                                      dev_type="cpu", batch_buckets=(1, 4),
                                      queue_depth=64, name="lockcheck")
        items = rng.randn(32, 6).astype(np.float32)
        answers = [None] * 32
        try:
            def client(i):
                futs = [(j, engine.submit(items[j]))
                        for j in range(i, 32, 4)]
                for j, f in futs:
                    answers[j] = f.result(timeout=60)
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
        finally:
            engine.close()
        assert all(a is not None for a in answers)
        p = feed.Pipeline([feed.SourceStage(list(range(23)), max_epochs=1),
                           feed.MapStage(lambda x: x * 2, workers=2),
                           feed.BatchStage(5)], buffer_size=2,
                          name="lockcheck")
        try:
            got = list(p)
        finally:
            p.close()
        assert len(got) == 5
        mgr = mx.checkpoint.CheckpointManager(str(tmp_path / "ckpt"))
        mgr.save(1, {"w": torch.ones(3)})
        mgr.wait()
        mgr.close()
        trace.dump_trace(str(tmp_path / "trace.json"))
    finally:
        trace.set_enabled(was_on)
    assert lockcheck.cycles()[before:] == [], lockcheck.lock_order_report()
    assert len(lockcheck.edges()) >= edges_before
