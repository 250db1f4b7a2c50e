"""Project-specific static analysis: the bug classes the JAX package
paid for, turned into mechanical checks on the port's source.

The counterpart of ``mxnet_tpu/analysis/linter.py``.  It stays
self-contained (stdlib ``ast`` only, no imports from the rest of
``mxnet_tpu_torch``), so it can be loaded by file path and run in
milliseconds without importing torch.  ``python -m
mxnet_tpu_torch.analysis`` is its command line.

Rules
-----
Kept as the JAX package has them (on the same source they report the
same ``(rule, line)``):

raw-env            ``os.environ`` reads bypassing ``base.get_env``
raw-time           ``time.time()`` in rate/duration arithmetic (wall
                   clock steps under NTP; use ``time.perf_counter()``)
unseeded-fork-rng  global ``np.random.*`` draws: forked reader workers
                   inherit one identical state
raw-future-settle  ``set_result``/``set_exception`` outside the
                   InvalidStateError-tolerant helpers (a cancelled
                   future raises and kills the settling thread)
raw-retry          a loop that both sleeps and swallows exceptions: a
                   bare retry loop outside ``mxnet_tpu_torch/faults/``
                   (retries ride faults.Backoff/retry_call)
unsealed-replay    ``np.load``/``np.fromfile`` in a capture-shard reader
                   with no SEALED-marker gate

Rewritten for the port:

raw-pallas-call    a raw kernel build or load outside
                   ``ops/cuda_kernels.py``: ``ctypes.CDLL``/
                   ``ctypes.cdll.LoadLibrary``, ``torch.utils.
                   cpp_extension``, or an ``nvcc`` subprocess.  Shipped
                   kernels live in one module, whose plain versions and
                   searches cover them (the rtc passthrough and the
                   compile cache's stored libraries carry inline
                   suppressions); the native layer's host libraries
                   (no kernels) are built and loaded in its sibling
                   ``native_build.py``
raw-jit            ``torch.cuda.graph``, ``torch.cuda.CUDAGraph`` or
                   ``torch.compile`` outside ``compile_cache/``: captures
                   go through its lock and its counted builds
raw-dist-init      ``torch.distributed.init_process_group`` outside
                   ``mxnet_tpu_torch/dist/``: the process-group boot is
                   single-owner (``dist.boot``)
decode-host-sync   ``np.asarray``/``.item()``/``.cpu()``/``.tolist()``/
                   ``float(x)``/``torch.cuda.synchronize()`` inside a
                   per-token decode loop (a For/While whose body calls a
                   ``*step*``/``forward`` callee): each one is a
                   device-to-host sync once per token
moe-raw-scatter    ``index_add_``, ``scatter_add_``, ``scatter_reduce``
                   or ``index_put_(..., accumulate=True)`` outside
                   ``moe/``, ``embed/sparse.py`` and ``embed/table.py``:
                   a raw scatter-add onto expert or embedding rows
                   bypasses the sentinel-fold discipline

``donated-aliasing`` is not carried: PyTorch has no buffer donation (the
fused step's state is written in place, and its static inputs are filled
by ``copy_``).

Suppressions
------------
Inline, same line or the line above, WITH a written reason::

    x = time.time()  # lint: allow(raw-time) — absolute ts for humans

File-level (first 10 lines), for files where a rule is wholesale
inapplicable::

    # lint: allow-file(raw-env) — DMLC protocol vars, reference semantics

A suppression without a reason (the ``— why`` part) is itself an error:
the whole value of the mechanism is that every exception is explained.

Baseline
--------
A JSON baseline (``mxnet_tpu_torch/analysis/lint_baseline.json`` by
default, absent: empty) grandfathers known findings by fingerprint
(rule, path, source line text), not line number, so unrelated edits do
not churn it; only NEW findings fail.  The port's tree lints green with
an empty baseline.
"""
from __future__ import annotations

import ast
import hashlib
import json
import os
import re
import tokenize
from typing import Dict, Iterable, List, Optional, Set, Tuple

__all__ = ["Finding", "RULES", "lint_file", "lint_source", "lint_paths",
           "Baseline", "load_baseline", "fingerprint"]

# ---------------------------------------------------------------------------
# findings + suppressions

_ALLOW_RE = re.compile(
    r"#\s*lint:\s*allow\(([a-z0-9_,\- ]+)\)\s*(?:[—–-]+\s*(.*\S))?")
_ALLOW_FILE_RE = re.compile(
    r"#\s*lint:\s*allow-file\(([a-z0-9_,\- ]+)\)\s*(?:[—–-]+\s*(.*\S))?")


class Finding:
    """One lint hit: rule id, location, message."""

    def __init__(self, rule: str, path: str, line: int, col: int,
                 msg: str, src_line: str = ""):
        self.rule = rule
        self.path = path
        self.line = line
        self.col = col
        self.msg = msg
        self.src_line = src_line

    def __repr__(self):
        return "%s:%d:%d: [%s] %s" % (self.path, self.line, self.col,
                                      self.rule, self.msg)

    def fingerprint(self) -> str:
        return fingerprint(self.rule, self.path, self.src_line)


def fingerprint(rule: str, path: str, src_line: str) -> str:
    """Line-number-free identity of a finding: stable across edits that
    merely move the offending line."""
    h = hashlib.sha256()
    h.update(("%s\0%s\0%s" % (rule, path, src_line.strip())).encode())
    return h.hexdigest()[:16]


class _Suppressions:
    """Per-file suppression table parsed from comments."""

    def __init__(self, source: str, path: str):
        self.by_line: Dict[int, Set[str]] = {}
        self.file_wide: Set[str] = set()
        self.errors: List[Finding] = []
        lines = source.splitlines()
        try:
            import io
            tokens = tokenize.generate_tokens(io.StringIO(source).readline)
            for tok in tokens:
                if tok.type != tokenize.COMMENT:
                    continue
                self._parse(tok.string, tok.start[0], path,
                            lines[tok.start[0] - 1]
                            if tok.start[0] <= len(lines) else "")
        except (tokenize.TokenError, IndentationError, SyntaxError):
            pass
        # a COMMENT-ONLY allow line extends through the rest of its
        # comment block to the first code line after it, so a multi-line
        # reason can sit above the statement it blesses; an INLINE allow
        # (trailing a code line) covers that statement only — extending
        # it would silently bless the next statement too
        for lineno in sorted(self.by_line):
            if not lines[lineno - 1].lstrip().startswith("#"):
                continue
            rules = self.by_line[lineno]
            nxt = lineno + 1
            while nxt <= len(lines):
                stripped = lines[nxt - 1].strip()
                self.by_line.setdefault(nxt, set()).update(rules)
                if stripped and not stripped.startswith("#"):
                    break  # reached the code line the allow targets
                nxt += 1

    def _parse(self, comment: str, lineno: int, path: str, src_line: str):
        m = _ALLOW_FILE_RE.search(comment)
        if m:
            rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
            if not m.group(2):
                self.errors.append(Finding(
                    "lint-meta", path, lineno, 0,
                    "allow-file(%s) carries no reason — write one after "
                    "an em dash" % ",".join(sorted(rules)), src_line))
            elif lineno > 10:
                self.errors.append(Finding(
                    "lint-meta", path, lineno, 0,
                    "allow-file must appear in the first 10 lines",
                    src_line))
            else:
                self.file_wide |= rules
            return
        m = _ALLOW_RE.search(comment)
        if m:
            rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
            if not m.group(2):
                self.errors.append(Finding(
                    "lint-meta", path, lineno, 0,
                    "allow(%s) carries no reason — write one after an "
                    "em dash" % ",".join(sorted(rules)), src_line))
                return
            self.by_line.setdefault(lineno, set()).update(rules)

    def allows(self, rule: str, line: int) -> bool:
        if rule in self.file_wide:
            return True
        return rule in self.by_line.get(line, set())


# ---------------------------------------------------------------------------
# AST helpers

def _dotted(node: ast.AST) -> Optional[str]:
    """'torch.cuda.graph' for Attribute(Attribute(Name('torch'), 'cuda'),
    'graph'); None when not a plain dotted name."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _attach_parents(tree: ast.AST) -> None:
    for parent in ast.walk(tree):
        for child in ast.iter_child_nodes(parent):
            child._lint_parent = parent  # type: ignore[attr-defined]


def _parent(node: ast.AST) -> Optional[ast.AST]:
    return getattr(node, "_lint_parent", None)


def _enclosing_funcs(node: ast.AST) -> List[str]:
    """Names of enclosing function defs, innermost first."""
    names = []
    cur = _parent(node)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.append(cur.name)
        cur = _parent(cur)
    return names


class _Ctx:
    def __init__(self, path: str, rel: str, tree: ast.AST, source: str):
        self.path = path
        self.rel = rel          # repo-relative, forward slashes
        self.tree = tree
        self.source = source
        self.lines = source.splitlines()

    def src(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""

    def finding(self, rule: str, node: ast.AST, msg: str) -> Finding:
        f = Finding(rule, self.rel, node.lineno, node.col_offset, msg,
                    self.src(node.lineno))
        f._node = node  # statement-span suppression check
        return f


# ---------------------------------------------------------------------------
# rules

_CAPTURES = ("torch.cuda.graph", "torch.cuda.CUDAGraph", "torch.compile")


def _rule_raw_jit(ctx: _Ctx) -> Iterable[Finding]:
    """A CUDA graph capture or ``torch.compile`` outside compile_cache:
    captures take the device's capture lock and count their builds
    there (``compile_cache.capture``); a stray one races another
    thread's capture and hides from the compile report."""
    if ctx.rel.startswith("mxnet_tpu_torch/compile_cache/"):
        return
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Attribute) and _dotted(node) in _CAPTURES:
            yield ctx.finding(
                "raw-jit", node,
                "%s outside compile_cache — capture through "
                "compile_cache.capture (the device's capture lock, counted "
                "builds), or suppress with the reason" % _dotted(node))


_LIB_LOADS = ("ctypes.CDLL", "ctypes.cdll.LoadLibrary", "ctypes.PyDLL")
_SUBPROCESS = ("subprocess.run", "subprocess.Popen", "subprocess.call",
               "subprocess.check_call", "subprocess.check_output")


def _mentions_nvcc(node: ast.AST) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Constant) and isinstance(n.value, str) \
                and "nvcc" in n.value:
            return True
        if isinstance(n, ast.Name) and "nvcc" in n.id.lower():
            return True
        if isinstance(n, ast.Attribute) and "nvcc" in n.attr.lower():
            return True
    return False


def _rule_raw_pallas_call(ctx: _Ctx) -> Iterable[Finding]:
    """A raw kernel build or load outside ops/cuda_kernels.py: shipped
    kernels live in the one module whose wrappers count launches, take
    the plain version only on the CPU and are searched and checked
    against it.  A library loaded or built elsewhere is an unchecked,
    uncounted kernel."""
    if ctx.rel.startswith(("mxnet_tpu_torch/ops/cuda_kernels",
                           "mxnet_tpu_torch/native_build")):
        return
    for node in ast.walk(ctx.tree):
        what = None
        if isinstance(node, ast.Call):
            d = _dotted(node.func) or ""
            if d in _LIB_LOADS or d.startswith("torch.utils.cpp_extension."):
                what = d
            elif d in _SUBPROCESS and node.args \
                    and _mentions_nvcc(node.args[0]):
                what = "an nvcc subprocess"
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.module.startswith("torch.utils.cpp_extension"):
            what = node.module
        if what is None:
            continue
        yield ctx.finding(
            "raw-pallas-call", node,
            "%s outside ops/cuda_kernels — shipped kernels are built and "
            "loaded there, where their launches are counted and their "
            "plain versions check them; add the kernel there, or "
            "suppress with the reason it cannot ride that module" % what)


_DIST_INITS = ("torch.distributed.init_process_group",
               "dist.init_process_group")


def _rule_raw_dist_init(ctx: _Ctx) -> Iterable[Finding]:
    """torch.distributed.init_process_group outside mxnet_tpu_torch/dist/:
    the boot is single-owner (dist.boot): it picks the backend (NCCL when
    every rank has its own card, gloo otherwise), binds each rank's card
    and tolerates re-entry.  A second raw call fails ("trying to
    initialize the default process group twice") or boots the wrong
    backend."""
    if ctx.rel.startswith("mxnet_tpu_torch/dist/"):
        return
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Attribute) and _dotted(node) in _DIST_INITS:
            yield ctx.finding(
                "raw-dist-init", node,
                "raw torch.distributed.init_process_group — the process-"
                "group lifecycle is owned by mxnet_tpu_torch.dist.boot "
                "(backend choice, the rank's card, idempotent re-entry); "
                "call dist.boot.initialize / ensure_from_env instead")


_ENV_READS = ("os.environ.get", "os.getenv", "environ.get")


def _rule_raw_env(ctx: _Ctx) -> Iterable[Finding]:
    """os.environ reads outside base.get_env: the PR 6 convention — one
    typed, defaulted accessor, not N ad-hoc parses."""
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Call) and _dotted(node.func) in _ENV_READS:
            yield ctx.finding(
                "raw-env", node,
                "raw environment read — use base.get_env(name, default, "
                "typ) (typed parse, one convention)")
        elif (isinstance(node, ast.Subscript)
              and _dotted(node.value) in ("os.environ", "environ")
              and isinstance(getattr(node, "ctx", None), ast.Load)):
            yield ctx.finding(
                "raw-env", node,
                "raw os.environ[...] read — use base.get_env")


def _rule_raw_time(ctx: _Ctx) -> Iterable[Finding]:
    """time.time() feeding duration/rate arithmetic: wall clock steps
    under NTP/DST and corrupts the window (PR 3's Speedometer bug).
    A bare timestamp recorded for humans (dict value, logged) is fine;
    arithmetic must ride time.perf_counter()."""
    # names assigned from time.time() per enclosing function
    for node in ast.walk(ctx.tree):
        if not (isinstance(node, ast.Call)
                and _dotted(node.func) in ("time.time",)):
            continue
        parent = _parent(node)
        # direct arithmetic: time.time() - start, start - time.time()...
        if isinstance(parent, ast.BinOp):
            yield ctx.finding(
                "raw-time", node,
                "time.time() in duration arithmetic — wall clock steps "
                "under NTP; use time.perf_counter()")
            continue
        if isinstance(parent, ast.Compare):
            yield ctx.finding(
                "raw-time", node,
                "time.time() compared against a deadline — use "
                "time.perf_counter() or time.monotonic()")
            continue
        # assigned to a name that later appears in a BinOp in the same
        # function: start = time.time(); ...; time.time() - start
        if isinstance(parent, ast.Assign) and len(parent.targets) == 1 \
                and isinstance(parent.targets[0], ast.Name):
            name = parent.targets[0].id
            scope = _enclosing_scope(node)
            if scope is not None and _name_in_arith(scope, name):
                yield ctx.finding(
                    "raw-time", node,
                    "time.time() stored in %r which feeds arithmetic — "
                    "wall clock steps under NTP; use time.perf_counter()"
                    % name)


def _enclosing_scope(node: ast.AST) -> Optional[ast.AST]:
    cur = _parent(node)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Module)):
            return cur
        cur = _parent(cur)
    return None


def _name_in_arith(scope: ast.AST, name: str) -> bool:
    for n in ast.walk(scope):
        if isinstance(n, (ast.BinOp, ast.Compare, ast.AugAssign)):
            for sub in ast.walk(n):
                if isinstance(sub, ast.Name) and sub.id == name:
                    return True
    return False


_NPR_SAFE = {"seed", "default_rng", "Generator", "RandomState",
             "SeedSequence", "PCG64", "get_state", "set_state"}


def _rule_unseeded_fork_rng(ctx: _Ctx) -> Iterable[Finding]:
    """Draws from numpy's GLOBAL generator: forked reader workers
    inherit one identical state, so every worker produces the SAME
    'random' crops/flips (PR 6's decorrelation bug).  Use an explicit
    np.random.default_rng(seed) or reseed per (seed, shard, epoch, seq)
    before drawing."""
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        dotted = _dotted(node.func)
        if not dotted:
            continue
        for prefix in ("np.random.", "numpy.random."):
            if dotted.startswith(prefix):
                fn = dotted[len(prefix):]
                if "." not in fn and fn not in _NPR_SAFE:
                    yield ctx.finding(
                        "unseeded-fork-rng", node,
                        "np.random.%s draws from the process-global "
                        "generator — forked workers inherit identical "
                        "state; use an explicit default_rng(seed) or "
                        "reseed per (seed, shard, epoch, seq)" % fn)
                break


def _rule_raw_future_settle(ctx: _Ctx) -> Iterable[Finding]:
    """fut.set_result/set_exception outside the InvalidStateError-
    tolerant helpers: a routine client cancel made the raw call raise,
    killing the worker thread and wedging the serve engine (PR 4 review
    round 2).  Settle futures only through serve.batcher._set_result /
    _set_exception."""
    for node in ast.walk(ctx.tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("set_result", "set_exception")):
            continue
        funcs = _enclosing_funcs(node)
        if funcs and funcs[0] in ("_set_result", "_set_exception"):
            continue  # the tolerant helpers themselves
        yield ctx.finding(
            "raw-future-settle", node,
            "raw Future.%s — a cancelled future raises "
            "InvalidStateError and kills the calling thread; use the "
            "tolerant _set_result/_set_exception helpers"
            % node.func.attr)


def _rule_raw_retry(ctx: _Ctx) -> Iterable[Finding]:
    """A loop whose body both sleeps AND swallows an exception is a
    hand-rolled retry loop: unbounded, unjittered, invisible to the
    fault plane's counters (the PR 15 reader-refork hot-loop class).
    Retries belong to faults.Backoff / faults.retry_call — bounded,
    jittered, deterministic, traced.  Poll loops (sleep, no swallowed
    exception) and fail-fast loops (except that raises/breaks/returns)
    are not flagged; faults/ itself implements the primitive."""
    if ctx.rel.startswith("mxnet_tpu_torch/faults/"):
        return
    flagged: Set[int] = set()
    for node in ast.walk(ctx.tree):
        if not isinstance(node, (ast.While, ast.For)):
            continue
        sleeps = [n for n in ast.walk(node)
                  if isinstance(n, ast.Call)
                  and _dotted(n.func) == "time.sleep"]
        if not sleeps:
            continue
        swallowing = [
            h for h in ast.walk(node)
            if isinstance(h, ast.ExceptHandler)
            and not any(isinstance(x, (ast.Raise, ast.Break, ast.Return))
                        for x in ast.walk(h))]
        if not swallowing:
            continue
        for s in sleeps:
            if id(s) in flagged:    # inner loop already reported it
                continue
            flagged.add(id(s))
            yield ctx.finding(
                "raw-retry", s,
                "sleep inside a loop that swallows exceptions — a bare "
                "retry loop: unbounded and unjittered; use "
                "faults.retry_call / faults.Backoff (bounded budget, "
                "deterministic jitter, traced waits)")


_HOST_SYNC_DOTTED = {"np.asarray", "numpy.asarray", "np.array",
                     "numpy.array"}


def _rule_decode_host_sync(ctx: _Ctx) -> Iterable[Finding]:
    """A device->host materialization inside a per-token decode loop: a
    For/While whose body drives a ``*step*``/``forward`` callee is the
    serving hot loop, and every ``np.asarray``/``.item()``/``.cpu()``/
    ``.tolist()``/``float(x)``/``torch.cuda.synchronize()`` in it blocks
    on the device stream once per token.  The paged decode
    engine's budget is ONE host sync per compiled step (PR 16); extra
    pulls belong outside the loop, or batched into that one asarray.
    ``int(...)`` on an already-host numpy scalar is not flagged — the
    sync already happened at the step's asarray."""
    flagged: Set[int] = set()
    for node in ast.walk(ctx.tree):
        if not isinstance(node, (ast.While, ast.For)):
            continue
        steppy = False
        for n in ast.walk(node):
            if isinstance(n, ast.Call):
                name = n.func.attr if isinstance(n.func, ast.Attribute) \
                    else (n.func.id if isinstance(n.func, ast.Name)
                          else None)
                if name and ("step" in name or name == "forward"):
                    steppy = True
                    break
        if not steppy:
            continue
        for n in ast.walk(node):
            if not isinstance(n, ast.Call) or id(n) in flagged:
                continue
            d = _dotted(n.func)
            what = None
            if d in _HOST_SYNC_DOTTED:
                what = d
            elif isinstance(n.func, ast.Attribute) \
                    and n.func.attr in ("item", "cpu", "tolist") \
                    and not n.args:
                what = ".%s()" % n.func.attr
            elif d == "torch.cuda.synchronize":
                what = d
            elif isinstance(n.func, ast.Name) and n.func.id == "float" \
                    and n.args and not isinstance(n.args[0], ast.Constant):
                what = "float(...)"
            if what is None:
                continue
            flagged.add(id(n))
            yield ctx.finding(
                "decode-host-sync", n,
                "%s inside a per-token decode loop — a device->host "
                "sync serialized against the step stream once per "
                "token; hoist it out of the loop or batch it into the "
                "step's single asarray (one host sync per compiled "
                "step)" % what)


_SHARD_LOADERS = {"np.load", "numpy.load", "np.fromfile",
                  "numpy.fromfile"}


def _rule_unsealed_replay(ctx: _Ctx) -> Iterable[Finding]:
    """A function that reads capture-shard files (``np.load`` /
    ``np.fromfile`` in shard-touching code) without any reference to
    the SEALED discipline: capture shards publish in two atomic steps
    (shard file, then SEALED marker — mirroring the checkpoint COMMIT
    protocol), so a reader that skips the marker check replays torn or
    in-progress tails as training data (PR 17).  The gate is any
    seal-named reference (``is_sealed`` / ``sealed_shards`` / a SEALED
    constant) in the same function; shard-ness is a ``shard-`` string
    (the capture file prefix) or a shard-named identifier."""
    for node in ast.walk(ctx.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        sharded = "shard" in node.name.lower()
        sealed = "seal" in node.name.lower()
        loads = []
        for n in ast.walk(node):
            if isinstance(n, ast.Constant) and isinstance(n.value, str):
                low = n.value.lower()
                if "shard-" in low:
                    sharded = True
                if "seal" in low:
                    sealed = True
            elif isinstance(n, ast.Name):
                low = n.id.lower()
                if "shard" in low:
                    sharded = True
                if "seal" in low:
                    sealed = True
            elif isinstance(n, ast.Attribute):
                low = n.attr.lower()
                if "shard" in low:
                    sharded = True
                if "seal" in low:
                    sealed = True
            elif isinstance(n, ast.Call) \
                    and _dotted(n.func) in _SHARD_LOADERS:
                loads.append(n)
        if not (sharded and loads) or sealed:
            continue
        for n in loads:
            yield ctx.finding(
                "unsealed-replay", n,
                "capture-shard read with no SEALED-marker gate — a "
                "torn or in-progress shard tail becomes training "
                "data; check online.capture.is_sealed(path) (or "
                "iterate sealed_shards()) before loading, like the "
                "checkpoint COMMIT discipline")


# the scatter choke points: capacity-bucketed dispatch (sentinel fold)
# and the sparse-embed gradient path (capped-unique dedup)
_SCATTER_CHOKE = ("mxnet_tpu_torch/moe/", "mxnet_tpu_torch/embed/sparse.py",
                  "mxnet_tpu_torch/embed/table.py")
_SCATTER_ADDS = ("index_add_", "index_add", "scatter_add_", "scatter_add",
                 "scatter_reduce", "scatter_reduce_")


def _rule_moe_raw_scatter(ctx: _Ctx) -> Iterable[Finding]:
    """``index_add_``/``scatter_add_``/``scatter_reduce``/``index_put_(...,
    accumulate=True)`` outside the dispatch/embed choke points: a raw
    scatter-add onto an expert or row buffer bypasses the sentinel-fold
    discipline, and an out-of-range or dropped index wraps (negatives)
    or lands on a LIVE row and corrupts it with traffic the row never
    accepted.  Plain ``index_put_``/``index_copy_`` writes (the paged KV
    cache, slot zeroing) are not accumulates and stay legal."""
    if ctx.rel.startswith(_SCATTER_CHOKE):
        return
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call) \
                or not isinstance(node.func, ast.Attribute):
            continue
        attr = node.func.attr
        if attr in _SCATTER_ADDS:
            what = attr
        elif attr in ("index_put_", "index_put") and any(
                k.arg == "accumulate" and not (
                    isinstance(k.value, ast.Constant) and not k.value.value)
                for k in node.keywords):
            what = "%s(accumulate=True)" % attr
        else:
            continue
        yield ctx.finding(
            "moe-raw-scatter", node,
            "raw %s scatter-accumulate — expert/row buffers are written "
            "only through the choke points (moe.dispatch, the embed.sparse "
            "gradient fold) where the sentinel fold keeps dropped traffic "
            "out of live rows; route through them or suppress with why "
            "this buffer has no out-of-range indices" % what)


RULES = {
    "raw-jit": _rule_raw_jit,
    "raw-dist-init": _rule_raw_dist_init,
    "raw-env": _rule_raw_env,
    "raw-time": _rule_raw_time,
    "unseeded-fork-rng": _rule_unseeded_fork_rng,
    "raw-future-settle": _rule_raw_future_settle,
    "raw-retry": _rule_raw_retry,
    "decode-host-sync": _rule_decode_host_sync,
    "unsealed-replay": _rule_unsealed_replay,
    "moe-raw-scatter": _rule_moe_raw_scatter,
    "raw-pallas-call": _rule_raw_pallas_call,
}


# ---------------------------------------------------------------------------
# driver

def lint_source(source: str, rel: str, path: Optional[str] = None,
                rules: Optional[Iterable[str]] = None) -> List[Finding]:
    """Lint one source string; ``rel`` is the repo-relative path used in
    findings and path-scoped rules (forward slashes)."""
    rel = rel.replace(os.sep, "/")
    try:
        tree = ast.parse(source, filename=rel)
    except SyntaxError as e:
        return [Finding("syntax", rel, e.lineno or 0, 0,
                        "syntax error: %s" % e.msg)]
    _attach_parents(tree)
    ctx = _Ctx(path or rel, rel, tree, source)
    sup = _Suppressions(source, rel)
    findings: List[Finding] = list(sup.errors)
    selected = set(rules) if rules is not None else set(RULES)
    for rule_name, rule in RULES.items():
        if rule_name not in selected:
            continue
        for f in rule(ctx):
            # an allow anywhere on the enclosing STATEMENT's lines (or
            # the comment block above it) suppresses — a flagged call
            # may sit on a continuation line of a multi-line statement
            lines = {f.line}
            node = getattr(f, "_node", None)
            stmt = node
            while stmt is not None and not isinstance(stmt, ast.stmt):
                stmt = _parent(stmt)
            if stmt is not None:
                lines.update(range(stmt.lineno,
                                   (getattr(stmt, "end_lineno", None)
                                    or stmt.lineno) + 1))
            if not any(sup.allows(rule_name, ln) for ln in lines):
                findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def lint_file(path: str, root: str,
              rules: Optional[Iterable[str]] = None) -> List[Finding]:
    rel = os.path.relpath(os.path.abspath(path), os.path.abspath(root))
    with open(path, encoding="utf-8", errors="replace") as f:
        return lint_source(f.read(), rel, path, rules)


def lint_paths(paths: Iterable[str], root: str,
               rules: Optional[Iterable[str]] = None) -> List[Finding]:
    """Lint every .py under the given files/directories."""
    out: List[Finding] = []
    for p in paths:
        if os.path.isdir(p):
            for base, dirs, files in os.walk(p):
                dirs[:] = [d for d in dirs
                           if d not in ("__pycache__", ".git")]
                for fn in sorted(files):
                    if fn.endswith(".py"):
                        out.extend(lint_file(os.path.join(base, fn), root,
                                             rules))
        elif p.endswith(".py"):
            out.extend(lint_file(p, root, rules))
    return out


# ---------------------------------------------------------------------------
# baseline

class Baseline:
    """Known-findings set: only NEW findings fail (the tree starts green,
    drift is caught)."""

    def __init__(self, fingerprints: Set[str], path: Optional[str] = None):
        self.fingerprints = fingerprints
        self.path = path

    def new_findings(self, findings: List[Finding]) -> List[Finding]:
        return [f for f in findings
                if f.fingerprint() not in self.fingerprints]

    @staticmethod
    def from_findings(findings: List[Finding],
                      path: Optional[str] = None) -> "Baseline":
        return Baseline({f.fingerprint() for f in findings}, path)

    def save(self, path: str, findings: List[Finding]) -> None:
        entries = [{"rule": f.rule, "path": f.path,
                    "line": f.src_line.strip(),
                    "fingerprint": f.fingerprint()}
                   for f in sorted(findings,
                                   key=lambda x: (x.path, x.line))]
        with open(path, "w") as fp:
            json.dump({"version": 1, "entries": entries}, fp, indent=1)
            fp.write("\n")


def load_baseline(path: str) -> Baseline:
    """Missing file -> empty baseline (a fresh tree has nothing
    grandfathered); malformed -> error, a torn baseline must not
    silently whitelist everything new."""
    if not os.path.exists(path):
        return Baseline(set(), path)
    with open(path) as fp:
        data = json.load(fp)
    return Baseline({e["fingerprint"] for e in data.get("entries", [])},
                    path)
