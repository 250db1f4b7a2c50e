"""Run one function on W ranks, each a fresh process (``subprocess``,
never ``fork`` after CUDA is up), joined through the launcher's envs.

``run_ranks("pkg.module:fn", 2, args)`` (or ``"/path/file.py:fn"``)
starts W children with ``MXNET_TPU_COORDINATOR`` set to a ``FileStore``
under a fresh temporary directory and ``MXNET_TPU_NUM_WORKERS`` /
``_WORKER_ID``, so each child's ``import mxnet_tpu_torch`` joins the
group as a ``tools/launch.py`` worker does.
Each child calls ``fn(*args)`` and hands back its pickled result; the
parent returns the W results in rank order.  Every child is waited for
or killed before ``run_ranks`` returns, also on a timeout or a failing
rank, whose output is in the error.

``python -m mxnet_tpu_torch.dist.spawn IN OUT`` is the child's side.
"""
from __future__ import annotations

import importlib
import importlib.util
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time

__all__ = ["run_ranks", "load_target"]


def load_target(target: str):
    """``"module:fn"`` or ``"/path/file.py:fn"`` -> the function."""
    where, name = target.rsplit(":", 1)
    if where.endswith(".py"):
        mod_name = "_spawned_" + os.path.splitext(os.path.basename(where))[0]
        spec = importlib.util.spec_from_file_location(mod_name, where)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[mod_name] = mod
        spec.loader.exec_module(mod)
    else:
        mod = importlib.import_module(where)
    return getattr(mod, name)


def run_ranks(target: str, world: int, args=(), timeout: float = 120.0):
    """-> [fn(*args) on rank r for r in range(world)]."""
    tmp = tempfile.mkdtemp(prefix="mxspawn")
    procs = []
    try:
        with open(os.path.join(tmp, "in.pkl"), "wb") as f:
            pickle.dump((target, tuple(args)), f)
        base = dict(os.environ)
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        base["PYTHONPATH"] = os.pathsep.join(
            [root] + [p for p in base.get("PYTHONPATH", "").split(
                os.pathsep) if p])
        base["MXNET_TPU_COORDINATOR"] = "file://" + os.path.join(tmp, "store")
        base["MXNET_TPU_NUM_WORKERS"] = str(world)
        for r in range(world):
            e = dict(base, MXNET_TPU_WORKER_ID=str(r))
            log = open(os.path.join(tmp, "log%d.txt" % r), "wb")
            procs.append((subprocess.Popen(
                [sys.executable, "-m", "mxnet_tpu_torch.dist.spawn",
                 os.path.join(tmp, "in.pkl"),
                 os.path.join(tmp, "out%d.pkl" % r)],
                env=e, stdout=log, stderr=subprocess.STDOUT), log))
        deadline = time.monotonic() + timeout
        failed = None
        while True:
            codes = [p.poll() for p, _ in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                failed = "rank %d exited with %d" % (bad[0], codes[bad[0]])
                break
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                failed = "timed out after %.0f s" % timeout
                break
            time.sleep(0.05)
        if failed:
            for p, _ in procs:
                if p.poll() is None:
                    p.kill()
            for p, _ in procs:
                p.wait()
            logs = []
            for r in range(world):
                with open(os.path.join(tmp, "log%d.txt" % r), "rb") as f:
                    logs.append("--- rank %d ---\n%s" % (
                        r, f.read()[-4000:].decode(errors="replace")))
            raise RuntimeError("run_ranks(%s, %d): %s\n%s"
                               % (target, world, failed, "\n".join(logs)))
        out = []
        for r in range(world):
            with open(os.path.join(tmp, "out%d.pkl" % r), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            log.close()
        shutil.rmtree(tmp, ignore_errors=True)


def _child(in_path: str, out_path: str) -> None:
    import mxnet_tpu_torch  # noqa: F401  (joins the group)
    from . import boot
    with open(in_path, "rb") as f:
        target, args = pickle.load(f)
    result = load_target(target)(*args)
    with open(out_path + ".tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(out_path + ".tmp", out_path)
    boot.shutdown()


if __name__ == "__main__":
    _child(sys.argv[1], sys.argv[2])
