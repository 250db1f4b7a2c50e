"""Build observability: where cold-start time goes, per program
(counterpart of ``mxnet_tpu/compile_cache/stats.py``).

One process-wide :class:`CompileStats`, fed by every ``cached_program``
wrapper (the fused step's captures, an executor's warm walk, a serve
bucket) and by the kernels' library builds, and shown by
``mx.profiler.compile_report()/_str()``.

Per program name: the distinct descriptions built (``variants``: a
program's ``fast_key``, what its configuration was), build seconds (for
an in-process program the bind and
the walk, and on the card the eager warm-up and the CUDA graph capture;
for a kernel library the nvcc run), load seconds of a library taken from
the store, hits, misses, bypasses with their reason, bytes published,
and ``steady_rebuilds``: the number of times a program object that had
already been built once was built again for a new input signature.  It
is the counterpart of the reference's retrace counter: a nonzero count
is a shape or dtype wobble that captures a new graph in a steady loop.
"""
from __future__ import annotations

from typing import Dict, Optional

from ..base import make_lock


class _ProgramStats:
    __slots__ = ("build_s", "load_s", "hits", "misses", "bypasses",
                 "builds", "rebuilds", "bypass_reasons", "bytes",
                 "variants")

    def __init__(self):
        self.build_s = 0.0
        self.load_s = 0.0
        self.hits = 0
        self.misses = 0
        self.bypasses = 0
        self.builds = 0
        self.rebuilds = 0
        self.bytes = 0
        self.bypass_reasons: Dict[str, int] = {}
        # the distinct program descriptions (``fast_key``) built
        self.variants: set = set()

    def report(self) -> dict:
        out = {"build_s": self.build_s, "load_s": self.load_s,
               "hits": self.hits, "misses": self.misses,
               "bypasses": self.bypasses, "builds": self.builds,
               "steady_rebuilds": self.rebuilds, "bytes": self.bytes,
               "variants": len(self.variants)}
        if self.bypass_reasons:
            out["bypass_reasons"] = dict(self.bypass_reasons)
        return out


class CompileStats:
    """Per-name build counters (thread-safe: warm-up pools build many
    programs at once)."""

    def __init__(self, name: str = "compile"):
        self.name = name
        self._lock = make_lock("compile_cache.stats")
        self._programs: Dict[str, _ProgramStats] = {}
        self.bytes_written = 0
        self.entries_written = 0

    def _prog(self, name: str) -> _ProgramStats:
        return self._programs.setdefault(name, _ProgramStats())

    # -- recording ---------------------------------------------------------
    def note_build(self, name: str, seconds: float,
                   rebuild: bool = False,
                   desc: Optional[str] = None) -> None:
        """One build of program ``name``; ``desc`` is the description of
        what built it, so ``variants`` tells builds of differently
        configured programs (remat on and off, mirroring, another
        optimizer) from builds of one program for new shapes."""
        with self._lock:
            ps = self._prog(name)
            ps.build_s += seconds
            ps.builds += 1
            if rebuild:
                ps.rebuilds += 1
            if desc is not None:
                ps.variants.add(desc)

    def note_build_time(self, name: str, seconds: float) -> None:
        """Add seconds to a program's build time without a build (the
        fused step's eager warm-up steps before its capture)."""
        with self._lock:
            self._prog(name).build_s += seconds

    def note_hit(self, name: str, seconds: float) -> None:
        with self._lock:
            ps = self._prog(name)
            ps.load_s += seconds
            ps.hits += 1

    def note_miss(self, name: str) -> None:
        with self._lock:
            self._prog(name).misses += 1

    def note_bypass(self, name: str, reason: str) -> None:
        with self._lock:
            ps = self._prog(name)
            ps.bypasses += 1
            ps.bypass_reasons[reason] = ps.bypass_reasons.get(reason, 0) + 1

    def note_store(self, name: str, nbytes: int) -> None:
        with self._lock:
            if nbytes > 0:
                self._prog(name).bytes += nbytes
                self.bytes_written += nbytes
                self.entries_written += 1

    # -- reporting ---------------------------------------------------------
    def totals(self) -> dict:
        with self._lock:
            progs = [p.report() for p in self._programs.values()]
        tot = {"programs": len(progs)}
        for k in ("build_s", "load_s", "hits", "misses", "bypasses",
                  "builds", "steady_rebuilds"):
            tot[k] = sum(p[k] for p in progs)
        tot["bytes_written"] = self.bytes_written
        tot["entries_written"] = self.entries_written
        lookups = tot["hits"] + tot["misses"]
        tot["hit_rate"] = (tot["hits"] / lookups) if lookups else None
        return tot

    def report(self, cache=None) -> dict:
        """Totals and per-program counters; ``cache`` (a CompileCache)
        adds the disk view (directory, entries, bytes, the reason
        in-process programs bypass it)."""
        with self._lock:
            progs = {n: p.report() for n, p in sorted(self._programs.items())}
        out = {"totals": self.totals(), "per_program": progs}
        if cache is not None:
            out["cache"] = cache.describe()
        return out

    def report_str(self, cache=None) -> str:
        r = self.report(cache=cache)
        t = r["totals"]
        lines = ["%s: %d programs, %d builds (%.2fs), %d hits (%.2fs "
                 "load), %d misses, %d bypasses, %d steady rebuilds"
                 % (self.name, t["programs"], t["builds"], t["build_s"],
                    t["hits"], t["load_s"], t["misses"], t["bypasses"],
                    t["steady_rebuilds"])]
        if t["hit_rate"] is not None:
            lines.append("  hit_rate %.2f" % t["hit_rate"])
        c = r.get("cache")
        if c:
            lines.append("  cache %s: %d entries, %.1f MB on disk"
                         % (c["directory"], c["entries"],
                            c["disk_bytes"] / 2 ** 20))
        for name, p in r["per_program"].items():
            lines.append(
                "  %-40s build %6.2fs  hit/miss/byp %d/%d/%d  rebuilds %d"
                "  variants %d"
                % (name[:40], p["build_s"], p["hits"], p["misses"],
                   p["bypasses"], p["steady_rebuilds"], p["variants"]))
        return "\n".join(lines)


_global_stats: Optional[CompileStats] = None
_stats_lock = make_lock("compile_cache.stats_registry")


def get_stats() -> CompileStats:
    global _global_stats
    with _stats_lock:
        if _global_stats is None:
            _global_stats = CompileStats()
        return _global_stats


def _reset_stats() -> None:   # test hook
    global _global_stats
    with _stats_lock:
        _global_stats = None
