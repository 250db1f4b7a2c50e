"""Monitor: per-op output statistics during execution (counterpart of
``mxnet_tpu/monitor.py``, reference python/mxnet/monitor.py).

``install`` sets an executor's monitor callback, which sees every node's
outputs as the executor's node-by-node walk makes them; a module with a
monitor installed runs the classic path (its fused step, one captured
graph, has no per-node outputs to show).  Stats stay on the device until
``toc``.
"""
from __future__ import annotations

import logging
import re
from typing import List, Tuple

from .ndarray import NDArray

__all__ = ["Monitor"]


class Monitor:
    """Regex-filtered per-op stats (reference monitor.py:13-120)."""

    def __init__(self, interval, stat_func=None, pattern=".*", sort=False):
        if stat_func is None:
            def asum_stat(x):
                """|x|/size(x), the reference default stat."""
                return NDArray(x._get().abs().sum().reshape(1) / x.size)
            stat_func = asum_stat
        self.stat_func = stat_func
        self.interval = interval
        self.activated = False
        self.queue: List[Tuple[int, str, NDArray]] = []
        self.step = 0
        self.exes = []
        self.re_prog = re.compile(pattern)
        self.sort = sort

    def stat_helper(self, name, arr):
        if not self.activated or not self.re_prog.match(name):
            return
        self.queue.append((self.step, name, self.stat_func(arr)))

    def install(self, exe):
        """Install to an executor (called by the module layers)."""
        exe.set_monitor_callback(self.stat_helper)
        self.exes.append(exe)

    def tic(self):
        """Start collecting stats for the current batch; clears old stats."""
        if self.step % self.interval == 0:
            self.queue = []
            self.activated = True
        self.step += 1

    def toc(self) -> List[Tuple[int, str, str]]:
        """End collection; return the stats of the batch as (step, name,
        text) rows."""
        if not self.activated:
            return []
        self.activated = False
        res = []
        for (n, k, v_list) in self.queue:
            if isinstance(v_list, NDArray):
                v_list = [v_list]
            s = ""
            for v in v_list:
                assert isinstance(v, NDArray)
                if v.shape == (1,):
                    s += str(v.asscalar()) + "\t"
                else:
                    s += str(v.asnumpy()) + "\t"
            res.append((n, k, s))
        self.queue = []
        if self.sort:
            res = sorted(res, key=lambda x: x[1])
        return res

    def toc_print(self):
        res = self.toc()
        for n, k, v in res:
            logging.info("Batch: %7d %30s %s", n, k, v)
