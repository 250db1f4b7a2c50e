"""Automatic symbol naming (counterpart of ``mxnet_tpu/name.py``)."""
from __future__ import annotations

import threading

__all__ = ["NameManager", "Prefix"]


class NameManager:
    """Assigns unique default names to symbols (reference name.py:6-54)."""

    _current = threading.local()

    def __init__(self):
        self._counter = {}
        self._old_manager = None

    def get(self, name, hint):
        if name:
            return name
        if hint not in self._counter:
            self._counter[hint] = 0
        name = "%s%d" % (hint, self._counter[hint])
        self._counter[hint] += 1
        return name

    @classmethod
    def current(cls) -> "NameManager":
        cur = getattr(cls._current, "value", None)
        if cur is None:
            cur = NameManager()
            cls._current.value = cur
        return cur

    def __enter__(self):
        self._old_manager = NameManager.current()
        NameManager._current.value = self
        return self

    def __exit__(self, ptype, value, trace):
        assert self._old_manager is not None
        NameManager._current.value = self._old_manager


class Prefix(NameManager):
    """Name manager that always attaches a prefix (reference name.py:57-78)."""

    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        name = super().get(name, hint)
        return self._prefix + name
