"""AttrScope: with-scope symbol attributes (counterpart of
``mxnet_tpu/attribute.py``).

Attributes like ``ctx_group``, ``lr_mult``, ``wd_mult`` and
``force_mirroring`` attach to symbols created inside the scope and are
carried through the symbol JSON unchanged.
"""
from __future__ import annotations

import threading

__all__ = ["AttrScope"]


class AttrScope:
    """Attribute manager for scoping (reference attribute.py:10-62)."""

    _current = threading.local()

    def __init__(self, **kwargs):
        for value in kwargs.values():
            if not isinstance(value, str):
                raise ValueError("Attributes need to be a string")
        self._attr = kwargs
        self._old_scope = None

    def get(self, attr):
        """Merge user-supplied attr dict with the scope's attributes."""
        if self._attr:
            ret = self._attr.copy()
            if attr:
                ret.update(attr)
            return ret
        return attr if attr else {}

    @classmethod
    def current(cls) -> "AttrScope":
        cur = getattr(cls._current, "value", None)
        if cur is None:
            cur = AttrScope()
            cls._current.value = cur
        return cur

    def __enter__(self):
        self._old_scope = AttrScope.current()
        attr = self._old_scope._attr.copy()
        attr.update(self._attr)
        self._attr = attr
        AttrScope._current.value = self
        return self

    def __exit__(self, ptype, value, trace):
        assert self._old_scope is not None
        AttrScope._current.value = self._old_scope
