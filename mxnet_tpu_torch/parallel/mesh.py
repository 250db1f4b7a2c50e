"""Device mesh helpers (counterpart of ``mxnet_tpu/parallel/mesh.py``).

The port runs one rank per device, so a mesh is an array of RANKS with
named axes.  ``make_mesh`` builds it from ``(name, size)`` axes (one
``-1`` absorbs the remaining ranks; the ``"dp=4,tp=2"`` string form is
``MXNET_MESH``'s), over the ranks of the process group by default.
Building a mesh makes no group; :meth:`Mesh.axis` does, on first use:
it boots a world-1 group if none is up (``dist.boot.ensure_group``) and
makes one ``torch.distributed`` group per line of ranks along each axis,
every rank making every group in the same order, as ``new_group``
requires.  Two equal meshes share their groups.

``PartitionSpec`` and ``NamedSharding`` are the port's own small types
(the JAX package's are jax's); the spec helpers and their error
messages match the JAX package's.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["make_mesh", "parse_mesh_spec", "mesh_from_env",
           "normalize_spec", "mesh_axes", "spec_axes", "validate_spec",
           "sharding_attrs", "dp_sharding", "replicated",
           "PartitionSpec", "NamedSharding", "Mesh"]

# (axis names, ranks) -> {axis name: {line of ranks: group}}
_GROUPS = {}


class PartitionSpec(tuple):
    """Per-dimension mesh axis names (None: not sharded), as
    ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *entries):
        return tuple.__new__(cls, entries)

    def __repr__(self):
        return "PartitionSpec%s" % (tuple.__repr__(self),)


class Mesh:
    """Ranks on named axes: ``devices`` is the array of ranks, ``shape``
    the ordered ``{axis: size}``."""

    def __init__(self, devices, axis_names: Sequence[str]):
        self.devices = np.asarray(devices, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError("mesh of %d-D ranks has %d axis names"
                             % (self.devices.ndim, len(self.axis_names)))
        self.shape = OrderedDict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def _key(self):
        return (self.axis_names, tuple(self.devices.ravel().tolist()),
                self.devices.shape)

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return "Mesh(%s, ranks=%s)" % (dict(self.shape),
                                       self.devices.ravel().tolist())

    def _groups(self):
        """{axis: {line of ranks: group}}, made on first use by every
        rank in one order."""
        key = self._key()
        groups = _GROUPS.get(key)
        if groups is not None:
            return groups
        from ..dist import boot
        import torch.distributed as dist
        boot.ensure_group()
        world = dist.get_world_size()
        if int(self.devices.max()) >= world:
            raise ValueError("mesh %s names rank %d; the group has %d"
                             % (dict(self.shape), int(self.devices.max()),
                                world))
        groups = {}
        for i, name in enumerate(self.axis_names):
            lines = np.moveaxis(self.devices, i, -1).reshape(
                -1, self.devices.shape[i])
            groups[name] = {}
            for line in lines:
                ranks = tuple(int(r) for r in line)
                groups[name][ranks] = (
                    dist.group.WORLD if ranks == tuple(range(world))
                    else dist.new_group(list(ranks)))
        _GROUPS[key] = groups
        return groups

    def axis(self, name: str):
        """This rank's view of one axis (``collectives.Axis``): its size,
        this rank's index along it and the group of its line."""
        from .collectives import Axis
        from ..dist import boot
        if name not in self.shape:
            raise ValueError("mesh %s has no axis %r"
                             % (dict(self.shape), name))
        groups = self._groups()
        me = boot.rank()
        where = np.argwhere(self.devices == me)
        if not len(where):
            raise ValueError("rank %d is not in mesh %r" % (me, self))
        i = self.axis_names.index(name)
        idx = [int(c) for c in where[0]]
        pos = idx[i]
        idx[i] = slice(None)
        line = tuple(int(r) for r in self.devices[tuple(idx)])
        return Axis(name, len(line), pos, line,
                    groups[name][line])


class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``)."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec

    def __repr__(self):
        return "NamedSharding(%r, %r)" % (self.mesh, self.spec)


def _default_ranks():
    import torch.distributed as dist
    world = dist.get_world_size() if dist.is_available() \
        and dist.is_initialized() else 1
    return list(range(world))


def make_mesh(axes: Sequence[Tuple[str, int]], devices=None) -> Mesh:
    """Create a Mesh from (name, size) axes, e.g. [("dp", 4), ("tp", 2)].

    Sizes may use -1 once to absorb the remaining ranks.  ``axes`` may
    also be the string form ``"dp=4,tp=2"`` (the ``MXNET_MESH`` syntax).
    ``devices``: the ranks to lay out, default every rank of the group
    (one when no group is up).
    """
    if isinstance(axes, str):
        axes = parse_mesh_spec(axes)
    if devices is None:
        devices = _default_ranks()
    devices = list(devices)
    names = [a for a, _ in axes]
    sizes = [int(s) for _, s in axes]
    n = len(devices)
    if any(s == 0 or s < -1 for s in sizes):
        raise ValueError(
            "mesh %s: axis sizes must be positive (-1 to absorb the "
            "remaining devices)" % (axes,))
    if sizes.count(-1) > 1:
        raise ValueError("mesh %s: only one axis may be -1" % (axes,))
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        if known <= 0 or n % known:
            raise ValueError("mesh %s: %d devices do not divide into the "
                             "fixed axes" % (axes, n))
        sizes[sizes.index(-1)] = n // known
    total = int(np.prod(sizes))
    if total > n:
        raise ValueError("mesh %s needs %d devices, have %d" % (axes, total, n))
    arr = np.asarray(devices[:total]).reshape(sizes)
    return Mesh(arr, tuple(names))


def parse_mesh_spec(spec: str) -> List[Tuple[str, int]]:
    """Parse the ``MXNET_MESH`` axis syntax: ``"dp=4,tp=2"`` ->
    ``[("dp", 4), ("tp", 2)]``.  ``-1`` absorbs the remaining ranks
    (``make_mesh`` resolves it)."""
    axes: List[Tuple[str, int]] = []
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                "bad mesh axis %r in %r (expected name=size, e.g. "
                "'dp=4,tp=2')" % (part, spec))
        name, size = part.split("=", 1)
        try:
            axes.append((name.strip(), int(size)))
        except ValueError:
            raise ValueError("bad mesh axis size %r in %r" % (size, spec))
    if not axes:
        raise ValueError("empty mesh spec %r" % (spec,))
    return axes


def mesh_from_env(devices=None) -> Optional[Mesh]:
    """Mesh from the ``MXNET_MESH`` env knob (``"dp=4,tp=2"``), or None
    when the knob is unset/empty."""
    from ..base import get_env
    spec = (get_env("MXNET_MESH", "") or "").strip()
    if not spec:
        return None
    return make_mesh(parse_mesh_spec(spec), devices=devices)


def normalize_spec(spec) -> PartitionSpec:
    """Canonical PartitionSpec from any accepted sharding-spec form:
    a PartitionSpec, a tuple/list of axis names (None entries allowed),
    the comma string form carried by symbol attributes
    (``"None,tp"``), or None (replicated)."""
    if spec is None:
        return PartitionSpec()
    if isinstance(spec, PartitionSpec):
        return spec
    if isinstance(spec, str):
        entries = [p.strip() for p in spec.split(",")]
        return PartitionSpec(*[None if p in ("", "None", "none", "-")
                               else p for p in entries])
    if isinstance(spec, (tuple, list)):
        return PartitionSpec(*[None if e in (None, "None") else e
                               for e in spec])
    raise ValueError(
        "cannot interpret sharding spec %r (want PartitionSpec, "
        "tuple of axis names, or 'None,tp'-style string)" % (spec,))


def mesh_axes(mesh) -> Tuple[Tuple[str, int], ...]:
    """Canonical ((name, size), ...) serialization of a mesh's axes."""
    return tuple((str(a), int(s)) for a, s in mesh.shape.items())


def spec_axes(spec) -> List[str]:
    """The mesh axis names a PartitionSpec (or entry list) references,
    tuple entries flattened, Nones dropped."""
    return [a for e in spec
            for a in (e if isinstance(e, (tuple, list)) else (e,))
            if a is not None]


def validate_spec(name, spec, mesh, shape=None) -> None:
    """Every referenced axis must exist in ``mesh`` and, when ``shape``
    is given, divide its dim evenly (a tuple entry over the PRODUCT of
    its axes).  Raises MXNetError naming the param/axis/dim."""
    from ..base import MXNetError
    sizes = dict(mesh.shape)
    bad = sorted(set(spec_axes(spec)) - set(sizes))
    if bad:
        raise MXNetError(
            "sharding spec for %r uses mesh axes %s not in mesh %s"
            % (name, bad, sizes))
    if shape is None:
        return
    if len(tuple(spec)) > len(shape):
        raise MXNetError(
            "sharding spec %s for %r has %d entries but the array is "
            "%d-D (shape %s)" % (tuple(spec), name, len(tuple(spec)),
                                 len(shape), tuple(shape)))
    for i, entry in enumerate(tuple(spec)[:len(shape)]):
        axes = [a for a in (entry if isinstance(entry, (tuple, list))
                            else (entry,)) if a is not None]
        if not axes:
            continue
        ways = 1
        for a in axes:
            ways *= int(sizes[a])
        if shape[i] % ways:
            raise MXNetError(
                "sharding spec %s for %r: dim %d (%d) is not "
                "divisible by mesh axes %s (%d ways)"
                % (tuple(spec), name, i, shape[i], tuple(axes), ways))


def sharding_attrs(symbol) -> dict:
    """Per-name PartitionSpecs declared on the symbol graph: every
    variable carrying a ``__sharding__`` attribute."""
    specs = {}
    for name, attrs in symbol.attr_dict().items():
        if "__sharding__" in attrs:
            specs[name] = normalize_spec(attrs["__sharding__"])
    return specs


def dp_sharding(mesh: Mesh, axis: str = "dp") -> NamedSharding:
    """Batch-dim sharding over the data-parallel axis."""
    return NamedSharding(mesh, PartitionSpec(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())
