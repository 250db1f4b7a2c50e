"""Data iterators (counterpart of ``mxnet_tpu/io.py``).

``DataDesc``, ``DataBatch``, the ``DataIter`` protocol and
``NDArrayIter`` (in-memory numpy data with shuffle and the pad, discard
and roll_over last-batch modes), as in the reference.  Batches are
NDArrays on the host (``cpu()``): the module copies each into its bound
arrays on the device.  ``shuffle`` draws its order from numpy's global
stream, as the reference does, so one numpy seed gives one order in both
packages.  The record iterators and the feed pipeline wait (ROADMAP.md,
queue 1 item 9).
"""
from __future__ import annotations

from collections import namedtuple

import numpy as np

from .context import cpu
from .ndarray import NDArray, array as _array

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter"]


def nd_array(a):
    """A host NDArray holding a copy of ``a``."""
    return _array(a, ctx=cpu())


DataDesc = namedtuple("DataDesc", ["name", "shape"])


class DataBatch:
    """One batch (reference io.py DataBatch)."""

    def __init__(self, data, label, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label


class DataIter:
    """Iterator protocol (reference io.py:64)."""

    def __init__(self):
        self.batch_size = 0

    def reset(self):
        pass

    def __iter__(self):
        return self

    def __next__(self):
        return self.next()

    def next(self) -> DataBatch:
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def iter_next(self):
        raise NotImplementedError()

    def getdata(self):
        raise NotImplementedError()

    def getlabel(self):
        raise NotImplementedError()

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError()


def _init_data(data, allow_empty, default_name):
    """Normalize input to list of (name, numpy) (reference io.py:219)."""
    assert data is not None or allow_empty
    if data is None:
        data = []
    if isinstance(data, (np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, list):
        if not allow_empty:
            assert len(data) > 0
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {"_%d_%s" % (i, default_name): d for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise TypeError("Input must be NDArray, numpy.ndarray, a list of them "
                        "or dict with them as values")
    out = {}
    for k, v in data.items():
        if isinstance(v, NDArray):
            v = v.asnumpy()
        out[k] = np.ascontiguousarray(np.asarray(v, dtype=np.float32))
    return list(sorted(out.items()))


class NDArrayIter(DataIter):
    """In-memory iterator with shuffle/pad (reference io.py:319)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data", label_name="softmax_label"):
        super().__init__()
        self.data = _init_data(data, allow_empty=False, default_name=data_name)
        self.label = _init_data(label, allow_empty=True, default_name=label_name)
        self.batch_size = batch_size

        self.num_data = self.data[0][1].shape[0]
        assert self.num_data >= batch_size, \
            "batch_size need to be smaller than data size."

        if shuffle:
            idx = np.arange(self.num_data)
            np.random.shuffle(idx)
            self.data = [(k, v[idx]) for k, v in self.data]
            self.label = [(k, v[idx]) for k, v in self.label]

        if last_batch_handle == "discard":
            new_n = self.num_data - self.num_data % batch_size
            self.data = [(k, v[:new_n]) for k, v in self.data]
            self.label = [(k, v[:new_n]) for k, v in self.label]
            self.num_data = new_n

        self.data_list = [x[1] for x in self.data] + [x[1] for x in self.label]
        self.num_source = len(self.data_list)
        self.last_batch_handle = last_batch_handle
        # Epoch position: `_batch_start` is the first row of the batch most
        # recently handed out (None before the epoch's first batch), and
        # `_wrap_carry` counts head rows a wrapped final batch has already
        # served, so roll_over mode can begin the next epoch past them.
        self._batch_start = None
        self._wrap_carry = 0

    @property
    def provide_data(self):
        return [(k, tuple([self.batch_size] + list(v.shape[1:])))
                for k, v in self.data]

    @property
    def provide_label(self):
        return [(k, tuple([self.batch_size] + list(v.shape[1:])))
                for k, v in self.label]

    def hard_reset(self):
        """Forget the epoch position entirely, including any roll-over."""
        self._batch_start = None
        self._wrap_carry = 0

    def reset(self):
        # After exhaustion, `_batch_start` sits one batch stride past the
        # last served batch; its overshoot beyond the data end equals the
        # head rows a wrapped final batch already consumed.  roll_over
        # starts the next epoch after them; a mid-epoch reset (no
        # overshoot) starts from the top.
        carry = 0
        if self.last_batch_handle == "roll_over" and \
                self._batch_start is not None:
            carry = max(0, self._batch_start - self.num_data)
        self._wrap_carry = carry
        self._batch_start = None

    def iter_next(self):
        if self._batch_start is None:
            self._batch_start = self._wrap_carry
        elif self._batch_start < self.num_data:
            self._batch_start += self.batch_size
        # once exhausted, further probes are no-ops: a consumer retrying
        # next() after StopIteration must not inflate the roll_over carry
        return self._batch_start < self.num_data

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=None)
        raise StopIteration

    def _overhang(self):
        """Rows by which the current batch sticks out past the data end."""
        if self._batch_start is None:
            return 0
        return max(0, self._batch_start + self.batch_size - self.num_data)

    def _getdata(self, data_source):
        start = self._batch_start
        assert start is not None and start < self.num_data, \
            "DataIter need reset."
        if not self._overhang():
            return [nd_array(v[start:start + self.batch_size])
                    for _, v in data_source]
        rows = np.arange(start, start + self.batch_size)
        return [nd_array(v.take(rows, axis=0, mode="wrap"))
                for _, v in data_source]

    def getdata(self):
        return self._getdata(self.data)

    def getlabel(self):
        return self._getdata(self.label)

    def getpad(self):
        return self._overhang() if self.last_batch_handle == "pad" else 0
