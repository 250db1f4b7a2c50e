"""SFrame plugin parity: a data iterator over columnar frames.

The counterpart of ``mxnet_tpu/plugins/sframe.py`` (reference
plugin/sframe/iter_sframe.cc): a DataIter over any columnar source with
the SFrame access shape, ``len(frame)`` and ``frame[column]`` yielding
array-likes (an ``sframe.SFrame``, a dict of arrays, a pandas
DataFrame).  Batches are host NDArrays, as ``NDArrayIter``'s are, and the
last batch wraps around to pad, as the reference's batch loader does.
"""
from __future__ import annotations

import numpy as np

from ..io import DataBatch, DataIter, nd_array

__all__ = ["SFrameIter"]


class SFrameIter(DataIter):
    """Iterate batches from a columnar frame.

    Parameters mirror the reference SFrameParam: ``data_field`` (one column
    name or list of them, stacked as features), ``label_field`` (optional
    scalar column), ``batch_size``.
    """

    def __init__(self, sframe, data_field, label_field=None, batch_size=1,
                 data_shape=None):
        super().__init__()
        self.frame = sframe
        self.data_fields = ([data_field] if isinstance(data_field, str)
                            else list(data_field))
        self.label_field = label_field
        self.batch_size = batch_size
        n = len(sframe[self.data_fields[0]])
        cols = [np.asarray([np.asarray(v, dtype=np.float32)
                            for v in sframe[f]]) for f in self.data_fields]
        data = np.concatenate([c.reshape(n, -1) for c in cols], axis=1)
        if data_shape is not None:
            data = data.reshape((n,) + tuple(data_shape))
        self._data = data.astype(np.float32)
        if label_field is not None:
            self._label = np.asarray(sframe[label_field],
                                     dtype=np.float32).reshape(n)
        else:
            self._label = np.zeros(n, dtype=np.float32)
        self.cur = 0
        self.provide_data = [("data", (batch_size,) + self._data.shape[1:])]
        self.provide_label = [("softmax_label", (batch_size,))]

    def reset(self):
        self.cur = 0

    def next(self):
        n = self._data.shape[0]
        if self.cur >= n:
            raise StopIteration
        end = self.cur + self.batch_size
        pad = max(0, end - n)
        idx = np.arange(self.cur, end) % n     # wrap padding
        self.cur = end
        return DataBatch(data=[nd_array(self._data[idx])],
                         label=[nd_array(self._label[idx])],
                         pad=pad, index=None)
