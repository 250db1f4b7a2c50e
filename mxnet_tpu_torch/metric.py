"""Evaluation metrics (counterpart of ``mxnet_tpu/metric.py``).

The reference's zoo with the same names and ``(name, value)`` streaming
interface: accuracy, top-k, binary F1, MAE/MSE/RMSE, cross-entropy,
torch-criterion mean, callable-backed custom metrics, the composite
fan-out, ``OutputSlice``, ``OutputMean``, ``np_metric`` (alias ``np``) and
``create``.  A host metric scores numpy copies of the arrays.

A metric with a device form (``_device_score``: accuracy, top-k,
cross-entropy and the regression trio) keeps its running score sum on
the predictions' device and its instance count on the host: ``update``
is tensor ops only, and reading ``sum_metric`` (or ``get()``) copies one
scalar back.  ``device_reducer()`` carries a (sum, count) pair of 0-d
float32 tensors through the superstep's K steps on the device, drained
once per K; a float sum continues the metric's own running total, so K
steps per drain and one step at a time add the same float32 values in
the same order, and integer hit counts stay exact.  The argmax picks
the lowest index among equal scores, as numpy's does.
"""
from __future__ import annotations

import numpy as _np
import torch

from .ndarray import NDArray

__all__ = ["EvalMetric", "DeviceReducer", "Accuracy", "TopKAccuracy", "F1",
           "MAE", "MSE", "RMSE", "CrossEntropy", "Torch", "CustomMetric",
           "CompositeEvalMetric", "OutputSlice", "OutputMean", "np_metric",
           "create", "check_label_shapes", "host_syncs"]

# device accumulators read back to the host (each a synchronizing copy)
_HOST_SYNCS = [0]


def host_syncs() -> int:
    """How many times a metric's device totals were copied back to the
    host (a superstep's drain counts one)."""
    return _HOST_SYNCS[0]


def note_host_sync() -> None:
    _HOST_SYNCS[0] += 1


def check_label_shapes(labels, preds, shape=0):
    """Compare list lengths (shape=0) or array shapes (shape=1)."""
    a = labels.shape if shape else len(labels)
    b = preds.shape if shape else len(preds)
    if a != b:
        raise ValueError(
            "Shape of labels {} does not match shape of predictions {}"
            .format(a, b))


def _host(x):
    """One device->host conversion point for every host metric."""
    if isinstance(x, NDArray):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return _np.asarray(x)


def _tensor(x):
    if isinstance(x, NDArray):
        return x._get()
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(_np.asarray(x))


def _ratio(num, den):
    return num / den if den else 0.0


def _zeros_pair(device):
    return (torch.zeros((), dtype=torch.float32, device=device),
            torch.zeros((), dtype=torch.float32, device=device))


class DeviceReducer:
    """On-device form of a metric for the superstep (reference
    metric.py:49): the accumulator is a pair of 0-d float32 tensors (a
    tuple of pairs for a composite) on the step's device.

    * ``signature``: hashable config key (e.g. ``("TopKAccuracy", 5)``);
    * ``init(device)``: the accumulator the K steps start from;
    * ``update(acc, labels, preds)``: tensor ops only (no host copy, so
      it can run inside a captured CUDA graph) -> the new accumulator;
    * ``absorb(host_acc)``: fold the drained (host) accumulator into the
      metric, once per superstep.
    """

    def __init__(self, signature, init, update, absorb):
        self.signature = signature
        self.init = init
        self.update = update
        self.absorb = absorb


class EvalMetric:
    """Streaming metric: accumulates (score_sum, instance_count) pairs
    and reports their ratio (reference metric.py:14).  ``num`` switches
    the accumulators to per-slot lists."""

    def __init__(self, name, num=None):
        self.name = name
        self.num = num
        self.reset()

    def reset(self):
        zero = (0, 0.0) if self.num is None else \
            ([0] * self.num, [0.0] * self.num)
        self.num_inst, self.sum_metric = zero

    def _score(self, label, pred):
        """Per-(label, pred) numpy score: return (score_sum, count)."""
        raise NotImplementedError()

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            s, n = self._score(_host(label), _host(pred))
            self.sum_metric += s
            self.num_inst += n

    # -- device form ----------------------------------------------------------
    _device_sum_integral = False

    def _device_score(self, label, pred):
        """Tensor mirror of ``_score`` on the predictions' device ->
        (0-d score sum, count).  The base marks the metric host-only."""
        raise NotImplementedError()

    def _device_signature(self):
        return (type(self).__name__,)

    def _has_device_form(self) -> bool:
        """The reference's mro rule: a device form counts only when it is
        declared at least as derived as every host form (``_score``,
        ``update``, ``_residuals``); a subclass that re-derives the host
        math alone keeps the host path."""
        if self.num is not None:
            return False

        def definer(name):
            for c in type(self).__mro__:
                if name in c.__dict__:
                    return c
            return None
        dev = definer("_device_score")
        if dev is None or dev is EvalMetric:
            return False
        for host_name in ("_score", "update", "_residuals"):
            host = definer(host_name)
            if host is not None and host is not _DeviceMetric \
                    and not issubclass(dev, host):
                return False
        return True

    def device_reducer(self):
        """-> :class:`DeviceReducer`, or None when this metric has no
        device form (the superstep then runs one step at a time)."""
        return None

    def get(self):
        if self.num is None:
            value = (self.sum_metric / self.num_inst if self.num_inst
                     else float("nan"))
            return (self.name, value)
        names = ["%s_%d" % (self.name, i) for i in range(self.num)]
        values = [_ratio(s, n) if n else float("nan")
                  for s, n in zip(self.sum_metric, self.num_inst)]
        return (names, values)

    def get_name_value(self):
        names, values = self.get()
        if not isinstance(names, list):
            names, values = [names], [values]
        return list(zip(names, values))

    def __str__(self):
        return "EvalMetric: {}".format(dict(self.get_name_value()))


class _DeviceMetric(EvalMetric):
    """A metric with a device form.  The instance count is kept on the
    host (each batch's count is known from shapes); the score sum runs
    on the predictions' device (``_acc``) on top of a host part
    (``_carry``).  Integer sums (hit counts) are int64 on the device in
    the one-step path and fold into a host int, so they stay exact; a
    float sum is one float32 running total that the superstep continues,
    so K steps per drain and one step at a time add the same floats in
    the same order."""

    def reset(self):
        self._acc = None
        self._carry = 0 if self._device_sum_integral else 0.0
        self._n = 0

    def _sum(self):
        if self._acc is None:
            return self._carry
        value = self._acc.item()
        note_host_sync()
        if self._device_sum_integral:
            return self._carry + int(value)
        return value

    @property
    def sum_metric(self):
        return self._sum()

    @sum_metric.setter
    def sum_metric(self, value):
        self._acc = None
        self._carry = value

    @property
    def num_inst(self):
        return self._n

    @num_inst.setter
    def num_inst(self, value):
        self._n = value

    def get(self):
        n = self._n
        return (self.name, self._sum() / n if n else float("nan"))

    def _running(self, device):
        """The float running total as a device tensor."""
        if self._acc is not None:
            return self._acc
        return torch.tensor(float(self._carry), dtype=torch.float32,
                            device=device)

    def update(self, labels, preds):
        if not self._has_device_form():
            EvalMetric.update(self, labels, preds)
            return
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            p = _tensor(pred)
            ds, dn = self._device_score(
                _tensor(label).to(p.device, non_blocking=True), p)
            if self._device_sum_integral:
                self._acc = ds if self._acc is None else self._acc + ds
            else:
                self._acc = self._running(p.device) + ds.to(torch.float32)
            self._n += int(dn)

    def _device_update(self, acc, labels, preds):
        check_label_shapes(labels, preds)
        s, n = acc
        for label, pred in zip(labels, preds):
            p = _tensor(pred)
            ds, dn = self._device_score(
                _tensor(label).to(p.device, non_blocking=True), p)
            s = s + ds.to(torch.float32)
            n = n + float(dn)
        return (s, n)

    def device_reducer(self):
        if not self._has_device_form():
            return None
        integral = self._device_sum_integral

        def init(device="cpu"):
            device = torch.device(device)
            s = torch.zeros((), dtype=torch.float32, device=device) \
                if integral else self._running(device)
            return (s, torch.zeros((), dtype=torch.float32, device=device))

        def absorb(host_acc):
            s, n = float(host_acc[0]), float(host_acc[1])
            if integral:
                self._carry += int(round(s))
            else:
                self._acc = None
                self._carry = s
            self._n += int(round(n))

        return DeviceReducer(self._device_signature(), init,
                             self._device_update, absorb)


_METRIC_REGISTRY = {}


def _register(*aliases):
    def deco(cls):
        for alias in aliases:
            _METRIC_REGISTRY[alias] = cls
        return cls
    return deco


@_register("acc", "accuracy")
class Accuracy(_DeviceMetric):
    """Fraction of exact class matches (reference metric.py:66)."""

    _device_sum_integral = True

    def __init__(self):
        super().__init__("accuracy")

    def _score(self, label, pred):
        yp = (_np.argmax(pred, axis=1) if pred.ndim > 1 and pred.shape[1] > 1
              else pred).astype("int64").ravel()
        yt = label.astype("int64").ravel()
        check_label_shapes(yt, yp, shape=1)
        return int(_np.count_nonzero(yp == yt)), yt.size

    def _device_score(self, label, pred):
        yp = torch.argmax(pred, dim=1) if pred.dim() > 1 and \
            pred.shape[1] > 1 else pred
        yp = yp.to(torch.int64).reshape(-1)
        yt = label.to(torch.int64).reshape(-1)
        check_label_shapes(yt, yp, shape=1)
        return torch.count_nonzero(yp == yt), yt.numel()


@_register("top_k_accuracy")
class TopKAccuracy(_DeviceMetric):
    """Hit rate of the true class among the k highest-scored classes
    (reference metric.py:84)."""

    _device_sum_integral = True

    def __init__(self, **kwargs):
        super().__init__("top_k_accuracy")
        self.top_k = kwargs.get("top_k", 1)
        assert self.top_k > 1, \
            "top_k must exceed 1 (plain Accuracy covers k=1)"
        self.name = "top_k_accuracy_%d" % self.top_k

    def _score(self, label, pred):
        yt = label.astype("int64").ravel()
        if pred.ndim == 1:
            return int(_np.count_nonzero(pred.astype("int64") == yt)), \
                yt.size
        rows, classes = pred.shape
        k = min(self.top_k, classes)
        best = _np.argpartition(pred.astype("float32"), classes - k,
                                axis=1)[:, classes - k:]
        return int(_np.count_nonzero(best == yt[:, None])), rows

    def _device_signature(self):
        return ("TopKAccuracy", self.top_k)

    def _device_score(self, label, pred):
        assert pred.dim() <= 2, "predictions must be at most 2-d"
        yt = label.to(torch.int64).reshape(-1)
        if pred.dim() == 1:
            return torch.count_nonzero(pred.to(torch.int64) == yt), \
                yt.numel()
        rows, classes = pred.shape
        if yt.shape[0] != rows:
            raise ValueError("labels (%d) vs predictions (%d) row mismatch"
                             % (yt.shape[0], rows))
        k = min(self.top_k, classes)
        best = torch.topk(pred.float(), k, dim=1).indices
        return torch.count_nonzero(best == yt[:, None]), rows


@_register("f1")
class F1(EvalMetric):
    """Binary F1 over argmax predictions, averaged per batch (reference
    metric.py:123)."""

    def __init__(self):
        super().__init__("f1")

    def _score(self, label, pred):
        yt = label.astype("int64").ravel()
        yp = _np.argmax(pred, axis=1).ravel()
        check_label_shapes(label, pred)
        if _np.unique(yt).size > 2:
            raise ValueError(
                "F1 currently only supports binary classification.")
        tp = int(_np.count_nonzero((yp == 1) & (yt == 1)))
        fp = int(_np.count_nonzero((yp == 1) & (yt == 0)))
        fn = int(_np.count_nonzero((yp == 0) & (yt == 1)))
        precision = _ratio(tp, tp + fp)
        recall = _ratio(tp, tp + fn)
        return _ratio(2 * precision * recall, precision + recall), 1


@_register("ce")
class CrossEntropy(_DeviceMetric):
    """Mean negative log-likelihood of the true class (reference
    metric.py:258)."""

    def __init__(self):
        super().__init__("cross-entropy")

    def _score(self, label, pred):
        yt = label.ravel().astype("int64")
        assert yt.shape[0] == pred.shape[0]
        picked = pred[_np.arange(yt.shape[0]), yt]
        return float(-_np.log(picked + 1e-12).sum()), yt.shape[0]

    def _device_score(self, label, pred):
        yt = label.reshape(-1).to(torch.int64)
        picked = torch.gather(pred, 1, yt[:, None])[:, 0]
        return -torch.sum(torch.log(picked + 1e-12)), yt.shape[0]


class _ResidualMetric(_DeviceMetric):
    """Regression trio frame: 1-d labels are column vectors."""

    def _residuals(self, label, pred):
        if label.ndim == 1:
            label = label[:, None]
        return label - pred


@_register("mae")
class MAE(_ResidualMetric):
    """Mean absolute error (reference metric.py:204)."""

    def __init__(self):
        super().__init__("mae")

    def _score(self, label, pred):
        return float(_np.abs(self._residuals(label, pred)).mean()), 1

    def _device_score(self, label, pred):
        return torch.abs(self._residuals(label, pred)).mean(), 1


@_register("mse")
class MSE(_ResidualMetric):
    """Mean squared error (reference metric.py:222)."""

    def __init__(self):
        super().__init__("mse")

    def _score(self, label, pred):
        return float(_np.square(self._residuals(label, pred)).mean()), 1

    def _device_score(self, label, pred):
        return torch.square(self._residuals(label, pred)).mean(), 1


@_register("rmse")
class RMSE(_ResidualMetric):
    """Root mean squared error (reference metric.py:240)."""

    def __init__(self):
        super().__init__("rmse")

    def _score(self, label, pred):
        r = self._residuals(label, pred)
        return float(_np.sqrt(_np.square(r).mean())), 1

    def _device_score(self, label, pred):
        return torch.sqrt(torch.square(self._residuals(label, pred))
                          .mean()), 1


@_register("torch")
class Torch(EvalMetric):
    """Mean of criterion outputs; labels are ignored."""

    def __init__(self):
        super().__init__("torch")

    def update(self, _, preds):
        for pred in preds:
            self.sum_metric += float(_host(pred).mean())
        self.num_inst += 1


class CustomMetric(EvalMetric):
    """Wrap ``feval(label, pred)`` over numpy arrays (reference
    metric.py:278); feval returns a scalar (count 1) or (sum, count)."""

    def __init__(self, feval, name=None, allow_extra_outputs=False):
        if name is None:
            name = feval.__name__
            if "<" in name:
                name = "custom(%s)" % name
        super().__init__(name)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            check_label_shapes(labels, preds)
        for pred, label in zip(preds, labels):
            out = self._feval(_host(label), _host(pred))
            s, n = out if isinstance(out, tuple) else (out, 1)
            self.sum_metric += s
            self.num_inst += n


class CompositeEvalMetric(EvalMetric):
    """Fan one update out to several child metrics (reference
    metric.py:320); get() returns parallel name/value lists."""

    def __init__(self, metrics=None, **kwargs):
        self.metrics = list(metrics or [])
        super().__init__("composite")

    def add(self, metric):
        self.metrics.append(metric)

    def get_metric(self, index):
        if 0 <= index < len(self.metrics):
            return self.metrics[index]
        return ValueError("Metric index {} is out of range 0 and {}"
                          .format(index, len(self.metrics)))

    def update(self, labels, preds):
        for child in self.metrics:
            child.update(labels, preds)

    def reset(self):
        for child in getattr(self, "metrics", []):
            if hasattr(child, "reset"):
                child.reset()

    def get(self):
        pairs = [child.get() for child in self.metrics]
        return ([n for n, _ in pairs], [v for _, v in pairs])

    def device_reducer(self):
        """A tuple of the children's accumulators, available when every
        child has a device form (a host-only child would drop out of the
        superstep's totals)."""
        reducers = [child.device_reducer()
                    if callable(getattr(child, "device_reducer", None))
                    else None for child in self.metrics]
        if not reducers or any(r is None for r in reducers):
            return None

        def init(device="cpu"):
            return tuple(r.init(device) for r in reducers)

        def update(acc, labels, preds):
            return tuple(r.update(a, labels, preds)
                         for r, a in zip(reducers, acc))

        def absorb(acc):
            for r, a in zip(reducers, acc):
                r.absorb(a)

        return DeviceReducer(tuple(r.signature for r in reducers),
                             init, update, absorb)


class OutputSlice(EvalMetric):
    """The child metric sees only ``preds[start:stop]`` (labels pass
    through), for graphs that group extra heads onto the output."""

    def __init__(self, metric, start=0, stop=1, **kwargs):
        self._child = metric if isinstance(metric, EvalMetric) \
            else create(metric, **kwargs)
        self._start, self._stop = start, stop
        super().__init__(self._child.name)

    def update(self, labels, preds):
        self._child.update(labels, preds[self._start:self._stop])

    def reset(self):
        if hasattr(self, "_child"):
            self._child.reset()

    def get(self):
        return self._child.get()

    def device_reducer(self):
        r = self._child.device_reducer()
        if r is None:
            return None
        start, stop = self._start, self._stop

        def update(acc, labels, preds):
            return r.update(acc, labels, preds[start:stop])

        return DeviceReducer(("output_slice", start, stop, r.signature),
                             r.init, update, r.absorb)


class OutputMean(EvalMetric):
    """Stream the mean of one output head, accumulated in float32."""

    def __init__(self, index, name=None):
        self.index = int(index)
        super().__init__(name or "output%d_mean" % index)

    def update(self, labels, preds):
        del labels
        arr = _host(preds[self.index])
        self.sum_metric = float(_np.float32(
            _np.float32(self.sum_metric) + arr.astype(_np.float32).mean()))
        self.num_inst += 1

    def device_reducer(self):
        idx = self.index

        def update(acc, labels, preds):
            s, n = acc
            return (s + _tensor(preds[idx]).float().mean(), n + 1.0)

        def absorb(acc):
            self.sum_metric += float(acc[0])
            self.num_inst += int(round(float(acc[1])))

        return DeviceReducer(("output_mean", idx),
                             lambda device="cpu": _zeros_pair(device),
                             update, absorb)


def np_metric(numpy_feval, name=None, allow_extra_outputs=False):
    """numpy feval -> CustomMetric (``mx.metric.np``)."""
    def feval(label, pred):
        return numpy_feval(label, pred)
    feval.__name__ = numpy_feval.__name__
    return CustomMetric(feval, name, allow_extra_outputs)


def create(metric, **kwargs):
    """Metric from a name, callable, instance, or list thereof
    (reference metric.py:375)."""
    if callable(metric):
        return CustomMetric(metric)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for child in metric:
            composite.add(create(child, **kwargs))
        return composite
    try:
        return _METRIC_REGISTRY[metric.lower()](**kwargs)
    except Exception:
        raise ValueError("Metric must be either callable or in {}".format(
            sorted(_METRIC_REGISTRY)))


np = np_metric
