"""Evaluation metrics (counterpart of ``mxnet_tpu/metric.py``).

The reference's zoo with the same names and ``(name, value)`` streaming
interface: accuracy, top-k, binary F1, MAE/MSE/RMSE, cross-entropy,
torch-criterion mean, callable-backed custom metrics, the composite
fan-out, ``OutputSlice``, ``OutputMean``, ``np_metric`` (alias ``np``) and
``create``.  Each host metric scores numpy copies of the arrays.

``Accuracy`` and ``TopKAccuracy`` keep their hit counts on the
predictions' device until ``get()``, the port's counterpart of the
reference's ``DeviceReducer``: a training loop that updates them every
batch copies nothing back to the host and waits for nothing.  The
argmax picks the lowest index among equal scores, as numpy's does.
"""
from __future__ import annotations

import numpy as _np
import torch

from .ndarray import NDArray

__all__ = ["EvalMetric", "Accuracy", "TopKAccuracy", "F1", "MAE", "MSE",
           "RMSE", "CrossEntropy", "Torch", "CustomMetric",
           "CompositeEvalMetric", "OutputSlice", "OutputMean", "np_metric",
           "create", "check_label_shapes"]


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


class _DeviceHits(EvalMetric):
    """Hit counts summed on the predictions' device: ``update`` adds a
    device scalar per batch, ``get`` (or reading ``sum_metric``) folds it
    into the integer total with one copy."""

    def reset(self):
        self._hits = None
        self._sum = 0
        self.num_inst = 0

    @property
    def sum_metric(self):
        if self._hits is not None:
            self._sum += int(self._hits.item())
            self._hits = None
        return self._sum

    @sum_metric.setter
    def sum_metric(self, value):
        self._hits = None
        self._sum = value

    def _hit_count(self, label, pred):
        """(device scalar of hits, instance count)."""
        raise NotImplementedError()

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            p = _tensor(pred)
            hits, n = self._hit_count(
                _tensor(label).to(p.device, non_blocking=True), p)
            self._hits = hits if self._hits is None else self._hits + hits
            self.num_inst += n


_METRIC_REGISTRY = {}


def _register(*aliases):
    def deco(cls):
        for alias in aliases:
            _METRIC_REGISTRY[alias] = cls
        return cls
    return deco


@_register("acc", "accuracy")
class Accuracy(_DeviceHits):
    """Fraction of exact class matches (reference metric.py:66)."""

    def __init__(self):
        super().__init__("accuracy")

    def _hit_count(self, label, pred):
        yp = torch.argmax(pred, dim=1) if pred.dim() > 1 and \
            pred.shape[1] > 1 else pred
        yp = yp.to(torch.int64).reshape(-1)
        yt = label.to(torch.int64).reshape(-1)
        check_label_shapes(yt, yp, shape=1)
        return torch.count_nonzero(yp == yt), yt.numel()


@_register("top_k_accuracy")
class TopKAccuracy(_DeviceHits):
    """Hit rate of the true class among the k highest-scored classes
    (reference metric.py:84)."""

    def __init__(self, **kwargs):
        super().__init__("top_k_accuracy")
        self.top_k = kwargs.get("top_k", 1)
        assert self.top_k > 1, \
            "top_k must exceed 1 (plain Accuracy covers k=1)"
        self.name = "top_k_accuracy_%d" % self.top_k

    def _hit_count(self, label, pred):
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
class CrossEntropy(EvalMetric):
    """Mean negative log-likelihood of the true class (reference
    metric.py:258)."""

    def __init__(self):
        super().__init__("cross-entropy")

    def _score(self, label, pred):
        yt = label.ravel().astype("int64")
        assert yt.shape[0] == pred.shape[0]
        picked = pred[_np.arange(yt.shape[0]), yt]
        return float(-_np.log(picked + 1e-12).sum()), yt.shape[0]


class _ResidualMetric(EvalMetric):
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


@_register("mse")
class MSE(_ResidualMetric):
    """Mean squared error (reference metric.py:222)."""

    def __init__(self):
        super().__init__("mse")

    def _score(self, label, pred):
        return float(_np.square(self._residuals(label, pred)).mean()), 1


@_register("rmse")
class RMSE(_ResidualMetric):
    """Root mean squared error (reference metric.py:240)."""

    def __init__(self):
        super().__init__("rmse")

    def _score(self, label, pred):
        r = self._residuals(label, pred)
        return float(_np.sqrt(_np.square(r).mean())), 1


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
