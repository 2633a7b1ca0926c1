"""Evaluation metrics.

Counterpart of ``mxnet_tpu/metric.py``: ``EvalMetric``,
``CompositeEvalMetric``, ``Accuracy``, ``CrossEntropy`` and ``create``.
Metric math runs in numpy on the host, once per step, as in the
reference.
"""
from __future__ import annotations

import numpy

from .base import MXNetError
from .ndarray import NDArray

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "CrossEntropy",
           "create", "register"]

_METRIC_REGISTRY = {}


def register(klass, *names):
    for name in names or (klass.__name__,):
        _METRIC_REGISTRY[name.lower()] = klass
    return klass


def _alias(*aliases):
    def deco(klass):
        return register(klass, klass.__name__, *aliases)
    return deco


def create(metric, *args, **kwargs):
    """A metric from a name, an instance or a list of either."""
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for child in metric:
            composite.add(create(child, *args, **kwargs))
        return composite
    if isinstance(metric, str):
        if metric.lower() not in _METRIC_REGISTRY:
            raise MXNetError("unknown metric %r" % metric)
        return _METRIC_REGISTRY[metric.lower()](*args, **kwargs)
    raise TypeError("metric should be a str, a list or an EvalMetric")


def check_label_shapes(labels, preds, shape=0):
    if shape == 0:
        label_shape, pred_shape = len(labels), len(preds)
    else:
        label_shape, pred_shape = labels.shape, preds.shape
    if label_shape != pred_shape:
        raise ValueError("Shape of labels {} does not match shape of "
                         "predictions {}".format(label_shape, pred_shape))


def _as_numpy(x):
    return x.asnumpy() if isinstance(x, NDArray) else numpy.asarray(x)


class EvalMetric:
    """Accumulates (sum_metric, num_inst)."""

    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def __str__(self):
        return "EvalMetric: {}".format(dict(self.get_name_value()))

    def update_dict(self, label, pred):
        pred = [pred[n] for n in self.output_names] \
            if self.output_names is not None else list(pred.values())
        label = [label[n] for n in self.label_names] \
            if self.label_names is not None else list(label.values())
        self.update(label, pred)

    def update(self, labels, preds):
        raise NotImplementedError()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name, value = [name], [value]
        return list(zip(name, value))


@register
class CompositeEvalMetric(EvalMetric):
    """Several metrics updated together."""

    def __init__(self, metrics=None, name="composite", output_names=None,
                 label_names=None):
        self.metrics = [create(m) for m in (metrics or [])]
        super().__init__(name, output_names=output_names,
                         label_names=label_names)

    def add(self, metric):
        self.metrics.append(create(metric))

    def update_dict(self, labels, preds):
        for m in self.metrics:
            m.update_dict(labels, preds)

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def reset(self):
        for m in getattr(self, "metrics", []):
            m.reset()

    def get(self):
        names, values = [], []
        for m in self.metrics:
            name, value = m.get()
            names.extend(name if isinstance(name, list) else [name])
            values.extend(value if isinstance(value, list) else [value])
        return (names, values)


@_alias("acc")
class Accuracy(EvalMetric):
    """Classification accuracy; argmax over ``axis`` when the prediction
    has one more dimension than the label."""

    def __init__(self, axis=1, name="accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, axis=axis, output_names=output_names,
                         label_names=label_names)
        self.axis = axis

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred_label in zip(labels, preds):
            pred_label, label = _as_numpy(pred_label), _as_numpy(label)
            if pred_label.ndim > label.ndim:
                pred_label = numpy.argmax(pred_label, axis=self.axis)
            pred_label = pred_label.astype("int32").flatten()
            label = label.astype("int32").flatten()
            check_label_shapes(label, pred_label, shape=1)
            self.sum_metric += (pred_label == label).sum()
            self.num_inst += len(pred_label)


@_alias("ce")
class CrossEntropy(EvalMetric):
    """Mean of -log(p[label] + eps)."""

    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(name, eps=eps, output_names=output_names,
                         label_names=label_names)
        self.eps = eps

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label, pred = _as_numpy(label).ravel(), _as_numpy(pred)
            if label.shape[0] != pred.shape[0]:
                raise ValueError("CrossEntropy: %d labels for %d predictions"
                                 % (label.shape[0], pred.shape[0]))
            prob = pred[numpy.arange(label.shape[0]), numpy.int64(label)]
            self.sum_metric += (-numpy.log(prob + self.eps)).sum()
            self.num_inst += label.shape[0]
