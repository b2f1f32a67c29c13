"""paddle.metric.metrics: the module the reference re-exports its classes
from (paddle_tpu/metric/metrics.py), aliased to the package surface."""
from . import Accuracy, Auc, Metric, Precision, Recall  # noqa: F401

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc"]
