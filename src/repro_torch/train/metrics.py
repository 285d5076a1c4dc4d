# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Evaluation metrics, the counterpart of ``repro/train/metrics.py``.
AUPRC (area under the precision-recall curve) is the paper's Figure-1
metric, computed as average precision over the ranked scores. Host-side
numpy: scores arrive here already on the host."""
from __future__ import annotations

import numpy as np


def auprc(scores, labels) -> float:
    """Average precision. labels in {-1,+1} (or {0,1}); scores any real."""
    s = np.asarray(scores, np.float64)
    y = (np.asarray(labels) > 0).astype(np.float64)
    order = np.argsort(-s, kind="stable")
    y = y[order]
    tp = np.cumsum(y)
    k = np.arange(1, len(y) + 1)
    precision = tp / k
    n_pos = y.sum()
    if n_pos == 0:
        return 0.0
    # AP = mean of precision at each positive
    return float((precision * y).sum() / n_pos)


def accuracy(scores, labels) -> float:
    s = np.asarray(scores)
    y = np.asarray(labels) > 0
    return float(((s > 0) == y).mean())


def log_loss(scores, labels) -> float:
    """Mean log(1 + exp(-y m)) in float64 (the reference sums in float32)."""
    m = np.asarray(scores, np.float64)
    y = np.where(np.asarray(labels) > 0, 1.0, -1.0)
    return float(np.mean(np.logaddexp(0.0, -y * m)))


def metrics_from_scores(scores, labels) -> dict:
    """The paper's Figure-1 metric set from precomputed scores, shared by
    :func:`glm_eval_fn` and ``repro_torch.api.make_design_eval``."""
    return {
        "auprc": auprc(scores, labels),
        "accuracy": accuracy(scores, labels),
        "logloss": log_loss(scores, labels),
    }


def glm_eval_fn(X_test, y_test):
    """eval_fn for the regularization path: test AUPRC, accuracy and log
    loss from a host-resident (numpy) test matrix. A tensor beta crosses
    to the host in one counted read (``core.engine.host_array``)."""
    X = np.asarray(X_test, np.float32)

    def fn(beta):
        from repro_torch.core import engine

        b = engine.host_array(beta.detach()) if hasattr(beta, "detach") else np.asarray(beta)
        return metrics_from_scores(X @ b, y_test)

    return fn
