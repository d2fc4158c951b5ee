"""Evaluation metrics, host-side NumPy: the port's copy of what the trainer
uses from ``dsgcn_tpu/core/metrics.py`` (reference pyskl/core/evaluation.py
top_k_accuracy :107-126, mean_class_accuracy + confusion_matrix :21-104)."""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def confusion_matrix(y_pred, y_real) -> np.ndarray:
    y_pred = np.asarray(y_pred, dtype=np.int64)
    y_real = np.asarray(y_real, dtype=np.int64)
    label_set = np.unique(np.concatenate((y_pred, y_real)))
    num_labels = len(label_set)
    label_map = np.zeros(label_set[-1] + 1, dtype=np.int64)
    for i, label in enumerate(label_set):
        label_map[label] = i
    return np.bincount(num_labels * label_map[y_real] + label_map[y_pred],
                       minlength=num_labels ** 2).reshape(num_labels,
                                                          num_labels)


def top_k_accuracy(scores, labels, topk: Sequence[int] = (1,)) -> List[float]:
    res = []
    labels = np.array(labels)[:, np.newaxis]
    scores = np.asarray(scores)
    for k in topk:
        max_k_preds = np.argsort(scores, axis=1)[:, -k:][:, ::-1]
        match = np.logical_or.reduce(max_k_preds == labels, axis=1)
        res.append(match.sum() / match.shape[0])
    return res


def mean_class_accuracy(scores, labels) -> Tuple[float, np.ndarray]:
    pred = np.argmax(np.asarray(scores), axis=1)
    cm = confusion_matrix(pred, labels).astype(float)
    cls_cnt = cm.sum(axis=1)
    cls_hit = np.diag(cm)
    acc = float(np.mean([hit / cnt if cnt else 0.0
                         for cnt, hit in zip(cls_cnt, cls_hit)]))
    return acc, cm


METRICS = {
    "top_k_accuracy": lambda s, l: dict(zip(
        ("top1_acc", "top5_acc"), top_k_accuracy(s, l, (1, 5)))),
    "mean_class_accuracy": lambda s, l: {
        "mean_class_accuracy": mean_class_accuracy(s, l)[0]},
}


def evaluate(scores, labels, metrics: Sequence[str] = ("top_k_accuracy",)):
    """Named metrics of class scores (reference datasets/base.py:111-237)."""
    unknown = [m for m in metrics if m not in METRICS]
    if unknown:
        raise NotImplementedError(f"metrics {unknown} are not ported yet "
                                  f"(the port has {sorted(METRICS)})")
    out = {}
    for m in metrics:
        out.update(METRICS[m](np.asarray(scores), labels))
    return out
