"""Evaluation metrics, host-side NumPy: the port's copy of
``dsgcn_tpu/core/metrics.py`` (reference pyskl/core/evaluation.py
top_k_accuracy :107-126, mean_class_accuracy + confusion_matrix :21-104,
mean_average_precision :129-196; the feature-space metrics of
datasets/base.py:198-221)."""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def confusion_matrix(y_pred, y_real,
                     normalize: Optional[str] = None) -> np.ndarray:
    """Counts of (true, predicted) label pairs over the labels present;
    ``normalize`` 'true' (rows), 'pred' (columns) or 'all' divides, empty
    rows or columns giving zeros."""
    if normalize not in ("true", "pred", "all", None):
        raise ValueError("normalize must be one of {'true', 'pred', 'all', "
                         "None}")
    y_pred = np.asarray(y_pred, dtype=np.int64)
    y_real = np.asarray(y_real, dtype=np.int64)
    label_set = np.unique(np.concatenate((y_pred, y_real)))
    num_labels = len(label_set)
    label_map = np.zeros(label_set[-1] + 1, dtype=np.int64)
    for i, label in enumerate(label_set):
        label_map[label] = i
    cm = np.bincount(num_labels * label_map[y_real] + label_map[y_pred],
                     minlength=num_labels ** 2).reshape(num_labels,
                                                        num_labels)
    with np.errstate(all="ignore"):
        if normalize == "true":
            cm = cm / cm.sum(axis=1, keepdims=True)
        elif normalize == "pred":
            cm = cm / cm.sum(axis=0, keepdims=True)
        elif normalize == "all":
            cm = cm / cm.sum()
        if normalize is not None:
            cm = np.nan_to_num(cm)
    return cm


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


def binary_precision_recall_curve(y_score: np.ndarray, y_true: np.ndarray):
    """(precision, recall, thresholds) of a binary problem, thresholds
    descending (reference evaluation.py:~150)."""
    desc = np.argsort(y_score, kind="mergesort")[::-1]
    y_score = y_score[desc]
    y_true = y_true[desc]
    distinct = np.where(np.diff(y_score))[0]
    threshold_idxs = np.r_[distinct, y_true.size - 1]
    tps = np.cumsum(y_true)[threshold_idxs]
    fps = 1 + threshold_idxs - tps
    thresholds = y_score[threshold_idxs]
    with np.errstate(all="ignore"):
        precision = tps / (tps + fps)
    precision = np.nan_to_num(precision)
    recall = tps / tps[-1] if tps[-1] > 0 else np.zeros_like(tps)
    last_ind = tps.searchsorted(tps[-1])
    sl = slice(last_ind, None, -1)
    return (np.r_[precision[sl], 1], np.r_[recall[sl], 0], thresholds[sl])


def mean_average_precision(scores, labels) -> float:
    """Multi-label mAP: each class's AP from its precision-recall curve,
    the mean over the classes whose AP is a number (reference
    evaluation.py:129-196).  ``labels``: (N, classes) 0/1."""
    scores = np.asarray(scores)
    labels = np.asarray(labels)
    results = []
    for c in range(scores.shape[1]):
        precision, recall, _ = binary_precision_recall_curve(
            scores[:, c], labels[:, c])
        results.append(-np.sum(np.diff(recall) * np.array(precision)[:-1]))
    results = [x for x in results if not np.isnan(x)]
    return float(np.mean(results)) if results else np.nan


def per_class_graph(results, labels) -> List[np.ndarray]:
    """The per-class mean of extracted features or graphs, the 'graph'
    metric (reference datasets/base.py:212-221).  As the reference (and
    JAX), it runs over ``range(max(label))`` and so leaves out the highest
    class id (base.py:216)."""
    labels = np.asarray(labels)
    results = np.asarray(results)
    return [results[labels == i].mean(axis=0) for i in range(labels.max())]


def _tsne_metric(s, l, device=None):
    from ..utils.analysis import tsne_map
    return {"TSNEmap": tsne_map(np.asarray(s), device=device),
            "labels": np.asarray(l)}


METRICS = {
    "top_k_accuracy": lambda s, l: dict(zip(
        ("top1_acc", "top5_acc"), top_k_accuracy(s, l, (1, 5)))),
    "mean_class_accuracy": lambda s, l: {
        "mean_class_accuracy": mean_class_accuracy(s, l)[0]},
    "mean_average_precision": lambda s, l: {
        "mean_average_precision": mean_average_precision(s, l)},
    # feature-space metrics: the results are features or graphs, not class
    # scores (reference base.py:198-221)
    "graph": lambda s, l: {"graph": per_class_graph(s, l)},
    "confusion_matrix": lambda s, l: {
        "confusion_matrix": mean_class_accuracy(s, l)[1]},
    "TSNEmap": _tsne_metric,
}


def evaluate(scores, labels, metrics: Sequence[str] = ("top_k_accuracy",),
             device=None):
    """Named metrics of the results (reference datasets/base.py:111-237).
    Multi-head results, each sample's result a list or tuple, recurse per
    position with ``_i``-suffixed keys (base.py:140-147).  ``device``: where
    'TSNEmap' runs its iterations (``utils/analysis.py:tsne_map``; default
    the CUDA device)."""
    if isinstance(scores, (list, tuple)) and len(scores) \
            and isinstance(scores[0], (list, tuple)):
        out = {}
        for i in range(len(scores[0])):
            sub = evaluate([x[i] for x in scores], labels, metrics, device)
            out.update({f"{k}_{i}": v for k, v in sub.items()})
        return out
    unknown = [m for m in metrics if m not in METRICS]
    if unknown:
        raise KeyError(f"unknown metrics {unknown} (known: "
                       f"{sorted(METRICS)})")
    out = {}
    for m in metrics:
        fn = METRICS[m]
        out.update(fn(np.asarray(scores), labels, device) if m == "TSNEmap"
                   else fn(np.asarray(scores), labels))
    return out
