"""Masker evaluation metrics (numpy, host-side): the port's own copy of the
part of the JAX package's ``eval_metrics.py`` that ``eval_masker`` and the
trainer's evaluation use.

Re-design of reference climategan/eval_metrics.py: the F1 score, pixel
accuracy and mIOU (:68-130) of the seg head, masker confusion metrics over
{cannot=0, must=1, may=2} labels (:133-260), the error maps and rates of
each label (``pred_cannot``, ``missed_must``, ``may_flood``; :264-357) and
edges_coherence_std_min (:484-543) without the sklearn/skimage deps
(Sobel + pairwise distances in numpy).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def f1_score(pred: np.ndarray, gt: np.ndarray) -> float:
    """F1 of a soft or binary prediction against a binary ground truth."""
    pred, gt = np.asarray(pred), np.asarray(gt)
    return float(2 * (pred * gt).sum() / max((pred + gt).sum(), 1e-12))


def accuracy(pred: np.ndarray, gt: np.ndarray) -> float:
    """Pixel accuracy of int labels (or logits over the last axis)."""
    pred, gt = np.asarray(pred), np.asarray(gt)
    if gt.ndim == 4 and gt.shape[-1] == 1:
        gt = gt[..., 0]
    if pred.ndim > gt.ndim:
        pred = np.argmax(pred, axis=-1)
    return float((pred == gt).sum()) / gt.size


def mIOU(pred: np.ndarray, label: np.ndarray, average: str = "macro",
         num_classes: Optional[int] = None) -> float:
    """Macro or weighted mean IOU (reference eval_metrics.py:79-130).

    pred: int labels (N, H, W) or logits (N, H, W, C); label: int (N, H, W).
    """
    pred, label = np.asarray(pred), np.asarray(label)
    if pred.ndim == label.ndim + 1:
        num_classes = num_classes or pred.shape[-1]
        pred = np.argmax(pred, axis=-1)
    elif num_classes is None:
        num_classes = int(max(pred.max(), label.max())) + 1

    pred, label = pred.reshape(-1), label.reshape(-1)
    classes = (list(range(num_classes)) if num_classes > 2
               else [int(label.max())])
    ious, weights = [], []
    for c in classes:
        pi, ti = pred == c, label == c
        if ti.sum() > 0 or pi.sum() > 0:
            inter = np.logical_and(pi, ti).sum()
            union = pi.sum() + ti.sum() - inter
            ious.append(inter / union)
            weights.append(pi.sum())
    if not ious:
        return float("nan")
    if average == "weighted":
        return float(np.sum(np.multiply(weights, ious)) / np.sum(weights))
    return float(np.mean(ious))


def masker_classification_metrics(
    pred: np.ndarray,
    label: np.ndarray,
    labels_dict: Dict[str, int] = {"cannot": 0, "must": 1, "may": 2},
) -> Tuple[Dict[str, float], Dict[str, np.ndarray]]:
    """Confusion metrics over {cannot, must, may} ground-truth labels
    (reference eval_metrics.py:133-260)."""
    pred = np.asarray(pred, dtype=float)
    label = np.asarray(label)
    must = (label == labels_dict["must"]).astype(float)
    cannot = (label == labels_dict["cannot"]).astype(float)
    may = (label == labels_dict["may"]).astype(float)
    n = float(np.prod(label.shape))

    tp_map = pred * must
    tn_map = (1.0 - pred) * cannot
    fp_map = pred * cannot
    fn_map = (1.0 - pred) * must
    may_pos_map = pred * may
    may_neg_map = (1.0 - pred) * may

    tpr = tp_map.sum() / max(must.sum(), 1e-12)
    tnr = tn_map.sum() / max(cannot.sum(), 1e-12)
    fpr = fp_map.sum() / max(cannot.sum(), 1e-12)
    fnr = fn_map.sum() / max(must.sum(), 1e-12)
    mnr = may_neg_map.sum() / max(may.sum(), 1e-12)
    mpr = may_pos_map.sum() / max(may.sum(), 1e-12)
    tpt, tnt = tp_map.sum() / n, tn_map.sum() / n
    fpt, fnt = fp_map.sum() / n, fn_map.sum() / n

    acc = tpt + tnt
    error = fpt + fnt
    precision = tp_map.sum() / max(tp_map.sum() + fp_map.sum(), 1e-12)
    beta2 = 0.25  # F0.5
    f05 = ((1 + beta2) * precision * tpr
           / max(beta2 * precision + tpr, 1e-12))
    acc_must_may = (tp_map.sum() + may_neg_map.sum() + may_pos_map.sum()) / max(
        must.sum() + may.sum(), 1e-12
    )

    metrics = {
        "tpr": tpr, "tpt": tpt, "tnr": tnr, "tnt": tnt,
        "fpr": fpr, "fpt": fpt, "fnr": fnr, "fnt": fnt,
        "mnr": mnr, "mpr": mpr, "accuracy": acc, "error": error,
        "precision": precision, "f05": f05,
        "accuracy_must_may": acc_must_may,
    }
    maps = {
        "tp": tp_map, "tn": tn_map, "fp": fp_map, "fn": fn_map,
        "may_pos": may_pos_map, "may_neg": may_neg_map,
    }
    return metrics, maps


def pred_cannot(pred, label, label_cannot: int = 0):
    """False-positive (mask on cannot-flood) map and rate
    (reference eval_metrics.py:264-299)."""
    fp_map = np.asarray(pred, float) * (np.asarray(label) == label_cannot)
    fpr = fp_map.sum() / max((np.asarray(label) == label_cannot).sum(), 1e-12)
    return fp_map, float(fpr)


def missed_must(pred, label, label_must: int = 1):
    """False-negative (missed must-flood) map and rate
    (reference eval_metrics.py:302-330)."""
    fn_map = (1.0 - np.asarray(pred, float)) * (np.asarray(label) == label_must)
    fnr = fn_map.sum() / max((np.asarray(label) == label_must).sum(), 1e-12)
    return fn_map, float(fnr)


def may_flood(pred, label, label_may: int = 2):
    """May-flood maps: (mask on may-flood, no mask on may-flood)
    (reference eval_metrics.py:333-357)."""
    may = np.asarray(label) == label_may
    pred = np.asarray(pred, float)
    return pred * may, (1.0 - pred) * may


def _sobel_mag(x: np.ndarray) -> np.ndarray:
    """skimage.filters.sobel equivalent: gradient magnitude, normalized."""
    kx = np.array([[1, 0, -1], [2, 0, -2], [1, 0, -1]], float) / 4.0
    ky = kx.T
    pad = np.pad(x, 1, mode="edge")
    h, w = x.shape
    win = np.lib.stride_tricks.sliding_window_view(pad, (3, 3))
    gx = (win * kx).sum(axis=(-2, -1))
    gy = (win * ky).sum(axis=(-2, -1))
    return np.sqrt(gx * gx + gy * gy)


def edges_coherence_std_min(pred, label, label_must: int = 1,
                            bin_th: float = 0.5):
    """Std of min distance between prediction edges and must-flood edges
    (reference eval_metrics.py:484-543)."""
    label = np.where(np.asarray(label) == label_must, 1.0, 0.0)
    pred = (np.asarray(pred) > bin_th).astype(float)

    pred_e = _sobel_mag(pred)
    label_e = _sobel_mag(label)

    pred_coord = np.argwhere(pred_e > 0)
    label_coord = np.argwhere(label_e > 0)
    if pred_coord.shape[0] == 0 or label_coord.shape[0] == 0:
        return 1.0, pred_e, label_e

    # pairwise distances, chunked to bound memory
    mins = np.empty(pred_coord.shape[0])
    for i in range(0, pred_coord.shape[0], 4096):
        chunk = pred_coord[i:i + 4096].astype(float)
        d = np.sqrt(
            ((chunk[:, None, :] - label_coord[None, :, :].astype(float)) ** 2
             ).sum(-1)
        )
        mins[i:i + 4096] = d.min(axis=1)
    edge_coherence = float(np.std(mins / pred_e.shape[0]))
    return edge_coherence, pred_e, label_e
