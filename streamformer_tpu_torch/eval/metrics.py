"""Evaluation metrics and proposal generation (numpy, host-side): the port's
own copy of the JAX package's ``eval/metrics.py``, which imports no JAX.

Rebuild of the reference's validation helpers
(tools/finetune_tools.py:186-256, :642-947): top-k accuracy, retrieval
Recall@K, grounding threshold/multi-segment proposals + temporal IoU with
R@tIoU, and per-frame mAP / mcAP for online action detection
(downstream/OAD/tools/eval/eval_perframe.py semantics).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def topk_accuracy(logits: np.ndarray, labels: np.ndarray, ks=(1, 5)) -> Dict[str, float]:
    order = np.argsort(-logits, axis=1)
    out = {}
    for k in ks:
        hit = (order[:, :k] == labels[:, None]).any(axis=1)
        out[f"top{k}"] = float(hit.mean() * 100)
    return out


def retrieval_recall(
    sim: np.ndarray, ks=(1, 5, 10), positives: Optional[np.ndarray] = None
) -> Dict[str, float]:
    """sim: (Nq, Ng) query-gallery similarity; positive is the diagonal (or
    ``positives[i]``). Reference banks features then computes R@1
    (tools/finetune_tools.py:741-747,902-944)."""
    nq = sim.shape[0]
    pos = positives if positives is not None else np.arange(nq)
    rank = (sim > sim[np.arange(nq), pos][:, None]).sum(axis=1)
    out = {}
    for k in ks:
        out[f"R@{k}"] = float((rank < k).mean() * 100)
    out["MedR"] = float(np.median(rank + 1))
    return out


def temporal_iou(a: Sequence[float], b: Sequence[float]) -> float:
    """IoU of two [start, end] segments (reference iou,
    finetune_tools.py:251-256 — note: denominator is the union span)."""
    inter = min(a[1], b[1]) - max(a[0], b[0])
    union = max(a[1], b[1]) - min(a[0], b[0])
    return max(inter, 0) / max(union, 1e-9)


def threshold_prob_proposal(
    prob: np.ndarray, timestamps: np.ndarray, factor: float = 0.7
) -> Tuple[float, float]:
    """Single proposal around the argmax, expanded while prob > factor*max
    (reference threshold_prob_proposal, finetune_tools.py:232-248)."""
    max_idx = int(np.argmax(prob))
    threshold = factor * float(prob[max_idx])
    start = max_idx
    while start > 0 and prob[start] > threshold:
        start -= 1
    end = max_idx
    while end < len(prob) - 1 and prob[end] > threshold:
        end += 1
    return float(timestamps[start]), float(timestamps[end])


def multi_segment_proposal(
    prob: np.ndarray,
    timestamps: np.ndarray,
    factor: float = 0.5,
    at_least_one: bool = True,
) -> Optional[List[List[float]]]:
    """All maximal runs with prob > factor; falls back to the argmax
    expansion when empty (reference multi_segment_proposal,
    finetune_tools.py:186-229)."""
    above = prob > factor
    segs: List[List[float]] = []
    i = 0
    n = len(prob)
    while i < n:
        if above[i]:
            j = i
            while j + 1 < n and above[j + 1]:
                j += 1
            # the constant score is REFERENCE-EXACT ("add fake score '1'
            # for now", finetune_tools.py:210-211) — downstream consumers
            # treat proposals as unranked; the fallback below deviates
            # deliberately (prob.max() instead of the reference's stale
            # loop-variable prob[idx])
            segs.append([float(timestamps[i]), float(timestamps[j]), 1.0])
            i = j + 1
        else:
            i += 1
    if segs:
        return segs
    if not at_least_one:
        return None
    s, e = threshold_prob_proposal(prob, timestamps, factor=factor)
    return [[s, e, float(prob.max())]]


def grounding_metrics(
    proposals: List[Tuple[float, float]],
    gts: List[Tuple[float, float]],
    thresholds=(0.3, 0.5, 0.7),
) -> Dict[str, float]:
    """mIoU and R@tIoU over (proposal, gt) pairs
    (reference validation loop, finetune_tools.py:748-818)."""
    ious = np.array([temporal_iou(p, g) for p, g in zip(proposals, gts)])
    out = {"mIoU": float(ious.mean() * 100)}
    for t in thresholds:
        out[f"R@{t}"] = float((ious >= t).mean() * 100)
    return out


# ---------------------------------------------------------------------------
# per-frame OAD metrics
# ---------------------------------------------------------------------------


def frame_average_precision(scores: np.ndarray, labels: np.ndarray) -> float:
    """AP of per-frame scores for one class (all-point interpolation)."""
    order = np.argsort(-scores)
    tp = labels[order] > 0
    if tp.sum() == 0:
        return float("nan")
    cum_tp = np.cumsum(tp)
    precision = cum_tp / (np.arange(len(tp)) + 1)
    return float((precision * tp).sum() / tp.sum())


def perframe_map(
    scores: np.ndarray, labels: np.ndarray, ignore_class0: bool = True
) -> Dict[str, float]:
    """Mean per-frame AP over classes (THUMOS OAD protocol,
    downstream/OAD/tools/eval/eval_perframe.py). scores/labels: (N, C)."""
    aps = []
    start = 1 if ignore_class0 else 0
    for c in range(start, scores.shape[1]):
        ap = frame_average_precision(scores[:, c], labels[:, c])
        if not np.isnan(ap):
            aps.append(ap)
    return {"mAP": float(np.mean(aps) * 100) if aps else 0.0}


def perframe_calibrated_map(
    scores: np.ndarray, labels: np.ndarray, ignore_class0: bool = True
) -> Dict[str, float]:
    """mcAP (TVSeries protocol): precision calibrated by the pos/neg ratio."""
    caps = []
    start = 1 if ignore_class0 else 0
    for c in range(start, scores.shape[1]):
        lab = labels[:, c] > 0
        npos = lab.sum()
        if npos == 0:
            continue
        w = (len(lab) - npos) / npos
        order = np.argsort(-scores[:, c])
        tp = lab[order]
        cum_tp = np.cumsum(tp)
        cum_fp = np.cumsum(~tp)
        prec = (w * cum_tp) / np.maximum(w * cum_tp + cum_fp, 1e-9)
        caps.append(float((prec * tp).sum() / npos))
    return {"mcAP": float(np.mean(caps) * 100) if caps else 0.0}


def merge_multiview_logits(
    rows: List[Tuple[int, np.ndarray, int]], num_classes: int
) -> Dict[str, float]:
    """AR multi-view merge: softmax-average all views per video, then top-1/5
    (reference downstream/AR engine merge, engine_for_finetuning.py:246-296).
    rows: (video_id, logits, label). ``num_classes`` validates the class
    axis (the merge itself is shape-driven)."""
    by_vid: Dict[int, List[np.ndarray]] = {}
    lab: Dict[int, int] = {}
    for vid, logits, label in rows:
        assert logits.shape[-1] == num_classes, (
            f"logits have {logits.shape[-1]} classes, expected {num_classes}"
        )
        x = np.exp(logits - logits.max())
        by_vid.setdefault(vid, []).append(x / x.sum())
        lab[vid] = label
    preds = np.stack([np.mean(by_vid[v], axis=0) for v in sorted(by_vid)])
    labels = np.array([lab[v] for v in sorted(by_vid)])
    return topk_accuracy(preds, labels)
