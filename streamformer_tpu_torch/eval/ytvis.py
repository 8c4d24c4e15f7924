"""YTVIS submission export and scoring (numpy, host-side): the port's own copy of the JAX
package's ``eval/ytvis.py``, which imports no JAX.

YTVIS submission export (reference vendored ytvis eval API,
downstream/OVIS/ctvis/data/vis/ytvis_eval.py; AP is computed by CodaLab —
downstream/OVIS/README.md:115-119 — so the deliverable is the results JSON).

Converts per-video tracker outputs into the YTVIS format:
[{video_id, category_id, score, segmentations: [RLE|null per frame]}].
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np


def mask_to_rle(mask: np.ndarray) -> Dict:
    """Binary (H, W) mask -> uncompressed COCO RLE (column-major counts)."""
    h, w = mask.shape
    flat = np.asarray(mask, bool).T.reshape(-1)  # F-order
    # run lengths starting with the count of 0s
    change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    bounds = np.concatenate([[0], change, [len(flat)]])
    counts = np.diff(bounds).tolist()
    if flat[0]:  # RLE must start with a zero-run
        counts = [0] + counts
    return {"size": [int(h), int(w)], "counts": counts}


def collect_video_result(
    video_id: int,
    frame_outputs: List[Dict],
    score_threshold: float = 0.05,
) -> List[Dict]:
    """frame_outputs: per frame {"track_ids": [..], "category_ids": [..],
    "scores": [..], "masks": (N, H, W) bool}. Returns YTVIS rows, one per
    track, with per-frame segmentations (null where absent)."""
    num_frames = len(frame_outputs)
    tracks: Dict[int, Dict] = {}
    for t, fo in enumerate(frame_outputs):
        for i, tid in enumerate(fo["track_ids"]):
            tr = tracks.setdefault(
                tid,
                {
                    "video_id": int(video_id),
                    "segmentations": [None] * num_frames,
                    "_scores": [],
                    "_cats": [],
                },
            )
            tr["segmentations"][t] = mask_to_rle(np.asarray(fo["masks"][i]))
            tr["_scores"].append(float(fo["scores"][i]))
            tr["_cats"].append(int(fo["category_ids"][i]))
    rows = []
    for tr in tracks.values():
        score = float(np.mean(tr.pop("_scores")))
        cats = tr.pop("_cats")
        if score < score_threshold:
            continue
        tr["score"] = score
        tr["category_id"] = int(np.bincount(cats).argmax())
        rows.append(tr)
    return rows


def write_results(rows: List[Dict], path: str) -> None:
    with open(path, "w") as f:
        json.dump(rows, f)


# ---------------------------------------------------------------------------
# YTVIS AP evaluation (reference vendored YTVOSeval,
# downstream/OVIS/ctvis/data/vis/ytvis_api/ytvoseval.py — COCO-style AP with
# the spatio-temporal track IoU of :534-545 params and :203-214 iou_seq)
# ---------------------------------------------------------------------------

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)


def rle_to_mask(rle: Dict) -> np.ndarray:
    """Uncompressed COCO RLE (column-major) -> (H, W) bool."""
    h, w = rle["size"]
    flat = np.zeros(h * w, bool)
    pos, val = 0, False
    for c in rle["counts"]:
        if val:
            flat[pos : pos + c] = True
        pos += c
        val = not val
    return flat.reshape(w, h).T  # stored F-order


def _frame_mask(seg, shape=None):
    if seg is None:
        return None
    if isinstance(seg, dict):
        return rle_to_mask(seg)
    return np.asarray(seg, bool)


def track_iou(d_segs: List, g_segs: List) -> float:
    """Spatio-temporal IoU: sum of per-frame intersections / sum of unions
    (reference iou_seq, ytvoseval.py:203-214; absent frames count as empty).
    """
    inter = 0.0
    union = 0.0
    for ds, gs in zip(d_segs, g_segs):
        d = _frame_mask(ds)
        g = _frame_mask(gs)
        if d is None and g is None:
            continue
        if d is None:
            union += float(np.count_nonzero(g))
            continue
        if g is None:
            union += float(np.count_nonzero(d))
            continue
        inter += float(np.count_nonzero(d & g))
        union += float(np.count_nonzero(d | g))
    return inter / union if union > 0 else 0.0


def evaluate_ytvis(
    results: List[Dict],
    gt_annotations: List[Dict],
    iou_thrs: np.ndarray = IOU_THRS,
    max_dets: int = 100,
) -> Dict[str, float]:
    """Video-instance-segmentation AP/AR.

    ``results``: YTVIS rows ({video_id, category_id, score, segmentations})
    as written by :func:`collect_video_result`. ``gt_annotations``: the same
    shape plus ``id`` (and optional ``iscrowd``). Masks may be RLE dicts,
    arrays, or None per frame. Returns AP (mean over 10 IoU thresholds and
    classes), AP50, AP75, AR@{1,10,100}, and per-class AP.
    """
    cats = sorted({g["category_id"] for g in gt_annotations})
    n_thr = len(iou_thrs)
    per_class_ap: Dict[int, float] = {}
    ap_accum = np.zeros((n_thr, 0))
    ar_at = {1: [], 10: [], 100: []}

    for cat in cats:
        # per (video) matching
        scores, tps = [], []  # tps: (n_thr,) bool rows
        ignores = []  # (n_thr,) bool rows: det matched only a crowd gt
        match_ranks = [[] for _ in range(n_thr)]  # in-video det rank per match
        n_gt = 0
        videos = sorted(
            {g["video_id"] for g in gt_annotations if g["category_id"] == cat}
            | {r["video_id"] for r in results if r["category_id"] == cat}
        )
        for vid in videos:
            gts = [
                g for g in gt_annotations
                if g["video_id"] == vid and g["category_id"] == cat
            ]
            dts = [
                r for r in results
                if r["video_id"] == vid and r["category_id"] == cat
            ]
            dts = sorted(dts, key=lambda r: -r["score"])[:max_dets]
            n_gt += sum(0 if g.get("iscrowd") else 1 for g in gts)
            ious = np.array(
                [
                    [track_iou(d["segmentations"], g["segmentations"])
                     for g in gts]
                    for d in dts
                ]
            ).reshape(len(dts), len(gts))
            matched = np.zeros((n_thr, len(gts)), bool)
            for di, d in enumerate(dts):
                row = np.zeros(n_thr, bool)
                ign = np.zeros(n_thr, bool)
                for ti, thr in enumerate(iou_thrs):
                    best, best_iou = -1, thr
                    for gi in range(len(gts)):
                        if matched[ti, gi] or gts[gi].get("iscrowd"):
                            continue
                        if ious[di, gi] >= best_iou:
                            best, best_iou = gi, ious[di, gi]
                    if best >= 0:
                        matched[ti, best] = True
                        row[ti] = True
                        match_ranks[ti].append(di)
                    else:
                        # COCO ignore semantics (ytvoseval: crowd gts carry
                        # gt['ignore'], are matchable by many dets, and a
                        # det matched only to one is excluded from BOTH tp
                        # and fp): a leftover det overlapping a crowd
                        # region must not count as a false positive
                        ign[ti] = any(
                            gts[gi].get("iscrowd") and ious[di, gi] >= thr
                            for gi in range(len(gts))
                        )
                scores.append(d["score"])
                tps.append(row)
                ignores.append(ign)
        if n_gt == 0:
            continue
        if not scores:
            per_class_ap[cat] = 0.0
            ap_accum = np.concatenate(
                [ap_accum, np.zeros((n_thr, 1))], axis=1
            )
            for k in ar_at:
                ar_at[k].append(0.0)
            continue
        order = np.argsort(-np.asarray(scores), kind="mergesort")
        tp = np.stack(tps, axis=1)[:, order]  # (n_thr, n_det)
        ig = np.stack(ignores, axis=1)[:, order]
        fp = ~tp & ~ig  # crowd-ignored dets count as neither tp nor fp
        tp_c = np.cumsum(tp, axis=1)
        fp_c = np.cumsum(fp, axis=1)
        recall = tp_c / n_gt
        precision = tp_c / np.maximum(tp_c + fp_c, 1e-12)
        # 101-point interpolated precision (COCO accumulate)
        ap_t = np.zeros(n_thr)
        for ti in range(n_thr):
            p = precision[ti].copy()
            for i in range(len(p) - 1, 0, -1):
                p[i - 1] = max(p[i - 1], p[i])
            idx = np.searchsorted(recall[ti], REC_THRS, side="left")
            q = np.where(idx < len(p), p[np.minimum(idx, len(p) - 1)], 0.0)
            ap_t[ti] = q.mean()
        per_class_ap[cat] = float(ap_t.mean())
        ap_accum = np.concatenate([ap_accum, ap_t[:, None]], axis=1)
        # AR@K: recall counting only matches made by each video's top-K
        # detections (greedy matching runs in score order per video, so
        # dropping rank>=K matches equals re-matching with K dets)
        for k in ar_at:
            rec_k = [
                sum(1 for r in match_ranks[ti] if r < k) / n_gt
                for ti in range(n_thr)
            ]
            ar_at[k].append(float(np.mean(rec_k)))

    if ap_accum.shape[1] == 0:
        return {"AP": 0.0, "AP50": 0.0, "AP75": 0.0,
                "AR@1": 0.0, "AR@10": 0.0, "AR@100": 0.0, "per_class": {}}
    thr_idx = {round(t, 2): i for i, t in enumerate(iou_thrs)}
    return {
        "AP": float(ap_accum.mean()),
        "AP50": float(ap_accum[thr_idx[0.5]].mean()),
        "AP75": float(ap_accum[thr_idx[0.75]].mean()),
        "AR@1": float(np.mean(ar_at[1])),
        "AR@10": float(np.mean(ar_at[10])),
        "AR@100": float(np.mean(ar_at[100])),
        "per_class": {int(k): v for k, v in per_class_ap.items()},
    }
