"""Per-task validation loops: the port of the JAX package's
``eval/validate.py`` (reference tools/finetune_tools.py:642-947).

Each validator takes a ``MultitaskModel`` and an iterable of batches from
the eval loader and returns the task's metrics:

* classification: top-1/5 on last-frame zero-shot logits (:730-739);
* retrieval: feature banking then Recall@K both directions (:741-747,
  :902-944);
* grounding: threshold proposals -> mIoU / R@{0.3,0.5,0.7} (:748-818) and a
  QVHighlights-style JSONL proposal dump (:819-844);
* localization: multi-segment proposals per class (ActionFormer-style result
  dict, :845-858).

The forwards run under ``torch.inference_mode()`` on the model's device at
its compute dtype (on the card ``model_forward`` through kernels B and C);
features and probabilities come back as fp32 numpy, where the metrics are
computed, as the JAX package computes them.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from streamformer_tpu_torch.eval import metrics as M


def _np(x: torch.Tensor) -> np.ndarray:
    return x.float().cpu().numpy()


def _last_frame(model, px) -> np.ndarray:
    """(B, D) fp32 features of each clip's last (causal summary) frame."""
    return _np(model.backbone_forward(px)["pooler_output"][:, -1])


def _probs(model, px, text: torch.Tensor, pattern: str) -> np.ndarray:
    """Sigmoid scores of the frames' normalized features against ``text``
    (normalized by the caller as the pattern needs), in fp32."""
    pooler = model.backbone_forward(px)["pooler_output"].float()
    img = pooler / pooler.norm(dim=-1, keepdim=True)
    sim = torch.einsum(pattern, img, text)
    return _np(torch.sigmoid(sim * model.logit_scale.float().exp() + model.logit_bias.float()))


@torch.inference_mode()
def validate_classification(model, batches) -> Dict[str, float]:
    """batches: (pixel_values, labels, task); zero-shot logits of the
    last-frame features against the task's label table."""
    table = None
    logits_all, labels_all = [], []
    for px, labels, task in batches:
        if table is None:
            table = _np(model.label_embeddings[task])
        feat = _last_frame(model, px)
        feat /= np.linalg.norm(feat, axis=-1, keepdims=True)
        logits_all.append(feat @ table.T)
        labels_all.append(np.asarray(labels))
    return M.topk_accuracy(np.concatenate(logits_all), np.concatenate(labels_all))


@torch.inference_mode()
def validate_retrieval(model, batches) -> Dict[str, float]:
    """batches: (pixel_values, captions). Banks normalized video and text
    features, then the v2t and t2v recalls."""
    vids, txts = [], []
    for px, captions in batches:
        v = _last_frame(model, px)
        t = _np(model.encode_texts(list(captions)))
        vids.append(v / np.linalg.norm(v, axis=-1, keepdims=True))
        txts.append(t / np.linalg.norm(t, axis=-1, keepdims=True))
    sim = np.concatenate(vids) @ np.concatenate(txts).T
    out = {f"v2t_{k}": val for k, val in M.retrieval_recall(sim).items()}
    out.update({f"t2v_{k}": val for k, val in M.retrieval_recall(sim.T).items()})
    return out


@torch.inference_mode()
def validate_grounding(model, batches, factor: float = 0.7,
                       jsonl_path: Optional[str] = None) -> Dict[str, float]:
    """batches: (pixel_values, caption_ids, metas), each meta {"times":
    per-frame timestamps, "gt": (start, end), "qid"}. Threshold proposals ->
    mIoU and R@tIoU; with ``jsonl_path`` also the QVHighlights JSONL of the
    proposals ("leave evaluation to official evaluation script", :820-844)."""
    from streamformer_tpu_torch.models import text_encoder

    proposals, gts, rows = [], [], []
    for px, ids, metas in batches:
        txt = text_encoder.forward(model.text, ids)["pooler_output"].float()
        txt = txt / txt.norm(dim=-1, keepdim=True)
        probs = _probs(model, px, txt, "btd,bd->bt")
        for i, meta in enumerate(metas):
            s, e = M.threshold_prob_proposal(probs[i], np.asarray(meta["times"]), factor=factor)
            proposals.append((s, e))
            gts.append(tuple(meta["gt"]))
            rows.append({"qid": meta.get("qid", len(rows)),
                         "pred_relevant_windows": [[float(s), float(e), 1.0]]})
    if jsonl_path:
        os.makedirs(os.path.dirname(jsonl_path) or ".", exist_ok=True)
        with open(jsonl_path, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    return M.grounding_metrics(proposals, gts)


@torch.inference_mode()
def validate_localization(model, batches, factor: float = 0.5) -> Dict[Any, List[Dict]]:
    """batches: (pixel_values, label_embeddings (B, L, D), class_mask (B, L),
    metas). Multi-segment proposals per class -> the ActionFormer-style
    result dict {video-id: [{label, segment, score}]} (:845-858)."""
    results: Dict[Any, List[Dict]] = {}
    for px, tables, class_mask, metas in batches:
        tables = torch.as_tensor(tables).to(model.device).float()
        probs = _probs(model, px, tables, "btd,bld->btl")
        cm = np.asarray(class_mask)
        for i, meta in enumerate(metas):
            times = np.asarray(meta["times"])
            out = results.setdefault(meta.get("video_id", len(results)), [])
            for c in range(probs.shape[2]):
                if not cm[i, c]:
                    continue
                segs = M.multi_segment_proposal(probs[i, :, c], times, factor=factor,
                                                at_least_one=False)
                for s, e, score in segs or ():
                    out.append({"label": int(c), "segment": [s, e], "score": float(score)})
    return results


def evaluate_multitask(model, eval_union, crop_size: int = 224,
                       batch_size: int = 8) -> Dict[str, Dict[str, float]]:
    """Per-task validation over an eval ``MultiTaskDataset`` (the reference's
    validation branches, tools/finetune_tools.py:730-877): classification,
    retrieval and grounding tasks; a task of another kind, or a dataset
    without a known ``task_name``, is skipped, as in the JAX package.
    Clips are centre-cropped and normalized on the model's device
    (``make_eval_augment``)."""
    from streamformer_tpu_torch.data.collate import make_eval_augment
    from streamformer_tpu_torch.models.multitask import head_type_for_task

    aug = make_eval_augment(crop_size)
    results: Dict[str, Dict[str, float]] = {}
    for ds in eval_union.datasets:
        task = getattr(ds, "task_name", type(ds).__name__)
        try:
            kind = head_type_for_task(task)
        except NotImplementedError:
            continue

        def batches(ds=ds):
            n = len(ds)
            for start in range(0, n, batch_size):
                tis = [ds[i]["task_input"] for i in range(start, min(start + batch_size, n))]
                clips = torch.from_numpy(np.stack([ti["frames"] for ti in tis]))
                yield aug(clips.to(model.device)), tis

        if kind == "classification":
            gen = ((px, np.asarray([ti["label"] for ti in tis]), task) for px, tis in batches())
            results[task] = validate_classification(model, gen)
        elif kind == "retrieval":
            gen = ((px, [ti["caption"] for ti in tis]) for px, tis in batches())
            results[task] = validate_retrieval(model, gen)
        elif kind == "grounding":
            gen = ((px, model.tokenize([ti["caption"] for ti in tis]),
                    [ti.get("meta", {"times": np.arange(px.shape[1]), "gt": (0, 1)})
                     for ti in tis])
                   for px, tis in batches())
            results[task] = validate_grounding(model, gen)
    return results
