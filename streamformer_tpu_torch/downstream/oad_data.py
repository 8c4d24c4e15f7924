"""OAD per-frame data layer and the LSTR/MAT training and evaluation loops,
on PyTorch.

Port of the JAX package's ``downstream/oad_data.py`` (the reference's
``perframe_data_layers.py``, ``perframe_det_trainer.py`` and
``perframe_det_batch_inference.py``):

* ``PerFrameDataset`` is the port's own copy of the numpy data layer:
  per-video visual features (L, 768) from ``extract.oad`` (and an optional
  flow stream, put after the visual columns) with one-hot per-frame targets
  (L, C); a sample is a work window with the strided long memory before it,
  zero-padded where the history is short; training batches drop the
  remainder, evaluation batches keep every window;
* ``make_optimizer`` is ``optax.adamw(lr, weight_decay=wd)``: AdamW with the
  decay on every parameter;
* ``make_train_step``: the multi-label BCE over the work tokens, a backward
  and an AdamW update;
* ``batch_inference``: the newest frame's sigmoid over every window, then
  per-frame mAP (THUMOS) and mcAP (TVSeries) from ``eval.metrics``.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from streamformer_tpu_torch.data.transforms import pinned_to
from streamformer_tpu_torch.downstream import oad_lstr as L
from streamformer_tpu_torch.eval import metrics as M
from streamformer_tpu_torch.train import optim


class PerFrameDataset:
    """Work/long-memory window samples over per-video feature dumps."""

    def __init__(
        self,
        feature_root: str,
        target_root: str,
        video_names: List[str],
        cfg: L.LSTRConfig,
        long_sample_rate: int = 4,
        mode: str = "train",
        flow_root: Optional[str] = None,
    ):
        self.cfg = cfg
        self.mode = mode
        self.long_sample_rate = long_sample_rate
        self.videos = []
        for name in video_names:
            vis = np.load(os.path.join(feature_root, name + ".npy"))
            tgt = np.load(os.path.join(target_root, name + ".npy"))
            flow = np.load(os.path.join(flow_root, name + ".npy")) if flow_root else None
            self.videos.append((name, vis, flow, tgt))
        # index: (video_idx, end_frame) for every valid work window
        self.samples: List[Tuple[int, int]] = []
        for vi, (_, vis, _, _) in enumerate(self.videos):
            for end in range(cfg.work_memory_num_samples, len(vis) + 1):
                self.samples.append((vi, end))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        vi, end = self.samples[idx]
        _, vis, flow, tgt = self.videos[vi]
        lw = self.cfg.work_memory_num_samples
        ln = self.cfg.long_memory_num_samples
        work = vis[end - lw:end]
        work_t = tgt[end - lw:end]
        # long memory: strided history before the work window, zero-padded
        long_idx = np.arange(end - lw - ln * self.long_sample_rate, end - lw, self.long_sample_rate)
        valid = long_idx >= 0
        long_feat = np.zeros((ln, vis.shape[1]), np.float32)
        long_feat[valid] = vis[long_idx[valid]]
        feats = np.concatenate([long_feat, work], axis=0)
        if flow is not None:
            # visual-first columns: the forward and LSTRStream.step slice
            # [..., :visual_size] as the visual stream
            fl = np.zeros((ln, flow.shape[1]), np.float32)
            fl[valid] = flow[long_idx[valid]]
            feats = np.concatenate([feats, np.concatenate([fl, flow[end - lw:end]], 0)], axis=-1)
        return {
            "features": feats.astype(np.float32),  # (ln + lw, D)
            "memory_mask": valid,  # (ln,)
            "targets": work_t.astype(np.float32),  # (lw, C)
        }

    def batches(self, batch_size: int, rng: np.random.Generator) -> Iterator[Dict]:
        order = rng.permutation(len(self)) if self.mode == "train" else np.arange(len(self))
        # train drops the remainder (reference drop_last); eval scores every window
        stop = len(order) - len(order) % batch_size if self.mode == "train" else len(order)
        for i in range(0, stop, batch_size):
            items = [self[j] for j in order[i:i + batch_size]]
            yield {k: np.stack([it[k] for it in items]) for k in items[0]}


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A batch of ``PerFrameDataset.batches`` on ``device``, copied without
    a stream synchronisation (pinned on the card)."""
    return {k: pinned_to(v, device) for k, v in batch.items()}


def make_optimizer(model: L.LSTR, lr: float, weight_decay: float) -> optim.ScheduledOptimizer:
    """``optax.adamw(lr, weight_decay=weight_decay)`` over the detector."""
    return optim.adamw_every_leaf(model, lr, weight_decay)


def loss_fn(model: L.LSTR, feats, mask, targets) -> torch.Tensor:
    """Per-frame multi-label BCE over the work tokens (reference
    perframe_det_trainer criterion)."""
    out = L.forward(model, feats, memory_mask=mask)
    lw = model.cfg.work_memory_num_samples
    bce = F.binary_cross_entropy_with_logits(out["logits"][:, :lw], targets)
    if "future_logits" in out:
        # the future loss needs future targets; the future branch stays in
        # the graph at weight 0, as in the JAX package
        bce = bce + 0.0 * out["future_logits"].sum()
    return bce


def make_train_step(model: L.LSTR, opt: optim.ScheduledOptimizer):
    """step(batch) -> the loss (a 0-d tensor on the model's device); a batch
    of ``PerFrameDataset.batches``, host arrays or tensors."""

    def step(batch) -> torch.Tensor:
        b = to_device(batch, model.device) if isinstance(batch["features"], np.ndarray) else batch
        opt.zero_grad()
        loss = loss_fn(model, b["features"], b["memory_mask"], b["targets"])
        loss.backward()
        opt.step()
        return loss.detach()

    return step


@torch.no_grad()
def batch_inference(model: L.LSTR, dataset: PerFrameDataset, batch_size: int = 16
                    ) -> Dict[str, float]:
    """Score every window's newest frame and compute per-frame mAP and mcAP
    (reference perframe_det_batch_inference + eval_perframe)."""
    lw = model.cfg.work_memory_num_samples
    scores, targets = [], []
    for batch in dataset.batches(batch_size, np.random.default_rng(0)):
        b = to_device(batch, model.device)
        logits = L.forward(model, b["features"], memory_mask=b["memory_mask"])["logits"]
        scores.append(torch.sigmoid(logits[:, lw - 1]))
        targets.append(batch["targets"][:, lw - 1])
    s = torch.cat(scores).cpu().numpy()
    t = np.concatenate(targets)
    out = M.perframe_map(s, t)
    out.update(M.perframe_calibrated_map(s, t))
    return out
