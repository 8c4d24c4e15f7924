"""Action-recognition fine-tuning on PyTorch (the reference's downstream/AR,
a UMT fork).

Port of the JAX package's ``downstream/ar.py``. The model is the encoder,
its MAP-pooled ``pooler_output`` averaged over frames, ``fc_norm`` and a
linear classifier (the reference's
``modeling_timesformer_video_classification.py:42-137``). The engine: a
train step with mixup / CutMix and soft-target cross-entropy (integer
cross-entropy with mixup off), an optional EMA of the weights in fp32,
validation top-1/5 and the multi-view final test, whose views are merged by
averaging their softmax per video (``engine_for_finetuning.py``).

Dropout and stochastic depth draw through ``encoder.Draws`` keyed by the
step's seed.
"""

from __future__ import annotations

import copy
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from streamformer_tpu_torch.config import StreamformerConfig
from streamformer_tpu_torch.data.mixup import mixup_batch, soft_target_cross_entropy
from streamformer_tpu_torch.eval import metrics as M
from streamformer_tpu_torch.models import encoder


class ClassifierHead(nn.Module):
    """``fc_norm`` (LayerNorm) and ``classifier`` (linear), fp32."""

    def __init__(self, hidden_size: int, num_classes: int, eps: float, device=None):
        super().__init__()
        self.fc_norm = nn.LayerNorm(hidden_size, eps=eps, device=device)
        self.classifier = nn.Linear(hidden_size, num_classes, device=device)


@torch.no_grad()
def init_classifier(cfg: StreamformerConfig, num_classes: int, *, device=None,
                    generator: Optional[torch.Generator] = None) -> ClassifierHead:
    """The head as the JAX package initialises it: unit norm, zero biases,
    the classifier trunc-normal(0.02) within two standard deviations, drawn
    on the host from ``generator`` (a CPU generator)."""
    dev = encoder.resolve_device(device)
    head = ClassifierHead(cfg.hidden_size, num_classes, cfg.layer_norm_eps, device=dev)
    draw = torch.empty(head.classifier.weight.shape)
    nn.init.trunc_normal_(draw, 0.0, 0.02, -0.04, 0.04, generator=generator)
    head.classifier.weight.copy_(draw)
    head.classifier.bias.zero_()
    return head


class ARModel(nn.Module):
    """``backbone`` (a ``StreamformerEncoder``; ``trainable=True`` to train)
    and ``head`` (a ``ClassifierHead``)."""

    def __init__(self, backbone: encoder.StreamformerEncoder, head: ClassifierHead):
        super().__init__()
        self.backbone, self.head = backbone, head

    @property
    def device(self) -> torch.device:
        return self.backbone.device


def classification_forward(model: ARModel, pixel_values: torch.Tensor, *, generator=None,
                           deterministic: bool = True) -> torch.Tensor:
    """(B, T, C, H, W) -> (B, num_classes) logits in the compute dtype: the
    frames' pooled features averaged, ``fc_norm``, the classifier."""
    cfg = model.backbone.cfg
    draws = None if deterministic else encoder.Draws.of(generator, pixel_values.shape[0],
                                                         model.device)
    out = encoder.model_forward(model.backbone, pixel_values, generator=draws,
                                deterministic=deterministic)
    feat = out["pooler_output"].mean(dim=1)
    head = model.head
    feat = encoder.layer_norm(feat, head.fc_norm, cfg.layer_norm_eps)
    dt = feat.dtype
    return F.linear(feat, head.classifier.weight.to(dt), head.classifier.bias.to(dt))


def init_ema(model: nn.Module) -> nn.Module:
    """The EMA shadow: an fp32 copy of ``model`` that records no grad."""
    return copy.deepcopy(model).float().requires_grad_(False)


@torch.no_grad()
def ema_update(ema: nn.Module, model: nn.Module, decay: float) -> None:
    """One ModelEma step in fp32, in place: ``ema <- decay * ema + (1 -
    decay) * param`` (the reference's timm ``ModelEma``)."""
    params = dict(model.named_parameters())
    for name, e in ema.named_parameters():
        e.copy_(decay * e + (1.0 - decay) * params[name].float())


def make_train_step(model: ARModel, optimizer, num_classes: int, mixup_alpha: float = 0.8,
                    cutmix_alpha: float = 1.0, label_smoothing: float = 0.1,
                    use_mixup: bool = True, ema: Optional[nn.Module] = None,
                    ema_decay: Optional[float] = None):
    """``step(pixel_values, labels, seed)`` -> the loss (a 0-d tensor): one
    update of ``model`` by ``optimizer`` (a ``train.optim.ScheduledOptimizer``)
    and, with ``ema``, one EMA step. ``seed`` keys the step's draws: mixup's
    (a CPU generator) and dropout's and stochastic depth's (``Draws``)."""

    def step(pixel_values: torch.Tensor, labels: torch.Tensor, seed: int) -> torch.Tensor:
        optimizer.zero_grad()
        px = pixel_values.to(model.device)
        labels = labels.to(model.device)
        gen = torch.Generator().manual_seed(int(seed))
        if use_mixup:
            px, targets = mixup_batch(gen, px, labels, num_classes, mixup_alpha=mixup_alpha,
                                      cutmix_alpha=cutmix_alpha, label_smoothing=label_smoothing,
                                      channels_last=False)
        logits = classification_forward(model, px, generator=gen, deterministic=False).float()
        loss = (soft_target_cross_entropy(logits, targets) if use_mixup
                else F.cross_entropy(logits, labels.long()))
        loss.backward()
        optimizer.step()
        if ema is not None:
            ema_update(ema, model, ema_decay)
        return loss.detach()

    return step


@torch.no_grad()
def _logits(model: ARModel, px: torch.Tensor) -> np.ndarray:
    return classification_forward(model, px).float().cpu().numpy()


def validate(model: ARModel, batches: Iterable[Tuple[torch.Tensor, torch.Tensor]]
             ) -> Dict[str, float]:
    """Top-1/5 over ``batches`` of (pixel_values, labels) (the reference's
    ``validation_one_epoch``)."""
    logits, labels = [], []
    for px, y in batches:
        logits.append(_logits(model, px))
        labels.append(np.asarray(torch.as_tensor(y).cpu()))
    return M.topk_accuracy(np.concatenate(logits), np.concatenate(labels))


def final_test(model: ARModel, batches: Iterable[Tuple[torch.Tensor, torch.Tensor, object]]
               ) -> Dict[str, float]:
    """The multi-view test over ``batches`` of (pixel_values, labels, video
    ids): each video's views merged by averaging their softmax (the
    reference's ``final_test`` and merge)."""
    rows: List[Tuple[int, np.ndarray, int]] = []
    num_classes = None
    for px, y, vids in batches:
        logits = _logits(model, px)
        num_classes = logits.shape[1]
        y = np.asarray(torch.as_tensor(y).cpu())
        for i in range(len(vids)):
            rows.append((int(vids[i]), logits[i], int(y[i])))
    return M.merge_multiview_logits(rows, num_classes)
