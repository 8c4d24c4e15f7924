"""Mixup and CutMix for video batches, on the clips' device.

Port of the JAX package's ``data/mixup.py`` (itself after timm's
``Mixup`` in the reference's ``datasets/mixup.py``): a batch lambda ~
Beta(alpha, alpha), or with probability ``switch_prob`` CutMix with a box
of area ratio 1 - lambda ~ Beta(cutmix_alpha, cutmix_alpha) centred at a
random point; each clip is mixed with the batch reversed (timm's "batch"
mode) and the labels become smoothed soft targets.

The draw is kept apart from the mix: ``draw_mixup`` reads an explicit
``torch.Generator`` on the host and returns the batch's scalars
(``MixupDraw``); ``mix_batch`` applies a draw on the device. JAX's threefry
draws cannot be reproduced, so a test hands both packages the same draw.
The box arithmetic is fp32, as the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class MixupDraw:
    """One batch's draws: the mixup and CutMix lambdas, whether CutMix is
    used, and the box centre (row, column)."""

    lam_mix: float
    lam_cut: float
    use_cutmix: bool
    cy: int
    cx: int


def one_hot(labels: torch.Tensor, num_classes: int, on_value: float = 1.0,
            off_value: float = 0.0) -> torch.Tensor:
    oh = F.one_hot(labels.long(), num_classes).float()
    return oh * (on_value - off_value) + off_value


def mixup_target(labels: torch.Tensor, num_classes: int, lam: float, smoothing: float = 0.0
                 ) -> torch.Tensor:
    """(B, num_classes) soft targets: the smoothed one-hot of each label
    mixed with the reversed batch's by ``lam`` (rounded to fp32; a host
    scalar, so nothing waits for the device)."""
    off = smoothing / num_classes
    on = 1.0 - smoothing + off
    y1 = one_hot(labels, num_classes, on, off)
    y2 = one_hot(labels.flip(0), num_classes, on, off)
    lam = np.float32(lam)
    return y1 * float(lam) + y2 * float(np.float32(1.0) - lam)


def _rand_bbox(h: int, w: int, lam: float, cy: int, cx: int) -> Tuple[int, int, int, int]:
    """CutMix box (y1, y2, x1, x2) of area ratio about 1 - lam centred at
    (cy, cx), clipped to the frame; the side lengths in fp32."""
    ratio = np.sqrt(np.float32(1.0) - np.float32(lam), dtype=np.float32)
    cut_h, cut_w = int(np.float32(h) * ratio), int(np.float32(w) * ratio)
    y1, y2 = np.clip(cy - cut_h // 2, 0, h), np.clip(cy + cut_h // 2, 0, h)
    x1, x2 = np.clip(cx - cut_w // 2, 0, w), np.clip(cx + cut_w // 2, 0, w)
    return int(y1), int(y2), int(x1), int(x2)


def draw_mixup(generator: torch.Generator, h: int, w: int, mixup_alpha: float = 0.8,
               cutmix_alpha: float = 1.0, switch_prob: float = 0.5) -> MixupDraw:
    """A batch's draws from ``generator`` (a CPU generator; nothing touches
    the device). The Beta draws come from a numpy generator seeded by it."""
    rng = np.random.default_rng(int(torch.randint(0, 2**62, (), generator=generator)))
    use_cutmix = bool(torch.rand((), generator=generator) < switch_prob) and cutmix_alpha > 0
    lam_mix = float(np.float32(rng.beta(mixup_alpha, mixup_alpha))) if mixup_alpha > 0 else 1.0
    lam_cut = float(np.float32(rng.beta(cutmix_alpha, cutmix_alpha))) if cutmix_alpha > 0 else 1.0
    cy = int(torch.randint(0, h, (), generator=generator))
    cx = int(torch.randint(0, w, (), generator=generator))
    return MixupDraw(lam_mix, lam_cut, use_cutmix, cy, cx)


def mix_batch(clips: torch.Tensor, labels: torch.Tensor, num_classes: int, draw: MixupDraw,
              label_smoothing: float = 0.1, channels_last: bool = True
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply ``draw`` to (B, T, H, W, C) clips (``channels_last``) or (B, T,
    C, H, W): (mixed clips, (B, num_classes) soft targets)."""
    flipped = clips.flip(0)
    if draw.use_cutmix:
        h, w = (clips.shape[2], clips.shape[3]) if channels_last else (clips.shape[3],
                                                                       clips.shape[4])
        y1, y2, x1, x2 = _rand_bbox(h, w, draw.lam_cut, draw.cy, draw.cx)
        mixed = clips.clone()
        if channels_last:
            mixed[:, :, y1:y2, x1:x2] = flipped[:, :, y1:y2, x1:x2]
        else:
            mixed[..., y1:y2, x1:x2] = flipped[..., y1:y2, x1:x2]
        lam = np.float32(1.0) - np.float32((y2 - y1) * (x2 - x1)) / np.float32(h * w)
    else:
        lam = np.float32(draw.lam_mix)
        mixed = clips * float(lam) + flipped * float(np.float32(1.0) - lam)
    return mixed, mixup_target(labels, num_classes, float(lam), label_smoothing)


def mixup_batch(generator: torch.Generator, clips: torch.Tensor, labels: torch.Tensor,
                num_classes: int, mixup_alpha: float = 0.8, cutmix_alpha: float = 1.0,
                switch_prob: float = 0.5, label_smoothing: float = 0.1,
                channels_last: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batch-mode mixup / CutMix: ``draw_mixup`` from ``generator``, then
    ``mix_batch``."""
    h, w = (clips.shape[2], clips.shape[3]) if channels_last else (clips.shape[3], clips.shape[4])
    draw = draw_mixup(generator, h, w, mixup_alpha, cutmix_alpha, switch_prob)
    return mix_batch(clips, labels, num_classes, draw, label_smoothing, channels_last)


def soft_target_cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """The loss for soft targets (timm's ``SoftTargetCrossEntropy``)."""
    return -(targets * torch.log_softmax(logits, dim=-1)).sum(-1).mean()
