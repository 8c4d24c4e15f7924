"""Contrastive losses, in their single-process forms.

Port of the JAX package's ``parallel/contrastive.py``. There the multi-chip
forms ride ``ppermute`` / ``all_gather`` over a named mesh axis and fall back
to single-shard math when no axis is bound (``axis_name=None``). Here the
place of the axis name is taken by a ``torch.distributed`` process group,
``group``: ``None`` is the single-process form, which is all this module
implements; a group raises ``NotImplementedError`` (the NCCL ring and the
all-gather are ROADMAP item 14).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _single_process(group, what: str) -> None:
    if group is not None:
        raise NotImplementedError(
            f"{what} over a torch.distributed process group (ROADMAP slice 4, item 14): "
            "pass group=None for the single-process form"
        )


def sigmoid_pair_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """SigLIP pairwise loss term: -sum(logsigmoid(labels * logits)), labels in
    {-1, +1} (a 0 entry contributes log 2: callers mask first)."""
    return -F.logsigmoid(labels * logits).sum()


def siglip_local_loss(img: torch.Tensor, txt: torch.Tensor, logit_scale: torch.Tensor,
                      logit_bias: torch.Tensor, *, negative_only: bool = False) -> torch.Tensor:
    """Single-shard SigLIP loss. img (B, D), txt (B', D), L2-normalized;
    ``logit_scale`` is already exponentiated. Labels are 2*I - 1 (all -1 when
    ``negative_only``); the sum is divided by the local B."""
    b = img.shape[0]
    logits = logit_scale * (img.float() @ txt.float().t()) + logit_bias
    labels = -torch.ones_like(logits)
    if not negative_only:
        labels = labels + 2 * torch.eye(b, txt.shape[0], dtype=logits.dtype, device=logits.device)
    return sigmoid_pair_loss(logits, labels) / b


def siglip_ring_loss(img: torch.Tensor, txt: torch.Tensor, logit_scale: torch.Tensor,
                     logit_bias: torch.Tensor, group=None) -> torch.Tensor:
    """Ring SigLIP loss: local positives and negatives, then negative-only
    terms against every other rank's text features. With ``group=None`` (one
    process) that is the local loss."""
    _single_process(group, "siglip_ring_loss")
    return siglip_local_loss(img, txt, logit_scale, logit_bias)


def all_gather_features(x: torch.Tensor, group=None) -> torch.Tensor:
    """Per-rank features concatenated along the batch axis; x itself in one
    process."""
    _single_process(group, "all_gather_features")
    return x


def axis_rank(group=None) -> int:
    """This process's rank in the group; 0 in one process."""
    _single_process(group, "axis_rank")
    return 0
