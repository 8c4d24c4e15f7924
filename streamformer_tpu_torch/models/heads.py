"""Multitask heads: global (classification, retrieval), temporal (grounding,
localization) and spatial (VIS, ReferVOS) supervision through SigLIP
text-embedding dot products.

Port of the JAX package's ``models/heads.py``. The heads are plain functions
on fixed-shape tensors: ragged per-sample structures (label tables, masks,
segment lists) arrive padded and masked from the data pipeline. Each returns
``(loss, logits)``. They take the raw parameters ``logit_scale`` (a log
scale) and ``logit_bias`` and exponentiate inside. Every head computes in
fp32 whatever the backbone's compute dtype: its inputs are cast up at entry
(the products are tiny, and loss math should not run in bf16).

The distributed terms (ring SigLIP, all-gathered contrastive batches) take a
``torch.distributed`` process group where the JAX package takes a mesh axis
name; ``group=None`` is the single-process form (``parallel.contrastive``).
Over a data group of W ranks each holding B samples, a head's loss averaged
over the group is its loss on the global batch of W*B samples.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from streamformer_tpu_torch.data.transforms import linear_resize_weights
from streamformer_tpu_torch.parallel import sharding
from streamformer_tpu_torch.parallel.contrastive import (
    all_gather_features,
    axis_rank,
    siglip_ring_loss,
)

# CLIP-style prompt-ensembling templates (the standard public CLIP/Kinetics
# prompt set), the port's own copy of the JAX package's list.
VIDEO_TEMPLATES = [
    "a photo of {}.",
    "a photo of a person {}.",
    "a photo of a person using {}.",
    "a photo of a person doing {}.",
    "a photo of a person during {}.",
    "a photo of a person performing {}.",
    "a photo of a person practicing {}.",
    "a video of {}.",
    "a video of a person {}.",
    "a video of a person using {}.",
    "a video of a person doing {}.",
    "a video of a person during {}.",
    "a video of a person performing {}.",
    "a video of a person practicing {}.",
    "a example of {}.",
    "a example of a person {}.",
    "a example of a person using {}.",
    "a example of a person doing {}.",
    "a example of a person during {}.",
    "a example of a person performing {}.",
    "a example of a person practicing {}.",
    "a demonstration of {}.",
    "a demonstration of a person {}.",
    "a demonstration of a person using {}.",
    "a demonstration of a person doing {}.",
    "a demonstration of a person during {}.",
    "a demonstration of a person performing {}.",
    "a demonstration of a person practicing {}.",
]
SCENE_TEMPLATES = ["{}"]

Projection = Dict[str, torch.Tensor]


def _norm(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize the last axis; an all-zero row (a zero-padded caption, a
    masked frame) yields zeros, not NaN (torch ``F.normalize``'s clamp)."""
    return x / x.norm(dim=-1, keepdim=True).clamp_min(eps)


def _logits(sim, logit_scale, logit_bias):
    return sim * torch.exp(logit_scale.float()) + logit_bias.float()


def _logsig_loss(labels, logits):
    return -F.logsigmoid(labels * logits).sum()


# ---------------------------------------------------------------------------
# Global heads
# ---------------------------------------------------------------------------


def classification_head(pooler_output, label_embeddings, labels, logit_scale, logit_bias):
    """Sigmoid-BCE zero-shot classification on the last-frame feature.

    pooler_output (B, T, D); label_embeddings (L, D), prompt-ensembled and
    L2-normalized, detached (the class anchors never receive a gradient);
    labels (B,) int. SigLIP +-1 targets, sum / B."""
    label_embeddings = label_embeddings.detach().float()
    img = _norm(pooler_output[:, -1, :].float())  # causal: the last frame sees all
    logits = _logits(img @ label_embeddings.t(), logit_scale, logit_bias)  # (B, L)
    b = logits.shape[0]
    targets = (-torch.ones_like(logits)).scatter_(1, labels.long()[:, None], 1.0)  # no sync
    return _logsig_loss(targets, logits) / b, logits


def classification_linear_head(pooler_output, params, labels):
    """Cross-entropy over a linear classifier on the last-frame feature.
    params: ``{"kernel": (D, L), "bias": (L,)}``."""
    feat = pooler_output[:, -1, :].float()
    logits = feat @ params["kernel"].float() + params["bias"].float()
    logp = F.log_softmax(logits, dim=-1)
    loss = -logp.gather(1, labels.long()[:, None]).mean()
    return loss, logits


def retrieval_head(pooler_output, text_embeds, logit_scale, logit_bias, group=None):
    """Video-text retrieval with the ring SigLIP loss: the last-frame
    feature (B, T, D) -> (B, D) against the caption embeddings (B, D)."""
    img = _norm(pooler_output[:, -1, :].float())
    txt = _norm(text_embeds.float())
    scale = torch.exp(logit_scale.float())
    loss = siglip_ring_loss(img, txt, scale, logit_bias.float(), group)
    return loss, img @ txt.t() * scale


# ---------------------------------------------------------------------------
# Temporal heads
# ---------------------------------------------------------------------------


def _signed(frame_labels: torch.Tensor) -> torch.Tensor:
    """{0, 1} frame labels -> {-1, +1} fp32 targets."""
    labels = frame_labels.float()
    return torch.where(labels == 0, -torch.ones_like(labels), labels)


def grounding_head(pooler_output, text_embeds, frame_labels, logit_scale, logit_bias):
    """Per-frame caption-similarity grounding: sigmoid-BCE of the (B, T, D) x
    (B, D) similarity, frame_labels (B, T) in {0, 1} with 0 mapped to -1,
    sum / B."""
    img = _norm(pooler_output.float())
    txt = _norm(text_embeds.float())
    logits = _logits(torch.einsum("btd,bd->bt", img, txt), logit_scale, logit_bias)
    return _logsig_loss(_signed(frame_labels), logits) / logits.shape[0], logits


def grounding_contrastive_head(pooler_output, text_embeds, frame_labels, logit_scale, logit_bias,
                               group=None):
    """Global-batch frame-vs-caption contrastive grounding: frames, captions
    and targets gathered over the group; the label matrix is -1 except each
    video's own caption column, which carries its per-frame +-1 targets."""
    b, t, d = pooler_output.shape
    img = _norm(pooler_output.float()).reshape(b * t, d)
    txt = _norm(text_embeds.float())
    img_all = all_gather_features(img, group)  # (W*B*t, D)
    txt_all = all_gather_features(txt, group)  # (W*B, D)
    tgt_all = all_gather_features(_signed(frame_labels), group)  # (W*B, T)
    logits = _logits(img_all @ txt_all.t(), logit_scale, logit_bias)
    total_b = txt_all.shape[0]
    # labels[i*t + k, j] = tgt_all[i, k] if i == j else -1
    row_video = torch.arange(total_b, device=logits.device).repeat_interleave(t)
    own = row_video[:, None] == torch.arange(total_b, device=logits.device)[None, :]
    labels = torch.where(own, tgt_all.reshape(total_b * t, 1), -torch.ones_like(logits))
    return _logsig_loss(labels, logits) / (total_b * t), logits


def naive_localization_head(pooler_output, label_embeddings, target_labels, logit_scale,
                            logit_bias):
    """Windowed temporal action localization: pooler_output (B*W, T, D) is
    regrouped to (B, W*T, D), the window size read from target_labels
    (B, W*T, L) in {-1, 0, +1}; per-frame sigmoid-BCE against the label
    embeddings (L, D)."""
    d = pooler_output.shape[-1]
    window = target_labels.shape[1]
    img = _norm(pooler_output.float().reshape(-1, window, d))
    txt = _norm(label_embeddings.float())
    logits = _logits(torch.einsum("btd,ld->btl", img, txt), logit_scale, logit_bias)
    loss = _logsig_loss(target_labels.float(), logits) / (target_labels.shape[0] * window)
    return loss, logits


def universal_localization_head(pooler_output, label_embeddings, class_mask, frame_labels,
                                logit_scale, logit_bias):
    """Per-frame localization against per-dataset label tables:
    label_embeddings (B, L_max, D) with class_mask (B, L_max) bool;
    frame_labels (B, T) int, -1 = background. Targets are -1 everywhere and
    +1 at (frame, its class) for foreground frames; per-sample sum / T, then
    the mean over the batch."""
    img = _norm(pooler_output.float())
    logits = _logits(torch.einsum("btd,bld->btl", img, label_embeddings.float()),
                     logit_scale, logit_bias)
    b, t, l = logits.shape
    fg = frame_labels >= 0
    cls = torch.where(fg, frame_labels, torch.zeros_like(frame_labels)).long()
    onehot = F.one_hot(cls, l).to(logits.dtype) * fg[..., None]
    per_elem = -F.logsigmoid((2.0 * onehot - 1.0) * logits) * class_mask[:, None, :]
    return per_elem.sum() / t / b, logits


# ---------------------------------------------------------------------------
# Spatial (dense) heads
# ---------------------------------------------------------------------------


def dense_projection_params(head: nn.Module) -> Projection:
    """Frozen copy of the MAP head's V, out-projection, LayerNorm and MLP,
    used to project patch tokens into the pooled-embedding space. Every
    tensor is detached: the spatial heads train the backbone through the
    patch features only, never through this projection. A tensor-parallel
    head's shards are gathered whole (a collective of its model group)."""
    d = head.attention.out_proj.weight.shape[0]
    attn = head.attention

    def whole(p):
        return sharding.full_tensor(p, sharding.shard_info(p))

    in_w, in_b = whole(attn.in_proj_weight), whole(attn.in_proj_bias)
    tensors = {
        "v.weight": in_w[2 * d:], "v.bias": in_b[2 * d:],
        "out.weight": whole(attn.out_proj.weight), "out.bias": attn.out_proj.bias,
        "layernorm.weight": head.layernorm.weight, "layernorm.bias": head.layernorm.bias,
        "fc1.weight": whole(head.mlp.fc1.weight), "fc1.bias": whole(head.mlp.fc1.bias),
        "fc2.weight": whole(head.mlp.fc2.weight), "fc2.bias": head.mlp.fc2.bias,
    }
    return {k: v.detach().float() for k, v in tensors.items()}


def dense_feature_projection(x: torch.Tensor, p: Projection, eps: float = 1e-6) -> torch.Tensor:
    """(..., N, D) patch features -> the pooled-embedding space: V and out
    projections, then the head's LN + MLP residual (exact GELU)."""
    y = F.linear(F.linear(x.float(), p["v.weight"], p["v.bias"]), p["out.weight"], p["out.bias"])
    ln = F.layer_norm(y, y.shape[-1:], p["layernorm.weight"], p["layernorm.bias"], eps)
    m = F.linear(F.gelu(F.linear(ln, p["fc1.weight"], p["fc1.bias"])), p["fc2.weight"],
                 p["fc2.bias"])
    return y + m


def _bilinear_resize_logits(logits: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(..., hp, wp, L) -> (..., out_h, out_w, L), bilinear with half-pixel
    centres (torch's ``align_corners=False``), as two small matrix products,
    one per axis. Enlarging, the heads' case (patch grid to mask size), this
    is ``F.interpolate`` and ``jax.image.resize`` alike; shrinking, it
    antialiases as ``jax.image.resize`` does (``F.interpolate`` would not
    unless asked). As products its backward sums in a fixed order, where
    ``F.interpolate``'s backward on a card adds with atomics."""
    hp, wp = logits.shape[-3], logits.shape[-2]
    wy = linear_resize_weights(hp, out_h, logits.device)
    wx = linear_resize_weights(wp, out_w, logits.device)
    rows = torch.einsum("oh,...hwl->...owl", wy, logits)
    return torch.einsum("pw,...owl->...opl", wx, rows)


def _masked_mean_nll(nll: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Per-sample mean of nll (B, T, H, W) over its valid pixels (0 for a
    sample with none), then the mean over the batch."""
    total = (nll * valid).flatten(1).sum(1)
    count = valid.flatten(1).sum(1)
    per_sample = torch.where(count > 0, total / count.clamp_min(1), torch.zeros_like(total))
    return per_sample.mean()


def vis_segmentation_head(last_hidden_state, proj_params, label_embeddings, class_mask,
                          mask_target, logit_scale, logit_bias):
    """Per-pixel cross-entropy open-vocabulary video instance segmentation.

    last_hidden_state (B, T, N, D); proj_params from
    ``dense_projection_params``; label_embeddings (B, L_sel, D), the classes
    pre-sampled per sample, with class_mask (B, L_sel) bool; mask_target
    (B, T, H_out, W_out) int, -1 = ignore. Patch logits are resized to the
    mask, classes outside the mask set to -inf, and each sample's NLL
    averaged over its labelled pixels. Returns the logits on the patch grid
    (B, T, hp, hp, L_sel)."""
    b, t, n, d = last_hidden_state.shape
    hp = int(round(n**0.5))
    img = _norm(dense_feature_projection(last_hidden_state, proj_params))
    logits = _logits(torch.einsum("btpd,bld->btpl", img, label_embeddings.float()),
                     logit_scale, logit_bias).reshape(b, t, hp, hp, -1)
    out_h, out_w = mask_target.shape[2], mask_target.shape[3]
    lg = _bilinear_resize_logits(logits, out_h, out_w)
    lg = lg.masked_fill(~class_mask.bool()[:, None, None, None, :], float("-inf"))
    logp = F.log_softmax(lg, dim=-1)
    valid = mask_target >= 0
    cls = torch.where(valid, mask_target, torch.zeros_like(mask_target)).long()
    nll = -logp.gather(-1, cls[..., None])[..., 0]
    return _masked_mean_nll(nll, valid), logits


def refervos_contrastive_head(last_hidden_state, proj_params, text_embeds, mask_target,
                              logit_scale, logit_bias, group=None):
    """Pixel-to-caption contrastive cross-entropy (ReferVOS): text embeddings
    gathered over the group; a pixel of video b inside its mask (target 1) is
    a positive for caption column rank*B + b, with the cross-entropy over the
    global caption axis; every other pixel is ignored. Returns the logits
    per patch, (B, T, N, W*B)."""
    b, t, n, d = last_hidden_state.shape
    hp = int(round(n**0.5))
    img = _norm(dense_feature_projection(last_hidden_state, proj_params))
    txt_all = all_gather_features(_norm(text_embeds.float()), group)  # (W*B, D)
    logits = _logits(torch.einsum("btpd,nd->btpn", img, txt_all), logit_scale, logit_bias)
    out_h, out_w = mask_target.shape[2], mask_target.shape[3]
    grid = logits.reshape(b, t, hp, hp, -1)
    logp = F.log_softmax(_bilinear_resize_logits(grid, out_h, out_w), dim=-1)
    idx = axis_rank(group) * b + torch.arange(b, device=logp.device)
    nll = -logp.gather(-1, idx.view(b, 1, 1, 1, 1).expand(b, t, out_h, out_w, 1))[..., 0]
    return _masked_mean_nll(nll, mask_target == 1), logits
