"""CTVIS contrastive-training plugin for online VIS, on PyTorch.

Port of the JAX package's ``downstream/ctvis_plugin.py`` (the reference's
``CTCLPlugin`` and ``MultiRefCLPlugin``): instance embeddings of one
identity across frames are positives, every other valid instance a
negative; the InfoNCE-style item loss and an auxiliary cosine loss teach
the association embedding the tracker matches on at inference.

``multi_ref_contrastive_loss`` computes every anchor frame at once, an
anchor axis in place of the JAX package's loop over anchors.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

_NEG = -1e30


def contrastive_items(key_embeds, ref_embeds, key_ids, ref_ids
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pairwise logits (Qk, Qr), same-identity targets and the validity
    mask; ids -1 = unmatched."""
    sim = key_embeds @ ref_embeds.T
    same = (key_ids[:, None] == ref_ids[None, :]) & (key_ids[:, None] >= 0)
    valid = (key_ids[:, None] >= 0) & (ref_ids[None, :] >= 0)
    return sim, same.float(), valid


def contrastive_loss(key_embeds, ref_embeds, key_ids, ref_ids, temperature: float = 1.0
                     ) -> torch.Tensor:
    """InfoNCE over the reference instances per anchor plus the auxiliary
    cosine loss (the reference's loss_track / loss_track_aux pair)."""
    logits, targets, valid = contrastive_items(key_embeds, ref_embeds, key_ids, ref_ids)
    logits = logits / temperature
    # InfoNCE with possibly many positives: -log(sum_pos / sum_all)
    logz = torch.logsumexp(logits.masked_fill(~valid, _NEG), 1)
    logpos = torch.logsumexp(logits.masked_fill(~(valid & (targets > 0)), _NEG), 1)
    has_pos = (targets * valid).sum(1) > 0
    nce = torch.where(has_pos, logz - logpos, torch.zeros_like(logz))
    loss_nce = nce.sum() / has_pos.sum().clamp_min(1)

    # aux cosine: same-id cosine to 1, different-id below a 0.3 margin
    kn = key_embeds / key_embeds.norm(dim=-1, keepdim=True)
    rn = ref_embeds / ref_embeds.norm(dim=-1, keepdim=True)
    cos = kn @ rn.T
    aux = torch.where(targets > 0, (1 - cos) ** 2, (cos - 0.3).clamp_min(0.0) ** 2)
    loss_aux = (aux * valid).sum() / valid.sum().clamp_min(1)
    return loss_nce + loss_aux


def multi_ref_contrastive_loss(embeds, ids, one_direction: bool = True, reid_weight: float = 2.0,
                               aux_reid_weight: float = 3.0) -> torch.Tensor:
    """Multi-reference-frame contrastive loss (reference MultiRefCLPlugin,
    multi_ref_cl_plugin.py:71-212). embeds (F, Q, D), ids (F, Q), -1 =
    unmatched.

    Every frame is an anchor (only frame 0 with ``one_direction``); a valid
    anchor instance's positives are its queries in the other frames where
    it is valid, its negatives every other valid query of those frames. The
    per-item loss ``logsumexp(pad(neg - pos, 1))`` is
    ``log1p(exp(logsumexp(neg) + logsumexp(-pos)))``; the aux term the
    squared error between cosine and the 0/1 identity label."""
    f = embeds.shape[0]
    anchors = 1 if one_direction else f
    a_emb, a_ids = embeds[:anchors], ids[:anchors]  # (A, Q, D), (A, Q)
    frames = torch.arange(f, device=embeds.device)
    other = frames[None, :] != frames[:anchors, None]  # (A, F)
    valid_ref = (ids >= 0)[None] & other[:, :, None]  # (A, F, Q)
    same = (a_ids[:, :, None, None] == ids[None, None]) & valid_ref[:, None]  # (A, Qa, F, Q)
    neg = valid_ref[:, None] & ~same
    logits = torch.einsum("aqd,fkd->aqfk", a_emb, embeds)
    lse_neg = torch.logsumexp(logits.masked_fill(~neg, _NEG).flatten(2), -1)
    lse_negpos = torch.logsumexp((-logits).masked_fill(~same, _NEG).flatten(2), -1)
    has_pos = (a_ids >= 0) & same.flatten(2).any(-1)  # (A, Qa)
    nce = torch.where(has_pos, torch.log1p(torch.exp((lse_neg + lse_negpos).clamp(-30.0, 30.0))),
                      torch.zeros_like(lse_neg))

    norm = embeds / embeds.norm(dim=-1, keepdim=True).clamp_min(1e-6)
    cos = torch.einsum("aqd,fkd->aqfk", norm[:anchors], norm)
    pair = (same | neg) & has_pos[:, :, None, None]
    aux = (cos - same.float()) ** 2
    loss_reid = nce.sum() / has_pos.sum().clamp_min(1)
    loss_aux = (aux * pair).sum() / pair.sum().clamp_min(1)
    return reid_weight * loss_reid + aux_reid_weight * loss_aux


def cl_loss_from_config(embeds, ids, extras: Optional[dict] = None) -> torch.Tensor:
    """CL_PLUGIN_NAME dispatch (reference CL_PLUGIN_REGISTRY):
    ``CTCLPlugin``, the pairwise key/reference loss on the first two
    frames; ``MultiRefCLPlugin``, the all-frame variant with the d2-config
    weights."""
    extras = extras or {}
    name = extras.get("cl_plugin_name", "CTCLPlugin")
    if name == "MultiRefCLPlugin":
        return multi_ref_contrastive_loss(
            embeds, ids, one_direction=extras.get("one_direction", True),
            reid_weight=extras.get("reid_weight", 2.0),
            aux_reid_weight=extras.get("aux_reid_weight", 3.0))
    if name == "CTCLPlugin":
        return contrastive_loss(embeds[0], embeds[1], ids[0], ids[1])
    raise ValueError(f"unknown CL plugin {name!r}")
