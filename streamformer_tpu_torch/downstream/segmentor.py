"""Mask2Former-style video instance segmentor on the ViT-Adapter FPN, on
PyTorch.

Port of the JAX package's ``downstream/segmentor.py`` (the reference's
OVIS stack, a fork of CTVIS / Mask2Former / detectron2):

* the pixel decoder: MSDeformAttn encoder layers over the res3..res5
  scales, then the finest encoded scale upsampled onto a res2 lateral for
  the high-resolution mask features;
* the masked transformer decoder: learned queries, rounds of masked
  cross-attention, self-attention and FFN cycling through the three scales,
  class and mask heads after each round. A query attends only where its
  current mask, resized to the scale (``jax.image.resize`` "linear", fp32,
  antialiased on a downscale: ``data.transforms.resize``), has sigmoid >
  0.5; a row with no such key attends everywhere;
* the Hungarian matcher (numpy and scipy on the host, its ground truth
  resized by ``floor(i * in / out)``) and the criterion (CE with a
  no-object weight, sigmoid BCE and dice on matched masks, the ground truth
  resized with half-pixel nearest, ``jax.image.resize`` "nearest");
* the CTVIS trackers (``SimpleTracker``, ``HungarianTracker`` and its
  ``_Tracklet``s), ``mask_nms`` and ``track_video``, the detectron2 YAML
  reader and ``tracker_from_extras``: the port's own numpy copies.

Modules keep the JAX tree's keys as names (``self``/``cross`` attention as
``self_attn``/``cross_attn``), so ``checkpoint.segmentor_params_from_jax``
carries a JAX tree across. Layer norms take eps 1e-5.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from streamformer_tpu_torch.data.transforms import resize
from streamformer_tpu_torch.models import encoder
from streamformer_tpu_torch.models.adapter import get_reference_points
from streamformer_tpu_torch.ops.msdeform_attn import MSDeformAttn, ms_deform_attn


@dataclasses.dataclass(frozen=True)
class SegmentorConfig:
    hidden_dim: int = 256
    num_queries: int = 100
    num_classes: int = 40
    nheads: int = 8
    dim_feedforward: int = 1024
    enc_layers: int = 3  # pixel decoder encoder layers
    dec_layers: int = 9  # transformer decoder layers
    mask_dim: int = 256
    in_dim: int = 768  # adapter FPN channel dim
    no_object_weight: float = 0.1
    class_weight: float = 2.0
    mask_weight: float = 5.0
    dice_weight: float = 5.0


# ---------------------------------------------------------------------------
# shared primitives
# ---------------------------------------------------------------------------


def _linear(din: int, dout: int, generator) -> nn.Linear:
    lin = nn.Linear(din, dout)
    with torch.no_grad():
        nn.init.xavier_uniform_(lin.weight, generator=generator)
        lin.bias.zero_()
    return lin


def _normal(shape, generator) -> nn.Parameter:
    return nn.Parameter(0.02 * torch.randn(*shape, generator=generator))


class MHA(nn.Module):
    def __init__(self, d: int, generator=None):
        super().__init__()
        self.q, self.k, self.v, self.out = (_linear(d, d, generator) for _ in range(4))


def mha(p: MHA, q_in, kv_in, heads: int, attn_mask=None):
    """``attn_mask`` (B, Lq, Lk) bool, True = attend."""
    b, lq, d = q_in.shape
    lk = kv_in.shape[1]
    dh = d // heads
    q = p.q(q_in).reshape(b, lq, heads, dh)
    k = p.k(kv_in).reshape(b, lk, heads, dh)
    v = p.v(kv_in).reshape(b, lk, heads, dh)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * dh**-0.5
    if attn_mask is not None:
        s = s.masked_fill(~attn_mask[:, None], -1e30)
    o = torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), v).reshape(b, lq, d)
    return p.out(o)


def _ln(d: int) -> nn.LayerNorm:
    return nn.LayerNorm(d, eps=1e-5)


# ---------------------------------------------------------------------------
# pixel decoder
# ---------------------------------------------------------------------------


class PixelDecoderLayer(nn.Module):
    def __init__(self, cfg: SegmentorConfig, generator=None):
        super().__init__()
        d = cfg.hidden_dim
        self.attn = MSDeformAttn(d, 3, cfg.nheads, 4, generator=generator)
        self.ln1 = _ln(d)
        self.fc1 = _linear(d, cfg.dim_feedforward, generator)
        self.fc2 = _linear(cfg.dim_feedforward, d, generator)
        self.ln2 = _ln(d)


class PixelDecoder(nn.Module):
    def __init__(self, cfg: SegmentorConfig, generator=None):
        super().__init__()
        d = cfg.hidden_dim
        self.layers = nn.ModuleList(PixelDecoderLayer(cfg, generator)
                                    for _ in range(cfg.enc_layers))
        self.input_proj = nn.ModuleList(_linear(cfg.in_dim, d, generator) for _ in range(3))
        self.level_embed = _normal((3, d), generator)
        self.lateral_res2 = _linear(cfg.in_dim, d, generator)
        self.mask_proj = _linear(d, cfg.mask_dim, generator)


def pixel_decoder_forward(p: PixelDecoder, fpn: Dict[str, torch.Tensor], cfg: SegmentorConfig):
    """fpn: res2..res5, NHWC, cfg.in_dim channels. Returns the per-scale
    memory [res5, res4, res3] (each (B, H_i * W_i, D)), their shapes and
    the mask features (B, H2, W2, mask_dim)."""
    feats = [fpn["res5"], fpn["res4"], fpn["res3"]]  # coarse -> fine
    shapes = [(f.shape[1], f.shape[2]) for f in feats]
    b = feats[0].shape[0]
    src = torch.cat([p.input_proj[i](f.reshape(b, -1, f.shape[-1])) + p.level_embed[i]
                     for i, f in enumerate(feats)], 1)
    ref = get_reference_points(shapes, src.device).expand(b, -1, 3, -1)
    for lp in p.layers:
        src = lp.ln1(src + ms_deform_attn(lp.attn, src, ref, src, shapes))
        src = lp.ln2(src + lp.fc2(F.relu(lp.fc1(src))))
    outs = list(src.split([h * w for h, w in shapes], 1))
    # mask features: the finest encoded scale (res3) upsampled + a res2 lateral
    h3, w3 = shapes[2]
    res2 = fpn["res2"]
    h2, w2 = res2.shape[1], res2.shape[2]
    up = resize(outs[2].reshape(b, h3, w3, cfg.hidden_dim), (h2, w2))
    mask_feat = up + p.lateral_res2(res2)
    return outs, shapes, p.mask_proj(mask_feat)


# ---------------------------------------------------------------------------
# masked transformer decoder
# ---------------------------------------------------------------------------


class MaskDecoderLayer(nn.Module):
    def __init__(self, cfg: SegmentorConfig, generator=None):
        super().__init__()
        d = cfg.hidden_dim
        self.cross_attn = MHA(d, generator)
        self.ln1 = _ln(d)
        self.self_attn = MHA(d, generator)
        self.ln2 = _ln(d)
        self.fc1 = _linear(d, cfg.dim_feedforward, generator)
        self.fc2 = _linear(cfg.dim_feedforward, d, generator)
        self.ln3 = _ln(d)


class MaskHead(nn.Module):
    def __init__(self, d: int, mask_dim: int, generator=None):
        super().__init__()
        self.fc1 = _linear(d, d, generator)
        self.fc2 = _linear(d, d, generator)
        self.fc3 = _linear(d, mask_dim, generator)


class MaskDecoder(nn.Module):
    def __init__(self, cfg: SegmentorConfig, generator=None):
        super().__init__()
        d = cfg.hidden_dim
        self.layers = nn.ModuleList(MaskDecoderLayer(cfg, generator)
                                    for _ in range(cfg.dec_layers))
        self.query_feat = _normal((cfg.num_queries, d), generator)
        self.query_embed = _normal((cfg.num_queries, d), generator)
        self.decoder_norm = _ln(d)
        self.class_head = _linear(d, cfg.num_classes + 1, generator)
        self.mask_head = MaskHead(d, cfg.mask_dim, generator)


def attention_mask(masks: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """(B, Q, H2, W2) mask logits -> (B, Q, h*w) bool: where the mask,
    resized to ``size`` in fp32, has sigmoid > 0.5; a row with no such key
    attends everywhere (the reference's guard)."""
    b, q = masks.shape[:2]
    am = resize(masks.float()[..., None], size)[..., 0]
    keep = (torch.sigmoid(am) > 0.5).reshape(b, q, -1)
    return keep | ~keep.any(-1, keepdim=True)


def mask_decoder_forward(p: MaskDecoder, memory: List[torch.Tensor], shapes, mask_feat,
                         cfg: SegmentorConfig, attn_masks: Optional[list] = None):
    """Returns pred_logits (B, Q, C+1), pred_masks (B, Q, H2, W2), the
    normalised query embeddings (B, Q, D) and ``aux``, the earlier rounds'
    predictions. ``attn_masks``, a list, receives each round's attention
    mask."""
    b = memory[0].shape[0]
    q = p.query_feat[None].expand(b, -1, -1)
    qe = p.query_embed[None]

    def predict(q):
        qn = p.decoder_norm(q)
        mh = p.mask_head
        membed = mh.fc3(F.relu(mh.fc2(F.relu(mh.fc1(qn)))))
        return p.class_head(qn), torch.einsum("bqc,bhwc->bqhw", membed, mask_feat), qn

    aux = []
    logits, masks, _ = predict(q)
    for li, lp in enumerate(p.layers):
        scale = li % len(memory)
        am = attention_mask(masks, shapes[scale])
        if attn_masks is not None:
            attn_masks.append(am)
        q = lp.ln1(q + mha(lp.cross_attn, q + qe, memory[scale], cfg.nheads, attn_mask=am))
        q = lp.ln2(q + mha(lp.self_attn, q + qe, q + qe, cfg.nheads))
        q = lp.ln3(q + lp.fc2(F.relu(lp.fc1(q))))
        logits, masks, qn = predict(q)
        aux.append({"pred_logits": logits, "pred_masks": masks})
    return {"pred_logits": logits, "pred_masks": masks, "embeddings": qn, "aux": aux[:-1]}


class Segmentor(nn.Module):
    """The segmentor's parameters (the JAX package's ``init_segmentor``
    tree), fp32 on ``device`` (``cuda`` unless named)."""

    def __init__(self, cfg: SegmentorConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.pixel_decoder = PixelDecoder(cfg, generator)
        self.mask_decoder = MaskDecoder(cfg, generator)
        self.to(encoder.resolve_device(device))

    def forward(self, fpn: Dict[str, torch.Tensor]) -> Dict:
        return segmentor_forward(self, fpn, self.cfg)


def segmentor_forward(p: Segmentor, fpn, cfg: SegmentorConfig, attn_masks: Optional[list] = None):
    memory, shapes, mask_feat = pixel_decoder_forward(p.pixel_decoder, fpn, cfg)
    return mask_decoder_forward(p.mask_decoder, memory, shapes, mask_feat, cfg, attn_masks)


# ---------------------------------------------------------------------------
# matcher + criterion
# ---------------------------------------------------------------------------


def dice_loss(pred: torch.Tensor, target: torch.Tensor, eps: float = 1.0) -> torch.Tensor:
    """pred logits, target {0, 1}; flattened over pixels."""
    p = torch.sigmoid(pred).reshape(pred.shape[0], -1)
    t = target.reshape(target.shape[0], -1)
    return 1 - (2 * (p * t).sum(-1) + eps) / (p.sum(-1) + t.sum(-1) + eps)


def _bce_logits(pred, target):
    return pred.clamp_min(0) - pred * target + torch.log1p(torch.exp(-pred.abs()))


def hungarian_match(
    pred_logits: np.ndarray,  # (Q, C+1)
    pred_masks: np.ndarray,  # (Q, H, W)
    gt_classes: np.ndarray,  # (G,)
    gt_masks: np.ndarray,  # (G, H, W)
    cfg: SegmentorConfig,
) -> Tuple[np.ndarray, np.ndarray]:
    """Bipartite matching on class and mask costs on the host (mask2former
    matcher semantics)."""
    from scipy.optimize import linear_sum_assignment

    if len(gt_classes) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    if gt_masks.shape[1:] != pred_masks.shape[1:]:
        ph, pw = pred_masks.shape[1:]
        yi = (np.arange(ph) * gt_masks.shape[1] / ph).astype(int)
        xi = (np.arange(pw) * gt_masks.shape[2] / pw).astype(int)
        gt_masks = gt_masks[:, yi][:, :, xi]
    prob = np.exp(pred_logits - pred_logits.max(-1, keepdims=True))
    prob /= prob.sum(-1, keepdims=True)
    cost_class = -prob[:, gt_classes]  # (Q, G)
    pm = pred_masks.reshape(len(pred_masks), -1)
    gm = gt_masks.reshape(len(gt_masks), -1).astype(np.float32)
    ps = 1 / (1 + np.exp(-pm))
    num = 2 * ps @ gm.T
    den = ps.sum(-1, keepdims=True) + gm.sum(-1)[None]
    cost_dice = 1 - (num + 1) / (den + 1)
    bce_pos = np.logaddexp(0, -pm) @ gm.T / gm.shape[1]
    bce_neg = np.logaddexp(0, pm) @ (1 - gm).T / gm.shape[1]
    cost = (cfg.class_weight * cost_class + cfg.mask_weight * (bce_pos + bce_neg)
            + cfg.dice_weight * cost_dice)
    qi, gi = linear_sum_assignment(cost)
    return qi.astype(np.int64), gi.astype(np.int64)


def criterion(
    outputs: Dict[str, torch.Tensor],
    matches: List[Tuple[np.ndarray, np.ndarray]],  # per sample (qi, gi)
    gt_classes: torch.Tensor,  # (B, Gmax), -1 padded
    gt_masks: torch.Tensor,  # (B, Gmax, H, W)
    cfg: SegmentorConfig,
) -> torch.Tensor:
    """Set-prediction loss on given matches: CE over classes (no-object for
    the unmatched), BCE and dice on the matched masks."""
    logits_all = outputs["pred_logits"]
    b, qn = logits_all.shape[:2]
    dev = logits_all.device
    total = logits_all.new_zeros(())
    for i in range(b):
        qi, gi = (torch.as_tensor(a, dtype=torch.int64).to(dev, non_blocking=True)
                  for a in matches[i])
        tgt = torch.full((qn,), cfg.num_classes, dtype=torch.int64, device=dev)
        if len(qi):
            tgt = tgt.index_put((qi,), gt_classes[i][gi].to(torch.int64))
        logp = torch.log_softmax(logits_all[i], -1)
        w = torch.where(tgt == cfg.num_classes, cfg.no_object_weight, 1.0)
        ce = -logp.gather(1, tgt[:, None])[:, 0] * w
        total = total + cfg.class_weight * ce.sum() / w.sum()
        if len(qi):
            pm = outputs["pred_masks"][i][qi]
            gm = gt_masks[i][gi].float()
            if gm.shape != pm.shape:
                gm = resize(gm[..., None], tuple(pm.shape[1:]), "nearest")[..., 0]
            total = total + cfg.mask_weight * _bce_logits(pm, gm).mean()
            total = total + cfg.dice_weight * dice_loss(pm, gm).mean()
    return total / b


# ---------------------------------------------------------------------------
# CTVIS-style online trackers (numpy, host-side)
# ---------------------------------------------------------------------------


class SimpleTracker:
    """Similarity-guided online instance tracker with a momentum memory bank
    (reference ctvis SimpleTracker, ctvis_model.py:368)."""

    def __init__(self, sim_threshold: float = 0.5, momentum: float = 0.8):
        self.sim_threshold = sim_threshold
        self.momentum = momentum
        self.memory: Optional[np.ndarray] = None  # (K, D)
        self.ids: List[int] = []
        self._next = 0

    def reset(self):
        self.memory, self.ids, self._next = None, [], 0

    def update(self, embeddings: np.ndarray, scores=None,
               frame_id: Optional[int] = None) -> List[int]:
        """embeddings: (N, D) for this frame's kept instances; returns
        per-instance track ids. ``scores``/``frame_id`` are accepted (and
        ignored: this tracker is purely similarity-driven) so track_video
        can drive either tracker through one call signature."""
        emb = embeddings / np.maximum(np.linalg.norm(embeddings, axis=-1, keepdims=True), 1e-6)
        if self.memory is None or not len(self.ids):
            self.memory = emb.copy()
            self.ids = list(range(len(emb)))
            self._next = len(emb)
            return list(self.ids)
        mem = self.memory / np.maximum(np.linalg.norm(self.memory, axis=-1, keepdims=True), 1e-6)
        sim = emb @ mem.T  # (N, K)
        from scipy.optimize import linear_sum_assignment

        ni, ki = linear_sum_assignment(-sim)
        out_ids = [-1] * len(emb)
        for n, k in zip(ni, ki):
            if sim[n, k] >= self.sim_threshold:
                out_ids[n] = self.ids[k]
                self.memory[k] = self.momentum * self.memory[k] + (1 - self.momentum) * emb[n]
        for n in range(len(emb)):
            if out_ids[n] == -1:  # new track
                out_ids[n] = self._next
                self._next += 1
                self.memory = np.concatenate([self.memory, emb[n:n + 1]])
                self.ids.append(out_ids[n])
        return out_ids


class _Tracklet:
    """One track's bounded history and fused association embedding
    (reference Tracklet, memory_bank.py:5-58): the last ``maximum_cache``
    (score, embedding) pairs, a momentum EMA and the similarity-guided
    fusion of arXiv 2203.14208 (a new embedding moves the fused one in
    proportion to its mean cosine similarity with the history)."""

    def __init__(self, track_id: int, maximum_cache: int = 10, momentum: float = 0.75):
        self.track_id = track_id
        self.scores: List[float] = []
        self.embeds: List[np.ndarray] = []
        self.frame_ids: List[int] = []
        self.exist_frames = 0
        self.maximum_cache = maximum_cache
        self.momentum = momentum
        self.momentum_embed: Optional[np.ndarray] = None
        self.sim_guided_embed: Optional[np.ndarray] = None

    @property
    def last_frame(self) -> int:
        return self.frame_ids[-1]

    def update(self, score: float, embed: np.ndarray, frame_id: int):
        self.scores.append(float(score))
        self.embeds.append(np.asarray(embed, np.float32))
        self.frame_ids.append(int(frame_id))
        if self.exist_frames == 0:
            self.momentum_embed = self.embeds[-1].copy()
            self.sim_guided_embed = self.embeds[-1].copy()
        else:
            # (1 - m) * old + m * new with m = 0.75: the new embedding
            # dominates, as in the reference (memory_bank.py:40)
            m = self.momentum
            self.momentum_embed = (1 - m) * self.momentum_embed + m * embed
            hist = np.stack(self.embeds[:-1])
            hn = hist / np.maximum(np.linalg.norm(hist, axis=-1, keepdims=True), 1e-6)
            en = embed / max(np.linalg.norm(embed), 1e-6)
            beta = max(0.0, float(np.mean(hn @ en)))
            self.sim_guided_embed = (1 - beta) * self.sim_guided_embed + beta * embed
        self.exist_frames += 1
        if len(self.scores) > self.maximum_cache:
            self.scores.pop(0)
            self.embeds.pop(0)
            self.frame_ids.pop(0)  # only frame_ids[-1] is read

    def fused_embed(self, embed_type: str) -> np.ndarray:
        if embed_type == "last":
            return self.embeds[-1]
        if embed_type == "momentum":
            return self.momentum_embed
        if embed_type == "similarity_guided":
            return self.sim_guided_embed
        if embed_type == "temporally_weighted_softmax":
            s = np.asarray(self.scores, np.float32)
            w = s + np.linspace(1 / len(s), 1.0, len(s), dtype=np.float32)
            return (np.stack(self.embeds) * w[:, None]).sum(0) / w.sum()
        raise ValueError(f"unknown embed_type {embed_type!r}")


class HungarianTracker:
    """Memory-bank online tracker with global (Hungarian) assignment
    (reference HungarianTracker + MemoryBank,
    hungarian_tracker.py:254-338): detections match live tracklets on a
    bisoftmax or cosine similarity against each tracklet's fused embedding;
    tracks unseen for ``num_dead_frames`` retire; ``frame_weight`` prefers
    long-lived tracklets. ``match_type='hungarian'`` (default) assigns
    globally, ``'greedy'`` resolves in detection order as the reference
    does."""

    def __init__(
        self,
        match_metric: str = "bisoftmax",
        match_type: str = "hungarian",
        match_score_thr: float = 0.2,
        init_score_thr: float = 0.01,
        frame_weight: bool = True,
        num_dead_frames: int = 20,
        embed_type: str = "similarity_guided",
        maximum_cache: int = 10,
    ):
        assert match_metric in ("bisoftmax", "cosine")
        assert match_type in ("hungarian", "greedy")
        assert embed_type in ("last", "momentum", "similarity_guided",
                              "temporally_weighted_softmax")
        self.match_metric = match_metric
        self.match_type = match_type
        self.match_score_thr = match_score_thr
        self.init_score_thr = init_score_thr
        self.frame_weight = frame_weight
        self.num_dead_frames = num_dead_frames
        self.embed_type = embed_type
        self.maximum_cache = maximum_cache
        self.reset()

    def reset(self):
        self.tracklets: Dict[int, _Tracklet] = {}
        self._next = 0
        self._frame = 0

    def _bank(self) -> Tuple[List[int], np.ndarray, np.ndarray]:
        ids = list(self.tracklets.keys())
        embeds = np.stack([self.tracklets[i].fused_embed(self.embed_type) for i in ids])
        exist = np.asarray([self.tracklets[i].exist_frames for i in ids], np.float32)
        return ids, embeds, exist

    def _match_scores(self, embeds: np.ndarray, bank: np.ndarray):
        if self.match_metric == "bisoftmax":
            sim = embeds @ bank.T  # (N, K)

            def sm(x, ax):
                e = np.exp(x - x.max(ax, keepdims=True))
                return e / np.sum(e, ax, keepdims=True)

            return (sm(sim, 1) + sm(sim, 0)) / 2
        en = embeds / np.maximum(np.linalg.norm(embeds, axis=-1, keepdims=True), 1e-6)
        bn = bank / np.maximum(np.linalg.norm(bank, axis=-1, keepdims=True), 1e-6)
        return en @ bn.T

    def update(self, embeddings: np.ndarray, scores: Optional[np.ndarray] = None,
               frame_id: Optional[int] = None) -> List[int]:
        """Assign this frame's detections (in descending score) to track
        ids; -1 = dropped (below the init threshold and unmatched)."""
        embeddings = np.asarray(embeddings, np.float32)
        n = len(embeddings)
        scores = np.ones(n, np.float32) if scores is None else np.asarray(scores, np.float32)
        frame_id = self._frame if frame_id is None else int(frame_id)
        self._frame = frame_id + 1
        # retire dead tracklets before matching, against the previous frame:
        # the bank the reference's clean after frame f - 1 leaves
        for tid in [t for t, tr in self.tracklets.items()
                    if (frame_id - 1) - tr.last_frame > self.num_dead_frames]:
            del self.tracklets[tid]

        out = np.full(n, -1, np.int64)
        if self.tracklets and n:
            ids, bank, exist = self._bank()
            ms = self._match_scores(embeddings, bank)
            if self.match_type == "hungarian":
                weighted = ms
                if self.frame_weight:
                    # rows with > 1 valid candidate prefer long-lived
                    # tracklets; the rest scale by the valid ones' mean
                    weighted = ms.copy()
                    for i in range(n):
                        valid = ms[i] > self.match_score_thr
                        if valid.sum() > 1:
                            weighted[i] = np.where(valid, ms[i] * exist,
                                                   ms[i] * exist[valid].mean())
                from scipy.optimize import linear_sum_assignment

                ni, ki = linear_sum_assignment(-weighted)
                for i, k in zip(ni, ki):
                    if ms[i, k] > self.match_score_thr:
                        out[i] = ids[k]
            else:
                # greedy in detection order (hungarian_tracker.py:289-311):
                # the weighting only with > 1 valid candidates, the
                # threshold on the weighted max, a match zeroes its column
                ms_work = ms.copy()
                for i in range(n):
                    row = ms_work[i]
                    valid = row > self.match_score_thr
                    if self.frame_weight and valid.sum() > 1:
                        row = np.where(valid, row * exist, row * exist[valid].mean())
                    k = int(np.argmax(row))
                    if row[k] > self.match_score_thr:
                        out[i] = ids[k]
                        ms_work[:, k] = 0.0
        for i in range(n):
            if out[i] == -1 and scores[i] > self.init_score_thr:
                out[i] = self._next
                self._next += 1
                self.tracklets[int(out[i])] = _Tracklet(int(out[i]), self.maximum_cache)
        for i in range(n):
            if out[i] >= 0:
                self.tracklets[int(out[i])].update(scores[i], embeddings[i], frame_id)
        return out.tolist()


def make_tracker(name: str, **kwargs):
    """TRACKER_NAME dispatch (reference TRACKER_REGISTRY)."""
    if name == "SimpleTracker":
        allowed = {"sim_threshold", "momentum"}
        return SimpleTracker(**{k: v for k, v in kwargs.items() if k in allowed})
    if name == "HungarianTracker":
        return HungarianTracker(**kwargs)
    raise ValueError(f"unknown tracker {name!r}")


def mask_nms(masks: np.ndarray, nms_thr: float = 0.6) -> np.ndarray:
    """Keep-mask over score-ordered binary masks: drop a mask whose IoU with
    a kept earlier (higher-scoring) mask exceeds ``nms_thr`` (reference
    ctvis/utils/utils.py:154-174)."""
    n = len(masks)
    keep = np.ones(n, bool)
    flat = masks.reshape(n, -1).astype(bool)
    area = flat.sum(-1)
    for i in range(n - 1):
        if not keep[i]:
            continue
        for j in range(i + 1, n):
            if not keep[j]:
                continue
            inter = np.count_nonzero(flat[i] & flat[j])
            union = area[i] + area[j] - inter
            if union > 0 and inter / union > nms_thr:
                keep[j] = False
    return keep


def _sigmoid_positive(x: np.ndarray) -> np.ndarray:
    """sigmoid(x) > 0.5 in fp32."""
    x = np.asarray(x, np.float32)
    return np.float32(1) / (np.float32(1) + np.exp(-x)) > np.float32(0.5)


def track_video(
    frame_logits: np.ndarray,  # (T, Q, C+1)
    frame_masks: np.ndarray,  # (T, Q, H, W) logits
    frame_embeds: np.ndarray,  # (T, Q, D)
    tracker,
    inference_select_thr: float = 0.01,
    mask_nms_thr: float = 0.6,
) -> List[Dict]:
    """Per-frame selection -> mask NMS -> tracking over a video's
    detections (the reference HungarianTracker.inference loop,
    hungarian_tracker.py:119-204). Returns per-frame dicts in
    ``eval.ytvis.collect_video_result``'s format."""
    tracker.reset()
    outs: List[Dict] = []
    for t in range(len(frame_logits)):
        logits = frame_logits[t]
        probs = np.exp(logits - logits.max(-1, keepdims=True))
        probs /= probs.sum(-1, keepdims=True)
        cls_scores = probs[:, :-1]
        score = cls_scores.max(-1)
        cat = cls_scores.argmax(-1)
        order = np.argsort(-score)
        keep = order[score[order] > inference_select_thr]
        if len(keep) == 0:  # always keep the best (reference :146-147)
            keep = order[:1]
        keep = keep[mask_nms(_sigmoid_positive(frame_masks[t][keep]), mask_nms_thr)]
        ids = tracker.update(frame_embeds[t][keep], score[keep], frame_id=t)
        sel = [i for i, tid in enumerate(ids) if tid >= 0]
        outs.append({
            "track_ids": [ids[i] for i in sel],
            "category_ids": cat[keep][sel].tolist(),
            "scores": score[keep][sel].tolist(),
            "masks": _sigmoid_positive(frame_masks[t][keep][sel]),
        })
    return outs


# ---------------------------------------------------------------------------
# detectron2-config compatibility (reference
# downstream/OVIS/configs/_base_/M2F.yaml + ytvis_2019/CTVIS_Streamformer.yaml)
# ---------------------------------------------------------------------------


def _deep_update(base: dict, new: dict) -> dict:
    for k, v in new.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _deep_update(base[k], v)
        else:
            base[k] = v
    return base


def load_detectron2_yaml(path: str) -> dict:
    """Resolve a detectron2-style YAML with ``_BASE_`` inheritance chains."""
    import os

    import yaml

    with open(path) as f:
        cfg = yaml.safe_load(f) or {}
    bases = cfg.pop("_BASE_", [])
    if isinstance(bases, str):
        bases = [bases]
    merged: dict = {}
    for b in bases:
        _deep_update(merged, load_detectron2_yaml(os.path.join(os.path.dirname(path), b)))
    return _deep_update(merged, cfg)


def config_from_detectron2_yaml(path: str):
    """Map the reference's detectron2 CTVIS/Mask2Former YAML keys onto
    (SegmentorConfig, extras): extras carries the tracker, CL-plugin,
    backbone, solver and input fields outside the segmentor itself."""
    cfg = load_detectron2_yaml(path)
    model = cfg.get("MODEL", {})
    mf = model.get("MASK_FORMER", {})
    ssh = model.get("SEM_SEG_HEAD", {})
    seg = SegmentorConfig(
        hidden_dim=int(mf.get("HIDDEN_DIM", 256)),
        num_queries=int(mf.get("NUM_OBJECT_QUERIES", 100)),
        num_classes=int(ssh.get("NUM_CLASSES", 40)),
        nheads=int(mf.get("NHEADS", 8)),
        dim_feedforward=int(mf.get("DIM_FEEDFORWARD", 1024)),
        enc_layers=int(ssh.get("TRANSFORMER_ENC_LAYERS", 3)),
        dec_layers=int(mf.get("DEC_LAYERS", 9)),
        mask_dim=int(ssh.get("MASK_DIM", 256)),
        in_dim=int(model.get("BACKBONE", {}).get("HIDDEN_SIZE", 768)),
        no_object_weight=float(mf.get("NO_OBJECT_WEIGHT", 0.1)),
        class_weight=float(mf.get("CLASS_WEIGHT", 2.0)),
        mask_weight=float(mf.get("MASK_WEIGHT", 5.0)),
        dice_weight=float(mf.get("DICE_WEIGHT", 5.0)),
    )
    tracker = model.get("TRACKER", {})
    bank = tracker.get("MEMORY_BANK", {})
    clp = model.get("CL_PLUGIN", {})
    solver = cfg.get("SOLVER", {})
    inp = cfg.get("INPUT", {})
    extras = {
        "backbone_pretrained": model.get("BACKBONE", {}).get("PRETRAINED"),
        "backbone_checkpoint": model.get("BACKBONE", {}).get("CHECKPOINT"),
        # the whole TRACKER block (reference ctvis/config.py:18-39 defaults)
        "tracker_name": tracker.get("TRACKER_NAME", "SimpleTracker"),
        "match_score_thr": float(tracker.get("MATCH_SCORE_THR", 0.3)),
        "match_metric": tracker.get("MATCH_METRIC", "bisoftmax"),
        "match_type": tracker.get("MATCH_TYPE", "hungarian"),
        "frame_weight": bool(tracker.get("FRAME_WEIGHT", True)),
        "temporal_score_type": tracker.get("TEMPORAL_SCORE_TYPE", "mean"),
        "inference_select_thr": float(tracker.get("INFERENCE_SELECT_THR", 0.01)),
        "init_score_thr": float(tracker.get("INIT_SCORE_THR", 0.01)),
        "mask_nms_thr": float(tracker.get("MASK_NMS_THR", 0.6)),
        "num_dead_frames": int(bank.get("NUM_DEAD_FRAMES", 20)),
        "embed_type": bank.get("EMBED_TYPE", "similarity_guided"),
        "maximum_cache": int(bank.get("maximum_cache", 10)),
        "cl_plugin_name": clp.get("CL_PLUGIN_NAME", "CTCLPlugin"),
        "one_direction": bool(clp.get("ONE_DIRECTION", True)),
        "reid_weight": float(clp.get("REID_WEIGHT", 2.0)),
        "aux_reid_weight": float(clp.get("AUX_REID_WEIGHT", 3.0)),
        "num_negatives": int(clp.get("NUM_NEGATIVES", 99)),
        # SOLVER / INPUT blocks (reference configs/_base_/YTVIS2019.yaml etc.)
        "base_lr": float(solver.get("BASE_LR", 1e-4)),
        "weight_decay": float(solver.get("WEIGHT_DECAY", 0.05)),
        "max_iter": int(solver.get("MAX_ITER", 0)),
        "ims_per_batch": int(solver.get("IMS_PER_BATCH", 1)),
        "backbone_multiplier": float(solver.get("BACKBONE_MULTIPLIER", 0.1)),
        "sampling_frame_num": int(inp.get("SAMPLING_FRAME_NUM", 2)),
        "datasets_train": cfg.get("DATASETS", {}).get("TRAIN"),
    }
    return seg, extras


def tracker_from_extras(extras: dict, name: Optional[str] = None):
    """The tracker a d2-config names (TRACKER_NAME and the MODEL.TRACKER /
    MEMORY_BANK hyperparameters)."""
    name = name or extras.get("tracker_name", "SimpleTracker")
    if name == "SimpleTracker":
        return SimpleTracker(sim_threshold=extras.get("match_score_thr", 0.3))
    return make_tracker(
        name,
        match_metric=extras.get("match_metric", "bisoftmax"),
        match_type=extras.get("match_type", "hungarian"),
        match_score_thr=extras.get("match_score_thr", 0.2),
        init_score_thr=extras.get("init_score_thr", 0.01),
        frame_weight=extras.get("frame_weight", True),
        num_dead_frames=extras.get("num_dead_frames", 20),
        embed_type=extras.get("embed_type", "similarity_guided"),
        maximum_cache=extras.get("maximum_cache", 10),
    )
