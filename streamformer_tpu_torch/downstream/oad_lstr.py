"""LSTR/MAT online action detector on extracted per-frame features, on PyTorch.

Port of the JAX package's ``downstream/oad_lstr.py`` (the reference's
MAT/LSTR fork, ``models/lstr.py``):

* feature heads fuse the visual features (768-d StreamFormer dumps) and an
  optional flow stream (``motion_size > 0``; visual columns first) into
  ``d_model``;
* the long memory is compressed group-wise: ``groups`` segments, each
  cross-attended by learned queries (a key-padding mask drops the zero
  padding of a short history) and average-pooled to one token, all groups
  as one batch; a second query module compresses the pooled tokens to
  ``enc_queries_1``;
* the work memory (and MAT's anticipation queries) runs a causal decoder
  over the compressed memory;
* MAT's future/CCI branch (``future_num_samples > 0``) generates future
  tokens and fuses work and future ``cci_times`` rounds;
* a classifier per work (and anticipation) token.

The forward draws no dropout: train and eval give the same logits.
Attention is written out (scores, a -1e30 fill where masked, softmax), so
a row whose keys are all masked attends uniformly, as in the JAX package.

``LSTRStream`` runs online inference a frame at a time: the long memory is
a FIFO on the model's device, and the compressed tokens are recomputed only
when a frame graduates into it, every ``long_sample_rate`` steps.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from streamformer_tpu_torch.models import encoder


@dataclasses.dataclass(frozen=True)
class LSTRConfig:
    visual_size: int = 768
    motion_size: int = 0  # 0 = no flow stream
    d_model: int = 1024
    num_heads: int = 8
    dim_feedforward: int = 1024
    dropout: float = 0.2
    num_classes: int = 22
    long_memory_num_samples: int = 512
    work_memory_num_samples: int = 32
    anticipation_num_samples: int = 0
    future_num_samples: int = 0
    enc_queries_0: int = 16  # ENC_MODULE[0][0]
    enc_layers_0: int = 1
    enc_queries_1: int = 32  # ENC_MODULE[1][0]
    enc_layers_1: int = 2
    dec_layers: int = 2
    gen_queries: int = 32  # GEN_MODULE[0]
    gen_layers: int = 2
    fut_queries: int = 48  # FUT_MODULE[0][0]
    groups: int = 8
    cci_times: int = 2
    max_pos: int = 2048


def _linear(din: int, dout: int, generator) -> nn.Linear:
    lin = nn.Linear(din, dout)
    with torch.no_grad():
        nn.init.xavier_uniform_(lin.weight, generator=generator)
        lin.bias.zero_()
    return lin


def _queries(n: int, d: int, generator) -> nn.Parameter:
    return nn.Parameter(0.02 * torch.randn(n, d, generator=generator))


class MHA(nn.Module):
    def __init__(self, d: int, generator=None):
        super().__init__()
        self.q, self.k, self.v, self.out = (_linear(d, d, generator) for _ in range(4))


def mha(p: MHA, q_in, kv_in, num_heads: int, mask=None, key_padding_mask=None):
    """q_in (B, Lq, D), kv_in (B, Lk, D); ``mask`` (Lq, Lk) bool (True =
    attend) or additive, ``key_padding_mask`` (B, Lk) True = keep."""
    b, lq, d = q_in.shape
    lk = kv_in.shape[1]
    dh = d // num_heads
    q = p.q(q_in).reshape(b, lq, num_heads, dh)
    k = p.k(kv_in).reshape(b, lk, num_heads, dh)
    v = p.v(kv_in).reshape(b, lk, num_heads, dh)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * dh**-0.5
    if mask is not None:
        s = s.masked_fill(~mask, -1e30) if mask.dtype == torch.bool else s + mask
    if key_padding_mask is not None:
        s = s.masked_fill(~key_padding_mask[:, None, None, :], -1e30)
    o = torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), v).reshape(b, lq, d)
    return p.out(o)


class DecoderLayer(nn.Module):
    """Post-norm transformer decoder layer (``nn.TransformerDecoderLayer``'s
    order, which the reference follows)."""

    def __init__(self, cfg: LSTRConfig, generator=None):
        super().__init__()
        d = cfg.d_model
        self.self_attn = MHA(d, generator)
        self.cross_attn = MHA(d, generator)
        self.fc1 = _linear(d, cfg.dim_feedforward, generator)
        self.fc2 = _linear(cfg.dim_feedforward, d, generator)
        self.ln1, self.ln2, self.ln3 = (nn.LayerNorm(d, eps=1e-5) for _ in range(3))


def decoder_layer(p: DecoderLayer, cfg: LSTRConfig, tgt, memory, tgt_mask=None, memory_mask=None,
                  memory_key_padding_mask=None):
    x = p.ln1(tgt + mha(p.self_attn, tgt, tgt, cfg.num_heads, mask=tgt_mask))
    x = p.ln2(x + mha(p.cross_attn, x, memory, cfg.num_heads, mask=memory_mask,
                      key_padding_mask=memory_key_padding_mask))
    return p.ln3(x + p.fc2(F.relu(p.fc1(x))))


class Decoder(nn.Module):
    def __init__(self, cfg: LSTRConfig, n_layers: int, generator=None):
        super().__init__()
        self.layers = nn.ModuleList(DecoderLayer(cfg, generator) for _ in range(n_layers))
        self.norm = nn.LayerNorm(cfg.d_model, eps=1e-5)


def decoder(p: Decoder, cfg: LSTRConfig, tgt, memory, **kw):
    x = tgt
    for layer in p.layers:
        x = decoder_layer(layer, cfg, x, memory, **kw)
    return p.norm(x)


def _causal_mask(n: int, device) -> torch.Tensor:
    return torch.ones(n, n, dtype=torch.bool, device=device).tril()


def _pos_encoding(d: int, max_len: int) -> torch.Tensor:
    pos = np.arange(max_len)[:, None]
    div = np.exp(np.arange(0, d, 2) * (-math.log(10000.0) / d))
    pe = np.zeros((max_len, d), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return torch.from_numpy(pe)


class LSTR(nn.Module):
    """The detector's parameters (the JAX package's ``init_params`` tree,
    leaf for leaf), fp32 on ``device`` (``cuda`` unless named), drawn from
    ``generator``."""

    def __init__(self, cfg: LSTRConfig, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        d = cfg.d_model
        din = cfg.visual_size + cfg.motion_size
        self.cfg = cfg
        self.feature_head_long = _linear(din, d, g)
        self.feature_head_work = _linear(din, d, g)
        self.enc_query_0 = _queries(cfg.enc_queries_0, d, g)
        self.enc_module_0 = Decoder(cfg, cfg.enc_layers_0, g)
        self.enc_query_1 = _queries(cfg.enc_queries_1, d, g)
        self.enc_module_1 = Decoder(cfg, cfg.enc_layers_1, g)
        self.dec_module = Decoder(cfg, cfg.dec_layers, g)
        self.classifier = _linear(d, cfg.num_classes, g)
        if cfg.future_num_samples > 0:
            self.gen_query = _queries(cfg.gen_queries, d, g)
            self.gen_layer = Decoder(cfg, cfg.gen_layers, g)
            self.final_query = _queries(cfg.fut_queries, d, g)
            self.work_fusions = nn.ModuleList(Decoder(cfg, 1, g) for _ in range(cfg.cci_times))
            self.fut_fusions = nn.ModuleList(Decoder(cfg, 1, g) for _ in range(cfg.cci_times - 1))
        self.register_buffer("pe", _pos_encoding(d, cfg.max_pos), persistent=False)
        self.to(encoder.resolve_device(device))

    @property
    def device(self) -> torch.device:
        return self.pe.device

    def forward(self, visual, motion=None, memory_mask=None) -> Dict[str, torch.Tensor]:
        return forward(self, visual, motion, memory_mask)


def _fuse_features(head: nn.Linear, visual, motion):
    x = visual if motion is None else torch.cat([visual, motion], -1)
    return F.relu(head(x))


def compress_long_memory(model: LSTR, long_visual, long_motion=None, memory_mask=None):
    """Group-wise compression (lstr.py:167-180): ``groups`` segments, each
    cross-attended by ``enc_query_0`` and average-pooled to one token (the
    groups run as one batch), then ``enc_module_1`` with ``enc_query_1``
    -> (B, enc_queries_1, D)."""
    cfg = model.cfg
    b = long_visual.shape[0]
    mem = _fuse_features(model.feature_head_long, long_visual, long_motion)
    g = cfg.groups
    lt = mem.shape[1] // g
    seg = mem[:, :g * lt].reshape(b * g, lt, mem.shape[-1])
    kpm = None if memory_mask is None else memory_mask[:, :g * lt].reshape(b * g, lt)
    q0 = model.enc_query_0[None].expand(b * g, -1, -1)
    out = decoder(model.enc_module_0, cfg, q0, seg, memory_key_padding_mask=kpm)
    pooled = out.mean(1).reshape(b, g, -1)
    q1 = model.enc_query_1[None].expand(b, -1, -1)
    return decoder(model.enc_module_1, cfg, q1, pooled)


def forward(model: LSTR, visual, motion=None, memory_mask=None) -> Dict[str, torch.Tensor]:
    """visual (B, L_long + L_work, visual_size [+ motion_size]), motion
    (B, L, motion_size) or None, memory_mask (B, L_long) True = valid.
    Returns ``logits`` (B, n, C) per work (and anticipation) token and, with
    the future branch, ``future_logits``."""
    cfg = model.cfg
    ln = cfg.long_memory_num_samples
    b = visual.shape[0]
    memory = compress_long_memory(model, visual[:, :ln], None if motion is None else motion[:, :ln],
                                  memory_mask)
    work = _fuse_features(model.feature_head_work, visual[:, ln:],
                          None if motion is None else motion[:, ln:])
    pe = model.pe
    lw = work.shape[1]
    work = work + pe[:lw][None]
    if cfg.anticipation_num_samples > 0 and cfg.future_num_samples > 0:
        ant = model.final_query[:cfg.anticipation_num_samples][None].expand(b, -1, -1)
        work = torch.cat([work, ant + pe[lw:lw + ant.shape[1]][None]], 1)
    n = work.shape[1]
    mask = _causal_mask(n, work.device)
    output = decoder(model.dec_module, cfg, work, memory, tgt_mask=mask)

    result = {}
    if cfg.future_num_samples > 0:  # CCI (lstr.py:122-147)
        future = decoder(model.gen_layer, cfg, model.gen_query[None].expand(b, -1, -1),
                         torch.cat([memory, output], 1))
        fq = model.final_query[None].expand(b, -1, -1)
        lm = memory.shape[1]
        for i in range(cfg.cci_times):
            fusion = model.work_fusions[i]
            ones = torch.ones(n, lm + n + future.shape[1], dtype=torch.bool, device=work.device)
            mm = torch.cat([ones[:, :lm], mask, ones[:, lm + n:]], 1)
            output = decoder_layer(fusion.layers[0], cfg, output,
                                   torch.cat([memory, output, future], 1), tgt_mask=mask,
                                   memory_mask=mm)
            output = fusion.norm(output)
            total = torch.cat([memory, output, future], 1)
            if i == 0:
                future = decoder(model.fut_fusions[i], cfg, fq, total)
            elif i != cfg.cci_times - 1:
                nf = future.shape[1]
                fmask = _causal_mask(nf, work.device)
                fmm = torch.cat([torch.ones(nf, lm + n, dtype=torch.bool, device=work.device),
                                 fmask], 1)
                future = decoder(model.fut_fusions[i], cfg, future, total, tgt_mask=fmask,
                                 memory_mask=fmm)
        result["future_logits"] = model.classifier(future)
    result["logits"] = model.classifier(output)
    return result


class LSTRStream:
    """Online per-frame inference (the reference's
    ``LSTRStream.stream_inference``, lstr.py:255-354).

    The work memory (``work_memory_num_samples`` frames, zero-padded at the
    front until it fills) and the long-memory FIFO live on the model's
    device; a step copies one frame to it. The oldest work frame leaves the
    work memory each step once it is full, and enters the long memory when
    the step count is a multiple of ``long_sample_rate``; only then are the
    compressed tokens recomputed. ``recomputed`` says whether the last step
    did so."""

    def __init__(self, model: LSTR, long_sample_rate: int = 4):
        cfg = model.cfg
        self.model = model
        self.long_sample_rate = long_sample_rate
        din = cfg.visual_size + cfg.motion_size
        dev = model.device
        self._long = torch.zeros(cfg.long_memory_num_samples, din, device=dev)
        self._long_valid = torch.zeros(cfg.long_memory_num_samples, dtype=torch.bool, device=dev)
        self._work = torch.zeros(cfg.work_memory_num_samples, din, device=dev)
        self._mask = _causal_mask(cfg.work_memory_num_samples, dev)
        self._true = torch.ones(1, dtype=torch.bool, device=dev)
        self._compressed = None
        self._steps = 0
        self.recomputed = False

    @property
    def long_memory(self):
        """(features (L_long, D), valid (L_long,)) of the FIFO as it stands."""
        return self._long, self._long_valid

    @torch.no_grad()
    def step(self, feature) -> torch.Tensor:
        """feature: (visual_size + motion_size,) for the new frame, a host
        array or a tensor; returns the newest work token's (num_classes,)
        logits on the model's device."""
        model, cfg = self.model, self.model.cfg
        f = torch.as_tensor(feature, dtype=torch.float32).to(model.device, non_blocking=True)
        if self._steps >= cfg.work_memory_num_samples:  # the oldest work frame graduates
            if self._steps % self.long_sample_rate == 0:
                self._long = torch.cat([self._long[1:], self._work[:1]])
                self._long_valid = torch.cat([self._long_valid[1:], self._true])
                self._compressed = None
        self._work = torch.cat([self._work[1:], f[None]])
        self._steps += 1
        self.recomputed = self._compressed is None
        if self.recomputed:
            vs = cfg.visual_size
            lv = self._long[None]
            self._compressed = compress_long_memory(
                model, lv[..., :vs], lv[..., vs:] if cfg.motion_size else None,
                self._long_valid[None])
        wv = self._work[None]
        w = _fuse_features(model.feature_head_work, wv[..., :cfg.visual_size],
                           wv[..., cfg.visual_size:] if cfg.motion_size else None)
        w = w + model.pe[:w.shape[1]][None]
        out = decoder(model.dec_module, cfg, w, self._compressed, tgt_mask=self._mask)
        return model.classifier(out)[0, -1]
