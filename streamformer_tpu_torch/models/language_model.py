"""The decoder-only language model (Qwen2 / Llama family) for VideoQA.

Port of the JAX package's ``models/language_model.py`` (the reference): RMS
norm, rotary embeddings (HF's rotate-half convention, angles in fp32),
grouped-query attention, a SwiGLU MLP; q/k/v biases for Qwen2
(``attention_bias``), none for Llama; an optional tied ``lm_head``; a
fixed-capacity KV cache for decoding, with one length for all rows
(lockstep) or one per row (ragged, continuous batching).

``LanguageModel`` holds the parameters under the HF state-dict names
(``model.layers.N.self_attn.q_proj.weight``, ...), so an HF Qwen2 / Llama
state dict loads through ``convert_hf_state_dict`` as it is. Matmul weights,
biases and the embedding table are kept in the compute dtype (the JAX
package casts its fp32 tree at each use, which rounds the same way); the
RMS-norm weights stay fp32, as the JAX package applies them in fp32.
``trainable=True`` keeps every parameter as an fp32 master that requires
grad, cast to the compute dtype at each use (VideoQA training). The
functions below take the module where the JAX package takes its parameter
tree. The LM runs no custom kernel: its products are ``F.linear`` and
``torch.bmm``.

Cache planes are flat 3-D ``(B, C, hkv*dh)``, head-major in the last axis;
``cache_dtype="int8"`` stores codes with per-(row, position, kv-head) fp32
scales ``(B, C, hkv)`` (``encoder.quantize_kv``), ``"int4"`` two codes a byte
with the same scales (``quant.quantize_kv4``). ``forward`` writes the new
K/V into the planes IN PLACE (the caller's cache is consumed, as the JAX
package donates it) and returns the cache with its new ``len``.

Tensor parallelism (``parallel.sharding.shard_lm``, the JAX package's LM
rules): each rank holds its query and kv-heads of q/k/v, its columns of
gate/up and the matching inputs of o/down, whose partial sums are reduced
over the model group (their bias added once, after), and its vocab slice of
the embedding table and the head. ``forward`` runs on the rank's heads and
its cache holds the rank's kv-heads (``init_cache(kv_heads=
local_kv_heads(model))``); the int8 and int4 KV scales are per (row,
position, kv-head), so cutting by kv-head keeps them exact. The lookup is
masked to the rank's slice and summed over the group; ``lm_logits`` gathers
the vocab slices (``gather=False`` keeps the rank's, for a reduction such as
``sharding.sharded_argmax``).

The append clamps its start as ``jax.lax.dynamic_update_slice`` does: L new
rows at a start past ``C - L`` land at ``C - L``, never out of bounds, while
the rotary positions and the mask keep the unclamped start. The decode
engine relies on it for idle slots at the capacity edge (their dummy row is
rolled back), and its prefill gives each chunk headroom so that no real
append is ever clamped.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from streamformer_tpu_torch.models import encoder
from streamformer_tpu_torch.ops import quant
from streamformer_tpu_torch.parallel import sharding

Cache = Dict[str, object]

@dataclasses.dataclass(frozen=True)
class LMConfig:
    vocab_size: int = 151936
    hidden_size: int = 3584
    intermediate_size: int = 18944
    num_hidden_layers: int = 28
    num_attention_heads: int = 28
    num_key_value_heads: int = 4
    max_position_embeddings: int = 32768
    rope_theta: float = 1000000.0
    rms_norm_eps: float = 1e-6
    tie_word_embeddings: bool = False
    attention_bias: bool = True  # Qwen2; Llama uses False
    dtype: str = "float32"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    def replace(self, **kw) -> "LMConfig":
        return dataclasses.replace(self, **kw)


class _RMSNorm(nn.Module):
    def __init__(self, d: int, device):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d, device=device))


def _linear(i: int, o: int, bias: bool, dt: torch.dtype, device) -> nn.Linear:
    return torch.nn.utils.skip_init(nn.Linear, i, o, bias=bias, device=device, dtype=dt)


class _Layer(nn.Module):
    def __init__(self, cfg: LMConfig, dt: torch.dtype, device):
        super().__init__()
        d, m = cfg.hidden_size, cfg.intermediate_size
        hq, hkv, dh, b = (cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim,
                          cfg.attention_bias)
        self.input_layernorm = _RMSNorm(d, device)
        self.post_attention_layernorm = _RMSNorm(d, device)
        self.self_attn = encoder._container(q_proj=_linear(d, hq * dh, b, dt, device),
                                    k_proj=_linear(d, hkv * dh, b, dt, device),
                                    v_proj=_linear(d, hkv * dh, b, dt, device),
                                    o_proj=_linear(hq * dh, d, False, dt, device))
        self.mlp = encoder._container(gate_proj=_linear(d, m, False, dt, device),
                              up_proj=_linear(d, m, False, dt, device),
                              down_proj=_linear(m, d, False, dt, device))


def rope_inverse_frequencies(cfg: LMConfig) -> torch.Tensor:
    """The rotary inverse frequencies (head_dim / 2,), fp32, on the host."""
    exps = torch.arange(0, cfg.head_dim, 2, dtype=torch.float32) / cfg.head_dim
    return 1.0 / torch.pow(torch.tensor(cfg.rope_theta, dtype=torch.float32), exps)


class LanguageModel(nn.Module):
    """The LM's parameters under the HF names. ``LanguageModel(cfg)`` lives on
    ``cuda``; ``device="cpu"`` runs on the CPU. Weights are drawn as the JAX
    package's ``init_params`` draws them (normal 0.02 for matrices and the
    embedding table, zero biases, unit norms) from ``generator``, on the
    generator's device; a generator on the card draws a 7B model there
    without a host copy. By default no parameter requires grad and the
    weights are in the compute dtype (the serving LM); ``trainable=True``
    gives fp32 master parameters that require grad."""

    def __init__(self, cfg: LMConfig, *, device=None, generator: Optional[torch.Generator] = None,
                 trainable: bool = False):
        super().__init__()
        dev = encoder.resolve_device(device)
        encoder.compute_dtype(cfg)  # refuses a dtype the port does not run
        dt = torch.float32 if trainable else encoder.compute_dtype(cfg)
        self.cfg = cfg
        d = cfg.hidden_size
        self.model = encoder._container(
            embed_tokens=torch.nn.utils.skip_init(nn.Embedding, cfg.vocab_size, d, device=dev,
                                                  dtype=dt),
            layers=nn.ModuleList(_Layer(cfg, dt, dev) for _ in range(cfg.num_hidden_layers)),
            norm=_RMSNorm(d, dev))
        if not cfg.tie_word_embeddings:
            self.lm_head = _linear(d, cfg.vocab_size, False, dt, dev)
        # the rotary inverse frequencies, fp32, computed on the host once (a
        # host scalar sent to the card each step would synchronise the stream)
        self.register_buffer("rope_inv", rope_inverse_frequencies(cfg).to(dev), persistent=False)
        # the model group this LM is sharded over (parallel.sharding.shard_lm)
        self.parallel = None
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith("bias"):
                    p.zero_()
                elif p.ndim == 2:
                    p.normal_(0.0, 0.02, generator=generator)
        self.requires_grad_(trainable)

    @property
    def device(self) -> torch.device:
        return self.model.norm.weight.device


# --------------------------------------------------------------------------
# Building blocks
# --------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = encoder.cast(x, torch.float32)
    x32 = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return encoder.cast(x32 * w, x.dtype)


def _rope_angles(positions: torch.Tensor, inv: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos and sin (B, L, 1, dh/2) of the rotary angles at positions (B, L),
    in fp32; one pair serves every layer's q and k."""
    ang = positions[..., None].float() * inv  # (B, L, dh/2)
    return torch.cos(ang)[:, :, None], torch.sin(ang)[:, :, None]


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """HF rotary embedding (rotate-half, non-interleaved) of x (B, L, H, dh)."""
    dh = x.shape[-1]
    x1, x2 = x[..., : dh // 2], x[..., dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _out_features(lin: nn.Module) -> int:
    return lin.weight.shape[0]


def local_kv_heads(model: LanguageModel) -> int:
    """The kv-heads this rank holds (all of them in one process)."""
    return _out_features(model.model.layers[0].self_attn.k_proj) // model.cfg.head_dim


def _vocab_slice(model: LanguageModel, weight: torch.Tensor):
    """``(offset, rows)`` of this rank's vocab slice of a table or head of
    ``weight``'s rows; None when it holds the whole vocab."""
    if model.parallel is None or weight.shape[0] == model.cfg.vocab_size:
        return None
    return model.parallel.rank * weight.shape[0], weight.shape[0]


def vocab_shard(model: LanguageModel):
    """``(TensorParallel, offset)`` of a vocab-sharded head: the group, and
    the global index of this rank's first vocab row of its logits
    (``lm_logits(..., gather=False)``); ``(None, 0)`` for the whole vocab."""
    head = model.model.embed_tokens if model.cfg.tie_word_embeddings else model.lm_head
    cut = _vocab_slice(model, head.weight)
    return (None, 0) if cut is None else (model.parallel, cut[0])


def _dense(x: torch.Tensor, lin: nn.Module) -> torch.Tensor:
    """``x @ W.T`` then ``+ b`` in x's dtype (the JAX package's two roundings),
    or the int8 product for an ``Int8Linear`` (weights-bandwidth-bound decode:
    int8 weights are its 2x lever)."""
    if isinstance(lin, quant.Int8Linear):
        return quant.int8_linear(x, lin.weight, lin.weight_scale, lin.bias)
    y = F.linear(x, encoder.cast(lin.weight, x.dtype))
    if lin.bias is not None:
        y = y + encoder.cast(lin.bias, x.dtype)
    return y


class _Scores(torch.autograd.Function):
    """The card's ``torch.bmm(q, k_t, out_dtype=torch.float32)`` with a
    backward (the overload has none): the fp32 score gradient goes through
    two fp32 products, and each input gradient is rounded once to its
    input's dtype. Training's q and k_t are one sequence's, not a cache."""

    @staticmethod
    def forward(ctx, q, k_t):
        ctx.save_for_backward(q, k_t)
        return torch.bmm(q, k_t, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        q, k_t = ctx.saved_tensors
        dq = torch.bmm(g, k_t.float().transpose(1, 2)).to(q.dtype)
        dk_t = torch.bmm(q.float().transpose(1, 2), g).to(k_t.dtype)
        return dq, dk_t


def _scores(q: torch.Tensor, k_t: torch.Tensor) -> torch.Tensor:
    """fp32 ``q @ k_t`` over batched matrices, the JAX einsum's
    ``preferred_element_type=float32``. On the card a bf16 product writes its
    fp32 accumulators as they are (``out_dtype``), so the cache is read in
    its own dtype, never copied to fp32; the CPU has no such overload. When
    a gradient is asked for, ``_Scores`` gives that product a backward."""
    if q.dtype == torch.float32:
        return torch.bmm(q, k_t)
    if q.is_cuda:
        if torch.is_grad_enabled() and (q.requires_grad or k_t.requires_grad):
            return _Scores.apply(q, k_t)
        return torch.bmm(q, k_t, out_dtype=torch.float32)
    return torch.bmm(q.float(), k_t.float())


# --------------------------------------------------------------------------
# The KV cache
# --------------------------------------------------------------------------


def init_cache(cfg: LMConfig, batch: int, capacity: int, per_stream_len: bool = False,
               cache_dtype: Optional[str] = None, device=None,
               kv_heads: Optional[int] = None) -> Cache:
    """A fixed-capacity cache of flat ``(B, C, hkv*dh)`` planes a layer.
    ``per_stream_len=True`` makes ``len`` (B,), each row decoding at its own
    position (ragged); otherwise ``len`` is a 0-d tensor. ``cache_dtype``
    "int8" stores codes with (B, C, hkv) fp32 scales, "int4" packs two codes
    a byte (a quarter of bf16's bytes). ``kv_heads`` (default all) is the
    kv-heads a rank of a model cut by ``sharding.shard_lm`` holds
    (``local_kv_heads``)."""
    dev = encoder.resolve_device(device)
    hkv, dh = kv_heads or cfg.num_key_value_heads, cfg.head_dim
    ln = torch.zeros((batch,) if per_stream_len else (), dtype=torch.int64, device=dev)
    if cache_dtype in ("int8", "int4"):
        if cache_dtype == "int4" and dh % 2:
            raise ValueError(f"int4 KV nibble-packs pairs: head_dim must be even, got {dh}")
        qdh = dh if cache_dtype == "int8" else dh // 2

        def layer():
            return {"k": torch.zeros(batch, capacity, hkv * qdh, dtype=torch.int8, device=dev),
                    "v": torch.zeros(batch, capacity, hkv * qdh, dtype=torch.int8, device=dev),
                    "k_scale": torch.zeros(batch, capacity, hkv, device=dev),
                    "v_scale": torch.zeros(batch, capacity, hkv, device=dev)}
    elif cache_dtype is None:
        dt = encoder.compute_dtype(cfg)

        def layer():
            return {kv: torch.zeros(batch, capacity, hkv * dh, dtype=dt, device=dev)
                    for kv in ("k", "v")}
    else:
        raise ValueError(f"cache_dtype {cache_dtype!r}: None, 'int8' or 'int4'")
    return {"layers": [layer() for _ in range(cfg.num_hidden_layers)], "len": ln}


def reset_streams(cache: Cache, done: torch.Tensor) -> Cache:
    """Re-admit the rows ``done`` of a ragged cache (``len`` -> 0). Stale K/V
    needs no clearing: every mask excludes positions >= len."""
    ln = cache["len"]
    if ln.ndim != 1:
        raise ValueError("reset_streams needs init_cache(per_stream_len=True)")
    return {**cache, "len": torch.where(done, torch.zeros_like(ln), ln)}


def _append(plane: torch.Tensor, new: torch.Tensor, start: torch.Tensor) -> None:
    """Write new (B, L, ...) into plane (B, C, ...) at each row's ``start``
    (B,), in place, the start clamped to [0, C - L] as
    ``dynamic_update_slice`` clamps it."""
    b, l = new.shape[:2]
    cap = plane.shape[1]
    s = start.clamp(0, cap - l)
    idx = (s[:, None] + torch.arange(l, device=plane.device))  # (B, L)
    idx = idx.reshape(b, l, *([1] * (plane.ndim - 2))).expand(new.shape)
    plane.scatter_(1, idx, new)


# --------------------------------------------------------------------------
# The forward
# --------------------------------------------------------------------------


def forward(model: LanguageModel, inputs_embeds: torch.Tensor,
            attention_mask: Optional[torch.Tensor] = None, cache: Optional[Cache] = None,
            logits: bool = True) -> Tuple[Dict[str, Optional[torch.Tensor]], Optional[Cache]]:
    """Causal decoder forward over (B, L, D) embeddings. With ``cache`` the L
    new positions append at ``cache["len"]`` (per row when it is (B,)) and
    ``attention_mask`` (B, L_total), 1 = valid, covers cached and new
    positions. Returns ({"logits" (fp32), "last_hidden_state"}, new cache).
    ``logits=False`` skips the vocab head (a prefill chunk needs one row of
    it: ``lm_logits`` on that row)."""
    cfg = model.cfg
    dt = encoder.compute_dtype(cfg)
    b, l, _ = inputs_embeds.shape
    dev = inputs_embeds.device
    x = inputs_embeds.to(dt)
    dh = cfg.head_dim
    attn0 = model.model.layers[0].self_attn
    # this rank's query and kv-heads (all of them in one process)
    hq, hkv = _out_features(attn0.q_proj) // dh, _out_features(attn0.k_proj) // dh
    rep = hq // hkv
    if cache is not None:
        start = cache["len"]
        start_b = start if start.ndim == 1 else start.expand(b)
    else:
        start_b = torch.zeros(b, dtype=torch.int64, device=dev)
    positions = start_b[:, None] + torch.arange(l, device=dev)[None]  # (B, L)
    cos, sin = _rope_angles(positions, model.rope_inv)

    if cache is not None:
        kl = cache["layers"][0]["k"].shape[1]
        kpos = torch.arange(kl, device=dev)
        # each row causal at its own depth; rows past a stream's frontier are
        # excluded until overwritten
        mask = kpos[None, None] <= positions[:, :, None]  # (B, L, kl)
    else:
        kl = l
        mask = torch.ones(l, l, dtype=torch.bool, device=dev).tril()[None].expand(b, l, l)
    if attention_mask is not None:
        mask = mask & attention_mask[:, None, :kl].bool()
    masked = ~mask[:, :, None]  # (B, L, 1, kl) against the (B, L, rep, kl) scores

    new_layers = []
    for i, lp in enumerate(model.model.layers):
        attn = lp.self_attn
        h = rms_norm(x, lp.input_layernorm.weight, cfg.rms_norm_eps)
        q = _rope(_dense(h, attn.q_proj).reshape(b, l, hq, dh), cos, sin)
        k = _rope(_dense(h, attn.k_proj).reshape(b, l, hkv, dh), cos, sin)
        v = _dense(h, attn.v_proj).reshape(b, l, hkv, dh)
        if cache is not None:
            lay = cache["layers"][i]
            if "k_scale" in lay:
                int4 = lay["k"].shape[-1] == hkv * (dh // 2)
                quantize = quant.quantize_kv4 if int4 else encoder.quantize_kv
                dequantize = quant.dequantize_kv4 if int4 else encoder.dequantize_kv
                qdh = dh // 2 if int4 else dh
                for name, val in (("k", k), ("v", v)):
                    codes, scale = quantize(val)  # (B, l, hkv) scales over dh
                    _append(lay[name], codes.reshape(b, l, hkv * qdh), start_b)
                    _append(lay[name + "_scale"], scale, start_b)
                k_att = dequantize(lay["k"].view(b, kl, hkv, qdh), lay["k_scale"], dt)
                v_att = dequantize(lay["v"].view(b, kl, hkv, qdh), lay["v_scale"], dt)
            else:
                _append(lay["k"], k.to(dt).reshape(b, l, hkv * dh), start_b)
                _append(lay["v"], v.to(dt).reshape(b, l, hkv * dh), start_b)
                k_att, v_att = lay["k"].view(b, kl, hkv, dh), lay["v"].view(b, kl, hkv, dh)
            new_layers.append(lay)
        else:
            k_att, v_att = k, v

        # grouped-query attention without repeating K/V: the rep query heads
        # of a kv-head read its (B, kl, dh) slice of the cache in place
        qg = q.reshape(b, l, hkv, rep, dh)
        ctx = []
        for g in range(hkv):
            s = _scores(qg[:, :, g].reshape(b, l * rep, dh), k_att[:, :, g].transpose(1, 2))
            s = (s * dh**-0.5).view(b, l, rep, kl)
            s = s.masked_fill(masked, -1e30)
            p = torch.softmax(s, dim=-1).to(dt).view(b, l * rep, kl)
            ctx.append(torch.bmm(p, v_att[:, :, g].to(dt)).view(b, l, rep, dh))
        ctx = torch.stack(ctx, dim=2).reshape(b, l, hq * dh)
        x = x + _row_parallel(model, ctx, attn.o_proj, cfg.num_attention_heads * dh)

        h = rms_norm(x, lp.post_attention_layernorm.weight, cfg.rms_norm_eps)
        gate = F.silu(_dense(h, lp.mlp.gate_proj))
        x = x + _row_parallel(model, gate * _dense(h, lp.mlp.up_proj), lp.mlp.down_proj,
                              cfg.intermediate_size)

    x = rms_norm(x, model.model.norm.weight, cfg.rms_norm_eps)
    out = {"logits": lm_logits(model, x) if logits else None, "last_hidden_state": x}
    new_cache = None
    if cache is not None:
        new_cache = {"layers": new_layers, "len": cache["len"] + l}
    return out, new_cache


def _row_parallel(model: LanguageModel, x: torch.Tensor, lin: nn.Module,
                  full_in: int) -> torch.Tensor:
    """o_proj or down_proj: ``_dense`` in one process (or on a replicated
    layer); under tensor parallelism the product of this rank's input
    columns (fp32 partial sums, ``sharding.partial_product``), reduced over
    the model group, then the bias, rounded to x's dtype."""
    if model.parallel is None or isinstance(lin, quant.Int8Linear) or \
            lin.weight.shape[1] == full_in:
        return _dense(x, lin)
    y = sharding.all_reduce(sharding.partial_product(x, encoder.cast(lin.weight, x.dtype)),
                            model.parallel.group)
    return encoder.cast(y if lin.bias is None else y + encoder.cast(lin.bias, y.dtype), x.dtype)


def embed_tokens(model: LanguageModel, ids: torch.Tensor) -> torch.Tensor:
    """The table's rows of ``ids``; a vocab-sharded table looks up the ids in
    this rank's slice (zeros elsewhere) and sums the ranks' lookups (one
    nonzero term a row: exact)."""
    ids = ids.to(model.device)
    table = model.model.embed_tokens.weight
    cut = _vocab_slice(model, table)
    if cut is None:
        return F.embedding(ids, table)
    lo, rows = cut
    mine = (ids >= lo) & (ids < lo + rows)
    local = F.embedding((ids - lo).clamp(0, rows - 1), table)
    local = torch.where(mine[..., None], local, torch.zeros((), dtype=local.dtype,
                                                            device=local.device))
    return sharding.all_reduce(local, model.parallel.group)


def lm_logits(model: LanguageModel, x: torch.Tensor, gather: bool = True) -> torch.Tensor:
    """The vocab head over final-norm hidden states (..., D) -> fp32 (..., V):
    tied to the embedding table, the untied ``lm_head``, or its int8 form.
    A vocab-sharded head gives this rank's slice, gathered over the model
    group into the whole vocab unless ``gather`` is False (then (..., V /
    mp) from ``vocab_shard(model)``'s offset on)."""
    if model.cfg.tie_word_embeddings:
        w = model.model.embed_tokens.weight
    elif isinstance(model.lm_head, quant.Int8Linear):
        return _dense(x, model.lm_head).float()
    else:
        w = model.lm_head.weight
    out = F.linear(x, encoder.cast(w, x.dtype)).float()
    if gather and _vocab_slice(model, w) is not None:
        out = sharding.all_gather(out, model.parallel.group, dim=-1)
    return out


def lm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Next-token cross-entropy, ignore_index -100 (HF Trainer semantics); 0
    when every label is ignored."""
    shift_logits = logits[:, :-1].float()
    shift_labels = labels[:, 1:].to(logits.device)
    valid = shift_labels != -100
    safe = torch.where(valid, shift_labels, torch.zeros_like(shift_labels))
    logp = torch.log_softmax(shift_logits, dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    return (nll * valid).sum() / valid.sum().clamp_min(1)


@torch.no_grad()
def greedy_generate(model: LanguageModel, inputs_embeds: torch.Tensor, max_new_tokens: int,
                    attention_mask: Optional[torch.Tensor] = None,
                    eos_token_id: Optional[int] = None,
                    capacity: Optional[int] = None) -> np.ndarray:
    """Greedy decoding on the fixed-capacity cache: (B, <= max_new_tokens)
    int64 token ids, stopped once every row's last token is EOS. A
    right-padded row continues at its last valid position + 1 (HF's
    positions from the mask): after the prefill the cache switches to
    per-row lengths, and the mask keeps the pads out until overwritten."""
    dev = model.device
    emb = inputs_embeds.to(dev)
    b, l, _ = emb.shape
    cap = capacity or (l + max_new_tokens)
    cache = init_cache(model.cfg, b, cap, device=dev)
    if attention_mask is None:
        attention_mask = torch.ones(b, l, dtype=torch.int64, device=dev)
    attention_mask = attention_mask.to(dev, torch.int64)
    am = torch.zeros(b, cap, dtype=torch.int64, device=dev)
    am[:, :l] = attention_mask
    out, cache = forward(model, emb, attention_mask=am, cache=cache)
    last = attention_mask.sum(1) - 1
    tok = out["logits"][torch.arange(b, device=dev), last].argmax(-1)
    cache["len"] = last + 1
    rows = torch.arange(b, device=dev)
    toks = [tok.cpu().numpy()]
    for _ in range(1, max_new_tokens):
        pos = cache["len"]
        # positions past the capacity are dropped, as a JAX scatter drops them
        am[rows, pos.clamp(max=cap - 1)] |= (pos < cap).long()
        out, cache = forward(model, embed_tokens(model, tok)[:, None], attention_mask=am,
                             cache=cache)
        tok = out["logits"][:, -1].argmax(-1)
        toks.append(tok.cpu().numpy())
        if eos_token_id is not None and bool(np.all(toks[-1] == eos_token_id)):
            break
    return np.stack(toks, axis=1)


# --------------------------------------------------------------------------
# HF weight import (Qwen2 / Llama names)
# --------------------------------------------------------------------------


def convert_hf_state_dict(sd: Mapping[str, object], cfg: LMConfig) -> Dict[str, torch.Tensor]:
    """An HF Qwen2 / Llama state dict (tensors or numpy arrays) -> the state
    dict of ``LanguageModel(cfg)``: the same names, torch's (out, in)
    layout; q/k/v biases only with ``attention_bias``, no ``lm_head`` when
    tied."""

    def t(name):
        return torch.as_tensor(np.asarray(sd[name]) if not torch.is_tensor(sd[name]) else sd[name])

    out = {"model.embed_tokens.weight": t("model.embed_tokens.weight"),
           "model.norm.weight": t("model.norm.weight")}
    for i in range(cfg.num_hidden_layers):
        pre = f"model.layers.{i}"
        for name in ("input_layernorm.weight", "post_attention_layernorm.weight",
                     "self_attn.o_proj.weight", "mlp.gate_proj.weight", "mlp.up_proj.weight",
                     "mlp.down_proj.weight"):
            out[f"{pre}.{name}"] = t(f"{pre}.{name}")
        for proj in ("q_proj", "k_proj", "v_proj"):
            out[f"{pre}.self_attn.{proj}.weight"] = t(f"{pre}.self_attn.{proj}.weight")
            if cfg.attention_bias:
                out[f"{pre}.self_attn.{proj}.bias"] = t(f"{pre}.self_attn.{proj}.bias")
    if not cfg.tie_word_embeddings:
        out["lm_head.weight"] = t("lm_head.weight")
    return out
