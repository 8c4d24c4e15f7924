"""The StreamFormer encoder on PyTorch: full-clip and streaming paths.

Port of the JAX package's ``models/encoder.py`` (the reference). The
backbone is a causal divided space-time TimeSformer-SigLIP: per layer a
temporal attention over frames behind a tanh gate, a spatial attention over
patches, and an MLP; a MAP head pools each frame's patches.

Layouts follow the JAX package at every public function: activations are
``(B, T, N, D)`` (batch, frames, patches, hidden); the streaming cache holds
one pos-major ``(C, B*N, D)`` K and V per layer plus a ``len`` tensor. The
attention runs through ``ops.attention``: the CUDA kernels on the card, their
plain versions on the CPU.

``StreamformerEncoder`` owns the parameters, under the reference
checkpoint's state-dict names, so ``load_state_dict`` takes a reference
(HF) state dict as it is. Matmul weights are kept in the compute dtype
(``cfg.dtype``); LayerNorm parameters and the temporal gates stay fp32,
because the JAX package applies them in fp32. The functions below take the
module where the JAX package takes its parameter tree.

Inference only: dropout and drop-path are not applied, and the kernels have
no backward yet.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from streamformer_tpu_torch.config import StreamformerConfig
from streamformer_tpu_torch.ops import attention as ops

Cache = Dict[str, object]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(cfg: StreamformerConfig) -> torch.dtype:
    if cfg.dtype not in _DTYPES:
        raise NotImplementedError(f"compute dtype {cfg.dtype!r}: the port runs float32 or bfloat16")
    return _DTYPES[cfg.dtype]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Asking for CUDA without a card raises; nothing moves to the CPU
    on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels"
        )
    return dev


# --------------------------------------------------------------------------
# Small building blocks
# --------------------------------------------------------------------------


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm, eps: float) -> torch.Tensor:
    """LayerNorm over the last axis, computed in fp32, cast back."""
    y = F.layer_norm(x.float(), x.shape[-1:], ln.weight.float(), ln.bias.float(), eps)
    return y.to(x.dtype)


def dense(
    x: torch.Tensor, lin: nn.Linear, lora: Optional[Tuple[nn.Linear, nn.Linear]] = None
) -> torch.Tensor:
    """Affine map with the optional LoRA delta ``y = W x + b + B(A x)``
    (the reference's convention: no extra scaling)."""
    dt = x.dtype
    bias = None if lin.bias is None else lin.bias.to(dt)
    y = F.linear(x, lin.weight.to(dt), bias)
    if lora is not None:
        a, b = lora
        y = y + F.linear(F.linear(x, a.weight.to(dt)), b.weight.to(dt))
    return y


def act_fn(x: torch.Tensor, name: str = "gelu") -> torch.Tensor:
    """HF ACT2FN subset used by the MAP head: "gelu" is the exact erf GELU,
    "gelu_pytorch_tanh"/"gelu_new"/"gelu_fast" the tanh approximation."""
    if name in ("gelu_pytorch_tanh", "gelu_new", "gelu_fast"):
        return F.gelu(x, approximate="tanh")
    if name == "relu":
        return F.relu(x)
    return F.gelu(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The MLP's GELU: tanh-approximate under bf16, exact erf under fp32
    (the JAX package's choice; the two differ below bf16 resolution)."""
    return F.gelu(x, approximate="tanh" if x.dtype == torch.bfloat16 else "none")


def _lora(parent: nn.Module, name: str) -> Optional[Tuple[nn.Linear, nn.Linear]]:
    a = getattr(parent, f"{name}_lora_a", None)
    return None if a is None else (a, getattr(parent, f"{name}_lora_b"))


# --------------------------------------------------------------------------
# Modules: parameter containers named as the reference state dict
# --------------------------------------------------------------------------


def _container(**children: nn.Module) -> nn.Module:
    m = nn.Module()
    for name, child in children.items():
        setattr(m, name, child)
    return m


def _attention(cfg: StreamformerConfig, dt: torch.dtype, lora: bool) -> nn.Module:
    """``attention.qkv`` (fused [q, k, v] rows) and ``output.dense``, with the
    reference's ``<name>_lora_a``/``<name>_lora_b`` siblings when asked."""
    d = cfg.hidden_size
    inner = _container(qkv=nn.Linear(d, 3 * d, bias=cfg.qkv_bias, dtype=dt))
    out = _container(dense=nn.Linear(d, d, dtype=dt))
    if lora:
        r = cfg.lora_rank
        inner.qkv_lora_a = nn.Linear(d, r, bias=False, dtype=dt)
        inner.qkv_lora_b = nn.Linear(r, 3 * d, bias=False, dtype=dt)
        out.dense_lora_a = nn.Linear(d, r, bias=False, dtype=dt)
        out.dense_lora_b = nn.Linear(r, d, bias=False, dtype=dt)
    return _container(attention=inner, output=out)


class _Layer(nn.Module):
    """One divided space-time block (reference TimesformerLayerSigLIP)."""

    def __init__(self, cfg: StreamformerConfig, dt: torch.dtype):
        super().__init__()
        d, m, eps = cfg.hidden_size, cfg.intermediate_size, cfg.layer_norm_eps
        self.layernorm_before = nn.LayerNorm(d, eps=eps)
        self.layernorm_after = nn.LayerNorm(d, eps=eps)
        self.attention = _attention(cfg, dt, cfg.add_lora_spatial)
        self.intermediate = _container(dense=nn.Linear(d, m, dtype=dt))
        self.output = _container(dense=nn.Linear(m, d, dtype=dt))
        self.temporal_layernorm = nn.LayerNorm(d, eps=eps)
        self.temporal_attention = _attention(cfg, dt, lora=False)
        self.temporal_dense = nn.Linear(d, d, dtype=dt)
        self.temporal_attention_gating = nn.Parameter(torch.zeros(()))


class StreamformerEncoder(nn.Module):
    """The encoder's parameters, and its full-clip and streaming entry points.

    ``StreamformerEncoder(cfg)`` lives on ``cuda``; ``device="cpu"`` runs the
    plain paths. Weights are initialised as the JAX package's
    ``init_params`` does (truncated normal 0.02 for projections, zero
    biases, embeddings and gates, a normal MAP probe) from ``generator``, or
    from a fresh default generator.
    """

    def __init__(self, cfg: StreamformerConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_supported(cfg)
        dev = resolve_device(device)
        dt = compute_dtype(cfg)
        d, c, ps = cfg.hidden_size, cfg.num_channels, cfg.patch_size
        self.cfg = cfg
        self.embeddings = _container(
            patch_embeddings=_container(
                projection=nn.Conv2d(c, d, ps, stride=ps, dtype=dt)
            ),
        )
        self.embeddings.position_embeddings = nn.Parameter(
            torch.zeros(1, cfg.num_patches, d, dtype=dt)
        )
        self.embeddings.time_embeddings = nn.Parameter(
            torch.zeros(1, cfg.num_frames, d, dtype=dt)
        )
        self.encoder = _container(
            layer=nn.ModuleList(_Layer(cfg, dt) for _ in range(cfg.num_hidden_layers))
        )
        self.post_layernorm = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        head_attn = _container(out_proj=nn.Linear(d, d, dtype=dt))
        head_attn.in_proj_weight = nn.Parameter(torch.empty(3 * d, d, dtype=dt))
        head_attn.in_proj_bias = nn.Parameter(torch.zeros(3 * d, dtype=dt))
        self.head = _container(
            attention=head_attn,
            layernorm=nn.LayerNorm(d, eps=cfg.layer_norm_eps),
            mlp=_container(
                fc1=nn.Linear(d, cfg.intermediate_size, dtype=dt),
                fc2=nn.Linear(cfg.intermediate_size, d, dtype=dt),
            ),
        )
        self.head.probe = nn.Parameter(torch.empty(1, 1, d, dtype=dt))
        self._init_weights(generator)
        self.to(dev)

    @torch.no_grad()
    def _init_weights(self, generator: Optional[torch.Generator]) -> None:
        std = 0.02
        for name, p in self.named_parameters():
            draw = torch.empty(p.shape)  # fp32, then rounded to the parameter's dtype
            if name.endswith("_lora_a.weight"):
                draw.normal_(0.0, std, generator=generator)
            elif name.endswith("_lora_b.weight") or name.endswith("bias"):
                draw.zero_()
            elif name == "head.probe":
                draw.normal_(0.0, 1.0, generator=generator)
            elif name.endswith("embeddings") or name.endswith("gating"):
                draw.zero_()
            elif "layernorm" in name:
                draw.fill_(1.0)
            else:  # projection weights, head in_proj
                nn.init.trunc_normal_(draw, 0.0, std, -2 * std, 2 * std, generator=generator)
            p.copy_(draw)

    @property
    def device(self) -> torch.device:
        return self.post_layernorm.weight.device

    def forward(self, pixel_values: torch.Tensor) -> Dict[str, torch.Tensor]:
        return model_forward(self, pixel_values)

    def init_cache(self, batch: int, capacity: Optional[int] = None) -> Cache:
        return init_cache(self.cfg, batch, capacity=capacity, device=self.device)

    def stream(self, frame: torch.Tensor, cache: Cache) -> Tuple[Dict[str, torch.Tensor], Cache]:
        return streaming_forward(self, frame, cache)


def _check_supported(cfg: StreamformerConfig) -> None:
    compute_dtype(cfg)
    if cfg.attention_type != "divided_space_time":
        raise NotImplementedError(
            f"attention_type {cfg.attention_type!r}: the port runs divided space-time "
            "(ROADMAP slice 1, item 3a)"
        )
    if not cfg.enable_causal_temporal:
        raise NotImplementedError(
            "non-causal temporal attention (ROADMAP slice 1, item 3a)"
        )


# --------------------------------------------------------------------------
# Embeddings
# --------------------------------------------------------------------------


def time_embeddings_for_positions(
    time_emb: torch.Tensor, start, t_new: int, total: int
) -> torch.Tensor:
    """Time embeddings (t_new, D) for absolute frame positions
    [start, start + t_new).

    When ``total`` exceeds the trained positions the table is
    nearest-interpolated to ``total`` (output i takes input
    floor(i * T_trained / total), torch's 'nearest'); positions past the
    table are clamped to its last row. ``start`` may be an int or a device
    tensor of one element (read on the device)."""
    t_trained = time_emb.shape[0]
    dev = time_emb.device
    table = time_emb
    if total > t_trained:
        table = time_emb[(torch.arange(total, device=dev) * t_trained) // total]
    start = torch.as_tensor(start, device=dev)
    if start.ndim:
        raise NotImplementedError("per-stream start positions (ROADMAP slice 2, item 4)")
    pos = (start + torch.arange(t_new, device=dev)).clamp(0, table.shape[0] - 1)
    return table.index_select(0, pos)


def embed(
    model: StreamformerEncoder,
    pixel_values: torch.Tensor,
    *,
    start_pos=0,
    total_frames: Optional[int] = None,
) -> torch.Tensor:
    """Patchify + position + time embeddings: (B, T, C, H, W) -> (B, T, N, D).

    The stride-p conv is run as one matmul on non-overlapping patches,
    flattened in (C, ph, pw) order as the conv weight is."""
    cfg = model.cfg
    dt = compute_dtype(cfg)
    b, t, c, h, w = pixel_values.shape
    ps = cfg.patch_size
    if h % ps or w % ps:
        raise ValueError(f"frame size {h}x{w} is not a multiple of the patch size {ps}")
    hp, wp = h // ps, w // ps
    if (hp, wp) != (cfg.patches_per_side, cfg.patches_per_side):
        raise NotImplementedError(
            f"resolution {h}x{w} differs from the trained {cfg.image_size}: "
            "position-embedding resize (ROADMAP slice 1, item 3a)"
        )
    n, d = hp * wp, cfg.hidden_size
    emb = model.embeddings
    x = pixel_values.to(device=model.device, dtype=dt)
    x = x.reshape(b * t, c, hp, ps, wp, ps).permute(0, 2, 4, 1, 3, 5)
    x = x.reshape(b * t, n, c * ps * ps)
    proj = emb.patch_embeddings.projection
    x = F.linear(x, proj.weight.to(dt).reshape(d, c * ps * ps), proj.bias.to(dt))
    x = x.reshape(b, t, n, d) + emb.position_embeddings.to(dt)
    total = total_frames if total_frames is not None else t
    temb = time_embeddings_for_positions(emb.time_embeddings[0], start_pos, t, total)
    return x + temb.to(dt)[None, :, None, :]


# --------------------------------------------------------------------------
# Attention
# --------------------------------------------------------------------------


def spatial_attention(x: torch.Tensor, attn: nn.Module, cfg: StreamformerConfig) -> torch.Tensor:
    """Softmax attention over the patches N, batched over (B, T);
    x: (B, T, N, D). Runs ``ops.spatial_flat`` on flat-D rows."""
    b, t, n, d = x.shape
    qkv = dense(x, attn.attention.qkv, _lora(attn.attention, "qkv"))  # (B, T, N, 3D)

    def rows(i):
        return qkv[..., i * d:(i + 1) * d].reshape(b * t, n, d).contiguous()

    ctx = ops.spatial_flat(rows(0), rows(1), rows(2), cfg.num_attention_heads)
    return dense(ctx.reshape(b, t, n, d), attn.output.dense, _lora(attn.output, "dense"))


def temporal_attention(
    x: torch.Tensor,
    attn: nn.Module,
    cfg: StreamformerConfig,
    *,
    cache_kv: Optional[Dict[str, torch.Tensor]] = None,
    cache_len: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Causal attention over the frames T, batched over (B, N); x: (B, T, N, D).

    Full clip (``cache_kv`` None): ``ops.temporal_fullclip`` on (B*N, T, D)
    rows, query t attending frames 0..t.

    Streaming (t = 1): ``ops.temporal_decode_pm`` attends the new frame to
    the cache and writes its K/V IN PLACE into ``cache_kv["k"]`` and
    ``cache_kv["v"]`` at slot ``cache_len % C``. ``cache_len`` is not
    advanced here. The same call serves the linear cache and the ring.
    """
    b, t, n, d = x.shape
    h = cfg.num_attention_heads
    qkv = dense(x, attn.attention.qkv)  # (B, T, N, 3D)
    if cache_kv is None:
        def rows(i):  # (B, T, N, D) slice -> (B*N, T, D)
            return qkv[..., i * d:(i + 1) * d].transpose(1, 2).reshape(b * n, t, d).contiguous()

        ctx = ops.temporal_fullclip(rows(0), rows(1), rows(2), h)
        ctx = ctx.reshape(b, n, t, d).transpose(1, 2)
        return dense(ctx, attn.output.dense)
    if t != 1:
        raise NotImplementedError("multi-frame streaming appends (ROADMAP slice 2, item 4)")

    def rows1(i):  # (B, 1, N, D) slice -> (B*N, D)
        return qkv[..., i * d:(i + 1) * d].reshape(b * n, d).contiguous()

    ctx = ops.temporal_decode_pm(
        rows1(0), rows1(1), rows1(2), cache_kv["k"], cache_kv["v"], cache_len, h
    )
    return dense(ctx.reshape(b, 1, n, d), attn.output.dense)


# --------------------------------------------------------------------------
# Transformer layer, MAP head, full model
# --------------------------------------------------------------------------


def layer_forward(
    layer: _Layer,
    x: torch.Tensor,
    cfg: StreamformerConfig,
    *,
    cache_kv: Optional[Dict[str, torch.Tensor]] = None,
    cache_len: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One divided space-time block on (B, T, N, D): temporal LN ->
    causal temporal attention -> ``temporal_dense`` -> residual scaled by
    tanh(gate); LN -> spatial attention -> residual; LN -> MLP -> residual.
    With ``cache_kv`` the layer's cache is updated in place."""
    eps = cfg.layer_norm_eps
    t_ln = layer_norm(x, layer.temporal_layernorm, eps)
    t_attn = temporal_attention(
        t_ln, layer.temporal_attention, cfg, cache_kv=cache_kv, cache_len=cache_len
    )
    gate = torch.tanh(layer.temporal_attention_gating.float()).to(x.dtype)
    x = x + gate * dense(t_attn, layer.temporal_dense)
    x = x + spatial_attention(layer_norm(x, layer.layernorm_before, eps), layer.attention, cfg)
    m = dense(layer_norm(x, layer.layernorm_after, eps), layer.intermediate.dense)
    return x + dense(gelu(m), layer.output.dense)


def map_pool(x: torch.Tensor, head: nn.Module, cfg: StreamformerConfig) -> torch.Tensor:
    """SigLIP multihead-attention pooling of each frame's patches:
    (B, T, N, D) -> (B, T, D). A learned probe attends over the N patches
    (torch nn.MultiheadAttention semantics), then LN + MLP residual."""
    b, t, n, d = x.shape
    h = cfg.num_attention_heads
    dh = d // h
    dt = x.dtype
    attn = head.attention
    w_q, w_k, w_v = attn.in_proj_weight.to(dt).split(d)
    b_q, b_k, b_v = attn.in_proj_bias.to(dt).split(d)
    q = F.linear(head.probe.reshape(1, d).to(dt), w_q, b_q).reshape(h, dh)
    k = F.linear(x, w_k, b_k).reshape(b, t, n, h, dh)
    v = F.linear(x, w_v, b_v).reshape(b, t, n, h, dh)
    scores = torch.einsum("hd,btnhd->bthn", q.float(), k.float()) * dh**-0.5
    probs = torch.softmax(scores, dim=-1).to(dt)
    ctx = torch.einsum("bthn,btnhd->bthd", probs.float(), v.float()).to(dt).reshape(b, t, d)
    pooled = dense(ctx, attn.out_proj)
    y = dense(layer_norm(pooled, head.layernorm, cfg.layer_norm_eps), head.mlp.fc1)
    return pooled + dense(act_fn(y, cfg.hidden_act), head.mlp.fc2)


@torch.no_grad()
def model_forward(model: StreamformerEncoder, pixel_values: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Full-clip forward. pixel_values: (B, T, C, H, W), T <= 32, moved to
    the model's device. Returns ``last_hidden_state`` (B, T, N, D) and
    ``pooler_output`` (B, T, D)."""
    cfg = model.cfg
    x = embed(model, pixel_values)
    for layer in model.encoder.layer:
        x = layer_forward(layer, x, cfg)
    x = layer_norm(x, model.post_layernorm, cfg.layer_norm_eps)
    return {"last_hidden_state": x, "pooler_output": map_pool(x, model.head, cfg)}


# --------------------------------------------------------------------------
# Streaming forward with the fixed-capacity temporal KV cache
# --------------------------------------------------------------------------


def init_cache(
    cfg: StreamformerConfig,
    batch: int,
    *,
    num_patches: Optional[int] = None,
    capacity: Optional[int] = None,
    dtype=None,
    per_stream_len: bool = False,
    device=None,
) -> Cache:
    """Preallocated temporal KV cache: ``{"layers": [{"k", "v"}, ...],
    "len": int32 tensor ()}``, K/V pos-major (C, batch*N, D), zeros, every
    stream in lockstep. ``capacity`` defaults to ``cfg.cache_capacity``; the
    cache lives on ``cuda`` unless ``device`` names another device."""
    if per_stream_len:
        raise NotImplementedError("per-stream lengths, the ragged cache (ROADMAP slice 2, item 4)")
    if cfg.cache_layout != "pos_major":
        raise NotImplementedError(
            f"cache layout {cfg.cache_layout!r}: the port keeps the pos-major cache "
            "(row-major: ROADMAP slice 7, item 20)"
        )
    dt = compute_dtype(cfg)
    name = dtype if dtype is not None else (cfg.cache_dtype or cfg.dtype)
    cache_dt = _DTYPES.get(name, name) if isinstance(name, str) else name
    if cache_dt != dt:
        raise NotImplementedError(
            f"cache dtype {name}: the cache is kept in the compute dtype "
            "(int8 and mixed caches: ROADMAP slice 3, item 9)"
        )
    dev = resolve_device(device)
    n = num_patches if num_patches is not None else cfg.num_patches
    cap = capacity if capacity is not None else cfg.cache_capacity
    shape = (cap, batch * n, cfg.hidden_size)
    layers: List[Dict[str, torch.Tensor]] = [
        {"k": torch.zeros(shape, dtype=dt, device=dev), "v": torch.zeros(shape, dtype=dt, device=dev)}
        for _ in range(cfg.num_hidden_layers)
    ]
    return {"layers": layers, "len": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def streaming_forward(
    model: StreamformerEncoder,
    pixel_values: torch.Tensor,
    cache: Cache,
    *,
    total_frames_hint: Optional[int] = None,
) -> Tuple[Dict[str, torch.Tensor], Cache]:
    """Append one frame per stream: pixel_values (B, 1, C, H, W).

    Returns (outputs, cache): ``last_hidden_state`` (B, 1, N, D) and
    ``pooler_output`` (B, 1, D) for the new frame, equal to the last frame of
    a full-clip forward over every frame so far (within the window, for the
    ring). The cache is updated IN PLACE, K/V planes and ``len`` alike, and
    returned for the JAX package's calling convention.

    ``total_frames_hint`` is the sequence length used for time-embedding
    interpolation; by default ``cfg.num_frames`` (as the JAX package's code
    does), so positions past the trained table reuse its last row. The
    linear cache must not be run past its capacity: that is not checked, as
    it would wait on the device for ``len``; the same kernel then acts as the
    ring.
    """
    cfg = model.cfg
    b, t = pixel_values.shape[:2]
    if t != 1:
        raise NotImplementedError("multi-frame streaming appends (ROADMAP slice 2, item 4)")
    cache_len = cache["len"]
    if cache_len.ndim:
        raise NotImplementedError("per-stream lengths, the ragged cache (ROADMAP slice 2, item 4)")
    total = total_frames_hint if total_frames_hint is not None else cfg.num_frames
    x = embed(model, pixel_values, start_pos=cache_len, total_frames=max(total, t))
    for layer, kv in zip(model.encoder.layer, cache["layers"]):
        x = layer_forward(layer, x, cfg, cache_kv=kv, cache_len=cache_len)
    x = layer_norm(x, model.post_layernorm, cfg.layer_norm_eps)
    out = {"last_hidden_state": x, "pooler_output": map_pool(x, model.head, cfg)}
    cache_len.add_(t)
    return out, cache
