"""The StreamFormer encoder on PyTorch: full-clip and streaming paths.

Port of the JAX package's ``models/encoder.py`` (the reference). The
backbone is a causal divided space-time TimeSformer-SigLIP: per layer a
temporal attention over frames behind a tanh gate, a spatial attention over
patches, and an MLP; a MAP head pools each frame's patches.

Layouts follow the JAX package at every public function: activations are
``(B, T, N, D)`` (batch, frames, patches, hidden); the streaming cache holds
one K and V per layer plus a ``len`` tensor, one length for the lockstep
cache or one per stream for the ragged cache of continuous batching. The
default layout is pos-major ``(C, B*N, D)``, an int8 cache adding
per-(position, row) fp32 scales; ``cfg.cache_layout="row_major"`` keeps the
JAX package's compatibility layout ``(B, N, C, D)``, lockstep only, an int8
cache adding per-(row, position, head) scales ``(B, N, C, H)``. The
attention runs through ``ops.attention``: the CUDA kernels on the card,
their plain versions on the CPU.

Int8 serving: ``ops.quant.quantize_encoder`` swaps the large dense layers
for ``Int8Linear`` (``dense`` dispatches on it), and ``init_cache`` with
``cache_dtype="int8"`` keeps the temporal KV cache in int8.

``StreamformerEncoder`` owns the parameters, under the reference
checkpoint's state-dict names, so ``load_state_dict`` takes a reference
(HF) state dict as it is. The functions below take the module where the JAX
package takes its parameter tree.

Serving and training build the module differently, and serving loads what
it always did. By default (``trainable=False``) the matmul weights are kept
in the compute dtype (``cfg.dtype``) and no parameter requires grad, so the
serving paths record no autograd graph. ``trainable=True`` is the trainer's
encoder: every parameter is an fp32 master parameter that requires grad, as
the JAX package's ``init_params`` tree is fp32, and ``dense`` casts each
weight to the compute dtype where it is used (bf16 compute over fp32
masters; the cast's backward hands the optimizer an fp32 gradient).
LayerNorm parameters and the temporal gates are fp32 either way, because the
JAX package applies them in fp32.

Training mode: ``model_forward(..., generator=g, deterministic=False)``
applies dropout and stochastic depth where the JAX package takes an
``rng``: ``g`` is a ``Draws`` (masks keyed by seed, global sample index,
draw site and element, so a data rank, a microbatch or a tensor-parallel
shard draws its part of the one-process masks) or a ``torch.Generator``,
whose seed keys them; ``cfg.remat == "layer"`` recomputes each layer in the
backward (``torch.utils.checkpoint``) with the same masks. The full-clip
attention is differentiable through ``ops.SpatialFlat`` and
``ops.TemporalFullclip``; the streaming path has no backward, as in the JAX
package.

Tensor and sequence parallelism (``parallel.sharding.shard_encoder``): the
encoder holds its model group's shard of the attention and MLP blocks, and
the full-clip forward and backward and the streaming step call the group's
collectives (``model.parallel``); the kernels run at the local head count,
and a streaming cache holds the rank's heads.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from streamformer_tpu_torch.config import StreamformerConfig
from streamformer_tpu_torch.data.transforms import resize
from streamformer_tpu_torch.ops import attention as ops
from streamformer_tpu_torch.ops import quant
from streamformer_tpu_torch.parallel import sharding

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


def cast(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """t in ``dtype``: t itself when it already is, as ``t.to(dtype)`` gives
    it eagerly, but without recording a cast in a traced program
    (``torch.export`` records ``to`` and a metadata check for each call)."""
    return t if t.dtype == dtype else t.to(dtype)


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm, eps: float) -> torch.Tensor:
    """LayerNorm over the last axis, computed in fp32, cast back."""
    f32 = torch.float32
    y = F.layer_norm(cast(x, f32), x.shape[-1:], cast(ln.weight, f32), cast(ln.bias, f32), eps)
    return cast(y, x.dtype)


def dense(
    x: torch.Tensor, lin: nn.Linear, lora: Optional[Tuple[nn.Linear, nn.Linear]] = None
) -> torch.Tensor:
    """Affine map with the optional LoRA delta ``y = W x + b + B(A x)``
    (the reference's convention: no extra scaling). An ``Int8Linear`` runs
    the int8 product with x quantized per row (``quant.int8_dense``)."""
    if isinstance(lin, quant.Int8Linear):
        return quant.int8_dense(x, lin, lora)
    dt = x.dtype
    bias = None if lin.bias is None else cast(lin.bias, dt)
    y = F.linear(x, cast(lin.weight, dt), bias)
    if lora is not None:
        a, b = lora
        y = y + F.linear(F.linear(x, cast(a.weight, dt)), cast(b.weight, dt))
    return y


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over the last axis (the JAX package's ``quantize_kv``,
    codes rounded half to even): (..., K) -> (int8 (..., K), fp32 (...,)).
    The pos-major int8 cache gives it (..., D) rows, one scale per row over
    the whole hidden D; ``quantize_kv_heads`` is the row-major cache's."""
    return quant.quantize_rows(x)


def quantize_kv_heads(x: torch.Tensor, num_heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The row-major int8 cache's quantizer: ``quantize_kv`` over each head's
    dh slice, one scale per head, as the JAX package quantizes its (..., H,
    dh) row-major K/V: (..., D) -> (int8 (..., D), fp32 (..., H))."""
    codes, scale = quantize_kv(x.reshape(*x.shape[:-1], num_heads, x.shape[-1] // num_heads))
    return codes.reshape(x.shape), scale


def dequantize_kv(codes: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return (codes.float() * scale[..., None]).to(dtype)


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


_M32 = 0xFFFFFFFF


def _mix32(x):
    """A 32-bit integer hash (two xorshift-multiply rounds) of values in
    [0, 2**32): a Python int, or an int64 tensor elementwise on any device
    (every product stays below 2**63, so the CPU and the card agree)."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x1B873593) & _M32
    return x ^ (x >> 16)


class Draws:
    """The dropout and stochastic-depth draws of one forward, keyed by
    (seed, global sample index, site, element) and computed by a hash, not
    read from a generator's stream. A sample draws the same masks whatever
    batch, data rank, microbatch or tensor-parallel shard it runs in, and a
    recompute (``remat="layer"``) draws them again.

    ``index`` (B,) int64, on the activations' device, holds the global
    indices of the rows the forward sees; a site numbers a draw point of the
    model (``embed``: 0 and 1; layer i: ``_layer_site(i)`` + 0..4)."""

    def __init__(self, seed: int, index: torch.Tensor):
        self.seed = int(seed)
        self.index = index

    @classmethod
    def of(cls, generator, batch: int, device) -> Optional["Draws"]:
        """``generator`` as draws over ``batch`` rows: a ``Draws`` as it is,
        a ``torch.Generator`` keyed by its seed (read, never advanced) with
        the rows numbered 0..batch-1, None as None."""
        if generator is None or isinstance(generator, Draws):
            return generator
        return cls(generator.initial_seed(), torch.arange(batch, device=device))

    def rows(self, start: int, stop: int) -> "Draws":
        """The draws of rows [start, stop) (a microbatch)."""
        return Draws(self.seed, self.index[start:stop])

    def uniform(self, site: int, full: Tuple[int, ...], start: Optional[Tuple[int, ...]] = None,
                size: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
        """(B, *size) fp32 uniforms in [0, 1) on steps of 2**-24: each row's
        draws of the elements of a per-sample tensor of shape ``full``, for
        the window of ``size`` elements from ``start`` (all of it by
        default)."""
        start = (0,) * len(full) if start is None else start
        size = tuple(full) if size is None else size
        key = _mix32(self.seed & _M32)
        key = _mix32(key ^ ((self.seed >> 32) & _M32))
        key = _mix32((key + 0x9E3779B9 * (site + 1)) & _M32)
        rows = _mix32(((self.index.long() * 0x2545F491) & _M32) ^ key)  # (B,)
        dev = self.index.device
        elem = torch.zeros((), dtype=torch.int64, device=dev)
        stride = 1
        for ax in reversed(range(len(full))):
            pos = torch.arange(start[ax], start[ax] + size[ax], dtype=torch.int64, device=dev)
            elem = elem + (pos * stride).reshape((-1,) + (1,) * (len(full) - 1 - ax))
            stride *= full[ax]
        elem = (elem * 0x9E3779B9) & _M32
        bits = _mix32((rows.reshape((-1,) + (1,) * len(full)) + elem) & _M32)
        return (bits >> 8).float() * 2.0**-24


def dropout(x: torch.Tensor, rate: float, generator, deterministic: bool, *, site: int = 0,
            full: Optional[Tuple[int, ...]] = None,
            start: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
    """Inverted dropout with the masks of ``Draws`` at ``site`` (a
    ``torch.Generator`` keys them by its seed). x (B, ...) is the window of a
    per-sample tensor of shape ``full`` from ``start`` (a tensor-parallel
    shard of it), all of it by default. The identity when ``deterministic``,
    at rate 0, or without a generator (the JAX package applies none without
    an ``rng``)."""
    if deterministic or rate == 0.0 or generator is None:
        return x
    draws = Draws.of(generator, x.shape[0], x.device)
    keep = draws.uniform(site, tuple(x.shape[1:]) if full is None else full, start,
                         tuple(x.shape[1:])) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def drop_path(x: torch.Tensor, rate: float, generator, deterministic: bool, *,
              site: int = 0) -> torch.Tensor:
    """Stochastic depth on the leading (batch) axis: one draw per sample,
    survivors scaled by 1 / keep probability."""
    if deterministic or rate == 0.0 or generator is None:
        return x
    draws = Draws.of(generator, x.shape[0], x.device)
    keep = (draws.uniform(site, ()) >= rate).reshape((x.shape[0],) + (1,) * (x.ndim - 1))
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def _drop_path_rates(cfg: StreamformerConfig) -> List[float]:
    """Per-layer stochastic-depth rates: linear from 0 to ``drop_path_rate``."""
    n = cfg.num_hidden_layers
    if n == 1:
        return [0.0]
    return [cfg.drop_path_rate * i / (n - 1) for i in range(n)]


def _layer_site(i: int) -> int:
    """The first draw site of layer ``i`` (``embed`` takes sites 0 and 1)."""
    return 8 * (i + 1)


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
    """One block (reference TimesformerLayerSigLIP): divided space-time
    attention, or for ``space_only`` and ``joint_space_time`` the spatial
    block alone, without the temporal one, as the JAX package's
    ``init_layer_params`` builds them."""

    def __init__(self, cfg: StreamformerConfig, dt: torch.dtype):
        super().__init__()
        d, m, eps = cfg.hidden_size, cfg.intermediate_size, cfg.layer_norm_eps
        self.layernorm_before = nn.LayerNorm(d, eps=eps)
        self.layernorm_after = nn.LayerNorm(d, eps=eps)
        self.attention = _attention(cfg, dt, cfg.add_lora_spatial)
        self.intermediate = _container(dense=nn.Linear(d, m, dtype=dt))
        self.output = _container(dense=nn.Linear(m, d, dtype=dt))
        if cfg.attention_type == "divided_space_time":
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
    from a fresh default generator. ``trainable=True`` gives fp32 master
    parameters that require grad (the trainer's encoder); the default is the
    serving encoder, weights in the compute dtype and no grad.
    """

    def __init__(self, cfg: StreamformerConfig, *, device=None,
                 generator: Optional[torch.Generator] = None, trainable: bool = False):
        super().__init__()
        _check_supported(cfg)
        dev = resolve_device(device)
        dt = torch.float32 if trainable else compute_dtype(cfg)
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
        # the model group this encoder is sharded over (parallel.sharding.shard_encoder)
        self.parallel = None
        self._init_weights(generator)
        self.requires_grad_(trainable)
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

    def forward(self, pixel_values: torch.Tensor, *,
                generator: Optional[torch.Generator] = None,
                deterministic: bool = True) -> Dict[str, torch.Tensor]:
        return model_forward(self, pixel_values, generator=generator,
                             deterministic=deterministic)

    def init_cache(self, batch: int, capacity: Optional[int] = None,
                   per_stream_len: bool = False) -> Cache:
        return init_cache(self.cfg, batch, capacity=capacity, per_stream_len=per_stream_len,
                          device=self.device, shards=cache_shards(self))

    def stream(self, frames: torch.Tensor, cache: Cache,
               new_valid: Optional[torch.Tensor] = None) -> Tuple[Dict[str, torch.Tensor], Cache]:
        return streaming_forward(self, frames, cache, new_valid=new_valid)


ATTENTION_TYPES = ("divided_space_time", "space_only", "joint_space_time")


def _check_supported(cfg: StreamformerConfig) -> None:
    compute_dtype(cfg)
    if cfg.attention_type not in ATTENTION_TYPES:
        raise ValueError(f"attention_type {cfg.attention_type!r}: one of {ATTENTION_TYPES}")


# --------------------------------------------------------------------------
# Embeddings
# --------------------------------------------------------------------------


def time_embeddings_for_positions(
    time_emb: torch.Tensor, start, t_new: int, total: int
) -> torch.Tensor:
    """Time embeddings for absolute frame positions [start, start + t_new):
    (t_new, D) for one shared start, (B, t_new, D) for per-stream starts.

    When ``total`` exceeds the trained positions the table is
    nearest-interpolated to ``total`` (output i takes input
    floor(i * T_trained / total), torch's 'nearest'); positions past the
    table are clamped to its last row. ``start`` is an int, a device tensor
    of one element, or a (B,) device tensor (the ragged cache's lengths); it
    is read on the device, never on the host."""
    t_trained = time_emb.shape[0]
    dev = time_emb.device
    table = time_emb
    if total > t_trained:
        table = time_emb[(torch.arange(total, device=dev) * t_trained) // total]
    start = torch.as_tensor(start).to(dev, non_blocking=True)  # an int: no stream sync
    steps = torch.arange(t_new, device=dev)
    pos = start[:, None] + steps if start.ndim == 1 else start + steps
    return table[pos.clamp(0, table.shape[0] - 1)]


def interpolate_pos_embeddings(pos_emb: torch.Tensor, h_patches: int, w_patches: int
                               ) -> torch.Tensor:
    """The (..., N, D) grid of position embeddings resized to h_patches x
    w_patches for another resolution than the trained one: Keys cubic
    (a = -0.5) with antialiasing on a downscale, ``jax.image.resize``'s
    "cubic" (the reference's bicubic ``F.interpolate`` with antialias), in
    fp32; the table itself at the trained size."""
    n, d = pos_emb.shape[-2:]
    m = int(round(n**0.5))
    if (h_patches, w_patches) == (m, m):
        return pos_emb
    grid = resize(pos_emb.reshape(m, m, d).float(), (h_patches, w_patches), "bicubic")
    return grid.reshape(*pos_emb.shape[:-2], h_patches * w_patches, d).to(pos_emb.dtype)


def embed(
    model: StreamformerEncoder,
    pixel_values: torch.Tensor,
    *,
    start_pos=0,
    total_frames: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    deterministic: bool = True,
) -> torch.Tensor:
    """Patchify + position + time embeddings: (B, T, C, H, W) -> (B, T, N, D).

    The stride-p conv is run as one matmul on non-overlapping patches,
    flattened in (C, ph, pw) order as the conv weight is. In training mode
    (a ``generator`` and not ``deterministic``) hidden dropout follows the
    position embeddings and again the time embeddings, as in the JAX
    package. ``space_only`` adds no time embeddings (nor their dropout): its
    frames are independent, as in the JAX package, which keeps the table in
    its tree all the same (so does this module, for a strict load)."""
    cfg = model.cfg
    dt = compute_dtype(cfg)
    b, t, c, h, w = pixel_values.shape
    ps = cfg.patch_size
    if h % ps or w % ps:
        raise ValueError(f"frame size {h}x{w} is not a multiple of the patch size {ps}")
    hp, wp = h // ps, w // ps
    n, d = hp * wp, cfg.hidden_size
    emb = model.embeddings
    x = pixel_values.to(device=model.device, dtype=dt)
    x = x.reshape(b * t, c, hp, ps, wp, ps).permute(0, 2, 4, 1, 3, 5)
    x = x.reshape(b * t, n, c * ps * ps)
    proj = emb.patch_embeddings.projection
    x = F.linear(x, cast(proj.weight, dt).reshape(d, c * ps * ps), cast(proj.bias, dt))
    x = x.reshape(b, t, n, d) + cast(interpolate_pos_embeddings(emb.position_embeddings, hp, wp), dt)
    x = dropout(x, cfg.hidden_dropout_prob, generator, deterministic, site=0)
    if cfg.attention_type == "space_only":
        return x
    total = total_frames if total_frames is not None else t
    temb = cast(time_embeddings_for_positions(emb.time_embeddings[0], start_pos, t, total), dt)
    # (T, D) for a shared start, (B, T, D) for per-stream starts
    x = x + (temb[None, :, None, :] if temb.ndim == 2 else temb[:, :, None, :])
    return dropout(x, cfg.hidden_dropout_prob, generator, deterministic, site=1)


# --------------------------------------------------------------------------
# Attention
# --------------------------------------------------------------------------


def _col_sharded(weight: torch.Tensor, full_out: int) -> bool:
    """Whether a column-parallel product's weight holds a shard of its
    output rows (a block whose heads or width do not divide over the model
    group stays replicated)."""
    return weight.shape[0] < full_out


def _enter(x: torch.Tensor, parallel, sharded: bool, patches: bool) -> torch.Tensor:
    """Into a block's column-parallel product (``parallel.region_in``); x
    itself in one process."""
    return x if parallel is None else sharding.region_in(x, parallel, sharded, patches)


def _output(ctx: torch.Tensor, lin: nn.Linear, lora, parallel, sharded: bool,
            patches: bool) -> torch.Tensor:
    """A block's closing product. In one process ``dense``; under tensor
    parallelism the row-parallel product of this rank's columns, its
    partial sums (``sharding.partial_product``: fp32 where no gradient is
    recorded) reduced over the model group (``sharding.region_out``), the
    bias added once after the reduction, then rounded to ctx's dtype."""
    if parallel is None:
        return dense(ctx, lin, lora)
    dt = ctx.dtype
    y = sharding.partial_product(ctx, cast(lin.weight, dt))  # fp32 when serving
    if lora is not None:
        a, b = lora
        y = y + F.linear(F.linear(ctx, cast(a.weight, dt)), cast(b.weight, dt)).to(y.dtype)
    y = sharding.region_out(y, parallel, sharded, patches)
    return cast(y if lin.bias is None else y + cast(lin.bias, y.dtype), dt)


def spatial_attention(x: torch.Tensor, attn: nn.Module, cfg: StreamformerConfig,
                      parallel=None) -> torch.Tensor:
    """Softmax attention over the patches N, batched over (B, T);
    x: (B, T, N, D). Runs ``ops.spatial_flat`` on flat-D rows. Under tensor
    parallelism (``parallel``, a ``sharding.TensorParallel``) the qkv
    projection holds this rank's heads, so the kernel runs at the local head
    count, and the output projection is row-parallel."""
    patches = parallel is not None and parallel.shard_patches
    qkv_w = attn.attention.qkv.weight
    sharded = parallel is not None and _col_sharded(qkv_w, 3 * cfg.hidden_size)
    x = _enter(x, parallel, sharded, patches)
    b, t, n, _ = x.shape
    qkv = dense(x, attn.attention.qkv, _lora(attn.attention, "qkv"))  # (B, T, N, 3D / mp)
    d = qkv.shape[-1] // 3

    def rows(i):
        return qkv[..., i * d:(i + 1) * d].reshape(b * t, n, d).contiguous()

    ctx = ops.spatial_flat(rows(0), rows(1), rows(2), d // cfg.head_dim)
    return _output(ctx.reshape(b, t, n, d), attn.output.dense, _lora(attn.output, "dense"),
                   parallel, sharded, patches)


def temporal_attention(
    x: torch.Tensor,
    attn: nn.Module,
    cfg: StreamformerConfig,
    *,
    cache_kv: Optional[Dict[str, torch.Tensor]] = None,
    cache_len: Optional[torch.Tensor] = None,
    new_valid: Optional[torch.Tensor] = None,
    attend_cap: Optional[int] = None,
    parallel=None,
) -> torch.Tensor:
    """Attention over the frames T, batched over (B, N); x: (B, T, N, D).
    Causal unless ``cfg.enable_causal_temporal`` is False.

    Full clip (``cache_kv`` None): ``ops.temporal_fullclip_qkv`` on the
    (B, T, N, 3D) output of the qkv projection as it is, query t attending
    frames 0..t (every frame when not causal); its gradient is one (B, T,
    N, 3D) tensor. Under tensor
    parallelism (``parallel``) the projection holds this rank's heads, the
    kernels read its (B, T, N, 3D / mp) output at the local head count, the
    cache holds those heads (``init_cache(shards=mp)``), and the output
    projection is row-parallel; every path below runs so.

    Streaming: the new frames attend the cache and their K/V are written IN
    PLACE into ``cache_kv["k"]`` and ``cache_kv["v"]``; ``cache_len`` (one
    length, or (B,) per stream for the ragged cache) is not advanced here.
    Not causal, every new frame of a call sees every other (and the cache),
    as in the JAX package. On the pos-major float cache:

    - t = 1 without ``new_valid``: ``ops.temporal_decode_pm`` (one length)
      or ``ops.temporal_decode_pm_ragged`` (per stream), appending at slot
      ``len % C``; the same call serves the linear cache and the ring. Past
      the capacity their plan takes (``ops.decode_fits``), kernel E at t = 1
      (``ring`` on the ring).
    - t >= 2 on the ring, causal (lockstep only, as in the JAX package): one
      t=1 step per new frame, frame ti at position len + ti, so query p sees
      positions (p - C, p] and of t > C frames only the last C stay, the
      function of the JAX package's ``_ring_attend_pos_major``.
    - Otherwise (the linear cache, lockstep or ragged, t >= 2 or
      ``new_valid``; the ring not causal, lockstep only):
      ``ops.temporal_append_pm_qkv``, kernel E on the (B, T, N, 3D) qkv as it
      is, any t. Stream b appends its first ``new_valid[b]`` frames (all t by
      default) at slots len[b] + ti; a lockstep cache is one stream of all
      B*N rows. On the ring every query sees the window of the C positions
      ending at the call's last frame, and the last min(t, C) frames are
      written.

    A float cache in another dtype than the compute dtype (a mixed cache)
    takes the new frames' K/V rounded to its dtype, as the JAX package writes
    them before it attends them; every kernel reads it in fp32.

    An int8 cache (``"k_scale"`` in ``cache_kv``) runs kernel F (one
    length) or G (per stream): see ``_attend_int8``.

    The row-major cache (``cfg.cache_layout == "row_major"``) takes
    ``_row_major_attend``; ``attend_cap`` bounds the keys its einsum paths
    read, as the JAX package's capacity bucketing does.

    ``new_valid`` is causal only, and linear only, as in the JAX package.
    """
    causal = cfg.enable_causal_temporal
    patches = parallel is not None and parallel.shard_patches
    sharded = parallel is not None and _col_sharded(attn.attention.qkv.weight,
                                                     3 * cfg.hidden_size)
    # (B, T, N, 3D / mp): this rank's heads under tensor parallelism
    qkv = dense(_enter(x, parallel, sharded, patches), attn.attention.qkv)

    def out(ctx):
        return _output(ctx, attn.output.dense, None, parallel, sharded, patches)

    if cache_kv is None:  # C (and H) read qkv and write ctx in place: no copies around them
        return out(ops.temporal_fullclip_qkv(qkv, qkv.shape[-1] // (3 * cfg.head_dim), causal))
    b, t, n, d3 = qkv.shape
    d = d3 // 3
    h = d // cfg.head_dim
    ragged = cache_len.ndim == 1
    if cfg.cache_layout == "row_major":
        if new_valid is not None:
            raise ValueError("new_valid (per-stream partial appends) is a pos_major feature")
        if ragged:
            raise NotImplementedError(
                "ragged (per-stream) lengths are a pos_major-layout feature; the row-major "
                "compatibility layout is lockstep-only"
            )
        return out(_row_major_attend(qkv, cache_kv, cache_len, cfg, attend_cap))
    ring = cfg.cache_mode == "ring"
    if new_valid is not None:
        if ring:
            raise ValueError("new_valid holds are illegal in ring mode (a wrap-around dummy "
                             "write would evict in-window history)")
        if not causal:
            raise ValueError("new_valid (partial multi-frame appends) is causal-only, as in the "
                             "JAX package")
    if ring and ragged and t >= 2:
        raise NotImplementedError(
            "ragged (per-stream) lengths reach the ring cache only through the t=1 decode "
            "(whose slot-mod write and mask handle them); multi-frame ring appends are "
            "lockstep-only"
        )
    if "k_scale" in cache_kv:
        return out(_attend_int8(qkv, cache_kv, cache_len, new_valid, causal, h,
                                parallel if sharded else None))
    if ragged:
        lens, per_stream = cache_len, n
    else:  # lockstep: one stream of all B*N rows
        lens, per_stream = cache_len.reshape(1), b * n
    kv_dt = cache_kv["k"].dtype
    fits = ops.decode_fits(d, h, cache_kv["k"].shape[0], qkv.dtype, kv_dt, qkv.device)

    def append(qkv_, length, valid=None):
        """Kernel E on qkv_ (B, t', N, 3D) at ``length``, its K/V rounded to
        the cache's dtype first where that differs. One frame sees what a
        causal one sees, so t' = 1 takes the mask, which the ring allows."""
        kv = None if kv_dt == qkv.dtype else qkv_[..., d:].to(kv_dt)
        if valid is None:
            valid = torch.full(length.shape, qkv_.shape[1], dtype=torch.int32,
                               device=length.device)
        return ops.temporal_append_pm_qkv(qkv_, cache_kv["k"], cache_kv["v"], length, valid,
                                          per_stream, h, causal or qkv_.shape[1] == 1, ring, kv)

    def decode(ti, length):  # frame ti at position ``length`` -> (B*N, D)
        if not fits:
            return append(qkv[:, ti:ti + 1], length).reshape(b * n, d)

        def rows(i):  # frame ti of slice i -> (B*N, D); K and V in the cache's dtype
            x_ = qkv[:, ti, :, i * d:(i + 1) * d].reshape(b * n, d)
            return (x_ if i == 0 else x_.to(kv_dt)).contiguous()

        if ragged:
            return ops.temporal_decode_pm_ragged(rows(0), rows(1), rows(2), cache_kv["k"],
                                                 cache_kv["v"], length, n, h)
        return ops.temporal_decode_pm(rows(0), rows(1), rows(2), cache_kv["k"], cache_kv["v"],
                                      length.reshape(()), h)

    if t == 1 and new_valid is None:
        return out(decode(0, lens).reshape(b, 1, n, d))
    if ring and causal:
        ctx = torch.stack([decode(ti, lens + ti if ti else lens) for ti in range(t)])
        return out(ctx.reshape(t, b, n, d).transpose(0, 1))
    # E reads q, k, v from qkv and writes ctx (B, T, N, D) in place: no copies around it
    return out(append(qkv, lens, new_valid))


def _attend_int8(qkv: torch.Tensor, cache: Dict[str, torch.Tensor], cache_len: torch.Tensor,
                 new_valid: Optional[torch.Tensor], causal: bool, h: int,
                 parallel=None) -> torch.Tensor:
    """Streaming temporal attention on the pos-major int8 cache: qkv (B, T,
    N, 3D) -> ctx (B, T, N, D), one kernel F (one length) or G (per stream)
    call a new frame, each quantizing the frame's K/V rows, attending them
    dequantized and appending the codes and scales in place
    (``_decode_int8``), the function of the JAX package's einsum path, which
    quantizes first and attends the dequantized view.

    - Causal: frame ti at position len + ti, so query ti sees the cache and
      frames 0..ti; on the ring the window of the C positions ending at it.
    - Not causal: frames max(0, t - C) .. t - 2 are quantized and written at
      slots (len + ti) % C first, then every query is decoded at position
      len + t - 1 against the last frame: each sees the cache and all t
      frames (on the ring, the window ending at the last frame; the slots
      written first are those of positions leaving it).
    - ``new_valid`` (ragged, causal): frame ti at position len + min(ti,
      valid), so a stream past its valid frames is held, its dummy frame
      written at slot (len + valid) % C and rolled back, as the serving
      engine rolls back a held step. That slot's codes and scales are saved
      before the frames and restored after them: it lies past the stream's
      valid prefix, or wraps to slot 0 when len + valid == C, where the
      restore keeps position 0. Outputs past valid are unspecified.

    Under tensor parallelism (``parallel``: qkv holds this rank's heads) a
    row's scale is its whole D's: the absmax is MAX-reduced over the model
    group before the codes are taken (``sharding.quantize_rows``).
    """
    b, t, n, d3 = qkv.shape
    d = d3 // 3
    cap = cache["k"].shape[0]
    r = b * n

    def frame(i, ti):  # frame ti of slice i -> (B*N, D)
        return qkv[:, ti, :, i * d:(i + 1) * d].reshape(r, d).contiguous()

    def decode(ti, length):
        return _decode_int8(frame(0, ti), frame(1, ti), frame(2, ti), cache, length, n, h,
                            parallel)

    if causal and new_valid is None:
        return torch.stack([decode(ti, cache_len + ti if ti else cache_len)
                            for ti in range(t)]).reshape(t, b, n, d).transpose(0, 1)
    rows = torch.arange(r, device=qkv.device)
    per_row = cache_len.repeat_interleave(n) if cache_len.ndim == 1 else cache_len
    planes = ("k", "v", "k_scale", "v_scale")
    if not causal:
        for ti in range(max(0, t - cap), t - 1):
            slot = ((per_row + ti) % cap).long().expand(r)
            for key, i in (("k", 1), ("v", 2)):
                codes, scale = sharding.quantize_rows(frame(i, ti), parallel)
                cache[key][slot, rows], cache[f"{key}_scale"][slot, rows] = codes, scale
        last = cache_len + (t - 1)
        ctx = [_decode_int8(frame(0, ti), frame(1, t - 1), frame(2, t - 1), cache, last, n, h,
                            parallel) for ti in range(t)]
        return torch.stack(ctx).reshape(t, b, n, d).transpose(0, 1)
    hold = ((cache_len + new_valid) % cap).long().repeat_interleave(n)  # (R,)
    saved = [cache[key][hold, rows].clone() for key in planes]
    ctx = [decode(ti, cache_len + torch.clamp(new_valid, max=ti)) for ti in range(t)]
    for key, x in zip(planes, saved):
        cache[key][hold, rows] = x
    return torch.stack(ctx).reshape(t, b, n, d).transpose(0, 1)


def _row_major_attend(qkv: torch.Tensor, cache: Dict[str, torch.Tensor], cache_len: torch.Tensor,
                      cfg: StreamformerConfig, attend_cap: Optional[int]) -> torch.Tensor:
    """Streaming temporal attention on the lockstep row-major cache, K/V
    (B, N, C, D) updated IN PLACE: qkv (B, T, N, 3D) -> ctx (B, T, N, D),
    before the output projection. The JAX package's row-major branch
    (``temporal_attention``), case by case:

    - t = 1, float, linear or ring: kernel J (``ops.temporal_decode_rm``)
      attends and writes the new frame at slot len % C, on the (B*N, C, D)
      view; J is kernel A's body on row-major strides, so a row-major stream
      equals the pos-major one bit for bit on either cache;
    - linear, t = 1, int8: the new row is quantized per head
      (``quantize_kv_heads``) and written with its (B, N, C, H) scales, then
      kernel K (``ops.temporal_decode_rm_readonly``) reads positions <= len;
    - linear, t >= 2: the t rows are written at positions len.. (the start
      clamped to C - t, as ``dynamic_update_slice`` clamps it), then plain
      attention over the cache (the first ``attend_cap`` positions, when
      given), query ti seeing positions <= len + ti;
    - ring, t >= 2, and the int8 ring at any t: plain attention over the
      cache as it was plus the new frames, query len + ti seeing cache slot
      s's newest position p < len when p > len + ti - C and new frame j when
      ti - C < j <= ti; then the last min(t, C) frames are written at slots
      (len + ti) % C. The new frames are attended unquantized on an int8
      ring, as the JAX einsum attends them.

    Plain attention computes the scores, the softmax and PV in fp32 and
    rounds only its output to the compute dtype, as the kernels do; the JAX
    einsum rounds the probabilities to the compute dtype before PV, which in
    bf16 moves a ring stream 0.0088 pooled from the pos-major ring's kernel
    A on the card (ROADMAP section 3), and in fp32 changes nothing."""
    b, t, n, d3 = qkv.shape
    d = d3 // 3
    h = d // cfg.head_dim  # this rank's heads under tensor parallelism
    dh = cfg.head_dim
    dt = qkv.dtype
    cap = cache["k"].shape[2]
    quantized = "k_scale" in cache
    causal = cfg.enable_causal_temporal

    def flat(a):  # (B, N, C, X) -> the (B*N, C, X) view, shared with the cache
        return a.view(b * n, cap, a.shape[-1])

    if t == 1 and not quantized:
        def rows1(i):  # (B, 1, N, D) slice -> (B*N, D); K and V in the cache's dtype
            x = qkv[..., i * d:(i + 1) * d].reshape(b * n, d)
            return (x if i == 0 else x.to(cache["k"].dtype)).contiguous()

        ctx = ops.temporal_decode_rm(rows1(0), rows1(1), rows1(2), flat(cache["k"]),
                                     flat(cache["v"]), cache_len, h)
        return ctx.reshape(b, 1, n, d)
    q, k, v = (qkv[..., i * d:(i + 1) * d].reshape(b, t, n, h, dh) for i in range(3))
    steps = torch.arange(t, device=qkv.device)

    def write(key: str, val: torch.Tensor, slots: torch.Tensor) -> None:
        """New rows val (B, T', N, H, dh) at positions ``slots`` (T',)."""
        val = val.transpose(1, 2).reshape(b, n, -1, d)  # (B, N, T', D)
        if quantized:
            codes, scale = quantize_kv_heads(val, h)
            cache[key].index_copy_(2, slots, codes)
            cache[f"{key}_scale"].index_copy_(2, slots, scale)
        else:
            cache[key].index_copy_(2, slots, val.to(cache[key].dtype))

    def full_kv(key: str, limit: int = cap) -> torch.Tensor:
        """(B, N, C', H, dh) in fp32: the cache's first ``limit`` positions,
        dequantized to the compute dtype on an int8 cache."""
        arr = cache[key][:, :, :limit].reshape(b, n, limit, h, dh)
        if quantized:
            arr = dequantize_kv(arr, cache[f"{key}_scale"][:, :, :limit], dt)
        return arr.to(dt).float()

    qf = q.float()
    scale = dh**-0.5
    if cfg.cache_mode == "ring":
        s_old = torch.einsum("bqnhd,bnkhd->bnhqk", qf, full_kv("k")) * scale
        s_new = torch.einsum("bqnhd,bknhd->bnhqk", qf, k.float()) * scale
        # query len + ti's window: the C positions ending at it (causal), or
        # at the call's last frame, len + t - 1
        qpos = cache_len + (steps[:, None] if causal else t - 1)  # (t, 1) or ()
        slot = torch.arange(cap, device=qkv.device)[None]  # (1, C)
        # slot s holds the newest position p = s (mod C) below len; unwritten slots give p < 0
        kpos_old = slot + cap * torch.div(cache_len - 1 - slot, cap, rounding_mode="floor")
        ok_old = ((kpos_old >= 0) & (kpos_old > qpos - cap)).expand(t, cap)  # (t, C)
        if causal:
            ok_new = (steps[None] <= steps[:, None]) & (steps[None] > steps[:, None] - cap)
        else:
            ok_new = (steps[None] > t - 1 - cap).expand(t, t)  # (t, t)
        scores = torch.cat([s_old.masked_fill(~ok_old, float("-inf")),
                            s_new.masked_fill(~ok_new, float("-inf"))], dim=-1)
        probs = torch.softmax(scores, dim=-1)
        vals = torch.cat([full_kv("v").transpose(1, 2), v.float()], dim=1)  # (B, C + t, N, H, dh)
        ctx = torch.einsum("bnhqk,bknhd->bqnhd", probs, vals).to(dt).reshape(b, t, n, d)
        keep = min(t, cap)
        slots = (cache_len + steps[t - keep:]) % cap
        write("k", k[:, t - keep:], slots)
        write("v", v[:, t - keep:], slots)
        return ctx
    start = cache_len.clamp(max=cap - t)  # dynamic_update_slice's clamp
    write("k", k, start + steps)
    write("v", v, start + steps)
    if t == 1:  # int8: kernel K over the cache as written; its reads stop at len
        ctx = ops.temporal_decode_rm_readonly(
            q.reshape(b * n, d).contiguous(), flat(cache["k"]), flat(cache["v"]),
            flat(cache["k_scale"]), flat(cache["v_scale"]), cache_len, h,
        )
        return ctx.reshape(b, 1, n, d)
    limit = cap if attend_cap is None else min(attend_cap, cap)
    scores = torch.einsum("bqnhd,bnkhd->bnhqk", qf, full_kv("k", limit)) * scale
    pos = torch.arange(limit, device=qkv.device)[None]
    if causal:
        visible = pos <= cache_len + steps[:, None]
    else:
        visible = (pos < cache_len + t).expand(t, limit)
    probs = torch.softmax(scores.masked_fill(~visible, float("-inf")), dim=-1)
    ctx = torch.einsum("bnhqk,bnkhd->bqnhd", probs, full_kv("v", limit))
    return ctx.to(dt).reshape(b, t, n, d)


def _decode_int8(q, k_new, v_new, cache_kv, lens, rows_per_stream, h, parallel=None):
    """One new frame (R, D) on the int8 cache: its K/V rows are quantized
    over the whole D (``quantize_kv``, as the JAX package does before its
    int8 kernels; over the model group's whole D under tensor parallelism),
    then kernel F (one length) or G (per stream) attends and appends the
    codes and the scales in place."""
    kq, ks = sharding.quantize_rows(k_new, parallel)
    vq, vs = sharding.quantize_rows(v_new, parallel)
    planes = (cache_kv["k"], cache_kv["v"], cache_kv["k_scale"], cache_kv["v_scale"])
    if lens.ndim == 1:
        return ops.temporal_decode_pm_int8_ragged(q, kq, vq, ks, vs, *planes, lens,
                                                  rows_per_stream, h)
    return ops.temporal_decode_pm_int8(q, kq, vq, ks, vs, *planes, lens, h)


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
    new_valid: Optional[torch.Tensor] = None,
    attend_cap: Optional[int] = None,
    drop_path_rate: float = 0.0,
    generator=None,
    deterministic: bool = True,
    site: int = 0,
    parallel=None,
) -> torch.Tensor:
    """One block on (B, T, N, D). Divided space-time: temporal LN ->
    temporal attention -> ``temporal_dense`` -> residual scaled by
    tanh(gate); LN -> spatial attention -> residual; LN -> MLP -> residual.
    With ``cache_kv`` the layer's cache is updated in place. ``space_only``
    and ``joint_space_time`` have no temporal block: LN -> attention over
    each frame's N patches, or over all T x N tokens of the clip (of the
    new frames when streaming; the cache is not used) -> residual; then the
    MLP, as the JAX package's branches do.

    In training mode stochastic depth falls where the JAX package puts it
    (on the temporal attention's output before ``temporal_dense``, on the
    spatial branch and on the MLP branch) and hidden dropout follows the
    GELU and the MLP's second projection; ``generator`` (a ``Draws`` or a
    ``torch.Generator``) keys them, from draw site ``site`` on.

    Tensor parallelism (``parallel``, a ``sharding.TensorParallel``): each
    block (temporal attention, spatial attention, MLP) is a column-parallel
    product of this rank's heads or columns and a row-parallel one reduced
    over the model group; ``temporal_dense`` is replicated and runs on the
    reduced attention output, so the temporal branch costs one reduction.
    With ``parallel.shard_patches`` x holds this rank's patches (sequence
    parallelism): the norms, the gate and the residuals run on them, an
    all-gather opens each block and a reduce-scatter closes it."""
    eps = cfg.layer_norm_eps
    patches = parallel is not None and parallel.shard_patches

    def dp(y, k):
        return drop_path(y, drop_path_rate, generator, deterministic, site=site + k)

    if cfg.attention_type == "divided_space_time":
        t_ln = layer_norm(x, layer.temporal_layernorm, eps)
        t_attn = temporal_attention(
            t_ln, layer.temporal_attention, cfg, cache_kv=cache_kv, cache_len=cache_len,
            new_valid=new_valid, attend_cap=attend_cap, parallel=parallel,
        )
        gate = cast(torch.tanh(cast(layer.temporal_attention_gating, torch.float32)), x.dtype)
        x = x + gate * dense(dp(t_attn, 0), layer.temporal_dense)
        s_attn = spatial_attention(layer_norm(x, layer.layernorm_before, eps), layer.attention,
                                   cfg, parallel)
    else:
        # a joint block attends all T x N tokens as one frame; under sequence
        # parallelism its gather concatenates the ranks' token sets, which
        # attention over every token does not see, and its reduce-scatter
        # hands each rank its own tokens back
        s_ln = layer_norm(x, layer.layernorm_before, eps)
        if cfg.attention_type == "joint_space_time":
            b, t, n, d = s_ln.shape
            s_attn = spatial_attention(s_ln.reshape(b, 1, t * n, d), layer.attention,
                                       cfg, parallel).reshape(b, t, n, d)
        else:
            s_attn = spatial_attention(s_ln, layer.attention, cfg, parallel)
    x = x + dp(s_attn, 1)
    fc1, fc2 = layer.intermediate.dense, layer.output.dense
    sharded = parallel is not None and _col_sharded(fc1.weight, cfg.intermediate_size)
    m = gelu(dense(_enter(layer_norm(x, layer.layernorm_after, eps), parallel, sharded, patches),
                   fc1))
    b, t, n, cols = m.shape
    full = (t, n, cfg.intermediate_size)  # this rank's columns of the per-sample masks
    m = dropout(m, cfg.hidden_dropout_prob, generator, deterministic, site=site + 3, full=full,
                start=(0, 0, parallel.rank * cols if sharded else 0))
    m = _output(m, fc2, None, parallel, sharded, patches)
    n_local = m.shape[2]  # this rank's patches under sequence parallelism
    m = dropout(m, cfg.hidden_dropout_prob, generator, deterministic, site=site + 4,
                full=(t, n_local * parallel.size if patches else n_local, m.shape[3]),
                start=(0, parallel.rank * n_local if patches else 0, 0))
    return x + dp(m, 2)


def map_pool(x: torch.Tensor, head: nn.Module, cfg: StreamformerConfig,
             parallel=None) -> torch.Tensor:
    """SigLIP multihead-attention pooling of each frame's patches:
    (B, T, N, D) -> (B, T, D). A learned probe attends over the N patches
    (torch nn.MultiheadAttention semantics), then LN + MLP residual.

    A quantized head (``quant.quantize_encoder``) keeps ``in_proj_weight``
    as int8 codes with ``in_proj_weight_scale``: q, k and v are then int8
    products as the JAX package's three leaves are; k and v share x's
    activation codes, so they run as one product of 2D columns.

    Under tensor parallelism (``parallel``) the in-projection holds this
    rank's heads and the MLP's first product its columns; the out-projection
    and the second product are row-parallel (x is whole on every rank)."""
    b, t, n, d = x.shape
    dh = cfg.head_dim
    dt = x.dtype
    attn = head.attention
    probe = cast(head.probe.reshape(1, d), dt)
    sharded = parallel is not None and _col_sharded(attn.in_proj_weight, 3 * d)
    if attn.in_proj_weight.dtype == torch.int8:
        h = cfg.num_attention_heads
        w, w_s, bias = attn.in_proj_weight, attn.in_proj_weight_scale, attn.in_proj_bias
        q = quant.int8_linear(probe, w[:d], w_s[:d], bias[:d]).reshape(h, dh)
        k, v = quant.int8_linear(x, w[d:], w_s[d:], bias[d:]).split(d, dim=-1)
        k, v = k.reshape(b, t, n, h, dh), v.reshape(b, t, n, h, dh)
    else:
        w_q, w_k, w_v = cast(attn.in_proj_weight, dt).chunk(3)
        b_q, b_k, b_v = cast(attn.in_proj_bias, dt).chunk(3)
        h = w_q.shape[0] // dh  # this rank's heads
        xin = _enter(x, parallel, sharded, False)
        q = F.linear(probe, w_q, b_q).reshape(h, dh)
        k = F.linear(xin, w_k, b_k).reshape(b, t, n, h, dh)
        v = F.linear(xin, w_v, b_v).reshape(b, t, n, h, dh)
    scores = torch.einsum("hd,btnhd->bthn", q.float(), k.float()) * dh**-0.5
    probs = torch.softmax(scores, dim=-1).to(dt)
    ctx = torch.einsum("bthn,btnhd->bthd", probs.float(), v.float()).to(dt).reshape(b, t, h * dh)
    pooled = _output(ctx, attn.out_proj, None, parallel, sharded, False)
    fc1 = head.mlp.fc1
    mlp_sharded = parallel is not None and _col_sharded(fc1.weight, cfg.intermediate_size)
    y = dense(_enter(layer_norm(pooled, head.layernorm, cfg.layer_norm_eps), parallel, mlp_sharded,
                     False), fc1)
    return pooled + _output(act_fn(y, cfg.hidden_act), head.mlp.fc2, None, parallel, mlp_sharded,
                            False)


def run_layers(layers, x: torch.Tensor, cfg: StreamformerConfig, *, first: int = 0,
               generator=None, deterministic: bool = True, parallel=None) -> torch.Tensor:
    """The trunk's layers ``first``, ``first + 1``, ... in order on x (B, T,
    N, D): each at its global index's stochastic-depth rate and draw sites.
    ``cfg.remat == "layer"`` keeps only each layer's input for the backward
    and recomputes the layer there; the keyed draws give the same masks."""
    if cfg.remat not in ("none", "layer"):
        raise NotImplementedError(f"remat {cfg.remat!r}: the port takes 'none' or 'layer'")
    rates = _drop_path_rates(cfg)
    remat = cfg.remat == "layer" and torch.is_grad_enabled()
    for i, layer in enumerate(layers, start=first):
        def run(y, layer=layer, i=i):
            return layer_forward(layer, y, cfg, drop_path_rate=rates[i], generator=generator,
                                 deterministic=deterministic, site=_layer_site(i),
                                 parallel=parallel)

        x = checkpoint(run, x, use_reentrant=False, preserve_rng_state=False) if remat else run(x)
    return x


def model_forward(
    model: StreamformerEncoder,
    pixel_values: torch.Tensor,
    *,
    generator=None,
    deterministic: bool = True,
) -> Dict[str, torch.Tensor]:
    """Full-clip forward. pixel_values: (B, T, C, H, W), any T and any frame
    size that is a multiple of the patch size, moved to the model's device. Returns ``last_hidden_state`` (B, T, N, D) and
    ``pooler_output`` (B, T, D).

    Differentiable: a graph is recorded when grad mode is on and a parameter
    (a ``trainable`` encoder) or the input requires grad. With a
    ``generator`` and ``deterministic=False`` dropout and stochastic depth
    are drawn: a ``Draws`` keys them by each row's global sample index, a
    ``torch.Generator`` by its seed and the row. ``cfg.remat == "layer"``
    keeps only each layer's input for the backward and recomputes the layer
    there, with the same masks.

    A model sharded by ``parallel.sharding.shard_encoder`` (``model.parallel``
    set) runs tensor parallel over its model group, every rank on the same
    rows; with ``shard_patches`` the trunk holds each rank's patches."""
    cfg = model.cfg
    par = model.parallel
    draws = None if deterministic else Draws.of(generator, pixel_values.shape[0], model.device)
    x = embed(model, pixel_values, generator=draws, deterministic=deterministic)
    patches = par is not None and par.shard_patches
    if patches:
        x = sharding.split_patches(x, par)
    x = run_layers(model.encoder.layer, x, cfg, generator=draws, deterministic=deterministic,
                   parallel=par)
    if patches:
        x = sharding.gather_patches(x, par)
    x = layer_norm(x, model.post_layernorm, cfg.layer_norm_eps)
    return {"last_hidden_state": x, "pooler_output": map_pool(x, model.head, cfg, par)}


# --------------------------------------------------------------------------
# Streaming forward with the fixed-capacity temporal KV cache
# --------------------------------------------------------------------------


def auto_cache_mode(cfg: StreamformerConfig) -> str:
    """The cache mode a serving engine takes for mode="auto": "ring" for the
    pos-major layout, whose t=1 decode (kernels A and D on the card, and
    their plain versions on the CPU) serves the ring's sliding window as it
    serves the linear cache; "linear" otherwise. The JAX package resolves to
    "linear" off its TPU kernels, so a comparison with its engine names the
    mode."""
    return "ring" if cfg.cache_layout == "pos_major" else "linear"


def cache_shards(model: StreamformerEncoder) -> int:
    """The parts a cache plane's D is cut into for ``model``: the model
    group's size when its temporal attention is cut by heads
    (``sharding.shard_encoder``), else 1."""
    par = model.parallel
    if par is None or model.cfg.attention_type != "divided_space_time":
        return 1
    qkv = model.encoder.layer[0].temporal_attention.attention.qkv.weight
    return par.size if _col_sharded(qkv, 3 * model.cfg.hidden_size) else 1


def init_cache(
    cfg: StreamformerConfig,
    batch: int,
    *,
    num_patches: Optional[int] = None,
    capacity: Optional[int] = None,
    dtype=None,
    per_stream_len: bool = False,
    device=None,
    shards: int = 1,
) -> Cache:
    """Preallocated temporal KV cache: ``{"layers": [{"k", "v"}, ...],
    "len": int32 tensor}``, zeros. K/V are pos-major (C, batch*N, D) for
    ``cfg.cache_layout == "pos_major"``, row-major (batch, N, C, D) for
    "row_major".

    The cache is kept in ``dtype`` (else ``cfg.cache_dtype``, else the
    compute dtype): float32 or bfloat16, which may differ from the compute
    dtype (a mixed cache: the new frames are rounded to it as they are
    written, and read back in fp32 by the kernels), or int8: then each layer
    also holds fp32
    ``k_scale`` and ``v_scale``, of shape (C, batch*N) on the pos-major
    layout, the scale of each (position slot, row), so that an append writes
    one contiguous row; of shape (batch, N, C, H) on the row-major layout,
    one per (row, position, head), as the JAX package keeps them.

    ``len`` is () with every stream in lockstep, or (batch,) with
    ``per_stream_len``: the ragged cache of continuous batching, each stream
    at its own position (see ``reset_streams``), pos-major only. Rows are
    not padded per stream. ``capacity`` defaults to ``cfg.cache_capacity``;
    the cache lives on ``cuda`` unless ``device`` names another device.

    ``shards`` cuts D (and the row-major scales' heads) into that many
    parts: the cache of one rank of a model cut by
    ``parallel.sharding.shard_encoder``, which holds the rank's heads
    (``cache_shards(model)``; ``model.init_cache`` passes it). The int8
    scales stay one per (position, row) over the whole D."""
    if cfg.cache_layout not in ("pos_major", "row_major"):
        raise ValueError(f"cache layout {cfg.cache_layout!r}: 'pos_major' or 'row_major'")
    row_major = cfg.cache_layout == "row_major"
    if per_stream_len and row_major:
        raise NotImplementedError("per-stream lengths are a pos_major-layout feature")
    name = dtype if dtype is not None else (cfg.cache_dtype or cfg.dtype)
    cache_dt = {"int8": torch.int8, **_DTYPES}.get(name, name) if isinstance(name, str) else name
    if cache_dt not in (torch.float32, torch.bfloat16, torch.int8):
        raise ValueError(f"cache dtype {name}: float32, bfloat16 or int8")
    dev = resolve_device(device)
    n = num_patches if num_patches is not None else cfg.num_patches
    cap = capacity if capacity is not None else cfg.cache_capacity
    if cfg.num_attention_heads % shards:
        raise ValueError(f"{cfg.num_attention_heads} heads do not divide into {shards} shards")
    width = cfg.hidden_size // shards
    if row_major:
        shape = (batch, n, cap, width)
        scale_shape = (batch, n, cap, cfg.num_attention_heads // shards)
    else:
        shape = (cap, batch * n, width)
        scale_shape = shape[:2]

    def layer() -> Dict[str, torch.Tensor]:
        kv = {"k": torch.zeros(shape, dtype=cache_dt, device=dev),
              "v": torch.zeros(shape, dtype=cache_dt, device=dev)}
        if cache_dt == torch.int8:
            kv["k_scale"] = torch.zeros(scale_shape, dtype=torch.float32, device=dev)
            kv["v_scale"] = torch.zeros(scale_shape, dtype=torch.float32, device=dev)
        return kv

    layers: List[Dict[str, torch.Tensor]] = [layer() for _ in range(cfg.num_hidden_layers)]
    len_shape = (batch,) if per_stream_len else ()
    return {"layers": layers, "len": torch.zeros(len_shape, dtype=torch.int32, device=dev)}


def reset_streams(cache: Cache, done: torch.Tensor) -> Cache:
    """Re-admit finished stream slots of a per-stream-length cache.

    done: (B,) bool on the cache's device; True sets that stream's length to
    0. IN PLACE, ``len.masked_fill_(done, 0)``, with no host read; the cache
    is returned for the JAX package's calling convention. Stale K/V need no
    clearing: every consumer masks positions >= len."""
    if cache["len"].ndim != 1:
        raise ValueError("reset_streams needs init_cache(per_stream_len=True)")
    cache["len"].masked_fill_(done, 0)
    return cache


@torch.no_grad()
def streaming_forward(
    model: StreamformerEncoder,
    pixel_values: torch.Tensor,
    cache: Cache,
    *,
    total_frames_hint: Optional[int] = None,
    attend_capacity: Optional[int] = None,
    new_valid: Optional[torch.Tensor] = None,
    cfg: Optional[StreamformerConfig] = None,
) -> Tuple[Dict[str, torch.Tensor], Cache]:
    """Append T new frames per stream: pixel_values (B, T, C, H, W).

    Returns (outputs, cache): ``last_hidden_state`` (B, T, N, D) and
    ``pooler_output`` (B, T, D) for the new frames, equal to the last frames
    of a full-clip forward over every frame so far (within the window, for
    the ring). The cache is updated IN PLACE, K/V planes and ``len`` alike,
    and returned for the JAX package's calling convention.

    Ragged cache (``init_cache(per_stream_len=True)``): each stream b starts
    at its own position len[b] (time embeddings, masks, appends), so row b
    equals a lone stream at that position. ``new_valid`` (B,) int32 in
    [0, T], ragged cache only, causal only: stream b appends only its first
    new_valid[b] frames and its ``len`` advances by new_valid[b]; output
    columns past it are unspecified. Without it every ``len`` advances by T.
    ``new_valid`` needs the linear cache; T >= 2 on the ring needs the
    lockstep cache. Any T, causal or not, on a float cache of the compute
    dtype or the other one (any capacity on the pos-major layout), or int8
    (``temporal_attention`` names the kernels). The row-major layout is
    lockstep only.

    ``total_frames_hint`` is the sequence length used for time-embedding
    interpolation; by default ``cfg.num_frames`` (as the JAX package's code
    does), so positions past the trained table reuse its last row; a call of
    T frames interpolates to max(hint, T). ``attend_capacity``, when given
    and at least len + T, bounds the cache positions the row-major einsum
    paths read, as the JAX package's capacity buckets do; it does not change
    the result, and the kernels' reads stop at the valid prefix anyway. The
    linear cache must not be run past its capacity: that is not checked, as
    it would wait on the device for ``len``; the t=1 kernels then act as the
    ring. ``cfg`` defaults to ``model.cfg``; a serving engine passes its own,
    whose ``cache_mode`` may differ.

    A model cut by ``parallel.sharding.shard_encoder`` streams tensor
    parallel over its model group, every rank on the same frames: its cache
    (``model.init_cache``) holds the rank's heads, at (C, B*N, D / mp), the
    kernels run at heads / mp, each block's closing product is reduced over
    the group, and an int8 cache's row scales are MAX-reduced over it, so
    they are the unsharded cache's. With ``shard_patches`` the trunk keeps
    the rank's patches between blocks, as the full clip does.
    """
    par = model.parallel
    cfg = cfg if cfg is not None else model.cfg
    shards = cache_shards(model)
    if (cfg.attention_type == "divided_space_time"
            and cache["layers"][0]["k"].shape[-1] * shards != cfg.hidden_size):
        raise ValueError(f"a cache of width {cache['layers'][0]['k'].shape[-1]} for a model of "
                         f"hidden {cfg.hidden_size} cut into {shards}: make it with "
                         "model.init_cache (init_cache(..., shards=cache_shards(model)))")
    b, t = pixel_values.shape[:2]
    cache_len = cache["len"]
    if new_valid is not None:
        if cache_len.ndim != 1:
            raise ValueError("new_valid (per-stream partial appends) needs "
                             "init_cache(per_stream_len=True)")
        new_valid = torch.as_tensor(new_valid, dtype=torch.int32, device=cache_len.device)
    total = total_frames_hint if total_frames_hint is not None else cfg.num_frames
    x = embed(model, pixel_values, start_pos=cache_len, total_frames=max(total, t))
    patches = par is not None and par.shard_patches
    if patches:
        x = sharding.split_patches(x, par)
    for layer, kv in zip(model.encoder.layer, cache["layers"]):
        x = layer_forward(layer, x, cfg, cache_kv=kv, cache_len=cache_len, new_valid=new_valid,
                          attend_cap=attend_capacity, parallel=par)
    if patches:
        x = sharding.gather_patches(x, par)
    x = layer_norm(x, model.post_layernorm, cfg.layer_norm_eps)
    out = {"last_hidden_state": x, "pooler_output": map_pool(x, model.head, cfg, par)}
    cache_len.add_(t if new_valid is None else new_valid)
    return out, cache
