"""Int8 weights with dynamic int8 activations, and int4 KV packing.

Port of the JAX package's ``ops/quant.py`` (the reference), for the serving
path; nothing here has a backward.

* ``quantize_rows``: symmetric per-row int8, the scale ``max(absmax, 1e-8) /
  127`` and the codes ``clip(round(x / scale), -127, 127)`` (round half to
  even), over the last axis. The encoder's int8 KV cache quantizes each new
  frame's K/V rows with it (per row over the whole D, not per head).
* ``Int8Linear``: a linear layer whose weight is int8 per output channel
  (``weight`` (out, in) int8, ``weight_scale`` (out,) fp32); its codes are
  ``quantize_rows`` of the float (out, in) weight, which is the JAX
  package's ``quantize_linear`` of the (in, out) kernel. The bias and any
  LoRA stay as they were.
* ``int8_dense``: quantize x per row, s8 x s8 -> s32 product, ``fp32 * xs *
  w_scale``, cast to x's dtype, add the bias in that dtype, add the LoRA
  delta unquantized: the JAX package's order, step for step.
* ``quantize_encoder`` / ``quantize_lm``: swap every large dense layer of a
  ``StreamformerEncoder`` or a ``LanguageModel`` (its untied ``lm_head``
  too) for an ``Int8Linear``, as ``quantize_encoder_params`` walks the JAX
  tree.
* ``quantize_kv4`` / ``dequantize_kv4``: int4 over the head dim, two codes a
  byte (the LM's ``cache_dtype="int4"``).

Every division by a constant divides by a device tensor: on the card
``x / 127.0`` with a Python divisor is a multiply by the reciprocal, one fp32
ulp off the JAX package's division, which moves codes that sit on a rounding
edge. The int8 product is ``torch._int_mm`` (cuBLASLt on the card), exact in
int32 on either device.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

# dense layers with fewer weight elements than this stay float (the JAX
# package's _MIN_KERNEL_ELEMENTS): dynamic quantization costs more than it
# saves on tiny products
MIN_KERNEL_ELEMENTS = 128 * 128

_DIVISORS: Dict[Tuple[float, torch.device], torch.Tensor] = {}


def _divisor(value: float, device: torch.device) -> torch.Tensor:
    """``value`` as a 0-d fp32 tensor on ``device``, so that dividing by it is
    a true division on the card too. A traced program (``torch.export``)
    fills one on the device at each call: the table holds real tensors only,
    and a lifted constant would be copied at each call."""
    if torch.compiler.is_compiling():
        return torch.full((), value, dtype=torch.float32, device=device)
    key = (value, device)
    if key not in _DIVISORS:
        _DIVISORS[key] = torch.tensor(value, dtype=torch.float32, device=device)
    return _DIVISORS[key]


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric dynamic int8 over the last axis: (..., K) -> (int8 (..., K),
    fp32 (...,)). The absmax is exact in x's dtype, and a bf16 x divided by
    the fp32 scale is divided in fp32, so no fp32 copy of x is made."""
    scale = x.abs().amax(dim=-1).float().clamp_min_(1e-8) / _divisor(127.0, x.device)
    codes = torch.round(x / scale[..., None]).clamp_(-127, 127).to(torch.int8)
    return codes, scale


def int8_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Exact s8 x s8 -> s32 product ``xq @ wq.T``: xq (M, K), wq (N, K), both
    int8 and row-major; returns (M, N) int32.

    ``wq.t()`` is the column-major (K, N) operand cuBLASLt takes as it is,
    so the weight is never copied. On the card cuBLASLt needs M > 16 and K
    and N multiples of 8: fewer rows (the MAP head's probe, a pooled batch)
    are padded with zero codes, whose products are zero."""
    m, k = xq.shape
    if xq.is_cuda:
        if k % 8 or wq.shape[0] % 8:
            raise ValueError(f"int8_matmul: K={k} and N={wq.shape[0]} must be multiples of 8 "
                             "on the card")
        if m <= 16:
            pad = torch.cat([xq, xq.new_zeros(32 - m, k)])
            return torch._int_mm(pad, wq.t())[:m]
    return torch._int_mm(xq, wq.t())


def int8_linear(x: torch.Tensor, weight: torch.Tensor, weight_scale: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ W.T + b`` with W int8 per output channel and x quantized per row
    on the fly; returns x's dtype and leading shape."""
    dt = x.dtype
    *lead, k = x.shape
    xq, xs = quantize_rows(x.reshape(-1, k))
    # int32 * fp32 promotes to fp32: (acc * xs) * w_scale, as the JAX package
    y = (int8_matmul(xq, weight) * xs[:, None]).mul_(weight_scale)
    y = y.to(dt).reshape(*lead, -1)
    if bias is not None:
        y = y + bias.to(dt)
    return y


class Int8Linear(nn.Module):
    """A dense layer with int8 weights: ``weight`` (out, in) int8 and
    ``weight_scale`` (out,) fp32 are buffers, ``bias`` a parameter in the
    compute dtype that does not require grad (an int8 layer serves; it has no
    backward). The state-dict names are the float layer's plus
    ``weight_scale``."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, *,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.register_buffer("weight", torch.zeros(out_features, in_features, dtype=torch.int8,
                                                   device=device))
        self.register_buffer("weight_scale", torch.ones(out_features, dtype=torch.float32,
                                                        device=device))
        self.bias = nn.Parameter(torch.zeros(out_features, dtype=dtype, device=device),
                                 requires_grad=False) if bias else None

    @classmethod
    @torch.no_grad()
    def from_linear(cls, lin: nn.Linear) -> "Int8Linear":
        """Per-output-channel codes and scales of ``lin``'s weight as it is
        stored (a bf16 weight is quantized from its bf16 values)."""
        out = cls(lin.in_features, lin.out_features, bias=lin.bias is not None,
                  dtype=lin.weight.dtype, device=lin.weight.device)
        out.weight, out.weight_scale = quantize_rows(lin.weight)
        if lin.bias is not None:
            out.bias.copy_(lin.bias)
        return out


def int8_dense(x: torch.Tensor, lin: Int8Linear,
               lora: Optional[Tuple[nn.Linear, nn.Linear]] = None) -> torch.Tensor:
    """``lin`` applied to x, plus the LoRA delta ``B(A x)`` in x's dtype,
    unquantized (the reference's LoRA convention)."""
    y = int8_linear(x, lin.weight, lin.weight_scale, lin.bias)
    if lora is not None:
        dt = x.dtype
        a, b = lora
        y = y + F.linear(F.linear(x, a.weight.to(dt)), b.weight.to(dt))
    return y


@torch.no_grad()
def quantize_encoder(model: nn.Module, min_elements: Optional[int] = None) -> nn.Module:
    """Quantize, IN PLACE, every dense layer of a ``StreamformerEncoder``
    with at least ``min_elements`` weight elements (default
    ``MIN_KERNEL_ELEMENTS``; 0 quantizes all), and return the model.

    The layers are those the JAX package's ``quantize_encoder_params``
    quantizes: each block's attention qkv and output, MLP, temporal qkv,
    output and ``temporal_dense``; the MAP head's q, k, v, output and MLP.
    The threshold applies per JAX leaf: the head's fused ``in_proj_weight``
    (3D, D) is three (D, D) leaves there, so it is tested at D*D and its
    per-row scales are the three leaves' per-column scales. The patch
    projection, LayerNorms, gates, embeddings, probe and LoRA stay float.

    The port keeps weights in the compute dtype, so a bf16 model is
    quantized from bf16-rounded weights, where the JAX package quantizes its
    fp32 tree; codes can then differ by one. Load a quantized JAX tree with
    ``checkpoint.params_from_jax`` (after quantizing at the same threshold)
    to take its codes as they are."""
    limit = _quantize_linears(model, min_elements)
    attn = model.head.attention
    d = attn.in_proj_weight.shape[1]
    if attn.in_proj_weight.dtype != torch.int8 and d * d >= limit:
        codes, scale = quantize_rows(attn.in_proj_weight)
        del attn.in_proj_weight
        attn.register_buffer("in_proj_weight", codes)
        attn.register_buffer("in_proj_weight_scale", scale)
    return model


def _quantize_linears(model: nn.Module, min_elements: Optional[int]) -> int:
    """Swap, in place, every ``nn.Linear`` but a LoRA factor with at least
    ``min_elements`` weight elements for an ``Int8Linear``; returns the
    threshold used."""
    limit = MIN_KERNEL_ELEMENTS if min_elements is None else min_elements
    for parent in list(model.modules()):
        for name, child in list(parent.named_children()):
            if (isinstance(child, nn.Linear) and not name.endswith(("_lora_a", "_lora_b"))
                    and child.weight.numel() >= limit):
                setattr(parent, name, Int8Linear.from_linear(child))
    return limit


@torch.no_grad()
def quantize_lm(model: nn.Module, min_elements: Optional[int] = None) -> nn.Module:
    """Quantize, IN PLACE, the dense layers of a ``LanguageModel`` as the JAX
    package's ``quantize_encoder_params`` walks its LM tree: every attention
    q/k/v/o and SwiGLU gate/up/down with at least ``min_elements`` weight
    elements, and the untied ``lm_head`` (the largest decode product; the
    JAX tree's ``lm_head_q`` / ``lm_head_scale``). The embedding table, a
    tied head and the norms stay float. Returns the model."""
    _quantize_linears(model, min_elements)
    return model


def quantize_kv4(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int4 over the last (head) axis, nibble-packed: (..., dh) ->
    (int8 (..., dh/2), fp32 (...,)). Even indices in the low nibble, odd in
    the high, each a 4-bit two's complement in [-7, 7]."""
    if x.shape[-1] % 2:
        raise ValueError(f"quantize_kv4: head dim {x.shape[-1]} must be even to nibble-pack")
    x32 = x.float()
    scale = x32.abs().amax(dim=-1).clamp_min(1e-8) / _divisor(7.0, x.device)
    q = torch.round(x32 / scale[..., None]).clamp_(-7, 7).to(torch.int8)
    return (q[..., 1::2] << 4) | (q[..., 0::2] & 0x0F), scale


def dequantize_kv4(packed: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of ``quantize_kv4``: arithmetic shifts sign-extend each nibble
    (the left shift wraps in int8)."""
    lo = (packed << 4) >> 4
    hi = packed >> 4
    q = torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1], packed.shape[-1] * 2)
    return (q.float() * scale[..., None]).to(dtype)
