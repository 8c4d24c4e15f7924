"""Multi-scale deformable attention (MSDeformAttn) on PyTorch.

Port of the JAX package's ``ops/msdeform_attn.py``, the ViT-Adapter's and
the Mask2Former pixel decoder's attention (the reference's
``ops/modules/ms_deform_attn.py``). It is no Pallas kernel there: the JAX
package samples with four-corner gathers. Here ``ms_deform_attn_core_plain``
is the reference's own plain version, one ``F.grid_sample`` a level
(bilinear, zero padding, ``align_corners=False``: the sample of location
``loc`` is at pixel ``loc * W - 0.5``, and a corner outside the map adds
zero), differentiable in the value, the locations and the weights.

``ms_deform_attn_core`` is the entry point. For CPU tensors it is the plain
version. For CUDA tensors it runs kernel M (``csrc/msdeform_attn.cu``)
through the ``torch.autograd.Function`` ``MSDeformAttnCore``, whose backward
is M's backward kernel (the gradients of the value, the locations and the
weights); there is no fallback on the card. Each launch adds one to
``LAUNCHES["ms_deform_attn"]`` or ``LAUNCHES["ms_deform_attn_bwd"]``
(``ops.attention.LAUNCHES``). ``ms_deform_attn_core_backward`` is the
backward alone (M's on the card, autograd of the plain version on the
CPU). The native CPU oracle is ``streamformer_tpu_torch.native``.

``MSDeformAttn`` holds the projections (value and output, the learned
sampling offsets and attention weights) at the reference's initialisation:
zero offset and weight matrices, the offsets' bias a rotated grid of
``n_points`` rings, Xavier-uniform value and output projections.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from streamformer_tpu_torch.data.transforms import host_to
from streamformer_tpu_torch.ops.attention import _DTYPE_CODES, _I, _P, _launch

# levels M takes in its argument struct; past them the table is a device array
ARG_LEVELS = 16
# the C entries' pointers, then B, S, M, D, Q, L, P, the dtype code, the stream
_FWD_ARGS = (_P,) * 6 + (_I,) * 8 + (_P,)
_BWD_ARGS = (_P,) * 9 + (_I,) * 8 + (_P,)


def ms_deform_attn_core_plain(
    value: torch.Tensor,  # (B, S, M, D), S = sum of H_l * W_l over levels
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,  # (B, Lq, M, L, P, 2) in [0, 1]
    attention_weights: torch.Tensor,  # (B, Lq, M, L, P), softmaxed over L * P
) -> torch.Tensor:
    """Returns (B, Lq, M * D)."""
    b, _, m, d = value.shape
    _, lq, _, nl, p, _ = sampling_locations.shape
    grids = 2 * sampling_locations - 1
    samples, start = [], 0
    for lid, (h, w) in enumerate(spatial_shapes):
        v = value[:, start:start + h * w].permute(0, 2, 3, 1).reshape(b * m, d, h, w)
        g = grids[:, :, :, lid].transpose(1, 2).reshape(b * m, lq, p, 2)
        samples.append(F.grid_sample(v, g, mode="bilinear", padding_mode="zeros",
                                     align_corners=False))  # (B*M, D, Lq, P)
        start += h * w
    sampled = torch.stack(samples, dim=-2).flatten(-2)  # (B*M, D, Lq, L*P)
    attn = attention_weights.transpose(1, 2).reshape(b * m, 1, lq, nl * p)
    out = (sampled * attn).sum(-1)  # (B*M, D, Lq)
    return out.reshape(b, m * d, lq).transpose(1, 2)


def ms_deform_attn_core_backward_plain(value, spatial_shapes, sampling_locations,
                                       attention_weights, grad_out):
    """Plain version of ``ms_deform_attn_core_backward``: autograd of
    ``ms_deform_attn_core_plain``."""
    with torch.enable_grad():
        args = [x.detach().requires_grad_() for x in
                (value, sampling_locations, attention_weights)]
        out = ms_deform_attn_core_plain(args[0], spatial_shapes, args[1], args[2])
        return torch.autograd.grad(out, args, grad_out)


def _shapes(spatial_shapes) -> Tuple[Tuple[int, int], ...]:
    return tuple((int(h), int(w)) for h, w in spatial_shapes)


def _levels(shapes: Tuple[Tuple[int, int], ...], device: torch.device):
    """The level table as M's C entries take it: the (L, 2) table of (H, W)
    on the host, which the entry copies into the kernel's argument struct,
    and, past ``ARG_LEVELS`` levels only, an (L, 3) int64 table of (H, W,
    start) on the device (else None). The caller keeps both alive over the
    launch."""
    host = (ctypes.c_int * (2 * len(shapes)))(*(x for hw in shapes for x in hw))
    if len(shapes) <= ARG_LEVELS:
        return host, None
    starts = [0]
    for h, w in shapes[:-1]:
        starts.append(starts[-1] + h * w)
    table = torch.tensor([[h, w, s0] for (h, w), s0 in zip(shapes, starts)], dtype=torch.int64,
                         device=device)
    return host, table


def _check(value, shapes, loc, weight, grad_out=None) -> None:
    """What M takes: one float32 or bfloat16 type, one CUDA device, and
    shapes that agree (the kernel trusts them)."""
    tensors = dict(value=value, sampling_locations=loc, attention_weights=weight)
    if grad_out is not None:
        tensors["grad_out"] = grad_out
    for key, t in tensors.items():
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"ms_deform_attn_core: {key} is {t.dtype}; kernel M takes "
                            "float32 or bfloat16")
        if t.dtype != value.dtype:
            raise TypeError(f"ms_deform_attn_core: {key} is {t.dtype}, value {value.dtype}; "
                            "kernel M takes one type")
        if t.device != value.device:
            raise ValueError(f"ms_deform_attn_core: {key} is on {t.device}, not {value.device}")
    if value.device.type != "cuda":
        raise ValueError(f"ms_deform_attn_core: kernel M runs on CUDA, not {value.device}")
    if value.ndim != 4 or loc.ndim != 6 or loc.shape[-1] != 2:
        raise ValueError(f"ms_deform_attn_core: value {tuple(value.shape)} must be (B, S, M, D), "
                         f"sampling_locations {tuple(loc.shape)} (B, Q, M, L, P, 2)")
    b, s, m, d = value.shape
    if (loc.shape[0], loc.shape[2], loc.shape[3]) != (b, m, len(shapes)):
        raise ValueError(f"ms_deform_attn_core: sampling_locations {tuple(loc.shape)} do not "
                         f"match value {tuple(value.shape)} and {len(shapes)} levels")
    if weight.shape != loc.shape[:-1]:
        raise ValueError(f"ms_deform_attn_core: attention_weights {tuple(weight.shape)} must "
                         f"be {tuple(loc.shape[:-1])}")
    if sum(h * w for h, w in shapes) != s:
        raise ValueError(f"ms_deform_attn_core: the levels {shapes} hold "
                         f"{sum(h * w for h, w in shapes)} positions, value {s}")
    if grad_out is not None and grad_out.shape != (b, loc.shape[1], m * d):
        raise ValueError(f"ms_deform_attn_core: grad_out {tuple(grad_out.shape)} must be "
                         f"{(b, loc.shape[1], m * d)}")


def _forward(value, shapes, loc, weight) -> torch.Tensor:
    """Launch M's forward on contiguous, checked inputs."""
    b, s, m, d = value.shape
    _, q, _, nl, p, _ = loc.shape
    out = value.new_empty(b, q, m * d)
    if b * q * m:
        host, table = _levels(shapes, value.device)
        _launch("ms_deform_attn", "sf_msdeform_attn", _FWD_ARGS, value.device,
                value.data_ptr(), loc.data_ptr(), weight.data_ptr(), out.data_ptr(),
                ctypes.addressof(host), 0 if table is None else table.data_ptr(),
                b, s, m, d, q, nl, p, _DTYPE_CODES[value.dtype], library="msdeform_attn")
    return out


def _backward(value, shapes, loc, weight, grad_out):
    """Launch M's backward on contiguous, checked inputs: the value's
    gradient is summed in an fp32 buffer (cast once for bf16)."""
    b, s, m, d = value.shape
    _, q, _, nl, p, _ = loc.shape
    grad_value = torch.zeros(value.shape, dtype=torch.float32, device=value.device)
    grad_loc, grad_weight = torch.empty_like(loc), torch.empty_like(weight)
    if b * q * m:
        host, table = _levels(shapes, value.device)
        _launch("ms_deform_attn_bwd", "sf_msdeform_attn_bwd", _BWD_ARGS, value.device,
                value.data_ptr(), loc.data_ptr(), weight.data_ptr(), grad_out.data_ptr(),
                grad_value.data_ptr(), grad_loc.data_ptr(), grad_weight.data_ptr(),
                ctypes.addressof(host), 0 if table is None else table.data_ptr(),
                b, s, m, d, q, nl, p, _DTYPE_CODES[value.dtype], library="msdeform_attn")
    return grad_value.to(value.dtype), grad_loc, grad_weight


class MSDeformAttnCore(torch.autograd.Function):
    """Kernel M and its backward: gradients of the value, the locations and
    the weights (none for the level shapes)."""

    @staticmethod
    def forward(ctx, value, sampling_locations, attention_weights, shapes):
        ctx.shapes = shapes
        ctx.save_for_backward(value, sampling_locations, attention_weights)
        return _forward(value, shapes, sampling_locations, attention_weights)

    @staticmethod
    def backward(ctx, grad_out):
        value, loc, weight = ctx.saved_tensors
        return (*_backward(value, ctx.shapes, loc, weight, grad_out.contiguous()), None)


def ms_deform_attn_core(
    value: torch.Tensor,  # (B, S, M, D), S = sum of H_l * W_l over levels
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,  # (B, Lq, M, L, P, 2) in [0, 1]
    attention_weights: torch.Tensor,  # (B, Lq, M, L, P), softmaxed over L * P
) -> torch.Tensor:
    """Returns (B, Lq, M * D): the plain version on the CPU, kernel M (and
    its backward) on the card. Locations outside [0, 1] sample zeros at the
    corners that fall off the map. M takes float32 or bfloat16, all three
    inputs in one type, and any B, S, M, D, Lq, L and P."""
    if value.device.type == "cpu":
        return ms_deform_attn_core_plain(value, spatial_shapes, sampling_locations,
                                         attention_weights)
    shapes = _shapes(spatial_shapes)
    _check(value, shapes, sampling_locations, attention_weights)
    return MSDeformAttnCore.apply(value.contiguous(), sampling_locations.contiguous(),
                                  attention_weights.contiguous(), shapes)


def ms_deform_attn_core_backward(value, spatial_shapes, sampling_locations, attention_weights,
                                 grad_out):
    """(grad_value, grad_loc, grad_weight) of ``ms_deform_attn_core`` for
    the output gradient grad_out (B, Lq, M * D): M's backward kernel on the
    card, the plain version's on the CPU."""
    if value.device.type == "cpu":
        return ms_deform_attn_core_backward_plain(value, spatial_shapes, sampling_locations,
                                                  attention_weights, grad_out)
    shapes = _shapes(spatial_shapes)
    _check(value, shapes, sampling_locations, attention_weights, grad_out)
    return _backward(value.contiguous(), shapes, sampling_locations.contiguous(),
                     attention_weights.contiguous(), grad_out.contiguous())


class MSDeformAttn(nn.Module):
    """The projections of one MSDeformAttn block (reference init)."""

    def __init__(self, d_model: int = 256, n_levels: int = 4, n_heads: int = 8,
                 n_points: int = 4, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_levels, self.n_heads, self.n_points = n_levels, n_heads, n_points
        self.sampling_offsets = nn.Linear(d_model, n_heads * n_levels * n_points * 2)
        self.attention_weights = nn.Linear(d_model, n_heads * n_levels * n_points)
        self.value_proj = nn.Linear(d_model, d_model)
        self.output_proj = nn.Linear(d_model, d_model)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        m, nl, p = self.n_heads, self.n_levels, self.n_points
        thetas = torch.arange(m, dtype=torch.float64) * (2.0 * math.pi / m)
        grid = torch.stack([thetas.cos(), thetas.sin()], -1)
        grid = grid / grid.abs().max(-1, keepdim=True).values
        grid = grid[:, None, None, :].repeat(1, nl, p, 1)
        grid = grid * torch.arange(1, p + 1, dtype=torch.float64)[None, None, :, None]
        self.sampling_offsets.weight.zero_()
        self.sampling_offsets.bias.copy_(grid.reshape(-1))
        self.attention_weights.weight.zero_()
        self.attention_weights.bias.zero_()
        for lin in (self.value_proj, self.output_proj):
            nn.init.xavier_uniform_(lin.weight, generator=generator)
            lin.bias.zero_()


def ms_deform_attn(
    module: MSDeformAttn,
    query: torch.Tensor,  # (B, Lq, C)
    reference_points: torch.Tensor,  # (B, Lq, L, 2), normalised
    value: torch.Tensor,  # (B, S, C)
    spatial_shapes: Sequence[Tuple[int, int]],
) -> torch.Tensor:
    b, lq, c = query.shape
    nl, m, p = len(spatial_shapes), module.n_heads, module.n_points
    v = module.value_proj(value).reshape(b, -1, m, c // m)
    offsets = module.sampling_offsets(query).reshape(b, lq, m, nl, p, 2)
    attn = module.attention_weights(query).reshape(b, lq, m, nl * p)
    attn = attn.softmax(-1).reshape(b, lq, m, nl, p)
    shapes_wh = host_to([[w, h] for h, w in spatial_shapes], query.device, torch.float32)
    loc = reference_points[:, :, None, :, None, :] + offsets / shapes_wh[:, None, :]
    return module.output_proj(ms_deform_attn_core(v, spatial_shapes, loc, attn))
