"""Multi-scale deformable attention (MSDeformAttn) on PyTorch.

Port of the JAX package's ``ops/msdeform_attn.py``, the ViT-Adapter's and
the Mask2Former pixel decoder's attention (the reference's
``ops/modules/ms_deform_attn.py``). It is no Pallas kernel there: the JAX
package samples with four-corner gathers. Here ``ms_deform_attn_core`` is
the reference's own plain version, one ``F.grid_sample`` a level
(bilinear, zero padding, ``align_corners=False``: the sample of location
``loc`` is at pixel ``loc * W - 0.5``, and a corner outside the map adds
zero), differentiable in the value, the locations and the weights.

``MSDeformAttn`` holds the projections (value and output, the learned
sampling offsets and attention weights) at the reference's initialisation:
zero offset and weight matrices, the offsets' bias a rotated grid of
``n_points`` rings, Xavier-uniform value and output projections.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from streamformer_tpu_torch.data.transforms import host_to


def ms_deform_attn_core(
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
