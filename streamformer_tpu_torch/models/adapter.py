"""ViT-Adapter on the frozen StreamFormer backbone for dense prediction
(OVIS), on PyTorch.

Port of the JAX package's ``models/adapter.py`` (the reference's
``TimesformerMultiTaskingModelSigLIPViTAdapter``): a SpatialPriorModule
conv stem giving 1/4..1/32 features; extractor blocks whose 3-scale
adapter tokens cross-attend the ViT tokens through single-level
MSDeformAttn and a ConvFFN (a depthwise conv over each scale); interaction
blocks over encoder layer ranges; a 4-scale FPN ``res2..res5`` (NHWC,
leading dim B*T) for the Mask2Former segmentor.

What the JAX package's XLA ops mean, written out in torch:

* ``padding="SAME"`` pads (total // 2, total - total // 2): for a 3x3
  stride-2 conv on an even input 0 before and 1 after, which
  ``padding=1`` would not give (``_same_pad``);
* the norms of the stem and the FPN (the reference's SyncBatchNorm) always
  take the batch's statistics over (N, H, W), biased, in training and at
  inference alike: there are no running statistics (``_bn``);
* ``jax.image.resize(..., "linear")`` is ``data.transforms.resize``: a
  triangle kernel widened by the scale on a downscale (antialiasing);
* the transposed conv's kernel arrives flipped in space
  (``checkpoint.adapter_params_from_jax``), as ``F.conv_transpose2d``
  wants it;
* layer norms take eps 1e-6 and the GELU is exact.

The backbone is frozen: ``embed`` and ``layer_forward`` run under
``torch.no_grad()`` (kernels B and C on the card, no graph recorded); the
extractors read its tokens and never write them, so no gradient is lost.
In JAX the backbone's blocks interleave with the extractors; as nothing
flows back into it, the port runs it first (``backbone_features``), and a
caller that runs the adapter twice on one clip runs the backbone once.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from streamformer_tpu_torch.config import StreamformerConfig
from streamformer_tpu_torch.data.transforms import resize
from streamformer_tpu_torch.models import encoder as enc
from streamformer_tpu_torch.ops.msdeform_attn import MSDeformAttn, ms_deform_attn

INTERACTION_INDEXES = [[0, 2], [3, 5], [6, 8], [9, 11]]


def default_interaction_indexes(num_layers: int):
    """Contiguous [lo, hi] layer ranges of the interaction blocks: the
    canonical 4-block split for the 12-layer flagship, min(4, num_layers)
    near-equal chunks for smaller encoders."""
    chunks = np.array_split(np.arange(num_layers), min(4, num_layers))
    return [[int(c[0]), int(c[-1])] for c in chunks]


# ---------------------------------------------------------------------------
# small pieces
# ---------------------------------------------------------------------------


def _conv(cin: int, cout: int, k: int, generator, groups: int = 1, bias: bool = False
          ) -> nn.Conv2d:
    conv = nn.Conv2d(cin, cout, k, groups=groups, bias=bias)
    with torch.no_grad():
        conv.weight.normal_(0.0, math.sqrt(2.0 / (k * k * cout // groups)), generator=generator)
        if bias:
            conv.bias.zero_()
    return conv


class Norm(nn.Module):
    """A norm's affine parameters (``weight``, ``bias``)."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))


def _bn(x: torch.Tensor, p: Norm, channel_dim: int, eps: float = 1e-5) -> torch.Tensor:
    """Batch statistics over every axis but ``channel_dim`` (biased
    variance), then the affine part."""
    dims = tuple(i for i in range(x.ndim) if i != channel_dim % x.ndim)
    m = x.mean(dims, keepdim=True)
    v = x.var(dims, unbiased=False, keepdim=True)
    shape = [1] * x.ndim
    shape[channel_dim] = -1
    return (x - m) * torch.rsqrt(v + eps) * p.weight.reshape(shape) + p.bias.reshape(shape)


def _same_pad(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """XLA's SAME padding of an NCHW input for a k x k conv at ``stride``."""
    pads = []
    for size in (x.shape[-1], x.shape[-2]):  # F.pad takes the last axis first
        total = max((-(-size // stride) - 1) * stride + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


def _conv_same(x: torch.Tensor, conv: nn.Conv2d, stride: int = 1) -> torch.Tensor:
    k = conv.weight.shape[-1]
    return F.conv2d(_same_pad(x, k, stride), conv.weight, conv.bias, stride=stride,
                    groups=conv.groups)


def get_reference_points(shapes: Sequence[Tuple[int, int]], device) -> torch.Tensor:
    """Normalised grid centres of each level, concatenated: (1, S, 1, 2)."""
    pts = []
    for h, w in shapes:
        ys = (torch.arange(h, device=device, dtype=torch.float32) + 0.5) / h
        xs = (torch.arange(w, device=device, dtype=torch.float32) + 0.5) / w
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        pts.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], -1))
    return torch.cat(pts, 0)[None, :, None, :]


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


class SpatialPriorModule(nn.Module):
    def __init__(self, inplanes: int = 64, embed_dim: int = 768, generator=None):
        super().__init__()
        g = generator
        self.stem1, self.stem1_bn = _conv(3, inplanes, 3, g), Norm(inplanes)
        self.stem2, self.stem2_bn = _conv(inplanes, inplanes, 3, g), Norm(inplanes)
        self.stem3, self.stem3_bn = _conv(inplanes, inplanes, 3, g), Norm(inplanes)
        self.conv2, self.conv2_bn = _conv(inplanes, 2 * inplanes, 3, g), Norm(2 * inplanes)
        self.conv3, self.conv3_bn = _conv(2 * inplanes, 4 * inplanes, 3, g), Norm(4 * inplanes)
        self.conv4, self.conv4_bn = _conv(4 * inplanes, 4 * inplanes, 3, g), Norm(4 * inplanes)
        self.fc1 = _conv(inplanes, embed_dim, 1, g, bias=True)
        self.fc2 = _conv(2 * inplanes, embed_dim, 1, g, bias=True)
        self.fc3 = _conv(4 * inplanes, embed_dim, 1, g, bias=True)
        self.fc4 = _conv(4 * inplanes, embed_dim, 1, g, bias=True)


def spm_forward(p: SpatialPriorModule, x: torch.Tensor):
    """x: (B*T, 3, H, W) -> c1 (1/4, NHWC) and the c2, c3, c4 token
    sequences (B*T, S_i, D)."""
    def block(y, conv, norm, stride):
        return F.relu(_bn(_conv_same(y, conv, stride), norm, 1))

    y = block(x, p.stem1, p.stem1_bn, 2)
    y = block(y, p.stem2, p.stem2_bn, 1)
    y = block(y, p.stem3, p.stem3_bn, 1)
    c1 = F.max_pool2d(y, 3, 2, padding=1)
    c2 = block(c1, p.conv2, p.conv2_bn, 2)
    c3 = block(c2, p.conv3, p.conv3_bn, 2)
    c4 = block(c3, p.conv4, p.conv4_bn, 2)
    c1, c2, c3, c4 = (F.conv2d(c, fc.weight, fc.bias).permute(0, 2, 3, 1)
                      for c, fc in ((c1, p.fc1), (c2, p.fc2), (c3, p.fc3), (c4, p.fc4)))
    return c1, c2.flatten(1, 2), c3.flatten(1, 2), c4.flatten(1, 2)


class Extractor(nn.Module):
    def __init__(self, dim: int, heads: int, n_points: int, cffn_ratio: float = 0.25,
                 generator=None):
        super().__init__()
        hid = int(dim * cffn_ratio)
        self.query_norm = nn.LayerNorm(dim, eps=1e-6)
        self.feat_norm = nn.LayerNorm(dim, eps=1e-6)
        self.attn = MSDeformAttn(dim, 1, heads, n_points, generator=generator)
        self.ffn_fc1 = nn.Linear(dim, hid)
        self.ffn_dw = _conv(hid, hid, 3, generator, groups=hid)
        self.ffn_dw_bias = nn.Parameter(torch.zeros(hid))
        self.ffn_fc2 = nn.Linear(hid, dim)
        self.ffn_norm = nn.LayerNorm(dim, eps=1e-6)
        with torch.no_grad():
            for lin in (self.ffn_fc1, self.ffn_fc2):
                lin.weight.normal_(0.0, 0.02, generator=generator)
                lin.bias.zero_()


def _conv_ffn(p: Extractor, x: torch.Tensor, shapes_3l) -> torch.Tensor:
    """ConvFFN, its depthwise 3x3 conv over each scale (reference
    ConvFFN/DWConv). x: (B, S, dim)."""
    y = p.ffn_fc1(x)
    parts, start = [], 0
    for h, w in shapes_3l:
        img = y[:, start:start + h * w].transpose(1, 2).unflatten(2, (h, w))
        img = F.conv2d(img, p.ffn_dw.weight, p.ffn_dw_bias, padding=1, groups=img.shape[1])
        parts.append(img.flatten(2).transpose(1, 2))
        start += h * w
    return p.ffn_fc2(F.gelu(torch.cat(parts, 1)))


def extractor_forward(p: Extractor, query, ref_pts, feat, feat_shape, shapes_3l):
    query = query + ms_deform_attn(p.attn, p.query_norm(query), ref_pts, p.feat_norm(feat),
                                   [feat_shape])
    return query + _conv_ffn(p, p.ffn_norm(query), shapes_3l)


class InteractionBlock(nn.Module):
    def __init__(self, dim: int, heads: int, n_points: int, extra: bool, generator=None):
        super().__init__()
        self.extractor = Extractor(dim, heads, n_points, generator=generator)
        if extra:
            self.extra_extractors = nn.ModuleList(
                Extractor(dim, heads, n_points, generator=generator) for _ in range(2))


class Adapter(nn.Module):
    """The adapter's parameters (the JAX package's ``init_adapter_params``
    tree, leaf for leaf), fp32 on ``device`` (``cuda`` unless named)."""

    def __init__(self, cfg: StreamformerConfig, conv_inplane: int = 64,
                 deform_num_heads: int = 12, n_points: int = 4,
                 interaction_indexes=INTERACTION_INDEXES, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        d = cfg.hidden_size
        n = len(interaction_indexes)
        self.deform_num_heads, self.n_points = deform_num_heads, n_points
        self.interaction_indexes = [list(r) for r in interaction_indexes]
        self.level_embed = nn.Parameter(torch.zeros(3, d))
        self.spm = SpatialPriorModule(conv_inplane, d, generator)
        self.interactions = nn.ModuleList(
            InteractionBlock(d, deform_num_heads, n_points, i == n - 1, generator)
            for i in range(n))
        self.up = nn.ConvTranspose2d(d, d, 2, stride=2)
        with torch.no_grad():
            self.up.weight.normal_(0.0, 0.02, generator=generator)
            self.up.bias.zero_()
        self.norm1, self.norm2, self.norm3, self.norm4 = (Norm(d) for _ in range(4))
        self.to(enc.resolve_device(device))


@torch.no_grad()
def backbone_features(adapter: Adapter, backbone: enc.StreamformerEncoder,
                      pixel_values: torch.Tensor) -> List[torch.Tensor]:
    """The frozen backbone's tokens after each interaction block's last
    layer, (B*T, N, D) each: ``embed`` and ``layer_forward`` without a
    graph (kernels B and C on the card, L times a clip in all)."""
    cfg = backbone.cfg
    b, t = pixel_values.shape[:2]
    x = enc.embed(backbone, pixel_values)
    feats = []
    for lo, hi in adapter.interaction_indexes:
        for li in range(lo, hi + 1):
            x = enc.layer_forward(backbone.encoder.layer[li], x, cfg)
        feats.append(x.reshape(b * t, -1, cfg.hidden_size).float())
    return feats


def adapter_forward(adapter: Adapter, backbone: enc.StreamformerEncoder,
                    pixel_values: torch.Tensor, feats: Optional[List[torch.Tensor]] = None
                    ) -> Dict[str, torch.Tensor]:
    """pixel_values (B, T, 3, H, W) -> {res2..res5}: NHWC features at
    strides 4, 8, 16 and 32, leading dim B*T (reference forward
    :596-681). ``feats``, the clip's ``backbone_features``, spares a second
    backbone pass over the same clip (the backbone is frozen)."""
    cfg = backbone.cfg
    b, t, _, h, w = pixel_values.shape
    hp, wp = h // cfg.patch_size, w // cfg.patch_size
    d = cfg.hidden_size
    px = pixel_values.to(adapter.level_embed.device, torch.float32)
    c1, c2, c3, c4 = spm_forward(adapter.spm, px.reshape(b * t, 3, h, w))
    c = torch.cat([c2 + adapter.level_embed[0], c3 + adapter.level_embed[1],
                   c4 + adapter.level_embed[2]], 1)
    shapes_3l = [(h // 8, w // 8), (hp, wp), (h // 32, w // 32)]
    ref_pts = get_reference_points(shapes_3l, c.device).expand(b * t, -1, -1, -1)

    if feats is None:
        feats = backbone_features(adapter, backbone, pixel_values)
    for block, feat in zip(adapter.interactions, feats):
        extractors = [block.extractor] + list(getattr(block, "extra_extractors", []))
        for ex in extractors:
            c = extractor_forward(ex, c, ref_pts, feat, (hp, wp), shapes_3l)

    s2, s3 = (h // 8) * (w // 8), hp * wp
    c2o = c[:, :s2].reshape(b * t, h // 8, w // 8, d)
    c3o = c[:, s2:s2 + s3].reshape(b * t, hp, wp, d)
    c4o = c[:, s2 + s3:].reshape(b * t, h // 32, w // 32, d)
    # transposed-conv upsample of c2 to 1/4, plus the stem's c1
    up = F.conv_transpose2d(c2o.permute(0, 3, 1, 2), adapter.up.weight, adapter.up.bias, stride=2)
    c1o = up.permute(0, 2, 3, 1) + c1

    # the ViT features added back at each scale
    outs = [f.reshape(b * t, hp, wp, d) for f in feats]
    outs = outs + [outs[-1]] * (4 - len(outs))  # fewer blocks than the canonical 4
    x1, x2, x3, x4 = outs[:4]
    c1o = c1o + resize(x1, (h // 4, w // 4))
    c2o = c2o + resize(x2, (h // 8, w // 8))
    c3o = c3o + x3
    c4o = c4o + resize(x4, (h // 32, w // 32))

    return {"res2": _bn(c1o, adapter.norm1, -1), "res3": _bn(c2o, adapter.norm2, -1),
            "res4": _bn(c3o, adapter.norm3, -1), "res5": _bn(c4o, adapter.norm4, -1)}
