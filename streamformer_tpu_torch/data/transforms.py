"""Video transforms on the device, the port's own copy of what its streaming
consumers use from the JAX package's ``data/transforms.py``.

Clips are ``(T, H, W, C)`` uint8 or float tensors; every operation runs on
the clip's device. ``resize`` is ``jax.image.resize(..., "linear")``: a
triangle kernel with half-pixel centres, widened by the scale when an axis
shrinks (antialiasing, which ``F.interpolate`` does not do), computed as one
small matrix product per axis. The augmentations of the JAX module wait for
the training data slice (ROADMAP item 13).
"""

from __future__ import annotations

from typing import Tuple

import torch

IMAGENET_DEFAULT_MEAN = (0.485, 0.456, 0.406)
IMAGENET_DEFAULT_STD = (0.229, 0.224, 0.225)
# SigLIP / the reference's normalize(0.5)
SIGLIP_MEAN = (0.5, 0.5, 0.5)
SIGLIP_STD = (0.5, 0.5, 0.5)


def to_float(clip: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] -> float32 [0, 1]; a float clip becomes float32. The
    division is by a device tensor, a true division on the card too."""
    if clip.dtype == torch.uint8:
        return clip.float() / torch.tensor(255.0, device=clip.device)
    return clip.float()


def normalize(clip: torch.Tensor, mean=SIGLIP_MEAN, std=SIGLIP_STD) -> torch.Tensor:
    mean = torch.tensor(mean, dtype=torch.float32, device=clip.device)
    std = torch.tensor(std, dtype=torch.float32, device=clip.device)
    return (to_float(clip) - mean) / std


def to_model_input(clip: torch.Tensor) -> torch.Tensor:
    """(T, H, W, C) -> (T, C, H, W), the encoder's pixel_values layout."""
    return clip.permute(0, 3, 1, 2)


def linear_resize_weights(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    """(n_out, n_in) weights of a linear resize along one axis with
    half-pixel centres: a triangle kernel around each output sample, widened
    by the scale when the axis shrinks (antialiasing), rows normalized, which
    at the borders is the edge clamp. The matrix of
    ``jax.image.resize(..., "linear")`` in its compiled fp32 arithmetic:
    sample i sits at fp32((i + 0.5) * fp32(1 / scale) - 0.5), rounded once
    as XLA's fused multiply-add rounds it (two roundings put a sample of a
    224-wide output 1e-5 of a pixel away)."""
    inv_scale = float(torch.tensor(1.0 / (n_out / n_in), dtype=torch.float32))
    width = max(inv_scale, 1.0)
    half = torch.arange(n_out, device=device, dtype=torch.float32) + 0.5
    sample = (half.double() * inv_scale - 0.5).float()
    taps = torch.arange(n_in, device=device, dtype=torch.float32)
    w = (1.0 - (sample[:, None] - taps[None, :]).abs() / width).clamp_min(0.0)
    return w / w.sum(dim=1, keepdim=True)


def resize(clip: torch.Tensor, size: Tuple[int, int], method: str = "bilinear") -> torch.Tensor:
    """Resize every frame to (H, W); float32 out."""
    if method != "bilinear":
        raise NotImplementedError(f"resize method {method!r}: the port resizes bilinearly "
                                  "(ROADMAP slice 4, item 13)")
    x = to_float(clip)
    wy = linear_resize_weights(x.shape[1], size[0], x.device)
    wx = linear_resize_weights(x.shape[2], size[1], x.device)
    x = torch.einsum("oh,thwc->towc", wy, x)
    return torch.einsum("pw,towc->topc", wx, x)


def resize_short_side(clip: torch.Tensor, short: int, method: str = "bilinear") -> torch.Tensor:
    """Resize keeping the aspect ratio so that the short side is ``short``."""
    _, h, w, _ = clip.shape
    if h <= w:
        nh, nw = short, max(1, int(round(w * short / h)))
    else:
        nh, nw = max(1, int(round(h * short / w))), short
    return resize(clip, (nh, nw), method)


def center_crop(clip: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    _, h, w, _ = clip.shape
    th, tw = size
    i, j = (h - th) // 2, (w - tw) // 2
    return clip[:, i:i + th, j:j + tw, :]
