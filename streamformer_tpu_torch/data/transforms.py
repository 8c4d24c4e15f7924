"""Video transforms on the device: the port of the JAX package's
``data/transforms.py``.

Clips are ``(T, H, W, C)`` uint8 or float tensors; the resizes and crops
also take any leading axes. The augmentations run on batches ``(B, T, H, W,
C)``, each sample with parameters of its own, constant across its frames
(a video augmentation must be temporally consistent). Every random op comes
in two halves:

* a **draw** (``draw_*``) reads a ``torch.Generator`` on the host and
  returns a few Python scalars for one sample;
* an **apply** is deterministic and runs batched on the clip's device, its
  per-sample parameters a scalar, a sequence or a ``(B,)`` tensor.

So an apply can be held against the JAX op given the JAX op's parameters,
and a batch augments the same on the card and on the CPU.

``resize`` is ``jax.image.resize``: a triangle (``"bilinear"``) or Keys
cubic (``"bicubic"``, a = -0.5) kernel with half-pixel centres, widened by
the scale when an axis shrinks (antialiasing, which ``F.interpolate`` does
not do), computed as one small matrix product per axis; ``"nearest"`` picks
``floor((i + 0.5) * in / out)``. ``resized_crop`` is
``jax.image.scale_and_translate(..., "linear")`` over a fractional box, one
weight matrix per sample and axis. The colour ops keep PIL's semantics on
the 0-255 scale; the geometric ops are inverse warps with bilinear taps and
fill 128, written as gathers with explicit border masks. ``equalize`` counts
its histograms in int64 (``scatter_add_``), so a rerun is bit-equal on the
card.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence, Tuple

import numpy as np
import torch

IMAGENET_DEFAULT_MEAN = (0.485, 0.456, 0.406)
IMAGENET_DEFAULT_STD = (0.229, 0.224, 0.225)
# SigLIP / the reference's normalize(0.5)
SIGLIP_MEAN = (0.5, 0.5, 0.5)
SIGLIP_STD = (0.5, 0.5, 0.5)


def host_to(v, device, dtype=None) -> torch.Tensor:
    """A host value (a scalar, a sequence, an array or a tensor) as a tensor
    on ``device``, copied without a stream synchronisation: a blocking copy
    to the card waits for all the work queued before it."""
    return torch.as_tensor(v, dtype=dtype).to(device, non_blocking=True)


def pinned_to(array, device) -> torch.Tensor:
    """A host array as a tensor on ``device``: staged in pinned memory for
    the card, so the copy is truly asynchronous; on the CPU it shares the
    array's memory."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if torch.device(device).type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def to_float(clip: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] -> float32 [0, 1]; a float clip becomes float32. The
    division is by a device tensor, a true division on the card too."""
    if clip.dtype == torch.uint8:
        return clip.float() / host_to(255.0, clip.device)
    return clip.float()


def normalize(clip: torch.Tensor, mean=SIGLIP_MEAN, std=SIGLIP_STD) -> torch.Tensor:
    mean = host_to(mean, clip.device, torch.float32)
    std = host_to(std, clip.device, torch.float32)
    return (to_float(clip) - mean) / std


def to_model_input(clip: torch.Tensor) -> torch.Tensor:
    """(..., T, H, W, C) -> (..., T, C, H, W), the encoder's pixel_values
    layout."""
    return clip.movedim(-1, -3)


# ---------------------------------------------------------------------------
# resampling weights: jax.image's compute_weight_mat in its fp32 arithmetic
# ---------------------------------------------------------------------------


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return (1.0 - x).clamp_min(0.0)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic convolution kernel, a = -0.5, on x = |distance| >= 0."""
    near = ((1.5 * x - 2.5) * x) * x + 1.0
    far = ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0
    return torch.where(x >= 2.0, torch.zeros_like(x), torch.where(x >= 1.0, far, near))


_KERNELS = {"bilinear": _triangle, "bicubic": _keys_cubic}


def resample_weights(n_in: int, n_out: int, inv_scale: torch.Tensor, translation: torch.Tensor,
                     kernel: Callable[[torch.Tensor], torch.Tensor] = _triangle) -> torch.Tensor:
    """(B, n_out, n_in) weights of ``scale_and_translate`` along one axis for
    B samples, each with its fp32 ``1 / scale`` and translation ((B,)
    tensors): output sample i reads the input at
    fp32((i + 0.5) * inv_scale - translation * inv_scale - 0.5), rounded once
    as XLA's fused multiply-add rounds it; the kernel is widened by
    ``inv_scale`` where the axis shrinks (antialiasing); each row is
    normalized, and zeroed where its sample lies outside the input."""
    dev = inv_scale.device
    inv64 = inv_scale.double()[:, None]
    half = torch.arange(n_out, device=dev, dtype=torch.float32).double()[None, :] + 0.5
    sample = (half * inv64 - translation.double()[:, None] * inv64 - 0.5).float()
    width = inv_scale.clamp_min(1.0)[:, None, None]
    taps = torch.arange(n_in, device=dev, dtype=torch.float32)
    w = kernel((sample[:, :, None] - taps).abs() / width)
    total = w.sum(dim=2, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    w = torch.where(total.abs() > eps, w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[:, :, None], w, torch.zeros_like(w))


def linear_resize_weights(n_in: int, n_out: int, device: torch.device,
                          kernel: Callable[[torch.Tensor], torch.Tensor] = _triangle
                          ) -> torch.Tensor:
    """(n_out, n_in) weights of ``jax.image.resize`` along one axis: no
    translation, 1 / scale the fp32 of 1 / (n_out / n_in)."""
    inv = host_to([1.0 / (n_out / n_in)], device, torch.float32)
    return resample_weights(n_in, n_out, inv, torch.zeros_like(inv), kernel)[0]


def _nearest_index(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    """``jax.image.resize(..., "nearest")``: floor(fp32((i + 0.5) * n_in) / n_out)."""
    pos = (torch.arange(n_out, device=device, dtype=torch.float32) + 0.5) * n_in
    return torch.floor(pos / host_to(float(n_out), device)).long()


def resize(clip: torch.Tensor, size: Tuple[int, int], method: str = "bilinear") -> torch.Tensor:
    """Resize every frame of a (..., H, W, C) clip to (H, W); float32 out.
    ``method`` is ``"bilinear"``, ``"bicubic"`` or ``"nearest"``, as the
    JAX package's ``resize`` takes them."""
    x = to_float(clip)
    h, w = x.shape[-3], x.shape[-2]
    if method == "nearest":
        if size[0] != h:
            x = x.index_select(-3, _nearest_index(h, size[0], x.device))
        if size[1] != w:
            x = x.index_select(-2, _nearest_index(w, size[1], x.device))
        return x
    if method not in _KERNELS:
        raise ValueError(f"resize method {method!r}: 'bilinear', 'bicubic' or 'nearest'")
    kernel = _KERNELS[method]
    if size[0] != h:  # an axis of unchanged size is left as it is, as jax.image does
        x = torch.einsum("oh,...hwc->...owc", linear_resize_weights(h, size[0], x.device, kernel), x)
    if size[1] != w:
        x = torch.einsum("pw,...hwc->...hpc", linear_resize_weights(w, size[1], x.device, kernel), x)
    return x


def resize_short_side(clip: torch.Tensor, short: int, method: str = "bilinear") -> torch.Tensor:
    """Resize keeping the aspect ratio so that the short side is ``short``."""
    h, w = clip.shape[-3], clip.shape[-2]
    if h <= w:
        nh, nw = short, max(1, int(round(w * short / h)))
    else:
        nh, nw = max(1, int(round(h * short / w))), short
    return resize(clip, (nh, nw), method)


def center_crop(clip: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    h, w = clip.shape[-3], clip.shape[-2]
    th, tw = size
    i, j = (h - th) // 2, (w - tw) // 2
    return clip[..., i:i + th, j:j + tw, :]


# ---------------------------------------------------------------------------
# per-sample parameters
# ---------------------------------------------------------------------------


def _col(v, x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """A per-sample value (a scalar, a sequence or a (B,) tensor) as a
    (B, 1, ..., 1) tensor on x's device that broadcasts over a sample."""
    t = host_to(v, x.device, dtype)
    if t.ndim == 0:
        t = t.expand(x.shape[0])
    return t.reshape(-1, *([1] * (x.ndim - 1)))


def _vec(v, x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """A per-sample value as a (B,) tensor on x's device."""
    t = host_to(v, x.device, dtype)
    return t.expand(x.shape[0]) if t.ndim == 0 else t


def _uniform(gen: torch.Generator, lo: float = 0.0, hi: float = 1.0) -> float:
    return lo + (hi - lo) * float(torch.rand((), generator=gen, dtype=torch.float64))


def draw_bernoulli(gen: torch.Generator, p: float) -> bool:
    return float(torch.rand((), generator=gen, dtype=torch.float64)) < p


# ---------------------------------------------------------------------------
# crops and flips
# ---------------------------------------------------------------------------


def crop_at(x: torch.Tensor, i, j, size: Tuple[int, int]) -> torch.Tensor:
    """(B, T, H, W, C): sample b cropped at (i[b], j[b]) to ``size``; the
    offsets are clamped into the frame as ``lax.dynamic_slice`` clamps them."""
    h, w = x.shape[2], x.shape[3]
    ii = [min(max(int(v), 0), h - size[0]) for v in torch.as_tensor(i).reshape(-1).tolist()]
    jj = [min(max(int(v), 0), w - size[1]) for v in torch.as_tensor(j).reshape(-1).tolist()]
    if len(ii) == 1:
        ii = ii * x.shape[0]
    if len(jj) == 1:
        jj = jj * x.shape[0]
    return torch.stack([x[b, :, ii[b]:ii[b] + size[0], jj[b]:jj[b] + size[1]]
                        for b in range(x.shape[0])])


def draw_crop(gen: torch.Generator, h: int, w: int, size: Tuple[int, int]) -> Tuple[int, int]:
    """A uniform crop offset (i, j) of ``size`` inside an (h, w) frame."""
    i = int(torch.randint(0, h - size[0] + 1, (), generator=gen))
    j = int(torch.randint(0, w - size[1] + 1, (), generator=gen))
    return i, j


def random_crop(gens: Sequence[torch.Generator], x: torch.Tensor, size: Tuple[int, int]
                ) -> torch.Tensor:
    """A crop of ``size`` at a uniform offset, one generator per sample."""
    ij = [draw_crop(g, x.shape[2], x.shape[3], size) for g in gens]
    return crop_at(x, [a for a, _ in ij], [b for _, b in ij], size)


def horizontal_flip(x: torch.Tensor) -> torch.Tensor:
    return x.flip(-2)


def flip_where(x: torch.Tensor, flip) -> torch.Tensor:
    """Flip sample b horizontally where ``flip[b]`` is true."""
    return torch.where(_col(flip, x, torch.bool), horizontal_flip(x), x)


def random_horizontal_flip(gens: Sequence[torch.Generator], x: torch.Tensor, p: float = 0.5
                           ) -> torch.Tensor:
    return flip_where(x, [draw_bernoulli(g, p) for g in gens])


def resized_crop_box(u: Sequence[float], h: int, w: int, scale=(0.08, 1.0),
                     ratio=(3.0 / 4.0, 4.0 / 3.0)) -> Tuple[float, float, float, float]:
    """The box (i, j, ch, cw) of an Inception-style resized crop from four
    uniforms in [0, 1): area fraction, log aspect, and the box's place. The
    box is clamped into the frame (no retry loop), as the JAX package's."""
    area = h * w * (scale[0] + (scale[1] - scale[0]) * u[0])
    log_lo, log_hi = math.log(ratio[0]), math.log(ratio[1])
    aspect = math.exp(log_lo + (log_hi - log_lo) * u[1])
    cw = min(max(math.sqrt(area * aspect), 8.0), float(w))
    ch = min(max(math.sqrt(area / aspect), 8.0), float(h))
    return u[2] * (h - ch), u[3] * (w - cw), ch, cw


def draw_resized_crop(gen: torch.Generator, h: int, w: int, scale=(0.08, 1.0),
                      ratio=(3.0 / 4.0, 4.0 / 3.0)) -> Tuple[float, float, float, float]:
    return resized_crop_box([_uniform(gen) for _ in range(4)], h, w, scale, ratio)


def resized_crop(x: torch.Tensor, boxes: Sequence[Tuple[float, float, float, float]],
                 size: Tuple[int, int]) -> torch.Tensor:
    """(B, T, H, W, C) -> (B, T, size, C) float: sample b's box (i, j, ch,
    cw) resampled to ``size`` by ``jax.image.scale_and_translate(...,
    "linear")``: scale = size / box, translation = -box offset * scale, all
    in fp32."""
    x = to_float(x)
    dev = x.device
    box = host_to(boxes, dev, torch.float32).reshape(-1, 4)
    i, j, ch, cw = box.unbind(1)
    sy = host_to(float(size[0]), dev) / ch
    sx = host_to(float(size[1]), dev) / cw
    one = host_to(1.0, dev)
    wy = resample_weights(x.shape[2], size[0], one / sy, -i * sy)
    wx = resample_weights(x.shape[3], size[1], one / sx, -j * sx)
    x = torch.einsum("boh,bthwc->btowc", wy, x)
    return torch.einsum("bpw,btowc->btopc", wx, x)


def random_resized_crop(gens: Sequence[torch.Generator], x: torch.Tensor,
                        size: Tuple[int, int], scale=(0.08, 1.0),
                        ratio=(3.0 / 4.0, 4.0 / 3.0)) -> torch.Tensor:
    boxes = [draw_resized_crop(g, x.shape[2], x.shape[3], scale, ratio) for g in gens]
    return resized_crop(x, boxes, size)


def random_short_side_scale_jitter(x: torch.Tensor, min_size: int, max_size: int
                                   ) -> torch.Tensor:
    """Scale jitter, then the caller crops: as the JAX package, a resize of
    the short side to ``max_size`` (static shapes), no draw."""
    return resize_short_side(x, max_size)


# ---------------------------------------------------------------------------
# colour ops (PIL ImageEnhance semantics, on [0, 255] floats)
# ---------------------------------------------------------------------------


def _blend(a: torch.Tensor, b: torch.Tensor, factor) -> torch.Tensor:
    """PIL ImageEnhance blend: out = b + factor * (a - b), clamped."""
    return (b + _col(factor, a) * (a - b)).clamp(0.0, 255.0)


def _gray_luma(x: torch.Tensor) -> torch.Tensor:
    """PIL convert('L') luma (ITU-R 601-2): L = 0.299 R + 0.587 G + 0.114 B."""
    return (x[..., 0] * 0.299 + x[..., 1] * 0.587 + x[..., 2] * 0.114)[..., None]


def adjust_brightness(x: torch.Tensor, factor) -> torch.Tensor:
    return _blend(x, torch.zeros_like(x), factor)


def adjust_contrast(x: torch.Tensor, factor) -> torch.Tensor:
    """Blend with the mean of each frame's rounded grayscale."""
    mean = torch.round(_gray_luma(x)).mean(dim=(-3, -2, -1), keepdim=True)
    return _blend(x, mean.expand_as(x), factor)


def adjust_saturation(x: torch.Tensor, factor) -> torch.Tensor:
    return _blend(x, _gray_luma(x).expand_as(x), factor)


def adjust_sharpness(x: torch.Tensor, factor) -> torch.Tensor:
    """Blend with the 3x3 smoothing [[1, 1, 1], [1, 5, 1], [1, 1, 1]] / 13 of
    the interior; PIL leaves the 1-pixel border unfiltered. The sums are
    shifted slices (a convolution's algorithm may change between runs)."""
    h, w = x.shape[-3], x.shape[-2]
    k = host_to(1.0 / 13.0, x.device)
    sm = x.clone()
    if h > 2 and w > 2:
        acc = None
        for dy in range(3):
            for dx in range(3):
                tap = x[..., dy:dy + h - 2, dx:dx + w - 2, :] * (k * (5.0 if dy == dx == 1 else 1.0))
                acc = tap if acc is None else acc + tap
        sm[..., 1:-1, 1:-1, :] = acc
    return _blend(x, sm, factor)


def invert(x: torch.Tensor) -> torch.Tensor:
    return 255.0 - x


def posterize(x: torch.Tensor, bits) -> torch.Tensor:
    """Keep the top ``bits`` bits of each uint8 value. Integer-exact."""
    xi = x.to(torch.uint8)
    shift = (8 - _col(bits, x, torch.int64)).to(torch.uint8)
    return torch.bitwise_left_shift(torch.bitwise_right_shift(xi, shift), shift).float()


def solarize(x: torch.Tensor, threshold) -> torch.Tensor:
    return torch.where(x >= _col(threshold, x), 255.0 - x, x)


def solarize_add(x: torch.Tensor, add, threshold=128.0) -> torch.Tensor:
    return torch.where(x < _col(threshold, x), (x + _col(add, x)).clamp(0.0, 255.0), x)


def autocontrast(x: torch.Tensor) -> torch.Tensor:
    """Per-frame per-channel min/max stretch (PIL autocontrast, cutoff 0)."""
    lo = x.amin(dim=(-3, -2), keepdim=True)
    hi = x.amax(dim=(-3, -2), keepdim=True)
    scale = 255.0 / (hi - lo).clamp_min(1e-5)
    out = ((x - lo) * scale).clamp(0.0, 255.0)
    return torch.where(hi > lo, out, x)


def equalize(x: torch.Tensor) -> torch.Tensor:
    """Per-frame per-channel histogram equalization with PIL's exact LUT:
    step = (pixels - last bin's count) // 255, lut[i] = (cumsum[:i] + step //
    2) // step; the identity where step is 0. (..., H, W, C)."""
    *lead, h, w, c = x.shape
    xi = x.to(torch.int64)
    flat = xi.reshape(-1, h * w, c).transpose(1, 2).reshape(-1, h * w)  # (frames * C, H * W)
    hist = torch.zeros(flat.shape[0], 256, dtype=torch.int64, device=x.device)
    hist.scatter_add_(1, flat, torch.ones((), dtype=torch.int64, device=x.device).expand_as(flat))
    bins = torch.arange(256, device=x.device)
    last_bin = torch.where(hist > 0, bins, torch.full_like(bins, -1)).amax(dim=1, keepdim=True)
    step = (hist.sum(dim=1, keepdim=True) - hist.gather(1, last_bin)) // 255
    cum = torch.cumsum(hist, dim=1) - hist
    lut = ((cum + step // 2) // step.clamp_min(1)).clamp(0, 255)
    out = torch.where(step == 0, flat, lut.gather(1, flat))
    return out.reshape(-1, c, h * w).transpose(1, 2).reshape(x.shape).float()


# ---------------------------------------------------------------------------
# geometric ops (inverse warps with bilinear taps, PIL's fill 128)
# ---------------------------------------------------------------------------


def _gather_pixels(x: torch.Tensor, yi: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """x (B, T, H, W, C); yi, xi (B, H', W') int64 in range -> (B, T, H', W', C)."""
    b, t, h, w, c = x.shape
    hd, wd = yi.shape[1], yi.shape[2]
    idx = (yi * w + xi).reshape(b, 1, hd * wd, 1).expand(b, t, hd * wd, c)
    return x.reshape(b, t, h * w, c).gather(2, idx).reshape(b, t, hd, wd, c)


def _affine_warp(x: torch.Tensor, matrix: torch.Tensor, fill: float = 128.0) -> torch.Tensor:
    """PIL-convention inverse affine, per sample: ``matrix`` (B, 6) = (a, b,
    c, d, e, f), src = (a dx + b dy + c, d dx + e dy + f) for each output
    pixel, bilinear, a tap outside the frame reading ``fill``."""
    _, _, h, w, _ = x.shape
    ys, xs = torch.meshgrid(torch.arange(h, device=x.device, dtype=torch.float32),
                            torch.arange(w, device=x.device, dtype=torch.float32), indexing="ij")
    a, b_, cc, d, e, f = (m[:, None, None] for m in matrix.unbind(1))
    sx = a * xs + b_ * ys + cc
    sy = d * xs + e * ys + f
    x0, y0 = torch.floor(sx), torch.floor(sy)
    wx, wy = (sx - x0)[:, None, :, :, None], (sy - y0)[:, None, :, :, None]

    def sample(xf, yf):
        inb = ((xf >= 0) & (xf < w) & (yf >= 0) & (yf < h))[:, None, :, :, None]
        v = _gather_pixels(x, yf.clamp(0, h - 1).long(), xf.clamp(0, w - 1).long())
        return torch.where(inb, v, host_to(fill, x.device))

    return (sample(x0, y0) * (1 - wx) * (1 - wy) + sample(x0 + 1, y0) * wx * (1 - wy)
            + sample(x0, y0 + 1) * (1 - wx) * wy + sample(x0 + 1, y0 + 1) * wx * wy)


def _lerp_taps(src: torch.Tensor, n: int):
    """Two bilinear taps of fractional positions ``src`` on an axis of n:
    (clamped index, weight) twice; a tap off the axis weighs 0."""
    p0 = torch.floor(src)
    frac = src - p0
    w0 = (1.0 - frac) * ((p0 >= 0) & (p0 < n))
    w1 = frac * ((p0 + 1 >= 0) & (p0 + 1 < n))
    return p0.clamp(0, n - 1).long(), w0, (p0 + 1).clamp(0, n - 1).long(), w1


def _resample_rows(x: torch.Tensor, src_x: torch.Tensor, fill: float) -> torch.Tensor:
    """Per-row 1-D bilinear resample along W. src_x (B, H, W_dst): the
    fractional source x of each output pixel; the weight a tap loses off the
    frame goes to ``fill``."""
    b, t, h, w, c = x.shape
    i0, w0, i1, w1 = _lerp_taps(src_x, w)
    rows = torch.arange(h, device=x.device)[None, :, None].expand_as(i0)
    v0, v1 = _gather_pixels(x, rows, i0), _gather_pixels(x, rows, i1)
    w0, w1 = w0[:, None, :, :, None], w1[:, None, :, :, None]
    return v0 * w0 + v1 * w1 + fill * (1.0 - (w0 + w1))


def _resample_cols(x: torch.Tensor, src_y: torch.Tensor, fill: float) -> torch.Tensor:
    """Per-column 1-D bilinear resample along H. src_y (B, W, H_dst)."""
    b, t, h, w, c = x.shape
    i0, w0, i1, w1 = (v.transpose(1, 2) for v in _lerp_taps(src_y, h))  # (B, H_dst, W)
    cols = torch.arange(w, device=x.device)[None, None, :].expand_as(i0)
    v0, v1 = _gather_pixels(x, i0, cols), _gather_pixels(x, i1, cols)
    w0, w1 = w0[:, None, :, :, None], w1[:, None, :, :, None]
    return v0 * w0 + v1 * w1 + fill * (1.0 - (w0 + w1))


def _grid(n: int, x: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, device=x.device, dtype=torch.float32)


def shear_x(x: torch.Tensor, magnitude, fill: float = 128.0) -> torch.Tensor:
    h, w = x.shape[2], x.shape[3]
    m = _vec(magnitude, x)[:, None, None]
    return _resample_rows(x, _grid(w, x)[None, None, :] + m * _grid(h, x)[None, :, None], fill)


def shear_y(x: torch.Tensor, magnitude, fill: float = 128.0) -> torch.Tensor:
    h, w = x.shape[2], x.shape[3]
    m = _vec(magnitude, x)[:, None, None]
    return _resample_cols(x, _grid(h, x)[None, None, :] + m * _grid(w, x)[None, :, None], fill)


def translate_x(x: torch.Tensor, pixels, fill: float = 128.0) -> torch.Tensor:
    h, w = x.shape[2], x.shape[3]
    src = _grid(w, x)[None, None, :] + _vec(pixels, x)[:, None, None]
    return _resample_rows(x, src.expand(-1, h, -1), fill)


def translate_y(x: torch.Tensor, pixels, fill: float = 128.0) -> torch.Tensor:
    h, w = x.shape[2], x.shape[3]
    src = _grid(h, x)[None, None, :] + _vec(pixels, x)[:, None, None]
    return _resample_cols(x, src.expand(-1, w, -1), fill)


def rotate(x: torch.Tensor, degrees, fill: float = 128.0) -> torch.Tensor:
    """Rotate about the frame's centre, counter-clockwise for positive
    degrees (PIL's convention: the inverse map turns by -degrees). The
    matrix is computed on the host in fp32, so the card and the CPU warp
    with the same coefficients (their cos and sin differ in the last bit)."""
    h, w = x.shape[2], x.shape[3]
    deg = torch.as_tensor(degrees, dtype=torch.float32).cpu().reshape(-1).expand(x.shape[0])
    theta = torch.deg2rad(-deg)
    cos, sin = torch.cos(theta), torch.sin(theta)
    cx, cy = w / 2.0 - 0.5, h / 2.0 - 0.5
    a, b_, d, e = cos, sin, -sin, cos
    cc = cx - a * cx - b_ * cy
    f = cy - d * cx - e * cy
    return _affine_warp(x, host_to(torch.stack([a, b_, cc, d, e, f], dim=1), x.device), fill)
