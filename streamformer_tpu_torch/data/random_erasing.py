"""RandomErasing for video batches on the device: the port of the JAX
package's ``data/random_erasing.py`` (pixel or constant mode, cube: one box
across a clip's frames).

Each sample draws from its own generator whether it is erased and its box
(area ratio in [min_area, max_area], aspect in [min_aspect, 1 / min_aspect],
clamped into the frame instead of retried, as the JAX package's); the
erased samples' noise comes from a generator seeded from the sample's own
seed on the clip's device, and the box is applied as a mask.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from streamformer_tpu_torch.data.transforms import host_to

Box = Optional[Tuple[int, int, int, int]]  # (i, j, eh, ew), None: not erased


def erasing_box(u: Sequence[float], ij: Tuple[int, int], h: int, w: int,
                min_area: float = 0.02, max_area: float = 1 / 3,
                min_aspect: float = 0.3) -> Tuple[int, int, int, int]:
    """The box (i, j, eh, ew) from two uniforms in [0, 1) (area fraction,
    log aspect) and a uniform corner (i, j) in the frame, pulled back so the
    box fits."""
    target = h * w * (min_area + (max_area - min_area) * u[0])
    lo, hi = math.log(min_aspect), math.log(1 / min_aspect)
    aspect = math.exp(lo + (hi - lo) * u[1])
    eh = int(min(max(round(math.sqrt(target * aspect)), 1), h - 1))
    ew = int(min(max(round(math.sqrt(target / aspect)), 1), w - 1))
    return min(ij[0], h - eh), min(ij[1], w - ew), eh, ew


def draw_erasing(gen: torch.Generator, h: int, w: int, probability: float = 0.25,
                 min_area: float = 0.02, max_area: float = 1 / 3,
                 min_aspect: float = 0.3) -> Box:
    """One sample's draw: its box, or None when it is not erased."""
    u = torch.rand(3, generator=gen, dtype=torch.float64).tolist()
    i = int(torch.randint(0, h, (), generator=gen))
    j = int(torch.randint(0, w, (), generator=gen))
    if not u[2] < probability:
        return None
    return erasing_box(u[:2], (i, j), h, w, min_area, max_area, min_aspect)


def region_mask(boxes: Sequence[Box], h: int, w: int, device) -> torch.Tensor:
    """(B, 1, H, W, 1) bool: inside sample b's box (nowhere for None)."""
    rows = host_to([[b[0], b[0] + b[2], b[1], b[1] + b[3]] if b else [0, 0, 0, 0]
                    for b in boxes], device)
    ys = torch.arange(h, device=device)[None, :, None]
    xs = torch.arange(w, device=device)[None, None, :]
    inside = ((ys >= rows[:, 0, None, None]) & (ys < rows[:, 1, None, None])
              & (xs >= rows[:, 2, None, None]) & (xs < rows[:, 3, None, None]))
    return inside[:, None, :, :, None]


def erasing_fill(x: torch.Tensor, boxes: Sequence[Box], seeds: Sequence[int],
                 mode: str = "pixel") -> torch.Tensor:
    """(B, T, H, W, C) fill values: standard normal noise of each erased
    sample from a generator on x's device seeded with its seed ("pixel"),
    or zeros ("const")."""
    if mode == "const":
        return torch.zeros_like(x)
    if mode != "pixel":
        raise ValueError(mode)
    fill = torch.zeros_like(x)
    for b, (box, seed) in enumerate(zip(boxes, seeds)):
        if box is not None:
            g = torch.Generator(device=x.device).manual_seed(int(seed))
            fill[b] = torch.randn(x.shape[1:], generator=g, device=x.device, dtype=x.dtype)
    return fill


def apply_erasing(x: torch.Tensor, boxes: Sequence[Box], fill: torch.Tensor) -> torch.Tensor:
    """Sample b's box replaced by its fill, in every frame (cube mode)."""
    return torch.where(region_mask(boxes, x.shape[2], x.shape[3], x.device), fill, x)


def random_erasing(gens: Sequence[torch.Generator], x: torch.Tensor, seeds: Sequence[int],
                   probability: float = 0.25, mode: str = "pixel") -> torch.Tensor:
    """Erase a random box of each sample with ``probability`` (x already
    normalized), one generator and one noise seed per sample."""
    boxes = [draw_erasing(g, x.shape[2], x.shape[3], probability) for g in gens]
    return apply_erasing(x, boxes, erasing_fill(x, boxes, seeds, mode))
