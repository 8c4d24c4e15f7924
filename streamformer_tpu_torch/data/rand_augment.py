"""RandAugment for video batches on the device: the port of the JAX
package's ``data/rand_augment.py``.

The policy is the JAX package's (itself the reference's timm port): the op
set, the magnitude mapping and the config string
(``rand-m7-n4-mstd0.5-inc1``). Each layer's op is drawn once per batch, as
the JAX loader draws it outside its vmap, and applied as one batched call;
each sample draws its own magnitude jitter, apply flag and sign from its own
generator, and keeps them across its frames.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence

import torch

from streamformer_tpu_torch.data import transforms as T

_MAX_LEVEL = 10.0

# the default op set (the reference's _RAND_TRANSFORMS)
RAND_TRANSFORMS = [
    "AutoContrast",
    "Equalize",
    "Invert",
    "Rotate",
    "Posterize",
    "Solarize",
    "SolarizeAdd",
    "Color",
    "Contrast",
    "Brightness",
    "Sharpness",
    "ShearX",
    "ShearY",
    "TranslateXRel",
    "TranslateYRel",
]


def _signed(v: torch.Tensor, negate) -> torch.Tensor:
    return torch.where(torch.as_tensor(negate, dtype=torch.bool).expand(v.shape), -v, v)


def _apply_op(name: str, x: torch.Tensor, level, negate, hparams: Dict) -> torch.Tensor:
    """x: (B, T, H, W, C) float [0, 255]; ``level`` in [0, 10] and
    ``negate`` (the sign draw) per sample (scalars, sequences or (B,)
    tensors). The per-sample parameters are computed on the host and go to
    the ops as (B,) tensors."""
    m = torch.as_tensor(level, dtype=torch.float32).cpu().reshape(-1).expand(x.shape[0]) / _MAX_LEVEL
    inc = hparams.get("inc", True)
    if name == "AutoContrast":
        return T.autocontrast(x)
    if name == "Equalize":
        return T.equalize(x)
    if name == "Invert":
        return T.invert(x)
    if name == "Rotate":
        return T.rotate(x, _signed(m * 30.0, negate))
    if name == "Posterize":
        # timm increasing: 4 - int(level / max * 4) bits removed -> 4..8 kept
        steps = torch.floor(m * 4).to(torch.int64)
        return T.posterize(x, 8 - steps if inc else steps + 4)
    if name == "Solarize":
        return T.solarize(x, 256.0 - m * 256.0 if inc else m * 256.0)
    if name == "SolarizeAdd":
        return T.solarize_add(x, m * 110.0)
    if name == "Color":
        return T.adjust_saturation(x, 1.0 + _signed(m * 0.9, negate))
    if name == "Contrast":
        return T.adjust_contrast(x, 1.0 + _signed(m * 0.9, negate))
    if name == "Brightness":
        return T.adjust_brightness(x, 1.0 + _signed(m * 0.9, negate))
    if name == "Sharpness":
        return T.adjust_sharpness(x, 1.0 + _signed(m * 0.9, negate))
    if name == "ShearX":
        return T.shear_x(x, _signed(m * 0.3, negate))
    if name == "ShearY":
        return T.shear_y(x, _signed(m * 0.3, negate))
    if name == "TranslateXRel":
        return T.translate_x(x, _signed(m * 0.45, negate) * x.shape[3])
    if name == "TranslateYRel":
        return T.translate_y(x, _signed(m * 0.45, negate) * x.shape[2])
    raise ValueError(name)


def parse_config(config_str: str) -> Dict:
    """Parse ``rand-m7-n4-mstd0.5-inc1`` (the reference's
    rand_augment_transform)."""
    parts = config_str.split("-")
    if parts[0] != "rand":
        raise ValueError(f"not a RandAugment config: {config_str!r}")
    cfg = {"magnitude": 10.0, "num_layers": 2, "mstd": 0.0, "inc": False, "p": 0.5}
    for p in parts[1:]:
        m = re.match(r"([a-z]+)([0-9.]+)", p)
        if not m:
            continue
        key, val = m.group(1), float(m.group(2))
        if key == "m":
            cfg["magnitude"] = val
        elif key == "n":
            cfg["num_layers"] = int(val)
        elif key == "mstd":
            cfg["mstd"] = val
        elif key == "inc":
            cfg["inc"] = bool(val)
        elif key == "p":
            cfg["p"] = val
    return cfg


def draw_ops(gen: torch.Generator, config_str: str, ops: Optional[List[str]] = None) -> List[int]:
    """The batch's op of each layer: indices into ``ops``, uniform with
    replacement."""
    n = len(ops or RAND_TRANSFORMS)
    layers = parse_config(config_str)["num_layers"]
    return [int(v) for v in torch.randint(0, n, (layers,), generator=gen)]


def draw_layers(gen: torch.Generator, config_str: str) -> List[Dict]:
    """One sample's draws per layer: ``level`` (the magnitude jittered by
    N(0, mstd), clipped to [0, 10]), ``apply`` (with probability p) and
    ``negate`` (with probability 1/2)."""
    cfg = parse_config(config_str)
    out = []
    for _ in range(cfg["num_layers"]):
        mag = cfg["magnitude"]
        if cfg["mstd"] > 0:
            mag = mag + cfg["mstd"] * float(torch.randn((), generator=gen, dtype=torch.float64))
        out.append({"level": min(max(mag, 0.0), _MAX_LEVEL),
                    "apply": T.draw_bernoulli(gen, cfg["p"]),
                    "negate": T.draw_bernoulli(gen, 0.5)})
    return out


def rand_augment(x: torch.Tensor, op_indices: Sequence[int], layers: Sequence[Sequence[Dict]],
                 config_str: str = "rand-m7-n4-mstd0.5-inc1",
                 ops: Optional[List[str]] = None) -> torch.Tensor:
    """Apply RandAugment to a batch (B, T, H, W, C) uint8 or float -> float
    [0, 255]. ``op_indices``: the batch's op of each layer (``draw_ops``);
    ``layers[b]``: sample b's draws (``draw_layers``). A layer's op runs once,
    on the samples whose ``apply`` is set."""
    cfg = parse_config(config_str)
    ops = ops or RAND_TRANSFORMS
    hparams = {"inc": cfg["inc"]}
    x = x.float()
    for i, op in enumerate(op_indices):
        chosen = [b for b, draws in enumerate(layers) if draws[i]["apply"]]
        if not chosen:
            continue
        sel = T.host_to(chosen, x.device)
        out = _apply_op(ops[op], x.index_select(0, sel),
                        [layers[b][i]["level"] for b in chosen],
                        [layers[b][i]["negate"] for b in chosen], hparams)
        x = x.index_copy(0, sel, out)
    return x.clamp(0.0, 255.0)
