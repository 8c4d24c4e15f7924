"""Optimizer factory: decay / no-decay groups, layer-wise lr decay (LLRD),
schedules, trainable masks.

Port of the JAX package's ``train/optim.py``, whose optax chain is

    clip_by_global_norm -> adam | trace | lion -> add_decayed_weights
                        -> LLRD scale -> * -lr(count)

inside a ``multi_transform`` that zeroes the updates of frozen leaves.
``create_optimizer`` builds the same update, number for number, on
``torch.optim``: one parameter group per (layer id, decayed or not); before
every step each group's ``lr`` is set to ``lr_schedule(count) * its LLRD
scale`` and its weight decay to ``wd_schedule(count)``, with ``count`` the
number of updates applied so far, so a schedule is read at the pre-update
count as ``optax.inject_hyperparams`` reads it. AdamW is
``torch.optim.AdamW`` (decoupled decay, eps outside the square root, as
optax's); SGD is ``torch.optim.SGD`` with momentum as optax's ``trace`` and
the decay applied decoupled, after the momentum; Lion is written out below,
torch has none. The global-norm clip sees the trainable leaves only, as it
does inside optax's ``multi_transform``. Frozen parameters are simply not
handed to the optimizer.

Names are the port's parameter names (``backbone.encoder.layer.3...``); the
decayed set and the layer ids are the images of the JAX package's under
``checkpoint.convert``'s name map, which ``tests/test_torch_optim.py`` holds
them to.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from streamformer_tpu_torch.parallel import sharding

Schedule = Callable[[int], float]
Named = Union[nn.Module, Dict[str, torch.Tensor], Iterable[Tuple[str, torch.Tensor]]]


def _named(params: Named) -> Dict[str, torch.Tensor]:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def weight_decay_mask(params: Named) -> Dict[str, bool]:
    """True where weight decay applies: the matrices and the embedding
    tables. The JAX package decays every leaf of rank >= 2; the port's MAP
    probe is stored (1, 1, D) where the JAX leaf is (D,), so it is excluded
    by name. Biases, LayerNorms, gates and the logit scale and bias are of
    rank <= 1 in both."""
    return {name: p.ndim >= 2 and not name.endswith("head.probe")
            for name, p in _named(params).items()}


def layer_id_of_name(name: str, num_layers: int) -> int:
    """LLRD layer id: the embeddings at 0, encoder layer i at i + 1,
    everything else (post-LN, MAP head, logit scale and bias) at
    ``num_layers + 1``. The text tower's layers count as layers and its
    embeddings as "everything else", as the JAX package's path rule has it."""
    parts = name.split(".")
    in_text = "text_model" in parts
    if "embeddings" in parts and not in_text:
        return 0
    for key in ("layer", "layers"):
        if key in parts:
            return int(parts[parts.index(key) + 1]) + 1
    return num_layers + 1


def layer_decay_scales(params: Named, num_layers: int, decay_rate: float) -> Dict[str, float]:
    """Per-parameter lr multiplier: ``decay_rate ** (num_layers + 1 - id)``."""
    return {name: decay_rate ** (num_layers + 1 - layer_id_of_name(name, num_layers))
            for name in _named(params)}


# ---------------------------------------------------------------------------
# schedules: plain functions of the update count, in optax's fp32 arithmetic
# ---------------------------------------------------------------------------

_f = np.float32


def _cosine_decay(count: int, init: float, decay_steps: int, alpha: float) -> float:
    """optax.cosine_decay_schedule(init, decay_steps, alpha)(count)."""
    frac = _f(min(count, decay_steps)) / _f(decay_steps)
    cosine = _f(0.5) * (_f(1.0) + np.cos(_f(np.pi) * frac, dtype=np.float32))
    return float(_f(init) * ((_f(1.0) - _f(alpha)) * cosine + _f(alpha)))


def cosine_lr_schedule(base_lr: float, min_lr: float, epochs: int, steps_per_epoch: int,
                       warmup_epochs: float = 0.0, warmup_steps: int = -1,
                       warmup_lr: float = 1e-6) -> Schedule:
    """Per-step cosine schedule with linear warm-up: ``warmup_lr`` ->
    ``base_lr`` over the warm-up steps, then a cosine to ``min_lr`` over the
    rest of ``epochs * steps_per_epoch``."""
    total = epochs * steps_per_epoch
    warm = warmup_steps if warmup_steps > 0 else int(warmup_epochs * steps_per_epoch)
    ramp = max(warm, 1)
    alpha = min_lr / max(base_lr, 1e-12)

    def schedule(count: int) -> float:
        count = int(count)
        if count < warm:
            frac = _f(1.0) - _f(min(max(count, 0), ramp)) / _f(ramp)
            return float((_f(warmup_lr) - _f(base_lr)) * frac + _f(base_lr))
        return _cosine_decay(count - warm, base_lr, max(total - warm, 1), alpha)

    return schedule


def cosine_wd_schedule(wd: float, wd_end: Optional[float], epochs: int,
                       steps_per_epoch: int) -> Schedule:
    if wd_end is None or wd_end == wd:
        return lambda count: wd
    total = max(epochs * steps_per_epoch, 1)
    alpha = wd_end / max(wd, 1e-12)
    return lambda count: _cosine_decay(int(count), wd, total, alpha)


def scale_lr(base_lr: float, total_batch_size: int, num_sample: int = 1) -> float:
    """Linear lr scaling rule."""
    return base_lr * total_batch_size * num_sample / 256.0


# ---------------------------------------------------------------------------
# trainable-parameter masks (freeze / LoRA policies), by parameter name
# ---------------------------------------------------------------------------


def trainable_mask_all(params: Named) -> Dict[str, bool]:
    return {name: True for name in _named(params)}


def trainable_mask_lora_spatial(params: Named) -> Dict[str, bool]:
    """Freeze the spatial attention's base qkv and output projections
    (weights and biases) of every encoder layer; their LoRA factors, the
    temporal attention and everything else train."""
    frozen = ("attention.attention.qkv.weight", "attention.attention.qkv.bias",
              "attention.output.dense.weight", "attention.output.dense.bias")

    def decide(name: str) -> bool:
        parts = name.split(".")
        if "layer" not in parts or "temporal_attention" in parts:
            return True
        return not name.endswith(frozen)

    return {name: decide(name) for name in _named(params)}


def trainable_mask_frozen_text(params: Named) -> Dict[str, bool]:
    return {name: "text_model" not in name.split(".") and not name.startswith("text.")
            for name in _named(params)}


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------


class Lion(torch.optim.Optimizer):
    """Lion as optax's ``scale_by_lion``: update = sign(b1 * mu + (1 - b1) * g),
    then mu <- b2 * mu + (1 - b2) * g; the step is ``p -= lr * (update +
    weight_decay * p)`` (decoupled decay)."""

    def __init__(self, params, lr: float = 1e-4, betas=(0.9, 0.99), weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["mu"] = torch.zeros_like(p)
                mu = state["mu"]
                update = (b1 * mu + (1 - b1) * p.grad).sign_()
                mu.mul_(b2).add_(p.grad, alpha=1 - b2)
                p.add_(update.add_(p, alpha=group["weight_decay"]), alpha=-group["lr"])


class ScheduledOptimizer:
    """A ``torch.optim`` optimizer driven by schedules of the update count.

    ``step()`` clips the gradients of its parameters by their global norm
    (if asked; ``clip_each_group`` clips each parameter group by its own
    norm, as a clip inside each branch of optax's ``multi_transform``
    does), sets every group's lr and weight decay from the schedules at
    ``count``, steps the inner optimizer and adds one to ``count``. A
    parameter without a gradient is stepped with a zero gradient, as optax
    steps every leaf."""

    def __init__(self, inner: torch.optim.Optimizer, lr_schedule: Schedule,
                 wd_schedule: Optional[Schedule], clip_grad: Optional[float],
                 decoupled_sgd_decay: bool, clip_each_group: bool = False):
        self.inner = inner
        self.lr_schedule = lr_schedule
        self.wd_schedule = wd_schedule
        self.clip_grad = clip_grad
        self._sgd_decay = decoupled_sgd_decay
        self.clip_each_group = clip_each_group
        self.count = 0

    @property
    def param_groups(self):
        return self.inner.param_groups

    def params(self) -> List[torch.Tensor]:
        return [p for g in self.inner.param_groups for p in g["params"]]

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.inner.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def step(self) -> None:
        params = self.params()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.clip_grad is not None and params:
            for ps in ([g["params"] for g in self.inner.param_groups] if self.clip_each_group
                       else [params]):
                norm = sharding.grad_norm(ps)  # a sharded leaf counted over its model group
                # optax: g if norm < max_norm else g / norm * max_norm; on the device
                divisor = torch.where(norm < self.clip_grad, torch.ones_like(norm),
                                      norm / self.clip_grad)
                torch._foreach_div_([p.grad for p in ps], divisor)
        lr = self.lr_schedule(self.count)
        for group in self.inner.param_groups:
            group["lr"] = lr * group["lr_scale"]
            if group["decayed"]:
                wd = group["base_weight_decay"] if self.wd_schedule is None \
                    else self.wd_schedule(self.count)
                if self._sgd_decay:  # decoupled: after the momentum, on the old weights
                    torch._foreach_mul_(group["params"], 1.0 - group["lr"] * wd)
                else:
                    group["weight_decay"] = wd
        self.inner.step()
        self.count += 1

    def state_dict(self) -> Dict:
        return {"inner": self.inner.state_dict(), "count": self.count}

    def load_state_dict(self, state: Dict) -> None:
        self.inner.load_state_dict(state["inner"])
        self.count = int(state["count"])


def adamw_every_leaf(params: Named, lr: float, weight_decay: float) -> ScheduledOptimizer:
    """``optax.adamw(lr, weight_decay=weight_decay)``: AdamW (b1 0.9, b2
    0.999, eps 1e-8) at a constant lr over every parameter of ``params``,
    the decay on every one of them, no clip."""
    inner = torch.optim.AdamW([dict(params=list(_named(params).values()), lr_scale=1.0,
                                    decayed=True, weight_decay=0.0,
                                    base_weight_decay=weight_decay)],
                              lr=0.0, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)
    return ScheduledOptimizer(inner, lambda count: lr, None, None, decoupled_sgd_decay=False)


def create_optimizer(
    params: Named,
    lr_schedule: Schedule,
    weight_decay: float = 0.05,
    wd_schedule: Optional[Schedule] = None,
    betas=(0.9, 0.999),
    eps: float = 1e-8,
    clip_grad: Optional[float] = None,
    layer_decay: Optional[float] = None,
    num_layers: int = 12,
    trainable_mask: Optional[Dict[str, bool]] = None,
    opt_name: str = "adamw",
) -> ScheduledOptimizer:
    """AdamW (default), SGD with momentum ``betas[0]`` or Lion over the
    trainable parameters of ``params`` (a module or named parameters): those
    that require grad and that ``trainable_mask`` (name -> bool, default all)
    does not switch off. Decay is decoupled and skips what
    ``weight_decay_mask`` skips; ``layer_decay`` < 1 scales each layer's lr
    (LLRD); ``clip_grad`` clips by the global norm before the update."""
    named = {name: p for name, p in _named(params).items()
             if p.requires_grad and (trainable_mask is None or trainable_mask.get(name, True))}
    decayed = weight_decay_mask(named)
    llrd = layer_decay is not None and layer_decay < 1.0
    scales = layer_decay_scales(named, num_layers, layer_decay) if llrd else {}
    buckets: Dict[Tuple[float, bool], List[torch.Tensor]] = {}
    for name, p in named.items():
        buckets.setdefault((scales.get(name, 1.0), decayed[name]), []).append(p)
    decay_on = wd_schedule is not None or bool(weight_decay)
    groups = [dict(params=ps, lr_scale=scale, decayed=dec and decay_on, weight_decay=0.0,
                   base_weight_decay=weight_decay)
              for (scale, dec), ps in buckets.items()]
    if opt_name == "adamw":
        inner = torch.optim.AdamW(groups, lr=0.0, betas=tuple(betas), eps=eps, weight_decay=0.0)
    elif opt_name == "sgd":
        inner = torch.optim.SGD(groups, lr=0.0, momentum=betas[0], weight_decay=0.0)
    elif opt_name == "lion":
        inner = Lion(groups, lr=0.0, betas=tuple(betas), weight_decay=0.0)
    else:
        raise ValueError(opt_name)
    return ScheduledOptimizer(inner, lr_schedule, wd_schedule, clip_grad,
                              decoupled_sgd_decay=opt_name == "sgd")
