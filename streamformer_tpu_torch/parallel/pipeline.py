"""GPipe pipeline parallelism for the encoder trunk.

Port of the JAX package's ``parallel/pipeline.py``. There the layers are
stacked into per-stage trees sharded over a ``pipe`` mesh axis and the
schedule is a ``lax.scan`` of ``ppermute`` hops that ``jax.grad``
transposes. Here each process of the ``pipe`` dim holds its stage's
``L / S`` layers (``place_pipeline_params``), and ``pipelined_trunk`` runs
the schedule by hand inside one autograd function:

* forward: stage 0 takes the microbatches of the embedded input in turn;
  every stage runs its layers on a microbatch and sends the result to the
  next stage, so M microbatches take M + S - 1 steps of the slowest stage
  (the GPipe bubble (S - 1) / (M + S - 1)); the last stage's outputs go to
  every stage;
* backward: the microbatches in reverse, each stage's input gradients sent
  back to the stage before it; the layers' gradients accumulate into their
  ``.grad`` on the stage that holds them, and the input's gradient is sent
  from stage 0 to every stage, so the replicated embedding gets the same
  gradient everywhere.

The embedding, the post-LN and the MAP head run replicated over ``pipe``.
Dropout and stochastic depth are keyed by sample (``encoder.Draws``): a
microbatch draws its rows' masks of the sequential trunk, decorrelated
across microbatches as they are across the rows of one batch. With the
data dim each data slice runs its own pipeline on its rows.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from streamformer_tpu_torch.config import StreamformerConfig
from streamformer_tpu_torch.models import encoder
from streamformer_tpu_torch.parallel import mesh as mesh_lib


@dataclasses.dataclass
class Stage:
    """A pipeline stage: its layers, the first one's global index."""

    layers: nn.ModuleList
    first: int


def stack_pipeline_params(model: encoder.StreamformerEncoder, num_stages: int
                          ) -> Tuple[List[Stage], int]:
    """The trunk's layers as ``num_stages`` consecutive stages, and the
    layers a stage. A layer count that does not divide is refused."""
    layers = model.encoder.layer
    n = len(layers)
    if n % num_stages:
        raise ValueError(f"num_hidden_layers={n} not divisible by num_stages={num_stages}")
    per = n // num_stages
    return [Stage(nn.ModuleList(layers[s * per:(s + 1) * per]), s * per)
            for s in range(num_stages)], per


def place_pipeline_params(model: encoder.StreamformerEncoder, mesh) -> Stage:
    """Keep this process's stage of the trunk (its ``pipe`` index) and free
    the others' layers (each replaced by an empty module, so the names of
    the kept ones do not change); returns the stage. Everything but the
    trunk stays replicated."""
    stages, _ = stack_pipeline_params(model, mesh_lib.dim_size(mesh, "pipe"))
    stage = stages[mesh_lib.dim_rank(mesh, "pipe")]
    keep = set(range(stage.first, stage.first + len(stage.layers)))
    for i in range(len(model.encoder.layer)):
        if i not in keep:
            model.encoder.layer[i] = nn.Module()
    return stage


def _send(t: torch.Tensor, to: int, group, ranks: List[int]):
    return dist.isend(t.contiguous(), ranks[to], group=group)


def _recv(like: torch.Tensor, src: int, group, ranks: List[int]) -> torch.Tensor:
    t = torch.empty_like(like)
    dist.recv(t, ranks[src], group=group)
    return t


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, run, group, num_microbatches, record):
        size, me = dist.get_world_size(group), dist.get_rank(group)
        ranks = dist.get_process_group_ranks(group)
        mbs = x.detach().chunk(num_microbatches)
        ctx.group, ctx.ranks, ctx.size, ctx.me = group, ranks, size, me
        ctx.inputs, ctx.outputs, sends = [], [], []
        for m, xm in enumerate(mbs):
            inp = xm if me == 0 else _recv(xm, me - 1, group, ranks)
            inp = inp.detach().requires_grad_(x.requires_grad or me > 0)
            with torch.set_grad_enabled(record):  # the graph the backward replays, if any
                out = run(inp, m)
            if me < size - 1:
                sends.append(_send(out.detach(), me + 1, group, ranks))
            ctx.inputs.append(inp)
            ctx.outputs.append(out)
        for req in sends:
            req.wait()
        y = torch.cat([o.detach() for o in ctx.outputs]) if me == size - 1 else torch.empty_like(x)
        dist.broadcast(y, ranks[size - 1], group=group)
        return y

    @staticmethod
    def backward(ctx, gy):
        group, ranks, size, me = ctx.group, ctx.ranks, ctx.size, ctx.me
        g_mbs = gy.chunk(len(ctx.outputs))
        sends, gx = [], [None] * len(ctx.outputs)
        for m in reversed(range(len(ctx.outputs))):
            out, inp = ctx.outputs[m], ctx.inputs[m]
            g = g_mbs[m].contiguous() if me == size - 1 else _recv(out, me + 1, group, ranks)
            torch.autograd.backward(out, g)
            if me > 0:
                sends.append(_send(inp.grad, me - 1, group, ranks))
            gx[m] = inp.grad if inp.grad is not None else torch.zeros_like(inp)
        for req in sends:
            req.wait()
        gx = torch.cat(gx) if me == 0 else torch.empty_like(gy)
        dist.broadcast(gx, ranks[0], group=group)
        ctx.inputs = ctx.outputs = None
        return gx, None, None, None, None


def pipelined_trunk(stage, x: torch.Tensor, cfg: StreamformerConfig, *, mesh,
                    num_microbatches: int, generator=None, deterministic: bool = True
                    ) -> torch.Tensor:
    """The encoder trunk (every layer) on x (B, T, N, D), this data rank's
    embedded rows, as a GPipe pipeline over ``mesh``'s ``pipe`` dim; returns
    (B, T, N, D) on every stage. ``stage`` is this process's ``Stage``, or
    the whole list ``stack_pipeline_params`` gives. Differentiable; a
    ``generator`` (a ``Draws`` or a ``torch.Generator``) keys the masks by
    row as the sequential trunk does."""
    group = mesh_lib.dim_group(mesh, "pipe")
    size = dist.get_world_size(group)
    if isinstance(stage, list):
        stage = stage[dist.get_rank(group)]
    if cfg.shard_patches:
        raise ValueError("shard_patches (sequence parallelism) cannot be combined with the "
                         "pipeline; shard the patch axis outside it")
    if len(stage.layers) * size != cfg.num_hidden_layers:
        raise ValueError(f"{len(stage.layers)} layers a stage over {size} stages is not the "
                         f"trunk's {cfg.num_hidden_layers}")
    b = x.shape[0]
    if b % num_microbatches:
        raise ValueError(f"a batch of {b} does not divide into {num_microbatches} microbatches")
    mb = b // num_microbatches
    draws = None if deterministic else encoder.Draws.of(generator, b, x.device)

    def run(h, m):
        rows = None if draws is None else draws.rows(m * mb, (m + 1) * mb)
        return encoder.run_layers(stage.layers, h, cfg, first=stage.first, generator=rows,
                                  deterministic=deterministic)

    return _Pipeline.apply(x, run, group, num_microbatches, torch.is_grad_enabled())


def model_forward_pp(model: encoder.StreamformerEncoder, pixel_values: torch.Tensor, *, mesh,
                     num_microbatches: int, stage=None, generator=None,
                     deterministic: bool = True) -> Dict[str, torch.Tensor]:
    """The pipelined full-clip forward of this data rank's clips, with
    ``encoder.model_forward``'s outputs (``last_hidden_state``,
    ``pooler_output``) and numbers: the embedding, the post-LN and the MAP
    head run replicated over ``pipe``, the trunk through
    ``pipelined_trunk``. ``stage`` defaults to this process's stage of the
    model's layers (``place_pipeline_params`` frees the others first)."""
    cfg = model.cfg
    if stage is None:
        stages, _ = stack_pipeline_params(model, mesh_lib.dim_size(mesh, "pipe"))
        stage = stages
    draws = None if deterministic else encoder.Draws.of(generator, pixel_values.shape[0],
                                                        model.device)
    x = encoder.embed(model, pixel_values, generator=draws, deterministic=deterministic)
    x = pipelined_trunk(stage, x, cfg, mesh=mesh, num_microbatches=num_microbatches,
                        generator=draws, deterministic=deterministic)
    x = encoder.layer_norm(x, model.post_layernorm, cfg.layer_norm_eps)
    return {"last_hidden_state": x, "pooler_output": encoder.map_pool(x, model.head, cfg)}
