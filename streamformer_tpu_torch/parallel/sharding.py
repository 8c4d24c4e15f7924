"""Tensor (Megatron) and sequence parallelism of the encoder over the
``model`` dim of a device mesh.

Port of the JAX package's ``parallel/sharding.py``. There GSPMD places
every leaf by a ``PartitionSpec`` and inserts the collectives; here each
process holds its shard of the sharded leaves and the encoder calls the
collectives itself, as autograd functions that are each other's conjugates
(``region_in`` opens a block's column-parallel product, ``region_out``
closes its row-parallel one).

The rules, per block (a block whose heads, or MLP width, do not divide over
the group stays replicated, as a JAX leaf does whose dimension does not
divide):

* column-parallel, output rows sharded: the fused ``qkv`` (and its bias and
  ``qkv_lora_b``) of both attentions and the MAP head's ``in_proj``, each by
  heads: rank r holds ``[q_heads(r), k_heads(r), v_heads(r)]``, so its
  packed (B, T, N, 3D / mp) projection is the layout the attention kernels
  read at ``num_heads / mp`` heads; the MLPs' first product
  (``intermediate.dense``, the head's ``mlp.fc1``) by columns;
* row-parallel, input columns sharded: the attentions' ``output.dense``
  (and ``dense_lora_a``), the head's ``out_proj``, the MLPs' second product
  (``output.dense``, the head's ``mlp.fc2``); the bias is added once, after
  the reduction;
* replicated: everything else, ``temporal_dense`` included. The temporal
  attention's ``output.dense`` and ``temporal_dense`` are back-to-back
  products that JAX names both row-parallel; here the reduction closes
  ``output.dense`` and ``temporal_dense`` runs replicated on its result:
  one reduction a layer's temporal branch, as the linear map would also
  give by passing the partial sums through ``temporal_dense``, but with no
  replicated weight fed a partial sum.

A replicated parameter used inside a sharded region gets a partial
gradient on each rank (the LoRA ``qkv_lora_a`` and ``dense_lora_b``, the
head's probe), and so does every replicated parameter of the trunk under
sequence parallelism, whose activations hold each rank's patches: those are
marked ``tp_partial`` and their gradients are summed over the model group
(``sum_partial_grads``). A sharded parameter carries ``tp_shard`` (its
``Shard`` and the group). Checkpoints are written whole
(``full_tensor``) and cut again at restore (``shard_of``), so the topology
is chosen at restore time. The frozen text tower stays replicated.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Iterable, List, Optional

import torch
import torch.distributed as dist
import torch.nn as nn


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """This process's place in its model group: ``size`` ranks, this one
    ``rank``; ``shard_patches`` splits the trunk's activations on the patch
    axis over the group between blocks (sequence parallelism)."""

    group: object
    size: int
    rank: int
    shard_patches: bool = False


@dataclasses.dataclass(frozen=True)
class Shard:
    """How a leaf is cut: along ``dim`` (0: a column-parallel product's
    output rows, 1: a row-parallel product's input columns), as ``parts``
    fused blocks (3 for [q, k, v]) each cut into equal contiguous pieces."""

    dim: int
    parts: int = 1


def shard_of(full: torch.Tensor, shard: Shard, size: int, rank: int) -> torch.Tensor:
    """Rank ``rank``'s piece of the whole tensor ``full`` (a copy)."""
    blocks = full.chunk(shard.parts, dim=shard.dim)
    return torch.cat([b.chunk(size, dim=shard.dim)[rank] for b in blocks], dim=shard.dim).clone()


def unshard(pieces: List[torch.Tensor], shard: Shard) -> torch.Tensor:
    """The whole tensor from every rank's piece, in rank order: the inverse
    of ``shard_of``."""
    split = [p.chunk(shard.parts, dim=shard.dim) for p in pieces]
    return torch.cat([torch.cat([s[j] for s in split], dim=shard.dim)
                      for j in range(shard.parts)], dim=shard.dim)


_ATTN = r"encoder\.layer\.\d+\.(attention|temporal_attention)\."
_MLP = r"encoder\.layer\.\d+\."


def param_rules(cfg, size: int) -> Dict[str, Shard]:
    """Parameter-name pattern (of the encoder) -> ``Shard``, for a model
    group of ``size`` ranks."""
    rules: Dict[str, Shard] = {}
    if cfg.num_attention_heads % size == 0:
        qkv, by_cols = Shard(0, 3), Shard(1)
        rules.update({
            _ATTN + r"attention\.qkv\.(weight|bias)": qkv,
            _ATTN + r"attention\.qkv_lora_b\.weight": qkv,
            _ATTN + r"output\.dense\.weight": by_cols,
            _ATTN + r"output\.dense_lora_a\.weight": by_cols,
            r"head\.attention\.in_proj_(weight|bias)": qkv,
            r"head\.attention\.out_proj\.weight": by_cols,
        })
    if cfg.intermediate_size % size == 0:
        rules.update({
            _MLP + r"intermediate\.dense\.(weight|bias)": Shard(0),
            _MLP + r"output\.dense\.weight": Shard(1),
            r"head\.mlp\.fc1\.(weight|bias)": Shard(0),
            r"head\.mlp\.fc2\.weight": Shard(1),
        })
    return rules


def _partial(name: str, cfg, size: int, shard_patches: bool) -> bool:
    """Whether a replicated parameter's gradient is a partial sum on each
    rank of the model group."""
    if shard_patches and name.startswith("encoder.layer."):
        return True
    if cfg.num_attention_heads % size:
        return False
    return bool(re.fullmatch(_ATTN + r"(attention\.qkv_lora_a|output\.dense_lora_b)\.weight",
                             name)) or name == "head.probe"


def shard_encoder(encoder: nn.Module, group, shard_patches: bool = False) -> nn.Module:
    """Cut ``encoder`` (a ``StreamformerEncoder`` holding the whole weights,
    the same on every rank) to this rank's shard of the model group
    ``group``, in place, and set ``encoder.parallel``; a group of one rank
    leaves it whole and one process's. Build the optimizer after this."""
    size = dist.get_world_size(group)
    if size == 1:
        encoder.parallel = None
        return encoder
    cfg = encoder.cfg
    if shard_patches and cfg.num_patches % size:
        raise ValueError(f"shard_patches: {cfg.num_patches} patches do not divide over "
                         f"{size} model ranks")
    par = TensorParallel(group, size, dist.get_rank(group), shard_patches)
    rules = param_rules(cfg, size)
    for name, p in list(encoder.named_parameters()):
        rule = next((r for pat, r in rules.items() if re.fullmatch(pat, name)), None)
        if rule is None:
            if _partial(name, cfg, size, shard_patches):
                p.tp_partial = par
            continue
        owner, attr = _owner(encoder, name)
        piece = nn.Parameter(shard_of(p.detach(), rule, size, par.rank),
                             requires_grad=p.requires_grad)
        piece.tp_shard = (rule, par)
        setattr(owner, attr, piece)
    encoder.parallel = par
    return encoder


def shard_model(model: nn.Module, mesh) -> nn.Module:
    """``shard_encoder`` on a ``MultitaskModel``'s backbone over the
    ``model`` dim of ``mesh`` (``parallel.mesh.make_mesh``), with
    ``model.cfg.shard_patches``; the text tower and the logit scale and bias
    stay replicated. A mesh without a ``model`` dim changes nothing."""
    if mesh is not None and "model" in (mesh.mesh_dim_names or ()):
        shard_encoder(model.backbone, mesh.get_group("model"), model.cfg.shard_patches)
    return model


def _owner(root: nn.Module, name: str):
    path, attr = name.rsplit(".", 1)
    return root.get_submodule(path), attr


def shard_info(p: torch.Tensor):
    """``(Shard, TensorParallel)`` of a sharded parameter, else None."""
    return getattr(p, "tp_shard", None)


def full_tensor(t: torch.Tensor, info) -> torch.Tensor:
    """The whole tensor of which ``t`` is this rank's piece (``info`` as
    ``shard_info`` gives it), gathered over the model group: a collective
    every rank of the group calls. ``t`` itself when ``info`` is None."""
    if info is None:
        return t
    rule, par = info
    pieces = [torch.empty_like(t) for _ in range(par.size)]
    dist.all_gather(pieces, t.detach().contiguous(), group=par.group)
    return unshard(pieces, rule)


def local_piece(full: torch.Tensor, info) -> torch.Tensor:
    """This rank's piece of the whole tensor ``full``; ``full`` when
    ``info`` is None."""
    if info is None:
        return full
    rule, par = info
    return shard_of(full, rule, par.size, par.rank)


# --------------------------------------------------------------------------
# Gradients: partial sums, the global norm
# --------------------------------------------------------------------------


def partial_first(named: Dict[str, torch.Tensor]) -> List[str]:
    """The names of ``named`` parameters with the ``tp_partial`` ones first
    (each keeps its order), so their gradients sit together in a flat
    buffer."""
    names = list(named)
    return sorted(names, key=lambda n: getattr(named[n], "tp_partial", None) is None)


def sum_partial_grads(flat: torch.Tensor, n_partial: int, par: Optional[TensorParallel]) -> None:
    """Sum over the model group, in place, the first ``n_partial`` elements
    of the flat gradient buffer (``partial_first``'s order)."""
    if par is not None and n_partial:
        dist.all_reduce(flat[:n_partial], group=par.group)


def grad_norm(params: Iterable[torch.Tensor], grads: Optional[Iterable[torch.Tensor]] = None
              ) -> torch.Tensor:
    """The global L2 norm of the gradients (``p.grad``, or ``grads``) of
    ``params``: the squared norms of sharded leaves summed over their model
    group, each replicated leaf counted once. With no sharded leaf it is
    the one-process formula, bit for bit."""
    params = list(params)
    grads = [p.grad for p in params] if grads is None else list(grads)
    sharded = [g for p, g in zip(params, grads) if shard_info(p) is not None]
    if not sharded:
        return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)).to(torch.float32))
    par = shard_info(next(p for p in params if shard_info(p) is not None))[1]
    repl = [g for p, g in zip(params, grads) if shard_info(p) is None]
    sq = torch.stack(torch._foreach_norm(sharded)).float().square().sum()
    dist.all_reduce(sq, group=par.group)
    if repl:
        sq = sq + torch.stack(torch._foreach_norm(repl)).float().square().sum()
    return sq.sqrt()


# --------------------------------------------------------------------------
# Collectives with their conjugate backwards
# --------------------------------------------------------------------------


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x


def _gather_patches(x: torch.Tensor, par: TensorParallel) -> torch.Tensor:
    """(B, T, N/mp, D) pieces -> (B, T, N, D), rank order along N."""
    piece = x.movedim(2, 0).contiguous()
    out = piece.new_empty((par.size * piece.shape[0],) + tuple(piece.shape[1:]))
    dist.all_gather_into_tensor(out, piece, group=par.group)
    return out.movedim(0, 2).contiguous()


def _reduce_scatter_patches(x: torch.Tensor, par: TensorParallel) -> torch.Tensor:
    """(B, T, N, D) partial sums -> this rank's (B, T, N/mp, D) of their sum."""
    whole = x.movedim(2, 0).contiguous()
    out = whole.new_empty((whole.shape[0] // par.size,) + tuple(whole.shape[1:]))
    dist.reduce_scatter_tensor(out, whole, group=par.group)
    return out.movedim(0, 2).contiguous()


def _narrow_patches(x: torch.Tensor, par: TensorParallel) -> torch.Tensor:
    n = x.shape[2] // par.size
    return x.narrow(2, par.rank * n, n).contiguous()


class _CopyToModel(torch.autograd.Function):
    """Identity forward, all-reduce backward: a replicated input entering a
    column-parallel product."""

    @staticmethod
    def forward(ctx, x, par):
        ctx.par = par
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.par.group), None


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce forward, identity backward: a row-parallel product's
    partial sums."""

    @staticmethod
    def forward(ctx, x, par):
        return _all_reduce(x, par.group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllGatherPatches(torch.autograd.Function):
    """All-gather on N forward, reduce-scatter backward: this rank's patches
    entering a column-parallel product under sequence parallelism."""

    @staticmethod
    def forward(ctx, x, par):
        ctx.par = par
        return _gather_patches(x, par)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter_patches(g, ctx.par), None


class _ReduceScatterPatches(torch.autograd.Function):
    """Reduce-scatter on N forward, all-gather backward: a row-parallel
    product's partial sums back to this rank's patches."""

    @staticmethod
    def forward(ctx, x, par):
        ctx.par = par
        return _reduce_scatter_patches(x, par)

    @staticmethod
    def backward(ctx, g):
        return _gather_patches(g, ctx.par), None


class _SplitPatches(torch.autograd.Function):
    """This rank's patches of a replicated tensor forward, all-gather
    backward: into the sequence-parallel trunk."""

    @staticmethod
    def forward(ctx, x, par):
        ctx.par = par
        return _narrow_patches(x, par)

    @staticmethod
    def backward(ctx, g):
        return _gather_patches(g, ctx.par), None


class _GatherPatches(torch.autograd.Function):
    """All-gather on N forward, this rank's patches of the (replicated)
    gradient backward: out of the sequence-parallel trunk."""

    @staticmethod
    def forward(ctx, x, par):
        ctx.par = par
        return _gather_patches(x, par)

    @staticmethod
    def backward(ctx, g):
        return _narrow_patches(g, ctx.par), None


def region_in(x: torch.Tensor, par: TensorParallel, sharded: bool, patches: bool) -> torch.Tensor:
    """A block's input on its way into the column-parallel product: every
    patch (all-gather) under sequence parallelism, else x, whose gradient is
    summed over the group when the block is sharded."""
    if patches:
        return _AllGatherPatches.apply(x, par)
    return _CopyToModel.apply(x, par) if sharded else x


def region_out(y: torch.Tensor, par: TensorParallel, sharded: bool, patches: bool) -> torch.Tensor:
    """A block's closing product on its way out: the partial sums of a
    sharded block reduced over the group (onto this rank's patches under
    sequence parallelism); a replicated block's output, cut to this rank's
    patches under sequence parallelism."""
    if sharded:
        return _ReduceScatterPatches.apply(y, par) if patches else _ReduceFromModel.apply(y, par)
    return _narrow_patches(y, par) if patches else y


def split_patches(x: torch.Tensor, par: TensorParallel) -> torch.Tensor:
    """Into the sequence-parallel trunk: this rank's patches of x."""
    return _SplitPatches.apply(x, par)


def gather_patches(x: torch.Tensor, par: TensorParallel) -> torch.Tensor:
    """Out of the sequence-parallel trunk: every patch, on every rank."""
    return _GatherPatches.apply(x, par)
