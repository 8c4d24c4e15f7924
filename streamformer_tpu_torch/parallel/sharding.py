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
import torch.nn.functional as F
from torch.distributed import _functional_collectives as fc

from streamformer_tpu_torch.ops import attention as ops
from streamformer_tpu_torch.ops import quant


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
    if any(isinstance(m, quant.Int8Linear) for m in encoder.modules()):
        raise NotImplementedError("tensor parallelism over an encoder with int8 weights: cut the "
                                  "float encoder, the port shards no int8 layer")
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


def traced() -> bool:
    """Whether a program is being traced: the collectives are then the
    functional ones (the ops' own switch, ``ops.attention._via_op``)."""
    return ops._via_op()


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """A new tensor: x reduced over ``group`` ("sum" or "max")."""
    if traced():
        return fc.all_reduce(x, op, group)
    x = x.contiguous().clone()
    dist.all_reduce(x, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM, group=group)
    return x


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's x concatenated along ``dim`` in rank order."""
    piece = x.movedim(dim, 0).contiguous()
    if traced():
        out = fc.all_gather_tensor(piece, 0, group)
    else:
        out = piece.new_empty((dist.get_world_size(group) * piece.shape[0],)
                              + tuple(piece.shape[1:]))
        dist.all_gather_into_tensor(out, piece, group=group)
    return out.movedim(0, dim).contiguous()


def _gather_patches(x: torch.Tensor, par: TensorParallel) -> torch.Tensor:
    """(B, T, N/mp, D) pieces -> (B, T, N, D), rank order along N."""
    return all_gather(x, par.group, dim=2)


def _reduce_scatter_patches(x: torch.Tensor, par: TensorParallel) -> torch.Tensor:
    """(B, T, N, D) partial sums -> this rank's (B, T, N/mp, D) of their sum."""
    whole = x.movedim(2, 0).contiguous()
    if traced():
        out = fc.reduce_scatter_tensor(whole, "sum", 0, par.group)
    else:
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
        return all_reduce(g, ctx.par.group), None


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce forward, identity backward: a row-parallel product's
    partial sums."""

    @staticmethod
    def forward(ctx, x, par):
        return all_reduce(x, par.group)

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
        return _gather_patches(x, par) if traced() else _AllGatherPatches.apply(x, par)
    return _CopyToModel.apply(x, par) if sharded and not traced() else x


def region_out(y: torch.Tensor, par: TensorParallel, sharded: bool, patches: bool) -> torch.Tensor:
    """A block's closing product on its way out: the partial sums of a
    sharded block reduced over the group (onto this rank's patches under
    sequence parallelism); a replicated block's output, cut to this rank's
    patches under sequence parallelism."""
    if traced():  # no backward in a traced program: the forwards alone
        if sharded:
            return _reduce_scatter_patches(y, par) if patches else all_reduce(y, par.group)
        return _narrow_patches(y, par) if patches else y
    if sharded:
        return _ReduceScatterPatches.apply(y, par) if patches else _ReduceFromModel.apply(y, par)
    return _narrow_patches(y, par) if patches else y


def split_patches(x: torch.Tensor, par: TensorParallel) -> torch.Tensor:
    """Into the sequence-parallel trunk: this rank's patches of x."""
    return _narrow_patches(x, par) if traced() else _SplitPatches.apply(x, par)


def gather_patches(x: torch.Tensor, par: TensorParallel) -> torch.Tensor:
    """Out of the sequence-parallel trunk: every patch, on every rank."""
    return _gather_patches(x, par) if traced() else _GatherPatches.apply(x, par)


def partial_product(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``x @ weight.T`` of a row-parallel product: this rank's partial sums.
    Where no gradient is recorded they are the fp32 accumulators (on the
    card the bf16 product writes them as they are, ``out_dtype``), so the
    sum over the group is rounded to x's dtype once, as the one-process
    product's is: bf16 partial sums rounded before the reduction move a
    bf16 flagship stream 0.012 pooled from one process over 12 layers. A
    recorded graph keeps x's dtype."""
    if x.dtype == torch.float32 or (torch.is_grad_enabled()
                                    and (x.requires_grad or weight.requires_grad)):
        return F.linear(x, weight)
    if x.is_cuda:
        flat = x.reshape(1, -1, x.shape[-1])
        out = torch.bmm(flat, weight.t()[None], out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], weight.shape[0])
    return F.linear(x.float(), weight.float())


def quantize_rows(x: torch.Tensor, par: Optional[TensorParallel]) -> tuple:
    """``quant.quantize_rows`` of rows whose last axis is cut over the model
    group: each row's absmax is MAX-reduced over the group first, so the
    scale is the whole row's and the codes are the unsharded ones (the int8
    KV cache's scale is per (position, row) over the whole D). One
    process's (``par`` None): ``quant.quantize_rows``."""
    if par is None:
        return quant.quantize_rows(x)
    amax = all_reduce(x.abs().amax(dim=-1).float(), par.group, "max")  # exact in fp32
    scale = amax.clamp_min_(1e-8) / quant._divisor(127.0, x.device)
    codes = torch.round(x / scale[..., None]).clamp_(-127, 127).to(torch.int8)
    return codes, scale


# --------------------------------------------------------------------------
# The language model
# --------------------------------------------------------------------------


_LM_LAYER = r"model\.layers\.\d+\."


def lm_param_rules(cfg, size: int) -> Dict[str, Shard]:
    """Parameter-name pattern (of ``LanguageModel``) -> ``Shard``, for a
    model group of ``size`` ranks: the attention when its query and kv-heads
    both divide, the MLP when its width does, the embedding table and the
    untied head when the vocab does."""
    rules: Dict[str, Shard] = {}
    if cfg.num_attention_heads % size == 0 and cfg.num_key_value_heads % size == 0:
        rules.update({_LM_LAYER + r"self_attn\.(q|k|v)_proj\.(weight|bias)": Shard(0),
                      _LM_LAYER + r"self_attn\.o_proj\.weight": Shard(1)})
    if cfg.intermediate_size % size == 0:
        rules.update({_LM_LAYER + r"mlp\.(gate|up)_proj\.weight": Shard(0),
                      _LM_LAYER + r"mlp\.down_proj\.weight": Shard(1)})
    if cfg.vocab_size % size == 0:
        rules.update({r"model\.embed_tokens\.weight": Shard(0), r"lm_head\.weight": Shard(0)})
    return rules


def _int8_block(root: nn.Module, name: str) -> bool:
    """Whether the block (attention, MLP or head) of parameter ``name`` holds
    an int8 layer: such a block stays replicated, as a JAX ``kernel_q``."""
    owner = root.get_submodule(name.rsplit(".", 2)[0])
    return isinstance(owner, quant.Int8Linear) or any(
        isinstance(m, quant.Int8Linear) for m in owner.children())


def shard_lm(model: nn.Module, group) -> nn.Module:
    """Cut a ``LanguageModel`` holding the whole weights (the same on every
    rank; carry a JAX tree across with ``checkpoint.lm_params_from_jax``
    first) to this rank's shard of the model group ``group``, in place, and
    set ``model.parallel``; a group of one rank leaves it whole. The rules
    are ``lm_param_rules``; an int8 layer's block stays replicated. Its
    caches hold this rank's kv-heads (``language_model.init_cache`` at
    ``kv_heads=language_model.local_kv_heads(model)``)."""
    if any(p.requires_grad for p in model.parameters()):
        raise NotImplementedError("a trainable LM under tensor parallelism (VideoQA stages 2-3 "
                                  "and DPO sharded): ROADMAP item 14c; shard_lm serves")
    size = dist.get_world_size(group)
    if size == 1:
        model.parallel = None
        return model
    par = TensorParallel(group, size, dist.get_rank(group))
    rules = lm_param_rules(model.cfg, size)
    for name, p in list(model.named_parameters()):
        rule = next((r for pat, r in rules.items() if re.fullmatch(pat, name)), None)
        if rule is None or _int8_block(model, name):
            continue
        owner, attr = _owner(model, name)
        piece = nn.Parameter(shard_of(p.detach(), rule, size, par.rank),
                             requires_grad=p.requires_grad)
        piece.tp_shard = (rule, par)
        setattr(owner, attr, piece)
    model.parallel = par
    return model


def sharded_argmax(x: torch.Tensor, par: Optional[TensorParallel], offset: int) -> torch.Tensor:
    """(S, V_local) scores of this rank's vocab slice, from global index
    ``offset`` on -> (S,) global argmax over every rank's slice, ties to the
    lowest index as ``torch.argmax`` gives them. One process's: x.argmax."""
    local = x.argmax(-1)
    if par is None:
        return local
    best = x.gather(-1, local[:, None])[:, 0].double()
    pair = torch.stack([best, (local + offset).double()], -1)  # both exact in float64
    every = all_gather(pair[None], par.group)  # (mp, S, 2)
    top = every[..., 0].amax(0)
    idx = torch.where(every[..., 0] == top, every[..., 1], float("inf")).amin(0)
    return idx.long()
