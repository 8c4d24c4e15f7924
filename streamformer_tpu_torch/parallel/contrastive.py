"""Contrastive losses and their multi-process forms.

Port of the JAX package's ``parallel/contrastive.py``. There the multi-chip
forms ride ``ppermute`` / ``all_gather`` over a named mesh axis and fall back
to single-shard math when no axis is bound (``axis_name=None``). Here the
place of the axis name is taken by a ``torch.distributed`` process group,
``group``: ``None`` is the single-process form. Over a group the ring loss
is the reference's bidirectional neighbour exchange (``batch_isend_irecv``
under an autograd function whose backward sends the received features'
gradients back along the reverse hop), and ``all_gather_features`` gathers
with gradient (its backward sums each rank's slice over the group).
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F


def sigmoid_pair_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """SigLIP pairwise loss term: -sum(logsigmoid(labels * logits)), labels in
    {-1, +1} (a 0 entry contributes log 2: callers mask first)."""
    return -F.logsigmoid(labels * logits).sum()


def siglip_local_loss(img: torch.Tensor, txt: torch.Tensor, logit_scale: torch.Tensor,
                      logit_bias: torch.Tensor, *, negative_only: bool = False) -> torch.Tensor:
    """Single-shard SigLIP loss. img (B, D), txt (B', D), L2-normalized;
    ``logit_scale`` is already exponentiated. Labels are 2*I - 1 (all -1 when
    ``negative_only``); the sum is divided by the local B."""
    b = img.shape[0]
    logits = logit_scale * (img.float() @ txt.float().t()) + logit_bias
    labels = -torch.ones_like(logits)
    if not negative_only:
        labels = labels + 2 * torch.eye(b, txt.shape[0], dtype=logits.dtype, device=logits.device)
    return sigmoid_pair_loss(logits, labels) / b


def _world(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _exchange(sends: List[Tuple[torch.Tensor, int]], recv_from: List[int], group
              ) -> List[torch.Tensor]:
    """Send each (tensor, group rank) and receive one tensor of the first's
    shape from each group rank of ``recv_from``, all posted together."""
    ranks = dist.get_process_group_ranks(group)
    like = sends[0][0]
    got = [torch.empty_like(like) for _ in recv_from]
    ops = [dist.P2POp(dist.isend, t.contiguous(), ranks[to], group) for t, to in sends]
    ops += [dist.P2POp(dist.irecv, r, ranks[src], group) for r, src in zip(got, recv_from)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return got


class _NeighbourExchange(torch.autograd.Function):
    """Forward: ``to_left`` goes to the left neighbour and ``to_right`` to
    the right one; returns (what came from the right, what came from the
    left). Backward: the reverse hop, each received tensor's gradient back
    to the rank that sent it. ``to_left`` may be None (the one-way hop to
    the right)."""

    @staticmethod
    def forward(ctx, group, to_left, to_right):
        ctx.group = group
        ctx.one_way = to_left is None
        world, me = dist.get_world_size(group), dist.get_rank(group)
        left, right = (me - 1) % world, (me + 1) % world
        ctx.left, ctx.right = left, right
        if ctx.one_way:
            (from_left,) = _exchange([(to_right, right)], [left], group)
            return from_left
        from_right, from_left = _exchange([(to_left, left), (to_right, right)], [right, left],
                                          group)
        return from_right, from_left

    @staticmethod
    def backward(ctx, *grads):
        if ctx.one_way:  # from_left's gradient goes back left; to_right's comes from the right
            (g_to_right,) = _exchange([(grads[0], ctx.left)], [ctx.right], ctx.group)
            return None, None, g_to_right
        g_from_right, g_from_left = grads
        g_to_left, g_to_right = _exchange([(g_from_right, ctx.right), (g_from_left, ctx.left)],
                                          [ctx.left, ctx.right], ctx.group)
        return None, g_to_left, g_to_right


def siglip_ring_loss(img: torch.Tensor, txt: torch.Tensor, logit_scale: torch.Tensor,
                     logit_bias: torch.Tensor, group=None) -> torch.Tensor:
    """Ring SigLIP loss (the reference's bidirectional neighbour exchange):
    local positives and negatives, then negative-only terms against every
    other rank's text features, passed left and right in
    ``(world - 1) // 2`` two-way rounds and one more one-way hop to the
    right when world - 1 is odd. Returns this rank's loss, whose mean over
    the group is the SigLIP loss of the global batch; the exchange is
    differentiable. With ``group=None`` (one process) or a group of one
    rank it is the local loss."""
    loss = siglip_local_loss(img, txt, logit_scale, logit_bias)
    world = _world(group)
    if world == 1:
        return loss
    n_bidir, remainder = divmod(world - 1, 2)
    to_left, to_right = txt, txt
    for _ in range(n_bidir):
        from_right, from_left = _NeighbourExchange.apply(group, to_left, to_right)
        for f in (from_right, from_left):
            loss = loss + siglip_local_loss(img, f, logit_scale, logit_bias, negative_only=True)
        to_left, to_right = from_right, from_left
    if remainder:
        recv = _NeighbourExchange.apply(group, None, to_right)
        loss = loss + siglip_local_loss(img, recv, logit_scale, logit_bias, negative_only=True)
    return loss


class _AllGather(torch.autograd.Function):
    """Concatenation over the group along dim 0 forward; backward, the sum
    over the group of each rank's slice of the gradient (reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        out = x.new_empty((dist.get_world_size(group) * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        out = g.new_empty((g.shape[0] // dist.get_world_size(ctx.group),) + tuple(g.shape[1:]))
        dist.reduce_scatter_tensor(out, g, group=ctx.group)
        return out, None


def all_gather_features(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's features concatenated along the batch axis, in rank
    order, with gradient; x itself in one process or a group of one."""
    if _world(group) == 1:
        return x
    return _AllGather.apply(x, group)


def axis_rank(group=None) -> int:
    """This process's rank in the group; 0 in one process."""
    return 0 if group is None else dist.get_rank(group)
