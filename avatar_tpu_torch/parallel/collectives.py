"""Collectives over one group of ranks of a :class:`~avatar_tpu_torch.
parallel.mesh.Mesh`, each differentiable where the multi-device modes need
its gradient. A backward is the transpose of its forward: the inverse
all-to-all, the opposite shift, a reduce-scatter for an all-gather, an
all-reduce for an all-reduce, and for a pipeline stage's hand-off the
gradient sent back.

Every rank of a group must make the same collective calls in the same order,
in the forward and in the backward: a mismatch hangs, it does not fail.
A group of one rank with no process group (``AxisGroup.group is None``)
makes every collective the identity; a group of one inside an initialized
process group still runs the collective on it (NCCL at world size 1).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class AxisGroup:
    """This rank's group along some mesh axes: the process group (None
    without one), the global ranks in the group's order and this rank's
    index among them."""

    group: Optional[object]
    ranks: Tuple[int, ...]
    index: int

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def trivial(self) -> bool:
        return self.group is None


# ---------------------------------------------------------------------------
# Plain collectives (no autograd)
# ---------------------------------------------------------------------------


def all_gather_plain(x: torch.Tensor, ag: AxisGroup, dim: int = 0) -> torch.Tensor:
    """The group's tensors concatenated along ``dim`` in group order."""
    if ag.trivial:
        return x
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((ag.size * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=ag.group)
    return out.movedim(0, dim)


def reduce_scatter_plain(x: torch.Tensor, ag: AxisGroup, dim: int = 0) -> torch.Tensor:
    """The sum over the group, this rank's chunk of it along ``dim``."""
    if ag.trivial:
        return x
    if x.shape[dim] % ag.size:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                         f"not divisible by {ag.size}")
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // ag.size,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, group=ag.group)
    return out.movedim(0, dim)


def psum_plain(x: torch.Tensor, ag: AxisGroup) -> torch.Tensor:
    """The sum over the group (a new tensor)."""
    if ag.trivial:
        return x.clone()
    out = x.contiguous().clone()
    dist.all_reduce(out, group=ag.group)
    return out


def all_to_all_plain(x: torch.Tensor, ag: AxisGroup, split_axis: int,
                     concat_axis: int) -> torch.Tensor:
    """JAX's tiled ``all_to_all``: chunk j of ``split_axis`` goes to rank j
    of the group; the chunks received are concatenated along
    ``concat_axis`` in the order of the ranks they came from."""
    if ag.trivial:
        return x
    s = ag.size
    if x.shape[split_axis] % s:
        raise ValueError(f"all_to_all: axis {split_axis} of {tuple(x.shape)} "
                         f"not divisible by {s}")
    shape = list(x.shape)
    parts = x.unflatten(split_axis, (s, shape[split_axis] // s)).movedim(split_axis, 0)
    parts = parts.contiguous()
    out = torch.empty_like(parts)
    dist.all_to_all_single(out, parts, group=ag.group)
    # out[i] came from rank i: put it at position i of concat_axis
    out = out.movedim(0, concat_axis)
    return out.flatten(concat_axis, concat_axis + 1)


def shift_plain(x: torch.Tensor, ag: AxisGroup, offset: int = 1) -> torch.Tensor:
    """JAX's ``ppermute`` by ``offset`` around the group's ring: this rank
    sends to index + offset and receives from index - offset. One rank
    (or an offset of a whole turn) is the identity."""
    if ag.trivial or offset % ag.size == 0:
        return x
    x = x.contiguous()
    out = torch.empty_like(x)
    dst = ag.ranks[(ag.index + offset) % ag.size]
    src = ag.ranks[(ag.index - offset) % ag.size]
    ops = [dist.P2POp(dist.isend, x, dst, ag.group),
           dist.P2POp(dist.irecv, out, src, ag.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


# ---------------------------------------------------------------------------
# Differentiable collectives
# ---------------------------------------------------------------------------


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ag, split_axis, concat_axis):
        ctx.ag, ctx.axes = ag, (split_axis, concat_axis)
        return all_to_all_plain(x, ag, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis = ctx.axes
        return all_to_all_plain(g, ctx.ag, concat_axis, split_axis), None, None, None


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ag, offset):
        ctx.ag, ctx.offset = ag, offset
        return shift_plain(x, ag, offset)

    @staticmethod
    def backward(ctx, g):
        return shift_plain(g, ctx.ag, -ctx.offset), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ag, dim):
        ctx.ag, ctx.dim = ag, dim
        return all_gather_plain(x, ag, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_plain(g, ctx.ag, ctx.dim), None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ag):
        ctx.ag = ag
        return psum_plain(x, ag)

    @staticmethod
    def backward(ctx, g):
        return psum_plain(g, ctx.ag), None


def all_to_all(x, ag: AxisGroup, split_axis: int, concat_axis: int):
    return _AllToAll.apply(x, ag, split_axis, concat_axis)


def shift(x, ag: AxisGroup, offset: int = 1):
    return _Shift.apply(x, ag, offset)


def all_gather(x, ag: AxisGroup, dim: int = 0):
    return _AllGather.apply(x, ag, dim)


def psum(x, ag: AxisGroup):
    return _Psum.apply(x, ag)


def chunk_of(x: torch.Tensor, ag: AxisGroup, dim: int = 0) -> torch.Tensor:
    """This rank's contiguous chunk of ``x`` along ``dim`` (a view)."""
    if x.shape[dim] % ag.size:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} not divisible by {ag.size}")
    n = x.shape[dim] // ag.size
    return x.narrow(dim, ag.index * n, n)


# ---------------------------------------------------------------------------
# Point to point (the pipeline's stage hand-off)
# ---------------------------------------------------------------------------


class _SendForward(torch.autograd.Function):
    """Send ``x`` to global rank ``peer``; returns a 0-dim zero tied to the
    graph, whose backward receives ``x``'s gradient from ``peer``."""

    @staticmethod
    def forward(ctx, x, peer, group, tag):
        ctx.shape, ctx.dtype, ctx.device = x.shape, x.dtype, x.device
        ctx.peer, ctx.group, ctx.tag = peer, group, tag
        dist.send(x.contiguous(), peer, group=group, tag=tag)
        return x.new_zeros(())

    @staticmethod
    def backward(ctx, g):
        grad = torch.empty(ctx.shape, dtype=ctx.dtype, device=ctx.device)
        dist.recv(grad, ctx.peer, group=ctx.group, tag=ctx.tag)
        return grad, None, None, None


class _RecvForward(torch.autograd.Function):
    """Receive a tensor like ``like`` from global rank ``peer``; its
    backward sends the gradient back to ``peer``. ``anchor`` (a tensor that
    requires grad, or None) only ties the node into the graph."""

    @staticmethod
    def forward(ctx, like, anchor, peer, group, tag):
        ctx.peer, ctx.group, ctx.tag = peer, group, tag
        out = torch.empty_like(like)
        dist.recv(out, peer, group=group, tag=tag)
        return out

    @staticmethod
    def backward(ctx, g):
        dist.send(g.contiguous(), ctx.peer, group=ctx.group, tag=ctx.tag)
        return None, None, None, None, None


def send_forward(x: torch.Tensor, peer: int, group, tag: int) -> torch.Tensor:
    return _SendForward.apply(x, peer, group, tag)


def recv_forward(like: torch.Tensor, anchor: Optional[torch.Tensor], peer: int, group,
                 tag: int) -> torch.Tensor:
    return _RecvForward.apply(like, anchor, peer, group, tag)
