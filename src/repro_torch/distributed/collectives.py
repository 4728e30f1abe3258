"""The collectives of training over a :class:`~repro_torch.distributed.
mesh.DeviceMesh`, as autograd functions.

A rank's autograd graph never reaches into another rank's: each function
below makes its collective in ``forward`` on tensors autograd does not
track, and its ``backward`` makes the transposed collective itself — so
the other ranks' parts arrive detached, and no rank's backward writes a
gradient into another's graph. Each carries the rank and its
:meth:`DeviceMesh.run` call (a :class:`Comm`) in ``ctx``: on the card
autograd runs a rank's backward on its device's worker thread, where the
mesh's thread-locals are not the rank's.

Conventions, Megatron's: an activation is *replicated* over an axis
(every rank of the group holds the same bits, and its gradient comes out
the same on each) or *split* over it (each rank its chunk, or its
partial sum).

- :func:`fsdp_gather` — a weight split over the FSDP axes (``data``,
  or ``("pod", "data")`` flattened pod-major) gathered whole at use:
  all-gather forward, rank-ordered reduce-scatter backward;
- :func:`copy_to` — Megatron's *f*, ahead of a product whose columns are
  split: identity forward, all-reduce backward;
- :func:`reduce_from` — Megatron's *g*, after a product whose
  contraction is split: all-reduce forward, identity backward;
- :func:`gather_from` — split chunks made whole: all-gather forward,
  the rank's chunk of the gradient backward. Where every rank of the
  group computes the same whole gradient (a layer run whole on each
  model rank, on the same input), that chunk is the leaf's gradient:
  no sum;
- :func:`split_to` — a replicated tensor cut to the rank's chunk: slice
  forward, all-gather of the chunks' gradients backward;
- :func:`scatter_from` — Megatron's *g* where the sum stays split (the
  residual stream held split over ``model``, Megatron-SP): the rank's
  chunk of the group's sum forward (reduce-scatter), all-gather of the
  chunks' gradients backward. Each chunk is bitwise the one
  :func:`reduce_from` would give, summed in the same order;
- :func:`vocab_nll` — the cross-entropy of logits split over ``model``
  by vocabulary (Megatron's vocab-parallel loss): every rank of the
  group gets the same per-position negative log likelihood, and its
  logits' gradient ``softmax - onehot`` over its own columns only.

Every sum is the mesh's rank-ordered one, so the ranks of a group get
the same bits forward and backward. An ``axis`` is one mesh axis or a
tuple of them, flattened in the order named.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


FSDP = ("pod", "data")   # the batch / FSDP group; a two-axis mesh: data


class Comm(NamedTuple):
    """A rank of a mesh and the :meth:`DeviceMesh.run` call it serves."""
    mesh: object
    rank: int
    call: object

    def size(self, axis: str) -> int:
        return len(self.mesh.group(self.rank, axis))

    def index(self, axis: str) -> int:
        return self.mesh.group(self.rank, axis).index(self.rank)

    def all_gather(self, x, dim, axis):
        return self.mesh.all_gather(x.contiguous(), dim, axis,
                                    rank=self.rank, call=self.call)

    def all_reduce(self, x, axis):
        return self.mesh.all_reduce(x.contiguous(), axis, rank=self.rank,
                                    call=self.call)

    def reduce_scatter(self, x, dim, axis):
        return self.mesh.reduce_scatter(x.contiguous(), dim, axis,
                                        rank=self.rank, call=self.call)

    def chunk(self, x, dim, axis):
        """The rank's chunk of ``x`` along ``dim``: one of the group's
        size, in group order."""
        w = x.shape[dim] // self.size(axis)
        return x.narrow(dim, self.index(axis) * w, w)


class _FsdpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axes, comm):
        ctx.dim, ctx.axes, ctx.comm = dim, axes, comm
        return comm.all_gather(x, dim, axes)

    @staticmethod
    def backward(ctx, g):
        return (ctx.comm.reduce_scatter(g, ctx.dim, ctx.axes), None, None,
                None)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, comm):
        ctx.axis, ctx.comm = axis, comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_reduce(g, ctx.axis), None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, comm):
        return comm.all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis, comm):
        ctx.dim, ctx.axis, ctx.comm = dim, axis, comm
        return comm.all_gather(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return (ctx.comm.chunk(g, ctx.dim, ctx.axis).contiguous(), None,
                None, None)


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis, comm):
        ctx.dim, ctx.axis, ctx.comm = dim, axis, comm
        return comm.chunk(x, dim, axis).contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_gather(g, ctx.dim, ctx.axis), None, None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis, comm):
        ctx.dim, ctx.axis, ctx.comm = dim, axis, comm
        return comm.reduce_scatter(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_gather(g, ctx.dim, ctx.axis), None, None, None


class _VocabNll(torch.autograd.Function):
    """z (..., V / n) fp32, the rank's vocab columns ``index * V / n``
    on; labels (...) over the whole vocab -> nll (...), the same bits on
    every rank of the group. lse = max + log(sum exp(z - max)), the max
    over the group's maxima (exact), the sums of exp added in rank
    order; the gold logit the one rank's whose columns hold the label,
    zero elsewhere, summed in rank order (exact)."""

    @staticmethod
    def forward(ctx, z, labels, axis, comm):
        v = z.shape[-1]
        local = labels.long() - comm.index(axis) * v
        inside = (local >= 0) & (local < v)
        local = local.clamp(0, v - 1)[..., None]
        m = comm.all_gather(z.amax(-1, keepdim=True), -1, axis).amax(
            -1, keepdim=True)
        lse = m[..., 0] + torch.log(comm.all_reduce(
            torch.exp(z - m).sum(-1), axis))
        gold = comm.all_reduce(torch.where(
            inside, z.gather(-1, local)[..., 0], 0.0), axis)
        ctx.save_for_backward(z, lse, local, inside)
        return lse - gold

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        z, lse, local, inside = ctx.saved_tensors
        p = torch.exp(z - lse[..., None])
        p.scatter_(-1, local, p.gather(-1, local)
                   - inside[..., None].to(p.dtype))
        return p * g[..., None], None, None, None


def _lone(comm: Comm, axis: str) -> bool:
    return comm.size(axis) == 1


def fsdp_gather(x: torch.Tensor, dim: int, comm: Comm, axes=FSDP
                ) -> torch.Tensor:
    """``x``, split along ``dim`` over ``axes``, gathered whole."""
    axes = tuple(axes)
    return x if _lone(comm, axes) else _FsdpGather.apply(x, dim, axes,
                                                         comm)


def copy_to(x: torch.Tensor, axis: str, comm: Comm) -> torch.Tensor:
    """Megatron's *f*: ``x`` as it is, its gradient summed over ``axis``."""
    return x if _lone(comm, axis) else _Copy.apply(x, axis, comm)


def reduce_from(x: torch.Tensor, axis: str, comm: Comm) -> torch.Tensor:
    """Megatron's *g*: the sum of the group's ``x``, its gradient passed
    to each as it is."""
    return x if _lone(comm, axis) else _Reduce.apply(x, axis, comm)


def gather_from(x: torch.Tensor, dim: int, axis: str, comm: Comm
                ) -> torch.Tensor:
    """The group's chunks of ``x`` concatenated along ``dim``."""
    return x if _lone(comm, axis) else _Gather.apply(x, dim, axis, comm)


def split_to(x: torch.Tensor, dim: int, axis: str, comm: Comm
             ) -> torch.Tensor:
    """The rank's chunk of the replicated ``x`` along ``dim``."""
    return x if _lone(comm, axis) else _Split.apply(x, dim, axis, comm)


def scatter_from(x: torch.Tensor, dim: int, axis: str, comm: Comm
                 ) -> torch.Tensor:
    """The rank's chunk along ``dim`` of the sum of the group's ``x``;
    its gradient the chunks' gradients gathered."""
    return x if _lone(comm, axis) else _Scatter.apply(x, dim, axis, comm)


def vocab_nll(z: torch.Tensor, labels: torch.Tensor, axis: str, comm: Comm
              ) -> torch.Tensor:
    """Per position, the negative log likelihood of ``labels`` under the
    logits whose vocabulary the group splits, ``z`` the rank's columns
    (:class:`_VocabNll`)."""
    return _VocabNll.apply(z, labels, axis, comm)
