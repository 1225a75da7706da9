"""In-group collectives with their gradients, over one mesh axis's process
group: what the port's model places by hand where XLA inserts collectives
from sharding annotations in the JAX package.

- :func:`gather_shards`: a parameter sharded over a batch axis ("data",
  "fsdp") is all-gathered for the forward; its gradient is reduce-scattered
  and averaged over the axis's ranks, each of which computed its own slice
  of the batch.
- :func:`average_grad`: identity forward; the gradient averaged over the
  axis (a parameter replicated over a batch axis).
- :func:`copy_to` / :func:`reduce_from`: Megatron's f and g over the
  ``tensor`` axis.  ``copy_to`` is identity forward and sums the gradient;
  ``reduce_from`` sums the partial results of a row-parallel product (in
  f32) and passes the gradient through.
- :func:`gather_from`: concatenates the ranks' slices of the last dim; the
  gradient keeps this rank's slice.

Every collective is a blocking ``torch.distributed`` call on plain tensors,
on whatever backend the group has (NCCL on separate cards, gloo where ranks
share one).  Gradient sums and averages run in the gradient's dtype.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["all_gather_cat", "average_grad", "copy_to", "gather_from", "gather_shards",
           "reduce_from"]


def all_gather_cat(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's tensors concatenated along ``dim``, in rank order (no
    gradient)."""
    n = dist.get_world_size(group)
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class _GatherShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_cat(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        n = dist.get_world_size(ctx.group)
        parts = [p.contiguous() for p in grad.chunk(n, dim=ctx.dim)]
        out = torch.empty_like(parts[0])
        dist.reduce_scatter(out, parts, group=ctx.group)
        return out.div_(n), None, None


class _AverageGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad.div_(dist.get_world_size(ctx.group)), None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _sum(grad, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather_cat(x, x.dim() - 1, group)

    @staticmethod
    def backward(ctx, grad):
        n, r = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        return grad.chunk(n, dim=-1)[r].contiguous(), None


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group's ranks, accumulated in f32 (a bf16 partial
    product is summed as the unsharded matmul accumulates it)."""
    acc = x.to(torch.float32, copy=True).contiguous()
    dist.all_reduce(acc, group=group)
    return acc.to(x.dtype)


def gather_shards(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return _GatherShards.apply(x, dim, group)


def average_grad(x: torch.Tensor, group) -> torch.Tensor:
    return _AverageGrad.apply(x, group)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFrom.apply(x, group)


def gather_from(x: torch.Tensor, group) -> torch.Tensor:
    return _GatherFrom.apply(x, group)
