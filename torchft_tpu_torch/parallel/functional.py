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
- :func:`all_sum`: the sum over the group with the sum's own adjoint (a sum
  of the gradients): statistics every rank of a batch axis uses whole, such
  as the mixture of experts' load-balance means over the group's batch.
- :func:`ring_hop`: ``lax.ppermute`` over a ring, each rank's tensor to the
  rank ``shift`` on; the gradient takes the inverse hop.  The pipeline's
  stage-to-stage link (``parallel/pipeline.py``) and ring attention's K/V
  rotation (``ops/ring_attention.py``); :func:`ring_shift` is the same hop
  without a gradient.
- :func:`all_to_all`: ``lax.all_to_all(tiled=True)``: each rank's tensor
  split along one dim, chunk ``i`` to rank ``i``, the chunks received
  concatenated along another in rank order; the gradient takes the inverse
  exchange.  Ulysses' head/sequence swap (``ops/ulysses.py``).
- :func:`mean_value`: the group's mean as the value, this rank's own
  gradient: a loss each rank computes over its own tokens, reported as the
  group's (the parameters' gradients are then averaged over the group).

Every collective is a blocking ``torch.distributed`` call on plain tensors,
on whatever backend the group has (NCCL on separate cards, gloo where ranks
share one).  Gradient sums and averages run in the gradient's dtype.  The
ring hop's point-to-point calls take CUDA tensors over NCCL; over gloo a
CUDA tensor is staged through host memory by hand (gloo's point-to-point
calls read host memory), never by a fallback that hides which path ran.
The exchange runs gloo's all-to-all on CUDA tensors directly (it takes
device memory, as its all-gather and all-reduce do).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["all_gather_cat", "all_sum", "all_to_all", "average_grad", "copy_to", "exchange",
           "gather_from", "gather_shards", "mean_value", "reduce_from", "ring_hop", "ring_shift"]


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


class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _sum(grad, ctx.group), None


class _RingHop(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return ring_shift(x, group, shift)

    @staticmethod
    def backward(ctx, grad):
        return ring_shift(grad, ctx.group, -ctx.shift), None, None


def ring_shift(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """Sends ``x`` to the rank ``shift`` on in the group's ring and returns
    what the rank ``shift`` back sent (every rank calls it; no gradient)."""
    n = dist.get_world_size(group)
    if n == 1 or shift % n == 0:
        return x.clone()
    r = dist.get_rank(group)
    dst = dist.get_global_rank(group, (r + shift) % n)
    src = dist.get_global_rank(group, (r - shift) % n)
    send = x.detach().contiguous()
    # gloo's send and recv take host memory only (a CUDA tensor fails with
    # "Bad address"): stage it through the host.
    staged = send.is_cuda and dist.get_backend(group) == "gloo"
    if staged:
        send = send.to("cpu")
    recv = torch.empty_like(send)
    works = dist.batch_isend_irecv([dist.P2POp(dist.isend, send, dst, group),
                                    dist.P2POp(dist.irecv, recv, src, group)])
    for w in works:
        w.wait()
    return recv.to(x.device) if staged else recv


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group):
        ctx.dims, ctx.group = (split_dim, concat_dim), group
        return exchange(x, split_dim, concat_dim, group)

    @staticmethod
    def backward(ctx, grad):
        split_dim, concat_dim = ctx.dims
        return exchange(grad, concat_dim, split_dim, ctx.group), None, None, None


def exchange(x: torch.Tensor, split_dim: int, concat_dim: int, group) -> torch.Tensor:
    """``x`` split into the group's size of chunks along ``split_dim``,
    chunk ``i`` sent to rank ``i``, and the chunks received concatenated
    along ``concat_dim`` in rank order (every rank calls it; no gradient).
    ``split_dim`` must divide evenly."""
    n = dist.get_world_size(group)
    if x.shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of shape {tuple(x.shape)} does not split over "
                         f"{n} ranks")
    send = torch.stack(x.chunk(n, dim=split_dim)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat_dim)


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


def all_sum(x: torch.Tensor, group) -> torch.Tensor:
    return _AllSum.apply(x, group)


def ring_hop(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    return _RingHop.apply(x, group, shift)


def all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int, group) -> torch.Tensor:
    return _AllToAll.apply(x, split_dim, concat_dim, group)


def mean_value(x: torch.Tensor, group) -> torch.Tensor:
    """``x``'s mean over the group as the value, with ``x``'s own gradient."""
    mean = x.detach().clone()
    dist.all_reduce(mean, group=group)
    mean.div_(dist.get_world_size(group))
    return x + (mean - x.detach())
