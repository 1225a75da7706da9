"""Mixture-of-experts feed-forward with expert parallelism: the counterpart
of ``torchft_tpu/models/moe.py`` (GShard / Switch routing, arXiv:2006.16668
and arXiv:2101.03961), with its math exactly.

- Routing builds dense dispatch and combine tensors ``[T, n_exp, C]`` at
  static shapes: each token's top-k experts by router probability, its
  slot in each expert's buffer of capacity C in k-major order (every
  token's first choice before anyone's second), tokens past C dropped
  (their residual path carries them).
- The experts are stacked on a leading axis, one batched product for all.
- The Switch load-balance loss: ``n_exp * sum(f * p)``, f the fraction of
  first choices an expert gets, p its mean router probability.

The JAX package routes the group's whole batch in one program, and XLA
inserts the exchanges that its sharding annotations imply.  Here each rank
holds its slice of the batch over the batch axes ("data", "fsdp"), and the
collectives are placed by hand (``parallel/functional.py``):

- **Routing over the group's batch.**  C comes from the group's token
  count; a rank's slot positions are offset by the per-choice, per-expert
  counts of the ranks before it (an all-gather of a ``[k, n_exp]`` count
  tensor over the batch axes); f and p are summed over the batch axes
  before their product.  So the same tokens drop as in one program.
- **Expert parallelism.**  The batch is replicated over "expert"; each rank
  runs its ``n_exp / P`` experts on its slice of ``dispatch`` and sums the
  partial outputs over "expert" (``reduce_from``).  The input enters
  through ``copy_to`` (its gradient summed over "expert"), the router's
  logits over its expert columns are gathered (``gather_from``), and the
  gate values pass ``copy_to`` too: each rank's gradient reaches them only
  through its own experts.
- **One rounding.**  The combine's product leaves its f32 accumulator
  unrounded, is summed over "expert" where there is one, and is rounded to
  the compute dtype once: sharded or not, a token's output takes one
  rounding (two, one a rank, flip near-tied routing choices in later
  layers in bf16).
- **Ties.**  ``jax.lax.top_k`` puts the lower index first on equal values;
  a stable descending sort does the same (``torch.topk`` promises no
  order).

Nothing here is a TPU kernel: the einsums are plain products.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import torch
import torch.nn.functional as F

from torchft_tpu_torch.parallel.functional import (
    all_gather_cat,
    all_sum,
    copy_to,
    gather_from,
    reduce_from,
)

__all__ = ["moe_capacity", "moe_ffn", "route_top_k"]

# The axes that split a group's batch, in batch-shard order ("data" major);
# the mesh's own list (parallel/mesh.py BATCH_AXES).
_BATCH_AXES = ("data", "fsdp")


def moe_capacity(tokens: int, n_experts: int, top_k: int, capacity_factor: float) -> int:
    """Static per-expert token capacity, padded to a multiple of 8."""
    cap = int(tokens * top_k * capacity_factor / n_experts) + 1
    return max(8, -(-cap // 8) * 8)


def route_top_k(probs: torch.Tensor, top_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of each row's ``top_k`` largest, the lower index
    first among equals (``jax.lax.top_k``'s order)."""
    idx = torch.sort(probs.detach(), dim=-1, descending=True, stable=True).indices[:, :top_k]
    return probs.gather(1, idx), idx


class _F32Product(torch.autograd.Function):
    """``a @ b`` of compute-dtype operands with an f32 result (the product's
    own accumulator, not rounded); the gradients in the operands' dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if a.is_cuda and a.dtype != torch.float32:
            # The tensor cores' product, its f32 accumulator written out.
            return torch.mm(a, b, out_dtype=torch.float32)
        return a.float() @ b.float()

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        grad = grad.to(a.dtype)
        return grad @ b.t(), a.t() @ grad


def _batch_groups(ftmesh: Any) -> List[Any]:
    if ftmesh is None:
        return []
    return [ftmesh.group(a) for a in _BATCH_AXES if ftmesh.size(a) > 1]


def _expert_group(ftmesh: Any) -> Any:
    if ftmesh is None or ftmesh.size("expert") == 1:
        return None
    return ftmesh.group("expert")


def _counts_before(counts: torch.Tensor, ftmesh: Any) -> Tuple[torch.Tensor, int]:
    """(offset [k, n_exp], shards): where this rank's slots start for each
    choice and expert in the group's k-major order, from every batch
    shard's ``counts`` [k, n_exp]."""
    if not _batch_groups(ftmesh):
        every, shard = counts[None], 0
    else:
        every = counts[None]
        for axis in reversed(_BATCH_AXES):  # "fsdp" minor, then "data"
            if ftmesh.size(axis) > 1:
                every = all_gather_cat(every[None], 0, ftmesh.group(axis)).flatten(0, 1)
        shard = ftmesh.batch_shard()[0]
    # Every shard's earlier choices, then the earlier shards' same choice.
    totals = every.sum(0)                                  # [k, n_exp]
    earlier_choices = totals.cumsum(0) - totals
    return earlier_choices + every[:shard].sum(0), every.shape[0]


def moe_ffn(
    x: torch.Tensor,
    router: torch.Tensor,
    w_gate: torch.Tensor,
    w_up: torch.Tensor,
    w_down: torch.Tensor,
    *,
    top_k: int = 2,
    capacity_factor: float = 1.25,
    dtype: torch.dtype = torch.bfloat16,
    ftmesh: Any = None,
    record: Optional[list] = None,
    route: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE feed-forward.

    Args:
        x: [B, S, E] activations (this rank's slice of the group's batch).
        router: [E, n_exp] routing weights, or this rank's columns of them
            over "expert" (kept f32: routing logits are sensitive).
        w_gate / w_up: [X, E, F]; w_down: [X, F, E]: the stacked experts,
            X = n_exp, or this rank's n_exp / P over "expert".
        ftmesh: the in-group mesh (``parallel/mesh.py``), or None.
        record: a list that receives this call's routing (gate indices,
            the router's own top-k, kept choices, capacity), detached, for
            inspection.
        route: [T, k] expert choices to take instead of the router's
            top-k (another run's recorded ``gate_idx``, to hold two runs
            at one routing); the gates are this router's probabilities
            at them.

    Returns:
        (y, aux): y [B, S, E] in x's dtype; aux the f32 load-balance term
        of the group's batch.
    """
    B, S, E = x.shape
    T = B * S
    eg = _expert_group(ftmesh)
    xf = x.reshape(T, E)
    xe = xf if eg is None else copy_to(xf, eg)
    logits = xe.float() @ router.float()
    if eg is not None:
        logits = gather_from(logits, eg)
    n_exp = logits.shape[1]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, own_idx = route_top_k(probs, top_k)
    gate_idx = own_idx
    if route is not None:
        gate_idx = route.to(own_idx.device)
        gate_vals = probs.gather(1, gate_idx)
    # Renormalised: the kept gates make a convex mixture.
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True).clamp_min(1e-9)

    # Each (token, choice)'s slot in its expert's buffer, k-major over the
    # group's batch in global order.
    onehot = F.one_hot(gate_idx, n_exp)                          # [T, k, n_exp]
    offset, shards = _counts_before(onehot.sum(0), ftmesh)
    C = moe_capacity(T * shards, n_exp, top_k, capacity_factor)
    pos = onehot.cumsum(0) - 1 + offset                          # [T, k, n_exp]
    within = (pos < C) & (onehot > 0)
    slot = F.one_hot(torch.where(within, pos, -1).amax(-1).clamp_min(0), C).float()
    kept = within.any(-1)                                        # [T, k]
    if record is not None:
        record.append({"gate_idx": gate_idx.detach(), "own_idx": own_idx, "kept": kept.detach(),
                       "capacity": C})

    # This rank's experts: dispatch[t, e, c] = 1 where token t sits in slot
    # c of expert e; combine carries its gate.  A product batched over t
    # (never a [T, k, n_exp, C] tensor).
    xl = w_gate.shape[0]
    lo = 0 if eg is None else ftmesh.coordinate("expert") * xl
    expert_oh = (onehot[:, :, lo:lo + xl] * within[:, :, lo:lo + xl]).float()  # [T, k, X]
    gates = gate_vals if eg is None else copy_to(gate_vals, eg)
    dispatch = torch.bmm(expert_oh.transpose(1, 2), slot)        # [T, X, C]
    combine = torch.bmm((expert_oh * gates[..., None]).transpose(1, 2), slot)

    xin = (dispatch.to(dtype).reshape(T, xl * C).t() @ xe.to(dtype)).reshape(xl, C, E)
    h = F.silu(torch.bmm(xin, w_gate.to(dtype))) * torch.bmm(xin, w_up.to(dtype))
    out = torch.bmm(h, w_down.to(dtype))                         # [X, C, E]
    y = _F32Product.apply(combine.to(dtype).reshape(T, xl * C), out.reshape(xl * C, E))
    if eg is not None:
        y = reduce_from(y, eg)

    # Switch load balance over the group's batch: f (no gradient) and p.
    f = onehot[:, 0, :].float().sum(0)
    p = probs.sum(0)
    for group in _batch_groups(ftmesh):
        torch.distributed.all_reduce(f, group=group)
        p = all_sum(p, group)
    aux = n_exp * torch.sum((f / (T * shards)) * (p / (T * shards)))
    return y.to(dtype).reshape(B, S, E).to(x.dtype), aux.float()
