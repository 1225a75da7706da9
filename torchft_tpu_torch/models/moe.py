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
holds its slice of the group's tokens: of the batch over the batch axes
("data", "fsdp"), and of every sequence over "sequence"; the collectives
are placed by hand (``parallel/functional.py``):

- **Routing over the group's tokens.**  The slot order is the JAX one over
  all B·S tokens of the group, batch-major, then sequence-major (in the
  order the tokens arrive: zigzag's permuted one under that ring layout).
  C comes from the group's token count; a rank's slot positions are offset
  by the earlier choices' totals, the earlier batch shards' counts, the
  earlier rows of its own shard over every "sequence" rank, and the lower
  "sequence" ranks' part of the same row (per-row counts ``[B, k, n_exp]``
  all-gathered over "sequence", per-shard totals over the batch axes).  f
  and p are summed over the batch axes and "sequence" before their
  product.  So the same tokens drop as in one program.  The sums' gradient
  (``all_sum``) sums over the axis, and ``FTMesh.materialize`` averages a
  replicated parameter's gradient over it: over "sequence" the same
  arithmetic as over "data".
- **Expert parallelism.**  The batch is replicated over "expert"; each rank
  runs its ``n_exp / P`` experts on its slice of ``dispatch`` and sums the
  partial outputs over "expert" (``reduce_from``).  The input enters
  through ``copy_to`` (its gradient summed over "expert"), the router's
  logits over its expert columns are gathered (``gather_from``), and the
  gate values pass ``copy_to`` too: each rank's gradient reaches them only
  through its own experts.
- **The experts' MLP dim over "tensor".**  Each rank holds ``F / tp`` of
  every expert's ``w_gate``, ``w_up`` (``[X, E, F / tp]``) and ``w_down``
  (``[X, F / tp, E]``); routing, dispatch and combine run alike on every
  "tensor" rank, on the residual stream before the tensor axis's
  ``copy_to`` (the caller's).  The dispatched input enters the rank's
  F-slice through ``copy_to`` (its gradient sums the partial products), and
  the down-projection's partial ``[X, C, E]`` leaves through
  ``reduce_from``, summed in f32 and rounded once.
- **One rounding.**  The combine's product leaves its f32 accumulator
  unrounded, is summed over "expert" where there is one, and is rounded to
  the compute dtype once: sharded or not, a token's output takes one
  rounding (two, one a rank, flip near-tied routing choices in later
  layers in bf16).  The down-projection's partial sums over "tensor" keep
  the same rule.
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
    """``a @ b`` (or a batched ``bmm``) of compute-dtype operands with an
    f32 result (the product's own accumulator, not rounded); the gradients
    in the operands' dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if a.is_cuda and a.dtype != torch.float32:
            # The tensor cores' product, its f32 accumulator written out.
            mm = torch.bmm if a.dim() == 3 else torch.mm
            return mm(a, b, out_dtype=torch.float32)
        return a.float() @ b.float()

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        grad = grad.to(a.dtype)
        return grad @ b.transpose(-1, -2), a.transpose(-1, -2) @ grad


def _group(ftmesh: Any, axis: str) -> Any:
    """``axis``'s process group where the mesh has it above 1, else None."""
    if ftmesh is None or ftmesh.size(axis) == 1:
        return None
    return ftmesh.group(axis)


def _token_groups(ftmesh: Any) -> List[Any]:
    """The groups of the axes that split the group's tokens: the batch axes
    and "sequence"."""
    return [g for g in (_group(ftmesh, a) for a in _BATCH_AXES + ("sequence",)) if g is not None]


def _rows_over_sequence(counts: torch.Tensor, ftmesh: Any) -> torch.Tensor:
    """Every "sequence" rank's per-row counts ``[n, B, k, n_exp]``, in rank
    order, from this rank's ``counts`` [B, k, n_exp]."""
    group = _group(ftmesh, "sequence")
    return counts[None] if group is None else all_gather_cat(counts[None], 0, group)


def _counts_before(counts: torch.Tensor, ftmesh: Any) -> Tuple[torch.Tensor, int]:
    """(offset [B, k, n_exp], shards): where each of this rank's rows starts
    its slots for each choice and expert in the group's k-major order, from
    every rank's per-row ``counts`` [B, k, n_exp]; ``shards`` the group's
    token count over this rank's.  A row's offset is the earlier choices'
    totals, the earlier batch shards', its own shard's earlier rows over
    every "sequence" rank, and the lower "sequence" ranks' part of it."""
    rows = _rows_over_sequence(counts, ftmesh)             # [n, B, k, n_exp]
    every = rows.sum((0, 1))[None]                         # this batch shard's [1, k, n_exp]
    shard = 0
    for axis in reversed(_BATCH_AXES):  # "fsdp" minor, then "data"
        group = _group(ftmesh, axis)
        if group is not None:
            every = all_gather_cat(every[None], 0, group).flatten(0, 1)
            shard = ftmesh.batch_shard()[0]
    totals = every.sum(0)                                  # [k, n_exp]
    earlier_choices = totals.cumsum(0) - totals
    by_row = rows.sum(0)                                   # [B, k, n_exp]
    earlier_rows = by_row.cumsum(0) - by_row
    seq_rank = 0 if ftmesh is None else ftmesh.coordinate("sequence")
    offset = earlier_choices + every[:shard].sum(0) + earlier_rows + rows[:seq_rank].sum(0)
    return offset, every.shape[0] * rows.shape[0]


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
        x: [B, S, E] activations: this rank's slice of the group's batch
            (batch shard ``s`` holds the group's rows ``s * B`` on, as the
            JAX batch sharding places them), and of every sequence over
            "sequence"; under "tensor" the residual stream before the
            axis's ``copy_to``.
        router: [E, n_exp] routing weights, or this rank's columns of them
            over "expert" (kept f32: routing logits are sensitive).
        w_gate / w_up: [X, E, F]; w_down: [X, F, E]: the stacked experts,
            X = n_exp, or this rank's n_exp / P over "expert"; F, or this
            rank's F / tp over "tensor".
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
        of the group's tokens.
    """
    B, S, E = x.shape
    T = B * S
    eg, tg = _group(ftmesh, "expert"), _group(ftmesh, "tensor")
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
    # group's tokens in global order: a row's own earlier tokens, then its
    # offset.
    onehot = F.one_hot(gate_idx, n_exp)                          # [T, k, n_exp]
    rows = onehot.reshape(B, S, top_k, n_exp)
    offset, shards = _counts_before(rows.sum(1), ftmesh)
    C = moe_capacity(T * shards, n_exp, top_k, capacity_factor)
    pos = (rows.cumsum(1) - 1 + offset[:, None]).reshape(T, top_k, n_exp)
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
    if tg is not None:
        xin = copy_to(xin, tg)
    h = F.silu(torch.bmm(xin, w_gate.to(dtype))) * torch.bmm(xin, w_up.to(dtype))
    if tg is None:
        out = torch.bmm(h, w_down.to(dtype))                     # [X, C, E]
    else:
        # The F-slices' partial products, summed in f32, rounded once.
        out = reduce_from(_F32Product.apply(h, w_down.to(dtype)), tg).to(dtype)
    y = _F32Product.apply(combine.to(dtype).reshape(T, xl * C), out.reshape(xl * C, E))
    if eg is not None:
        y = reduce_from(y, eg)

    # Switch load balance over the group's tokens: f (no gradient) and p.
    f = onehot[:, 0, :].float().sum(0)
    p = probs.sum(0)
    for group in _token_groups(ftmesh):
        torch.distributed.all_reduce(f, group=group)
        p = all_sum(p, group)
    aux = n_exp * torch.sum((f / (T * shards)) * (p / (T * shards)))
    return y.to(dtype).reshape(B, S, E).to(x.dtype), aux.float()
