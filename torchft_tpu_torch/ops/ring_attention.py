"""Ring attention: causal attention over a sequence-sharded mesh axis.

The counterpart of ``torchft_tpu/ops/ring_attention.py``.  Q/K/V are
sharded along the sequence over the "sequence" axis's process group; each
rank keeps its Q shard and the K/V shards rotate around the ring, one
neighbour hop a tick (:func:`~torchft_tpu_torch.parallel.functional.ring_shift`,
host-staged over gloo on CUDA tensors).  Each incoming block's attention is
merged into the running accumulator by the online log-sum-exp recurrence
(:func:`_merge`), so no rank holds more than one ``[S_local, S_local]``
score block.

Two sequence layouts, as in the JAX package:

- ``contiguous``: rank i holds positions [i S/N, (i+1) S/N); a causal
  block above the diagonal is skipped (its products, never its hop).
- ``zigzag``: the sequence is cut into 2N chunks and rank i holds chunks
  (i, 2N-1-i) (:func:`to_zigzag` permutes it once on the host, with the
  targets and the rope positions); every round is half a block of unmasked
  work on every rank.

The block products are the JAX package's einsums, not a kernel: bf16
operands with f32 results (``torch.bmm(..., out_dtype=torch.float32)`` on
the card), p cast to v's dtype before the PV product.  The JAX package
differentiates its ring by autodiff; here :class:`_RingAttention` carries
its own backward, which recomputes each block's probabilities from the
saved global log-sum-exp and sends each K/V block's gradient around the
ring with it, home after N hops.  So every rank runs the same autograd
graph, and meets the same hops in the same order in the forward and the
backward, whichever blocks its causal branches skip.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist

from torchft_tpu_torch.parallel.functional import all_gather_cat, ring_shift

__all__ = ["from_zigzag", "inverse_zigzag_permutation", "ring_attention",
           "ring_attention_sharded", "to_zigzag", "zigzag_permutation"]

_NEG_INF = -1e30


def _product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (batched) with an f32 result: the tensor cores' f32
    accumulator of compute-dtype operands on the card."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _scores(q, k, scale: float, row0: int, col0: int, causal: bool) -> torch.Tensor:
    """f32 scores q kᵀ·scale of one block, with global causal masking."""
    s = _product(q, k.transpose(1, 2)) * scale
    if causal:
        rows = row0 + torch.arange(s.shape[-2], device=s.device)[:, None]
        cols = col0 + torch.arange(s.shape[-1], device=s.device)[None, :]
        s = torch.where(rows >= cols, s, _NEG_INF)
    return s


def _block_attn(q, k, v, scale: float, row0: int, col0: int, causal: bool):
    """One [Sq_local x Sk_local] attention block with global causal masking.

    Returns the unnormalized out, the running max m and the sum l (f32).
    q/k/v: [BH, S, D] in the input dtype; row0/col0: global block offsets."""
    s = _scores(q, k, scale, row0, col0, causal)
    m = s.amax(dim=-1, keepdim=True)
    # Rows with every position masked: exp(-inf - -inf) traps; clamp m.
    m_safe = torch.clamp_min(m, -1e29)
    p = torch.exp(s - m_safe)
    l = p.sum(dim=-1, keepdim=True)
    o = _product(p.to(v.dtype), v)
    return o, m_safe, l


def _block_grads(q, k, v, do, lse, delta, scale: float, row0: int, col0: int, causal: bool):
    """(dq, dk, dv) of one block, f32, from the global log-sum-exp ``lse``
    and ``delta`` = rowsum(dO·O) of the rows (both [BH, Sq, 1] f32)."""
    p = torch.exp(_scores(q, k, scale, row0, col0, causal) - lse)
    dv = _product(p.to(do.dtype).transpose(1, 2), do)
    ds = (p * (_product(do, v.transpose(1, 2)) - delta)).to(q.dtype)
    return _product(ds, k) * scale, _product(ds.transpose(1, 2), q) * scale, dv


def _neutral(q: torch.Tensor) -> tuple:
    """The merge's neutral element for q's rows (a skipped block)."""
    col = q.new_zeros(q.shape[:-1] + (1,), dtype=torch.float32)
    return q.new_zeros(q.shape, dtype=torch.float32), col + _NEG_INF / 10, col


def _merge(acc, m, l, o_t, m_t, l_t):
    """Online log-sum-exp merge of one block contribution."""
    m_new = torch.maximum(m, m_t)
    alpha = torch.exp(m - m_new)
    beta = torch.exp(m_t - m_new)
    return acc * alpha + o_t * beta, m_new, l * alpha + l_t * beta


def _start(q: torch.Tensor) -> tuple:
    """An empty accumulator (acc, m, l) for q's rows."""
    col = q.new_zeros(q.shape[:-1] + (1,), dtype=torch.float32)
    return q.new_zeros(q.shape, dtype=torch.float32), col + _NEG_INF, col


def _finish(acc, m, l) -> tuple:
    """(out, lse): the output divides by l only where l != 0; a row that saw
    nothing has lse +inf, so its probabilities are 0 in the backward."""
    out = acc / torch.where(l == 0.0, 1.0, l)
    lse = torch.where(l == 0.0, float("inf"), m + torch.log(l))
    return out, lse


def _hop(tensors: Sequence[torch.Tensor], group) -> list:
    """The tensors, packed into one buffer of bytes, to the next rank of the
    ring; returns what the previous rank sent, unpacked alike."""
    flat = [t.contiguous().view(-1).view(torch.uint8) for t in tensors]
    got = ring_shift(torch.cat(flat), group)
    out, at = [], 0
    for t, f in zip(tensors, flat):
        out.append(got[at:at + f.numel()].view(t.dtype).view(t.shape))
        at += f.numel()
    return out


def _skip(causal: bool, col_block: int, idx: int) -> bool:
    """A contiguous causal block strictly above this rank's diagonal is
    fully masked: its products are skipped (the JAX package's lax.cond)."""
    return causal and col_block > idx


def _contiguous_fwd(qf, kf, vf, scale, causal, idx, n, group):
    s_local = qf.shape[1]
    row0 = idx * s_local
    acc, m, l = _start(qf)
    # Step t sees the K/V block that started on rank (idx - t) mod n.
    for t in range(n):
        col_block = (idx - t) % n
        if _skip(causal, col_block, idx):
            o_t, m_t, l_t = _neutral(qf)
        else:
            o_t, m_t, l_t = _block_attn(qf, kf, vf, scale, row0, col_block * s_local, causal)
        acc, m, l = _merge(acc, m, l, o_t, m_t, l_t)
        if t != n - 1:
            kf, vf = _hop((kf, vf), group)
    return _finish(acc, m, l)


def _zigzag_fwd(qf, kf, vf, scale, idx, n, group):
    """Balanced causal ring body for the zigzag layout: rank i's local [2c]
    sequence is (early chunk i, late chunk 2N-1-i).  Visibility is static
    per round:

      t = 0      : early-vs-early causal, late-vs-(early|late-causal);
      t > 0, j<i : both local q chunks see only the incoming early chunk;
      t > 0, j>i : only the local late chunk sees the incoming pair.

    The two local chunks keep separate accumulators."""
    c = qf.shape[1] // 2
    qa, qb = qf[:, :c], qf[:, c:]
    A, B = _start(qa), _start(qb)
    # t = 0: the diagonal; late rows follow the early ones (offset c).
    A = _merge(*A, *_block_attn(qa, kf[:, :c], vf[:, :c], scale, 0, 0, True))
    B = _merge(*B, *_block_attn(qb, kf, vf, scale, c, 0, True))
    for t in range(1, n):
        kf, vf = _hop((kf, vf), group)
        j = (idx - t) % n
        if j < idx:
            ka, va = kf[:, :c], vf[:, :c]
            A = _merge(*A, *_block_attn(qa, ka, va, scale, 0, 0, False))
            B = _merge(*B, *_block_attn(qb, ka, va, scale, 0, 0, False))
        else:
            A = _merge(*A, *_neutral(qa))
            B = _merge(*B, *_block_attn(qb, kf, vf, scale, 0, 0, False))
    (oa, la), (ob, lb) = _finish(*A), _finish(*B)
    return torch.cat([oa, ob], dim=1), torch.cat([la, lb], dim=1)


def _contiguous_bwd(qf, kf, vf, do, lse, delta, scale, causal, idx, n, group):
    s_local = qf.shape[1]
    row0 = idx * s_local
    dq = torch.zeros(qf.shape, dtype=torch.float32, device=qf.device)
    dk = torch.zeros(kf.shape, dtype=torch.float32, device=kf.device)
    dv = torch.zeros_like(dk)
    # The K/V block of tick t travels with its gradient; after the last
    # tick's share the gradient hops once more, to its owner.
    for t in range(n):
        col_block = (idx - t) % n
        if not _skip(causal, col_block, idx):
            gq, gk, gv = _block_grads(qf, kf, vf, do, lse, delta, scale, row0,
                                      col_block * s_local, causal)
            dq += gq
            dk += gk
            dv += gv
        if t != n - 1:
            kf, vf, dk, dv = _hop((kf, vf, dk, dv), group)
        else:
            dk, dv = _hop((dk, dv), group)
    return dq, dk, dv


def _zigzag_bwd(qf, kf, vf, do, lse, delta, scale, idx, n, group):
    c = qf.shape[1] // 2
    qa, qb = qf[:, :c], qf[:, c:]
    da, db = do[:, :c], do[:, c:]
    la, lb = lse[:, :c], lse[:, c:]
    ea, eb = delta[:, :c], delta[:, c:]
    dqa = torch.zeros(qa.shape, dtype=torch.float32, device=qf.device)
    dqb = torch.zeros_like(dqa)
    dk = torch.zeros(kf.shape, dtype=torch.float32, device=kf.device)
    dv = torch.zeros_like(dk)
    gq, gk, gv = _block_grads(qa, kf[:, :c], vf[:, :c], da, la, ea, scale, 0, 0, True)
    dqa += gq
    dk[:, :c] += gk
    dv[:, :c] += gv
    gq, gk, gv = _block_grads(qb, kf, vf, db, lb, eb, scale, c, 0, True)
    dqb += gq
    dk += gk
    dv += gv
    for t in range(1, n):
        kf, vf, dk, dv = _hop((kf, vf, dk, dv), group)
        j = (idx - t) % n
        if j < idx:
            ka, va = kf[:, :c], vf[:, :c]
            for q_, d_, l_, e_, dq_ in ((qa, da, la, ea, dqa), (qb, db, lb, eb, dqb)):
                gq, gk, gv = _block_grads(q_, ka, va, d_, l_, e_, scale, 0, 0, False)
                dq_ += gq
                dk[:, :c] += gk
                dv[:, :c] += gv
        else:
            gq, gk, gv = _block_grads(qb, kf, vf, db, lb, eb, scale, 0, 0, False)
            dqb += gq
            dk += gk
            dv += gv
    dk, dv = _hop((dk, dv), group)
    return torch.cat([dqa, dqb], dim=1), dk, dv


class _RingAttention(torch.autograd.Function):
    """The ring body on [BH, S_local, D] shards, with its ring backward."""

    @staticmethod
    def forward(ctx, qf, kf, vf, group, causal: bool, scale: float, zigzag: bool):
        idx, n = dist.get_rank(group), dist.get_world_size(group)
        if zigzag:
            out, lse = _zigzag_fwd(qf, kf, vf, scale, idx, n, group)
        else:
            out, lse = _contiguous_fwd(qf, kf, vf, scale, causal, idx, n, group)
        out = out.to(qf.dtype)
        ctx.save_for_backward(qf, kf, vf, out, lse)
        ctx.args = (group, causal, scale, zigzag, idx, n)
        return out

    @staticmethod
    def backward(ctx, do):
        qf, kf, vf, out, lse = ctx.saved_tensors
        group, causal, scale, zigzag, idx, n = ctx.args
        do = do.contiguous()
        delta = (do.float() * out.float()).sum(dim=-1, keepdim=True)
        if zigzag:
            dq, dk, dv = _zigzag_bwd(qf, kf, vf, do, lse, delta, scale, idx, n, group)
        else:
            dq, dk, dv = _contiguous_bwd(qf, kf, vf, do, lse, delta, scale, causal, idx, n,
                                         group)
        return dq.to(qf.dtype), dk.to(kf.dtype), dv.to(vf.dtype), None, None, None, None


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    group: Any,
    causal: bool = True,
    layout: str = "contiguous",
) -> torch.Tensor:
    """The local ring body over ``group`` (the "sequence" axis's).

    q/k/v: this rank's sequence shards, [B, H, S_local, D] (kv heads must
    already match q heads: the model repeats GQA groups first).  layout:
    'contiguous' or 'zigzag' (the caller has permuted the sequence with
    :func:`to_zigzag`; the output comes back in the same order).
    Non-causal attention takes the contiguous schedule under either layout:
    every block is unmasked."""
    if layout not in ("contiguous", "zigzag"):
        raise ValueError(f"unknown ring layout {layout!r}")
    b, h, s_local, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"ring attention needs equal q/k/v shapes, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    zigzag = layout == "zigzag" and causal
    if zigzag and s_local % 2 != 0:
        raise ValueError("zigzag layout needs an even local sequence length")
    out = _RingAttention.apply(
        q.reshape(b * h, s_local, d).contiguous(), k.reshape(b * h, s_local, d).contiguous(),
        v.reshape(b * h, s_local, d).contiguous(), group, causal, d ** -0.5, zigzag)
    return out.reshape(b, h, s_local, d)


def zigzag_permutation(seq_len: int, n_shards: int) -> np.ndarray:
    """Positions (original order) in zigzag order, as a numpy int array.

    ``x[..., perm, ...]`` reorders a sequence axis so a plain contiguous
    shard over ``n_shards`` ranks gives rank i the original chunks
    (i, 2N-1-i).  Apply the same permutation to targets / position ids;
    invert with :func:`inverse_zigzag_permutation`."""
    if seq_len % (2 * n_shards) != 0:
        raise ValueError(
            f"zigzag needs seq_len divisible by 2*n_shards, got {seq_len} vs {n_shards}")
    c = seq_len // (2 * n_shards)
    chunks = []
    for i in range(n_shards):
        chunks.append(np.arange(i * c, (i + 1) * c))
        j = 2 * n_shards - 1 - i
        chunks.append(np.arange(j * c, (j + 1) * c))
    return np.concatenate(chunks)


def inverse_zigzag_permutation(seq_len: int, n_shards: int) -> np.ndarray:
    """Inverse of :func:`zigzag_permutation`: maps zigzag order back to the
    original sequence order."""
    perm = zigzag_permutation(seq_len, n_shards)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(seq_len)
    return inv


def to_zigzag(x: torch.Tensor, n_shards: int, dim: int) -> torch.Tensor:
    """Permutes a sequence dim into zigzag order (on the host, before
    sharding)."""
    perm = torch.from_numpy(zigzag_permutation(x.shape[dim], n_shards)).to(x.device)
    return x.index_select(dim, perm)


def from_zigzag(x: torch.Tensor, n_shards: int, dim: int) -> torch.Tensor:
    """Undoes :func:`to_zigzag`."""
    inv = torch.from_numpy(inverse_zigzag_permutation(x.shape[dim], n_shards)).to(x.device)
    return x.index_select(dim, inv)


# The JAX wrappers' PartitionSpec (batch_axis, head_axis, seq_axis, None).
_SHARDED_DIMS = ((0, "data"), (1, "tensor"), (2, "sequence"))


def local_block(ftmesh: Any, x: torch.Tensor) -> torch.Tensor:
    """This rank's block of a global [B, H, S, D] tensor: the batch over
    "data", the heads over "tensor", the sequence over "sequence"."""
    for dim, axis in _SHARDED_DIMS:
        x = x.chunk(ftmesh.size(axis), dim=dim)[ftmesh.coordinate(axis)]
    return x.contiguous()


def global_block(ftmesh: Any, x: torch.Tensor) -> torch.Tensor:
    """The global tensor from every rank's :func:`local_block` (no
    gradient)."""
    for dim, axis in reversed(_SHARDED_DIMS):
        if ftmesh.size(axis) > 1:
            x = all_gather_cat(x, dim, ftmesh.group(axis))
    return x


def ring_attention_sharded(
    ftmesh: Any,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    layout: str = "contiguous",
) -> torch.Tensor:
    """The JAX ``ring_attention_sharded``'s counterpart: global q/k/v [B, H,
    S, D] (the same on every rank) placed as its ``shard_map`` places them,
    the batch over "data", the heads over "tensor" and the sequence ring
    over "sequence" (``ftmesh``'s groups), each rank running
    :func:`ring_attention` on its block; returns the global output,
    gathered (no gradient through the gather).  With layout='zigzag' the
    inputs are already in zigzag order (:func:`to_zigzag`), and so is the
    output."""
    out = ring_attention(local_block(ftmesh, q), local_block(ftmesh, k), local_block(ftmesh, v),
                         ftmesh.group("sequence"), causal=causal, layout=layout)
    return global_block(ftmesh, out)

