"""Fused lm-head cross-entropy: hand-written Hopper kernels with plain twins.

The counterpart of ``torchft_tpu/ops/cross_entropy.py``.  The mean
cross-entropy of ``softmax(x @ w)`` against integer targets, without the
f32 ``[N, V]`` logits in device memory: the forward is the ``ce_lse``
kernel plus a gather of the target logit outside it; the backward is the
``ce_dlogits`` kernel, then ``dx = dl wᵀ`` and ``dw = xᵀ dl`` as plain
matrix products (``torch.matmul``, as the JAX package leaves them to XLA).

On a CPU tensor every step runs as plain PyTorch over the materialized
logits (``_ce_lse_reference``, ``_ce_dlogits_reference``); a CUDA tensor
the kernels do not take raises.  A caller that must run every shape (the
model) asks :func:`fused_ce_applicable` first, as the JAX model asks its
``fused_ce_applicable``, and otherwise takes the materialized logits.
"""

from __future__ import annotations

import ctypes

import torch

from torchft_tpu_torch.ops._launch import Kernel, check_cuda

_i, _p = ctypes.c_int, ctypes.c_void_p

CE_LSE = Kernel(
    "ce_lse", "cross_entropy", "tf_ce_lse",
    [_p, _p, _p, _p, _i, _i, _i, _i, _i, _i],
    replaces="torchft_tpu/ops/cross_entropy.py:114",
)
CE_DLOGITS = Kernel(
    "ce_dlogits", "cross_entropy", "tf_ce_dlogits",
    [_p, _p, _p, _p, _p, _p, _i, _i, _i, _i],
    replaces="torchft_tpu/ops/cross_entropy.py:147",
)


def fused_ce_shapes_supported(n: int, e: int, v: int) -> bool:
    """The kernels' shape terms: 16-element rows of x and 8-column rows of
    w (16-byte TMA strides in bf16), any N >= 1 (ragged tiles are
    clipped)."""
    return n >= 1 and e >= 1 and e % 16 == 0 and v % 8 == 0


def fused_ce_applicable(x: torch.Tensor, w: torch.Tensor) -> bool:
    """True when :func:`fused_linear_cross_entropy` can run the kernels on
    ``x`` ``[N, E]`` and ``w`` ``[E, V]``: both bf16 on one CUDA device with
    :func:`fused_ce_shapes_supported` shapes.  A pure shape and placement
    test, evaluated before any launch."""
    return (
        x.device.type == "cuda"
        and w.device == x.device
        and x.dtype == w.dtype == torch.bfloat16
        and x.dim() == w.dim() == 2
        and x.shape[1] == w.shape[0]
        and fused_ce_shapes_supported(x.shape[0], x.shape[1], w.shape[1])
    )


def _check(name: str, x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"{name}: expected x [N, E] and w [E, V], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.shape[1] % 16 or w.shape[1] % 8:
        raise ValueError(f"{name}: needs E % 16 == 0 and V % 8 == 0, got "
                         f"E={x.shape[1]}, V={w.shape[1]}")
    check_cuda(name, torch.bfloat16, x, w)


def _logits(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x.float(), w.float())


def _ce_lse_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.logsumexp(_logits(x, w), dim=-1)


def _ce_dlogits_reference(x, w, targets, lse, scale) -> torch.Tensor:
    p = torch.exp(_logits(x, w) - lse[:, None])
    p[torch.arange(x.shape[0], device=x.device), targets.long()] -= 1.0
    return (p * scale).to(x.dtype)


_ROWS_PER_TILE, _COLS_PER_TILE = 128, 256
# How much busier than an even spread of the tiles the busiest block may be.
_SPREAD = 1.02


def _vocab_slices(n: int, v: int, blocks: int) -> "tuple[int, int]":
    """(columns per slice, slices) for ce_lse, whose ``blocks`` persistent
    blocks walk the (row tile, slice) items.  A slice is a whole number of
    256-column tiles and none is empty.  Wider slices leave fewer partial
    results to fold but spread the tiles less evenly over the blocks: the
    widest whose busiest block has at most ``_SPREAD`` times the tiles of an
    even spread."""
    row_tiles = -(-n // _ROWS_PER_TILE)
    v_tiles = -(-v // _COLS_PER_TILE)
    even = row_tiles * v_tiles / blocks
    for per in range(v_tiles, 1, -1):
        slices = -(-v_tiles // per)
        if -(-(row_tiles * slices) // blocks) * per <= _SPREAD * even:
            return per * _COLS_PER_TILE, slices
    return _COLS_PER_TILE, v_tiles


def ce_lse(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """logsumexp over V of ``x @ w``: [N] f32."""
    if x.device.type == "cpu":
        return _ce_lse_reference(x, w)
    _check("ce_lse", x, w)
    n, e = x.shape
    v = w.shape[1]
    blocks = torch.cuda.get_device_properties(x.device).multi_processor_count
    v_per_split, splits = _vocab_slices(n, v, blocks)
    part = torch.empty((splits, n), dtype=torch.float32, device=x.device)
    lse = torch.empty(n, dtype=torch.float32, device=x.device)
    CE_LSE(x.data_ptr(), w.data_ptr(), part.data_ptr(), lse.data_ptr(), n, e, v, v_per_split,
           splits, blocks)
    return lse


def ce_dlogits(x, w, targets, lse, scale: torch.Tensor) -> torch.Tensor:
    """``(softmax(x @ w) - onehot(targets)) * scale`` in x's dtype; ``scale``
    is a one-element f32 tensor on x's device."""
    if x.device.type == "cpu":
        return _ce_dlogits_reference(x, w, targets, lse, scale)
    _check("ce_dlogits", x, w)
    n, e = x.shape
    tgt = targets.to(torch.int32).contiguous()
    lse = lse.contiguous()
    scale = scale.reshape(1).to(torch.float32).contiguous()
    if tgt.shape != (n,) or lse.shape != (n,) or lse.dtype != torch.float32:
        raise ValueError("ce_dlogits: targets and lse must be [N] (lse in f32)")
    for t in (tgt, lse, scale):
        if t.device != x.device:
            raise ValueError("ce_dlogits: targets, lse and scale must be on x's device")
    dl = torch.empty((n, w.shape[1]), dtype=x.dtype, device=x.device)
    blocks = torch.cuda.get_device_properties(x.device).multi_processor_count
    CE_DLOGITS(x.data_ptr(), w.data_ptr(), tgt.data_ptr(), lse.data_ptr(), scale.data_ptr(),
               dl.data_ptr(), n, e, w.shape[1], blocks)
    return dl


def _target_logit(x: torch.Tensor, w: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """rowsum(x * w[:, t]) in f32: an O(N E) gather, no [N, V] involved."""
    wt = w.t()[targets.long()]
    return (x.float() * wt.float()).sum(dim=-1)


class _FusedLinearCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, targets):
        lse = ce_lse(x, w)
        ctx.save_for_backward(x, w, targets, lse)
        return (lse - _target_logit(x, w, targets)).mean()

    @staticmethod
    def backward(ctx, g):
        x, w, targets, lse = ctx.saved_tensors
        dl = ce_dlogits(x, w, targets, lse, g.float() / x.shape[0])
        return torch.matmul(dl, w.t()), torch.matmul(x.t(), dl), None


def fused_linear_cross_entropy(x: torch.Tensor, w: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of ``softmax(x @ w)`` against ``targets``; x [N, E]
    and w [E, V] in one dtype (bf16 on the card), targets [N] integer.
    Returns an f32 scalar."""
    return _FusedLinearCE.apply(x, w, targets)
