"""Flash attention: hand-written Hopper kernels with plain PyTorch twins.

The counterpart of ``torchft_tpu/ops/attention.py``.  On a CUDA tensor the
forward runs ``csrc/flash_fwd.cu`` and the backward
``csrc/flash_bwd.cu`` (a dK/dV kernel and a dQ kernel); on a CPU tensor the
same math runs as plain PyTorch with the scores materialized
(``_fa_reference``, ``_fa_bwd_reference``).  The wrappers take the plain
path only for CPU tensors: a CUDA tensor the kernels do not take raises.
A caller that must run every shape (the model) asks :func:`flash_applicable`
first and takes :func:`plain_attention` where it is false, as the JAX
model's ``_use_pallas`` gate falls back to its XLA formulation.

Shapes: ``[BH, S, D]`` inside, ``[B, H, S, D]`` at :func:`flash_attention`,
which repeats grouped kv heads (GQA) outside the kernels.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from torchft_tpu_torch.ops._launch import Kernel, check_cuda

_NEG_INF = -1e30

_i, _f, _p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p

FLASH_FWD = Kernel(
    "flash_fwd", "flash_fwd", "tf_flash_fwd",
    [_p, _p, _p, _p, _p, _i, _i, _i, _f, _i],
    replaces="torchft_tpu/ops/attention.py:64",
)
FLASH_BWD_DKDV = Kernel(
    "flash_bwd_dkdv", "flash_bwd", "tf_flash_bwd_dkdv",
    [_p, _p, _p, _p, _p, _p, _p, _p, _i, _i, _i, _f, _i],
    replaces="torchft_tpu/ops/attention.py:196",
)
FLASH_BWD_DQ = Kernel(
    "flash_bwd_dq", "flash_bwd", "tf_flash_bwd_dq",
    [_p, _p, _p, _p, _p, _p, _p, _i, _i, _i, _f, _i],
    replaces="torchft_tpu/ops/attention.py:257",
)

# The kernels are instantiated for the head dim the port's configurations
# run; another one is added with the configuration that needs it.
_HEAD_DIMS = (128,)


def flash_shapes_supported(seq_q: int, seq_k: int, head_dim: int) -> bool:
    """The kernels' shape terms: a built head dim, and one sequence length
    for q and k/v (the kernels take a single S; any S >= 1, ragged tiles
    are masked)."""
    return head_dim in _HEAD_DIMS and seq_q == seq_k and seq_q >= 1


def flash_applicable(q: torch.Tensor, k: torch.Tensor) -> bool:
    """True when :func:`flash_attention` can run the kernels on ``q``
    ``[B, Hq, S, D]`` and ``k`` ``[B, Hkv, S, D]``: both bf16 on one CUDA
    device, with :func:`flash_shapes_supported` shapes.  A pure shape and
    placement test, evaluated before any launch."""
    return (
        q.device.type == "cuda"
        and k.device == q.device
        and q.dtype == k.dtype == torch.bfloat16
        and q.dim() == k.dim() == 4
        and k.shape[-1] == q.shape[-1]
        and flash_shapes_supported(q.shape[2], k.shape[2], q.shape[-1])
    )


def _check_shapes(name: str, q: torch.Tensor, *others: torch.Tensor) -> None:
    if q.dim() != 3 or q.shape[2] not in _HEAD_DIMS:
        raise ValueError(f"{name}: expected [BH, S, D] with D in {_HEAD_DIMS}, got {tuple(q.shape)}")
    for t in others:
        if t.shape != q.shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(q.shape)}")


def _causal_mask(s: torch.Tensor) -> torch.Tensor:
    rows = torch.arange(s.shape[-2], device=s.device)[:, None]
    cols = torch.arange(s.shape[-1], device=s.device)[None, :]
    return rows >= cols


def _fa_reference(q, k, v, scale: float, causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain attention returning (out, lse); q/k/v: [BH, S, D]."""
    s = torch.einsum("bqd,bkd->bqk", q, k).float() * scale
    if causal:
        s = torch.where(_causal_mask(s), s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bqk,bkd->bqd", (p / l).to(v.dtype), v)
    return o.to(q.dtype), (m + torch.log(l))[..., 0]


def _fa_bwd_reference(q, k, v, o, lse, g, scale: float, causal: bool):
    """Plain flash backward with the scores materialized, in f32."""
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    s = torch.einsum("bqd,bkd->bqk", qf, kf) * scale
    if causal:
        s = torch.where(_causal_mask(s), s, torch.full_like(s, _NEG_INF))
    p = torch.exp(s - lse[..., None])
    dv = torch.einsum("bqk,bqd->bkd", p, gf)
    dp = torch.einsum("bqd,bkd->bqk", gf, vf)
    delta = (gf * o.float()).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta) * scale
    dq = torch.einsum("bqk,bkd->bqd", ds, kf)
    dk = torch.einsum("bqk,bqd->bkd", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_fwd(q, k, v, scale: float, causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(O, lse) for q/k/v [BH, S, D]; the kernel on CUDA, plain on CPU."""
    if q.device.type == "cpu":
        return _fa_reference(q, k, v, scale, causal)
    _check_shapes("flash_fwd", q, k, v)
    check_cuda("flash_fwd", torch.bfloat16, q, k, v)
    bh, s, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((bh, s), dtype=torch.float32, device=q.device)
    FLASH_FWD(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
              bh, s, d, float(scale), int(causal))
    return o, lse


def flash_bwd(q, k, v, o, lse, g, scale: float, causal: bool):
    """(dq, dk, dv); the two kernels on CUDA, plain on CPU."""
    if q.device.type == "cpu":
        return _fa_bwd_reference(q, k, v, o, lse, g, scale, causal)
    _check_shapes("flash_bwd", q, k, v, o, g)
    check_cuda("flash_bwd", torch.bfloat16, q, k, v, o, g)
    check_cuda("flash_bwd", torch.float32, lse)
    bh, s, d = q.shape
    if lse.shape != (bh, s):
        raise ValueError(f"flash_bwd: lse shape {tuple(lse.shape)} != {(bh, s)}")
    # delta = rowsum(dO * O) once, outside the kernels (as on the TPU).
    delta = (g.float() * o.float()).sum(dim=-1).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    FLASH_BWD_DKDV(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
                   delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh, s, d,
                   float(scale), int(causal))
    FLASH_BWD_DQ(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
                 delta.data_ptr(), dq.data_ptr(), bh, s, d, float(scale), int(causal))
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    """Attention with the saved (O, lse) backward; ``plain`` runs the plain
    twins on any device, else the kernel wrappers."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, causal: bool, plain: bool):
        o, lse = (_fa_reference if plain else flash_fwd)(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.causal, ctx.plain = scale, causal, plain
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = _fa_bwd_reference if ctx.plain else flash_bwd
        dq, dk, dv = bwd(q, k, v, o, lse, g.contiguous(), ctx.scale, ctx.causal)
        return dq, dk, dv, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Multi-head attention; q: [B, Hq, S, D], k/v: [B, Hkv, S, D] with Hkv
    dividing Hq (kv heads are repeated to the query groups).  The kernels on
    CUDA (raising for what they do not take), plain on the CPU."""
    return _attention(q, k, v, causal, scale, plain=False)


def plain_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """:func:`flash_attention`'s math as plain PyTorch on any device, the
    scores materialized: the path for shapes :func:`flash_applicable`
    rejects."""
    return _attention(q, k, v, causal, scale, plain=True)


def _attention(q, k, v, causal: bool, scale: Optional[float], plain: bool) -> torch.Tensor:
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    if hkv != hq:
        if hq % hkv:
            raise ValueError("query heads must be a multiple of kv heads")
        k = k.repeat_interleave(hq // hkv, dim=1)
        v = v.repeat_interleave(hq // hkv, dim=1)
    scale = scale if scale is not None else d ** -0.5
    out = _Flash.apply(
        q.reshape(b * hq, sq, d).contiguous(),
        k.reshape(b * hq, k.shape[2], d).contiguous(),
        v.reshape(b * hq, v.shape[2], d).contiguous(),
        scale,
        causal,
        plain,
    )
    return out.reshape(b, hq, sq, d)
