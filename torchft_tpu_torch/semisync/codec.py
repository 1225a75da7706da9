"""Per-fragment wire preparation for the semi-sync pseudogradient plane.

The counterpart of ``torchft_tpu/semisync/codec.py``.  A fragment codec
takes a fragment from "its live leaves and the last-committed backup" to
"the host payload handed to the cross-group ring":

    pseudogradient  pg = backup - local   (the DiLoCo paper's sign,
                                           arXiv:2311.08105: an outer SGD
                                           descent step moves the backup
                                           toward the averaged progress)

``int8``: int8 with error feedback.  The fragment's pseudogradient plus the
residual the last round failed to send is quantized at the source with one
scale per fragment (amax / 127), and the new residual ``x - q * scale`` is
carried to the next round; the ring then wires scale + int8 frames
(``wire_codec="int8"``).  ``int4`` is the same with amax / 7 and [-7, 7]
(the ring packs two values a byte).  ``bf16`` casts the pseudogradient to
bfloat16; ``f32`` sends it at full width; ``auto`` sends f32 and lets the
collective's own wire policy decide.

Host paths are numpy copies of the JAX package's, bit for bit.  The device
path engages by type, as the JAX package's ``_all_jax`` gate does: when
every leaf of a lossy-eligible fragment is a CUDA tensor, the pseudogradient,
the residual add, amax, scale, ``nan_to_num``, round-half-even, clip and the
new residual run as torch ops on the card, the residual stays there, and
only q and the scale (int8 / int4) or the cast pseudogradient (bf16, f32)
cross to the host.  Each op is a separate IEEE float32 kernel (no fused
multiply-add), so the device encode is bitwise the host encode.

Torch optimizers update CUDA parameters in place, so a worker that read the
leaves later would encode a torn pseudogradient.  Encoding is therefore
split: :meth:`FragmentCodec.prepare` runs on the train thread, ordered on
its stream, and turns the leaves into fresh tensors (the device encode's
outputs, or a host copy) plus an event; :meth:`FragmentCodec.finish` runs
on the sync worker, waits for the event and copies off the card on a
stream of its own into pinned buffers.  :meth:`FragmentCodec.encode` is the
two in one call.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from torchft_tpu_torch.collectives import bf16_encode, quantize_int4, quantize_int8
from torchft_tpu_torch.futures import event_wait
from torchft_tpu_torch.semisync.fragments import Fragment, as_host_tensor, pack_flat

__all__ = [
    "CODECS",
    "TPUFT_SEMISYNC_CODEC_ENV",
    "FragmentCodec",
    "Prepared",
    "ef_quantize",
    "make_codec",
]

TPUFT_SEMISYNC_CODEC_ENV = "TPUFT_SEMISYNC_CODEC"
CODECS = ("int8", "int4", "bf16", "f32", "auto")


def _all_cuda(leaves: Sequence[Any]) -> bool:
    return bool(leaves) and all(isinstance(t, torch.Tensor) and t.device.type == "cuda"
                                for t in leaves)


def _device_flat(leaves: Sequence[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """The device twin of ``pack_flat``: one flat tensor of ``dtype`` on the
    leaves' device."""
    flat = (torch.cat([t.detach().reshape(-1) for t in leaves]) if len(leaves) > 1
            else leaves[0].detach().reshape(-1))
    return flat.to(dtype)


def ef_quantize(local: torch.Tensor, backup: torch.Tensor, residual: torch.Tensor,
                qmax: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(q, scale, new_residual)`` of the error-feedback encode, as torch
    ops on the tensors' device: x = (backup - local) + residual; scale =
    amax / qmax (1 where amax is 0 or not finite); q = clip(round_half_even(
    nan_to_num(x / scale, nan=0)), -qmax, qmax) as int8; new residual =
    x - q * scale where x is finite, else 0.  Bitwise ``quantize_int8`` /
    ``quantize_int4`` and the host residual on the same float32 inputs."""
    x = (backup - local) + residual
    amax = x.abs().max() if x.numel() else torch.zeros((), dtype=x.dtype, device=x.device)
    ok = (amax > 0) & torch.isfinite(amax)
    # A divisor on the tensor's device: CUDA divides by a host scalar as a
    # multiply by its reciprocal, which can differ from the quotient.
    divisor = torch.full((), float(qmax), dtype=torch.float32, device=x.device)
    scale = torch.where(ok, amax / divisor, torch.ones_like(amax))
    q = torch.clamp(torch.round(torch.nan_to_num(x / scale, nan=0.0)), -qmax, qmax)
    q = q.to(torch.int8)
    deq = q.to(torch.float32) * scale
    new_residual = torch.where(torch.isfinite(x), x - deq, torch.zeros_like(x))
    return q, scale, new_residual


class Prepared:
    """One fragment's encode as the train thread leaves it for the worker:
    ``host`` (a host copy of the packed local leaves, host path) or
    ``device`` (the device encode's fresh outputs) with ``event`` recorded
    after them; ``d2h`` counts the bytes the host path copied off the card."""

    def __init__(self, host: Optional[torch.Tensor] = None,
                 device: Optional[Tuple[torch.Tensor, ...]] = None,
                 event: Any = None, d2h: int = 0) -> None:
        self.host = host
        self.device = device
        self.event = event
        self.d2h = d2h


class FragmentCodec:
    """Base: the raw pseudogradient in the fragment's dtype.  One instance
    per fragment: codecs hold state (the residual, the backup's device
    mirror, pinned staging buffers)."""

    name = "f32"
    # Whether the collective may apply its own lossy wire (bf16 if so shaped).
    allow_wire_compression = False
    # The explicit per-call wire codec, for collectives that support it.
    wire_codec: Optional[str] = None

    def __init__(self, fragment: Fragment) -> None:
        self.fragment = fragment
        self._backup_host: Optional[torch.Tensor] = None
        self._backup_dev: Optional[torch.Tensor] = None
        # The worker's copies off the card: pinned buffers, and a stream of
        # their own (never the legacy default stream, which would queue
        # them behind the train step).
        self._staging: Dict[int, torch.Tensor] = {}
        self._stream: Any = None

    @property
    def _work_dtype(self) -> torch.dtype:
        """The dtype of the pseudogradient math: the fragment's own (an f64
        fragment must not be cut down by a codec that promises full
        width); the quantizing codecs override it with float32."""
        return self.fragment.dtype

    @property
    def payload_dtype(self) -> torch.dtype:
        """The dtype of the payload :meth:`encode` hands the ring; a group
        that does not participate sends zeros of exactly this dtype (each
        rank's frame sizes derive from it)."""
        return self._work_dtype

    def zero_payload(self) -> torch.Tensor:
        return torch.zeros(self.fragment.numel, dtype=self.payload_dtype)

    # -- the backup ----------------------------------------------------------

    def set_backup(self, flat_host: Any) -> None:
        """Installs the fragment's last-committed flat backup (host); the
        device mirror is rebuilt at the next device encode."""
        self._backup_host = as_host_tensor(flat_host).to(self._work_dtype).contiguous()
        self._backup_dev = None

    def _backup_device(self, device: torch.device) -> torch.Tensor:
        if self._backup_dev is None or self._backup_dev.device != device:
            assert self._backup_host is not None, "set_backup before encoding"
            self._backup_dev = self._backup_host.to(device)
        return self._backup_dev

    # -- encode ----------------------------------------------------------------

    def prepare(self, leaves: Sequence[Any]) -> Prepared:
        """The train thread's half of an encode (``leaves`` is the whole
        list; the fragment picks its own): the device encode into fresh
        tensors when every leaf of a lossy-eligible fragment is on the card,
        else a host copy of the packed leaves."""
        frag_leaves = [leaves[i] for i in self.fragment.bucket.indices]
        if self.fragment.lossy_ok and _all_cuda(frag_leaves):
            outs = self._prepare_device(frag_leaves)
            event = torch.cuda.Event()
            event.record()
            return Prepared(device=outs, event=event)
        on_card = [t for t in frag_leaves if isinstance(t, torch.Tensor) and t.device.type == "cuda"]
        local = pack_flat(frag_leaves, self._work_dtype)
        if not on_card:
            local = local.clone()  # a CPU leaf may be a view: the copy is the snapshot
        return Prepared(host=local, d2h=sum(t.numel() * t.element_size() for t in on_card))

    def finish(self, prep: Prepared, timeout: float = 60.0) -> Tuple[Any, int]:
        """The worker's half: (host payload for the ring, bytes fetched off
        the card)."""
        if prep.device is None:
            return self._encode_host(prep.host), prep.d2h
        return self._finish_device(prep, timeout)

    def encode(self, leaves: Sequence[Any]) -> Tuple[Any, int]:
        """(host payload, d2h bytes) in one call."""
        return self.finish(self.prepare(leaves))

    def _encode_host(self, local: torch.Tensor) -> Any:
        assert self._backup_host is not None, "set_backup before encoding"
        return self._backup_host - local

    def _prepare_device(self, frag_leaves: List[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        backup = self._backup_device(frag_leaves[0].device)
        return (backup - _device_flat(frag_leaves, backup.dtype),)

    def _fetch(self, prep: Prepared, timeout: float) -> List[torch.Tensor]:
        """Copies the prepared device tensors into this codec's pinned
        buffers on the worker's copy stream, behind the prepare's event."""
        srcs = prep.device
        assert srcs is not None
        if self._stream is None or self._stream.device != srcs[0].device:
            self._stream = torch.cuda.Stream(srcs[0].device)
        stream = self._stream
        outs = []
        with torch.cuda.stream(stream):
            stream.wait_event(prep.event)
            for k, src in enumerate(srcs):
                buf = self._staging.get(k)
                if buf is None or buf.shape != src.shape or buf.dtype != src.dtype:
                    buf = self._staging[k] = torch.empty(src.shape, dtype=src.dtype,
                                                         pin_memory=True)
                buf.copy_(src, non_blocking=True)
                outs.append(buf)
            done = torch.cuda.Event()
            done.record(stream)
        event_wait(done, timeout, "fragment copy off the card")
        return outs

    def _finish_device(self, prep: Prepared, timeout: float) -> Tuple[Any, int]:
        (host,) = self._fetch(prep, timeout)
        return host.clone(), host.numel() * host.element_size()

    # -- the round's outcome --------------------------------------------------

    def on_commit(self) -> None:
        """The round's averaged pseudogradient was applied."""

    def on_abort(self) -> None:
        """The round failed: state tied to its transmission is reset."""


class _AutoCodec(FragmentCodec):
    """An f32 payload; the collective decides the wire."""

    name = "auto"
    allow_wire_compression = True


def _bf16_tensor(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(bf16_encode(x).view(np.int16)).view(torch.bfloat16)


class _BF16Codec(FragmentCodec):
    """The pseudogradient cast to bfloat16 (on the card or on the host):
    the copy off the card and the wire move 2 bytes an element."""

    name = "bf16"
    allow_wire_compression = True

    @property
    def _work_dtype(self) -> torch.dtype:
        return torch.float32

    @property
    def payload_dtype(self) -> torch.dtype:
        return torch.bfloat16

    def _encode_host(self, local: torch.Tensor) -> Any:
        assert self._backup_host is not None, "set_backup before encoding"
        return _bf16_tensor(self._backup_host.numpy() - local.numpy())

    def _prepare_device(self, frag_leaves: List[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        backup = self._backup_device(frag_leaves[0].device)
        return ((backup - _device_flat(frag_leaves, torch.float32)).to(torch.bfloat16),)


class _Int8EFCodec(FragmentCodec):
    """int8 with error feedback (see the module docstring).  The ring still
    requantizes per chunk and hop; the residual captures the source's
    quantization error, which dominates.  A failed round discards the
    pending and the carried residual: the transmission they described
    never landed, and the next pseudogradient re-derives the whole
    difference."""

    name = "int8"
    allow_wire_compression = True
    wire_codec = "int8"
    _qmax = 127

    def __init__(self, fragment: Fragment) -> None:
        super().__init__(fragment)
        self._residual_host: Optional[np.ndarray] = None
        self._residual_dev: Optional[torch.Tensor] = None
        # Set by an encode, promoted on commit, discarded on abort.
        self._pending_residual: Any = None
        self._pending_on_device = False

    @property
    def _work_dtype(self) -> torch.dtype:
        return torch.float32

    def _quantize(self, x: np.ndarray):
        return quantize_int8(x)

    def _residual_on(self, device: Optional[torch.device]) -> Any:
        """The carried residual: a float32 tensor on ``device``, or a host
        array when ``device`` is None; zeros when none is carried."""
        if device is not None:
            if self._residual_dev is None or self._residual_dev.device != device:
                self._residual_dev = (
                    torch.from_numpy(self._residual_host).to(device)
                    if self._residual_host is not None
                    else torch.zeros(self.fragment.numel, dtype=torch.float32, device=device))
            return self._residual_dev
        if self._residual_host is None:
            self._residual_host = (self._residual_dev.cpu().numpy()
                                   if self._residual_dev is not None
                                   else np.zeros(self.fragment.numel, dtype=np.float32))
        return self._residual_host

    def residual_l2(self) -> float:
        """The carried residual's L2 norm (telemetry); a residual on the
        card is reduced there and only the scalar fetched."""
        if self._residual_host is not None:
            return float(np.linalg.norm(self._residual_host))
        if self._residual_dev is not None:
            return float(torch.linalg.vector_norm(self._residual_dev))
        return 0.0

    def _encode_host(self, local: torch.Tensor) -> Any:
        assert self._backup_host is not None, "set_backup before encoding"
        x = (self._backup_host.numpy() - local.numpy()) + self._residual_on(None)
        scale, q = self._quantize(x)
        deq = q.astype(np.float32) * np.float32(scale)
        # Non-finite elements cannot ride the wire; their residual is zeroed,
        # not carried (a NaN residual would poison every later scale).
        self._pending_residual = np.where(np.isfinite(x), x - deq, 0.0).astype(np.float32)
        self._pending_on_device = False
        return deq

    def _prepare_device(self, frag_leaves: List[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        device = frag_leaves[0].device
        q, scale, new_residual = ef_quantize(
            _device_flat(frag_leaves, torch.float32), self._backup_device(device),
            self._residual_on(device), self._qmax)
        self._pending_residual = new_residual
        self._pending_on_device = True
        return q, scale.reshape(1)

    def _finish_device(self, prep: Prepared, timeout: float) -> Tuple[Any, int]:
        # Only q and the scale cross: int8 bytes + 4, the residual stays.
        q, scale = self._fetch(prep, timeout)
        deq = q.numpy().astype(np.float32) * np.float32(float(scale[0]))
        return deq, q.numel() + 4

    def on_commit(self) -> None:
        if self._pending_residual is None:
            return
        if self._pending_on_device:
            self._residual_dev, self._residual_host = self._pending_residual, None
        else:
            self._residual_host, self._residual_dev = self._pending_residual, None
        self._pending_residual = None

    def on_abort(self) -> None:
        self._pending_residual = None
        self._residual_host = None
        self._residual_dev = None


class _Int4EFCodec(_Int8EFCodec):
    """int4 with error feedback, the Streaming DiLoCo design point
    (arXiv:2501.18512 wires 4-bit outer gradients): scale amax / 7, values
    in [-7, 7], packed two a byte on the ring's ``wire_codec="int4"``.  The
    copy off the card still moves one int8 byte an element (the nibble
    packing is the wire's); the saving is on the cross-group wire."""

    name = "int4"
    wire_codec = "int4"
    _qmax = 7

    def _quantize(self, x: np.ndarray):
        return quantize_int4(x)


_CODEC_CLASSES = {
    "f32": FragmentCodec,
    "auto": _AutoCodec,
    "bf16": _BF16Codec,
    "int8": _Int8EFCodec,
    "int4": _Int4EFCodec,
}


def make_codec(name: str, fragment: Fragment) -> FragmentCodec:
    """The codec ``name`` for one fragment; a fragment no lossy codec may
    touch (integer or sub-f32) gets the raw base codec whatever was asked."""
    if name not in _CODEC_CLASSES:
        raise ValueError(f"unknown semisync codec {name!r}; expected {CODECS}")
    if not fragment.lossy_ok and name in ("int8", "int4", "bf16"):
        return FragmentCodec(fragment)
    return _CODEC_CLASSES[name](fragment)
