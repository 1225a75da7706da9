"""Gradient averaging across replica groups: the pipelined bucket averager.

The counterpart of ``torchft_tpu/ddp.py``'s ``GradientAverager``.  Gradients
are coalesced into flat buckets (grouped by dtype, then packed greedily up
to ``bucket_bytes``), **planned once per gradient signature and participant
count** with persistent buffers: a device staging tensor and a pinned host
buffer per bucket.  Each step:

1. every bucket is packed into its staging tensor on the current stream,
   and its device-to-host copy is queued on a side stream behind an event
   recorded after that pack;
2. each bucket's ``Manager.allreduce(host_buf, donate=True)`` is issued as
   soon as that bucket's copy lands (an event wait with the Manager's
   deadline), so bucket 0 is on the wire while later buckets still leave
   the card, and with a multi-lane ring the buckets overlap on the wire;
3. the averaged buckets return by host-to-device copies into the staging
   tensors and are unpacked into the gradients.  An event after each
   upload orders the next step's copy into that pinned buffer behind it.

``device_wire_prep`` (default ``TPUFT_DEVICE_WIRE_PREP``, off) packs each
floating bucket as bfloat16 on the device when the collective wires bf16:
the copy off the card moves half the bytes, and the wire carries the same
bits the ring's own encode would send (the cast rounds to nearest even on
the device, as on the host).  Without a card the same code runs with the
host buffers as the staging tensors and no streams.

bf16 gradients (which numpy cannot hold) are widened to float32 in their
host buffers and summed there; float32 gradients, the models' case, ride
as the JAX package's do, bit for bit.

Each of the train thread's waits runs inside a span of the Manager's step
spans, as in the JAX averager: ``allreduce_d2h`` (a bucket's copy off the
card), ``allreduce_merge`` (its ring) and ``allreduce_h2d`` (its copy back,
and the final wait for the uploads), with the bytes noted onto the step in
flight.  ``last_stats``' three waits are the sums of those spans' durations.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from torchft_tpu_torch.futures import event_wait
from torchft_tpu_torch.manager import Manager

TPUFT_DEVICE_WIRE_PREP_ENV = "TPUFT_DEVICE_WIRE_PREP"
_MAX_PLANS = 8


def _env_flag(name: str, default: bool = False) -> bool:
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return default
    return raw.strip().lower() in ("1", "true", "on", "yes")


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).rsplit(".", 1)[-1]


class _Bucket:
    """Which gradients one flat bucket packs (original indices), where each
    lives in it, and its buffers (set by :class:`_Plan`)."""

    def __init__(self, indices: List[int], shapes: List[tuple], dtype: torch.dtype) -> None:
        self.indices = indices
        self.shapes = shapes
        self.dtype = dtype
        self.sizes = [int(torch.Size(s).numel()) for s in shapes]
        self.offsets: List[int] = []
        off = 0
        for size in self.sizes:
            self.offsets.append(off)
            off += size
        self.numel = off
        self.nbytes = off * dtype.itemsize
        # Split-out 0-d gradients under device wire prep travel full width.
        self.wire_bypass = False
        self.stage: Optional[torch.Tensor] = None  # packed on the grads' device
        self.host: Optional[torch.Tensor] = None   # what the collective reduces
        self.packed = self.fetched = self.uploaded = None  # CUDA events

    def views(self, flat: torch.Tensor) -> List[Tuple[int, torch.Tensor]]:
        """(gradient index, view of ``flat``) per packed gradient."""
        return [(i, flat[o:o + n].view(s))
                for i, o, n, s in zip(self.indices, self.offsets, self.sizes, self.shapes)]


def plan_buckets(metas: Sequence[Tuple[tuple, torch.dtype]], bucket_bytes: int) -> List[_Bucket]:
    """The bucket layout for gradients of ``(shape, dtype)``: stably grouped
    by dtype, then packed greedily up to ``bucket_bytes`` (a larger gradient
    gets a bucket of its own), as the JAX package's ``plan_buckets``."""
    order = sorted(range(len(metas)), key=lambda i: _dtype_name(metas[i][1]))
    buckets: List[_Bucket] = []
    cur: List[int] = []
    cur_bytes = 0
    for i in order:
        shape, dtype = metas[i]
        nbytes = int(torch.Size(shape).numel()) * dtype.itemsize
        if cur and (cur_bytes + nbytes > bucket_bytes or dtype != metas[cur[0]][1]):
            buckets.append(_Bucket(cur, [tuple(metas[j][0]) for j in cur], metas[cur[0]][1]))
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nbytes
    if cur:
        buckets.append(_Bucket(cur, [tuple(metas[j][0]) for j in cur], metas[cur[0]][1]))
    return buckets


class _Plan:
    """A bucket layout with its persistent buffers, for one gradient
    signature on one device."""

    def __init__(self, metas: Sequence[Tuple[tuple, torch.dtype]], bucket_bytes: int,
                 device: torch.device, wire_prep: bool) -> None:
        buckets = plan_buckets(metas, bucket_bytes)
        if wire_prep:
            # 0-d gradients (a loss riding along) keep full width, in a
            # bucket of their own so they do not pull a whole bucket off
            # the device cast.
            split: List[_Bucket] = []
            for b in buckets:
                zero = [k for k, s in enumerate(b.shapes) if len(s) == 0]
                parts = [b]
                if zero and len(zero) < len(b.indices):
                    keep = [k for k in range(len(b.indices)) if k not in zero]
                    parts = [_Bucket([b.indices[k] for k in sel], [b.shapes[k] for k in sel],
                                     b.dtype) for sel in (keep, zero)]
                for nb in parts:
                    nb.wire_bypass = all(len(s) == 0 for s in nb.shapes)
                split += parts
            buckets = split
        self.buckets = buckets
        on_card = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if on_card else None
        for b in buckets:
            floating = b.dtype.is_floating_point
            if wire_prep and floating and b.dtype.itemsize >= 4 and not b.wire_bypass:
                dtype = torch.bfloat16
            elif b.dtype == torch.bfloat16:
                dtype = torch.float32  # numpy has no bfloat16: widened on the host
            else:
                dtype = b.dtype
            b.host = torch.empty(b.numel, dtype=dtype, pin_memory=on_card)
            b.stage = torch.empty(b.numel, dtype=dtype, device=device) if on_card else b.host
            if on_card:
                b.packed, b.fetched, b.uploaded = (torch.cuda.Event() for _ in range(3))


class GradientAverager:
    """Pipelined, coalesced fault-tolerant gradient averaging (25 MB
    buckets, torch DDP's first-bucket size)."""

    def __init__(self, manager: Manager, bucket_bytes: int = 25 << 20,
                 device_wire_prep: Optional[bool] = None) -> None:
        self.manager = manager
        self._bucket_bytes = bucket_bytes
        if device_wire_prep is None:
            device_wire_prep = _env_flag(TPUFT_DEVICE_WIRE_PREP_ENV)
        self._device_wire_prep = bool(device_wire_prep)
        self._plans: Dict[Any, _Plan] = {}
        # The last allreduce's transfers: bytes off and onto the device,
        # per-hop wire bytes, buckets, and the train thread's waits (for
        # the copies off the card, for the ring, and the copies back).
        self.last_stats: Dict[str, Any] = {}

    def _wires_bf16(self) -> bool:
        return getattr(self.manager.collective(), "wire_dtype", None) == "bf16"

    def _plan_for(self, grads: List[torch.Tensor]) -> _Plan:
        """The cached plan for this gradient signature, device and
        participant count; the least recently used of ``_MAX_PLANS`` goes."""
        metas = [(tuple(g.shape), g.dtype) for g in grads]
        key = (tuple(metas), grads[0].device, int(self.manager.num_participants() or 0))
        plan = self._plans.pop(key, None)
        if plan is None:
            if len(self._plans) >= _MAX_PLANS:
                self._plans.pop(next(iter(self._plans)))
            plan = _Plan(metas, self._bucket_bytes, grads[0].device,
                         self._device_wire_prep and self._wires_bf16())
        self._plans[key] = plan
        return plan

    def allreduce(self, grads: Sequence[torch.Tensor]) -> None:
        """Replaces every tensor of ``grads`` (all on one device) in place by
        its average across the participating replica groups.  Blocks until
        the averages are back in the gradients; a bucket whose allreduce
        failed keeps its gradients (the error is latched in the Manager and
        the step's commit vote fails)."""
        grads = list(grads)
        if not grads:
            return
        manager = self.manager
        manager.wait_quorum()
        if (manager.errored() is None and manager.collective().size() == 1
                and manager.is_participating()):
            return  # alone in the ring: the average is the gradient itself
        plan = self._plan_for(grads)
        spans, step = manager.spans, manager.current_step()
        timeout = manager.timeout.total_seconds()
        wire_nbytes = getattr(manager.collective(), "wire_nbytes", None)
        stats: Dict[str, Any] = {"buckets": len(plan.buckets), "d2h_bytes": 0, "h2d_bytes": 0,
                                 "wire_bytes": 0, "d2h_wait_s": 0.0, "ring_wait_s": 0.0,
                                 "h2d_s": 0.0}
        self.last_stats = stats
        stream = plan.stream

        # 1. Pack every bucket; queue its copy off the card behind the pack
        # (and behind the last upload out of the same pinned buffer).
        for b in plan.buckets:
            for i, view in b.views(b.stage):
                view.copy_(grads[i])
            if stream is not None:
                b.packed.record()
                with torch.cuda.stream(stream):
                    stream.wait_event(b.packed)
                    stream.wait_event(b.uploaded)
                    b.host.copy_(b.stage, non_blocking=True)
                    b.fetched.record(stream)

        # 2. Each bucket goes on the wire as soon as it is on the host.
        pending = []
        for b in plan.buckets:
            host_nbytes = b.numel * b.host.element_size()
            with spans.span("allreduce_d2h", step=step, bytes=host_nbytes) as sp:
                if stream is not None:
                    try:
                        event_wait(b.fetched, timeout, "gradient copy off the card")
                    except TimeoutError as e:
                        manager.report_error(e)
                        return
            stats["d2h_wait_s"] += sp.duration_ms / 1e3
            stats["d2h_bytes"] += host_nbytes
            manager.note_d2h(host_nbytes)
            stats["wire_bytes"] += (int(wire_nbytes(b.host[:1], not b.wire_bypass)) * b.numel
                                    if callable(wire_nbytes) else host_nbytes)
            pending.append((b, manager.allreduce(
                b.host, allow_wire_compression=not b.wire_bypass, donate=True)))

        # 3. Drain in order; each average goes back as soon as it lands.
        for b, fut in pending:
            with spans.span("allreduce_merge", step=step) as sp:
                res = fut.result()
            stats["ring_wait_s"] += sp.duration_ms / 1e3
            if res is b.host:
                continue  # latched failure: these gradients stay as they were
            up_nbytes = 0 if stream is None else b.numel * b.host.element_size()
            with spans.span("allreduce_h2d", step=step, bytes=up_nbytes) as sp:
                if stream is None:
                    for i, view in b.views(res):
                        grads[i].copy_(view)
                else:
                    if res.data_ptr() != b.host.data_ptr():
                        b.host.copy_(res)  # uploads always leave from the pinned buffer
                    b.stage.copy_(b.host, non_blocking=True)
                    b.uploaded.record()
                    for i, view in b.views(b.stage):
                        grads[i].copy_(view)
            stats["h2d_s"] += sp.duration_ms / 1e3
            if up_nbytes:
                stats["h2d_bytes"] += up_nbytes
                manager.note_h2d(up_nbytes)
        if stream is not None:
            with spans.span("allreduce_h2d", step=step, bytes=0) as sp:
                done = torch.cuda.Event()
                done.record()
                try:
                    event_wait(done, timeout, "gradient copy onto the card")
                except TimeoutError as e:
                    manager.report_error(e)
            stats["h2d_s"] += sp.duration_ms / 1e3
