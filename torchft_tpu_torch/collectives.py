"""Reconfigurable host collectives for the fault-tolerant replica dimension.

The counterpart of ``torchft_tpu/collectives.py``.  Gradients cross replica
groups as host buffers over TCP; ``configure(store_addr, rank, world_size)``
tears down the previous ring and rendezvouses a new one on every quorum
change, and operations return ``Work`` futures whose failures are latched
and reported through ``errored()`` instead of raised into the train loop.
A quorum change that keeps a ring edge (the same neighbour process on the
same side) reuses that edge's lane sockets instead (below).

:class:`TCPCollective` is the JAX package's striped multi-lane ring:
``lanes`` sockets to each ring neighbour, each allreduce cut into chunk
stripes that run as independent tagged rings on the lanes, and the hot
loop either in Python threads (``engine="py"``) or in the native GIL-free
engine of the port's own ``libtpuft.so`` (``engine="native"``,
:class:`~torchft_tpu_torch._native.RingEngine`).  The wire stays the JAX
package's byte for byte, so one ring can hold JAX and port ranks on either
engine:

* the rendezvous keys ``rank_<r>`` (``host:port``) and ``cfg_<r>``
  (``full:<token>`` or ``inc:<token>``) under the quorum's store prefix,
  and the 12-byte dial preamble ``<III`` (rank, channel, lane), one
  connection per lane; channel 0 is the flat ring, 1 a point-to-point
  link, 2 and 3 the 2-D topology's row and column rings;
* incremental reconfiguration (``TPUFT_INCREMENTAL_RECONF``, on by
  default; flat ring only): the listener and its token outlive a
  configure, and a rank whose previous ring is live publishes
  ``inc:<token>``; an edge is reused (its sockets, and its shm segment)
  when the neighbour's (address, token) is the one recorded at the
  previous configure and its mode is ``inc``, and only the other edges are
  dialled and accepted (``last_configure``: ``mode``, ``reused_lanes``,
  ``opened_lanes``, ``configure_s``); a port rank also publishes
  ``nbrs_<r>`` (its previous neighbours) and reuses an edge to another
  port rank only when both ends recorded each other;
* every frame is a ``<IQ`` header (tag, payload bytes) and the payload;
* op ``seq``'s stripe ``s`` owns tags ``seq * 520 + s * 8 + sub``: 1 and 2
  the reduce-scatter and allgather hops of the flat ring and the row tier,
  3 the circulation of the object ops, 4 and 5 the column tier's hops.
  Every op (allreduce, allgather, broadcast, reduce_scatter, alltoall,
  barrier) takes its sequence number from one counter at call time, so a
  port rank and a JAX rank that issue the same ops land on the same tags;
  stripe counts, ``np.array_split`` chunk and stripe geometry (carved from
  the caller's flat payload) and the ring-step order of the sums are the
  reference's;
* the reduce ops ``sum``, ``avg`` (the sum over the world size), ``max``
  and ``min``, on either engine;
* the f32 wire sends the payload's bytes; the bf16 wire rounds each hop's
  chunk to bfloat16 (nearest even) and accumulates in float32, and each
  allgather owner encodes its chunk once, so every rank decodes the same
  bits;
* a per-call ``wire_codec`` (:data:`WIRE_CODECS`) frames each hop's chunk as
  a 4-byte f32 scale and symmetric int8 values (scale = chunk amax / 127) or
  packed signed nibbles (amax / 7), accumulating in the payload's dtype, on
  either engine (``native/src/ring.cc``'s ``Int8Encode`` / ``Int4Encode``
  emit the same bytes as :func:`quantize_int8` / :func:`pack_int4`);
* bf16 payloads off the bf16 wire ride raw bf16 frames and accumulate in
  bf16 (each sum rounded to nearest even), as ``ml_dtypes`` arrays do in
  the JAX engine;
* the 2-D topology (``topology="ring2d"``, or ``"auto"`` from
  ``TPUFT_RING2D_MIN_GROUPS`` groups on, default 8, when the count
  factors): the groups on the R x C grid of :func:`_grid_shape`, a row and a
  column ring dialled beside the flat one; an allreduce reduce-scatters
  along the row, allreduces its owned chunk along the column and
  allgathers along the row, so its sums equal a JAX ring2d's bit for bit
  and the flat ring's within f32 reassociation; a prime world runs the
  flat ring;
* same-host shm lanes (``transport="shm"`` or ``"auto"``,
  ``TPUFT_RING_TRANSPORT``): right after the preamble the dialer sends its
  boot id (``_SHM_REQ``), the acceptor on the same host answers with a
  segment it created (``_SHM_REP``: flag, generation token, name) and the
  dialer acks once it has checked the segment's magic and token; the
  lane's frames then move through a single-producer ring in that segment
  (:class:`_ShmRing`, the native engine's layout), the socket staying open
  as the liveness and abort channel.  The port names its segments
  ``tpuft_torch-*`` (the name rides the handshake, so a JAX peer maps them
  as its own);
* link shaping (``TPUFT_SHAPED_LINK="<mbps>:<rtt_ms>"``,
  :meth:`TCPCollective.set_link_shaping`): :class:`LinkShaper`, one
  virtual-time pacer per peer direction shared by that direction's lanes,
  in the Python engine, and the native engine's pacer of the same model;
* ``allgather``, ``broadcast`` and ``alltoall`` circulate pickled numpy
  arrays on the flat ring's lane 0; ``reduce_scatter`` and ``barrier`` are
  single-lane ring allreduces; ``send`` / ``recv`` ride lazily dialled
  point-to-point links (tag ``100 + tag``; a ``<I`` meta length, the
  pickled (dtype, shape), the raw bytes), one turnstile per (direction,
  peer, tag).  Frames from peers are unpickled by a restricted unpickler
  that builds numpy arrays and dtypes only.

Both engines record every hop into the JAX package's data-plane flight
recorder: per-tier stall aggregates, and a sampled, bounded timeline of
records with exactly :data:`HOP_RECORD_FIELDS` (``TPUFT_HOP_SAMPLE``,
default 1; ``TPUFT_HOP_RING``, default 2048).  :meth:`TCPCollective.lane_stats`
reads the current configuration's counters (they restart at every
``configure``; ``tiers`` and per-tier ``hops`` under ring2d, and each
tier's shaping sleep as ``shape_s``) and :meth:`TCPCollective.lane_totals`
the monotonic totals across reconfigures.

:class:`ErrorSwallowingCollective` latches the first failure and turns the
later ops into no-ops until the next ``configure``;
:class:`ManagedCollective` is a collective facade over a Manager.

Nothing of the JAX package's collective plane is left to port.  One
difference stays, since numpy has no bfloat16 here: the pickled ops
(allgather, broadcast, alltoall) refuse bf16 tensors, and a JAX rank's
``ml_dtypes`` bfloat16 arrays reach a port rank through send / recv only,
as bf16 tensors.
"""

from __future__ import annotations

import collections
import io
import json
import logging
import math
import mmap
import os
import pickle
import select
import socket
import struct
import threading
import time
from abc import ABC, abstractmethod
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from torchft_tpu_torch import _native
from torchft_tpu_torch._native import RingEngine, StoreClient
from torchft_tpu_torch.futures import completed_future, failed_future

__all__ = ["Work", "Collective", "DummyCollective", "TCPCollective", "ErrorSwallowingCollective",
           "ManagedCollective", "LinkShaper", "HopRecorder", "HOP_RECORD_FIELDS", "WIRE_CODECS",
           "bf16_encode", "bf16_decode", "quantize_int8", "quantize_int4", "pack_int4",
           "unpack_int4"]

logger = logging.getLogger("torchft_tpu_torch.collectives")

_HDR = struct.Struct("<IQ")  # tag, nbytes
_PREAMBLE = struct.Struct("<III")  # rank, channel, lane
_SCALE = struct.Struct("<f")  # the int8 / int4 frames' per-chunk scale
_P2P_META = struct.Struct("<I")  # a send frame's pickled-meta length
_CH_RING = 0
_CH_P2P = 1
_CH_ROW = 2
_CH_COL = 3
# Tag space: seq * _TAGS_PER_OP + stripe * _TAGS_PER_STRIPE + subtag, the
# JAX engine's layout: the flat ring and the row tier in the low half of a
# stripe's block, the column tier in the high half.
_MAX_STRIPES = 64
_TAGS_PER_STRIPE = 8
_TAGS_PER_OP = _TAGS_PER_STRIPE * (_MAX_STRIPES + 1)
_SUB_RS = 1  # reduce-scatter hops (flat ring, row tier)
_SUB_AG = 2  # allgather hops (flat ring, row tier)
_SUB_GATHER = 3  # whole-object circulation (allgather, broadcast, alltoall)
_SUB_COL_RS = 4  # the column tier's reduce-scatter (ring2d)
_SUB_COL_AG = 5  # the column tier's allgather (ring2d)
_P2P_TAG_BASE = 100  # send / recv frames ride tag 100 + the caller's tag

# The elementwise combine of each reduce op ("avg" divides by the world
# size after the sum); membership is the validity check.
_REDUCE_COMBINE = {"sum": np.add, "avg": np.add, "max": np.maximum, "min": np.minimum}
_NATIVE_OP = {"sum": RingEngine.OP_SUM, "avg": RingEngine.OP_SUM, "max": RingEngine.OP_MAX,
              "min": RingEngine.OP_MIN}


def _bad_reduce_op(op: str) -> ValueError:
    return ValueError(f"unsupported reduce op {op!r}; expected one of {sorted(_REDUCE_COMBINE)}")


TPUFT_RING_LANES_ENV = "TPUFT_RING_LANES"
TPUFT_RING_ENGINE_ENV = "TPUFT_RING_ENGINE"
_MAX_LANES = 8
_RING_ENGINES = ("auto", "py", "native")
_WIRE_DTYPES = ("auto", "f32", "bf16")

# Incremental reconfiguration: "0" (or false/off/no) takes the full
# rendezvous at every quorum change.
TPUFT_INCREMENTAL_RECONF_ENV = "TPUFT_INCREMENTAL_RECONF"

# The allreduce topology: "ring" (flat), "ring2d" (the R x C grid; a prime
# world runs the flat ring), "auto" (ring2d from TPUFT_RING2D_MIN_GROUPS
# groups on).  Every rank of one collective must agree, as on lanes.
TPUFT_RING_TOPOLOGY_ENV = "TPUFT_RING_TOPOLOGY"
TPUFT_RING2D_MIN_ENV = "TPUFT_RING2D_MIN_GROUPS"
_RING2D_DEFAULT_MIN = 8
_TOPOLOGIES = ("auto", "ring", "ring2d")

# The ring lanes' transport: "tcp" (default); "shm", where a failed
# same-host negotiation fails configure(); "auto", which keeps TCP where
# shm cannot be had.  Every rank of one collective must agree (a TCP rank
# cannot read the handshake).
TPUFT_RING_TRANSPORT_ENV = "TPUFT_RING_TRANSPORT"
_TRANSPORTS = ("tcp", "shm", "auto")
# Data bytes of one lane's segment past its 64-byte header; larger frames
# flow through in pieces, so this bounds memory, not frame size.
TPUFT_SHM_RING_BYTES_ENV = "TPUFT_SHM_RING_BYTES"
_SHM_RING_BYTES_DEFAULT = 1 << 20
# A shaped link, "<mbps>:<rtt_ms>": every peer direction paced at mbps
# plus half the RTT a frame.
TPUFT_SHAPED_LINK_ENV = "TPUFT_SHAPED_LINK"

# The segment header, native/src/ring.cc's (kShmMagic, kShmHdr, kShm*Off):
# magic u64 @0, generation token u64 @8, head (producer cursor) u64 @16,
# tail (consumer cursor) u64 @24, poisoned u32 @32, the native engine's
# parked flags u32 @40 and @44 (this engine polls and never sets them),
# data from @64.  Cursors are monotonic byte counts.
_SHM_MAGIC = 0x746675745F736D68
_SHM_HDR = 64
_SHM_TOKEN_OFF = 8
_SHM_HEAD_OFF = 16
_SHM_TAIL_OFF = 24
_SHM_POISON_OFF = 32
_SHM_DIR = "/dev/shm/"
# The port's segment names (the JAX package's start "tpuft-").
_SHM_PREFIX = "tpuft_torch-"
# The handshake on ring channels when the transport is not "tcp": dialer ->
# its 64-byte padded boot id; acceptor -> (flag, token, segment name);
# dialer -> one ack byte.
_SHM_REQ = struct.Struct("<64s")
_SHM_REP = struct.Struct("<BQ64s")

_native_fallback_warned = False


def _incremental_from_env() -> bool:
    v = os.environ.get(TPUFT_INCREMENTAL_RECONF_ENV, "1").strip().lower()
    return v not in ("0", "false", "off", "no")


def _ring_lanes_from_env() -> int:
    try:
        lanes = int(os.environ.get(TPUFT_RING_LANES_ENV, "2"))
    except ValueError:
        return 2
    return max(1, min(_MAX_LANES, lanes))


def _ring_engine_from_env() -> str:
    engine = os.environ.get(TPUFT_RING_ENGINE_ENV, "auto")
    return engine if engine in _RING_ENGINES else "auto"


def _topology_from_env() -> str:
    topo = os.environ.get(TPUFT_RING_TOPOLOGY_ENV, "auto")
    return topo if topo in _TOPOLOGIES else "auto"


def _ring2d_min_from_env() -> int:
    try:
        return max(2, int(os.environ.get(TPUFT_RING2D_MIN_ENV, str(_RING2D_DEFAULT_MIN))))
    except ValueError:
        return _RING2D_DEFAULT_MIN


def _transport_from_env() -> str:
    t = os.environ.get(TPUFT_RING_TRANSPORT_ENV, "tcp")
    return t if t in _TRANSPORTS else "tcp"


def _shm_ring_bytes_from_env() -> int:
    try:
        return max(4096, int(os.environ.get(TPUFT_SHM_RING_BYTES_ENV,
                                            str(_SHM_RING_BYTES_DEFAULT))))
    except ValueError:
        return _SHM_RING_BYTES_DEFAULT


def _shaped_link_from_env() -> Tuple[float, float]:
    """(mbps, rtt_ms) of ``TPUFT_SHAPED_LINK``; (0, 0) unshaped."""
    spec = os.environ.get(TPUFT_SHAPED_LINK_ENV)
    if not spec:
        return 0.0, 0.0
    try:
        head, _, tail = spec.partition(":")
        return float(head), float(tail or "0")
    except ValueError:
        return 0.0, 0.0


def _boot_id() -> bytes:
    """This host's boot id, the same-host proof two ranks compare at
    rendezvous (equal ids: one kernel, one /dev/shm).  Empty when
    unreadable, which disables shm."""
    try:
        with open("/proc/sys/kernel/random/boot_id", "rb") as f:
            return f.read().strip()[:64]
    except OSError:
        return b""


def _grid_shape(n: int) -> Tuple[int, int]:
    """``(rows, cols)`` with ``rows * cols == n`` and ``rows`` the largest
    divisor of ``n`` up to its square root: the squarest exact grid, which
    every rank derives from the world size alone.  A prime gives (1, n),
    and the caller then runs the flat ring."""
    rows = int(math.isqrt(n))
    while rows > 1 and n % rows:
        rows -= 1
    rows = max(1, rows)
    return rows, n // rows


def _warn_native_fallback(reason: str) -> None:
    """One line per process when ``engine="auto"`` cannot build the native
    engine: a silent Python fallback would report Python-bound numbers as
    the native data plane's."""
    global _native_fallback_warned
    if not _native_fallback_warned:
        _native_fallback_warned = True
        logger.warning("the native ring engine is unavailable; running the PYTHON ring "
                       "engine instead: %s", reason)


# -- the data-plane flight recorder (the JAX package's HopRecorder) ----------
TPUFT_HOP_SAMPLE_ENV = "TPUFT_HOP_SAMPLE"
TPUFT_HOP_RING_ENV = "TPUFT_HOP_RING"
_HOP_RING_DEFAULT = 2048

# The hop record, shared with the native engine and the JAX package: ts =
# wall-clock seconds at the hop's start; tier 0 flat, 1 row, 2 col;
# send_s = blocked joining the lane's sender (link pacing included);
# recv_s = blocked on the matching inbound frame; comb_s = decode + combine
# of the received chunk (0 on allgather forwards); nbytes = payload bytes
# sent.
HOP_RECORD_FIELDS = ("ts", "tier", "lane", "tag", "send_s", "recv_s", "comb_s", "nbytes")
_HOP_TOTAL_KEYS = ("hops", "send_block_s", "recv_wait_s", "combine_s", "shape_s")


def _hop_sample_from_env() -> int:
    try:
        return max(0, int(os.environ.get(TPUFT_HOP_SAMPLE_ENV, "1")))
    except ValueError:
        return 1


def _hop_ring_from_env() -> int:
    try:
        return max(16, int(os.environ.get(TPUFT_HOP_RING_ENV, str(_HOP_RING_DEFAULT))))
    except ValueError:
        return _HOP_RING_DEFAULT


class HopRecorder:
    """The Python engine's hop recorder: per-tier aggregate stall counters
    (always on) and a timeline of every ``sample``-th hop (0 keeps none)
    in a ring of ``cap`` records, as the native engine's."""

    def __init__(self, sample: Optional[int] = None, cap: Optional[int] = None) -> None:
        self.sample = sample if sample is not None else _hop_sample_from_env()
        self.cap = cap if cap is not None else _hop_ring_from_env()
        self._lock = threading.Lock()
        self._ring: "collections.deque[dict]" = collections.deque(maxlen=self.cap)
        self._count = 0
        self._agg: Dict[int, List[float]] = {}  # tier -> [hops, send_s, recv_s, comb_s]

    def record(self, tier: int, lane: int, tag: int, send_s: float, recv_s: float,
               comb_s: float, nbytes: int, ts: float) -> None:
        with self._lock:
            agg = self._agg.setdefault(tier, [0, 0.0, 0.0, 0.0])
            agg[0] += 1
            agg[1] += send_s
            agg[2] += recv_s
            agg[3] += comb_s
            if self.sample <= 0:
                return
            n = self._count
            self._count = n + 1
            if n % self.sample:
                return
            self._ring.append({"ts": ts, "tier": tier, "lane": lane, "tag": tag,
                               "send_s": send_s, "recv_s": recv_s, "comb_s": comb_s,
                               "nbytes": nbytes})

    def stats(self, tier: int) -> dict:
        """Aggregate stall counters of one tier (the native engine's
        ``hop_stats`` keys)."""
        with self._lock:
            agg = self._agg.get(tier, [0, 0.0, 0.0, 0.0])
            return {"hops": int(agg[0]), "send_block_s": agg[1], "recv_wait_s": agg[2],
                    "combine_s": agg[3]}

    def records(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    def keep(self, rec: dict) -> None:
        """Appends a hop recorded elsewhere (a closing native engine's
        timeline) without touching the aggregates."""
        with self._lock:
            self._ring.append(rec)

    def reset_aggregates(self) -> None:
        """Zeroes the aggregates (banked by the caller) and keeps the
        timeline, which is what explains a fault after an abort."""
        with self._lock:
            self._agg = {}


def bf16_encode(x: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 bits (uint16), round to nearest even: the bf16
    wire's encode, bit for bit ``ml_dtypes``' cast and the native engine's.

    The cast runs through torch.  On finite values and infinities torch's
    rounding is those casts' exactly.  NaN is not: torch's casts give
    ``0x7FC0`` or ``0xFFFF`` (scalar or vector path), where ``ml_dtypes``
    and the native engine give a quiet NaN that keeps the input's sign
    (``sign | 0x7FC0``), so NaN lanes are rewritten to that; a NaN's
    payload bits are dropped by all three."""
    x = np.asarray(x, dtype=np.float32).reshape(-1)
    if not x.flags.c_contiguous or not x.flags.writeable:
        x = x.copy()  # torch.from_numpy wants a writable, contiguous array
    bits = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    nan = np.isnan(x)
    if nan.any():
        bits[nan] = ((x.view(np.uint32)[nan] >> 16) & 0x8000).astype(np.uint16) | 0x7FC0
    return bits


def bf16_decode(bits: np.ndarray) -> np.ndarray:
    """bfloat16 bits (uint16) -> float32, exactly."""
    return (np.asarray(bits, dtype=np.uint16).astype(np.uint32) << 16).view(np.float32)


def _bf16_round(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to the nearest bfloat16, kept as float32."""
    return bf16_decode(bf16_encode(x))


# Per-call wire codecs (TCPCollective.allreduce(wire_codec=...)), the JAX
# package's: "int8" frames a chunk as its f32 scale (amax / 127) and int8
# values, ~0.25x the f32 wire; "int4" as its scale (amax / 7) and signed
# nibbles two to a byte, ~0.125x.  Lossy per hop like the bf16 wire; meant
# for payloads with an error-feedback loop at the source (the semisync
# pseudogradients), never for raw weights.
WIRE_CODECS = ("int8", "int4")


def _quantize(x: np.ndarray, qmax: int):
    x = np.asarray(x)
    if x.dtype != np.float32:
        x = x.astype(np.float32)
    amax = float(np.max(np.abs(x))) if x.size else 0.0
    scale = amax / float(qmax) if (amax > 0.0 and math.isfinite(amax)) else 1.0
    q = np.clip(np.rint(np.nan_to_num(x / scale, nan=0.0)), -qmax, qmax).astype(np.int8)
    return scale, q


def quantize_int8(x: np.ndarray):
    """``(scale, q)``: the symmetric int8 quantizer, scale = amax / 127,
    round to nearest even, clipped to [-127, 127].  A non-finite amax falls
    back to scale 1; inf elements saturate to +/-127 and NaN elements encode
    as 0 (the wire cannot carry NaN).  The JAX package's, bit for bit; the
    semisync codec's device encoder is its torch twin."""
    return _quantize(x, 127)


def quantize_int4(x: np.ndarray):
    """``(scale, q)``: the symmetric int4 quantizer, scale = amax / 7,
    clipped to [-7, 7]; ``q`` is int8-typed and :func:`pack_int4` packs it.
    The non-finite rules of :func:`quantize_int8`."""
    return _quantize(x, 7)


def pack_int4(q: np.ndarray) -> np.ndarray:
    """Packs signed nibbles (int8 in [-7, 7]) two to a byte: element 2i in
    the low nibble, 2i+1 in the high one, two's complement; an odd tail
    leaves the last high nibble 0 (``native/src/ring.cc``'s layout)."""
    u = (q.astype(np.int16) & 0xF).astype(np.uint8)
    if u.size % 2:
        u = np.concatenate([u, np.zeros(1, dtype=np.uint8)])
    return (u[0::2] | (u[1::2] << 4)).astype(np.uint8)


def unpack_int4(raw, n: int) -> np.ndarray:
    """The first ``n`` signed int8 values of a packed nibble stream."""
    b = np.frombuffer(raw, dtype=np.uint8)
    nib = np.empty(b.size * 2, dtype=np.int16)
    nib[0::2] = b & 0xF
    nib[1::2] = b >> 4
    return ((nib[:n] ^ 8) - 8).astype(np.int8)


def _is_floating(a: Any) -> bool:
    if isinstance(a, torch.Tensor):
        return a.is_floating_point()
    return np.issubdtype(np.asarray(a).dtype, np.floating)


class LinkShaper:
    """A shaped link on localhost, applied at the sender: each frame pays
    half the RTT (propagation) and its bytes are paced at the configured
    bandwidth (serialization), the JAX package's model.

    The serialization budget is a shared virtual-time pacer: the lanes of
    one peer direction share one shaper and queue on the modelled link, so
    adding lanes cannot multiply the modelled bandwidth (lanes win only by
    overlapping propagation and host work with serialization).  When the
    native engine owns the direction's sends, its pacer counts and sleeps,
    and the hooks read its counters."""

    def __init__(self, mbps: float, rtt_ms: float) -> None:
        self.bytes_per_s = mbps * 1e6 / 8.0
        self.half_rtt_s = rtt_ms / 2000.0
        self._bytes_sent = 0
        self._frames_sent = 0
        self._wait_s = 0.0
        self._native_read: Optional[Callable[[], Tuple[int, int]]] = None
        self._native_wait: Optional[Callable[[], float]] = None
        self._lock = threading.Lock()
        # Monotonic time until which the modelled link is busy with the
        # frames already admitted.
        self._busy_until = 0.0

    @property
    def bytes_sent(self) -> int:
        if self._native_read is not None:
            return self._native_read()[0]
        return self._bytes_sent

    @property
    def frames_sent(self) -> int:
        if self._native_read is not None:
            return self._native_read()[1]
        return self._frames_sent

    @property
    def wait_s(self) -> float:
        """Seconds senders slept in this pacer (the shaping time)."""
        if self._native_wait is not None:
            return self._native_wait()
        return self._wait_s

    def set_rate(self, mbps: float, rtt_ms: float) -> None:
        """Re-paces the link mid-run; ``mbps`` <= 0 disables the pacing
        (the native pacer's contract)."""
        with self._lock:
            if mbps > 0:
                self.bytes_per_s = mbps * 1e6 / 8.0
                self.half_rtt_s = rtt_ms / 2000.0
            else:
                self.bytes_per_s = float("inf")
                self.half_rtt_s = 0.0

    def reset_counters(self) -> None:
        """Zeroes the counters and drops the native hooks (a reused edge's
        shaper at an incremental reconfigure: its totals were banked)."""
        self._native_read = None
        self._native_wait = None
        with self._lock:
            self._bytes_sent = 0
            self._frames_sent = 0
            self._wait_s = 0.0
            self._busy_until = 0.0

    @classmethod
    def from_env(cls) -> Optional["LinkShaper"]:
        spec = os.environ.get(TPUFT_SHAPED_LINK_ENV)
        if not spec:
            return None
        mbps, _, rtt = spec.partition(":")
        return cls(float(mbps), float(rtt or "0"))

    def delay_s(self, nbytes: int) -> float:
        return self.half_rtt_s + nbytes / self.bytes_per_s

    def on_send(self, nbytes: int) -> None:
        with self._lock:
            self._bytes_sent += nbytes
            self._frames_sent += 1
            now = time.monotonic()
            start = max(now, self._busy_until)
            self._busy_until = start + nbytes / self.bytes_per_s
            # Delivered once its bytes clear the shared link, plus the
            # one-way propagation.
            wake = self._busy_until + self.half_rtt_s
        remaining = wake - time.monotonic()
        if remaining > 0:
            time.sleep(remaining)
            with self._lock:
                self._wait_s += remaining


# -- frames from peers: numpy arrays and dtypes only ---------------------------


class _Bf16Dtype:
    """A JAX rank's ``ml_dtypes.bfloat16`` dtype in a received frame (numpy
    has no bfloat16 here): a send of one comes back as a bf16 tensor."""

    def __setstate__(self, state: Any) -> None:
        pass


def _np_dtype(obj: Any, *args: Any) -> Any:
    if obj is _Bf16Dtype or (isinstance(obj, str) and obj == "bfloat16"):
        return _Bf16Dtype()
    return np.dtype(obj, *args)


_RECONSTRUCT = np.zeros(0).__reduce__()[0]
_SCALAR = np.float32(0).__reduce__()[0]
_FRAME_GLOBALS: Dict[Tuple[str, str], Any] = {("numpy", "dtype"): _np_dtype,
                                              ("numpy", "ndarray"): np.ndarray}
for _mod in ("numpy.core.multiarray", "numpy._core.multiarray"):
    _FRAME_GLOBALS[(_mod, "_reconstruct")] = _RECONSTRUCT
    _FRAME_GLOBALS[(_mod, "scalar")] = _SCALAR


class _FrameUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str) -> Any:
        if (module, name) == ("ml_dtypes", "bfloat16"):
            return _Bf16Dtype
        found = _FRAME_GLOBALS.get((module, name))
        if found is None:
            raise pickle.UnpicklingError(f"a ring frame names {module}.{name}: only numpy "
                                         f"arrays and dtypes are accepted")
        return found


def _frame_loads(data: Any) -> Any:
    """Unpickles an object op's or a send's frame from a peer."""
    return _FrameUnpickler(io.BytesIO(bytes(data))).load()


def _as_u8(arr: np.ndarray) -> np.ndarray:
    """A flat uint8 view of a contiguous array (0-d included)."""
    arr = np.ascontiguousarray(arr)
    return arr.reshape(-1).view(np.uint8)


def _host_array(a: Any) -> Tuple[np.ndarray, str]:
    """``a`` (a numpy array or a CPU tensor) as numpy, and its kind."""
    if isinstance(a, torch.Tensor):
        if a.device.type != "cpu":
            raise ValueError(f"collectives take host buffers, got a tensor on {a.device}")
        if a.dtype == torch.bfloat16:
            raise ValueError("bf16 tensors ride allreduce, reduce_scatter and send/recv; "
                             "the pickled ops carry numpy dtypes")
        return a.detach().contiguous().numpy(), "torch"
    return np.ascontiguousarray(a), "numpy"


def _as_kind(arr: Any, kind: str) -> Any:
    if kind != "torch" or isinstance(arr, torch.Tensor):
        return arr
    arr = np.asarray(arr)
    return torch.from_numpy(arr if arr.flags.writeable else arr.copy())


def _clone(a: Any) -> Any:
    return a.clone() if isinstance(a, torch.Tensor) else np.array(a, copy=True)


def _zeros(shape: tuple, dtype: Any) -> Any:
    if isinstance(dtype, torch.dtype):
        return torch.zeros(shape, dtype=dtype)
    return np.zeros(shape, dtype)


def _nbytes(a: Any) -> int:
    if isinstance(a, torch.Tensor):
        return a.numel() * a.element_size()
    return int(np.asarray(a).nbytes)


class Work:
    """Handle for an asynchronous collective operation."""

    def __init__(self, future: Future) -> None:
        self._future = future

    def wait(self, timeout: Optional[float] = None):
        return self._future.result(timeout=timeout)

    def result(self, timeout: Optional[float] = None):
        return self._future.result(timeout=timeout)

    def done(self) -> bool:
        return self._future.done()

    def exception(self, timeout: Optional[float] = None):
        return self._future.exception(timeout=timeout)

    def future(self) -> Future:
        return self._future

    def add_done_callback(self, fn: Callable[[Future], None]) -> None:
        self._future.add_done_callback(fn)


class Collective(ABC):
    """A reconfigurable collective over the replica-group dimension: the
    ops of a process group, on host buffers (numpy arrays or CPU
    tensors)."""

    @abstractmethod
    def configure(self, store_addr: str, rank: int, world_size: int) -> None:
        """(Re)builds the communicator, aborting any previous one.
        ``store_addr`` is ``host:port/prefix``, one prefix per quorum."""

    @abstractmethod
    def allreduce(self, arrays: Sequence[Any], op: str = "sum",
                  allow_wire_compression: bool = True, donate: bool = False,
                  wire_codec: Optional[str] = None) -> Work:
        """Elementwise reduction (sum, avg, max or min) across ranks; the
        Work resolves to the list of reduced arrays."""

    @abstractmethod
    def allgather(self, array: Any) -> Work:
        """Every rank's array; the Work resolves to a list of world_size."""

    @abstractmethod
    def broadcast(self, array: Any, root: int = 0) -> Work:
        """Root's array on every rank."""

    @abstractmethod
    def reduce_scatter(self, arrays: Sequence[Any], op: str = "sum") -> Work:
        """Rank i receives the reduction of every rank's ``arrays[i]``."""

    @abstractmethod
    def alltoall(self, arrays: Sequence[Any]) -> Work:
        """Rank i sends ``arrays[j]`` to rank j; resolves to the received
        list, by source rank."""

    @abstractmethod
    def send(self, array: Any, dst: int, tag: int = 0) -> Work: ...

    @abstractmethod
    def recv(self, shape: tuple, dtype: Any, src: int, tag: int = 0) -> Work: ...

    @abstractmethod
    def barrier(self) -> Work: ...

    @abstractmethod
    def size(self) -> int: ...

    @abstractmethod
    def rank(self) -> int: ...

    def errored(self) -> Optional[Exception]:
        return None

    def abort(self) -> None:
        """Fails in-flight work; the collective is unusable until the next
        ``configure``."""

    def shutdown(self) -> None:
        self.abort()


class DummyCollective(Collective):
    """World-size-1 collective: copies inputs to outputs at once."""

    wire_codecs = WIRE_CODECS  # accepted, and moot at world size 1

    def __init__(self, rank: int = 0, world_size: int = 1) -> None:
        self._rank = rank
        self._world_size = world_size
        self.configure_count = 0

    def configure(self, store_addr: str, rank: int, world_size: int) -> None:
        self._rank = rank
        self._world_size = world_size
        self.configure_count += 1

    def allreduce(self, arrays: Sequence[Any], op: str = "sum",
                  allow_wire_compression: bool = True, donate: bool = False,
                  wire_codec: Optional[str] = None) -> Work:
        return Work(completed_future([_clone(a) for a in arrays]))

    def allgather(self, array: Any) -> Work:
        return Work(completed_future([_clone(array)]))

    def broadcast(self, array: Any, root: int = 0) -> Work:
        return Work(completed_future(_clone(array)))

    def reduce_scatter(self, arrays: Sequence[Any], op: str = "sum") -> Work:
        return Work(completed_future(_clone(arrays[0])))

    def alltoall(self, arrays: Sequence[Any]) -> Work:
        return Work(completed_future([_clone(a) for a in arrays]))

    def send(self, array: Any, dst: int, tag: int = 0) -> Work:
        return Work(completed_future(None))

    def recv(self, shape: tuple, dtype: Any, src: int, tag: int = 0) -> Work:
        return Work(completed_future(_zeros(shape, dtype)))

    def barrier(self) -> Work:
        return Work(completed_future(None))

    def size(self) -> int:
        return self._world_size

    def rank(self) -> int:
        return self._rank


class _ShmRing:
    """One attached end of a same-host single-producer, single-consumer
    byte ring: the Python engine's half of the shm lanes, over the native
    engine's segment layout (``ShmWriteAll`` / ``ShmReadExact`` in
    ``native/src/ring.cc``), so a Python producer feeds a native consumer
    and the reverse.

    A lane link is one-way (the dialer sends, the acceptor receives), so
    the only synchronisation is the pair of monotonic cursors in the
    header, head (producer) and tail (consumer).  A stall polls the link's
    kept TCP socket: a dead peer's socket reads EOF long before the op
    timeout, so shm lanes fail as fast as TCP lanes."""

    _SPINS = 512

    def __init__(self, path: str, token: int, sock: socket.socket) -> None:
        fd = os.open(path, os.O_RDWR)
        try:
            size = os.fstat(fd).st_size
            if size <= _SHM_HDR:
                raise ConnectionError(f"shm segment too small: {size} bytes")
            self._mm = mmap.mmap(fd, size)
        finally:
            os.close(fd)
        magic, tok = struct.unpack_from("<QQ", self._mm, 0)
        if magic != _SHM_MAGIC or tok != token:
            self._mm.close()
            raise ConnectionError("stale shm segment (generation mismatch); refusing to attach")
        self._cap = size - _SHM_HDR
        self._sock = sock
        self.path = path
        self._closed = False

    def _u64(self, off: int) -> int:
        return struct.unpack_from("<Q", self._mm, off)[0]

    def poison(self) -> None:
        """Marks the segment dead for the peer (a socket shutdown's shm
        twin)."""
        if not self._closed:
            struct.pack_into("<I", self._mm, _SHM_POISON_OFF, 1)

    def _wait_tick(self, spins: List[int], deadline: float, consumer: bool = False) -> None:
        """One step without progress: spin a little, then check the
        deadline, the peer's poison flag and the socket.  The consumer
        fails on the peer's death only once the ring is drained (its last
        frames land before its close sets the flag, as bytes sit in a
        closed socket's buffer)."""
        def dead(msg: str) -> None:
            if consumer and self._u64(_SHM_HEAD_OFF) - self._u64(_SHM_TAIL_OFF):
                return  # frames still in the ring: drain them first
            raise ConnectionError(msg)

        if struct.unpack_from("<I", self._mm, _SHM_POISON_OFF)[0]:
            dead("peer connection closed (shm ring poisoned)")
            return
        if spins[0] < self._SPINS:
            spins[0] += 1
            return
        spins[0] = 0
        if time.monotonic() > deadline:
            raise TimeoutError("shm ring timed out")
        try:
            readable, _, _ = select.select([self._sock], [], [], 0)
            eof = bool(readable) and self._sock.recv(1, socket.MSG_PEEK) == b""
        except (OSError, ValueError):
            readable, eof = False, True
        if eof:
            dead("peer connection closed")
            return
        if readable:
            raise ConnectionError("unexpected socket data on an shm lane")
        time.sleep(20e-6)

    def write(self, data: Any, timeout: float) -> None:
        """Producer: appends ``data``'s bytes, waiting while the ring is
        full; frames larger than the ring flow through in pieces."""
        mv = memoryview(data)
        if mv.ndim != 1 or mv.itemsize != 1:
            mv = mv.cast("B")
        deadline = time.monotonic() + timeout
        spins = [0]
        pos, n, cap = 0, len(mv), self._cap
        while pos < n:
            if self._closed:
                raise ConnectionError("shm ring closed")
            h = self._u64(_SHM_HEAD_OFF)
            t = self._u64(_SHM_TAIL_OFF)
            free = cap - (h - t)
            if free == 0:
                self._wait_tick(spins, deadline)
                continue
            take = min(n - pos, free)
            off = h % cap
            first = min(take, cap - off)
            self._mm[_SHM_HDR + off:_SHM_HDR + off + first] = mv[pos:pos + first]
            if take > first:
                self._mm[_SHM_HDR:_SHM_HDR + take - first] = mv[pos + first:pos + take]
            struct.pack_into("<Q", self._mm, _SHM_HEAD_OFF, h + take)
            pos += take
            deadline = time.monotonic() + timeout
            spins[0] = 0

    def read_into(self, view: memoryview, timeout: float) -> None:
        """Consumer: fills ``view``, waiting while the ring is empty."""
        deadline = time.monotonic() + timeout
        spins = [0]
        pos, n, cap = 0, len(view), self._cap
        while pos < n:
            if self._closed:
                raise ConnectionError("shm ring closed")
            t = self._u64(_SHM_TAIL_OFF)
            h = self._u64(_SHM_HEAD_OFF)
            avail = h - t
            if avail == 0:
                self._wait_tick(spins, deadline, consumer=True)
                continue
            take = min(n - pos, avail)
            off = t % cap
            first = min(take, cap - off)
            view[pos:pos + first] = self._mm[_SHM_HDR + off:_SHM_HDR + off + first]
            if take > first:
                view[pos + first:pos + take] = self._mm[_SHM_HDR:_SHM_HDR + take - first]
            struct.pack_into("<Q", self._mm, _SHM_TAIL_OFF, t + take)
            pos += take
            deadline = time.monotonic() + timeout
            spins[0] = 0

    def close(self) -> None:
        if not self._closed:
            try:
                self.poison()
            except ValueError:
                pass
            self._closed = True
            try:
                self._mm.close()
            except Exception:  # noqa: BLE001 - a view may still pin the map
                pass


class _Peer:
    """A framed TCP link to one peer (a ring neighbour on one lane, or a
    point-to-point link).

    Several stripes share a lane, so frames arrive out of order and are
    demultiplexed by tag.  The demux is leader/follower, as the JAX
    engine's: one caller at a time reads the socket, but it publishes every
    frame for another tag to the stash under the condition and notifies,
    so a caller whose frame already landed takes it at once instead of
    queueing behind the reader (holding one lock across the read can
    deadlock two ring directions).

    A ring link negotiated onto shm keeps ``shm_pending`` (path, token,
    role) until the configure arms it: the native engine maps the segment
    itself; the Python engine arms ``shm_tx`` (the dialer, producer) or
    ``shm_rx`` (the acceptor, consumer), and frames then move through the
    segment while the socket stays open for liveness."""

    def __init__(self, sock: socket.socket, shaper: Optional[LinkShaper] = None) -> None:
        self.sock = sock
        self.send_lock = threading.Lock()
        self.recv_cond = threading.Condition()
        self._reading = False
        self._stash: Dict[int, List[bytearray]] = {}
        self.shaper = shaper if shaper is not None else LinkShaper.from_env()
        # Frame bytes (headers included) the Python engine moved.
        self.bytes_out = 0
        self.bytes_in = 0
        self.shm_pending: Optional[tuple] = None
        self.shm_tx: Optional[_ShmRing] = None
        self.shm_rx: Optional[_ShmRing] = None

    def send_msg(self, tag: int, payload: Any) -> None:
        """``payload``: one buffer, or a list of buffers sent as one frame."""
        parts = payload if isinstance(payload, (list, tuple)) else [payload]
        total = sum(len(p) for p in parts)
        with self.send_lock:
            if self.shaper is not None:
                self.shaper.on_send(total + _HDR.size)
            if self.shm_tx is not None:
                budget = self.sock.gettimeout() or 60.0
                self.shm_tx.write(_HDR.pack(tag, total), budget)
                for p in parts:
                    self.shm_tx.write(p, budget)
            else:
                self.sock.sendall(_HDR.pack(tag, total))
                for p in parts:
                    self.sock.sendall(p)
            self.bytes_out += _HDR.size + total

    def recv_msg(self, tag: int) -> bytearray:
        with self.recv_cond:
            while True:
                q = self._stash.get(tag)
                if q:
                    payload = q.pop(0)
                    if not q:
                        del self._stash[tag]
                    return payload
                if not self._reading:
                    self._reading = True
                    break
                # The reader hands us our frame through the stash or steps
                # down; its socket timeout bounds this wait.
                self.recv_cond.wait()
        try:
            while True:
                got_tag, nbytes = _HDR.unpack(self.recv_exact(_HDR.size))
                payload = self.recv_exact(nbytes)
                self.bytes_in += _HDR.size + nbytes
                if got_tag == tag:
                    return payload
                with self.recv_cond:
                    self._stash.setdefault(got_tag, []).append(payload)
                    self.recv_cond.notify_all()
        finally:
            with self.recv_cond:
                self._reading = False
                self.recv_cond.notify_all()

    def recv_exact(self, n: int) -> bytearray:
        buf = bytearray(n)
        view = memoryview(buf)
        if self.shm_rx is not None:
            self.shm_rx.read_into(view, self.sock.gettimeout() or 60.0)
            return buf
        got = 0
        while got < n:
            r = self.sock.recv_into(view[got:], n - got)
            if r == 0:
                raise ConnectionError("peer connection closed")
            got += r
        return buf

    def close(self) -> None:
        for ring in (self.shm_tx, self.shm_rx):
            if ring is not None:
                ring.close()
        # shutdown first: it wakes a thread blocked in recv on this socket.
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()


class _FifoQueue:
    """The submission-order turnstile of one (direction, peer, tag) stream
    of point-to-point ops.  Once an op on the stream fails the stream is
    poisoned and every later op fails at once: skipping a failed slot would
    let the far side's matching op pair with the next op's frame."""

    def __init__(self) -> None:
        self.cond = threading.Condition()
        self.next_submit = 0
        self.next_serve = 0
        self.poison: Optional[Exception] = None

    def take_ticket(self) -> int:
        with self.cond:
            seq = self.next_submit
            self.next_submit += 1
            return seq

    def wait_turn(self, seq: int, timeout: float) -> None:
        with self.cond:
            ok = self.cond.wait_for(lambda: self.poison is not None or self.next_serve >= seq,
                                    timeout=timeout)
            if self.poison is not None:
                raise RuntimeError(f"channel poisoned by earlier failure: {self.poison}")
            if not ok:
                raise TimeoutError("timed out waiting for earlier op on this channel")

    def done(self) -> None:
        with self.cond:
            self.next_serve += 1
            self.cond.notify_all()

    def poison_with(self, exc: Exception) -> None:
        with self.cond:
            if self.poison is None:
                self.poison = exc
            self.cond.notify_all()


class _TierLinks:
    """One nested ring of the 2-D topology (a grid row or column): ``size``
    members, this rank at ``ring_rank``, one socket a lane a direction, and
    its own sender pools."""

    def __init__(self, size: int, ring_rank: int, next_rank: int, prev_rank: int) -> None:
        self.size = size
        self.ring_rank = ring_rank
        self.next_rank = next_rank  # world rank of the tier's next neighbour
        self.prev_rank = prev_rank  # world rank of the tier's previous neighbour
        self.next_lanes: List[_Peer] = []
        self.prev_lanes: List[_Peer] = []
        self.send_pools: List[ThreadPoolExecutor] = []

    def peers(self) -> List[_Peer]:
        return list(self.next_lanes) + list(self.prev_lanes)


def _listen(host: str) -> socket.socket:
    if host:
        return socket.create_server((host, 0))
    try:
        return socket.create_server(("", 0), family=socket.AF_INET6, dualstack_ipv6=True)
    except OSError:  # no IPv6 on this host
        return socket.create_server(("", 0))


def _close_listener(listener: socket.socket) -> None:
    # shutdown wakes the accept loop's blocked accept(); close alone does not.
    try:
        listener.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    listener.close()


class _Payload:
    """One allreduce's inputs as numpy, and the way back to the caller's
    types.  Inputs are numpy arrays or CPU torch tensors; bf16 tensors are
    carried as float32 (exact)."""

    def __init__(self, arrays: Sequence[Any]) -> None:
        self.kinds: List[str] = []
        self.arrays: List[np.ndarray] = []
        for a in arrays:
            if isinstance(a, torch.Tensor):
                if a.device.type != "cpu":
                    raise ValueError(f"allreduce takes host buffers, got a tensor on {a.device}")
                t = a.detach().contiguous()
                if t.dtype == torch.bfloat16:
                    self.kinds.append("bf16")
                    self.arrays.append(t.view(torch.int16).numpy().view(np.uint16))
                else:
                    self.kinds.append("torch")
                    self.arrays.append(t.numpy())
            else:
                self.kinds.append("numpy")
                self.arrays.append(np.ascontiguousarray(a))
        self.bf16 = "bf16" in self.kinds
        if self.bf16 and any(k != "bf16" for k in self.kinds):
            raise ValueError("allreduce: bf16 tensors cannot share a call with other dtypes")

    def flat(self) -> np.ndarray:
        """The flat working payload (f32 for bf16 inputs); a single input is
        viewed, not copied."""
        parts = [a.reshape(-1) for a in self.arrays]
        flat = np.concatenate(parts) if len(parts) > 1 else parts[0]
        return bf16_decode(flat) if self.bf16 else flat

    def fresh(self) -> bool:
        """Whether :meth:`flat` is a new buffer, free to reduce in place."""
        return self.bf16 or len(self.arrays) > 1

    def itemsize(self) -> int:
        """Bytes per element of the caller's flat payload (stripe geometry
        is carved from these, as the JAX engine carves from its flattened
        inputs: a mixed call promotes, as ``np.concatenate`` does)."""
        if self.bf16:
            return 2
        return np.result_type(*[a.dtype for a in self.arrays]).itemsize

    def unflatten(self, out_flat: np.ndarray) -> List[Any]:
        out: List[Any] = []
        pos = 0
        for a, kind in zip(self.arrays, self.kinds):
            piece = out_flat[pos:pos + a.size]
            pos += a.size
            if kind == "bf16":
                out.append(torch.from_numpy(bf16_encode(piece)).view(torch.bfloat16)
                           .reshape(a.shape))
                continue
            piece = piece.reshape(a.shape).astype(a.dtype, copy=False)
            out.append(torch.from_numpy(piece) if kind == "torch" else piece)
        return out


class TCPCollective(Collective):
    """Striped multi-lane ring between replica groups, over TCP or
    same-host shm lanes, flat or 2-D.

    Ring allreduce moves 2(n-1)/n of the payload per rank.  ``lanes``
    parallel connections link each pair of ring neighbours; with more than
    one lane an allreduce is cut into round-robin chunk stripes (about
    ``chunk_bytes`` each, a lane multiple, at most 64), stripe ``s`` running
    its own ring on lane ``s % lanes`` under its own tags, so one stripe's
    sum overlaps another's bytes on the wire and back-to-back allreduces
    (the averager's buckets) overlap each other.  Program order of the ops
    must be the same on every rank; alignment within it rides on the tags.

    Args:
        timeout: seconds an op (and each socket read) may take.
        chunk_bytes: target stripe size.
        wire_dtype: ``"f32"`` sends the payload's bytes; ``"bf16"`` halves
            floating payloads on the wire (each hop rounds to bfloat16,
            local sums stay in the input dtype); ``"auto"`` picks bf16 when
            ``TPUFT_LINK_PROFILE=dcn`` or ``TPUFT_SHAPED_LINK`` is set, as the
            JAX package does, else f32.
        lanes: connections per neighbour (default ``TPUFT_RING_LANES`` or 2,
            at most 8).
        engine: ``"native"`` runs the hot loop in the GIL-free native engine
            and raises where it cannot be built; ``"py"`` in Python threads;
            ``"auto"`` (default ``TPUFT_RING_ENGINE`` or auto) the native
            engine, falling back to Python with one warning.  Payloads the
            native engine does not reduce (non-f32 accumulation) run the
            Python hops over the engine's sockets.
        host: the address to listen on and advertise; by default every
            interface, advertised under this machine's host name.
        topology: ``"ring"``, ``"ring2d"`` or ``"auto"`` (default
            ``TPUFT_RING_TOPOLOGY`` or auto), resolved at every configure
            (:attr:`topology`).  The object ops run on the flat ring always.
        transport: ``"tcp"``, ``"shm"`` or ``"auto"`` (default
            ``TPUFT_RING_TRANSPORT`` or tcp); :attr:`ring_transport` says
            what the configuration runs.
    """

    RENDEZVOUS_TIMEOUT_S = 60.0

    def __init__(
        self,
        timeout: float = 60.0,
        chunk_bytes: int = 4 << 20,
        wire_dtype: str = "auto",
        lanes: Optional[int] = None,
        engine: Optional[str] = None,
        host: Optional[str] = None,
        topology: Optional[str] = None,
        transport: Optional[str] = None,
    ) -> None:
        if wire_dtype not in _WIRE_DTYPES:
            raise ValueError(f"unsupported wire_dtype {wire_dtype!r}; expected one of "
                             f"{_WIRE_DTYPES}")
        if wire_dtype == "auto":
            wire_dtype = ("bf16" if os.environ.get("TPUFT_LINK_PROFILE") == "dcn"
                          or os.environ.get(TPUFT_SHAPED_LINK_ENV) else "f32")
        engine = engine if engine is not None else _ring_engine_from_env()
        if engine not in _RING_ENGINES:
            raise ValueError(f"unsupported engine {engine!r}; expected one of {_RING_ENGINES}")
        topology = topology if topology is not None else _topology_from_env()
        if topology not in _TOPOLOGIES:
            raise ValueError(f"unsupported topology {topology!r}; expected one of {_TOPOLOGIES}")
        transport = transport if transport is not None else _transport_from_env()
        if transport not in _TRANSPORTS:
            raise ValueError(f"unsupported transport {transport!r}; expected one of "
                             f"{_TRANSPORTS}")
        self._timeout = timeout
        self._chunk_bytes = chunk_bytes
        self._wire_dtype = wire_dtype
        self._lanes = max(1, min(_MAX_LANES, lanes if lanes is not None
                                 else _ring_lanes_from_env()))
        self._engine_mode = engine
        self._engine: Optional[_native.RingEngine] = None
        self._host = host or ""
        self._topology = topology  # requested; resolved at every configure
        self._ring2d_min = _ring2d_min_from_env()
        self._active_topology = "ring"
        self._row_tier: Optional[_TierLinks] = None
        self._col_tier: Optional[_TierLinks] = None
        # The lane transport asked for, the links this configuration armed
        # on shm, and every segment this rank negotiated (both ends track
        # every path, so whichever survives a crash unlinks it).
        self._transport = transport
        self._shm_links = 0
        self._shm_lock = threading.Lock()
        self._shm_paths: set = set()
        self._lock = threading.Lock()
        self._rank = 0
        self._world_size = 1
        self._generation = 0
        self._next_lanes: List[_Peer] = []  # to (rank + 1) % n, one per lane
        self._prev_lanes: List[_Peer] = []  # from (rank - 1) % n, one per lane
        self._listener: Optional[socket.socket] = None
        self._store: Optional[StoreClient] = None
        # Unstriped ops (lanes == 1 allreduces and the object ops) run one
        # at a time in submission order.
        self._ring_executor: Optional[ThreadPoolExecutor] = None
        # Striped ops: two workers a lane, so a stripe waiting on the wire
        # does not hold the next op's stripes off it.
        self._lane_executor: Optional[ThreadPoolExecutor] = None
        # Point-to-point ops, which may overlap freely.
        self._p2p_executor: Optional[ThreadPoolExecutor] = None
        # One single-worker sender per lane: hops send full duplex.
        self._send_pools: List[ThreadPoolExecutor] = []
        # Allocated on the caller's thread: the same program order on every
        # rank yields the same tags.
        self._op_seq = 0
        self._op_error: Optional[Exception] = None
        self._inflight: set = set()
        # The accept loop's tables: ring and tier lanes by (rank, channel,
        # lane) until a configure takes them, point-to-point links by rank.
        self._accept_cond = threading.Condition()
        self._accepted_ring: Dict[Tuple[int, int, int], _Peer] = {}
        self._peers: Dict[int, _Peer] = {}
        self._dialing: set = set()
        # Point-to-point turnstiles, one per (direction, peer, tag).
        self._fifo_lock = threading.Lock()
        self._fifo: Dict[tuple, _FifoQueue] = {}
        self._p2p_submit_lock = threading.Lock()
        # The shapers accepted previous-direction lanes get (on the
        # instance, so a kept accept loop arms a later generation's lanes).
        self._ring_prev_shaper: Optional[LinkShaper] = None
        self._tier_prev_shapers: Dict[int, Optional[LinkShaper]] = {}
        # The Python hops' recorder; native ring passes record inside the
        # engine and are merged in hop_records / lane_stats.
        self._hops = HopRecorder()
        # Counters of every closed configuration, banked at abort (and at an
        # incremental configure), so lane_totals never goes backwards.
        self._lifetime: Dict[str, Any] = {}
        # Incremental reconfiguration: this rank's published listener
        # address and the token minted with the listener, and each ring
        # neighbour's (address, token) as the last configure saw it.
        self._incremental = _incremental_from_env()
        self._self_addr: Optional[str] = None
        self._listener_token = ""
        self._neighbor_ids: Dict[str, tuple] = {}
        self.last_configure: Dict[str, Any] = {"mode": "none", "reused_lanes": 0,
                                               "opened_lanes": 0, "configure_s": 0.0}

    # -- properties -----------------------------------------------------------

    @property
    def ring_engine(self) -> str:
        """The engine the current configuration runs the ring on:
        ``"native"`` or ``"py"``."""
        return "native" if self._engine is not None else "py"

    @property
    def ring_transport(self) -> str:
        """``"shm"`` when the current configuration armed at least one
        same-host segment (a ring on one host arms every lane), else
        ``"tcp"``."""
        return "shm" if self._shm_links > 0 else "tcp"

    @property
    def topology(self) -> str:
        """The topology the current configuration runs: ``"ring"`` or
        ``"ring2d"``."""
        return self._active_topology

    @property
    def lanes(self) -> int:
        return self._lanes

    @property
    def wire_dtype(self) -> str:
        """The resolved wire encoding, ``"f32"`` or ``"bf16"``."""
        return self._wire_dtype

    @property
    def _next(self) -> Optional[_Peer]:
        """Lane 0 to (rank + 1) % n; every lane of a direction shares its
        shaper, so its shaper's counters cover the direction."""
        return self._next_lanes[0] if self._next_lanes else None

    @property
    def _prev(self) -> Optional[_Peer]:
        return self._prev_lanes[0] if self._prev_lanes else None

    # The per-call wire codecs this collective's allreduce accepts.
    wire_codecs = WIRE_CODECS

    def wire_nbytes(self, array: Any, allow_wire_compression: bool = True,
                    wire_codec: Optional[str] = None) -> int:
        """Bytes ``array`` occupies per hop on the ring's wire: under
        ``wire_codec="int8"`` a floating payload counts a byte an element
        plus the 4-byte scale, under ``"int4"`` its packed nibbles plus the
        scale."""
        if isinstance(array, torch.Tensor):
            size, itemsize = array.numel(), array.element_size()
        else:
            array = np.asarray(array)
            size, itemsize = array.size, array.itemsize
        floating = _is_floating(array)
        if floating and wire_codec == "int8":
            return size + _SCALE.size
        if floating and wire_codec == "int4":
            return (size + 1) // 2 + _SCALE.size
        if floating and allow_wire_compression and self._wire_dtype == "bf16":
            return 2 * size
        return size * itemsize

    def _resolve_topology(self, world_size: int) -> str:
        """The topology a world of ``world_size`` runs: ring2d needs a grid
        (a prime has none), and "auto" keeps the flat ring below the
        crossover."""
        if self._topology == "ring" or world_size < 4:
            return "ring"
        rows, _cols = _grid_shape(world_size)
        if rows < 2:
            return "ring"
        if self._topology == "ring2d":
            return "ring2d"
        return "ring2d" if world_size >= self._ring2d_min else "ring"

    def _tiers(self) -> List[Tuple[str, int, Optional[_TierLinks], List[_Peer], List[_Peer]]]:
        """(name, native tier id, tier, next lanes, prev lanes) of every
        ring this configuration runs: the flat one, then ring2d's row and
        column."""
        out: List[Tuple[str, int, Optional[_TierLinks], List[_Peer], List[_Peer]]] = [
            ("flat", RingEngine.TIER_FLAT, None, self._next_lanes, self._prev_lanes)]
        for name, tid, tier in (("row", RingEngine.TIER_ROW, self._row_tier),
                                ("col", RingEngine.TIER_COL, self._col_tier)):
            if tier is not None:
                out.append((name, tid, tier, tier.next_lanes, tier.prev_lanes))
        return out

    def _tier_id(self, tier: Optional[_TierLinks]) -> int:
        if tier is None:
            return RingEngine.TIER_FLAT
        return RingEngine.TIER_ROW if tier is self._row_tier else RingEngine.TIER_COL

    # -- lifecycle ------------------------------------------------------------

    def configure(self, store_addr: str, rank: int, world_size: int) -> None:
        t0 = time.monotonic()
        # The incremental attempt comes first: abort() would close the
        # sockets and the listener it keeps.
        if self._configure_incremental(store_addr, rank, world_size, t0):
            return
        self.abort()
        with self._lock:
            self._op_error = None
            self._rank = rank
            self._world_size = world_size
            self._op_seq = 0
            self._active_topology = self._resolve_topology(world_size)
            # abort() may have cancelled queued point-to-point ops that
            # never reach done(): fresh turnstiles.
            with self._fifo_lock:
                self._fifo = {}
            # How the configure went (the Manager's reconfigure event reads
            # it).
            self.last_configure = {"mode": "full", "reused_lanes": 0, "opened_lanes": 0,
                                   "configure_s": 0.0}
            if world_size == 1:
                self.last_configure["configure_s"] = time.monotonic() - t0
                return
            self._store = StoreClient(store_addr)
            self._rendezvous()
            self._engine = self._create_engine()
            self._arm_shm_links()
            self._ring_executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="tpuft_ring")
            self._send_pools = [
                ThreadPoolExecutor(max_workers=1, thread_name_prefix=f"tpuft_send{lane}")
                for lane in range(self._lanes)
            ]
            for name, _tid, tier, _n, _p in self._tiers()[1:]:
                # Each tier's own senders: a row frame never waits behind a
                # column frame bound for another neighbour.
                assert tier is not None
                tier.send_pools = [
                    ThreadPoolExecutor(max_workers=1, thread_name_prefix=f"tpuft_{name}{lane}")
                    for lane in range(self._lanes)
                ]
            if self._lanes > 1:
                self._lane_executor = ThreadPoolExecutor(
                    max_workers=2 * self._lanes, thread_name_prefix="tpuft_lane"
                )
            self._p2p_executor = ThreadPoolExecutor(max_workers=4, thread_name_prefix="tpuft_p2p")
            self.last_configure = {
                "mode": "full", "reused_lanes": 0,
                "opened_lanes": sum(len(n) + len(p) for _, _, _, n, p in self._tiers()),
                "configure_s": time.monotonic() - t0,
            }

    def _configure_incremental(self, store_addr: str, rank: int, world_size: int,
                               t0: float) -> bool:
        """The quorum change's fast path, the JAX package's protocol: when
        this rank's previous flat ring is live, keep the listener and the
        lane sockets (and shm segments) of every edge whose neighbour
        survives, and open only the changed edges.  Returns False (the
        caller then takes the full path, whose abort reclaims whatever this
        attempt left) when a precondition fails or any step slips.

        Every configuring rank publishes ``rank_<r>`` (its address; the
        listener is kept, so it is unchanged here) and ``cfg_<r>``
        (``inc:<token>`` here, ``full:<token>`` on the full path) under the
        new quorum's prefix.  An edge is reused when the neighbour's
        published (address, token) equals the one recorded at the previous
        configure and its mode is ``inc`` (a ``full`` neighbour's abort
        closed its end).  Both ends read the same two records, so they
        decide alike.  Once ``inc`` is published this rank stays on the
        path even when no edge survives (it then rebuilds both over the
        kept listener), since a fresh neighbour may already have dialled
        it.

        A port rank also publishes ``nbrs_<r>``, the neighbours it recorded
        at its previous configure, and reuses an edge to another port rank
        only when the far end recorded this rank there too.  Identity alone
        is not enough when a rank missed a quorum: its neighbour kept its
        listener and token but closed their edge when it reconfigured
        without it, and the rank that missed the quorum would reuse a dead
        socket while the neighbour waited the whole rendezvous timeout for
        its dial (a JAX neighbour publishes no ``nbrs_<r>``; the edge then
        follows the JAX package's rule on both ends).  A ring2d
        configuration, on either side of the change, takes the full path."""
        if not self._incremental:
            return False
        with self._lock:
            try:
                return self._configure_incremental_locked(store_addr, rank, world_size, t0)
            except Exception as e:  # noqa: BLE001 - any slip falls back to the full path
                logger.info("incremental reconfigure fell back to the full path: %s", e)
                return False

    def _configure_incremental_locked(self, store_addr: str, rank: int, world_size: int,
                                      t0: float) -> bool:
        # A live flat ring on both sides of the change, a kept listener, no
        # latched error and nothing in flight (the Manager reconfigures at
        # a step boundary).
        if (self._listener is None or self._self_addr is None or not self._neighbor_ids
                or self._world_size <= 1 or world_size <= 1 or self._op_error is not None
                or self._inflight or not self._next_lanes or not self._prev_lanes
                or self._ring_executor is None or self._active_topology != "ring"
                or self._resolve_topology(world_size) != "ring"):
            return False
        old_next_id = self._neighbor_ids.get("next")
        old_prev_id = self._neighbor_ids.get("prev")
        if old_next_id is None or old_prev_id is None:
            return False
        store = StoreClient(store_addr)
        old_store, self._store = self._store, store
        if old_store is not None:
            old_store.close()
        # Before publishing: close the point-to-point links (ranks
        # renumber) and every ring dial the kept listener accepted and no
        # configure took (a fresh neighbour dials the moment it reads our
        # key, so its lanes must land after this sweep), and bump the
        # generation, as abort() does.
        with self._accept_cond:
            stale = list(self._peers.values()) + list(self._accepted_ring.values())
            self._peers, self._accepted_ring, self._dialing = {}, {}, set()
            self._generation += 1
            self._accept_cond.notify_all()
        for p in stale:
            p.close()
        # The segments of the closing configuration.  Once our key is
        # published the accept loop negotiates the new edges' segments
        # into _shm_paths while this configure runs: those are never
        # dropped below (the JAX rule drops them too, and the neighbour
        # that dialled then maps a segment that is gone).
        with self._shm_lock:
            closing_paths = set(self._shm_paths)
        self._ring_prev_shaper = LinkShaper.from_env()
        store.set(f"rank_{rank}", self._self_addr.encode())
        # Set before cfg_<r>: a neighbour that reads this rank's mode finds
        # its previous neighbours too.
        store.set(f"nbrs_{rank}", json.dumps({"next": list(old_next_id),
                                               "prev": list(old_prev_id)}).encode())
        store.set(f"cfg_{rank}", f"inc:{self._listener_token}".encode())
        next_rank, prev_rank = (rank + 1) % world_size, (rank - 1) % world_size
        # The whole rendezvous budget: a replaced neighbour is a fresh
        # process that may publish late.
        ident_ms = int(self.RENDEZVOUS_TIMEOUT_S * 1000)
        next_id = self._peer_identity(next_rank, timeout_ms=ident_ms)
        prev_id = self._peer_identity(prev_rank, timeout_ms=ident_ms)
        if next_id is None or prev_id is None:
            return False
        me = [self._self_addr, self._listener_token]
        reuse_next = (next_id[2] == "inc" and next_id[:2] == old_next_id
                      and self._recorded_me(next_rank, "prev", me))
        reuse_prev = (prev_id[2] == "inc" and prev_id[:2] == old_prev_id
                      and self._recorded_me(prev_rank, "next", me))
        # Bank the closing configuration's counters while its engine is
        # readable, then detach the engine: its dup'd fds close without a
        # shutdown, so the kept sockets stay connected (a refusal, ops in
        # flight, raises and falls back).
        self._bank_locked()
        engine, self._engine = self._engine, None
        if engine is not None:
            engine.detach()
        keep_paths: set = set()
        for reused, peers in ((reuse_next, self._next_lanes), (reuse_prev, self._prev_lanes)):
            shaper = peers[0].shaper if peers else None
            if reused and shaper is not None:
                shaper.reset_counters()
            for p in peers:
                if reused:
                    p.bytes_out = p.bytes_in = 0
                    if p.shm_pending is not None:
                        keep_paths.add(p.shm_pending[0])
                else:
                    p.close()
        # Unlink the segments of the closed edges; a kept edge's segment
        # keeps its name and token, and the new engine maps it again.
        with self._shm_lock:
            drop = closing_paths - keep_paths
            self._shm_paths -= drop
        for sp in drop:
            try:
                os.unlink(sp)
            except OSError:
                pass
        self._op_error = None
        self._rank = rank
        self._world_size = world_size
        self._op_seq = 0
        with self._fifo_lock:
            self._fifo = {}
        lanes = self._lanes
        opened = 0
        if not reuse_next:
            shaper = LinkShaper.from_env()
            self._next_lanes = [self._dial_rank(next_rank, _CH_RING, lane=lane, shaper=shaper)
                                for lane in range(lanes)]
            opened += lanes
        if not reuse_prev:
            self._prev_lanes = self._take_accepted(
                [(prev_rank, _CH_RING, lane) for lane in range(lanes)])
            opened += lanes
        self._engine = self._create_engine()
        self._arm_shm_links()
        self._neighbor_ids = {"next": next_id[:2], "prev": prev_id[:2]}
        self.last_configure = {
            "mode": "incremental",
            "reused_lanes": (lanes if reuse_next else 0) + (lanes if reuse_prev else 0),
            "opened_lanes": opened,
            "configure_s": time.monotonic() - t0,
        }
        return True

    def _recorded_me(self, peer_rank: int, side: str, me: list) -> bool:
        """Whether ``peer_rank`` recorded this rank as its ``side``
        neighbour at its previous configure; True for a neighbour that
        publishes no record (the JAX package's rule)."""
        assert self._store is not None
        raw = self._store.get(f"nbrs_{peer_rank}", wait=False)
        return raw is None or json.loads(raw.decode()).get(side) == me

    def _peer_identity(self, peer_rank: int, timeout_ms: int = 10_000) -> Optional[tuple]:
        """``(address, token, mode)`` that ``peer_rank`` published under the
        current prefix, or None."""
        assert self._store is not None
        addr = self._store.get(f"rank_{peer_rank}", wait=True, timeout_ms=timeout_ms)
        cfg = self._store.get(f"cfg_{peer_rank}", wait=True, timeout_ms=timeout_ms)
        if addr is None or cfg is None:
            return None
        mode, _, token = cfg.decode().partition(":")
        if not token:
            return None
        return (addr.decode(), token, mode)

    def _create_engine(self) -> Optional[_native.RingEngine]:
        """The native engine over this generation's lane sockets, every
        tier's, paced as ``TPUFT_SHAPED_LINK`` says, or None for the Python
        engine."""
        if self._engine_mode == "py":
            return None
        mbps, rtt_ms = _shaped_link_from_env()
        tiers = self._tiers()
        try:
            engine = (_native.RingEngine(self._lanes, mbps, rtt_ms) if mbps > 0
                      else _native.RingEngine(self._lanes))
            for _name, tid, _tier, nexts, prevs in tiers:
                engine.set_tier(tid, [p.sock.fileno() for p in nexts],
                                [p.sock.fileno() for p in prevs])
            engine.set_hop(self._hops.sample, self._hops.cap)
        except Exception as e:  # noqa: BLE001 - "auto" falls back, "native" raises
            if self._engine_mode == "native":
                raise RuntimeError(f"engine='native': the ring engine cannot run: {e}") from e
            _warn_native_fallback(str(e))
            return None
        # The Python shapers read the native pacers' counters from now on.
        for _name, tid, _tier, nexts, prevs in tiers:
            for direction, peers in ((0, nexts), (1, prevs)):
                shaper = peers[0].shaper if peers else None
                if shaper is not None:
                    self._wire_native_shaper_hooks(engine, shaper, tid, direction)
        return engine

    @staticmethod
    def _wire_native_shaper_hooks(engine: _native.RingEngine, shaper: LinkShaper, tid: int,
                                  direction: int) -> None:
        """Points one shaper's byte and sleep reads at the native pacer of
        its tier-direction (at engine creation, and when
        :meth:`set_link_shaping` attaches a shaper later)."""
        shaper._native_read = lambda: engine.shaper_counters(tid, direction)
        shaper._native_wait = lambda: engine.shaper_wait_s(tid, direction)

    def _rendezvous(self) -> None:
        assert self._store is not None
        lanes = self._lanes
        listener = _listen(self._host)
        listener.listen(16 + 6 * lanes)
        self._listener = listener
        port = listener.getsockname()[1]
        host = self._host or socket.gethostname()
        # The token is minted with the listener: (address, token) equality
        # at a later configure proves the same process holds the far end
        # (an address alone could be a new process on a recycled port).
        self._listener_token = os.urandom(8).hex()
        self._self_addr = f"{host}:{port}"
        self._store.set(f"rank_{self._rank}", self._self_addr.encode())
        # "full": this rank's earlier sockets are gone (abort closed them).
        self._store.set(f"cfg_{self._rank}", f"full:{self._listener_token}".encode())

        n, rank = self._world_size, self._rank
        next_rank, prev_rank = (rank + 1) % n, (rank - 1) % n
        # One pacer per peer direction, shared by its lanes; each ring2d
        # tier direction is another link and gets its own.
        next_shaper = LinkShaper.from_env()
        self._row_tier = self._col_tier = None
        tier_specs: List[Tuple[int, _TierLinks]] = []
        if self._active_topology == "ring2d":
            rows, cols = _grid_shape(n)
            r, c = divmod(rank, cols)
            self._row_tier = _TierLinks(size=cols, ring_rank=c,
                                        next_rank=r * cols + (c + 1) % cols,
                                        prev_rank=r * cols + (c - 1) % cols)
            self._col_tier = _TierLinks(size=rows, ring_rank=r,
                                        next_rank=((r + 1) % rows) * cols + c,
                                        prev_rank=((r - 1) % rows) * cols + c)
            tier_specs = [(_CH_ROW, self._row_tier), (_CH_COL, self._col_tier)]
        self._ring_prev_shaper = LinkShaper.from_env()
        self._tier_prev_shapers = {ch: LinkShaper.from_env() for ch, _t in tier_specs}
        threading.Thread(target=self._accept_loop, args=(listener,), daemon=True,
                         name="tpuft_accept").start()
        # A dial completes in the listener's backlog, so every rank dials
        # all its lanes before waiting for any.
        self._next_lanes = [self._dial_rank(next_rank, _CH_RING, lane=lane, shaper=next_shaper)
                            for lane in range(lanes)]
        for channel, tier in tier_specs:
            shaper = LinkShaper.from_env()
            tier.next_lanes = [self._dial_rank(tier.next_rank, channel, lane=lane, shaper=shaper)
                               for lane in range(lanes)]
        self._prev_lanes = self._take_accepted([(prev_rank, _CH_RING, lane)
                                                for lane in range(lanes)])
        for channel, tier in tier_specs:
            tier.prev_lanes = self._take_accepted([(tier.prev_rank, channel, lane)
                                                   for lane in range(lanes)])
        # Each flat-ring neighbour's identity, which the next configure
        # compares to decide whether an edge survived; a missing one only
        # forces the full path then.
        self._neighbor_ids = {}
        if self._active_topology == "ring":
            try:
                nxt, prv = self._peer_identity(next_rank), self._peer_identity(prev_rank)
                if nxt is not None and prv is not None:
                    self._neighbor_ids = {"next": nxt[:2], "prev": prv[:2]}
            except Exception:  # noqa: BLE001 - a reuse hint only
                pass

    def _accept_loop(self, listener: socket.socket) -> None:
        """Accepts for the listener's lifetime (it outlives an incremental
        configure): ring and tier lanes go to ``_accepted_ring`` until a
        configure takes them, point-to-point links to ``_peers``."""
        while True:
            try:
                conn, _ = listener.accept()
            except OSError:
                return  # the listener was closed
            try:
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                # The op timeout: a read from a stalled peer must fail, not
                # hold a thread forever.
                conn.settimeout(self._timeout)
                peer = _Peer(conn)
                their_rank, channel, lane = _PREAMBLE.unpack(peer.recv_exact(_PREAMBLE.size))
                if channel != _CH_P2P and self._transport != "tcp":
                    self._shm_accept_handshake(peer, their_rank, channel, lane)
                with self._accept_cond:
                    if self._listener is not listener:
                        peer.close()
                        return
                    if channel == _CH_P2P:
                        self._peers[their_rank] = peer
                    else:
                        peer.shaper = (self._ring_prev_shaper if channel == _CH_RING
                                       else self._tier_prev_shapers.get(channel))
                        stale = self._accepted_ring.pop((their_rank, channel, lane), None)
                        if stale is not None:
                            stale.close()
                        self._accepted_ring[(their_rank, channel, lane)] = peer
                    self._accept_cond.notify_all()
            except Exception:  # noqa: BLE001 - a bad dial is dropped
                conn.close()

    def _take_accepted(self, expected: List[Tuple[int, int, int]]) -> List[_Peer]:
        """The accepted lanes ``expected`` (rank, channel, lane), in order,
        once all have connected."""
        with self._accept_cond:
            ok = self._accept_cond.wait_for(
                lambda: all(k in self._accepted_ring for k in expected),
                timeout=self.RENDEZVOUS_TIMEOUT_S)
            if not ok:
                missing = [k for k in expected if k not in self._accepted_ring]
                raise TimeoutError(f"rendezvous: ring lanes never connected: {missing}")
            return [self._accepted_ring.pop(k) for k in expected]

    def _dial_rank(self, peer_rank: int, channel: int, timeout: Optional[float] = None,
                   lane: int = 0, shaper: Optional[LinkShaper] = None) -> _Peer:
        assert self._store is not None
        timeout = timeout if timeout is not None else self.RENDEZVOUS_TIMEOUT_S
        addr = self._store.get(f"rank_{peer_rank}", wait=True, timeout_ms=int(timeout * 1000))
        if addr is None:
            raise TimeoutError(f"rendezvous: rank {peer_rank} never published its address")
        phost, pport = addr.decode().rsplit(":", 1)
        sock = socket.create_connection((phost, int(pport)), timeout=min(self._timeout, timeout))
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.settimeout(self._timeout)
        peer = _Peer(sock, shaper=shaper)
        sock.sendall(_PREAMBLE.pack(self._rank, channel, lane))
        if channel != _CH_P2P and self._transport != "tcp":
            self._shm_dial_handshake(peer, peer_rank)
        return peer

    # -- same-host shm lanes ----------------------------------------------------

    def _create_shm_segment(self, their_rank: int, channel: int, lane: int) -> Tuple[str, int]:
        """A fresh segment for one same-host lane link: created exclusively,
        sized header + ring, stamped with the magic and a fresh random
        generation token, which the dialer checks against the one this
        connection negotiated, so a dead process's leftover segment is never
        attached."""
        name = (f"{_SHM_PREFIX}{os.getpid()}-g{self._generation}-r{their_rank}"
                f"to{self._rank}-c{channel}-l{lane}-{os.urandom(4).hex()}")
        path = _SHM_DIR + name
        try:
            os.unlink(path)
        except FileNotFoundError:
            pass
        cap = _shm_ring_bytes_from_env()
        fd = os.open(path, os.O_RDWR | os.O_CREAT | os.O_EXCL, 0o600)
        try:
            os.ftruncate(fd, _SHM_HDR + cap)
            token = int.from_bytes(os.urandom(8), "little") | 1
            os.pwrite(fd, struct.pack("<QQQQI", _SHM_MAGIC, token, 0, 0, 0), 0)
        except OSError:
            os.close(fd)
            try:
                os.unlink(path)
            except OSError:
                pass
            raise
        os.close(fd)
        return path, token

    def _shm_accept_handshake(self, peer: _Peer, their_rank: int, channel: int,
                              lane: int) -> None:
        """The acceptor's half, right after the preamble: read the dialer's
        boot id; on this host, create a segment and offer (token, name);
        the dialer's positive ack arms the consumer role at configure."""
        (req,) = _SHM_REQ.unpack(bytes(peer.recv_exact(_SHM_REQ.size)))
        mine = _boot_id()
        flag, token, name, path = 0, 0, b"", None
        if mine and req.rstrip(b"\x00") == mine:
            try:
                path, token = self._create_shm_segment(their_rank, channel, lane)
                name = os.path.basename(path).encode()
                flag = 1
            except OSError:
                flag, token, name, path = 0, 0, b"", None
        peer.sock.sendall(_SHM_REP.pack(flag, token, name))
        if not flag:
            return
        assert path is not None
        if bytes(peer.recv_exact(1)) != b"\x01":
            # The dialer could not attach: stay on TCP, reclaim the segment.
            try:
                os.unlink(path)
            except OSError:
                pass
            return
        peer.shm_pending = (path, token, "rx")
        with self._shm_lock:
            self._shm_paths.add(path)

    def _shm_dial_handshake(self, peer: _Peer, peer_rank: int) -> None:
        """The dialer's half: send our boot id; on an offer, check the
        segment's magic and token before acking (a stale segment is
        refused here) and record the producer role."""
        peer.sock.sendall(_SHM_REQ.pack(_boot_id()))
        flag, token, name = _SHM_REP.unpack(bytes(peer.recv_exact(_SHM_REP.size)))
        if not flag:
            if self._transport == "shm":
                raise ConnectionError(
                    f"transport 'shm' but rank {peer_rank} offered no same-host segment "
                    "(another host, an unreadable boot id, or the segment could not be "
                    "created); use transport='auto' for mixed placements")
            return
        path = _SHM_DIR + name.rstrip(b"\x00").decode()
        try:
            fd = os.open(path, os.O_RDWR)
            try:
                magic, tok = struct.unpack("<QQ", os.pread(fd, 16, 0))
            finally:
                os.close(fd)
            if magic != _SHM_MAGIC or tok != token:
                raise ConnectionError("stale shm segment (generation mismatch); refusing to "
                                      "attach")
        except Exception:
            peer.sock.sendall(b"\x00")
            if self._transport == "shm":
                raise
            return
        peer.sock.sendall(b"\x01")
        peer.shm_pending = (path, token, "tx")
        with self._shm_lock:
            self._shm_paths.add(path)

    def _arm_shm_links(self) -> None:
        """Arms every negotiated segment on the engine this configuration
        runs: the native engine maps them itself (``set_shm``), the Python
        engine attaches the peers' producer and consumer halves."""
        self._shm_links = 0
        for _name, tid, _tier, nexts, prevs in self._tiers():
            for direction, peers in ((0, nexts), (1, prevs)):
                for lane, peer in enumerate(peers):
                    if peer.shm_pending is None:
                        continue
                    # A kept edge on the Python engine is armed already: its
                    # halves map the kept segment.
                    if self._engine is None and (peer.shm_tx is not None
                                                 or peer.shm_rx is not None):
                        self._shm_links += 1
                        continue
                    path, token, role = peer.shm_pending
                    try:
                        if self._engine is not None:
                            self._engine.set_shm(tid, direction, lane, path, token)
                        elif role == "tx":
                            peer.shm_tx = _ShmRing(path, token, peer.sock)
                        else:
                            peer.shm_rx = _ShmRing(path, token, peer.sock)
                    except Exception:
                        if self._transport == "shm":
                            raise
                        continue
                    self._shm_links += 1

    def _dial_p2p(self, peer_rank: int) -> _Peer:
        """The point-to-point link to ``peer_rank``.  The lower rank dials
        and concurrent callers share one socket a pair; a waiter takes over
        from a dialer that failed, and a reconfigure during the dial
        discards it (the generation check)."""
        deadline = time.monotonic() + self._timeout
        while True:
            with self._accept_cond:
                gen = self._generation
                peer = self._peers.get(peer_rank)
                if peer is not None:
                    return peer
                if self._rank < peer_rank and peer_rank not in self._dialing:
                    self._dialing.add(peer_rank)
                    break  # this rank dials
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(f"no point-to-point link to rank {peer_rank} within "
                                       f"the timeout")
                if self._rank < peer_rank:
                    def ready() -> bool:
                        return (peer_rank in self._peers or peer_rank not in self._dialing
                                or self._generation != gen)
                else:
                    def ready() -> bool:
                        return peer_rank in self._peers or self._generation != gen
                self._accept_cond.wait_for(ready, timeout=remaining)
                if self._generation != gen:
                    raise RuntimeError("collective reconfigured during dial")
        try:
            peer = self._dial_rank(peer_rank, _CH_P2P,
                                   timeout=max(0.1, deadline - time.monotonic()))
        except Exception:
            with self._accept_cond:
                self._dialing.discard(peer_rank)
                self._accept_cond.notify_all()
            raise
        with self._accept_cond:
            self._dialing.discard(peer_rank)
            self._accept_cond.notify_all()
            if self._generation != gen:
                peer.close()
                raise RuntimeError("collective reconfigured during dial")
            self._peers[peer_rank] = peer
        return peer

    def abort(self) -> None:
        with self._lock:
            self._bank_locked()
            with self._accept_cond:
                stale = list(self._peers.values()) + list(self._accepted_ring.values())
                self._peers, self._accepted_ring, self._dialing = {}, {}, set()
                # A dial completing after this must not register into the
                # next generation's tables.
                self._generation += 1
                self._accept_cond.notify_all()
            engine, self._engine = self._engine, None
            tiers = [t for t in (self._row_tier, self._col_tier) if t is not None]
            peers = (self._next_lanes + self._prev_lanes + [p for t in tiers for p in t.peers()]
                     + stale)
            self._next_lanes, self._prev_lanes = [], []
            self._row_tier = self._col_tier = None
            if self._listener is not None:
                _close_listener(self._listener)
                self._listener = None
            # The listener and its token are gone: no edge of this rank can
            # be reused by the next configure.
            self._neighbor_ids = {}
            self._self_addr = None
            pools = [self._ring_executor, self._lane_executor, self._p2p_executor,
                     *self._send_pools, *[p for t in tiers for p in t.send_pools]]
            self._ring_executor = self._lane_executor = self._p2p_executor = None
            self._send_pools = []
            for pool in pools:
                if pool is not None:
                    pool.shutdown(wait=False, cancel_futures=True)
            if self._store is not None:
                self._store.close()
                self._store = None
            # Both ends track every negotiated segment, so the survivor of a
            # crash reclaims it (a second unlink is a harmless ENOENT).
            with self._shm_lock:
                shm_paths, self._shm_paths = list(self._shm_paths), set()
            self._shm_links = 0
            inflight, self._inflight = list(self._inflight), set()
        # The engine first: its close shuts the connections down (blocked
        # native ops on both ends wake at once), poisons and unmaps its shm
        # links and closes every dup'd fd, so none survives into the next
        # quorum; then the Python sockets.
        if engine is not None:
            engine.close()
        for peer in peers:
            peer.close()
        for sp in shm_paths:
            try:
                os.unlink(sp)
            except OSError:
                pass
        err = RuntimeError("collective aborted")
        for fut in inflight:
            if not fut.done():
                try:
                    fut.set_exception(err)
                except Exception:  # noqa: BLE001 - racing completion
                    pass

    def errored(self) -> Optional[Exception]:
        """The first latched op failure since the last ``configure``."""
        with self._lock:
            return self._op_error

    def _latch(self, exc: Exception) -> None:
        with self._lock:
            if self._op_error is None:
                self._op_error = exc

    def size(self) -> int:
        return self._world_size

    def rank(self) -> int:
        return self._rank

    # -- the data-plane flight recorder ---------------------------------------

    def _tier_bytes(self, tid: int, nexts: List[_Peer],
                    prevs: List[_Peer]) -> Tuple[List[int], List[int]]:
        """(sent, received) frame bytes per lane of one tier: the Python
        hops' plus, under the native engine, its own."""
        sent = [p.bytes_out for p in nexts]
        recv = [p.bytes_in for p in prevs]
        engine = self._engine
        if engine is not None and sent:
            sent = [b + engine.link_bytes(tid, 0, lane) for lane, b in enumerate(sent)]
            recv = [b + engine.link_bytes(tid, 1, lane) for lane, b in enumerate(recv)]
        return sent, recv

    def _tier_shape_s(self, nexts: List[_Peer]) -> float:
        """Shaping sleep of one tier's next direction (sends pace outbound
        only)."""
        shaper = nexts[0].shaper if nexts else None
        return float(shaper.wait_s) if shaper is not None else 0.0

    def _hop_stats(self, tid: int, nexts: List[_Peer]) -> dict:
        """One tier's hop aggregates, both engines merged, with its
        ``shape_s``."""
        s = self._hops.stats(tid)
        engine = self._engine
        if engine is not None:
            ns = engine.hop_stats(tid)
            s = {k: s[k] + ns[k] for k in s}
        s["shape_s"] = self._tier_shape_s(nexts)
        return s

    def hop_records(self) -> List[dict]:
        """The retained hop timeline of both engines, oldest first, each a
        dict with exactly :data:`HOP_RECORD_FIELDS`."""
        recs = self._hops.records()
        engine = self._engine
        if engine is not None:
            recs += engine.hop_records(self._hops.cap)
        recs.sort(key=lambda r: r["ts"])
        return recs

    def _live_counters(self) -> dict:
        tiers: Dict[str, dict] = {}
        hops: Dict[str, dict] = {}
        for name, tid, _tier, nexts, prevs in self._tiers():
            sent, recv = self._tier_bytes(tid, nexts, prevs)
            tiers[name] = {"sent_bytes": sum(sent), "recv_bytes": sum(recv)}
            hops[name] = self._hop_stats(tid, nexts)
        return {"sent_bytes": sum(t["sent_bytes"] for t in tiers.values()),
                "recv_bytes": sum(t["recv_bytes"] for t in tiers.values()),
                "tiers": tiers, "hops": hops}

    def _bank_locked(self) -> None:
        """Folds the closing configuration's counters into the lifetime
        bank and keeps the closing engine's hop timeline (the caller holds
        ``_lock``; abort calls it before the lanes go)."""
        if not self._next_lanes:
            return
        live = self._live_counters()
        bank = self._lifetime
        bank["reconfigures"] = bank.get("reconfigures", 0) + 1
        for key in ("sent_bytes", "recv_bytes"):
            bank[key] = bank.get(key, 0) + live[key]
        for name, t in live["tiers"].items():
            slot = bank.setdefault("tiers", {}).setdefault(name, {"sent_bytes": 0,
                                                                  "recv_bytes": 0})
            for key in ("sent_bytes", "recv_bytes"):
                slot[key] += t[key]
        for name, h in live["hops"].items():
            slot = bank.setdefault("hops", {}).setdefault(name,
                                                          dict.fromkeys(_HOP_TOTAL_KEYS, 0))
            for key in _HOP_TOTAL_KEYS:
                slot[key] += h[key]
        if self._engine is not None:
            for rec in self._engine.hop_records(self._hops.cap):
                self._hops.keep(rec)
        # The aggregates are in the bank now; the timeline stays.
        self._hops.reset_aggregates()

    def lane_totals(self) -> dict:
        """Wire bytes and hop aggregates summed over every configuration
        so far (the bank) and the live one: monotonic across reconfigures,
        unlike :meth:`lane_stats`.  A configure holding the lock past 0.5 s
        (a rendezvous) reads the bank alone."""
        acquired = self._lock.acquire(timeout=0.5)
        try:
            live = (self._live_counters() if acquired else
                    {"sent_bytes": 0, "recv_bytes": 0, "tiers": {}, "hops": {}})
            bank = self._lifetime
            out: Dict[str, Any] = {
                "reconfigures": int(bank.get("reconfigures", 0)),
                "sent_bytes": int(bank.get("sent_bytes", 0)) + live["sent_bytes"],
                "recv_bytes": int(bank.get("recv_bytes", 0)) + live["recv_bytes"],
                "tiers": {},
                "hops": {},
            }
            for name in set(live["tiers"]) | set(bank.get("tiers", {})):
                b = bank.get("tiers", {}).get(name, {})
                lv = live["tiers"].get(name, {})
                out["tiers"][name] = {k: int(b.get(k, 0)) + int(lv.get(k, 0))
                                      for k in ("sent_bytes", "recv_bytes")}
            for name in set(live["hops"]) | set(bank.get("hops", {})):
                b = bank.get("hops", {}).get(name, {})
                lv = live["hops"].get(name, {})
                out["hops"][name] = {k: b.get(k, 0) + lv.get(k, 0) for k in _HOP_TOTAL_KEYS}
            return out
        finally:
            if acquired:
                self._lock.release()

    def lane_stats(self) -> dict:
        """This configuration's per-lane wire bytes and hop aggregates (the
        JAX package's layout: ``lanes``, ``topology``, ``engine``,
        ``sent``, ``recv``, under ring2d ``tiers`` (each tier's ``size``,
        ``sent`` and ``recv``), and ``hops`` by tier with each tier's
        ``shape_s``); they restart at every configure.  The Manager puts it
        on ``step_summary`` and the goodput ledger splits the step's
        data-plane waits by its hop deltas."""
        out: Dict[str, Any] = {"lanes": self._lanes, "topology": self._active_topology,
                               "engine": self.ring_engine}
        tiers: Dict[str, dict] = {}
        hops: Dict[str, dict] = {}
        for name, tid, tier, nexts, prevs in self._tiers():
            sent, recv = self._tier_bytes(tid, nexts, prevs)
            if tier is None:
                out["sent"], out["recv"] = sent, recv
            else:
                tiers[name] = {"size": tier.size, "sent": sent, "recv": recv}
            hops[name] = self._hop_stats(tid, nexts)
        if tiers:
            out["tiers"] = tiers
        out["hops"] = hops
        return out

    def set_link_shaping(self, mbps: float, rtt_ms: float, direction: str = "next",
                         tier: str = "flat") -> None:
        """Re-paces one peer direction (``"next"`` or ``"prev"``) of one
        tier (``"flat"``, ``"row"``, ``"col"``) mid-run, in whichever engine
        owns the pacing; ``mbps`` <= 0 disables it.  A collective
        configured unshaped gets a shaper here (its sleep then reads
        through to the native pacer)."""
        tid = {"flat": RingEngine.TIER_FLAT, "row": RingEngine.TIER_ROW,
               "col": RingEngine.TIER_COL}[tier]
        t = {"flat": None, "row": self._row_tier, "col": self._col_tier}[tier]
        if t is None:
            peers = self._next_lanes if direction == "next" else self._prev_lanes
        else:
            peers = t.next_lanes if direction == "next" else t.prev_lanes
        shared: Optional[LinkShaper] = None
        for p in peers:
            if p.shaper is None:
                # Nothing to disable; a zero rate would divide by zero.
                if mbps <= 0:
                    continue
                if shared is None:
                    shared = LinkShaper(mbps, rtt_ms)
                p.shaper = shared
            else:
                p.shaper.set_rate(mbps, rtt_ms)
        engine = self._engine
        if engine is not None:
            d = 0 if direction == "next" else 1
            engine.set_shaper(tid, d, mbps, rtt_ms)
            shaper = peers[0].shaper if peers else None
            if shaper is not None and shaper._native_wait is None:
                self._wire_native_shaper_hooks(engine, shaper, tid, d)

    # -- allreduce ------------------------------------------------------------

    def allreduce(self, arrays: Sequence[Any], op: str = "sum",
                  allow_wire_compression: bool = True, donate: bool = False,
                  wire_codec: Optional[str] = None) -> Work:
        """Sum, average, max or min of ``arrays`` (numpy arrays or CPU
        tensors) across ranks; the Work resolves to the reduced arrays, of
        the inputs' types, dtypes and shapes.

        ``allow_wire_compression=False`` keeps this call on full width under
        the bf16 wire.  ``wire_codec`` (one of :data:`WIRE_CODECS`, floating
        inputs only) frames every hop as int8 or int4 with a per-chunk
        scale, on either wire.  ``donate=True`` hands the buffers to the op:
        the native engine then reduces in place over them, so the results
        may alias the inputs (the Python engine never mutates its inputs)."""
        # Before the world-size-1 path: a bad op fails alone too.
        if op not in _REDUCE_COMBINE:
            return Work(failed_future(_bad_reduce_op(op)))
        if wire_codec is not None:
            if wire_codec not in WIRE_CODECS:
                return Work(failed_future(ValueError(
                    f"unsupported wire_codec {wire_codec!r}; expected one of {WIRE_CODECS}"
                )))
            # Quantizing integers would corrupt them: codecs are float-only.
            if not all(_is_floating(a) for a in arrays):
                return Work(failed_future(ValueError(
                    f"wire_codec={wire_codec!r} requires floating inputs"
                )))
        try:
            payload = _Payload(arrays)
        except ValueError as e:
            return Work(failed_future(e))
        if self._world_size == 1:
            return Work(completed_future([
                a if kind != "numpy" else arr
                for a, arr, kind in zip(arrays, payload.arrays, payload.kinds)
            ]))
        seq = self._next_seq()
        wire = self._wire_for(payload, allow_wire_compression and wire_codec is None, wire_codec)
        if self._active_topology == "ring2d":
            if self._lanes > 1:
                return self._striped_hier_allreduce(payload, op, wire, seq, donate)
            return self._submit(lambda: self._hier_allreduce(payload, op, wire, seq, donate))
        if self._lanes > 1:
            return self._striped_allreduce(payload, op, wire, seq, donate)
        return self._submit(lambda: self._ring_allreduce(payload, op, wire, seq, donate))

    def _next_seq(self) -> int:
        """The op's sequence number, taken on the caller's thread: the same
        program order on every rank yields the same tag blocks."""
        with self._lock:
            seq = self._op_seq
            self._op_seq += 1
        return seq

    def _tag_base(self, seq: int, stripe: int = 0) -> int:
        return (seq * _TAGS_PER_OP + stripe * _TAGS_PER_STRIPE) & 0x7FFFFFFF

    def _wire_for(self, payload: _Payload, allow_wire_compression: bool,
                  codec: Optional[str]) -> "_Wire":
        """How this op's hops encode: under a codec, its frames; else the
        bf16 wire when compression is allowed and configured and every
        input is floating (an integer array in the call must not be
        rounded), with float32 sums; else the payload's own bytes, with
        sums in its dtype (bf16 payloads: rounded to bf16 after each)."""
        bf16_wire = (allow_wire_compression and self._wire_dtype == "bf16"
                     and (payload.bf16
                          or all(np.issubdtype(a.dtype, np.floating) for a in payload.arrays)))
        return _Wire(codec, bf16_wire, payload.bf16 and not bf16_wire)

    def _native_wire_mode(self, flat: np.ndarray, wire: "_Wire") -> Optional[int]:
        """The native engine's wire mode for this op, or None where the
        Python hops run it (no engine, or sums in a dtype other than
        float32)."""
        if self._engine is None or flat.dtype != np.float32 or wire.bf16_acc:
            return None
        if wire.codec is not None:
            return {"int8": RingEngine.WIRE_INT8, "int4": RingEngine.WIRE_INT4}[wire.codec]
        return RingEngine.WIRE_BF16 if wire.bf16_wire else RingEngine.WIRE_RAW

    @staticmethod
    def _native_buffer(flat: np.ndarray, payload: _Payload, donate: bool) -> np.ndarray:
        """The float32 buffer a native pass reduces IN PLACE: the caller's
        own when donated (zero-copy), a buffer :meth:`_Payload.flat` just
        made, else a copy (the ring never mutates an input it was lent)."""
        return flat if donate or payload.fresh() else flat.copy()

    def _submit(self, fn: Callable[[], Any], ring: bool = True) -> Work:
        with self._lock:
            executor = self._ring_executor if ring else self._p2p_executor
        if executor is None:
            return Work(failed_future(self._op_error or RuntimeError("collective not configured")))

        def run() -> Any:
            try:
                return fn()
            except Exception as e:  # noqa: BLE001 - latched, then delivered
                self._latch(e)
                raise

        try:
            return Work(executor.submit(run))
        except RuntimeError as e:  # shut down by a concurrent abort
            self._latch(e)
            return Work(failed_future(e))

    def _native_pass(self, tid: int, lane: int, n: int, rank: int, tag_base: int, rs_sub: int,
                     ag_sub: int, mode: int, op: str, wire_mode: int,
                     views: Sequence[np.ndarray]) -> None:
        """One GIL-free ring pass IN PLACE over contiguous f32 views."""
        engine = self._engine
        if engine is None:
            raise RuntimeError("collective aborted")
        engine.ring_pass(tid, lane, n, rank, tag_base, rs_sub, ag_sub, mode, _NATIVE_OP[op],
                         wire_mode, [v.ctypes.data for v in views], [v.size for v in views],
                         self._timeout)

    def _native_hier_pass(self, buf: np.ndarray, lane: int, tag_base: int, op: str,
                          wire_mode: int) -> None:
        """The ring2d pass over ``buf`` in place, the three phases (and the
        tags) of :meth:`_hier_rs_ag_flat`, each one native call."""
        row, col = self._row_tier, self._col_tier
        assert row is not None and col is not None
        C, crank = row.size, row.ring_rank
        chunks = np.array_split(buf, C)
        self._native_pass(RingEngine.TIER_ROW, lane, C, crank, tag_base, _SUB_RS, _SUB_AG,
                          RingEngine.PASS_RS, op, wire_mode, chunks)
        own = (crank + 1) % C
        if col.size > 1:
            self._native_pass(RingEngine.TIER_COL, lane, col.size, col.ring_rank, tag_base,
                              _SUB_COL_RS, _SUB_COL_AG, RingEngine.PASS_FULL, op, wire_mode,
                              np.array_split(chunks[own], col.size))
        self._native_pass(RingEngine.TIER_ROW, lane, C, crank, tag_base, _SUB_RS, _SUB_AG,
                          RingEngine.PASS_AG, op, wire_mode, chunks)

    def _ring_allreduce(self, payload: _Payload, op: str, wire: "_Wire", seq: int,
                        donate: bool) -> List[Any]:
        """One whole-chunk flat ring pass on lane 0: the lanes == 1 path,
        and the body of reduce_scatter and barrier."""
        n = self._world_size
        flat = payload.flat()
        mode = self._native_wire_mode(flat, wire)
        if mode is not None:
            buf = self._native_buffer(flat, payload, donate)
            self._native_pass(RingEngine.TIER_FLAT, 0, n, self._rank, self._tag_base(seq),
                              _SUB_RS, _SUB_AG, RingEngine.PASS_FULL, op, mode,
                              np.array_split(buf, n))
            return self._finish(buf, payload, op)
        chunks = self._ring_rs_ag(np.array_split(flat, n), wire, op, 0, self._tag_base(seq))
        return self._finish(np.concatenate(chunks), payload, op)

    def _hier_allreduce(self, payload: _Payload, op: str, wire: "_Wire", seq: int,
                        donate: bool) -> List[Any]:
        """The lanes == 1 ring2d allreduce: one 2-D pass over the whole
        payload on lane 0."""
        flat = payload.flat()
        mode = self._native_wire_mode(flat, wire)
        if mode is not None:
            buf = self._native_buffer(flat, payload, donate)
            self._native_hier_pass(buf, 0, self._tag_base(seq), op, mode)
            return self._finish(buf, payload, op)
        return self._finish(self._hier_rs_ag_flat(flat, wire, op, 0, self._tag_base(seq)),
                            payload, op)

    def _finish(self, out_flat: np.ndarray, payload: _Payload, op: str) -> List[Any]:
        if op == "avg":
            out_flat = out_flat / self._world_size
        return payload.unflatten(out_flat)

    def _stripe_count(self, max_chunk_nbytes: int) -> int:
        """Stripes per ring chunk: enough to keep every lane busy, about
        ``chunk_bytes`` each, a lane multiple, capped below ``_MAX_STRIPES``
        (the cap stays a lane multiple so no stripe's tags spill into the
        next op's block)."""
        per = max(1, self._chunk_bytes)
        s = max(self._lanes, -(-max_chunk_nbytes // per))
        s = -(-s // self._lanes) * self._lanes
        return min(s, _MAX_STRIPES - _MAX_STRIPES % self._lanes)

    def _striped_allreduce(self, payload: _Payload, op: str, wire: "_Wire", seq: int,
                           donate: bool) -> Work:
        n = self._world_size
        try:
            flat = payload.flat()
            # From the caller's payload, not the working copy: every engine,
            # in either package, carves the same stripes.
            max_chunk = -(-flat.size // n) * payload.itemsize()
            nstripes = self._stripe_count(max_chunk)
            mode = self._native_wire_mode(flat, wire)
            if mode is not None:
                flat = buf = self._native_buffer(flat, payload, donate)
            sub = [np.array_split(c, nstripes) for c in np.array_split(flat, n)]
        except Exception as e:  # noqa: BLE001 - latched, then delivered
            self._latch(e)
            return Work(failed_future(e))

        if mode is not None:
            engine = self._engine
            lanes = [s % self._lanes for s in range(nstripes)]
            tags = [self._tag_base(seq, s) for s in range(nstripes)]
            ptrs = [sub[i][s].ctypes.data for s in range(nstripes) for i in range(n)]
            elems = [sub[i][s].size for s in range(nstripes) for i in range(n)]

            def native_body(_s: int) -> None:
                # One crossing into the engine for the whole stripe set.
                if engine is None:
                    raise RuntimeError("collective aborted")
                engine.ring_pass_multi(
                    RingEngine.TIER_FLAT, nstripes, n, self._rank, lanes, tags, _SUB_RS,
                    _SUB_AG, RingEngine.PASS_FULL, _NATIVE_OP[op], mode, ptrs, elems,
                    self._timeout,
                )

            return self._run_striped(1, native_body, lambda _r: self._finish(buf, payload, op))

        def py_body(s: int) -> List[np.ndarray]:
            return self._ring_rs_ag([sub[i][s] for i in range(n)], wire, op, s % self._lanes,
                                    self._tag_base(seq, s))

        def assemble(results: List[Any]) -> List[Any]:
            # One concatenate in (chunk, stripe) order.
            segs = [results[s][i] for i in range(n) for s in range(nstripes)]
            return self._finish(np.concatenate(segs), payload, op)

        return self._run_striped(nstripes, py_body, assemble)

    def _striped_hier_allreduce(self, payload: _Payload, op: str, wire: "_Wire", seq: int,
                                donate: bool) -> Work:
        """Lanes > 1 under ring2d: the flat payload cut into stripes, each
        running the whole 2-D pass on lane ``s % lanes`` under its own tags,
        sized so a stripe's row chunk is about ``chunk_bytes``."""
        row = self._row_tier
        try:
            assert row is not None
            flat = payload.flat()
            nstripes = self._stripe_count(-(-(flat.size * payload.itemsize()) // row.size))
            mode = self._native_wire_mode(flat, wire)
            if mode is not None:
                flat = buf = self._native_buffer(flat, payload, donate)
            stripes = np.array_split(flat, nstripes)
        except Exception as e:  # noqa: BLE001 - latched, then delivered
            self._latch(e)
            return Work(failed_future(e))

        if mode is not None:
            def native_body(s: int) -> None:
                self._native_hier_pass(stripes[s], s % self._lanes, self._tag_base(seq, s), op,
                                       mode)

            return self._run_striped(nstripes, native_body,
                                     lambda _r: self._finish(buf, payload, op))

        def py_body(s: int) -> np.ndarray:
            return self._hier_rs_ag_flat(stripes[s], wire, op, s % self._lanes,
                                         self._tag_base(seq, s))

        def assemble(results: List[Any]) -> List[Any]:
            return self._finish(np.concatenate(results) if len(results) > 1 else results[0],
                                payload, op)

        return self._run_striped(nstripes, py_body, assemble)

    def _run_striped(self, nstripes: int, body: Callable[[int], Any],
                     assemble: Callable[[List[Any]], List[Any]]) -> Work:
        """Runs ``body(s)`` for every stripe on the lane executor and
        resolves the Work with ``assemble(results)``; the first stripe error
        latches, fails the op, and closes this generation's lanes (every
        tier's) so the sibling stripes fail fast instead of waiting out the
        timeout."""
        with self._lock:
            lane_exec = self._lane_executor
            gen = self._generation
        if lane_exec is None:
            return Work(failed_future(self._op_error or RuntimeError("collective not configured")))
        results: List[Any] = [None] * nstripes
        out: Future = Future()
        state = {"pending": nstripes, "failed": False}
        state_lock = threading.Lock()
        with self._lock:
            self._inflight.add(out)

        def settle(value: Any = None, exc: Optional[Exception] = None) -> None:
            if exc is not None:
                self._latch(exc)
                self._fail_ring(gen)
            with self._lock:
                self._inflight.discard(out)
            try:
                if exc is not None:
                    out.set_exception(exc)
                else:
                    out.set_result(value)
            except Exception:  # noqa: BLE001 - racing abort
                pass

        def run(s: int) -> None:
            try:
                results[s] = body(s)
            except Exception as e:  # noqa: BLE001 - delivered through the Work
                with state_lock:
                    first = not state["failed"]
                    state["failed"] = True
                if first:
                    settle(exc=e)
                return
            with state_lock:
                state["pending"] -= 1
                last = state["pending"] == 0 and not state["failed"]
            if last:
                try:
                    value = assemble(results)
                except Exception as e:  # noqa: BLE001 - delivered through the Work
                    settle(exc=e)
                    return
                settle(value)

        try:
            for s in range(nstripes):
                lane_exec.submit(run, s)
        except RuntimeError as e:  # executor shut down by a concurrent abort
            settle(exc=e)
        return Work(out)

    def _fail_ring(self, gen: int) -> None:
        """Closes generation ``gen``'s lanes, every tier's (and its engine's
        dup'd fds), so every op blocked on them fails fast; a later
        generation's fresh lanes are left alone."""
        with self._lock:
            if self._generation != gen:
                return
            peers = [p for _, _, _, n, pv in self._tiers() for p in n + pv]
            engine = self._engine
        if engine is not None:
            engine.close()
        for p in peers:
            p.close()

    # -- the Python hops -------------------------------------------------------

    def _exchange(self, tag: int, payload: Any, lane: int = 0, hop: Optional[dict] = None,
                  tier: Optional[_TierLinks] = None) -> Any:
        """Sends to the next rank of the flat ring (or of ``tier``) while
        receiving from the previous one on ``lane`` (full duplex:
        send-then-receive deadlocks once payloads outgrow the socket
        buffers).  Over the native engine's demux when an engine owns the
        lanes.  Fills ``hop``, when given, with the hop's ``ts``,
        ``recv_s``, ``send_s`` (the further wait for the send after the
        receive) and ``nbytes``; through the engine's exchange, which waits
        for both at once, the whole wait is ``recv_s``, as in the JAX
        package."""
        nbytes = len(payload)
        if hop is not None:
            hop["ts"] = time.time()
            hop["nbytes"] = nbytes
        engine = self._engine
        if engine is not None:
            t0 = time.monotonic()
            out = engine.exchange(self._tier_id(tier), lane, tag,
                                  payload if isinstance(payload, bytes) else bytes(payload),
                                  self._timeout)
            if hop is not None:
                hop["recv_s"], hop["send_s"] = time.monotonic() - t0, 0.0
            return out
        if tier is None:
            pools, nexts, prevs = self._send_pools, self._next_lanes, self._prev_lanes
        else:
            pools, nexts, prevs = tier.send_pools, tier.next_lanes, tier.prev_lanes
        if not pools or not nexts:
            raise RuntimeError("collective aborted")
        sent = pools[lane].submit(nexts[lane].send_msg, tag, payload)
        t0 = time.monotonic()
        received = prevs[lane].recv_msg(tag)
        t1 = time.monotonic()
        sent.result(timeout=self._timeout)
        if hop is not None:
            hop["recv_s"], hop["send_s"] = t1 - t0, time.monotonic() - t1
        return received

    def _record_hop(self, tier: Optional[_TierLinks], lane: int, tag: int, hop: dict,
                    comb_s: float = 0.0) -> None:
        self._hops.record(self._tier_id(tier), lane, tag, hop["send_s"], hop["recv_s"], comb_s,
                          hop["nbytes"], hop["ts"])

    def _ring_rs_ag(self, chunks: List[np.ndarray], wire: "_Wire", op: str, lane: int,
                    tag_base: int, tier: Optional[_TierLinks] = None, rs_sub: int = _SUB_RS,
                    ag_sub: int = _SUB_AG) -> List[np.ndarray]:
        """One ring pass (reduce-scatter, then allgather) over one array per
        rank slot of the flat ring or of ``tier``, in the JAX engine's hop
        order.  On the bf16 wire each reduce-scatter hop rounds the chunk it
        sends and the sum stays in float32; under a codec each hop
        quantizes the chunk it sends with its own scale and combines the
        decoded values."""
        n = tier.size if tier is not None else self._world_size
        rank = tier.ring_rank if tier is not None else self._rank
        chunks = list(chunks)
        encode, decode, combine = wire.codec_fns(chunks[0].dtype, op)
        # Reduce-scatter: after n-1 steps chunk (rank+1) % n is fully reduced.
        tag = tag_base + rs_sub
        for step in range(n - 1):
            send_idx, recv_idx = (rank - step) % n, (rank - step - 1) % n
            hop: dict = {}
            raw = self._exchange(tag, encode(chunks[send_idx]), lane, hop, tier)
            t_comb = time.monotonic()
            chunks[recv_idx] = combine(chunks[recv_idx], decode(raw, chunks[recv_idx].size))
            self._record_hop(tier, lane, tag, hop, time.monotonic() - t_comb)
        return self._ring_ag_phase(chunks, wire, op, lane, tag_base + ag_sub, tier)

    def _ring_ag_phase(self, chunks: List[np.ndarray], wire: "_Wire", op: str, lane: int,
                       tag: int, tier: Optional[_TierLinks] = None) -> List[np.ndarray]:
        """The allgather circulation over the flat ring or ``tier``: each
        rank owns chunk (rank+1) % n and the owned chunks circulate until
        every rank holds all n.  On an encoding wire each owner encodes its
        chunk once and the others forward those bytes, so every rank
        decodes the same bits."""
        n = tier.size if tier is not None else self._world_size
        rank = tier.ring_rank if tier is not None else self._rank
        chunks = list(chunks)
        encode, decode, _combine = wire.codec_fns(chunks[0].dtype, op)
        if wire.encodes:
            own = (rank + 1) % n
            raws: List[Any] = [None] * n
            raws[own] = bytes(encode(chunks[own]))
            for step in range(n - 1):
                send_idx, recv_idx = (rank - step + 1) % n, (rank - step) % n
                hop: dict = {}
                raws[recv_idx] = self._exchange(tag, memoryview(raws[send_idx]), lane, hop, tier)
                self._record_hop(tier, lane, tag, hop)
            return [decode(r, c.size) for r, c in zip(raws, chunks)]
        for step in range(n - 1):
            send_idx, recv_idx = (rank - step + 1) % n, (rank - step) % n
            hop = {}
            raw = self._exchange(tag, encode(chunks[send_idx]), lane, hop, tier)
            chunks[recv_idx] = decode(raw, chunks[recv_idx].size)
            self._record_hop(tier, lane, tag, hop)
        return chunks

    def _hier_rs_ag_flat(self, flat: np.ndarray, wire: "_Wire", op: str, lane: int,
                         tag_base: int) -> np.ndarray:
        """One ring2d pass over a flat buffer: reduce-scatter along the
        row, allreduce of the owned row chunk along the column (on the
        column's subtags), allgather along the row; (C-1) + 2(R-1) + (C-1)
        hops against the flat ring's 2(N-1).  Row partials sum in row ring
        order, then fold across rows in column ring order: fixed by the
        world size and rank, so every rank decodes the same bits."""
        row, col = self._row_tier, self._col_tier
        assert row is not None and col is not None
        C, crank = row.size, row.ring_rank
        chunks = list(np.array_split(flat, C))
        encode, decode, combine = wire.codec_fns(flat.dtype, op)
        tag = tag_base + _SUB_RS
        for step in range(C - 1):
            send_idx, recv_idx = (crank - step) % C, (crank - step - 1) % C
            hop: dict = {}
            raw = self._exchange(tag, encode(chunks[send_idx]), lane, hop, row)
            t_comb = time.monotonic()
            chunks[recv_idx] = combine(chunks[recv_idx], decode(raw, chunks[recv_idx].size))
            self._record_hop(row, lane, tag, hop, time.monotonic() - t_comb)
        own = (crank + 1) % C
        if col.size > 1:
            sub = self._ring_rs_ag(list(np.array_split(chunks[own], col.size)), wire, op, lane,
                                   tag_base, tier=col, rs_sub=_SUB_COL_RS, ag_sub=_SUB_COL_AG)
            chunks[own] = np.concatenate(sub) if len(sub) > 1 else sub[0]
        chunks = self._ring_ag_phase(chunks, wire, op, lane, tag_base + _SUB_AG, tier=row)
        return np.concatenate(chunks) if C > 1 else chunks[0]

    # -- the object ops --------------------------------------------------------

    def _ring_allgather(self, array: np.ndarray, tag: int) -> List[Any]:
        """Every rank's pickled array circulated round the flat ring's lane
        0; the slots, unpickled."""
        n, rank = self._world_size, self._rank
        slots: List[Any] = [None] * n
        slots[rank] = pickle.dumps(array)
        for step in range(n - 1):
            send_idx, recv_idx = (rank - step) % n, (rank - step - 1) % n
            slots[recv_idx] = self._exchange(tag, slots[send_idx])
        return [_frame_loads(s) for s in slots]

    def allgather(self, array: Any) -> Work:
        try:
            arr, kind = _host_array(array)
        except ValueError as e:
            return Work(failed_future(e))
        if self._world_size == 1:
            return Work(completed_future([_as_kind(arr.copy(), kind)]))
        seq = self._next_seq()
        return self._submit(lambda: [
            _as_kind(a, kind) for a in self._ring_allgather(arr, self._tag_base(seq) + _SUB_GATHER)
        ])

    def broadcast(self, array: Any, root: int = 0) -> Work:
        try:
            arr, kind = _host_array(array)
        except ValueError as e:
            return Work(failed_future(e))
        if self._world_size == 1:
            return Work(completed_future(_as_kind(arr.copy(), kind)))
        seq = self._next_seq()
        return self._submit(lambda: _as_kind(
            self._ring_allgather(arr, self._tag_base(seq) + _SUB_GATHER)[root], kind))

    def reduce_scatter(self, arrays: Sequence[Any], op: str = "sum") -> Work:
        """Over one flat ring allreduce of the stacked inputs on lane 0 (the
        JAX package's), of which rank i keeps slice i."""
        if op not in _REDUCE_COMBINE:
            return Work(failed_future(_bad_reduce_op(op)))
        if self._world_size == 1:
            return Work(completed_future(_clone(arrays[0])))
        if len(arrays) != self._world_size:
            return Work(failed_future(ValueError(
                f"reduce_scatter needs world_size={self._world_size} inputs, got {len(arrays)}")))
        try:
            if isinstance(arrays[0], torch.Tensor):
                stacked: Any = torch.stack([t.detach() for t in arrays])
            else:
                stacked = np.stack([np.asarray(a) for a in arrays])
            payload = _Payload([stacked])
        except (ValueError, RuntimeError, TypeError) as e:
            return Work(failed_future(e))
        seq = self._next_seq()
        wire = self._wire_for(payload, True, None)
        return self._submit(
            lambda: self._ring_allreduce(payload, op, wire, seq, False)[0][self._rank])

    def alltoall(self, arrays: Sequence[Any]) -> Work:
        try:
            host = [_host_array(a) for a in arrays]
        except ValueError as e:
            return Work(failed_future(e))
        kind = host[0][1] if host else "numpy"
        if self._world_size == 1:
            return Work(completed_future([_as_kind(a.copy(), k) for a, k in host]))
        seq = self._next_seq()

        def run() -> List[Any]:
            # Everyone's whole list circulates; rank r keeps entry r of each.
            n, rank = self._world_size, self._rank
            slots: List[Any] = [None] * n
            slots[rank] = pickle.dumps([a for a, _k in host])
            tag = self._tag_base(seq) + _SUB_GATHER
            for step in range(n - 1):
                send_idx, recv_idx = (rank - step) % n, (rank - step - 1) % n
                slots[recv_idx] = self._exchange(tag, slots[send_idx])
            lists = [_frame_loads(s) for s in slots]
            return [_as_kind(lists[src][rank], kind) for src in range(n)]

        return self._submit(run)

    def barrier(self) -> Work:
        if self._world_size == 1:
            return Work(completed_future(None))
        payload = _Payload([np.zeros(1, dtype=np.int32)])
        seq = self._next_seq()
        wire = self._wire_for(payload, True, None)
        return self._submit(lambda: (self._ring_allreduce(payload, "sum", wire, seq, False),
                                     None)[1])

    # -- point-to-point --------------------------------------------------------

    def _fifo_queue(self, key: tuple) -> _FifoQueue:
        with self._fifo_lock:
            q = self._fifo.get(key)
            if q is None:
                q = self._fifo[key] = _FifoQueue()
            return q

    def _sever_peer(self, peer_rank: int, gen: int, used: Optional[_Peer]) -> None:
        """Closes the link a failed op used, so the far side's matching op
        fails fast instead of pairing with a later frame; a failure from an
        earlier generation, or on a link already replaced, touches
        nothing."""
        if used is None:
            return
        with self._accept_cond:
            if self._generation != gen or self._peers.get(peer_rank) is not used:
                used = None
            else:
                del self._peers[peer_rank]
        if used is not None:
            used.close()

    def _p2p_op(self, q: _FifoQueue, peer_rank: int, body: Callable[[List[_Peer]], Any]) -> Work:
        # The ticket and the submit are one step: an inverted executor order
        # could park every worker on later tickets.
        with self._p2p_submit_lock:
            seq = q.take_ticket()
            gen = self._generation

            def run() -> Any:
                try:
                    q.wait_turn(seq, self._timeout)
                except Exception as e:  # noqa: BLE001 - poison, never skip a slot
                    q.poison_with(e)
                    raise
                used: List[_Peer] = []
                try:
                    out = body(used)
                except Exception as e:  # noqa: BLE001 - a partial frame may be on the wire
                    q.poison_with(e)
                    self._sever_peer(peer_rank, gen, used[0] if used else None)
                    raise
                q.done()
                return out

            return self._submit(run, ring=False)

    def send(self, array: Any, dst: int, tag: int = 0) -> Work:
        """Sends ``array`` (a numpy array or a CPU tensor, bf16 included)
        to rank ``dst``: the JAX package's frame, a ``<I`` meta length, the
        pickled (dtype, shape), the raw bytes."""
        if isinstance(array, torch.Tensor) and array.dtype == torch.bfloat16:
            if array.device.type != "cpu":
                return Work(failed_future(ValueError(
                    f"send takes host buffers, got a tensor on {array.device}")))
            arr: np.ndarray = array.detach().contiguous().view(torch.int16).numpy()
            dtype: Any = "bfloat16"
        else:
            try:
                arr, _kind = _host_array(array)
            except ValueError as e:
                return Work(failed_future(e))
            dtype = arr.dtype
        q = self._fifo_queue(("send", dst, tag))

        def body(used: List[_Peer]) -> None:
            peer = self._dial_p2p(dst)
            used.append(peer)
            meta = pickle.dumps((dtype, arr.shape))
            peer.send_msg(_P2P_TAG_BASE + tag,
                          [_P2P_META.pack(len(meta)), meta, memoryview(_as_u8(arr))])

        return self._p2p_op(q, dst, body)

    def recv(self, shape: tuple, dtype: Any, src: int, tag: int = 0) -> Work:
        """Receives one ``send`` from rank ``src``; the frame's own dtype and
        shape win.  A torch ``dtype`` (or a bf16 frame) resolves to a
        tensor, else a numpy array."""
        q = self._fifo_queue(("recv", src, tag))
        as_torch = isinstance(dtype, torch.dtype)

        def body(used: List[_Peer]) -> Any:
            peer = self._dial_p2p(src)
            used.append(peer)
            raw = peer.recv_msg(_P2P_TAG_BASE + tag)
            (mlen,) = _P2P_META.unpack_from(raw, 0)
            rdtype, rshape = _frame_loads(raw[_P2P_META.size:_P2P_META.size + mlen])
            data = np.frombuffer(raw, dtype=np.uint8, offset=_P2P_META.size + mlen)
            if isinstance(rdtype, _Bf16Dtype) or (isinstance(rdtype, str)
                                                  and rdtype == "bfloat16"):
                return torch.from_numpy(data.view(np.int16).reshape(rshape)).view(torch.bfloat16)
            out = data.view(rdtype).reshape(rshape)
            return torch.from_numpy(out) if as_torch else out

        return self._p2p_op(q, src, body)


class _Wire:
    """One allreduce's hop encoding: a codec (``"int8"``/``"int4"``), the
    bf16 wire (float32 sums), bf16 sums of raw bf16 frames (a bf16 payload
    off the bf16 wire), or raw bytes in the payload's dtype."""

    def __init__(self, codec: Optional[str], bf16_wire: bool, bf16_acc: bool) -> None:
        self.codec = codec
        self.bf16_wire = bf16_wire and codec is None
        self.bf16_acc = bf16_acc

    @property
    def encodes(self) -> bool:
        """Whether hops re-encode (so allgather owners encode once)."""
        return self.codec is not None or self.bf16_wire

    def codec_fns(self, dtype: np.dtype, op: str):
        """(encode(chunk) -> bytes-like, decode(raw, n) -> array in the sum
        dtype, combine(acc, incoming) by ``op``) for chunks of ``dtype``."""
        bf16_acc = self.bf16_acc
        reduce_fn = _REDUCE_COMBINE[op]

        def cast(x: np.ndarray) -> np.ndarray:
            # Into the sum dtype: bf16 sums hold bf16 values (as float32).
            return _bf16_round(x) if bf16_acc else x.astype(dtype, copy=False)

        def combine(acc: np.ndarray, incoming: np.ndarray) -> np.ndarray:
            out = reduce_fn(acc, incoming)
            return _bf16_round(out) if bf16_acc else out

        if self.codec is not None:
            qmax = 127 if self.codec == "int8" else 7

            def encode(chunk: np.ndarray) -> memoryview:
                scale, q = _quantize(chunk, qmax)
                body = q if qmax == 127 else pack_int4(q)
                return memoryview(_SCALE.pack(scale) + body.tobytes())

            def decode(raw, n: int) -> np.ndarray:
                (scale,) = _SCALE.unpack_from(raw, 0)
                body = memoryview(raw)[_SCALE.size:]
                q = (np.frombuffer(body, dtype=np.int8) if qmax == 127
                     else unpack_int4(body, n))
                return cast(q.astype(np.float32) * np.float32(scale))

            return encode, decode, combine

        if self.bf16_wire or bf16_acc:
            def encode(chunk: np.ndarray) -> memoryview:
                return memoryview(bf16_encode(chunk).view(np.uint8))

            def decode(raw, n: int) -> np.ndarray:
                return bf16_decode(np.frombuffer(raw, dtype=np.uint16))

            return encode, decode, combine

        def encode(chunk: np.ndarray) -> memoryview:
            return memoryview(np.ascontiguousarray(chunk).reshape(-1).view(np.uint8))

        def decode(raw, n: int) -> np.ndarray:
            return np.frombuffer(raw, dtype=dtype)

        return encode, decode, combine


class ErrorSwallowingCollective(Collective):
    """Latches the first error and turns the later ops into immediate
    no-ops, resolving to each op's fallback (the inputs; zeros for a
    recv), until the next ``configure``."""

    def __init__(self, inner: Collective) -> None:
        self._inner = inner
        self._error: Optional[Exception] = None

    def configure(self, store_addr: str, rank: int, world_size: int) -> None:
        self._error = None
        self._inner.configure(store_addr, rank, world_size)

    # The wire probes pass through: the layers above (the averager's
    # device wire prep, the semisync codec gate, the Manager's wire-byte
    # accounting) find the wire by getattr, and a wrapper hiding it would
    # change the wire they pick.

    @property
    def wire_codecs(self):
        return getattr(self._inner, "wire_codecs", ())

    @property
    def wire_dtype(self):
        return getattr(self._inner, "wire_dtype", None)

    def wire_nbytes(self, array: Any, allow_wire_compression: bool = True,
                    wire_codec: Optional[str] = None) -> int:
        probe = getattr(self._inner, "wire_nbytes", None)
        if callable(probe):
            if wire_codec is not None:
                return probe(array, allow_wire_compression, wire_codec)
            return probe(array, allow_wire_compression)
        return _nbytes(array)

    def errored(self) -> Optional[Exception]:
        return self._error or self._inner.errored()

    def report_error(self, exc: Exception) -> None:
        if self._error is None:
            self._error = exc

    def _guard(self, fn: Callable[[], Work], fallback: Any) -> Work:
        if self.errored() is not None:
            return Work(completed_future(fallback))
        work = fn()
        out: Future = Future()

        def settle(f: Future) -> None:
            exc = f.exception()
            if exc is not None:
                self.report_error(exc)
                out.set_result(fallback)
            else:
                out.set_result(f.result())

        work.add_done_callback(settle)
        return Work(out)

    def allreduce(self, arrays: Sequence[Any], op: str = "sum",
                  allow_wire_compression: bool = True, donate: bool = False,
                  wire_codec: Optional[str] = None) -> Work:
        # Optional arguments pass on only when set, so an inner collective
        # with the bare signature keeps working.
        extra: Dict[str, Any] = {}
        if wire_codec is not None:
            extra["wire_codec"] = wire_codec
        if donate:
            extra["donate"] = True
        return self._guard(lambda: self._inner.allreduce(arrays, op, allow_wire_compression,
                                                         **extra), list(arrays))

    def allgather(self, array: Any) -> Work:
        return self._guard(lambda: self._inner.allgather(array), [array])

    def broadcast(self, array: Any, root: int = 0) -> Work:
        return self._guard(lambda: self._inner.broadcast(array, root), array)

    def reduce_scatter(self, arrays: Sequence[Any], op: str = "sum") -> Work:
        return self._guard(lambda: self._inner.reduce_scatter(arrays, op), arrays[0])

    def alltoall(self, arrays: Sequence[Any]) -> Work:
        return self._guard(lambda: self._inner.alltoall(arrays), list(arrays))

    def send(self, array: Any, dst: int, tag: int = 0) -> Work:
        return self._guard(lambda: self._inner.send(array, dst, tag), None)

    def recv(self, shape: tuple, dtype: Any, src: int, tag: int = 0) -> Work:
        return self._guard(lambda: self._inner.recv(shape, dtype, src, tag), _zeros(shape, dtype))

    def barrier(self) -> Work:
        return self._guard(lambda: self._inner.barrier(), None)

    def size(self) -> int:
        return self._inner.size()

    def rank(self) -> int:
        return self._inner.rank()

    def abort(self) -> None:
        self._inner.abort()


class ManagedCollective(Collective):
    """A collective facade bound to a Manager: ops wait for the quorum,
    ``size`` is the participant count, and ``allreduce`` is the Manager's
    fault-tolerant average."""

    def __init__(self, manager: Any) -> None:
        self._manager = manager

    def configure(self, store_addr: str, rank: int, world_size: int) -> None:
        self._manager.collective().configure(store_addr, rank, world_size)

    def allreduce(self, arrays: Sequence[Any], op: str = "sum",
                  allow_wire_compression: bool = True, donate: bool = False,
                  wire_codec: Optional[str] = None) -> Work:
        # Manager.allreduce is the participant average; another op must
        # not come back averaged (use manager.collective() for those).
        if op not in ("sum", "avg"):
            return Work(failed_future(ValueError(
                f"ManagedCollective.allreduce implements the participant-averaged gradient "
                f"reduction; op={op!r} is not expressible through it")))
        futs = [self._manager.allreduce(a) for a in arrays]
        out: Future = Future()

        def gather(_f: Future) -> None:
            if all(f.done() for f in futs) and not out.done():
                out.set_result([f.result() for f in futs])

        for f in futs:
            f.add_done_callback(gather)
        return Work(out)

    def allgather(self, array: Any) -> Work:
        self._manager.wait_quorum()
        return self._manager.collective().allgather(array)

    def broadcast(self, array: Any, root: int = 0) -> Work:
        self._manager.wait_quorum()
        return self._manager.collective().broadcast(array, root)

    def reduce_scatter(self, arrays: Sequence[Any], op: str = "sum") -> Work:
        self._manager.wait_quorum()
        return self._manager.collective().reduce_scatter(arrays, op)

    def alltoall(self, arrays: Sequence[Any]) -> Work:
        self._manager.wait_quorum()
        return self._manager.collective().alltoall(arrays)

    def send(self, array: Any, dst: int, tag: int = 0) -> Work:
        self._manager.wait_quorum()
        return self._manager.collective().send(array, dst, tag)

    def recv(self, shape: tuple, dtype: Any, src: int, tag: int = 0) -> Work:
        self._manager.wait_quorum()
        return self._manager.collective().recv(shape, dtype, src, tag)

    def barrier(self) -> Work:
        self._manager.wait_quorum()
        return self._manager.collective().barrier()

    def size(self) -> int:
        return self._manager.num_participants()

    def rank(self) -> int:
        return self._manager.participating_rank() or 0

    def errored(self) -> Optional[Exception]:
        return self._manager.errored()

    def abort(self) -> None:
        self._manager.collective().abort()
