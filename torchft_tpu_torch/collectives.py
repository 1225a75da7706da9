"""Reconfigurable host collectives for the fault-tolerant replica dimension.

The counterpart of ``torchft_tpu/collectives.py``.  Gradients cross replica
groups as host buffers over TCP; ``configure(store_addr, rank, world_size)``
tears down the previous ring and rendezvouses a new one on every quorum
change, and operations return ``Work`` futures whose failures are latched
and reported through ``errored()`` instead of raised into the train loop.
A quorum change that keeps a ring edge (the same neighbour process on the
same side) reuses that edge's lane sockets instead (below).

:class:`TCPCollective` is the JAX package's striped multi-lane flat ring:
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
  connection per lane;
* incremental reconfiguration (``TPUFT_INCREMENTAL_RECONF``, on by
  default): the listener and its token outlive a configure, and a rank
  whose previous ring is live publishes ``inc:<token>``; an edge is reused
  when the neighbour's (address, token) is the one recorded at the
  previous configure and its mode is ``inc``, and only the other edges are
  dialled and accepted (``last_configure``: ``mode``, ``reused_lanes``,
  ``opened_lanes``, ``configure_s``); a port rank also publishes
  ``nbrs_<r>`` (its previous neighbours) and reuses an edge to another
  port rank only when both ends recorded each other;
* every frame is a ``<IQ`` header (tag, payload bytes) and the payload;
* op ``seq``'s stripe ``s`` owns tags ``seq * 520 + s * 8 + {1: reduce-
  scatter, 2: allgather}``; stripe counts, ``np.array_split`` chunk and
  stripe geometry (carved from the caller's flat payload) and the ring-step
  order of the sums are the reference's;
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
  the JAX engine.

Both engines record every hop into the JAX package's data-plane flight
recorder: per-tier stall aggregates, and a sampled, bounded timeline of
records with exactly :data:`HOP_RECORD_FIELDS` (``TPUFT_HOP_SAMPLE``,
default 1; ``TPUFT_HOP_RING``, default 2048).  :meth:`TCPCollective.lane_stats`
reads the current configuration's counters (they restart at every
``configure``) and :meth:`TCPCollective.lane_totals` the monotonic totals
across reconfigures.

Not ported yet: the 2-D topology, shm lanes, link shaping, and the ops
other than allreduce.
"""

from __future__ import annotations

import collections
import json
import logging
import math
import os
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
from torchft_tpu_torch._native import StoreClient
from torchft_tpu_torch.futures import completed_future, failed_future

__all__ = ["Work", "Collective", "DummyCollective", "TCPCollective", "HopRecorder",
           "HOP_RECORD_FIELDS", "WIRE_CODECS", "bf16_encode", "bf16_decode", "quantize_int8",
           "quantize_int4", "pack_int4", "unpack_int4"]

logger = logging.getLogger("torchft_tpu_torch.collectives")

_HDR = struct.Struct("<IQ")  # tag, nbytes
_PREAMBLE = struct.Struct("<III")  # rank, channel, lane
_SCALE = struct.Struct("<f")  # the int8 / int4 frames' per-chunk scale
_CH_RING = 0
# Tag space: seq * _TAGS_PER_OP + stripe * _TAGS_PER_STRIPE + subtag, the
# JAX engine's layout (its 2-D tiers' subtags 3-5 stay unused here).
_MAX_STRIPES = 64
_TAGS_PER_STRIPE = 8
_TAGS_PER_OP = _TAGS_PER_STRIPE * (_MAX_STRIPES + 1)
_SUB_RS = 1
_SUB_AG = 2

_REDUCE_OPS = ("sum", "avg")

TPUFT_RING_LANES_ENV = "TPUFT_RING_LANES"
TPUFT_RING_ENGINE_ENV = "TPUFT_RING_ENGINE"
_MAX_LANES = 8
_RING_ENGINES = ("auto", "py", "native")
_WIRE_DTYPES = ("auto", "f32", "bf16")

# Incremental reconfiguration: "0" (or false/off/no) takes the full
# rendezvous at every quorum change.
TPUFT_INCREMENTAL_RECONF_ENV = "TPUFT_INCREMENTAL_RECONF"

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
# wall-clock seconds at the hop's start; tier 0 (the flat ring); send_s =
# blocked joining the lane's sender; recv_s = blocked on the matching
# inbound frame; comb_s = decode + sum of the received chunk (0 on
# allgather forwards); nbytes = payload bytes sent.
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


class Work:
    """Handle for an asynchronous collective operation."""

    def __init__(self, future: Future) -> None:
        self._future = future

    def wait(self, timeout: Optional[float] = None):
        return self._future.result(timeout=timeout)

    def exception(self, timeout: Optional[float] = None):
        return self._future.exception(timeout=timeout)

    def future(self) -> Future:
        return self._future


class Collective(ABC):
    """A reconfigurable collective over the replica-group dimension."""

    @abstractmethod
    def configure(self, store_addr: str, rank: int, world_size: int) -> None:
        """(Re)builds the communicator, aborting any previous one.
        ``store_addr`` is ``host:port/prefix``, one prefix per quorum."""

    @abstractmethod
    def allreduce(self, arrays: Sequence[Any], op: str = "sum",
                  allow_wire_compression: bool = True, donate: bool = False,
                  wire_codec: Optional[str] = None) -> Work:
        """Elementwise sum (or average) across ranks; the Work resolves to
        the list of reduced arrays."""

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

    def configure(self, store_addr: str, rank: int, world_size: int) -> None:
        self._rank = rank
        self._world_size = world_size

    def allreduce(self, arrays: Sequence[Any], op: str = "sum",
                  allow_wire_compression: bool = True, donate: bool = False,
                  wire_codec: Optional[str] = None) -> Work:
        return Work(completed_future([
            a.clone() if isinstance(a, torch.Tensor) else np.array(a, copy=True) for a in arrays
        ]))

    def size(self) -> int:
        return self._world_size

    def rank(self) -> int:
        return self._rank


class _Peer:
    """A framed TCP link to one ring neighbour on one lane.

    Several stripes share a lane, so frames arrive out of order and are
    demultiplexed by tag.  The demux is leader/follower, as the JAX
    engine's: one caller at a time reads the socket, but it publishes every
    frame for another tag to the stash under the condition and notifies,
    so a caller whose frame already landed takes it at once instead of
    queueing behind the reader (holding one lock across the read can
    deadlock two ring directions)."""

    def __init__(self, sock: socket.socket) -> None:
        self.sock = sock
        self.send_lock = threading.Lock()
        self.recv_cond = threading.Condition()
        self._reading = False
        self._stash: Dict[int, List[bytearray]] = {}
        # Frame bytes (headers included) the Python engine moved.
        self.bytes_out = 0
        self.bytes_in = 0

    def send_msg(self, tag: int, payload) -> None:
        with self.send_lock:
            self.sock.sendall(_HDR.pack(tag, len(payload)))
            self.sock.sendall(payload)
            self.bytes_out += _HDR.size + len(payload)

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
        got = 0
        while got < n:
            r = self.sock.recv_into(view[got:], n - got)
            if r == 0:
                raise ConnectionError("peer connection closed")
            got += r
        return buf

    def close(self) -> None:
        # shutdown first: it wakes a thread blocked in recv on this socket.
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()


def _listen(host: str) -> socket.socket:
    if host:
        return socket.create_server((host, 0))
    try:
        return socket.create_server(("", 0), family=socket.AF_INET6, dualstack_ipv6=True)
    except OSError:  # no IPv6 on this host
        return socket.create_server(("", 0))


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
        """Bytes per element of the caller's payload (stripe geometry is
        carved from these, as the JAX engine carves from its inputs)."""
        return 2 if self.bf16 else self.arrays[0].dtype.itemsize

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
    """Striped multi-lane flat ring over TCP between replica groups.

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
    ) -> None:
        if wire_dtype not in _WIRE_DTYPES:
            raise ValueError(f"unsupported wire_dtype {wire_dtype!r}; expected one of "
                             f"{_WIRE_DTYPES}")
        if wire_dtype == "auto":
            wire_dtype = ("bf16" if os.environ.get("TPUFT_LINK_PROFILE") == "dcn"
                          or os.environ.get("TPUFT_SHAPED_LINK") else "f32")
        engine = engine if engine is not None else _ring_engine_from_env()
        if engine not in _RING_ENGINES:
            raise ValueError(f"unsupported engine {engine!r}; expected one of {_RING_ENGINES}")
        self._timeout = timeout
        self._chunk_bytes = chunk_bytes
        self._wire_dtype = wire_dtype
        self._lanes = max(1, min(_MAX_LANES, lanes if lanes is not None
                                 else _ring_lanes_from_env()))
        self._engine_mode = engine
        self._engine: Optional[_native.RingEngine] = None
        self._host = host or ""
        self._lock = threading.Lock()
        self._rank = 0
        self._world_size = 1
        self._generation = 0
        self._next_lanes: List[_Peer] = []  # to (rank + 1) % n, one per lane
        self._prev_lanes: List[_Peer] = []  # from (rank - 1) % n, one per lane
        self._listener: Optional[socket.socket] = None
        self._store: Optional[StoreClient] = None
        # Unstriped (lanes == 1) ops run one at a time in submission order.
        self._ring_executor: Optional[ThreadPoolExecutor] = None
        # Striped ops: two workers a lane, so a stripe waiting on the wire
        # does not hold the next op's stripes off it.
        self._lane_executor: Optional[ThreadPoolExecutor] = None
        # One single-worker sender per lane: hops send full duplex.
        self._send_pools: List[ThreadPoolExecutor] = []
        # Allocated on the caller's thread: the same program order on every
        # rank yields the same tags.
        self._op_seq = 0
        self._op_error: Optional[Exception] = None
        self._inflight: set = set()
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
    def lanes(self) -> int:
        return self._lanes

    @property
    def wire_dtype(self) -> str:
        """The resolved wire encoding, ``"f32"`` or ``"bf16"``."""
        return self._wire_dtype

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
            self._ring_executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="tpuft_ring")
            self._send_pools = [
                ThreadPoolExecutor(max_workers=1, thread_name_prefix=f"tpuft_send{lane}")
                for lane in range(self._lanes)
            ]
            if self._lanes > 1:
                self._lane_executor = ThreadPoolExecutor(
                    max_workers=2 * self._lanes, thread_name_prefix="tpuft_lane"
                )
            self.last_configure = {
                "mode": "full", "reused_lanes": 0,
                "opened_lanes": len(self._next_lanes) + len(self._prev_lanes),
                "configure_s": time.monotonic() - t0,
            }

    def _configure_incremental(self, store_addr: str, rank: int, world_size: int,
                               t0: float) -> bool:
        """The quorum change's fast path, the JAX package's protocol: when
        this rank's previous ring is live, keep the listener and the lane
        sockets of every edge whose neighbour survives, and open only the
        changed edges.  Returns False (the caller then takes the full path,
        whose abort reclaims whatever this attempt left) when a
        precondition fails or any step slips.

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
        follows the JAX package's rule on both ends)."""
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
        # A live ring on both sides of the change, a kept listener, no
        # latched error and nothing in flight (the Manager reconfigures at
        # a step boundary).
        if (self._listener is None or self._self_addr is None or not self._neighbor_ids
                or self._world_size <= 1 or world_size <= 1 or self._op_error is not None
                or self._inflight or not self._next_lanes or not self._prev_lanes
                or self._ring_executor is None):
            return False
        old_next_id = self._neighbor_ids.get("next")
        old_prev_id = self._neighbor_ids.get("prev")
        if old_next_id is None or old_prev_id is None:
            return False
        store = StoreClient(store_addr)
        old_store, self._store = self._store, store
        if old_store is not None:
            old_store.close()
        # Before publishing: drop dials that reached the kept listener and
        # were never taken (a fresh neighbour dials the moment it reads our
        # key, so its lanes must land after this sweep), and bump the
        # generation, as abort() does.
        self._generation += 1
        self._purge_backlog()
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
        for reused, peers in ((reuse_next, self._next_lanes), (reuse_prev, self._prev_lanes)):
            for p in peers:
                if reused:
                    p.bytes_out = p.bytes_in = 0
                else:
                    p.close()
        self._op_error = None
        self._rank = rank
        self._world_size = world_size
        self._op_seq = 0
        lanes = self._lanes
        opened = 0
        if not reuse_next:
            addr = store.get(f"rank_{next_rank}", wait=True, timeout_ms=ident_ms)
            if addr is None:
                raise TimeoutError(f"rendezvous: rank {next_rank} never published its address")
            self._next_lanes = [self._dial(addr, lane) for lane in range(lanes)]
            opened += lanes
        if not reuse_prev:
            self._prev_lanes = self._accept_lanes(self._listener, prev_rank, strict=False)
            opened += lanes
        self._engine = self._create_engine()
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

    def _purge_backlog(self) -> None:
        """Closes every connection waiting in the kept listener's backlog."""
        listener = self._listener
        assert listener is not None
        listener.settimeout(0.0)
        try:
            while True:
                try:
                    conn, _ = listener.accept()
                except (BlockingIOError, socket.timeout):
                    return
                conn.close()
        finally:
            listener.settimeout(None)

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
        """The native engine over this generation's lane sockets, or None
        for the Python engine."""
        if self._engine_mode == "py":
            return None
        try:
            engine = _native.RingEngine(self._lanes)
            engine.set_tier(_native.RingEngine.TIER_FLAT,
                            [p.sock.fileno() for p in self._next_lanes],
                            [p.sock.fileno() for p in self._prev_lanes])
            engine.set_hop(self._hops.sample, self._hops.cap)
        except Exception as e:  # noqa: BLE001 - "auto" falls back, "native" raises
            if self._engine_mode == "native":
                raise RuntimeError(f"engine='native': the ring engine cannot run: {e}") from e
            _warn_native_fallback(str(e))
            return None
        return engine

    def _dial(self, addr: bytes, lane: int) -> _Peer:
        phost, pport = addr.decode().rsplit(":", 1)
        sock = socket.create_connection((phost, int(pport)), timeout=self.RENDEZVOUS_TIMEOUT_S)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.settimeout(self._timeout)
        sock.sendall(_PREAMBLE.pack(self._rank, _CH_RING, lane))
        return _Peer(sock)

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

        n = self._world_size
        next_rank, prev_rank = (self._rank + 1) % n, (self._rank - 1) % n
        timeout_ms = int(self.RENDEZVOUS_TIMEOUT_S * 1000)
        addr = self._store.get(f"rank_{next_rank}", wait=True, timeout_ms=timeout_ms)
        if addr is None:
            raise TimeoutError(f"rendezvous: rank {next_rank} never published its address")
        # A dial completes in the listener's backlog, so every rank dials
        # all its lanes before accepting any.
        self._next_lanes = [self._dial(addr, lane) for lane in range(lanes)]
        self._prev_lanes = self._accept_lanes(listener, prev_rank, strict=True)
        # Each neighbour's identity, which the next configure compares to
        # decide whether an edge survived; a missing one only forces the
        # full path then.
        self._neighbor_ids = {}
        try:
            nxt, prv = self._peer_identity(next_rank), self._peer_identity(prev_rank)
            if nxt is not None and prv is not None:
                self._neighbor_ids = {"next": nxt[:2], "prev": prv[:2]}
        except Exception:  # noqa: BLE001 - a reuse hint only
            pass

    def _accept_lanes(self, listener: socket.socket, prev_rank: int,
                      strict: bool) -> List[_Peer]:
        """Accepts one connection a lane from ``prev_rank`` (in any order,
        keyed by the preamble).  An unexpected connection raises when
        ``strict`` (a fresh listener) and is dropped otherwise (a kept
        listener may still hear a stale dial)."""
        lanes = self._lanes
        expected = {(prev_rank, _CH_RING, lane) for lane in range(lanes)}
        accepted: Dict[Tuple[int, int, int], _Peer] = {}
        deadline = time.monotonic() + self.RENDEZVOUS_TIMEOUT_S
        try:
            while len(accepted) < lanes:
                listener.settimeout(max(0.01, deadline - time.monotonic()))
                try:
                    conn, _ = listener.accept()
                except socket.timeout:
                    raise TimeoutError(f"rendezvous: ring lanes never connected: "
                                       f"{sorted(expected - set(accepted))}") from None
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                conn.settimeout(self._timeout)
                peer = _Peer(conn)
                try:
                    key = _PREAMBLE.unpack(peer.recv_exact(_PREAMBLE.size))
                except (OSError, ConnectionError):
                    if strict:
                        raise
                    peer.close()
                    continue
                if key not in expected or key in accepted:
                    peer.close()
                    if strict:
                        raise ConnectionError(f"rendezvous: unexpected connection (rank, "
                                              f"channel, lane) {key}; expected "
                                              f"{sorted(expected)}")
                    logger.warning("dropping a stale ring connection %s", key)
                    continue
                accepted[key] = peer
        except BaseException:
            for peer in accepted.values():
                peer.close()
            raise
        finally:
            listener.settimeout(None)
        return [accepted[(prev_rank, _CH_RING, lane)] for lane in range(lanes)]

    def abort(self) -> None:
        with self._lock:
            self._bank_locked()
            self._generation += 1
            engine, self._engine = self._engine, None
            peers = self._next_lanes + self._prev_lanes
            self._next_lanes, self._prev_lanes = [], []
            if self._listener is not None:
                self._listener.close()
                self._listener = None
            # The listener and its token are gone: no edge of this rank can
            # be reused by the next configure.
            self._neighbor_ids = {}
            self._self_addr = None
            pools = [self._ring_executor, self._lane_executor, *self._send_pools]
            self._ring_executor = self._lane_executor = None
            self._send_pools = []
            for pool in pools:
                if pool is not None:
                    pool.shutdown(wait=False, cancel_futures=True)
            if self._store is not None:
                self._store.close()
                self._store = None
            inflight, self._inflight = list(self._inflight), set()
        # The engine first: its close shuts the connections down (blocked
        # native ops on both ends wake at once) and closes every dup'd fd,
        # so none survives into the next quorum; then the Python sockets.
        if engine is not None:
            engine.close()
        for peer in peers:
            peer.close()
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

    def _lane_bytes(self) -> Tuple[List[int], List[int]]:
        """(sent, received) frame bytes per lane of this configuration:
        the Python hops' plus, under the native engine, its own."""
        sent = [p.bytes_out for p in self._next_lanes]
        recv = [p.bytes_in for p in self._prev_lanes]
        engine = self._engine
        if engine is not None and sent:
            flat = _native.RingEngine.TIER_FLAT
            sent = [b + engine.link_bytes(flat, 0, lane) for lane, b in enumerate(sent)]
            recv = [b + engine.link_bytes(flat, 1, lane) for lane, b in enumerate(recv)]
        return sent, recv

    def _hop_stats(self) -> dict:
        """The flat ring's hop aggregates, both engines merged, with the
        JAX package's ``shape_s`` (0: the port shapes no link)."""
        s = self._hops.stats(0)
        engine = self._engine
        if engine is not None:
            ns = engine.hop_stats(_native.RingEngine.TIER_FLAT)
            s = {k: s[k] + ns[k] for k in s}
        s["shape_s"] = 0.0
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
        sent, recv = self._lane_bytes()
        return {"sent_bytes": sum(sent), "recv_bytes": sum(recv),
                "tiers": {"flat": {"sent_bytes": sum(sent), "recv_bytes": sum(recv)}},
                "hops": {"flat": self._hop_stats()}}

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
        tier = bank.setdefault("tiers", {}).setdefault("flat", {"sent_bytes": 0, "recv_bytes": 0})
        for key in ("sent_bytes", "recv_bytes"):
            tier[key] += live["tiers"]["flat"][key]
        hops = bank.setdefault("hops", {}).setdefault("flat", dict.fromkeys(_HOP_TOTAL_KEYS, 0))
        for key in _HOP_TOTAL_KEYS:
            hops[key] += live["hops"]["flat"][key]
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
        ``sent``, ``recv``, ``hops``); they restart at every configure.
        The Manager puts it on ``step_summary`` and the goodput ledger
        splits the step's data-plane waits by its hop deltas."""
        sent, recv = self._lane_bytes()
        return {"lanes": self._lanes, "topology": "ring", "engine": self.ring_engine,
                "sent": sent, "recv": recv, "hops": {"flat": self._hop_stats()}}

    # -- allreduce ------------------------------------------------------------

    def allreduce(self, arrays: Sequence[Any], op: str = "sum",
                  allow_wire_compression: bool = True, donate: bool = False,
                  wire_codec: Optional[str] = None) -> Work:
        """Sum (or average) of ``arrays`` (numpy arrays or CPU tensors)
        across ranks; the Work resolves to the reduced arrays, of the
        inputs' types, dtypes and shapes.

        ``allow_wire_compression=False`` keeps this call on full width under
        the bf16 wire.  ``wire_codec`` (one of :data:`WIRE_CODECS`, floating
        inputs only) frames every hop as int8 or int4 with a per-chunk
        scale, on either wire.  ``donate=True`` hands the buffers to the op:
        the native engine then reduces in place over them, so the results
        may alias the inputs (the Python engine never mutates its inputs)."""
        if op not in _REDUCE_OPS:
            return Work(failed_future(ValueError(
                f"unsupported reduce op {op!r}; expected one of {_REDUCE_OPS}"
            )))
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
        with self._lock:
            seq = self._op_seq
            self._op_seq += 1
        wire = self._wire_for(payload, allow_wire_compression and wire_codec is None, wire_codec)
        if self._lanes > 1:
            return self._striped_allreduce(payload, op, wire, seq, donate)
        return self._submit(lambda: self._ring_allreduce(payload, op, wire, seq, donate))

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
            return {"int8": _native.RingEngine.WIRE_INT8,
                    "int4": _native.RingEngine.WIRE_INT4}[wire.codec]
        return _native.RingEngine.WIRE_BF16 if wire.bf16_wire else _native.RingEngine.WIRE_RAW

    @staticmethod
    def _native_buffer(flat: np.ndarray, payload: _Payload, donate: bool) -> np.ndarray:
        """The float32 buffer a native pass reduces IN PLACE: the caller's
        own when donated (zero-copy), a buffer :meth:`_Payload.flat` just
        made, else a copy (the ring never mutates an input it was lent)."""
        return flat if donate or payload.fresh() else flat.copy()

    def _submit(self, fn: Callable[[], List[Any]]) -> Work:
        with self._lock:
            executor = self._ring_executor
        if executor is None:
            return Work(failed_future(self._op_error or RuntimeError("collective not configured")))

        def run() -> List[Any]:
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

    def _ring_allreduce(self, payload: _Payload, op: str, wire: "_Wire", seq: int,
                        donate: bool) -> List[Any]:
        """The lanes == 1 path: one whole-chunk ring pass on lane 0."""
        n = self._world_size
        flat = payload.flat()
        mode = self._native_wire_mode(flat, wire)
        if mode is not None:
            buf = self._native_buffer(flat, payload, donate)
            views = np.array_split(buf, n)
            engine = self._engine
            if engine is None:
                raise RuntimeError("collective aborted")
            engine.ring_pass(
                _native.RingEngine.TIER_FLAT, 0, n, self._rank, self._tag_base(seq), _SUB_RS,
                _SUB_AG, _native.RingEngine.PASS_FULL, _native.RingEngine.OP_SUM, mode,
                [v.ctypes.data for v in views], [v.size for v in views], self._timeout,
            )
            return self._finish(buf, payload, op)
        chunks = self._ring_rs_ag(np.array_split(flat, n), wire, 0, self._tag_base(seq))
        return self._finish(np.concatenate(chunks), payload, op)

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
                    _native.RingEngine.TIER_FLAT, nstripes, n, self._rank, lanes, tags,
                    _SUB_RS, _SUB_AG, _native.RingEngine.PASS_FULL, _native.RingEngine.OP_SUM,
                    mode, ptrs, elems, self._timeout,
                )

            return self._run_striped(1, native_body, lambda _r: self._finish(buf, payload, op))

        def py_body(s: int) -> List[np.ndarray]:
            return self._ring_rs_ag([sub[i][s] for i in range(n)], wire, s % self._lanes,
                                    self._tag_base(seq, s))

        def assemble(results: List[Any]) -> List[Any]:
            # One concatenate in (chunk, stripe) order.
            segs = [results[s][i] for i in range(n) for s in range(nstripes)]
            return self._finish(np.concatenate(segs), payload, op)

        return self._run_striped(nstripes, py_body, assemble)

    def _run_striped(self, nstripes: int, body: Callable[[int], Any],
                     assemble: Callable[[List[Any]], List[Any]]) -> Work:
        """Runs ``body(s)`` for every stripe on the lane executor and
        resolves the Work with ``assemble(results)``; the first stripe error
        latches, fails the op, and closes this generation's lanes so the
        sibling stripes fail fast instead of waiting out the timeout."""
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
        """Closes generation ``gen``'s lanes (and its engine's dup'd fds) so
        every op blocked on them fails fast; a later generation's fresh
        lanes are left alone."""
        with self._lock:
            if self._generation != gen:
                return
            peers = self._next_lanes + self._prev_lanes
            engine = self._engine
        if engine is not None:
            engine.close()
        for p in peers:
            p.close()

    # -- the Python hops -------------------------------------------------------

    def _exchange(self, tag: int, payload: memoryview, lane: int, hop: dict) -> bytes:
        """Sends to the next rank while receiving from the previous one on
        ``lane`` (full duplex: send-then-receive deadlocks once payloads
        outgrow the socket buffers).  Over the native engine's demux when
        an engine owns the lanes.  Fills ``hop`` with the hop's ``ts``,
        ``recv_s``, ``send_s`` (the further wait for the send after the
        receive) and ``nbytes``; through the engine's exchange, which waits
        for both at once, the whole wait is ``recv_s``, as in the JAX
        package."""
        hop["ts"] = time.time()
        hop["nbytes"] = len(payload)
        engine = self._engine
        if engine is not None:
            t0 = time.monotonic()
            out = engine.exchange(_native.RingEngine.TIER_FLAT, lane, tag, bytes(payload),
                                  self._timeout)
            hop["recv_s"], hop["send_s"] = time.monotonic() - t0, 0.0
            return out
        pools = self._send_pools
        if not pools or not self._next_lanes:
            raise RuntimeError("collective aborted")
        sent = pools[lane].submit(self._next_lanes[lane].send_msg, tag, payload)
        t0 = time.monotonic()
        received = self._prev_lanes[lane].recv_msg(tag)
        t1 = time.monotonic()
        sent.result(timeout=self._timeout)
        hop["recv_s"], hop["send_s"] = t1 - t0, time.monotonic() - t1
        return received

    def _record_hop(self, lane: int, tag: int, hop: dict, comb_s: float = 0.0) -> None:
        self._hops.record(0, lane, tag, hop["send_s"], hop["recv_s"], comb_s, hop["nbytes"],
                          hop["ts"])

    def _ring_rs_ag(self, chunks: List[np.ndarray], wire: "_Wire", lane: int,
                    tag_base: int) -> List[np.ndarray]:
        """One ring pass (reduce-scatter, then allgather) over one array per
        rank slot, in the JAX engine's hop order.  On the bf16 wire each
        reduce-scatter hop rounds the chunk it sends and the sum stays in
        float32; under a codec each hop quantizes the chunk it sends with
        its own scale and sums the decoded values.  On an encoding wire, in
        the allgather each owner encodes its chunk once and the others
        forward those bytes, so every rank decodes the same bits."""
        n, rank = self._world_size, self._rank
        chunks = list(chunks)
        encode, decode, combine = wire.codec_fns(chunks[0].dtype)

        # Reduce-scatter: after n-1 steps chunk (rank+1) % n is fully summed.
        for step in range(n - 1):
            send_idx, recv_idx = (rank - step) % n, (rank - step - 1) % n
            hop: dict = {}
            raw = self._exchange(tag_base + _SUB_RS, encode(chunks[send_idx]), lane, hop)
            t_comb = time.monotonic()
            chunks[recv_idx] = combine(chunks[recv_idx], decode(raw, chunks[recv_idx].size))
            self._record_hop(lane, tag_base + _SUB_RS, hop, time.monotonic() - t_comb)
        # Allgather: the owned chunks circulate until every rank has all n.
        tag = tag_base + _SUB_AG
        if wire.encodes:
            own = (rank + 1) % n
            raws: List[Any] = [None] * n
            raws[own] = bytes(encode(chunks[own]))
            for step in range(n - 1):
                send_idx, recv_idx = (rank - step + 1) % n, (rank - step) % n
                hop = {}
                raws[recv_idx] = self._exchange(tag, memoryview(raws[send_idx]), lane, hop)
                self._record_hop(lane, tag, hop)
            return [decode(r, c.size) for r, c in zip(raws, chunks)]
        for step in range(n - 1):
            send_idx, recv_idx = (rank - step + 1) % n, (rank - step) % n
            hop = {}
            raw = self._exchange(tag, encode(chunks[send_idx]), lane, hop)
            chunks[recv_idx] = decode(raw, chunks[recv_idx].size)
            self._record_hop(lane, tag, hop)
        return chunks


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

    def codec_fns(self, dtype: np.dtype):
        """(encode(chunk) -> bytes-like, decode(raw, n) -> array in the sum
        dtype, combine(acc, incoming)) for chunks of ``dtype``."""
        bf16_acc = self.bf16_acc

        def cast(x: np.ndarray) -> np.ndarray:
            # Into the sum dtype: bf16 sums hold bf16 values (as float32).
            return _bf16_round(x) if bf16_acc else x.astype(dtype, copy=False)

        def combine(acc: np.ndarray, incoming: np.ndarray) -> np.ndarray:
            out = np.add(acc, incoming)
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
