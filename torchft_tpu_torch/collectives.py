"""Reconfigurable host collectives for the fault-tolerant replica dimension.

The counterpart of ``torchft_tpu/collectives.py``.  Gradients cross replica
groups as host buffers over TCP; ``configure(store_addr, rank, world_size)``
tears down the previous ring and rendezvouses a new one on every quorum
change, and operations return ``Work`` futures whose failures are latched
and reported through ``errored()`` instead of raised into the train loop.

:class:`TCPCollective` is the JAX package's striped multi-lane flat ring:
``lanes`` sockets to each ring neighbour, each allreduce cut into chunk
stripes that run as independent tagged rings on the lanes, and the hot
loop either in Python threads (``engine="py"``) or in the native GIL-free
engine of the port's own ``libtpuft.so`` (``engine="native"``,
:class:`~torchft_tpu_torch._native.RingEngine`).  The wire stays the JAX
package's byte for byte, so one ring can hold JAX and port ranks on either
engine:

* the rendezvous keys ``rank_<r>`` (``host:port``) and ``cfg_<r>``
  (``full:<token>``) under the quorum's store prefix, and the 12-byte dial
  preamble ``<III`` (rank, channel, lane), one connection per lane;
* every frame is a ``<IQ`` header (tag, payload bytes) and the payload;
* op ``seq``'s stripe ``s`` owns tags ``seq * 520 + s * 8 + {1: reduce-
  scatter, 2: allgather}``; stripe counts, ``np.array_split`` chunk and
  stripe geometry (carved from the caller's flat payload) and the ring-step
  order of the sums are the reference's;
* the f32 wire sends the payload's bytes; the bf16 wire rounds each hop's
  chunk to bfloat16 (nearest even) and accumulates in float32, and each
  allgather owner encodes its chunk once, so every rank decodes the same
  bits.

Both engines record every hop into the JAX package's data-plane flight
recorder: per-tier stall aggregates, and a sampled, bounded timeline of
records with exactly :data:`HOP_RECORD_FIELDS` (``TPUFT_HOP_SAMPLE``,
default 1; ``TPUFT_HOP_RING``, default 2048).  :meth:`TCPCollective.lane_stats`
reads the current configuration's counters (they restart at every
``configure``) and :meth:`TCPCollective.lane_totals` the monotonic totals
across reconfigures.

Not ported yet: the 2-D topology, shm lanes, the int8/int4 codecs, link
shaping, incremental reconfiguration, and the ops other than allreduce.
"""

from __future__ import annotations

import collections
import logging
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
           "HOP_RECORD_FIELDS", "bf16_encode", "bf16_decode"]

logger = logging.getLogger("torchft_tpu_torch.collectives")

_HDR = struct.Struct("<IQ")  # tag, nbytes
_PREAMBLE = struct.Struct("<III")  # rank, channel, lane
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

_native_fallback_warned = False


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
                  allow_wire_compression: bool = True, donate: bool = False) -> Work:
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

    def __init__(self, rank: int = 0, world_size: int = 1) -> None:
        self._rank = rank
        self._world_size = world_size

    def configure(self, store_addr: str, rank: int, world_size: int) -> None:
        self._rank = rank
        self._world_size = world_size

    def allreduce(self, arrays: Sequence[Any], op: str = "sum",
                  allow_wire_compression: bool = True, donate: bool = False) -> Work:
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
    types.  Inputs are numpy arrays or CPU torch tensors; a bf16 tensor is
    carried as float32 (exact) and rides the bf16 wire only."""

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
        # Counters of every closed configuration, banked at abort, so
        # lane_totals never goes backwards across a reconfigure.
        self._lifetime: Dict[str, Any] = {}
        self.last_configure: Dict[str, Any] = {}

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

    def wire_nbytes(self, array: Any, allow_wire_compression: bool = True) -> int:
        """Bytes ``array`` occupies per hop on the ring's wire."""
        if isinstance(array, torch.Tensor):
            size, itemsize = array.numel(), array.element_size()
            floating = array.is_floating_point()
        else:
            array = np.asarray(array)
            size, itemsize = array.size, array.itemsize
            floating = np.issubdtype(array.dtype, np.floating)
        if floating and allow_wire_compression and self._wire_dtype == "bf16":
            return 2 * size
        return size * itemsize

    # -- lifecycle ------------------------------------------------------------

    def configure(self, store_addr: str, rank: int, world_size: int) -> None:
        t0 = time.monotonic()
        self.abort()
        with self._lock:
            self._op_error = None
            self._rank = rank
            self._world_size = world_size
            self._op_seq = 0
            # How the configure went, in the JAX package's record (the port
            # always rendezvouses in full); the Manager's reconfigure event
            # reads it.
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
        self._store.set(f"rank_{self._rank}", f"{host}:{port}".encode())
        self._store.set(f"cfg_{self._rank}", f"full:{os.urandom(8).hex()}".encode())

        n = self._world_size
        next_rank, prev_rank = (self._rank + 1) % n, (self._rank - 1) % n
        timeout_ms = int(self.RENDEZVOUS_TIMEOUT_S * 1000)
        addr = self._store.get(f"rank_{next_rank}", wait=True, timeout_ms=timeout_ms)
        if addr is None:
            raise TimeoutError(f"rendezvous: rank {next_rank} never published its address")
        # A dial completes in the listener's backlog, so every rank dials
        # all its lanes before accepting any.
        self._next_lanes = [self._dial(addr, lane) for lane in range(lanes)]

        # Lanes from prev arrive in any order, keyed by their preamble.
        expected = {(prev_rank, _CH_RING, lane) for lane in range(lanes)}
        accepted: Dict[Tuple[int, int, int], _Peer] = {}
        deadline = time.monotonic() + self.RENDEZVOUS_TIMEOUT_S
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
            key = _PREAMBLE.unpack(peer.recv_exact(_PREAMBLE.size))
            if key not in expected or key in accepted:
                peer.close()
                raise ConnectionError(f"rendezvous: unexpected connection (rank, channel, lane) "
                                      f"{key}; expected {sorted(expected)}")
            accepted[key] = peer
        self._prev_lanes = [accepted[(prev_rank, _CH_RING, lane)] for lane in range(lanes)]

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
                  allow_wire_compression: bool = True, donate: bool = False) -> Work:
        """Sum (or average) of ``arrays`` (numpy arrays or CPU tensors)
        across ranks; the Work resolves to the reduced arrays, of the
        inputs' types, dtypes and shapes.

        ``allow_wire_compression=False`` keeps this call on full width under
        the bf16 wire.  ``donate=True`` hands the buffers to the op: the
        native engine then reduces in place over them, so the results may
        alias the inputs (the Python engine never mutates its inputs)."""
        if op not in _REDUCE_OPS:
            return Work(failed_future(ValueError(
                f"unsupported reduce op {op!r}; expected one of {_REDUCE_OPS}"
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
        if payload.bf16 and not (allow_wire_compression and self._wire_dtype == "bf16"):
            return Work(failed_future(ValueError(
                "allreduce: bf16 tensors ride the bf16 wire only (wire_dtype='bf16', "
                "allow_wire_compression=True)"
            )))
        with self._lock:
            seq = self._op_seq
            self._op_seq += 1
        if self._lanes > 1:
            return self._striped_allreduce(payload, op, allow_wire_compression, seq, donate)
        return self._submit(
            lambda: self._ring_allreduce(payload, op, allow_wire_compression, seq, donate)
        )

    def _tag_base(self, seq: int, stripe: int = 0) -> int:
        return (seq * _TAGS_PER_OP + stripe * _TAGS_PER_STRIPE) & 0x7FFFFFFF

    def _wire_for(self, payload: _Payload, allow_wire_compression: bool) -> bool:
        """Whether this op rides the bf16 wire: compression allowed and
        configured, and every input floating (an integer array in the call
        must not be rounded)."""
        if not (allow_wire_compression and self._wire_dtype == "bf16"):
            return False
        return payload.bf16 or all(np.issubdtype(a.dtype, np.floating) for a in payload.arrays)

    def _native_wire_mode(self, flat: np.ndarray, bf16_wire: bool) -> Optional[int]:
        """The native engine's wire mode for this op, or None where the
        Python hops run it (no engine, or an accumulation dtype other than
        float32)."""
        if self._engine is None or flat.dtype != np.float32:
            return None
        return _native.RingEngine.WIRE_BF16 if bf16_wire else _native.RingEngine.WIRE_RAW

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

    def _ring_allreduce(self, payload: _Payload, op: str, allow_wire_compression: bool,
                        seq: int, donate: bool) -> List[Any]:
        """The lanes == 1 path: one whole-chunk ring pass on lane 0."""
        n = self._world_size
        flat = payload.flat()
        bf16_wire = self._wire_for(payload, allow_wire_compression)
        mode = self._native_wire_mode(flat, bf16_wire)
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
        chunks = self._ring_rs_ag(np.array_split(flat, n), bf16_wire, 0, self._tag_base(seq))
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

    def _striped_allreduce(self, payload: _Payload, op: str, allow_wire_compression: bool,
                           seq: int, donate: bool) -> Work:
        n = self._world_size
        try:
            flat = payload.flat()
            bf16_wire = self._wire_for(payload, allow_wire_compression)
            # From the caller's payload, not the working copy: every engine,
            # in either package, carves the same stripes.
            max_chunk = -(-flat.size // n) * payload.itemsize()
            nstripes = self._stripe_count(max_chunk)
            mode = self._native_wire_mode(flat, bf16_wire)
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
            return self._ring_rs_ag([sub[i][s] for i in range(n)], bf16_wire, s % self._lanes,
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

    def _ring_rs_ag(self, chunks: List[np.ndarray], bf16_wire: bool, lane: int,
                    tag_base: int) -> List[np.ndarray]:
        """One ring pass (reduce-scatter, then allgather) over one array per
        rank slot, in the JAX engine's hop order.  On the bf16 wire each
        reduce-scatter hop rounds the chunk it sends and the sum stays in
        float32; in the allgather each owner encodes its chunk once and the
        others forward those bytes, so every rank decodes the same bits."""
        n, rank = self._world_size, self._rank
        chunks = list(chunks)
        dtype = chunks[0].dtype

        def encode(chunk: np.ndarray) -> memoryview:
            raw = bf16_encode(chunk) if bf16_wire else np.ascontiguousarray(chunk)
            return memoryview(raw.reshape(-1).view(np.uint8))

        def decode(raw) -> np.ndarray:
            if bf16_wire:
                return bf16_decode(np.frombuffer(raw, dtype=np.uint16))
            return np.frombuffer(raw, dtype=dtype)

        # Reduce-scatter: after n-1 steps chunk (rank+1) % n is fully summed.
        for step in range(n - 1):
            send_idx, recv_idx = (rank - step) % n, (rank - step - 1) % n
            hop: dict = {}
            raw = self._exchange(tag_base + _SUB_RS, encode(chunks[send_idx]), lane, hop)
            t_comb = time.monotonic()
            chunks[recv_idx] = np.add(chunks[recv_idx], decode(raw))
            self._record_hop(lane, tag_base + _SUB_RS, hop, time.monotonic() - t_comb)
        # Allgather: the owned chunks circulate until every rank has all n.
        tag = tag_base + _SUB_AG
        if bf16_wire:
            own = (rank + 1) % n
            raws: List[Any] = [None] * n
            raws[own] = bytes(encode(chunks[own]))
            for step in range(n - 1):
                send_idx, recv_idx = (rank - step + 1) % n, (rank - step) % n
                hop = {}
                raws[recv_idx] = self._exchange(tag, memoryview(raws[send_idx]), lane, hop)
                self._record_hop(lane, tag, hop)
            return [decode(r) for r in raws]
        for step in range(n - 1):
            send_idx, recv_idx = (rank - step + 1) % n, (rank - step) % n
            hop = {}
            chunks[recv_idx] = decode(self._exchange(tag, encode(chunks[send_idx]), lane, hop))
            self._record_hop(lane, tag, hop)
        return chunks
