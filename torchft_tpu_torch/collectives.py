"""Reconfigurable host collectives for the fault-tolerant replica dimension.

The counterpart of ``torchft_tpu/collectives.py``.  Gradients cross replica
groups as host buffers over TCP; ``configure(store_addr, rank, world_size)``
tears down the previous ring and rendezvouses a new one on every quorum
change, and operations return ``Work`` futures whose failures are latched
and reported through ``errored()`` instead of raised into the train loop.

This slice carries the Python engine's single-lane flat ring with the raw
wire: the payload is summed in its own dtype.  Wire compatibility with the
JAX package's Python engine is kept byte for byte, so a later slice can run
mixed JAX/torch rings (the JAX side with one lane and the tcp transport):

* the rendezvous keys ``rank_<r>`` (``host:port``) and ``cfg_<r>``
  (``full:<token>``) under the quorum's store prefix, and the 12-byte dial
  preamble ``<III`` (rank, channel, lane);
* every frame is a ``<IQ`` header (tag, payload bytes) and the payload;
* op ``seq`` owns tags ``seq * 520 + {1: reduce-scatter, 2: allgather}``;
* ``np.array_split`` chunk geometry and the ring-step order of the sums.
"""

from __future__ import annotations

import collections
import os
import socket
import struct
import threading
from abc import ABC, abstractmethod
from concurrent.futures import Future, ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np

from torchft_tpu_torch._native import StoreClient
from torchft_tpu_torch.futures import completed_future, failed_future

__all__ = ["Work", "Collective", "DummyCollective", "TCPCollective"]

_HDR = struct.Struct("<IQ")  # tag, nbytes
_PREAMBLE = struct.Struct("<III")  # rank, channel, lane
_CH_RING = 0
# Tag space: seq * _TAGS_PER_OP + stripe * _TAGS_PER_STRIPE + subtag, as in
# the JAX engine (one lane, so the stripe is always 0).
_TAGS_PER_STRIPE = 8
_TAGS_PER_OP = _TAGS_PER_STRIPE * (64 + 1)
_SUB_RS = 1
_SUB_AG = 2

_REDUCE_OPS = ("sum", "avg")


class Work:
    """Handle for an asynchronous collective operation."""

    def __init__(self, future: Future) -> None:
        self._future = future

    def wait(self, timeout: Optional[float] = None):
        return self._future.result(timeout=timeout)

    def future(self) -> Future:
        return self._future


class Collective(ABC):
    """A reconfigurable collective over the replica-group dimension."""

    @abstractmethod
    def configure(self, store_addr: str, rank: int, world_size: int) -> None:
        """(Re)builds the communicator, aborting any previous one.
        ``store_addr`` is ``host:port/prefix``, one prefix per quorum."""

    @abstractmethod
    def allreduce(self, arrays: Sequence[np.ndarray], op: str = "sum") -> Work:
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

    def allreduce(self, arrays: Sequence[np.ndarray], op: str = "sum") -> Work:
        return Work(completed_future([np.array(a, copy=True) for a in arrays]))

    def size(self) -> int:
        return self._world_size

    def rank(self) -> int:
        return self._rank


class _Peer:
    """A framed TCP link to one ring neighbour.  Frames that arrive for a
    tag nobody is waiting on yet are stashed until asked for."""

    def __init__(self, sock: socket.socket) -> None:
        self.sock = sock
        self.send_lock = threading.Lock()
        self.recv_lock = threading.Lock()
        self._stash: dict = collections.defaultdict(collections.deque)

    def send_msg(self, tag: int, payload) -> None:
        with self.send_lock:
            self.sock.sendall(_HDR.pack(tag, len(payload)))
            self.sock.sendall(payload)

    def recv_msg(self, tag: int) -> bytearray:
        with self.recv_lock:
            if self._stash[tag]:
                return self._stash[tag].popleft()
            while True:
                got_tag, nbytes = _HDR.unpack(self.recv_exact(_HDR.size))
                payload = self.recv_exact(nbytes)
                if got_tag == tag:
                    return payload
                self._stash[got_tag].append(payload)

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


class TCPCollective(Collective):
    """Single-lane flat ring over TCP between replica groups.

    Ring allreduce moves 2(n-1)/n of the payload per rank; ops run one at a
    time, in submission order, on a single worker thread, which keeps the
    rings of all ranks aligned (identical program order on every rank).

    ``host``: the address to listen on and advertise; by default every
    interface, advertised under this machine's host name (as the JAX engine
    does).
    """

    RENDEZVOUS_TIMEOUT_S = 60.0

    def __init__(self, timeout: float = 60.0, host: Optional[str] = None) -> None:
        self._timeout = timeout
        self._host = host or ""
        self._lock = threading.Lock()
        self._rank = 0
        self._world_size = 1
        self._next: Optional[_Peer] = None
        self._prev: Optional[_Peer] = None
        self._listener: Optional[socket.socket] = None
        self._executor: Optional[ThreadPoolExecutor] = None
        self._sender: Optional[ThreadPoolExecutor] = None
        self._store: Optional[StoreClient] = None
        self._op_seq = 0
        self._op_error: Optional[Exception] = None

    # -- lifecycle ----------------------------------------------------------

    def configure(self, store_addr: str, rank: int, world_size: int) -> None:
        self.abort()
        with self._lock:
            self._op_error = None
            self._rank = rank
            self._world_size = world_size
            self._op_seq = 0
            if world_size == 1:
                return
            self._store = StoreClient(store_addr)
            self._rendezvous()
            self._executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="tpuft_ring")
            self._sender = ThreadPoolExecutor(max_workers=1, thread_name_prefix="tpuft_send")

    def _rendezvous(self) -> None:
        assert self._store is not None
        listener = _listen(self._host)
        listener.listen(16)
        listener.settimeout(self.RENDEZVOUS_TIMEOUT_S)
        self._listener = listener
        port = listener.getsockname()[1]
        host = self._host or socket.gethostname()
        self._store.set(f"rank_{self._rank}", f"{host}:{port}".encode())
        self._store.set(f"cfg_{self._rank}", f"full:{os.urandom(8).hex()}".encode())

        n = self._world_size
        next_rank, prev_rank = (self._rank + 1) % n, (self._rank - 1) % n
        addr = self._store.get(
            f"rank_{next_rank}", wait=True, timeout_ms=int(self.RENDEZVOUS_TIMEOUT_S * 1000)
        )
        if addr is None:
            raise TimeoutError(f"rendezvous: rank {next_rank} never published its address")
        phost, pport = addr.decode().rsplit(":", 1)
        sock = socket.create_connection((phost, int(pport)), timeout=self.RENDEZVOUS_TIMEOUT_S)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.settimeout(self._timeout)
        sock.sendall(_PREAMBLE.pack(self._rank, _CH_RING, 0))
        self._next = _Peer(sock)

        conn, _ = listener.accept()
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        conn.settimeout(self._timeout)
        prev = _Peer(conn)
        their_rank, channel, lane = _PREAMBLE.unpack(prev.recv_exact(_PREAMBLE.size))
        if (their_rank, channel, lane) != (prev_rank, _CH_RING, 0):
            prev.close()
            raise ConnectionError(
                f"rendezvous: expected ring lane 0 from rank {prev_rank}, got "
                f"rank {their_rank} channel {channel} lane {lane}"
            )
        self._prev = prev

    def abort(self) -> None:
        with self._lock:
            for peer in (self._next, self._prev):
                if peer is not None:
                    peer.close()
            self._next = self._prev = None
            if self._listener is not None:
                self._listener.close()
                self._listener = None
            for pool in (self._executor, self._sender):
                if pool is not None:
                    pool.shutdown(wait=False, cancel_futures=True)
            self._executor = self._sender = None
            if self._store is not None:
                self._store.close()
                self._store = None

    def errored(self) -> Optional[Exception]:
        with self._lock:
            return self._op_error

    def size(self) -> int:
        return self._world_size

    def rank(self) -> int:
        return self._rank

    # -- ops ----------------------------------------------------------------

    def allreduce(self, arrays: Sequence[np.ndarray], op: str = "sum") -> Work:
        if op not in _REDUCE_OPS:
            return Work(failed_future(ValueError(
                f"unsupported reduce op {op!r}; expected one of {_REDUCE_OPS}"
            )))
        arrays = [np.ascontiguousarray(a) for a in arrays]
        if self._world_size == 1:
            return Work(completed_future(list(arrays)))
        with self._lock:
            executor = self._executor
            seq = self._op_seq
            self._op_seq += 1
        if executor is None:
            return Work(failed_future(self._op_error or RuntimeError("collective not configured")))

        def run() -> List[np.ndarray]:
            try:
                return self._ring_allreduce(arrays, op, seq)
            except Exception as e:  # noqa: BLE001 - latched, then delivered
                with self._lock:
                    if self._op_error is None:
                        self._op_error = e
                raise

        return Work(executor.submit(run))

    def _exchange(self, tag: int, payload: memoryview) -> bytearray:
        """Sends to the next rank while receiving from the previous one
        (full duplex: a blocking send-then-recv deadlocks the ring once
        payloads outgrow the socket buffers)."""
        nxt, prv, sender = self._next, self._prev, self._sender
        if nxt is None or prv is None or sender is None:
            raise RuntimeError("collective aborted")
        sent = sender.submit(nxt.send_msg, tag, payload)
        received = prv.recv_msg(tag)
        sent.result(timeout=self._timeout)
        return received

    def _ring_allreduce(self, arrays: List[np.ndarray], op: str, seq: int) -> List[np.ndarray]:
        n, rank = self._world_size, self._rank
        flat = (
            np.concatenate([a.reshape(-1) for a in arrays])
            if len(arrays) > 1 else arrays[0].reshape(-1)
        )
        dtype = flat.dtype
        chunks = list(np.array_split(flat, n))
        tag_base = (seq * _TAGS_PER_OP) & 0x7FFFFFFF
        # Reduce-scatter: after n-1 steps chunk (rank+1) % n is fully summed.
        for step in range(n - 1):
            send_idx, recv_idx = (rank - step) % n, (rank - step - 1) % n
            raw = self._exchange(tag_base + _SUB_RS, memoryview(chunks[send_idx]).cast("B"))
            chunks[recv_idx] = chunks[recv_idx] + np.frombuffer(raw, dtype=dtype)
        # Allgather: the owned chunks circulate until every rank has all n.
        for step in range(n - 1):
            send_idx, recv_idx = (rank - step + 1) % n, (rank - step) % n
            raw = self._exchange(tag_base + _SUB_AG, memoryview(chunks[send_idx]).cast("B"))
            chunks[recv_idx] = np.frombuffer(raw, dtype=dtype)
        out = np.concatenate(chunks)
        if op == "avg":
            out = out / n
        result, pos = [], 0
        for a in arrays:
            result.append(out[pos:pos + a.size].reshape(a.shape).astype(a.dtype, copy=False))
            pos += a.size
        return result
