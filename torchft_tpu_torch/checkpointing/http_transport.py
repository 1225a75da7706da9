"""HTTP checkpoint transport: pull-based live weight recovery.

The counterpart of ``torchft_tpu/checkpointing/http_transport.py``, with its
URL scheme and wire layout: every group runs a threaded HTTP server that
serves ``/checkpoint/<step>/{metadata,header,full,chunk_<i>}`` (``?n=<N>``
lets the receiver choose the stripe count) and the erasure-shard endpoints
``GET/POST /ec/shard/<step>/<idx>`` and ``GET /ec/have/<step>``.

Donor side.  The served snapshot is a COPY of the state at
``send_checkpoint``: torch optimizers update parameters in place, so a
snapshot by reference would serve the next step's weights under this
step's number.  A state holding CUDA tensors is copied in two stages:
``send_checkpoint`` (and ``enqueue_snapshot``) clones every tensor on the
caller's current stream (the Manager runs it under the train thread's
stream, so the clone precedes the step's optimizer update), records an
event and returns; the background snapshotter waits for the event, copies
the clones to the host on a stream of its own, flattens them, stamps one
checksum a buffer into the header (``TPUFT_HTTP_CRC=0`` turns the stamp
off), flips the served snapshot (serving enqueues only) and runs the
snapshot hook (the erasure encoder's entry).  A state on the CPU alone is
flattened at once, unless ``background=True``.  ``enqueue_snapshot(...,
serve=False)`` runs the same pipeline without flipping the served slot.
An RW lock is the serving window: its write side is held from
construction and from ``disallow_checkpoint`` until ``allow_checkpoint``
(which ``send_checkpoint`` calls), and every checkpoint request holds the
read side while it streams.  A request for a step whose snapshot is still
flattening waits for the flip (bounded by the timeout); a request for any
step other than the served one gets a 404, so the stripes of one heal come
from one snapshot generation, and each buffer is checked against the
header's checksums as it lands.  ``TPUFT_HTTP_SHAPED_MBPS`` (or
``set_shaped_mbps``) paces every connection of a transport to one link
rate, as a donor's network link would.

Receiver side.  ``recv_checkpoint`` takes one donor URL or a list.  With
one donor it asks ``/metadata`` for the donor's chunk count and pulls the
chunks in parallel when this host has the cores (``workers = min(chunks,
os.cpu_count())``, or ``TPUFT_HTTP_CHUNK_WORKERS``), else one ``/full``
stream; with several it stripes the buffers round-robin over twice the
donor count, assigns stripes to donors by bytes and fails a stripe over to
the next donor on any error, a checksum mismatch included.  Every buffer is
allocated once (pinned host memory where CUDA is available, so the upload
that follows can be asynchronous) and read straight into.  ``last_fetch``
holds the last fetch's bytes, seconds, mode, donors, stripes and workers,
the stripes each donor served, the failovers and the checksum time;
``last_snapshot`` the last flatten's step, thread, milliseconds, bytes and
checksum time.
"""

from __future__ import annotations

import io
import json
import logging
import os
import pickle
import socket
import threading
import time
import urllib.parse
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from torchft_tpu_torch.checkpointing import integrity
from torchft_tpu_torch.checkpointing._rwlock import RWLock
from torchft_tpu_torch.checkpointing.serialization import (
    ForeignFrameError,
    StateDictMeta,
    as_u8,
    byte_view,
    flatten_state_dict,
    read_exact,
    read_exact_into,
    read_header,
    read_state_dict,
    safe_loads,
    state_dict_frames,
    unflatten_state_dict,
    write_state_dict,
)
from torchft_tpu_torch.checkpointing.transport import CheckpointTransport

logger = logging.getLogger("torchft_tpu_torch.checkpointing.http")

# Chunks a donor advertises on /metadata: a single-donor receiver with the
# cores pulls that many in parallel.
DEFAULT_NUM_CHUNKS = 8


class _Server(ThreadingHTTPServer):
    daemon_threads = True


def _make_server(host: str, handler: type) -> _Server:
    if host:
        return _Server((host, 0), handler)
    try:
        class _Server6(_Server):
            address_family = socket.AF_INET6

            def server_bind(self) -> None:
                self.socket.setsockopt(socket.IPPROTO_IPV6, socket.IPV6_V6ONLY, 0)
                super().server_bind()

        return _Server6(("::", 0), handler)
    except OSError:  # no IPv6 on this host
        return _Server(("", 0), handler)


def _has_cuda(node: Any) -> bool:
    if isinstance(node, dict):
        return any(_has_cuda(v) for v in node.values())
    if isinstance(node, (list, tuple)):
        return any(_has_cuda(v) for v in node)
    return isinstance(node, torch.Tensor) and node.device.type == "cuda"


def _clone_tree(node: Any) -> Any:
    """The state with every tensor cloned where it lies (CUDA tensors on
    the current stream), containers rebuilt with their types and key
    order, other values kept."""
    if isinstance(node, dict):
        return type(node)((k, _clone_tree(v)) for k, v in node.items())
    if isinstance(node, (list, tuple)):
        return type(node)(_clone_tree(v) for v in node)
    if isinstance(node, torch.Tensor):
        return node.detach().clone()
    return node


class HTTPTransport(CheckpointTransport):
    """Serves state-dict snapshots and erasure shards over HTTP.

    Args:
        timeout: per-request deadline, and how long a request waits for the
            serving window or for the snapshot of its step.
        host: address to listen on and advertise; by default every
            interface, advertised under this machine's host name.
        background: flatten on the background snapshotter; by default
            exactly for states that hold CUDA tensors.
        num_chunks: chunks advertised on ``/metadata`` to single-donor
            receivers (0 or 1: one ``/full`` stream).
        restore_sharding: the placement restorer of every received state
            (``serialization.sharding_restorer(state_dict_fn)``): tensors
            land on their live twins' devices, DTensor shards on their
            twins' meshes.  None: the state comes back on the CPU, a DTensor
            leaf as its plain local shard.
    """

    serves_all_donors = True

    def __init__(self, timeout: float = 60.0, host: Optional[str] = None,
                 background: Optional[bool] = None, num_chunks: int = DEFAULT_NUM_CHUNKS,
                 restore_sharding: Optional[Callable[..., torch.Tensor]] = None) -> None:
        self._timeout = timeout
        self._restore = restore_sharding
        self._background = background
        self._num_chunks = num_chunks
        # Received buffers are pinned where a card will take them.
        self._pin = torch.cuda.is_available()
        self._host = host or ""
        # The serving window: write-held while closed.
        self._checkpoint_lock = RWLock(timeout=timeout)
        self._checkpoint_lock.w_acquire()
        # Under _cond: the served snapshot (_state at _step), the pending
        # snapshots keyed by their serve flag (newest of each kind only,
        # serving ones first), the newest pending serving step, and each
        # kind's last flatten failure.
        self._cond = threading.Condition()
        self._state: Optional[Tuple[StateDictMeta, List[np.ndarray]]] = None
        self._step = -1
        self._snap_pending: Dict[bool, tuple] = {}
        self._pending_step = -1
        self._snap_busy = False
        self._snap_error: Dict[bool, Optional[Exception]] = {}
        self._shutdown = False
        self._spans: Any = None
        self._shard_store: Any = None
        self._snapshot_hook: Optional[Callable[[int, StateDictMeta, List[np.ndarray]], None]] = None
        self._crc_enabled = os.environ.get("TPUFT_HTTP_CRC", "1") != "0"
        self._pacer = _ServerPacer.from_env()
        self.last_fetch: dict = {}
        self.last_snapshot: dict = {}
        # Requests answered, counted as their answer starts, by kind
        # (metadata, header, full, chunk, ec_shard, ec_have, ec_push), and
        # serving windows opened.
        self.served: Dict[str, int] = {}
        self.windows_opened = 0
        transport = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt: str, *args: object) -> None:
                logger.debug(fmt % args)

            def do_GET(self) -> None:
                path, _, query = self.path.partition("?")
                parts = path.strip("/").split("/")
                if parts and parts[0] == "ec":
                    transport._handle_ec_get(self, parts, query)
                    return
                if len(parts) != 3 or parts[0] != "checkpoint":
                    self.send_error(404, "unknown path")
                    return
                try:
                    step = int(parts[1])
                except ValueError:
                    self.send_error(400, "bad step")
                    return
                what = parts[2]
                n_req: Optional[int] = None
                if query:
                    try:
                        raw_n = urllib.parse.parse_qs(query).get("n", [None])[0]
                        n_req = None if raw_n is None else int(raw_n)
                    except ValueError:
                        self.send_error(400, "bad stripe count")
                        return
                    if n_req is not None and n_req <= 0:
                        self.send_error(400, "bad stripe count")
                        return
                try:
                    transport._await_flip(step)
                    with transport._checkpoint_lock.r_lock(transport._timeout):
                        # A request that arrived before the window opened
                        # sees the snapshot's enqueue only now.
                        transport._await_flip(step)
                        with transport._cond:
                            if transport._state is None or transport._step != step:
                                self.send_error(404, f"checkpoint for step {step} not available "
                                                     f"(serving {transport._step})")
                                return
                            # Immutable after the flip: streams outside the lock.
                            meta, buffers = transport._state
                        transport._serve(self, meta, buffers, what, n_req)
                except TimeoutError:
                    self.send_error(503, "checkpoint window closed")

            def do_POST(self) -> None:
                parts = self.path.partition("?")[0].strip("/").split("/")
                if parts and parts[0] == "ec":
                    transport._handle_ec_post(self, parts)
                    return
                self.send_error(404, "unknown path")

        self._server = _make_server(self._host, Handler)
        self._port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="tpuft_torch_http", daemon=True
        )
        self._thread.start()
        self._snap_thread = threading.Thread(
            target=self._snapshot_loop, name="tpuft_torch_http_snapshot", daemon=True
        )
        self._snap_thread.start()

    # -- wiring ---------------------------------------------------------------

    def metadata(self) -> str:
        return f"http://{self._host or socket.gethostname()}:{self._port}"

    def set_span_tracker(self, spans: Any) -> None:
        """Spans each flatten on ``spans``
        (:class:`~torchft_tpu_torch.obs.spans.SpanTracker`)."""
        self._spans = spans

    def attach_shard_store(self, store: Any) -> None:
        """Serves and accepts the shards of ``store``
        (:class:`~torchft_tpu_torch.ec.store.ShardStore`) on ``/ec/...``."""
        self._shard_store = store

    def set_snapshot_hook(self, hook: Callable[[int, StateDictMeta, List[np.ndarray]], None]
                          ) -> None:
        """Runs ``hook(step, meta, buffers)`` on the background snapshotter
        after every flatten (the erasure encoder's entry); it must not
        raise."""
        self._snapshot_hook = hook

    def set_shaped_mbps(self, mbps: float) -> None:
        """Paces every connection of this transport to ``mbps`` MB/s, as
        ``TPUFT_HTTP_SHAPED_MBPS`` does at construction (0: no pacing)."""
        self._pacer = _ServerPacer(mbps) if mbps > 0 else None

    # -- the snapshot pipeline -----------------------------------------------

    def send_checkpoint(self, dst_ranks: List[int], step: int, state_dict: Any,
                        timeout: float) -> None:
        """Serves a copy of ``state_dict`` as ``step`` and opens the serving
        window: at once for a state on the CPU; for one with CUDA tensors,
        clones them on the current stream and leaves the host copy to the
        background snapshotter."""
        self.enqueue_snapshot(step, state_dict, serve=True)
        self.allow_checkpoint(step)

    def enqueue_snapshot(self, step: int, state_dict: Any, serve: bool = True) -> None:
        """Snapshots ``state_dict`` for the pipeline: ``serve=True`` flips
        the served snapshot, ``serve=False`` (the erasure encoder's per-commit
        feed) runs the flatten, the checksums and the hook only.  Only the
        newest pending snapshot of each kind is kept."""
        on_card = _has_cuda(state_dict)
        if not (on_card if self._background is None else self._background):
            flat = self._flatten(state_dict, step, serve)
            if serve:
                self._publish(step, *flat)
            if serve and self._snapshot_hook is None:
                return
            entry = (step, flat, None, True)
        else:
            ready = None
            clone = _clone_tree(state_dict)
            if on_card:
                ready = torch.cuda.Event()
                ready.record()
            entry = (step, clone, ready, False)
        with self._cond:
            self._snap_pending[serve] = entry
            if serve and not entry[3]:
                self._pending_step = max(self._pending_step, step)
            self._cond.notify_all()

    def _flatten(self, state_dict: Any, step: int, serve: bool) -> tuple:
        t0 = time.monotonic()
        if self._spans is None:
            meta, buffers, crc_ms = self._flatten_with_crcs(state_dict, step)
        else:
            with self._spans.span("snapshot", step=step) as sp:
                meta, buffers, crc_ms = self._flatten_with_crcs(state_dict, step)
                sp.fields["bytes"] = sum(b.nbytes for b in buffers)
                sp.fields["crc_ms"] = crc_ms
        self.last_snapshot = {"step": step, "thread": threading.current_thread().name,
                              "ms": round((time.monotonic() - t0) * 1e3, 3),
                              "bytes": sum(b.nbytes for b in buffers), "crc_ms": crc_ms,
                              "serve": serve}
        return meta, buffers

    def _flatten_with_crcs(self, state_dict: Any, step: int) -> tuple:
        meta, buffers = flatten_state_dict(state_dict, step)
        crc_ms = 0.0
        if self._crc_enabled:
            t0 = time.monotonic()
            meta.crc_algo, crcs = integrity.checksum_buffers(buffers)
            meta.crcs = tuple(crcs)
            crc_ms = round((time.monotonic() - t0) * 1e3, 3)
        return meta, buffers, crc_ms

    def _publish(self, step: int, meta: StateDictMeta, buffers: List[np.ndarray]) -> None:
        with self._cond:
            if step >= self._step:
                self._state = (meta, buffers)
                self._step = step
            self._cond.notify_all()

    def _snapshot_loop(self) -> None:
        """Flattens the newest pending snapshot off the train thread (a
        clone on the card: after its event, on this thread's own stream),
        flips the served slot for a serving one, then runs the hook."""
        stream = None
        while True:
            with self._cond:
                while not self._snap_pending and not self._shutdown:
                    self._cond.wait()
                if self._shutdown:
                    return
                serve = True in self._snap_pending
                step, payload, ready, flat = self._snap_pending.pop(serve)
                self._snap_busy = True
            try:
                if flat:
                    meta, buffers = payload
                elif ready is None:
                    meta, buffers = self._flatten(payload, step, serve)
                else:
                    stream = stream or torch.cuda.Stream()
                    stream.wait_event(ready)
                    with torch.cuda.stream(stream):
                        meta, buffers = self._flatten(payload, step, serve)
                    stream.synchronize()
                error = None
            except Exception as e:  # noqa: BLE001 - a healer sees a 404 and retries
                logger.exception("background snapshot for step %s failed: %s", step, e)
                error = e
            payload = None  # frees the clone
            with self._cond:
                if error is None and serve and step >= self._step:
                    self._state = (meta, buffers)
                    self._step = step
                self._snap_error[serve] = error
                if serve and self._pending_step == step:
                    self._pending_step = -1
                if error is not None:
                    self._snap_busy = False
                self._cond.notify_all()
            if error is not None:
                continue
            hook = self._snapshot_hook
            if hook is not None:
                try:
                    hook(step, meta, buffers)
                except Exception as e:  # noqa: BLE001 - degrades to donor-only healing
                    logger.exception("snapshot hook for step %s failed: %s", step, e)
            with self._cond:
                self._snap_busy = False
                self._cond.notify_all()

    def _await_flip(self, step: int) -> None:
        """Blocks while a serving snapshot for ``step`` is pending, until it
        is served (or fails, or the timeout passes: TimeoutError)."""
        deadline = time.monotonic() + self._timeout
        with self._cond:
            while self._step < step and self._pending_step >= step and not self._shutdown:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError("snapshot still pending")
                self._cond.wait(remaining)

    def wait_snapshot(self, timeout: Optional[float] = None) -> bool:
        """Blocks until no snapshot is pending or flattening (the hook
        included); False on timeout or when the last serving snapshot
        failed to flatten."""
        deadline = time.monotonic() + (timeout if timeout is not None else self._timeout)
        with self._cond:
            while ((self._snap_pending or self._snap_busy or self._pending_step >= 0)
                   and not self._shutdown):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(remaining)
            return self._snap_error.get(True) is None

    def allow_checkpoint(self, step: int) -> None:
        """Opens the serving window."""
        if self._checkpoint_lock.w_locked():
            self._checkpoint_lock.w_release()
            self.windows_opened += 1

    def disallow_checkpoint(self) -> None:
        """Closes the serving window once the requests being served finish."""
        if not self._checkpoint_lock.w_locked():
            if not self._checkpoint_lock.w_acquire(self._timeout):
                raise TimeoutError("timed out closing the checkpoint window")

    # -- serving --------------------------------------------------------------

    def _count(self, kind: str) -> None:
        with self._cond:
            self.served[kind] = self.served.get(kind, 0) + 1

    def _serve(self, handler: Any, meta: StateDictMeta, buffers: List[np.ndarray], what: str,
               n_req: Optional[int]) -> None:
        if what == "full":
            prefix, total = state_dict_frames(meta, buffers)
            _send_head(handler, total)
            self._count("full")
            write_state_dict(meta, buffers, _paced(handler.wfile, self._pacer), prefix=prefix)
            return
        if what.startswith("chunk_"):
            framed = self._chunk_frame(meta, buffers, what, n_req)
            if framed is None:
                handler.send_error(404, f"unknown object {what}")
                return
            sub_prefix, sel, total = framed
            _send_head(handler, total)
            self._count("chunk")
            out = _paced(handler.wfile, self._pacer)
            out.write(sub_prefix)
            for i in sel:
                out.write(memoryview(as_u8(buffers[i])))
            return
        if what == "header":
            payload = state_dict_frames(meta, [])[0]
        elif what == "metadata":
            payload = pickle.dumps(self._chunk_count(buffers))
        else:
            handler.send_error(404, f"unknown object {what}")
            return
        _send_head(handler, len(payload))
        self._count(what)
        handler.wfile.write(payload)

    def _chunk_frame(self, meta: StateDictMeta, buffers: List[np.ndarray], what: str,
                     n_req: Optional[int]) -> Optional[Tuple[bytes, List[int], int]]:
        """(the chunk's prefix, its buffer indices, its body length) of one
        ``chunk_<i>`` request, or None for a bad index.  ``?n=`` sets the
        round-robin split; without it the advertised chunk count does."""
        try:
            idx = int(what[len("chunk_"):])
        except ValueError:
            return None
        n = n_req if n_req is not None else self._chunk_count(buffers)
        if idx < 0 or idx >= n:
            return None
        sel = [i for i in range(len(buffers)) if i % n == idx]
        sub_meta = pickle.dumps((idx, sel))
        prefix = len(sub_meta).to_bytes(8, "little") + sub_meta
        return prefix, sel, len(prefix) + sum(int(buffers[i].nbytes) for i in sel)

    def _chunk_count(self, buffers: List[np.ndarray]) -> int:
        if self._num_chunks <= 0:
            return 1
        return max(1, min(self._num_chunks, len(buffers)))

    # -- erasure shard endpoints ----------------------------------------------

    def _handle_ec_get(self, handler: Any, parts: List[str], query: str = "") -> None:
        """GET /ec/shard/<step>/<idx>[?part=<i>&n=<N>] (one shard frame, or
        its header and payload range i of N) and GET /ec/have/<step> (the
        store's inventory as JSON), served straight from the shard store:
        no serving window."""
        store = self._shard_store
        if store is None:
            handler.send_error(404, "no shard store attached")
            return
        try:
            if len(parts) == 4 and parts[1] == "shard":
                step, idx = int(parts[2]), int(parts[3])
                shard = store.get(step, idx)
                if shard is None:
                    handler.send_error(404, f"shard {idx} for step {step} not held")
                    return
                from torchft_tpu_torch.ec.encoder import write_shard, write_shard_part

                part = n = None
                if query:
                    qs = urllib.parse.parse_qs(query)
                    raw_part, raw_n = qs.get("part", [None])[0], qs.get("n", [None])[0]
                    if raw_part is not None or raw_n is not None:
                        try:
                            part, n = int(raw_part or 0), int(raw_n or 0)
                        except ValueError:
                            handler.send_error(400, "bad shard range")
                            return
                        if n <= 0 or not 0 <= part < n:
                            handler.send_error(400, "bad shard range")
                            return
                body = write_shard(shard) if n is None else write_shard_part(shard, part, n)
                _send_head(handler, len(body))
                self._count("ec_shard")
                _paced(handler.wfile, self._pacer).write(body)
                return
            if len(parts) == 3 and parts[1] == "have":
                body = json.dumps(store.inventory(int(parts[2]))).encode()
                _send_head(handler, len(body), "application/json")
                self._count("ec_have")
                handler.wfile.write(body)
                return
        except ValueError:
            handler.send_error(400, "bad step/shard index")
            return
        handler.send_error(404, "unknown ec path")

    def _handle_ec_post(self, handler: Any, parts: List[str]) -> None:
        """POST /ec/shard/<step>/<idx>: a peer pushing a parity shard,
        checksum-verified before it is stored (a torn push gets a 400)."""
        store = self._shard_store
        if store is None:
            handler.send_error(404, "no shard store attached")
            return
        if len(parts) != 4 or parts[1] != "shard":
            handler.send_error(404, "unknown ec path")
            return
        try:
            step, idx = int(parts[2]), int(parts[3])
            length = int(handler.headers.get("Content-Length", "0"))
        except ValueError:
            handler.send_error(400, "bad step/shard index")
            return
        if length <= 0:
            handler.send_error(400, "missing body")
            return
        try:
            from torchft_tpu_torch.ec.encoder import read_shard

            shard = read_shard(bytes(read_exact(handler.rfile, length)))
            if shard.step != step or shard.idx != idx:
                raise IOError(f"shard header ({shard.step},{shard.idx}) != path ({step},{idx})")
        except Exception as e:  # noqa: BLE001 - a corrupt push is a 400, not a 500
            handler.send_error(400, f"bad shard frame: {e}".encode("ascii", "replace").decode())
            return
        store.put(shard)
        self._count("ec_push")
        handler.send_response(204)
        handler.send_header("Content-Length", "0")
        handler.end_headers()

    # -- receiving ------------------------------------------------------------

    def _alloc(self, nbytes: int) -> Any:
        if self._pin and nbytes > 0:
            return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        return bytearray(nbytes)

    def materialize(self, meta: StateDictMeta, buffers: List[Any]) -> Any:
        """(header, buffers) -> the state, as a donor fetch builds it (the
        last leg of an erasure reconstruction)."""
        return unflatten_state_dict(meta, buffers, self._restore)

    def recv_checkpoint(self, src_rank: int, metadata: Union[str, Sequence[str]], step: int,
                        timeout: float) -> Any:
        """Fetches the state of ``step`` from one donor URL or a list of
        them (striped over all, each stripe failing over to the next)."""
        donors = [metadata] if isinstance(metadata, str) else [m for m in metadata if m]
        if not donors:
            raise ValueError("recv_checkpoint: no donor metadata")
        try:
            forced = int(os.environ.get("TPUFT_HTTP_CHUNK_WORKERS") or 0)
        except ValueError:
            logger.warning("ignoring malformed TPUFT_HTTP_CHUNK_WORKERS")
            forced = 0
        t0 = time.monotonic()
        stats = {"crc_ms": 0.0, "crc_verified": 0}
        n_stripes = 0
        if len(donors) == 1:
            base = f"{donors[0]}/checkpoint/{step}"
            n_chunks = int(safe_loads(self._fetch(f"{base}/metadata", timeout)))
            workers = forced or min(n_chunks, os.cpu_count() or 1)
            if n_chunks <= 1 or workers < 2:
                with self._urlopen(f"{base}/full", timeout) as resp:
                    meta, buffers = read_state_dict(resp, alloc=self._alloc, stats=stats)
                self._note_fetch(t0, buffers, stats, mode="full", donors=donors, n_stripes=1,
                                 workers=1, by_donor=[1], failovers=0, dead=[])
                return unflatten_state_dict(meta, buffers, self._restore)
            n_stripes = n_chunks
        else:
            workers = forced or max(len(donors), min(2 * len(donors), os.cpu_count() or 1))
        meta, buffers, got = self._recv_striped(donors, step, n_stripes, workers, timeout, stats)
        self._note_fetch(t0, buffers, stats, mode="striped" if len(donors) > 1 else "chunked",
                         donors=donors, workers=workers, **got)
        return unflatten_state_dict(meta, buffers, self._restore)

    def _note_fetch(self, t0: float, buffers: List[Any], stats: dict, **fields: Any) -> None:
        donors = fields["donors"]
        self.last_fetch = {
            "bytes": sum(len(byte_view(b)) for b in buffers),
            "fetch_s": round(time.monotonic() - t0, 6),
            "n_donors": len(donors),
            "crc_ms": round(stats["crc_ms"], 3),
            "crc_verified": stats["crc_verified"],
            **fields,
        }

    def _recv_striped(self, donors: List[str], step: int, n_stripes: int, workers: int,
                      timeout: float, stats: dict) -> tuple:
        dead: set = set()
        meta = self._fetch_header(donors, step, timeout, dead)
        n_tensors = len(meta.tensors)
        got = {"n_stripes": 0, "by_donor": [0] * len(donors), "failovers": 0}
        if n_tensors == 0:
            return meta, [], {**got, "dead": []}
        if n_stripes <= 0:
            # Twice the donors: the byte-greedy assignment can then balance
            # uneven tensors, and a dead donor's share splits.
            n_stripes = min(n_tensors, max(1, 2 * len(donors)))
        n_stripes = min(n_stripes, n_tensors)
        sels, sizes = _stripe_partition(meta, n_stripes)
        assign = _assign_stripes_by_bytes(sizes, len(donors))
        store = [self._alloc(n) for n in meta.buffer_nbytes]
        views = [byte_view(b) for b in store]
        lock = threading.Lock()

        def fetch_stripe(idx: int) -> None:
            d, failovers, crc_ms, verified = self._fetch_stripe(
                donors, assign[idx], step, n_stripes, idx, sels[idx], meta, views, timeout, dead)
            with lock:
                got["by_donor"][d] += 1
                got["failovers"] += failovers
                stats["crc_ms"] += crc_ms
                stats["crc_verified"] += verified

        if workers >= 2 and n_stripes > 1:
            with ThreadPoolExecutor(max_workers=min(workers, n_stripes),
                                    thread_name_prefix="tpuft_torch_stripe") as pool:
                list(pool.map(fetch_stripe, range(n_stripes)))
        else:
            for idx in range(n_stripes):
                fetch_stripe(idx)
        got["n_stripes"] = n_stripes
        got["dead"] = sorted(donors[d] for d in dead)
        return meta, store, got

    def _fetch_header(self, donors: List[str], step: int, timeout: float,
                      dead: set) -> StateDictMeta:
        errors: List[Exception] = []
        for d, donor in enumerate(donors):
            try:
                raw = self._fetch(f"{donor}/checkpoint/{step}/header", timeout)
                return read_header(io.BytesIO(raw))
            except Exception as e:  # noqa: BLE001 - fail over to the next donor
                dead.add(d)
                errors.append(e)
                logger.warning("header fetch from %s failed: %s", donor, e)
        foreign = [e for e in errors if isinstance(e, ForeignFrameError)]
        if foreign:
            raise foreign[0]
        raise RuntimeError(f"all {len(donors)} donors failed serving the header: {errors[-1]}")

    def _fetch_stripe(self, donors: List[str], assigned: int, step: int, n: int, idx: int,
                      sel: List[int], meta: StateDictMeta, views: List[memoryview],
                      timeout: float, dead: set) -> tuple:
        """Pulls stripe ``idx`` of ``n`` into the preallocated views from
        the assigned donor, failing over through the rest of the rotation;
        returns (the donor that served it, failovers, checksum ms, buffers
        verified)."""
        order = [(assigned + k) % len(donors) for k in range(len(donors))]
        candidates = [d for d in order if d not in dead] or order
        # One donor, chunked: n is the donor's own advertised count.
        query = f"?n={n}" if len(donors) > 1 else ""
        last: Optional[Exception] = None
        for attempt, d in enumerate(candidates):
            url = f"{donors[d]}/checkpoint/{step}/chunk_{idx}{query}"
            crc_ms, verified = 0.0, 0
            try:
                with self._urlopen(url, timeout) as resp:
                    sub_len = int.from_bytes(read_exact(resp, 8), "little")
                    got_idx, got_sel = safe_loads(read_exact(resp, sub_len))
                    if got_idx != idx or list(got_sel) != list(sel):
                        raise RuntimeError(f"stripe mismatch: asked ({idx},{n}), got {got_idx}")
                    for i in got_sel:
                        read_exact_into(resp, views[i])
                        if meta.crcs is not None:
                            # Verified as it lands: a corrupt stripe fails
                            # over, and the refetch overwrites the view.
                            t0 = time.monotonic()
                            integrity.verify(views[i], meta.crcs[i], meta.crc_algo,
                                             f"stripe {idx}/{n} buffer {i} from {donors[d]}")
                            crc_ms += (time.monotonic() - t0) * 1e3
                            verified += 1
                return d, attempt, crc_ms, verified
            except Exception as e:  # noqa: BLE001 - stripe failover
                last = e
                dead.add(d)
                if attempt + 1 < len(candidates):
                    logger.warning("stripe %d/%d from %s failed (%s); failing over to %s",
                                   idx, n, donors[d], e, donors[candidates[attempt + 1]])
        raise RuntimeError(f"stripe {idx}/{n} failed on all {len(candidates)} donors: {last}")

    def _fetch(self, url: str, timeout: float) -> bytes:
        with self._urlopen(url, timeout) as resp:
            return resp.read()

    def _urlopen(self, url: str, timeout: float) -> Any:
        """Every receiver-side HTTP open goes through here (tests hook it to
        kill a donor at a chosen request)."""
        return urllib.request.urlopen(url, timeout=timeout)

    def shutdown(self, wait: bool = True) -> None:
        with self._cond:
            self._shutdown = True
            self._cond.notify_all()
        self._server.shutdown()
        self._server.server_close()
        if wait:
            self._thread.join(timeout=5)
            self._snap_thread.join(timeout=5)


def _send_head(handler: Any, length: int, ctype: str = "application/octet-stream") -> None:
    handler.send_response(200)
    handler.send_header("Content-Type", ctype)
    handler.send_header("Content-Length", str(length))
    handler.end_headers()


def _stripe_partition(meta: StateDictMeta, n: int) -> Tuple[List[List[int]], List[int]]:
    """Round-robin buffer stripes and their byte sizes: the server's
    ``_chunk_frame`` selection exactly."""
    sels: List[List[int]] = [[] for _ in range(n)]
    sizes = [0] * n
    for i, nbytes in enumerate(meta.buffer_nbytes):
        sels[i % n].append(i)
        sizes[i % n] += nbytes
    return sels, sizes


def _assign_stripes_by_bytes(sizes: List[int], n_donors: int) -> List[int]:
    """Largest stripes first onto the least-loaded donor."""
    loads = [0] * n_donors
    assign = [0] * len(sizes)
    for idx in sorted(range(len(sizes)), key=lambda s: -sizes[s]):
        d = min(range(n_donors), key=lambda j: loads[j])
        assign[idx] = d
        loads[d] += sizes[idx]
    return assign


class _ServerPacer:
    """A virtual-time link shared by every connection of one transport:
    each write reserves ``bytes / rate`` seconds and sleeps to the end of
    its reservation, so parallel stripe readers share one link's rate."""

    def __init__(self, mbps: float) -> None:
        self._rate = mbps * 1e6
        self._lock = threading.Lock()
        self._next_free = 0.0

    @classmethod
    def from_env(cls) -> Optional["_ServerPacer"]:
        try:
            mbps = float(os.environ.get("TPUFT_HTTP_SHAPED_MBPS") or 0.0)
        except ValueError:
            mbps = 0.0
        return cls(mbps) if mbps > 0 else None

    def consume(self, n: int) -> None:
        now = time.monotonic()
        with self._lock:
            start = max(now, self._next_free)
            self._next_free = start + n / self._rate
            until = self._next_free
        if until > now:
            time.sleep(until - now)


class _PacedStream:
    """Writes through a shared :class:`_ServerPacer` in 4 MB slices."""

    _SLICE = 4 << 20

    def __init__(self, raw: Any, pacer: _ServerPacer) -> None:
        self._raw = raw
        self._pacer = pacer

    def write(self, data: Any) -> int:
        mv = memoryview(data).cast("B")
        for off in range(0, len(mv), self._SLICE):
            part = mv[off:off + self._SLICE]
            # Reserve before writing, so the socket write overlaps the next
            # reservation and the link runs at its nominal rate.
            self._pacer.consume(len(part))
            self._raw.write(part)
        return len(mv)


def _paced(raw: Any, pacer: Optional[_ServerPacer]) -> Any:
    return raw if pacer is None else _PacedStream(raw, pacer)
