"""HTTP checkpoint transport: pull-based live weight recovery, one donor.

The counterpart of ``torchft_tpu/checkpointing/http_transport.py`` without
striping, erasure shards, pacing or the integrity sidecar.  Every group runs
a threaded HTTP server; a recovering group fetches
``/checkpoint/<step>/full`` from its donor.

The served snapshot is a COPY of the state at ``send_checkpoint``: torch
optimizers update parameters in place, so a snapshot by reference (what the
JAX package can afford with immutable arrays) would serve the next step's
weights under this step's number.  A state holding CUDA tensors is copied
in two stages, as the JAX transport's background snapshotter flattens:
``send_checkpoint`` clones every CUDA tensor on the device, on the caller's
current stream (the Manager runs it under the train thread's stream, so
the clone precedes the step's optimizer update), clones the CPU tensors,
records an event and returns; a background thread waits for the event,
copies the clones to the host on a stream of its own, flattens them and
flips the served snapshot.  A state on the CPU alone is copied and served
at once (there is nothing to overlap), unless ``background=True`` asks for
the background path there too.  ``disallow_checkpoint`` drops the
served copy; ``wait_snapshot`` blocks until no snapshot is pending.  A
request for a step whose snapshot is not up yet waits for it (bounded by
the timeout) instead of failing: the donor's and the healer's quorum
threads race by design.

With a span tracker set (the Manager sets its own), the flatten runs inside
a ``snapshot`` span, the JAX transport's overlapped phase: on the
background thread for a state on the card, inside ``send_checkpoint`` for
one on the CPU.  ``last_fetch`` holds the last fetch's bytes and seconds,
``last_snapshot`` the last flatten's step, thread, milliseconds and bytes.
"""

from __future__ import annotations

import logging
import socket
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, List, Optional, Sequence, Tuple, Union

import torch

from torchft_tpu_torch.checkpointing.serialization import (
    flatten_state_dict,
    read_state_dict,
    state_dict_prefix,
    unflatten_state_dict,
)
from torchft_tpu_torch.checkpointing.transport import CheckpointTransport

logger = logging.getLogger("torchft_tpu_torch.checkpointing.http")


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
    """Serves state-dict snapshots over HTTP.

    Args:
        timeout: per-request deadline, and how long a request waits for the
            snapshot of its step.
        host: address to listen on and advertise; by default every
            interface, advertised under this machine's host name.
        background: flatten on the background snapshotter; by default
            exactly for states that hold CUDA tensors.
    """

    serves_all_donors = True

    def __init__(self, timeout: float = 60.0, host: Optional[str] = None,
                 background: Optional[bool] = None) -> None:
        self._timeout = timeout
        self._background = background
        self._host = host or ""
        self._cond = threading.Condition()
        self._snapshot: Optional[tuple] = None  # (step, meta, buffers)
        self._spans: Any = None  # a SpanTracker, or None
        self.last_fetch: dict = {}
        self.last_snapshot: dict = {}
        # The background snapshotter: the newest (step, cloned state, event)
        # waiting to be flattened, whether one is flattening, and the last
        # flatten's failure.
        self._snap_pending: Optional[Tuple[int, Any, Any]] = None
        self._snap_busy = False
        self._snap_error: Optional[Exception] = None
        self._shutdown = False
        self._snap_thread: Optional[threading.Thread] = None
        transport = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt: str, *args: object) -> None:
                logger.debug(fmt % args)

            def do_GET(self) -> None:
                parts = self.path.strip("/").split("/")
                if len(parts) != 3 or parts[0] != "checkpoint" or parts[2] != "full":
                    self.send_error(404, "unknown path")
                    return
                try:
                    step = int(parts[1])
                except ValueError:
                    self.send_error(400, "bad step")
                    return
                snap = transport._await_snapshot(step)
                if snap is None:
                    self.send_error(404, f"checkpoint for step {step} not available")
                    return
                _, meta, buffers = snap
                prefix = state_dict_prefix(meta)
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.send_header(
                    "Content-Length", str(len(prefix) + sum(b.nbytes for b in buffers))
                )
                self.end_headers()
                self.wfile.write(prefix)
                for buf in buffers:
                    self.wfile.write(memoryview(buf))

        self._server = _make_server(self._host, Handler)
        self._port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="tpuft_torch_http", daemon=True
        )
        self._thread.start()

    def _await_snapshot(self, step: int) -> Optional[tuple]:
        deadline = time.monotonic() + self._timeout
        with self._cond:
            while self._snapshot is None or self._snapshot[0] != step:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self._cond.wait(remaining)
            return self._snapshot

    def metadata(self) -> str:
        return f"http://{self._host or socket.gethostname()}:{self._port}"

    def set_span_tracker(self, spans: Any) -> None:
        """Spans each snapshot copy on ``spans``
        (:class:`~torchft_tpu_torch.obs.spans.SpanTracker`)."""
        self._spans = spans

    def send_checkpoint(self, dst_ranks: List[int], step: int, state_dict: Any, timeout: float) -> None:
        """Serves a copy of ``state_dict`` as ``step``: at once for a state
        on the CPU; for one with CUDA tensors, clones them on the current
        stream and leaves the host copy to the background snapshotter."""
        on_card = _has_cuda(state_dict)
        if not (on_card if self._background is None else self._background):
            self._publish(step, *self._flatten(state_dict, step))
            return
        clone = _clone_tree(state_dict)
        ready = None
        if on_card:
            ready = torch.cuda.Event()
            ready.record()
        with self._cond:
            self._snap_pending = (step, clone, ready)
            self._snap_error = None
            if self._snap_thread is None:
                self._snap_thread = threading.Thread(
                    target=self._snapshot_loop, name="tpuft_torch_http_snapshot", daemon=True
                )
                self._snap_thread.start()
            self._cond.notify_all()

    def _flatten(self, state_dict: Any, step: int) -> tuple:
        t0 = time.monotonic()
        if self._spans is None:
            meta, buffers = flatten_state_dict(state_dict, step)
        else:
            with self._spans.span("snapshot", step=step) as sp:
                meta, buffers = flatten_state_dict(state_dict, step)
                sp.fields["bytes"] = sum(b.nbytes for b in buffers)
        self.last_snapshot = {"step": step, "thread": threading.current_thread().name,
                              "ms": round((time.monotonic() - t0) * 1e3, 3),
                              "bytes": sum(b.nbytes for b in buffers)}
        return meta, buffers

    def _publish(self, step: int, meta: Any, buffers: List[Any]) -> None:
        with self._cond:
            self._snapshot = (step, meta, buffers)
            self._cond.notify_all()

    def _snapshot_loop(self) -> None:
        """Flattens the newest pending clone off the train thread: waits for
        its event, copies it to the host on this thread's own stream, flips
        the served snapshot, and frees the clone."""
        stream = None
        while True:
            with self._cond:
                while self._snap_pending is None and not self._shutdown:
                    self._cond.wait()
                if self._shutdown:
                    return
                (step, clone, ready), self._snap_pending = self._snap_pending, None
                self._snap_busy = True
            try:
                if ready is None:
                    meta, buffers = self._flatten(clone, step)
                else:
                    stream = stream or torch.cuda.Stream()
                    stream.wait_event(ready)
                    with torch.cuda.stream(stream):
                        meta, buffers = self._flatten(clone, step)
                    stream.synchronize()
                self._publish(step, meta, buffers)
                error = None
            except Exception as e:  # noqa: BLE001 - a healer sees a 404 and retries
                logger.exception("background snapshot for step %s failed: %s", step, e)
                error = e
            del clone
            with self._cond:
                self._snap_error = error
                self._snap_busy = False
                self._cond.notify_all()

    def wait_snapshot(self, timeout: Optional[float] = None) -> bool:
        """Blocks until no snapshot is pending or flattening; False on
        timeout or when the last one failed to flatten."""
        deadline = time.monotonic() + (timeout if timeout is not None else self._timeout)
        with self._cond:
            while (self._snap_pending is not None or self._snap_busy) and not self._shutdown:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(remaining)
            return self._snap_error is None

    def disallow_checkpoint(self) -> None:
        with self._cond:
            self._snapshot = None

    def recv_checkpoint(
        self, src_rank: int, metadata: Union[str, Sequence[str]], step: int, timeout: float
    ) -> Any:
        base = metadata if isinstance(metadata, str) else metadata[0]
        t0 = time.monotonic()
        with urllib.request.urlopen(f"{base}/checkpoint/{step}/full", timeout=timeout) as resp:
            meta, buffers = read_state_dict(resp)
        self.last_fetch = {"bytes": sum(len(b) for b in buffers),
                           "fetch_s": round(time.monotonic() - t0, 6)}
        return unflatten_state_dict(meta, buffers)

    def shutdown(self, wait: bool = True) -> None:
        with self._cond:
            self._shutdown = True
            self._cond.notify_all()
        self._server.shutdown()
        self._server.server_close()
        if wait:
            self._thread.join(timeout=5)
            if self._snap_thread is not None:
                self._snap_thread.join(timeout=5)
