"""HTTP checkpoint transport: pull-based live weight recovery, one donor.

The counterpart of ``torchft_tpu/checkpointing/http_transport.py`` without
striping, erasure shards, pacing or the integrity sidecar.  Every group runs
a threaded HTTP server; a recovering group fetches
``/checkpoint/<step>/full`` from its donor.

The served snapshot is a COPY taken at ``send_checkpoint``: torch optimizers
update parameters in place, so a snapshot by reference (what the JAX
package can afford with immutable arrays) would serve the next step's
weights under this step's number.  ``disallow_checkpoint`` drops the copy.
A request for a step whose snapshot is not up yet waits for it (bounded by
the timeout) instead of failing: the donor's and the healer's quorum
threads race by design.

With a span tracker set (the Manager sets its own), the copy runs inside a
``snapshot`` span, the JAX transport's phase name.  The JAX transport
flattens on a background thread, so the phase is an overlapped one there;
here the copy runs on the Manager's quorum thread, and the Manager spans
the train thread's wait for it as ``snapshot_wait``.  ``last_fetch`` holds
the last fetch's bytes and seconds.
"""

from __future__ import annotations

import logging
import socket
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, List, Optional, Sequence, Union

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


class HTTPTransport(CheckpointTransport):
    """Serves state-dict snapshots over HTTP.

    Args:
        timeout: per-request deadline, and how long a request waits for the
            snapshot of its step.
        host: address to listen on and advertise; by default every
            interface, advertised under this machine's host name.
    """

    serves_all_donors = True

    def __init__(self, timeout: float = 60.0, host: Optional[str] = None) -> None:
        self._timeout = timeout
        self._host = host or ""
        self._cond = threading.Condition()
        self._snapshot: Optional[tuple] = None  # (step, meta, buffers)
        self._spans: Any = None  # a SpanTracker, or None
        self.last_fetch: dict = {}
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
        """Takes a host copy of ``state_dict`` and serves it as ``step``."""
        if self._spans is None:
            meta, buffers = flatten_state_dict(state_dict, step)
        else:
            with self._spans.span("snapshot", step=step) as sp:
                meta, buffers = flatten_state_dict(state_dict, step)
                sp.fields["bytes"] = sum(b.nbytes for b in buffers)
        with self._cond:
            self._snapshot = (step, meta, buffers)
            self._cond.notify_all()

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
        self._server.shutdown()
        self._server.server_close()
        if wait:
            self._thread.join(timeout=5)
