"""Dual-stack threading HTTP server with a deep accept queue, and the
text-exposition endpoint every Python-side metrics page of the port is
served by.

The counterpart of ``torchft_tpu/http.py``.
"""

from __future__ import annotations

import socket
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

__all__ = ["ThreadingHTTPServerV6", "serve_text_exposition"]


class ThreadingHTTPServerV6(ThreadingHTTPServer):
    """IPv6 server that also accepts IPv4 (mapped) connections where the
    host allows dual stack."""

    address_family = socket.AF_INET6
    request_queue_size = 1024
    daemon_threads = True

    def server_bind(self) -> None:
        try:
            self.socket.setsockopt(socket.IPPROTO_IPV6, socket.IPV6_V6ONLY, 0)
        except OSError:  # a v6-only host: the bind below still serves v6
            pass
        super().server_bind()


class _ThreadingHTTPServerV4(ThreadingHTTPServer):
    request_queue_size = 1024
    daemon_threads = True


def serve_text_exposition(
    render: Callable[[], str],
    port: int,
    bind: str = "::1",
    path: str = "/metrics",
    thread_name: str = "tpuft_metrics",
) -> Optional[ThreadingHTTPServerV6]:
    """Starts a daemon HTTP server answering ``GET <path>`` with
    ``render()``'s text (the Prometheus exposition content type), on the
    dual-stack v6 server for a v6 ``bind`` and a v4 one for a v4 address.
    ``bind`` defaults to loopback: the endpoint is unauthenticated, so a wider bind
    is the operator's explicit choice.  Returns the server (its port is
    ``server.server_address[1]``), or None on any failure: metrics must
    never fail training."""
    try:
        class Handler(BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 - stdlib API
                if self.path != path:
                    self.send_response(404)
                    self.end_headers()
                    return
                body = render().encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args: object) -> None:  # no stderr line per scrape
                pass

        cls = ThreadingHTTPServerV6 if ":" in bind else _ThreadingHTTPServerV4
        server = cls((bind, port), Handler)
        threading.Thread(target=server.serve_forever, name=thread_name, daemon=True).start()
        return server
    except Exception:  # noqa: BLE001 - see the docstring
        return None
