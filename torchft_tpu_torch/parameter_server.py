"""A fault-tolerant parameter server over reconfigurable collectives.

The counterpart of ``torchft_tpu/parameter_server.py``.  A threaded HTTP
endpoint hands out sessions: ``GET /new_session`` returns ``{session_id,
store_addr}``, and the serving thread is then taken over to rendezvous a
fresh 2-rank collective under that store prefix (the server rank 0, the
client rank 1) and run the user's ``forward`` over it.  A wedged or crashed
session costs one collective, not the server: the client opens a new
session.  No lighthouse is involved: the sessions are the membership.

The rendezvous store is the native ``StoreServer`` the port binds, one a
server, shared by every session through its prefix; the data plane is a
host collective, so a JAX package client can open a session on a port
server (the wire is the same).
"""

from __future__ import annotations

import json
import logging
import socket
import threading
import urllib.request
import uuid
from abc import ABC, abstractmethod
from http.server import BaseHTTPRequestHandler
from typing import Callable

from torchft_tpu_torch._native import StoreServer
from torchft_tpu_torch.collectives import Collective, TCPCollective
from torchft_tpu_torch.http import ThreadingHTTPServerV6

__all__ = ["ParameterServer", "TCPParameterServer"]

logger = logging.getLogger("torchft_tpu_torch.parameter_server")


class ParameterServer(ABC):
    """Threaded parameter server; a subclass gives the collective factory
    and the per-session ``forward``.

    Args:
        port: the HTTP port (0: any free one).
        store_bind: the bind address of the shared rendezvous store.
    """

    def __init__(self, port: int = 0, store_bind: str = "0.0.0.0:0") -> None:
        self._store = StoreServer(bind=store_bind)
        ps = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt: str, *args: object) -> None:
                logger.debug(fmt % args)

            def do_GET(self) -> None:  # noqa: N802 - stdlib API
                if self.path != "/new_session":
                    self.send_error(400, f"invalid path {self.path}")
                    return
                session_id = str(uuid.uuid4())
                store_addr = f"{ps.store_address()}/session/{session_id}"
                payload = json.dumps({"session_id": session_id,
                                      "store_addr": store_addr}).encode() + b"\n"
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)
                # The whole answer goes out (its Content-Length lets the
                # client finish) before this thread is taken for the session.
                self.wfile.flush()
                self.close_connection = True
                logger.info("new session %s", session_id)
                try:
                    ps._run_session(session_id, store_addr)
                except Exception:  # noqa: BLE001 - a session's death frees one collective
                    logger.exception("session %s failed", session_id)

        self._server = ThreadingHTTPServerV6(("", port), Handler)
        self._port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="tpuft_torch_parameter_server", daemon=True)
        self._thread.start()
        logger.info("parameter server on %s", self.address())

    # -- addresses --------------------------------------------------------------

    def address(self) -> str:
        """The HTTP address a client opens a session at."""
        return f"http://{socket.gethostname()}:{self._port}/new_session"

    def store_address(self) -> str:
        return self._store.address()

    # -- sessions ---------------------------------------------------------------

    def _run_session(self, session_id: str, store_addr: str) -> None:
        collective = self.new_collective()
        try:
            collective.configure(store_addr, rank=0, world_size=2)
            self.forward(session_id, collective)
        finally:
            collective.shutdown()

    @classmethod
    def new_session(cls, address: str, timeout: float = 60.0) -> Collective:
        """The client's side: opens a session and returns its configured
        collective (the client is rank 1, the server rank 0)."""
        with urllib.request.urlopen(address, timeout=timeout) as resp:
            data = json.load(resp)
        logger.info("connecting to session %s at %s", data["session_id"], data["store_addr"])
        collective = cls.new_collective()
        collective.configure(data["store_addr"], rank=1, world_size=2)
        return collective

    # -- what a subclass gives --------------------------------------------------

    @classmethod
    @abstractmethod
    def new_collective(cls) -> Collective:
        """A fresh, unconfigured collective for one session."""

    @abstractmethod
    def forward(self, session_id: str, collective: Collective) -> None:
        """Runs once a session on its own thread (loop inside for a session
        of many requests); an error ends this session only."""

    def shutdown(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5)
        self._store.shutdown()


class TCPParameterServer(ParameterServer):
    """A :class:`ParameterServer` over :class:`TCPCollective` with a
    ``forward`` callable of the user's."""

    def __init__(self, forward_fn: Callable[[str, Collective], None], port: int = 0,
                 store_bind: str = "0.0.0.0:0") -> None:
        self._forward_fn = forward_fn
        super().__init__(port=port, store_bind=store_bind)

    @classmethod
    def new_collective(cls) -> Collective:
        return TCPCollective(timeout=60.0)

    def forward(self, session_id: str, collective: Collective) -> None:
        self._forward_fn(session_id, collective)
