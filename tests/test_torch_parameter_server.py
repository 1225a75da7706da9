"""The port's parameter server against the JAX package's.

Twins of ``tests/test_parameter_server.py`` (a session's round trip, two
sessions isolated from each other with an abandoned one in between, a bad
path refused with a 4xx), the session document's keys, and a JAX package
client on a port server: its session's answer bitwise the port client's.
Payloads come from a seeded numpy generator.
"""

from __future__ import annotations

import json
import socket
import urllib.error
import urllib.request

import numpy as np
import pytest

from torch_port_ref import import_reference
from torchft_tpu_torch.parameter_server import TCPParameterServer

DELTA = np.random.default_rng(1900).standard_normal(8).astype(np.float32)


@pytest.fixture()
def ps():
    def forward(session_id: str, collective) -> None:
        # A parameter pull: the client sends a delta, the server answers
        # with the (pretend) updated weights, delta + 1.
        delta = collective.recv((8,), np.float32, src=1, tag=1).wait(timeout=30)
        collective.send(delta + np.float32(1.0), dst=1, tag=2).wait(timeout=30)

    server = TCPParameterServer(forward, store_bind="127.0.0.1:0")
    yield server
    server.shutdown()


def _local_address(ps) -> str:
    # The host name may not resolve here: loopback.
    return ps.address().replace(socket.gethostname(), "127.0.0.1")


def _pull(client) -> np.ndarray:
    client.send(DELTA, dst=0, tag=1).wait(timeout=30)
    return client.recv((8,), np.float32, src=0, tag=2).wait(timeout=30)


def test_session_roundtrip(ps) -> None:
    client = TCPParameterServer.new_session(_local_address(ps))
    try:
        assert client.rank() == 1 and client.size() == 2
        np.testing.assert_array_equal(_pull(client), DELTA + np.float32(1.0))
    finally:
        client.shutdown()


def test_sessions_are_isolated(ps) -> None:
    first = TCPParameterServer.new_session(_local_address(ps))
    first.shutdown()  # walks away mid-session: the server's thread fails, the server lives
    second = TCPParameterServer.new_session(_local_address(ps))
    try:
        second.send(np.zeros(8, dtype=np.float32), dst=0, tag=1).wait(timeout=30)
        out = second.recv((8,), np.float32, src=0, tag=2).wait(timeout=30)
        np.testing.assert_array_equal(out, np.ones(8, dtype=np.float32))
    finally:
        second.shutdown()


def test_bad_path_is_rejected(ps) -> None:
    url = _local_address(ps).replace("/new_session", "/nope")
    with pytest.raises(urllib.error.HTTPError) as info:
        urllib.request.urlopen(url, timeout=10)
    assert 400 <= info.value.code < 500


def test_session_document_names_a_store_prefix_of_its_own(ps) -> None:
    """``GET /new_session`` answers ``{session_id, store_addr}`` (a prefix
    under the server's store), a fresh id each time; the serving thread
    then waits as rank 0, so each session here is closed as a client."""
    from torchft_tpu_torch.collectives import TCPCollective

    docs = []
    for _ in range(2):
        with urllib.request.urlopen(_local_address(ps), timeout=10) as resp:
            doc = json.load(resp)
        assert set(doc) == {"session_id", "store_addr"}
        assert doc["store_addr"] == f"{ps.store_address()}/session/{doc['session_id']}"
        docs.append(doc)
        c = TCPCollective(timeout=30.0)
        c.configure(doc["store_addr"], rank=1, world_size=2)
        try:
            _pull(c)
        finally:
            c.shutdown()
    assert docs[0]["session_id"] != docs[1]["session_id"]


def test_a_jax_client_on_a_port_server_gets_the_port_clients_answer(ps) -> None:
    jax_ps = import_reference("torchft_tpu.parameter_server")
    port_client = TCPParameterServer.new_session(_local_address(ps))
    jax_client = jax_ps.TCPParameterServer.new_session(_local_address(ps))
    try:
        got_port = _pull(port_client)
        got_jax = _pull(jax_client)
    finally:
        port_client.shutdown()
        jax_client.shutdown()
    assert got_jax.dtype == got_port.dtype == np.float32
    assert got_jax.tobytes() == got_port.tobytes() == (DELTA + np.float32(1.0)).tobytes()
