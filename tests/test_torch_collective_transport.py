"""The port's ``CollectiveTransport`` and the Manager's membership callbacks
and ``set_checkpoint_transport``, against the JAX package's.

- The twin of ``tests/test_transports.py``'s multi-recovery case over
  ``CollectiveTransport``: three ranks, rank 0 serves ranks 1 and 2, and
  each healer's state is bitwise the donor's; the same arrays through the
  JAX transport give the same bytes, leaf by leaf.
- A step mismatch raises; the healer restores in place on its live twins'
  devices.
- A JAX package donor's header is refused with ``ForeignFrameError`` by a
  port healer in a subprocess that imports neither ``jax`` nor the JAX
  package.
- Two port Managers on a real lighthouse: group 1 joins late, is given its
  transport through ``set_checkpoint_transport``, heals from group 0 over
  send/recv (bitwise, the ``heal`` span carrying the bytes), and both
  commit merged steps with one state; each Manager's membership callback
  saw exactly the payloads of its ``membership_change`` events.
- The point-to-point path: with ``serves_all_donors`` false the donor
  serves only the healers the quorum assigns it, and the healer fetches
  from its primary alone.
- Membership callbacks: the payload is a copy of the event's, a callback
  that raises leaves the step alive, and a new quorum id over the same
  participants calls none.

Arrays come from seeded numpy generators.
"""

from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from datetime import timedelta
from typing import Any, Dict, List
from unittest.mock import MagicMock

import numpy as np
import pytest
import torch

from torch_port_ref import REPO, import_reference
from torchft_tpu_torch import _native
from torchft_tpu_torch.checkpointing import CollectiveTransport
from torchft_tpu_torch.checkpointing.serialization import flatten_state_dict
from torchft_tpu_torch.collectives import DummyCollective, TCPCollective
from torchft_tpu_torch.manager import Manager

HOST = "127.0.0.1"
T = 20.0
_PREFIX = itertools.count()


@pytest.fixture(scope="module")
def store():
    server = _native.StoreServer(bind=f"{HOST}:0")
    yield server
    server.shutdown()


def _np_state(seed: int) -> Dict[str, Any]:
    """The JAX test's state: f32 and bf16 weights, int64 and 0-d int32
    optimizer leaves, a 0-d f32 scalar and plain values."""
    import ml_dtypes

    rng = np.random.default_rng(seed)
    return {
        "model": {"w": rng.standard_normal((8, 16)).astype(np.float32),
                  "b": rng.standard_normal(16).astype(np.float32).astype(ml_dtypes.bfloat16)},
        "optim": [np.arange(10, dtype=np.int64) * seed,
                  {"lr": 0.125, "count": np.asarray(seed * 3, dtype=np.int32)}],
        "scalar": np.asarray(float(seed), dtype=np.float32),
        "tpuft": {"step": 7, "batches_committed": 21},
    }


def _torch_state(np_state: Dict[str, Any]) -> Dict[str, Any]:
    """The same arrays as tensors (bf16 through its bit pattern)."""
    def conv(x: Any) -> Any:
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, list):
            return [conv(v) for v in x]
        if isinstance(x, np.ndarray):
            if x.dtype.name == "bfloat16":
                return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
            return torch.from_numpy(x.copy())
        return x

    return conv(np_state)


def _leaf_bytes(state: Any) -> List[Any]:
    meta, buffers = flatten_state_dict(state)
    return [(meta.tensors[v][0], buffers[v].tobytes()) if k == "tensor" else v
            for k, v in meta.leaves]


def _jax_leaf_bytes(state: Any) -> List[Any]:
    import jax

    return [(tuple(np.shape(x)), np.asarray(x).tobytes()) if hasattr(x, "shape") else x
            for x in jax.tree_util.tree_leaves(state)]


def _recovery(store, make_collective, make_transport, state: Any, world: int = 3) -> dict:
    """Rank 0 serves ranks 1..world-1 at step 7; returns what each got."""
    prefix = f"ct/{next(_PREFIX)}"
    cols = [make_collective() for _ in range(world)]
    transports: Dict[int, Any] = {}

    def boot(rank: int) -> None:
        cols[rank].configure(f"{store.address()}/{prefix}", rank, world)
        transports[rank] = make_transport(cols[rank])

    results: Dict[int, Any] = {}
    barrier = threading.Barrier(world)

    def node(rank: int) -> None:
        t = transports[rank]
        try:
            if rank == 0:
                t.send_checkpoint(dst_ranks=list(range(1, world)), step=7, state_dict=state,
                                  timeout=T)
            else:
                results[rank] = t.recv_checkpoint(src_rank=0, metadata=t.metadata(), step=7,
                                                  timeout=T)
            barrier.wait(timeout=T)
        finally:
            t.shutdown()
            cols[rank].shutdown()

    with ThreadPoolExecutor(max_workers=world) as pool:
        list(pool.map(boot, range(world)))
        for f in [pool.submit(node, r) for r in range(world)]:
            f.result(timeout=60)
    return results


def test_multi_recovery_is_bitwise_and_equals_the_jax_transports_bytes(store) -> None:
    jax_ct = import_reference("torchft_tpu.checkpointing.collective_transport")
    jax_cols = import_reference("torchft_tpu.collectives")
    np_state = _np_state(1)
    state = _torch_state(np_state)
    got = _recovery(store, lambda: TCPCollective(timeout=T, host=HOST),
                    lambda c: CollectiveTransport(c, timeout=T), state)
    assert sorted(got) == [1, 2]
    want = _leaf_bytes(state)
    for rank in (1, 2):
        assert _leaf_bytes(got[rank]) == want
        assert got[rank]["model"]["b"].dtype == torch.bfloat16
        assert got[rank]["scalar"].shape == () and got[rank]["optim"][1]["count"].shape == ()
    ref = _recovery(store, lambda: jax_cols.TCPCollective(timeout=T),
                    lambda c: jax_ct.CollectiveTransport(c, timeout=T), np_state)
    assert sorted(ref) == [1, 2]
    assert _jax_leaf_bytes(ref[1]) == _jax_leaf_bytes(ref[2]) == want


def test_step_mismatch_raises_and_receive_restores_in_place(store) -> None:
    prefix = f"ct/{next(_PREFIX)}"
    cols = [TCPCollective(timeout=T, host=HOST) for _ in range(2)]
    live = {"w": torch.empty(8, 16, device="meta")}
    with ThreadPoolExecutor(max_workers=2) as pool:
        list(pool.map(lambda r: cols[r].configure(f"{store.address()}/{prefix}", r, 2), range(2)))
        rx = CollectiveTransport(cols[1], timeout=T, state_dict_fn=lambda: live)
        tx = CollectiveTransport(cols[0], timeout=T)
        state = {"w": torch.randn(8, 16, generator=torch.Generator().manual_seed(5))}
        try:
            sent = pool.submit(tx.send_checkpoint, [1], 7, state, T)
            with pytest.raises(RuntimeError, match="step mismatch: wanted 8, got 7"):
                rx.recv_checkpoint(0, "<collective>", step=8, timeout=T)
            sent.result(timeout=T)
            # The next transfer on the same ranks lands on the twin's device.
            sent = pool.submit(tx.send_checkpoint, [1], 9, {"w": torch.zeros(8, 16)}, T)
            # The buffer of the refused transfer is still queued first on its tag.
            cols[1].recv((0,), np.uint8, 0, tag=3).wait(timeout=T)
            got = rx.recv_checkpoint(0, ["<collective>", "<collective>"], step=9, timeout=T)
            sent.result(timeout=T)
            assert got["w"].device.type == "meta"
            assert rx.last_fetch["bytes"] == 8 * 16 * 4 and rx.last_fetch["mode"] == "collective"
        finally:
            for c in cols:
                c.shutdown()


def test_a_jax_header_is_refused_without_importing_jax(store, tmp_path) -> None:
    jax_ct = import_reference("torchft_tpu.checkpointing.collective_transport")
    jax_cols = import_reference("torchft_tpu.collectives")
    prefix = f"ct/{next(_PREFIX)}"
    script = (
        "import sys\n"
        "from torchft_tpu_torch.collectives import TCPCollective\n"
        "from torchft_tpu_torch.checkpointing import CollectiveTransport\n"
        "from torchft_tpu_torch.checkpointing.serialization import ForeignFrameError\n"
        "c = TCPCollective(timeout=20.0, host='127.0.0.1')\n"
        f"c.configure({store.address() + '/' + prefix!r}, 1, 2)\n"
        "try:\n"
        "    CollectiveTransport(c, timeout=20.0).recv_checkpoint(0, '<collective>', 7, 20.0)\n"
        "    raise SystemExit('read a foreign header')\n"
        "except ForeignFrameError as e:\n"
        "    print('refused:', e)\n"
        "c.shutdown()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'torchft_tpu'))\n"
        "print('imported:', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.Popen([sys.executable, "-c", script], cwd=str(tmp_path), env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    donor = jax_cols.TCPCollective(timeout=T)
    try:
        donor.configure(f"{store.address()}/{prefix}", 0, 2)
        try:
            jax_ct.CollectiveTransport(donor, timeout=T).send_checkpoint([1], 7, _np_state(2), T)
        except OSError:
            pass  # the healer refused the header and hung up before the buffers went
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
        donor.shutdown()
    assert proc.returncode == 0, out
    assert "refused: checkpoint header names torchft_tpu.checkpointing.serialization." \
           "StateDictMeta" in out
    assert "imported: []" in out


# -- Managers ----------------------------------------------------------------------------


def _group(gid: int, lighthouse: str, shared: dict, late: bool) -> None:
    """One group: two tensors trained by the average of per-group
    gradients.  Group 1 starts once group 0 has committed alone, with its
    transport set after construction, and heals over send/recv."""
    params = {"w": torch.zeros(300), "b": torch.zeros(7, dtype=torch.float64)}

    def load(sd: Dict[str, torch.Tensor]) -> None:
        for k, v in sd.items():
            params[k].copy_(v)

    collective = TCPCollective(timeout=T, host=HOST)
    m = Manager(
        collective=collective, load_state_dict=load, state_dict=lambda: params,
        min_replica_size=1, rank=0, world_size=1, replica_id=f"ct_g{gid}",
        lighthouse_addr=lighthouse, store_addr=HOST, manager_bind=f"{HOST}:0",
        checkpoint_transport=None if late else CollectiveTransport(collective, timeout=T),
        timeout=timedelta(seconds=T), quorum_timeout=timedelta(seconds=30), init_sync=False,
    )
    transport = CollectiveTransport(collective, timeout=T, state_dict_fn=lambda: params)
    if late:
        m.set_checkpoint_transport(transport)
        assert m._checkpoint_transport is transport
    seen: List[dict] = []
    m.register_membership_callback(seen.append)
    shared["callbacks"][m._replica_id] = seen
    try:
        for _ in range(300):
            target = shared["target"]
            if target is not None and m.current_step() >= target:
                break
            m.start_quorum()
            step = m.current_step()
            avg = m.allreduce(torch.full((300,), float(gid + 1)) * (step + 1)).result()
            avg_b = m.allreduce(torch.arange(7, dtype=torch.float64) * (gid - 1)).result()
            committed = m.should_commit()
            if committed:
                params["w"].sub_(0.01 * avg)
                params["b"].sub_(0.5 * avg_b)
                if gid == 0 and step == 2:
                    shared["solo_done"].set()
                if late and shared["target"] is None and m.num_participants() == 2:
                    shared["target"] = m.current_step() + 3
            if m.num_participants() < 2:
                time.sleep(0.02)
        shared["final"][gid] = (m.current_step(), {k: v.clone() for k, v in params.items()})
        if late:
            shared["heal_fetch"] = dict(transport.last_fetch)
    finally:
        m.shutdown()


def test_a_late_group_heals_over_send_recv_and_callbacks_match_the_events(
        monkeypatch, tmp_path) -> None:
    path = tmp_path / "metrics.jsonl"
    monkeypatch.setenv("TPUFT_METRICS_PATH", str(path))
    lh = _native.LighthouseServer(bind=f"{HOST}:0", min_replicas=1, join_timeout_ms=200,
                                  heartbeat_timeout_ms=1000)
    shared: Dict[str, Any] = {"target": None, "solo_done": threading.Event(), "final": {},
                              "callbacks": {}}
    errors: List[BaseException] = []

    def run(gid: int, late: bool) -> None:
        try:
            _group(gid, lh.address(), shared, late)
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(0, False))]
    try:
        threads[0].start()
        assert shared["solo_done"].wait(60), "group 0 never committed alone"
        threads.append(threading.Thread(target=run, args=(1, True)))
        threads[1].start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads), "a group hung"
    finally:
        lh.shutdown()
    if errors:
        raise errors[0]
    finals = shared["final"]
    assert sorted(finals) == [0, 1] and finals[0][0] == finals[1][0]
    for k in ("w", "b"):
        assert torch.equal(finals[0][1][k], finals[1][1][k]), k
    assert shared["heal_fetch"]["bytes"] == 300 * 4 + 7 * 8
    events = [json.loads(line) for line in path.read_text().splitlines()]
    healed = [e for e in events if e["event"] == "heal_fetched"]
    assert len(healed) == 1 and healed[0]["mode"] == "collective"
    assert healed[0]["bytes"] == 300 * 4 + 7 * 8
    keys = ("quorum_id", "old_participants", "new_participants", "joined", "left",
            "transition_s", "mode", "elastic_plan")
    for rid, seen in shared["callbacks"].items():
        changes = [{k: e[k] for k in keys} for e in events
                   if e["event"] == "membership_change" and e["replica_id"] == rid]
        assert changes and seen == changes, rid
    g0 = next(seen for rid, seen in shared["callbacks"].items() if rid.startswith("ct_g0"))
    assert [(c["joined"], c["left"]) for c in g0] == [([0], []), ([1], [])]


def _stub(lighthouse: str, transport: Any, quorums: List[Any]) -> Manager:
    m = Manager(
        collective=DummyCollective(), load_state_dict=lambda sd: None, state_dict=lambda: {},
        min_replica_size=1, rank=0, world_size=1, replica_id="stub",
        lighthouse_addr=lighthouse, store_addr=HOST, manager_bind=f"{HOST}:0",
        checkpoint_transport=transport, timeout=timedelta(seconds=10),
        quorum_timeout=timedelta(seconds=10),
    )
    m._client = MagicMock()
    m._client._quorum.side_effect = quorums
    m._client.should_commit.side_effect = lambda rank, step, ok, **kw: ok
    return m


@pytest.fixture
def lighthouse():
    lh = _native.LighthouseServer(bind=f"{HOST}:0", min_replicas=1)
    yield lh.address()
    lh.shutdown()


def _quorum(qid: int, participants: List[int], **kw: Any) -> Any:
    return _native.QuorumResult(quorum_id=qid, replica_rank=0,
                                replica_world_size=len(participants), max_step=kw.pop("step", 0),
                                max_replica_rank=0, max_world_size=len(participants),
                                participant_replica_ranks=participants,
                                participant_manager_addresses=[f"m{p}" for p in participants],
                                **kw)


def test_callbacks_get_copies_survive_a_raise_and_skip_a_bare_quorum_id_change(
        lighthouse, monkeypatch, tmp_path) -> None:
    path = tmp_path / "metrics.jsonl"
    monkeypatch.setenv("TPUFT_METRICS_PATH", str(path))
    quorums = [_quorum(1, [0]), _quorum(2, [0]), _quorum(3, [0, 1]), _quorum(3, [0, 1])]
    m = _stub(lighthouse, None, quorums)
    got: List[dict] = []

    def boom(payload: dict) -> None:
        payload["joined"].append(99)  # a copy: the next callback never sees it
        raise RuntimeError("resize hook failed")

    m.register_membership_callback(boom)
    m.register_membership_callback(got.append)
    try:
        for _ in quorums:
            m.start_quorum()
            assert m.should_commit()
        assert m.current_step() == 4 and m.errored() is None
    finally:
        m.shutdown()
    assert [(p["quorum_id"], p["joined"], p["left"]) for p in got] == [(1, [0], []),
                                                                        (3, [1], [])]
    events = [json.loads(line) for line in path.read_text().splitlines()]
    assert [e["quorum_id"] for e in events if e["event"] == "membership_change"] == [1, 3]
    assert [e["quorum_id"] for e in events if e["event"] == "reconfigure"] == [1, 2, 3]


def test_point_to_point_transport_serves_its_assigned_healers_and_heals_from_the_primary(
        lighthouse) -> None:
    transport = MagicMock()
    transport.serves_all_donors = False
    transport.metadata.return_value = "<collective>"
    transport.recv_checkpoint.return_value = {"user": {}, "tpuft": {"step": 5,
                                                                    "batches_committed": 0}}
    del transport.enqueue_snapshot
    donor_q = _quorum(1, [0, 1, 2, 3], recover_dst_replica_ranks=[2],
                      recover_dst_replica_ranks_all=[2, 3])
    heal_q = _quorum(1, [0, 1, 2], step=5, heal=True, recover_src_replica_rank=1,
                     recover_src_manager_address="mgr-1:0", recover_src_replica_ranks=[1, 0],
                     recover_src_manager_addresses=["mgr-1:0", "mgr-0:0"])
    m = _stub(lighthouse, transport, [donor_q, heal_q])
    dialled: List[str] = []
    m._dial_peer_transport = lambda addr: dialled.append(addr) or "<collective>"
    try:
        m.start_quorum()
        m.wait_quorum()
        assert transport.send_checkpoint.call_args.kwargs["dst_ranks"] == [2]
        assert m.should_commit()
        m.start_quorum()
        m.wait_quorum()
        assert m.errored() is None
        kwargs = transport.recv_checkpoint.call_args.kwargs
        assert kwargs["src_rank"] == 1 and kwargs["metadata"] == "<collective>"
        assert dialled == ["mgr-1:0"] and m.current_step() == 5
    finally:
        m.shutdown()
