"""The port's elastic plane against the JAX package's: the elastic batch
engine, ``FIXED_WITH_SPARES`` and a membership churn in mixed quorums.

- ``ElasticBatchScaler``: ``plan`` equal to the JAX scaler's over
  participants 1-9 x global batch {1, 7, 48, 1000} x microbatch {1, 5, 16}
  x ``scale_lr`` x every rank (and none, and one out of range), and
  ``from_env`` equal over the knobs' combinations.
- ``FIXED_WITH_SPARES`` (fixed 2): three groups, one of them the port's, in
  one quorum; each group's participation, allreduce bits and votes equal
  an all-JAX quorum's, and the third group contributes zeros.
- A 3 -> 2 -> 3 churn of a mixed quorum under the elastic engine (global
  batch 48, microbatch 16): group 2 drains, groups 0 and 1 go on, a new
  incarnation of group 2 rejoins and heals.  Every group's participation,
  votes, ``last_configure`` (mode, reused and opened lanes) and
  ``membership_change.elastic_plan`` equal an all-JAX run's with the same
  incremental knobs, and every group ends with the all-JAX run's bits.
  After the heal the port plans for the participating world while the JAX
  Manager keeps the heal step's plan (ROADMAP queue 3): pinned here.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from datetime import timedelta
from typing import Any, Dict, List, Optional

import numpy as np
import pytest
import torch

from torch_port_ref import import_reference
from torchft_tpu_torch import _native
from torchft_tpu_torch.checkpointing import HTTPTransport
from torchft_tpu_torch.collectives import TCPCollective
from torchft_tpu_torch.ddp import ElasticBatchScaler
from torchft_tpu_torch.manager import Manager, WorldSizeMode

HOST = "127.0.0.1"
TIMEOUT = timedelta(seconds=20)
_ELASTIC_ENV = ("TPUFT_ELASTIC", "TPUFT_ELASTIC_GLOBAL_BATCH", "TPUFT_ELASTIC_MICROBATCH",
                "TPUFT_ELASTIC_SCALE_LR", "TPUFT_ELASTIC_BASE_PARTICIPANTS")


@pytest.fixture(scope="module")
def ref():
    return {name: import_reference(f"torchft_tpu.{name}")
            for name in ("manager", "collectives", "ddp", "checkpointing.http_transport",
                         "_native")}


# -- ElasticBatchScaler ------------------------------------------------------------


@pytest.mark.parametrize("scale_lr", ["none", "linear", "sqrt"])
@pytest.mark.parametrize("global_batch", [1, 7, 48, 1000])
def test_scaler_plans_equal_the_jax_scaler(ref, global_batch, scale_lr) -> None:
    for micro in (1, 5, 16):
        port = ElasticBatchScaler(global_batch, microbatch=micro, scale_lr=scale_lr)
        jax = ref["ddp"].ElasticBatchScaler(global_batch, microbatch=micro, scale_lr=scale_lr)
        for participants in range(1, 10):
            for rank in [None, *range(participants + 1)]:
                assert port.plan(participants, rank) == jax.plan(participants, rank), (
                    micro, participants, rank)
        # The split is exact: the ranks' shares sum to the global batch.
        for participants in range(1, 10):
            assert sum(port.plan(participants, r)["group_batch"]
                       for r in range(participants)) == max(global_batch, 0) or \
                global_batch < participants
    with pytest.raises(ValueError):
        ElasticBatchScaler(global_batch, scale_lr="cubic")
    with pytest.raises(ValueError):
        ElasticBatchScaler(0)


_ENV_CASES = [
    {},
    {"TPUFT_ELASTIC_GLOBAL_BATCH": "48", "TPUFT_ELASTIC_MICROBATCH": "16"},
    {"TPUFT_ELASTIC_GLOBAL_BATCH": "48", "TPUFT_ELASTIC": "0"},
    {"TPUFT_ELASTIC_GLOBAL_BATCH": "48", "TPUFT_ELASTIC": "on",
     "TPUFT_ELASTIC_SCALE_LR": "sqrt", "TPUFT_ELASTIC_BASE_PARTICIPANTS": "4"},
    {"TPUFT_ELASTIC_GLOBAL_BATCH": "1000", "TPUFT_ELASTIC_SCALE_LR": "cubic"},
    {"TPUFT_ELASTIC_GLOBAL_BATCH": "x"},
    {"TPUFT_ELASTIC_GLOBAL_BATCH": "-3"},
    {"TPUFT_ELASTIC_GLOBAL_BATCH": "7", "TPUFT_ELASTIC_MICROBATCH": "0"},
    {"TPUFT_ELASTIC_GLOBAL_BATCH": "7", "TPUFT_ELASTIC_SCALE_LR": "linear"},
]


@pytest.mark.parametrize("case", range(len(_ENV_CASES)))
def test_scaler_from_env_equals_the_jax_scaler(ref, monkeypatch, case) -> None:
    for key in _ELASTIC_ENV:
        monkeypatch.delenv(key, raising=False)
    for key, value in _ENV_CASES[case].items():
        monkeypatch.setenv(key, value)
    port, jax = ElasticBatchScaler.from_env(), ref["ddp"].ElasticBatchScaler.from_env()
    assert (port is None) == (jax is None)
    if port is not None:
        assert vars(port) == vars(jax)
        for participants in (3, 2, 5):
            assert port.plan(participants, 0) == jax.plan(participants, 0)


# -- mixed quorums ------------------------------------------------------------------


def _make(kind: str, ref, gid: int, lighthouse: str, state: Dict[str, Any], inc: bool,
          **kw) -> Any:
    """One group's Manager over a 2-lane ring and the HTTP transport; its
    state is ``{"w": f32[200]}`` (numpy for JAX, a tensor for the port)."""
    if kind == "jax":
        def load(sd):
            state["w"] = np.array(sd["w"], dtype=np.float32)

        m = ref["manager"].Manager(
            collective=ref["collectives"].TCPCollective(timeout=20.0, lanes=2,
                                                        chunk_bytes=4 << 10),
            load_state_dict=load, state_dict=lambda: {"w": state["w"]}, min_replica_size=2,
            timeout=TIMEOUT, quorum_timeout=TIMEOUT, rank=0, world_size=1,
            replica_id=f"el{gid}", lighthouse_addr=lighthouse, init_sync=False,
            checkpoint_transport=ref["checkpointing.http_transport"].HTTPTransport(
                timeout=20.0),
            **kw)
    else:
        def load(sd):
            state["w"] = np.asarray(sd["w"].numpy() if isinstance(sd["w"], torch.Tensor)
                                    else sd["w"], dtype=np.float32).copy()

        if "world_size_mode" in kw:
            kw = dict(kw, world_size_mode=WorldSizeMode[kw["world_size_mode"].name])
        m = Manager(
            collective=TCPCollective(timeout=20.0, lanes=2, chunk_bytes=4 << 10, host=HOST),
            load_state_dict=load, state_dict=lambda: {"w": torch.from_numpy(state["w"])},
            min_replica_size=2, timeout=TIMEOUT, quorum_timeout=TIMEOUT, rank=0,
            world_size=1, replica_id=f"el{gid}", lighthouse_addr=lighthouse, store_addr=HOST,
            manager_bind=f"{HOST}:0", init_sync=False,
            checkpoint_transport=HTTPTransport(timeout=20.0, host=HOST), **kw)
    m.collective()._incremental = inc
    return m


def _grad(gid: int, step: int) -> np.ndarray:
    rng = np.random.default_rng(900 + 31 * gid + step)
    return rng.standard_normal(200).astype(np.float32)


def _step(m, gid: int, state: Dict[str, Any], log: List[dict]) -> bool:
    """One FT step: quorum, one allreduce, the vote, an SGD update."""
    m.start_quorum()
    m.wait_quorum()
    step = m.current_step()
    lc = m.collective().last_configure
    avg = m.allreduce(_grad(gid, step))
    avg = np.asarray(avg.result(), dtype=np.float32)
    ok = m.should_commit()
    if ok:
        state["w"] = state["w"] - np.float32(0.1) * avg
    plan = m.elastic_plan()
    log.append({"step": step, "ok": ok, "participants": m.num_participants(),
                "prank": m.participating_rank(), "avg": avg.tobytes(),
                "cfg": (lc["mode"], lc["reused_lanes"], lc["opened_lanes"]),
                "plan": dict(plan) if plan else None})
    return ok


def _heartbeats(lh, ref, n: int) -> None:
    """Waits until the lighthouse has heard ``n`` groups' heartbeats, so the
    first quorum forms with every built group."""
    client = ref["_native"].LighthouseClient(lh.address())
    try:
        deadline = time.monotonic() + 20
        while len(client.status().heartbeat_age_ms) < n:
            assert time.monotonic() < deadline, "heartbeats never arrived"
            time.sleep(0.02)
    finally:
        client.close()


def _join_all(threads: List[threading.Thread], errors: List[BaseException]) -> None:
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads), "a group hung"
    if errors:
        raise errors[0]


def _fixed_run(kinds: List[str], ref) -> Dict[int, List[dict]]:
    lh = _native.LighthouseServer(bind=f"{HOST}:0", http_bind=f"{HOST}:0", min_replicas=2,
                                  join_timeout_ms=2000)
    logs: Dict[int, List[dict]] = {g: [] for g in range(3)}
    errors: List[BaseException] = []
    built = threading.Barrier(3, action=lambda: _heartbeats(lh, ref, 3))
    managers: Dict[int, Any] = {}

    def group(g: int) -> None:
        try:
            state = {"w": np.zeros(200, np.float32)}
            mode = ref["manager"].WorldSizeMode.FIXED_WITH_SPARES
            managers[g] = m = _make(kinds[g], ref, g, lh.address(), state, True,
                                    world_size_mode=mode, fixed_world_size=2)
            built.wait(30)
            for _ in range(3):
                assert _step(m, g, state, logs[g])
            logs[g].append({"w": state["w"].tobytes()})
        except BaseException as e:  # noqa: BLE001 - re-raised by the test
            errors.append(e)
            built.abort()

    threads = [threading.Thread(target=group, args=(g,)) for g in range(3)]
    try:
        for t in threads:
            t.start()
        _join_all(threads, errors)
    finally:
        # One group at a time, from this thread, once every group's last
        # vote is in: the groups' threads shutting down together segfaulted
        # in the JAX package's native shutdown.
        for g in sorted(managers):
            managers[g].shutdown()
        lh.shutdown()
    return logs


@pytest.mark.parametrize("port_group", [0, 2])
def test_fixed_with_spares_mixed_quorum_equals_all_jax(ref, port_group) -> None:
    kinds = ["jax"] * 3
    kinds[port_group] = "port"
    mixed, want = _fixed_run(kinds, ref), _fixed_run(["jax"] * 3, ref)
    assert mixed == want
    for g in range(3):
        assert [r["participants"] for r in mixed[g][:-1]] == [2, 2, 2]
    assert [r["prank"] for r in mixed[2][:-1]] == [None] * 3  # the spare
    # The spare contributes zeros: the average is groups 0 and 1's.
    for s, rec in enumerate(mixed[0][:-1]):
        want_avg = (_grad(0, s) + _grad(1, s)) / np.float32(2)
        assert np.frombuffer(rec["avg"], np.float32).tobytes() == want_avg.tobytes()


def _churn_run(kinds: List[str], incs: List[bool], ref, monkeypatch) -> dict:
    """Groups 0-2 take 2 steps; group 2 drains and leaves; groups 0 and 1
    take 2 steps; a new incarnation of group 2 (``kinds[2]``, healing from
    group 0, the same package) rejoins and all take 3 more (the first its
    heal step)."""
    monkeypatch.setenv("TPUFT_ELASTIC_GLOBAL_BATCH", "48")
    monkeypatch.setenv("TPUFT_ELASTIC_MICROBATCH", "16")
    monkeypatch.setenv("TPUFT_MAX_HEAL_DONORS", "1")
    lh = _native.LighthouseServer(bind=f"{HOST}:0", http_bind=f"{HOST}:0", min_replicas=2,
                                  join_timeout_ms=2000)
    jax_lh = ref["_native"].LighthouseClient(lh.address())
    logs: Dict[Any, List[dict]] = {0: [], 1: [], 2: [], "2b": []}
    errors: List[BaseException] = []
    built = threading.Barrier(3, action=lambda: _heartbeats(lh, ref, 3))
    left, phase2, rejoined = threading.Event(), threading.Barrier(3), threading.Event()
    finals: Dict[Any, bytes] = {}

    def survivor(g: int) -> None:
        m = None
        try:
            state = {"w": np.zeros(200, np.float32)}
            m = _make(kinds[g], ref, g, lh.address(), state, incs[g])
            built.wait(30)
            for _ in range(2):
                assert _step(m, g, state, logs[g])
            assert left.wait(30)
            for _ in range(2):
                assert _step(m, g, state, logs[g])
            phase2.wait(30)
            assert rejoined.wait(30)
            for _ in range(3):
                assert _step(m, g, state, logs[g])
            finals[g] = state["w"].tobytes()
        except BaseException as e:  # noqa: BLE001 - re-raised by the test
            errors.append(e)
            built.abort()
            phase2.abort()
        finally:
            if m is not None:
                m.shutdown()

    def leaver() -> None:
        m = None
        try:
            state = {"w": np.zeros(200, np.float32)}
            m = _make(kinds[2], ref, 2, lh.address(), state, incs[2])
            built.wait(30)
            for _ in range(2):
                assert _step(m, 2, state, logs[2])
            m.begin_drain()
            deadline = time.monotonic() + 20
            while m.replica_id() not in list(jax_lh.status().draining):
                assert time.monotonic() < deadline, "the drain notice never landed"
                time.sleep(0.02)
            assert m.drain_requested()
            m.complete_drain()
        except BaseException as e:  # noqa: BLE001 - re-raised by the test
            errors.append(e)
            built.abort()
        finally:
            if m is not None:
                m.shutdown()
            left.set()

    def rejoiner() -> None:
        m = None
        try:
            phase2.wait(60)
            state = {"w": np.zeros(200, np.float32)}
            m = _make(kinds[2], ref, 2, lh.address(), state, incs[2])
            # The rejoiner asks first, so the survivors' next quorum holds it.
            m.start_quorum()
            time.sleep(0.5)
            rejoined.set()
            m.wait_quorum()
            first = True
            for _ in range(3):
                if not first:
                    m.start_quorum()
                first = False
                m.wait_quorum()
                step = m.current_step()
                lc = m.collective().last_configure
                avg = np.asarray(m.allreduce(_grad(2, step)).result(), dtype=np.float32)
                ok = m.should_commit()
                assert ok
                state["w"] = state["w"] - np.float32(0.1) * avg
                plan = m.elastic_plan()
                logs["2b"].append({"step": step, "ok": ok, "participants": m.num_participants(),
                                   "prank": m.participating_rank(), "avg": avg.tobytes(),
                                   "cfg": (lc["mode"], lc["reused_lanes"], lc["opened_lanes"]),
                                   "plan": dict(plan) if plan else None})
            finals["2b"] = state["w"].tobytes()
        except BaseException as e:  # noqa: BLE001 - re-raised by the test
            errors.append(e)
        finally:
            rejoined.set()
            if m is not None:
                m.shutdown()

    threads = [threading.Thread(target=survivor, args=(g,)) for g in (0, 1)]
    threads += [threading.Thread(target=leaver), threading.Thread(target=rejoiner)]
    try:
        for t in threads:
            t.start()
        _join_all(threads, errors)
    finally:
        jax_lh.close()
        lh.shutdown()
    return {"logs": logs, "finals": finals}


def _without_plans(logs: Dict[Any, List[dict]]) -> Dict[Any, List[dict]]:
    return {k: [{f: v for f, v in r.items() if f != "plan"} for r in rs] for k, rs in logs.items()}


@pytest.mark.parametrize("kinds, incs", [
    (["jax", "port", "jax"], [True, True, True]),
    (["jax", "port", "jax"], [True, False, True]),
    (["jax", "port", "jax"], [False, True, False]),
    (["port", "jax", "port"], [True, True, True]),
])
def test_churn_3_2_3_mixed_quorum_equals_all_jax(ref, monkeypatch, kinds, incs) -> None:
    mixed = _churn_run(kinds, incs, ref, monkeypatch)
    want = _churn_run(["jax"] * 3, incs, ref, monkeypatch)
    assert _without_plans(mixed["logs"]) == _without_plans(want["logs"])
    assert mixed["finals"] == want["finals"]
    assert len(set(mixed["finals"].values())) == 1, "the groups ended apart"
    logs = mixed["logs"]
    assert [r["participants"] for r in logs[0]] == [3, 3, 2, 2, 2, 3, 3]
    assert logs["2b"][0]["prank"] is None  # the heal step: it contributes zeros
    if all(incs[:2]):
        # 3 -> 2: the 0 -> 1 edge survives on both ends.
        assert logs[0][2]["cfg"] == ("incremental", 2, 2)
        assert logs[1][2]["cfg"] == ("incremental", 2, 2)
    # The elastic plans: a constant global batch, the survivors' share and
    # microsteps following the participating world.
    for g in (0, 1):
        for rec, kind_ref in zip(logs[g], want["logs"][g]):
            plan = rec["plan"]
            assert plan["global_batch"] == 48
            if kinds[g] == "port":
                n = rec["participants"]
                assert (plan["participants"], plan["group_batch"], plan["accum_steps"]) == (
                    n, 48 // n, -(-(48 // n) // 16))
                if kind_ref["plan"]["participants"] != n:
                    # The JAX Manager kept the heal step's plan (queue 3).
                    assert rec["step"] >= logs["2b"][0]["step"] + 1
                else:
                    assert plan == kind_ref["plan"]
            else:
                assert plan == kind_ref["plan"]


def test_membership_change_event_carries_the_plan(ref, monkeypatch, tmp_path) -> None:
    """The port's ``membership_change`` event carries the refreshed plan (it
    was always null before the elastic engine), and every committed
    ``step_summary`` the plan's four fields."""
    path = tmp_path / "metrics.jsonl"
    monkeypatch.setenv("TPUFT_METRICS_PATH", str(path))
    run = _churn_run(["port", "jax", "port"], [True, True, True], ref, monkeypatch)
    assert len(set(run["finals"].values())) == 1
    events = [json.loads(line) for line in path.read_text().splitlines()]
    port_ids = {e["replica_id"] for e in events if e["event"] == "step_summary"}
    changes = [e for e in events if e["event"] == "membership_change"]
    assert changes and all(e["elastic_plan"]["global_batch"] == 48 for e in changes)
    assert {(len(e["new_participants"]), e["elastic_plan"]["participants"]) for e in changes
            if e["replica_id"].startswith("el0")} >= {(2, 2)}
    summaries = [e for e in events if e["event"] == "step_summary" and e["committed"]]
    assert summaries and port_ids
    for e in summaries:
        assert e["elastic_global_batch"] == 48
        assert e["elastic_group_batch"] * e["elastic_participants"] == 48
    seen = [e["elastic_participants"] for e in summaries if e["replica_id"].startswith("el0")]
    assert [k for k, _ in itertools.groupby(seen)] == [3, 2, 3], seen
