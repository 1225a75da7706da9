"""Shared mechanics of the example trainers: the launcher's environment
contract (with the hot-spare branch), the straggler injection, the Manager
wiring (with the drain watcher), when a train loop is done (a drain among
the exits), and the FINAL digest.  Each example keeps its own train loop
inline.

The counterpart of ``examples/_common.py`` (whose JAX platform pin and
compile cache have no counterpart here).
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from datetime import timedelta
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from torchft_tpu_torch.checkpointing import CollectiveTransport, HTTPTransport
from torchft_tpu_torch.checkpointing.serialization import sharding_restorer
from torchft_tpu_torch.collectives import TCPCollective
from torchft_tpu_torch.manager import Manager


def warm_device(device: Any) -> None:
    """The group-independent start a hot spare pays while idle: the CUDA
    context and every kernel library's load (a no-op on the CPU)."""
    if torch.device(device).type != "cuda":
        return
    from torchft_tpu_torch._build import kernel_lib
    from torchft_tpu_torch.ops import KERNELS

    torch.zeros(1, device=device)
    for source in sorted({k.source for k in KERNELS.values()}):
        kernel_lib(source)


def replica_env(device: Optional[Any] = None) -> Tuple[int, int]:
    """(replica_group, num_replica_groups) from the launcher's env.

    A hot spare (``TPUFT_SPARE_FILE`` set, no ``REPLICA_GROUP_ID``) first
    warms ``device`` (:func:`warm_device`), then blocks until the launcher
    writes its group id into the go-file.  Call this after the rest of the
    group-independent work (the imports, the model's build from its seed),
    so an adoption pays only for the Manager and the rejoin."""
    gid = os.environ.get("REPLICA_GROUP_ID")
    spare = os.environ.get("TPUFT_SPARE_FILE")
    if gid is None and spare:
        if device is not None:
            warm_device(device)
        print(f"[spare] ready (device up), waiting at {spare}", flush=True)
        while not os.path.exists(spare):
            time.sleep(0.05)
        with open(spare) as f:
            gid = f.read().strip()
        os.environ["REPLICA_GROUP_ID"] = gid
        print(f"[spare] adopted replica group {gid}", flush=True)
    return (
        int(gid or 0),
        int(os.environ.get("NUM_REPLICA_GROUPS", 2)),
    )


def maybe_straggle(replica_group: int) -> float:
    """Fault injection of the straggler scenario: where
    ``<TPUFT_STRAGGLE_DIR>/straggle_<group>.json`` names this process's pid,
    the step sleeps its ``sleep_s`` more, a degraded-but-alive host (the
    failure no heartbeat timeout catches).  Call it in the busy part of the
    step, outside every FT span (after the backward, before the averager),
    or the sentinel's busy-time EWMA does not see it.  The notice must name
    a pid: a replacement adopting the group id is a healthy host and does
    not inherit the slowness.  Returns the seconds slept (0: none)."""
    d = os.environ.get("TPUFT_STRAGGLE_DIR")
    if not d:
        return 0.0
    try:
        with open(os.path.join(d, f"straggle_{replica_group}.json"), "r",
                  encoding="utf-8") as f:
            data = json.load(f)
    except (OSError, ValueError):
        return 0.0
    pid = data.get("pid")
    # A pid-less notice would pin the slowness to every incarnation.
    if pid is None or int(pid) != os.getpid():
        return 0.0
    sleep_s = float(data.get("sleep_s", 0.0))
    if sleep_s > 0.0:
        time.sleep(sleep_s)
    return sleep_s


def make_manager(
    save: Callable[[], Any],
    load: Callable[[Any], None],
    replica_group: int,
    *,
    min_replicas: int = 1,
    timeout_s: float = 30.0,
    init_sync: bool = True,
    rank: int = 0,
    world_size: int = 1,
    store_port: Optional[int] = None,
    restore_in_place: bool = False,
    transport: str = "http",
) -> Manager:
    """A replica group's Manager with the examples' wiring: a TCPCollective
    data plane and the HTTP checkpoint transport; a one-process group also
    gets the drain watcher (SIGTERM, the launcher's notice file, the opt-in
    GCE poll), so a planned departure hands off instead of dying.

    Every server of the group (store, manager, ring, checkpoint) listens on
    and is advertised under ``MASTER_ADDR``, the group's store host (the
    launcher sets ``localhost``): peers already reach the store there.
    ``init_sync=False`` skips the step-0 weight sync, for groups that build
    the same weights from one seed.  A group of ``world_size`` local ranks
    (``examples/train_hsdp.py``) gives each its ``rank`` and the
    ``store_port`` rank 0's store binds.  ``restore_in_place`` places what
    a heal fetches on the live state's devices and meshes
    (``serialization.sharding_restorer`` over ``save``).
    ``transport="collective"`` heals over the data plane's send/recv
    (``CollectiveTransport``) instead of HTTP."""
    host = os.environ.get("MASTER_ADDR", "localhost")
    timeout = timedelta(seconds=timeout_s)
    collective = TCPCollective(timeout=timeout_s, host=host)
    if transport == "http":
        checkpoint_transport = HTTPTransport(
            timeout=timeout_s, host=host,
            restore_sharding=sharding_restorer(save) if restore_in_place else None)
    elif transport == "collective":
        checkpoint_transport = CollectiveTransport(
            collective, timeout=timeout_s, state_dict_fn=save if restore_in_place else None)
    else:
        raise ValueError(f"unknown checkpoint transport {transport!r}")
    manager = Manager(
        collective=collective,
        load_state_dict=load,
        state_dict=save,
        min_replica_size=min_replicas,
        timeout=timeout,
        quorum_timeout=timeout,
        rank=rank,
        world_size=world_size,
        replica_id=str(replica_group),
        store_addr=host,
        store_port=store_port,
        manager_bind=f"{host}:0",
        checkpoint_transport=checkpoint_transport,
        init_sync=init_sync,
    )
    if world_size == 1:
        # A drain leaves after the step in flight; ranks that saw the
        # notice at different steps would part on their in-group
        # collectives, so a multi-rank group stops whole instead.
        manager.attach_drain_watcher()
    return manager


class TrainGate:
    """Decides when an example train loop is done.

    - **drain**: a drain notice arrived; leave after the step in flight
      (the launcher has already started a replacement).
    - **merged final** (``require_merged`` > 0): past the step budget, keep
      stepping until a committed step ran with at least that many groups.
      A survivor then steps on alone until a healed replacement merges back,
      so both groups finish the same merged step with the same state.
    - **step budget**: ``current_step() >= steps`` otherwise, with
      ``steps_cap`` bounding a run whose merged criterion is never met.
    """

    def __init__(self, manager: Manager, steps: int, *, require_merged: int = 0,
                 steps_cap: int = 0) -> None:
        self._manager = manager
        self._steps = steps
        self._require_merged = require_merged
        self._steps_cap = steps_cap
        self._last_merged = 0

    def should_continue(self) -> bool:
        if self._manager.drain_requested():
            return False
        step = self._manager.current_step()
        if self._steps_cap and step >= self._steps_cap:
            return False
        if step < self._steps:
            return True
        return self._require_merged > 0 and self._last_merged < self._require_merged

    def note_commit(self, committed: bool) -> None:
        """Records the last step's participation (call once per step)."""
        self._last_merged = self._manager.num_participants() if committed else 0

    def drained(self) -> bool:
        return self._manager.drain_requested()

    def finish(self, replica_group: int) -> bool:
        """The drain epilogue: completes a requested drain and prints the
        exit marker.  True on a drain exit (the caller prints no FINAL: a
        donor's parameters are not the run's result)."""
        if not self.drained():
            return False
        self._manager.complete_drain()
        print(f"[group {replica_group}] DRAIN exit step={self._manager.current_step()}",
              flush=True)
        return True


def params_digest(state_dict: Dict[str, torch.Tensor]) -> str:
    """sha256 over every tensor's bytes, in name order: the cross-group
    convergence evidence each example prints at FINAL."""
    digest = hashlib.sha256()
    for name in sorted(state_dict):
        t = state_dict[name].detach().cpu().contiguous()
        digest.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return digest.hexdigest()
