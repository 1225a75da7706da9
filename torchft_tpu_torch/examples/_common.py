"""Shared mechanics of the example trainers: the launcher's environment
contract, the Manager wiring, when a train loop is done, and the FINAL
digest.  Each example keeps its own train loop inline.

The counterpart of ``examples/_common.py``, without the hot-spare branch,
the drain watcher and the straggler injection.
"""

from __future__ import annotations

import hashlib
import os
from datetime import timedelta
from typing import Any, Callable, Dict, Tuple

import torch

from torchft_tpu_torch.checkpointing import HTTPTransport
from torchft_tpu_torch.collectives import TCPCollective
from torchft_tpu_torch.manager import Manager


def replica_env() -> Tuple[int, int]:
    """(replica_group, num_replica_groups) from the launcher's env."""
    return (
        int(os.environ.get("REPLICA_GROUP_ID", 0)),
        int(os.environ.get("NUM_REPLICA_GROUPS", 2)),
    )


def make_manager(
    save: Callable[[], Any],
    load: Callable[[Any], None],
    replica_group: int,
    *,
    min_replicas: int = 1,
    timeout_s: float = 30.0,
) -> Manager:
    """One-process replica group's Manager with the examples' wiring: a
    TCPCollective data plane and the HTTP checkpoint transport.

    Every server of the group (store, manager, ring, checkpoint) listens on
    and is advertised under ``MASTER_ADDR``, the group's store host (the
    launcher sets ``localhost``): peers already reach the store there."""
    host = os.environ.get("MASTER_ADDR", "localhost")
    timeout = timedelta(seconds=timeout_s)
    return Manager(
        collective=TCPCollective(timeout=timeout_s, host=host),
        load_state_dict=load,
        state_dict=save,
        min_replica_size=min_replicas,
        timeout=timeout,
        quorum_timeout=timeout,
        rank=0,
        world_size=1,
        replica_id=str(replica_group),
        store_addr=host,
        manager_bind=f"{host}:0",
        checkpoint_transport=HTTPTransport(timeout=timeout_s, host=host),
    )


class TrainGate:
    """Decides when an example train loop is done.

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
        step = self._manager.current_step()
        if self._steps_cap and step >= self._steps_cap:
            return False
        if step < self._steps:
            return True
        return self._require_merged > 0 and self._last_merged < self._require_merged

    def note_commit(self, committed: bool) -> None:
        """Records the last step's participation (call once per step)."""
        self._last_merged = self._manager.num_participants() if committed else 0


def params_digest(state_dict: Dict[str, torch.Tensor]) -> str:
    """sha256 over every tensor's bytes, in name order: the cross-group
    convergence evidence each example prints at FINAL."""
    digest = hashlib.sha256()
    for name in sorted(state_dict):
        t = state_dict[name].detach().cpu().contiguous()
        digest.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return digest.hexdigest()
