"""Deterministic shard -> peer-group placement, rotated per step.

A copy of ``torchft_tpu/ec/placement.py``: shard ``i`` of step ``s`` lives
on participant ``(i + s) mod n``.

Every group derives the SAME placement from the same inputs — the sorted
participant rank list of the quorum and the step being encoded — so the
write side (which shards do I materialize into my own store?) and the read
side (which holder should have shard i?) agree without any coordination
RPC.  The per-step rotation spreads both the storage and the
reconstruction read load across the fleet instead of pinning shard 0's
bytes to the same group forever.

Placement is an OPTIMIZATION hint on the read side: the reconstruction
client probes holders' ``/ec/have/<step>`` inventories anyway, so a stale
membership view degrades to an extra probe, never to a wrong decode.
"""

from __future__ import annotations

from typing import List, Sequence, TypeVar

H = TypeVar("H")

__all__ = ["shard_holder", "shards_for_holder"]


def shard_holder(step: int, idx: int, holders: Sequence[H]) -> H:
    """The holder assigned shard ``idx`` of the step-``step`` generation.
    ``holders`` must be the same sorted sequence on every group (the
    quorum's participant ranks)."""
    if not holders:
        raise ValueError("no holders")
    return holders[(idx + step) % len(holders)]


def shards_for_holder(
    step: int, holder: H, holders: Sequence[H], n_shards: int
) -> List[int]:
    """All shard indices assigned to ``holder`` this step (the write-side
    view: which shards a group materializes into its own store)."""
    return [
        idx
        for idx in range(n_shards)
        if shard_holder(step, idx, holders) == holder
    ]
