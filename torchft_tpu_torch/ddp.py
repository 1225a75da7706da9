"""Gradient averaging across replica groups.

The counterpart of ``torchft_tpu/ddp.py``'s ``GradientAverager`` in its
plain form: the gradients are packed into float32 buckets on their device,
each bucket is copied to pinned host memory and handed to
``Manager.allreduce`` (which averages over the participating groups), and
the averaged values are copied back into the gradients.  All buckets are
issued before the first is awaited, so later buckets' device copies overlap
earlier buckets on the wire.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from torchft_tpu_torch.manager import Manager


def plan_buckets(numels: Sequence[int], bucket_bytes: int) -> List[List[int]]:
    """Groups tensor indices, in order, into buckets of at most
    ``bucket_bytes`` of float32 (a larger tensor gets a bucket of its own)."""
    buckets: List[List[int]] = []
    cur: List[int] = []
    cur_bytes = 0
    for i, n in enumerate(numels):
        if cur and cur_bytes + 4 * n > bucket_bytes:
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += 4 * n
    if cur:
        buckets.append(cur)
    return buckets


class GradientAverager:
    """Coalesced fault-tolerant gradient averaging (25 MB buckets, torch
    DDP's first-bucket size)."""

    def __init__(self, manager: Manager, bucket_bytes: int = 25 << 20) -> None:
        self.manager = manager
        self._bucket_bytes = bucket_bytes

    def allreduce(self, grads: Sequence[torch.Tensor]) -> None:
        """Replaces every tensor of ``grads`` in place by its average across
        the participating replica groups."""
        grads = list(grads)
        futures = []
        for idx in plan_buckets([g.numel() for g in grads], self._bucket_bytes):
            flat = torch.cat([grads[i].reshape(-1).float() for i in idx])
            futures.append((idx, self.manager.allreduce(flat)))
        for idx, fut in futures:
            flat = fut.result()
            pos = 0
            for i in idx:
                g = grads[i]
                g.copy_(flat[pos:pos + g.numel()].view_as(g))
                pos += g.numel()
