"""Fragment planning for the streaming semi-sync plane.

The counterpart of ``torchft_tpu/semisync/fragments.py``.  The outer
(DiLoCo) state is partitioned into **fragments**, dtype-homogeneous flat
slices of the parameter list, on the gradient plane's own bucket planner
(:func:`torchft_tpu_torch.ddp.plan_buckets`): leaves grouped by dtype,
packed greedily up to ``fragment_bytes``, a larger leaf alone.  A fragment
is the unit of the background pseudogradient sync (Streaming DiLoCo,
arXiv:2501.18512); a round's fragments go out at staggered inner-step
slots, so each fragment's wire time overlaps the inner steps left.  For
the same leaf shapes and dtypes the plan and its schedule are the JAX
package's, so a JAX group and a port group issue the same ring ops in the
same order.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from torchft_tpu_torch.ddp import plan_buckets

__all__ = [
    "Fragment",
    "FragmentPlan",
    "pack_flat",
    "as_host_tensor",
    "TPUFT_SEMISYNC_FRAGMENT_BYTES_ENV",
    "DEFAULT_FRAGMENT_BYTES",
]

TPUFT_SEMISYNC_FRAGMENT_BYTES_ENV = "TPUFT_SEMISYNC_FRAGMENT_BYTES"
# Smaller than the gradient plane's 25 MB buckets: a round has only
# sync_every slots to hide fragments in, and 4 MB keeps several fragments a
# round while amortizing the ring's framing.
DEFAULT_FRAGMENT_BYTES = 4 << 20


def as_host_tensor(x: Any) -> torch.Tensor:
    """``x`` (a tensor anywhere, or a numpy array) as a CPU tensor: a CUDA
    tensor is copied off the card, a CPU tensor or writable array is
    shared, a read-only array copied."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    arr = np.asarray(x)
    if not (arr.flags.writeable and arr.flags.c_contiguous):
        arr = np.array(arr, copy=True, order="C")
    return torch.from_numpy(arr)


def pack_flat(arrs: Sequence[Any], dtype: torch.dtype) -> torch.Tensor:
    """One flat CPU tensor of ``dtype`` from a leaf list: the packing
    primitive shared by :meth:`Fragment.pack` and the codecs' host paths.
    A single CPU leaf of ``dtype`` comes back as a view of itself."""
    parts = [as_host_tensor(a).reshape(-1) for a in arrs]
    flat = parts[0] if len(parts) == 1 else torch.cat(parts)
    return flat.to(dtype)


def fragment_bytes_from_env(explicit: Any = None) -> int:
    """The fragment size: ``explicit``, else ``TPUFT_SEMISYNC_FRAGMENT_BYTES``,
    else the default; a malformed value falls back to the default."""
    if explicit is not None:
        return max(1, int(explicit))
    try:
        return max(1, int(os.environ.get(TPUFT_SEMISYNC_FRAGMENT_BYTES_ENV,
                                          str(DEFAULT_FRAGMENT_BYTES))))
    except ValueError:
        return DEFAULT_FRAGMENT_BYTES


class Fragment:
    """One flat slice of the outer state: which leaves it packs and where
    each lies in its flat buffer (the shared bucket metadata), and whether
    lossy codecs may touch it (floats of at least 4 bytes: integer and
    sub-f32 fragments always ride full width)."""

    def __init__(self, index: int, bucket: Any) -> None:
        self.index = index
        self.bucket = bucket
        self.numel = bucket.numel
        self.nbytes = bucket.nbytes
        self.dtype: torch.dtype = bucket.dtype
        self.lossy_ok = self.dtype.is_floating_point and self.dtype.itemsize >= 4

    def pack(self, leaves: Sequence[Any]) -> torch.Tensor:
        """This fragment's leaves (picked by index from the whole list) as
        one flat CPU tensor of the fragment's dtype, in bucket layout."""
        return pack_flat([leaves[i] for i in self.bucket.indices], self.dtype)

    def unpack(self, flat: Any) -> List[Tuple[int, torch.Tensor]]:
        """(leaf index, view of ``flat`` in the leaf's shape) per leaf."""
        return self.bucket.views(as_host_tensor(flat).to(self.dtype))


class FragmentPlan:
    """The fragment layout for one leaf signature, and the round's issue
    schedule: fragment f of F is due after inner step
    ``1 + floor(f * sync_every / F)`` (clamped to the round), so the first
    leaves as the round starts and the last still has about
    ``sync_every / F`` inner steps to hide behind.  Every group derives the
    same schedule from (signature, sync_every), which keeps the groups'
    ring ops aligned."""

    def __init__(self, metas: Sequence[Tuple[tuple, torch.dtype]],
                 fragment_bytes: Any = None) -> None:
        self.fragment_bytes = fragment_bytes_from_env(fragment_bytes)
        self.fragments = [Fragment(i, b)
                          for i, b in enumerate(plan_buckets(metas, self.fragment_bytes))]
        self.total_bytes = sum(f.nbytes for f in self.fragments)

    def __len__(self) -> int:
        return len(self.fragments)

    def slot(self, index: int, sync_every: int) -> int:
        """The inner step (1-based) after which fragment ``index`` goes."""
        n = max(1, len(self.fragments))
        return min(sync_every, 1 + (index * sync_every) // n)

    def schedule(self, sync_every: int) -> Dict[int, List[Fragment]]:
        """Inner step -> the fragments due then; each fragment once."""
        by_slot: Dict[int, List[Fragment]] = {}
        for f in self.fragments:
            by_slot.setdefault(self.slot(f.index, sync_every), []).append(f)
        return by_slot
