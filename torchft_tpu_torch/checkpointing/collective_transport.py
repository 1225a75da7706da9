"""Checkpoint transport over the reconfigurable collective's send and recv.

The counterpart of ``torchft_tpu/checkpointing/collective_transport.py``.
It shares the Manager's data-plane collective, already rendezvoused across
the replica groups each quorum: the pickled header travels first (tag 1),
then each buffer's raw bytes (buffer ``i`` on tag ``3 + i``).  The frame is
the port's own; the header is read with :func:`safe_loads`, so a JAX
package donor's header raises :class:`ForeignFrameError` without importing
``jax``.

Unlike the HTTP transport, whose serving is passive, ``send_checkpoint``
returns only once the healers have taken every buffer: the donor's quorum
waits through the transfer.  A healer receives from the primary donor only
(``serves_all_donors`` is false), and a healer that dies mid-receive costs
the donor its send timeout.  The erasure-coded plane needs a transport that
hosts shards (``attach_shard_store``), which this one does not: with it the
Manager leaves the plane off.
"""

from __future__ import annotations

import logging
import pickle
import time
from contextlib import contextmanager
from typing import Any, Callable, Iterator, List, Optional, Sequence, Union

import numpy as np

from torchft_tpu_torch.checkpointing.serialization import (
    as_u8,
    flatten_state_dict,
    safe_loads,
    sharding_restorer,
    unflatten_state_dict,
)
from torchft_tpu_torch.checkpointing.transport import CheckpointTransport
from torchft_tpu_torch.collectives import Collective

__all__ = ["CollectiveTransport"]

logger = logging.getLogger("torchft_tpu_torch.checkpointing.collective")


@contextmanager
def _timeit(name: str) -> Iterator[None]:
    start = time.perf_counter()
    yield
    logger.info("%s took %.3fs", name, time.perf_counter() - start)


class CollectiveTransport(CheckpointTransport):
    """Streams state dicts between replica ranks over collective send/recv.

    Args:
        collective: the Manager's collective, whose ranks are replica-group
            ranks.
        timeout: the deadline of each send and receive.
        state_dict_fn: when set, ``recv_checkpoint`` restores in place: each
            received tensor lands on the device of its twin in
            ``state_dict_fn()`` (:func:`sharding_restorer`).
    """

    def __init__(self, collective: Collective, timeout: float = 60.0,
                 state_dict_fn: Optional[Callable[[], Any]] = None) -> None:
        self._collective = collective
        self._timeout = timeout
        self._state_dict_fn = state_dict_fn
        # The last receive's bytes and seconds (the heal span carries them).
        self.last_fetch: dict = {}

    def metadata(self) -> str:
        return "<collective>"

    def send_checkpoint(self, dst_ranks: List[int], step: int, state_dict: Any,
                        timeout: float) -> None:
        with _timeit("flatten_state_dict"):
            meta, buffers = flatten_state_dict(state_dict, step=step)
        header = np.frombuffer(pickle.dumps(meta), dtype=np.uint8)
        with _timeit(f"send_checkpoint to {dst_ranks}"):
            works = [self._collective.send(header, dst, tag=1) for dst in dst_ranks]
            for work in works:
                work.wait(timeout=timeout)
            works = []
            for i, buf in enumerate(buffers):
                flat = as_u8(buf)
                for dst in dst_ranks:
                    works.append(self._collective.send(flat, dst, tag=3 + i))
            for work in works:
                work.wait(timeout=timeout)

    def recv_checkpoint(self, src_rank: int, metadata: Union[str, Sequence[str]], step: int,
                        timeout: float) -> Any:
        # A donor list names one primary: a receive has one source.
        t0 = time.monotonic()
        with _timeit(f"recv_checkpoint from {src_rank}"):
            header = self._collective.recv((0,), np.uint8, src_rank, tag=1).wait(timeout=timeout)
            meta = safe_loads(np.asarray(header).tobytes())
            if meta.step != step:
                raise RuntimeError(f"checkpoint step mismatch: wanted {step}, got {meta.step}")
            buffers: List[np.ndarray] = []
            for i, nbytes in enumerate(meta.buffer_nbytes):
                raw = self._collective.recv((nbytes,), np.uint8, src_rank, tag=3 + i).wait(
                    timeout=timeout)
                buffers.append(np.asarray(raw).reshape(-1))
        restore = sharding_restorer(self._state_dict_fn) if self._state_dict_fn else None
        state = unflatten_state_dict(meta, buffers, restore)
        fetch_s = time.monotonic() - t0
        nbytes = sum(meta.buffer_nbytes)
        self.last_fetch = {"bytes": nbytes, "fetch_s": fetch_s, "mode": "collective",
                           "gb_per_s": nbytes / 1e9 / max(fetch_s, 1e-9)}
        return state

    def shutdown(self, wait: bool = True) -> None:
        # The collective belongs to the Manager: nothing to release.
        pass
