"""Data sharding across replica groups and local ranks.

The counterpart of ``torchft_tpu/data.py``'s ``DistributedSampler`` and
``StatefulDataLoader``: the two parallel dimensions compose into one flat
shard index, ``global_rank = rank + num_replicas * replica_group`` over
``num_replicas * num_replica_groups`` shards, and the shuffled order comes
from numpy's ``default_rng(seed + epoch)``, so the port yields the same
index stream, and the same index batches, as the JAX package for the same
arguments.  Sharding is static per run: a group that leaves takes its
shard's remaining samples with it.

:func:`shard_batch` splits one batch's indices the same way, for a
group's local ranks (``FTMesh.batch_shard``) or for synthetic streams;
:func:`shard_sequence` splits each sequence of a rank's batch over the
"sequence" axis, as the JAX package's ``ftmesh.sharding("batch", "seq")``
places the "seq" dim.
"""

from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np

__all__ = ["DistributedSampler", "StatefulDataLoader", "shard_batch", "shard_sequence"]


class DistributedSampler:
    """Yields dataset indices for one (replica_group, local rank) shard.

    Args:
        dataset_len: number of samples in the dataset.
        replica_group: which replica group this worker belongs to.
        num_replica_groups: total replica groups in the job.
        rank: local rank within the group (default 0).
        num_replicas: local ranks per group (default 1).
        shuffle: reshuffle each epoch with a deterministic seed.
        seed: base seed of the shuffle.
        drop_last: drop the ragged tail so all shards are equal length;
            otherwise pad it with the first indices.
    """

    def __init__(
        self,
        dataset_len: int,
        replica_group: int,
        num_replica_groups: int,
        rank: int = 0,
        num_replicas: int = 1,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
    ) -> None:
        self.global_rank = rank + num_replicas * replica_group
        self.global_world_size = num_replicas * num_replica_groups
        self.dataset_len = dataset_len
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        if drop_last:
            self.num_samples = dataset_len // self.global_world_size
        else:
            self.num_samples = -(-dataset_len // self.global_world_size)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return self.num_samples

    def __iter__(self) -> Iterator[int]:
        if self.shuffle:
            order = np.random.default_rng(self.seed + self.epoch).permutation(self.dataset_len)
        else:
            order = np.arange(self.dataset_len)
        if self.drop_last:
            # Equal shards: unequal ones would desync lockstep replicas.
            order = order[: self.num_samples * self.global_world_size]
        elif self.dataset_len % self.global_world_size:
            pad = self.global_world_size - self.dataset_len % self.global_world_size
            order = np.concatenate([order, order[:pad]])
        yield from order[self.global_rank :: self.global_world_size].tolist()


class StatefulDataLoader:
    """Checkpointable batch iterator over an indexable dataset.

    Drives a :class:`DistributedSampler` through epochs and yields index
    batches as ``np.ndarray`` (int64); the caller gathers its rows and moves
    them to its device.  ``state_dict`` / ``load_state_dict`` round-trip the
    exact position, ``{"epoch", "batches_yielded"}``: the per-epoch order is
    seeded, so a resume re-derives it and skips the batches already yielded.
    Put ``loader.state_dict()`` in the state a ``ManagedDiskCheckpoint``
    saves, so a job resumed from disk neither replays nor skips data.
    """

    def __init__(self, sampler: DistributedSampler, batch_size: int,
                 drop_last: bool = True) -> None:
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self._sampler = sampler
        self._batch_size = batch_size
        self._drop_last = drop_last
        self._epoch = 0
        self._batches_yielded = 0
        # Bumped by each __iter__: the position lives on the loader (which
        # is what makes it checkpointable), so a second live iterator would
        # interleave with the first and advance it twice.
        self._iter_token = 0

    def _epoch_batches(self) -> int:
        n = len(self._sampler)
        if self._drop_last:
            return n // self._batch_size
        return -(-n // self._batch_size)

    def _roll_if_exhausted(self) -> None:
        # A state saved right after an epoch's last batch (before the
        # iterator's epilogue ran) points one past the end: the next pass is
        # the next epoch, not an empty one.
        if self._batches_yielded >= self._epoch_batches():
            self._epoch += 1
            self._batches_yielded = 0

    def __iter__(self) -> Iterator[np.ndarray]:
        """One epoch of index batches from the current position; at its end
        the position moves to the next epoch."""
        self._iter_token += 1
        token = self._iter_token
        self._roll_if_exhausted()
        self._sampler.set_epoch(self._epoch)
        idx = np.fromiter(self._sampler, dtype=np.int64, count=len(self._sampler))
        batches = self._epoch_batches()
        while self._batches_yielded < batches:
            if self._iter_token != token:
                raise RuntimeError(
                    "a newer iterator was started on this StatefulDataLoader; only one live "
                    "iterator is supported (its position is shared so it can be checkpointed)"
                )
            lo = self._batches_yielded * self._batch_size
            self._batches_yielded += 1
            yield idx[lo:lo + self._batch_size]
        self._epoch += 1
        self._batches_yielded = 0

    def state_dict(self) -> dict:
        return {"epoch": self._epoch, "batches_yielded": self._batches_yielded}

    def load_state_dict(self, state: dict) -> None:
        self._epoch = int(state["epoch"])
        self._batches_yielded = int(state["batches_yielded"])
        self._roll_if_exhausted()


def shard_batch(
    batch_indices: Sequence[int],
    replica_group: int,
    num_replica_groups: int,
    rank: int = 0,
    num_replicas: int = 1,
) -> np.ndarray:
    """Shards a single global batch's indices the same way the sampler shards
    the dataset: every ``num_replicas * num_replica_groups``-th index from
    ``rank + num_replicas * replica_group`` on."""
    global_rank = rank + num_replicas * replica_group
    global_ws = num_replicas * num_replica_groups
    return np.asarray(batch_indices)[global_rank::global_ws]


def shard_sequence(batch, rank: int, count: int):
    """This rank's contiguous slice of the sequence dim (dim 1) of ``batch``
    ([B, S, ...], a numpy array or a torch tensor), the ``rank``-th of
    ``count``: the "sequence" axis's share of a batch whose rows
    :func:`shard_batch` chose.  The sequence must divide evenly."""
    seq = batch.shape[1]
    if seq % count:
        raise ValueError(f"sequence length {seq} does not divide over {count} ranks")
    width = seq // count
    return batch[:, rank * width:(rank + 1) * width]
