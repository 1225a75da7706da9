"""Data sharding across replica groups and local ranks.

The counterpart of ``torchft_tpu/data.py``'s ``DistributedSampler``: the two
parallel dimensions compose into one flat shard index,
``global_rank = rank + num_replicas * replica_group`` over
``num_replicas * num_replica_groups`` shards, and the shuffled order comes
from numpy's ``default_rng(seed + epoch)``, so the port yields the same
index stream as the JAX package for the same arguments.  Sharding is static
per run: a group that leaves takes its shard's remaining samples with it.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

__all__ = ["DistributedSampler"]


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
