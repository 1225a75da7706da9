"""The port's ``StatefulDataLoader`` against the JAX package's.

Twins of the loader cases of ``tests/test_wrappers.py`` (a mid-epoch resume
equal to the uninterrupted stream, a state saved at an epoch's end, a
second live iterator refused), and for the same sampler arguments the
port's index batches equal the JAX loader's, bit for bit, across a
mid-epoch save and load, an epoch boundary, and ``drop_last`` on and off.
Sampler seeds and sizes are fixed; the interruption points are drawn from
a seeded numpy generator.
"""

from __future__ import annotations

from typing import List

import numpy as np
import pytest

from torch_port_ref import import_reference
from torchft_tpu_torch.data import DistributedSampler, StatefulDataLoader


@pytest.fixture(scope="module")
def jax_data():
    return import_reference("torchft_tpu.data")


def _loader(mod, n: int, group: int, groups: int, batch: int, seed: int, drop_last: bool,
            sampler_drop_last: bool = True):
    return mod.StatefulDataLoader(
        mod.DistributedSampler(n, group, groups, shuffle=True, seed=seed,
                               drop_last=sampler_drop_last),
        batch_size=batch, drop_last=drop_last)


def _port_mod():
    import torchft_tpu_torch.data as port

    return port


def test_stateful_loader_resumes_mid_epoch() -> None:
    def fresh():
        return StatefulDataLoader(DistributedSampler(64, 0, 2, shuffle=True, seed=3),
                                  batch_size=4)

    ref_loader = fresh()
    ref = [b.tolist() for _ in range(2) for b in ref_loader]
    loader = fresh()
    got = []
    it = iter(loader)
    for _ in range(5):
        got.append(next(it).tolist())
    state = loader.state_dict()
    resumed = fresh()
    resumed.load_state_dict(state)
    for _ in range(2):
        for b in resumed:
            got.append(b.tolist())
    assert got == ref
    assert resumed.state_dict()["batches_yielded"] == 0


def test_stateful_loader_epoch_boundary_state() -> None:
    def fresh():
        return StatefulDataLoader(DistributedSampler(16, 0, 2, shuffle=True, seed=1),
                                  batch_size=4)

    loader = fresh()
    it = iter(loader)
    for _ in range(2):
        next(it)
    state = loader.state_dict()  # one past the end of epoch 0
    resumed = fresh()
    resumed.load_state_dict(state)
    epoch1 = [b.tolist() for b in resumed]
    assert len(epoch1) == 2
    ref_loader = fresh()
    ref = [b.tolist() for _ in range(2) for b in ref_loader]
    assert epoch1 == ref[2:]


def test_stateful_loader_rejects_second_live_iterator() -> None:
    loader = StatefulDataLoader(DistributedSampler(32, 0, 2, shuffle=False), batch_size=4)
    it1 = iter(loader)
    next(it1)
    it2 = iter(loader)
    next(it2)
    with pytest.raises(RuntimeError, match="newer iterator"):
        next(it1)


def test_batch_size_below_one_is_refused() -> None:
    with pytest.raises(ValueError, match="batch_size"):
        StatefulDataLoader(DistributedSampler(8, 0, 1), batch_size=0)


def _run(mod, args: tuple, cut: int, total: int) -> List[np.ndarray]:
    """``total`` batches: ``cut`` from one loader, then the rest from a fresh
    one that loaded its state (a save and load in the middle)."""
    first = _loader(mod, *args)
    out: List[np.ndarray] = []
    it = iter(first)
    while len(out) < cut:
        try:
            out.append(next(it))
        except StopIteration:
            it = iter(first)
    state = first.state_dict()
    second = _loader(mod, *args)
    second.load_state_dict(state)
    while len(out) < total:
        for b in second:
            out.append(b)
            if len(out) == total:
                break
    return out


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("sampler_drop_last", [True, False])
@pytest.mark.parametrize("group", [0, 2])
def test_index_batches_equal_the_jax_loaders_across_save_load_and_epochs(
        jax_data, drop_last, sampler_drop_last, group) -> None:
    # 3 groups over 70 samples: a ragged shard tail (23 or 24 a group) and a
    # ragged last batch (batch 5) with drop_last off.
    args = (70, group, 3, 5, 11, drop_last, sampler_drop_last)
    cuts = np.random.default_rng(1300 + group).integers(1, 12, size=3)
    for cut in [0, 4, 5, *cuts.tolist()]:  # 4 and 5 end or cross epoch 0's last batch
        total = 14
        got = _run(_port_mod(), args, int(cut), total)
        ref = _run(jax_data, args, int(cut), total)
        assert len(got) == len(ref) == total
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype == np.int64
            assert g.tolist() == r.tolist(), (cut, g, r)


def test_state_dicts_equal_the_jax_loaders(jax_data) -> None:
    port = _loader(_port_mod(), 40, 1, 2, 3, 5, True)
    ref = _loader(jax_data, 40, 1, 2, 3, 5, True)
    it_port, it_ref = iter(port), iter(ref)
    for a in it_port:
        assert a.tolist() == next(it_ref).tolist()
        assert port.state_dict() == ref.state_dict()
    with pytest.raises(StopIteration):
        next(it_ref)
    assert port.state_dict() == ref.state_dict() == {"epoch": 1, "batches_yielded": 0}
    for state in ({"epoch": 3, "batches_yielded": 6}, {"epoch": 0, "batches_yielded": 2}):
        port.load_state_dict(state)
        ref.load_state_dict(state)
        assert port.state_dict() == ref.state_dict()
