"""The port's TrainStep options on the CPU: the byte count and the memory
budget of the overlapped commit vote, its automatic choice, and the commit
gate with and without the overlap.  PyTorch updates in place, so a
speculative step copies the parameters and the optimizer state before it
dispatches the update and copies them back on a failed or raising vote:
every such case is held bitwise against the state before the step (AdamW's
``step`` counter included), and a passed vote bitwise against the serial
step.  Three overlapped steps with a failed vote in the middle are held
against the JAX package's TrainStep within test_torch_slice's float32
tolerance."""

from __future__ import annotations

import copy
from types import SimpleNamespace
from unittest.mock import create_autospec

import numpy as np
import pytest
import torch

import torchft_tpu_torch.parallel.trainer as trainer_mod
from torch_port_ref import import_reference
from torchft_tpu_torch.manager import ExceededMaxRetriesError
from torchft_tpu_torch.models import Transformer, TransformerConfig, loss_fn
from torchft_tpu_torch.parallel import TrainStep
from torchft_tpu_torch.parallel.trainer import (device_memory, speculation_fits,
                                                tree_device_bytes)
from torchft_tpu_torch.weights import params_from_jax

TINY = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, n_kv_heads=1, d_ff=64,
            max_seq=16)
ADAMW = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-2)
GB = 1 << 30


class _Group:
    """A stand-in Manager for a group alone in its ring (the averager's
    lone-ring path) with scripted votes: True, False, or an exception to
    raise.  ``on_vote`` runs inside ``should_commit`` before the vote."""

    def __init__(self, votes, participating: bool = True, healing: bool = False,
                 on_vote=None) -> None:
        self.votes = list(votes)
        self.participating = participating
        self.healing = healing
        self.on_vote = on_vote

    def wait_quorum(self) -> None:
        pass

    def errored(self):
        return None

    def collective(self):
        return SimpleNamespace(size=lambda: 1)

    def is_participating(self) -> bool:
        return self.participating

    def is_healing(self) -> bool:
        return self.healing

    def should_commit(self, timeout=None) -> bool:
        if self.on_vote is not None:
            self.on_vote()
        vote = self.votes.pop(0)
        if isinstance(vote, BaseException):
            raise vote
        return vote


def _model(seed: int = 0, **over) -> Transformer:
    cfg = TransformerConfig(**{**TINY, **over}, dtype=torch.float32)
    return Transformer(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))


def _adamw(model: torch.nn.Module) -> torch.optim.AdamW:
    return torch.optim.AdamW(model.parameters(), lr=ADAMW["lr"], betas=(ADAMW["b1"], ADAMW["b2"]),
                             eps=ADAMW["eps"], weight_decay=ADAMW["weight_decay"])


def _batch(seed: int, vocab: int = TINY["vocab_size"], b: int = 2, s: int = TINY["max_seq"]):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (b, s)).astype(np.int32)
    return {"tokens": tokens, "targets": np.roll(tokens, -1, axis=1)}


def _tb(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def _trainer(votes, overlap, seed: int = 0, participating: bool = True, healing: bool = False,
             **kw) -> TrainStep:
    model = _model(seed)
    return TrainStep(model, _adamw(model), loss_fn, _Group(votes, participating, healing),
                     overlap_commit=overlap, **kw)


def _state(step: TrainStep) -> dict:
    """Every parameter and every optimizer state value, copied."""
    out = {f"p.{n}": p.detach().clone() for n, p in step.model.named_parameters()}
    for i, p in enumerate(step.optimizer.param_groups[0]["params"]):
        for k, v in step.optimizer.state.get(p, {}).items():
            out[f"s{i}.{k}"] = v.clone() if torch.is_tensor(v) else copy.deepcopy(v)
    return out


def _assert_state_equal(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        if torch.is_tensor(a[k]):
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


# -- the byte count and the budget ------------------------------------------------------


def test_tree_device_bytes_counts_parameters_and_optimizer_state() -> None:
    step = _trainer([True], overlap=False)
    n = sum(p.numel() for p in step.model.parameters())
    assert tree_device_bytes(step.state_tensors()) == 4 * n  # no AdamW state before a step
    step.full_step(_tb(_batch(0)))
    n_params = len(list(step.model.parameters()))
    # exp_avg and exp_avg_sq a parameter, and the 0-d f32 step counter.
    assert tree_device_bytes(step.state_tensors()) == 3 * 4 * n + 4 * n_params
    assert tree_device_bytes(step.state_tensors(), "cpu") == 3 * 4 * n + 4 * n_params
    # Only what lies on the device asked for counts.
    assert tree_device_bytes(step.state_tensors(), "cuda") == 0
    tree = {"a": torch.zeros(8, 16), "b": [torch.zeros(3, dtype=torch.float64), 7, None],
            "c": (torch.empty(5, device="meta"),)}
    assert tree_device_bytes(tree) == 512 + 24 + 20
    assert tree_device_bytes(tree, "meta") == 20
    assert tree_device_bytes(tree, torch.device("cpu")) == 512 + 24


def _fake_card(monkeypatch, stats, free: int, total: int = 80 * GB) -> None:
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda device=None: stats)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (free, total))


def test_speculation_fits_budget_arithmetic(monkeypatch) -> None:
    card = torch.device("cuda", 0)
    # 10 GB free on the card and 6 GB reserved by this process, all of it
    # allocated: 16 GB this process may hold, 6 GB high water, 9 GB budget.
    stats = {"reserved_bytes.all.current": 6 * GB, "allocated_bytes.all.current": 6 * GB}
    _fake_card(monkeypatch, stats, free=10 * GB)
    assert speculation_fits(8 * GB, card) is True
    assert speculation_fits(10 * GB, card) is False
    mem = device_memory(card)
    assert mem == {"limit": 16 * GB, "high_water": 6 * GB, "free": 10 * GB, "total": 80 * GB,
                   "reserved": 6 * GB}
    # The allocator's peak after the step governs: 16 - 12 = 4 GB, 3.6 GB
    # with the headroom, although only 6 GB are allocated now.
    _fake_card(monkeypatch, dict(stats, **{"allocated_bytes.all.peak": 12 * GB}), free=10 * GB)
    assert speculation_fits(3 * GB, card) is True
    assert speculation_fits(int(3.7 * GB), card) is False
    # Another process on the card (a second replica group) holds most of
    # it: only 2 GB are free, so 8 - 5 = 3 GB, 2.7 GB with the headroom,
    # whatever the card's total.
    _fake_card(monkeypatch, {"reserved_bytes.all.current": 6 * GB,
                             "allocated_bytes.all.current": 4 * GB,
                             "allocated_bytes.all.peak": 5 * GB}, free=2 * GB)
    assert speculation_fits(int(2.6 * GB), card) is True
    assert speculation_fits(3 * GB, card) is False
    # No statistics: undecidable.
    _fake_card(monkeypatch, {}, free=10 * GB)
    assert speculation_fits(1, card) is None
    _fake_card(monkeypatch, {"allocated_bytes.all.current": 1}, free=10 * GB)
    assert speculation_fits(1, card) is None

    def no_stats(device=None):
        raise AssertionError("a CPU device has no allocator statistics to read")

    monkeypatch.setattr(torch.cuda, "memory_stats", no_stats)
    assert speculation_fits(1, torch.device("cpu")) is None
    assert device_memory("cpu") is None


def test_auto_overlap_falls_back_when_memory_is_tight_and_sticks(monkeypatch) -> None:
    step = _trainer([False, True, True], overlap=None)
    assert step.overlap_commit is None and step.bucket_bytes == 25 << 20
    monkeypatch.setattr(trainer_mod, "speculation_fits", lambda extra, dev: False)
    # A failed vote decides nothing: the apply never ran.
    assert step.ft_step(_tb(_batch(0)))[1] is False
    assert step._overlap_resolved is None and step.overlap_decision is None
    assert step.ft_step(_tb(_batch(1)))[1] is True
    assert step._overlap_resolved is False  # the serial step chosen
    assert step.overlap_decision["overlap"] is False
    assert step.overlap_decision["extra_bytes"] == tree_device_bytes(step.state_tensors())
    assert step.averager._bucket_bytes == 25 << 20
    step.ft_step(_tb(_batch(2)))
    assert step.last_speculation is None and step._overlap_resolved is False

    # No statistics (None) keeps the overlap, and the choice is sticky.
    step2 = _trainer([True, True], overlap=None, bucket_bytes=1 << 20)
    monkeypatch.setattr(trainer_mod, "speculation_fits", lambda extra, dev: None)
    step2.ft_step(_tb(_batch(0)))
    assert step2.last_speculation is None  # the first step runs serially
    assert step2._overlap_resolved is True and step2.overlap_decision["fits"] is None
    monkeypatch.setattr(trainer_mod, "speculation_fits", lambda extra, dev: False)
    step2.ft_step(_tb(_batch(1)))
    assert step2._overlap_resolved is True and step2.last_speculation is not None
    assert step2.averager._bucket_bytes == 1 << 20


def test_auto_overlap_on_the_cpu_keeps_the_overlap() -> None:
    step = _trainer([True], overlap=None)
    step.ft_step(_tb(_batch(0)))
    assert step._overlap_resolved is True
    assert step.overlap_decision == {"overlap": True, "fits": None, "device": "cpu",
                                     "extra_bytes": tree_device_bytes(step.state_tensors())}


# -- the commit gate ------------------------------------------------------------------


@pytest.mark.parametrize("overlap", [True, False])
def test_commit_gate(overlap: bool) -> None:
    """Votes fail, pass, fail, pass: a failed vote leaves the parameters and
    the AdamW state bitwise as they were (the first one also leaves no
    state behind), and a passed vote ends bitwise where the serial step
    does."""
    seen = {}
    step = _trainer([False, True, False, True], overlap=overlap)
    ref = _trainer([], overlap=False)
    step.manager.on_vote = lambda: seen.setdefault("changed", []).append(
        not torch.equal(step.model.lm_head, ref.model.lm_head))
    batches = [_tb(_batch(s)) for s in range(4)]
    before = _state(step)
    assert step.ft_step(batches[0])[1] is False
    _assert_state_equal(_state(step), before)
    assert len(step.optimizer.state) == 0
    assert step.ft_step(batches[1])[1] is True
    ref.full_step(batches[1])
    _assert_state_equal(_state(step), _state(ref))
    before = _state(step)
    assert step.ft_step(batches[2])[1] is False
    _assert_state_equal(_state(step), before)
    assert float(next(iter(step.optimizer.state.values()))["step"]) == 1.0
    assert step.ft_step(batches[3])[1] is True
    ref.full_step(batches[3])
    _assert_state_equal(_state(step), _state(ref))
    # The speculative step had applied the update when the vote ran; the
    # serial step had not.
    assert seen["changed"] == ([True] * 4 if overlap else [False, False, False, False])
    if overlap:
        assert step.last_speculation["restored"] is False
        assert step.last_speculation["snapshot_bytes"] == tree_device_bytes(step.state_tensors())
        assert step.snapshot_ms() >= 0.0
    else:
        assert step.last_speculation is None and step.snapshot_ms() is None


def test_a_raising_vote_restores_the_state_then_raises() -> None:
    step = _trainer([True, ExceededMaxRetriesError("exceeded max_retries=2")], overlap=True)
    step.ft_step(_tb(_batch(0)))
    before = _state(step)
    with pytest.raises(ExceededMaxRetriesError):
        step.ft_step(_tb(_batch(1)))
    _assert_state_equal(_state(step), before)
    assert step.last_speculation["restored"] is True


def test_a_failed_speculative_apply_raises() -> None:
    """An error in the dispatched update (an out-of-memory error on the
    card) is not turned into a serial step."""
    step = _trainer([True], overlap=True)

    def broken() -> None:
        raise RuntimeError("CUDA out of memory")

    step.optimizer.step = broken
    with pytest.raises(RuntimeError, match="out of memory"):
        step.ft_step(_tb(_batch(0)))
    assert step.manager.votes == [True]  # it never voted


@pytest.mark.parametrize("participating", [False, True])
def test_a_healing_group_takes_the_serial_step(participating: bool) -> None:
    """A group that heals gets its state inside should_commit; the update
    must follow it, as the donor's does.  A group that re-fetches after
    failed commits heals while it participates."""
    step = _trainer([True], overlap=True, participating=participating, healing=True)
    step._averager = SimpleNamespace(manager=step.manager, allreduce=lambda grads: None)
    healed = _model(seed=5)
    at_vote = {}

    def install() -> None:
        at_vote["untouched"] = all(torch.equal(p, q) for p, q in zip(
            step.model.parameters(), _model(seed=0).parameters()))
        step.model.load_state_dict(healed.state_dict())

    step.manager.on_vote = install
    assert step.ft_step(_tb(_batch(0)))[1] is True
    assert at_vote["untouched"] and step.last_speculation is None
    # The healed weights plus one AdamW step on this step's gradients.
    want_opt = _adamw(healed)
    for p, q in zip(healed.parameters(), step.model.parameters()):
        p.grad = q.grad.clone()
    want_opt.step()
    for (name, p), q in zip(step.model.named_parameters(), healed.parameters()):
        assert torch.equal(p, q), name


# -- against the JAX package --------------------------------------------------------------


def test_three_overlapped_steps_with_a_failed_vote_match_jax() -> None:
    """test_torch_slice's weights and first group's batches, its AdamW and
    its tolerance.  AdamW divides each update by the root of the squared
    gradient's average, so an element whose gradient is float32 noise
    around zero (3.9e-8 against 7.3e-8, PRNGKey 3) can move by more than
    that tolerance after two steps in either framework; the overlapped
    run is also held bitwise against the port's serial run."""
    import datetime

    import jax
    import jax.numpy as jnp
    import optax

    ref = import_reference("torchft_tpu.models.transformer")
    jax_manager = import_reference("torchft_tpu.manager")
    jax_futures = import_reference("torchft_tpu.futures")
    jax_parallel = import_reference("torchft_tpu.parallel")

    cfg = dict(vocab_size=256, d_model=128, n_layers=2, n_heads=2, n_kv_heads=1, d_ff=256,
               max_seq=64)
    votes = [True, False, True]
    rng = np.random.default_rng(100)
    batches = []
    for _ in votes:
        tokens = rng.integers(0, cfg["vocab_size"], (2, cfg["max_seq"])).astype(np.int32)
        batches.append({"tokens": tokens, "targets": np.roll(tokens, -1, axis=1)})
    jcfg = ref.TransformerConfig(**cfg, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, ref.init_params(jax.random.PRNGKey(1), jcfg))

    manager = create_autospec(jax_manager.Manager, instance=True)
    manager.num_participants.return_value = 1
    manager.timeout = datetime.timedelta(seconds=60)
    manager.allreduce.side_effect = lambda arr, should_average=True, **kw: (
        jax_futures.completed_future(np.asarray(arr)))
    manager.should_commit.side_effect = list(votes)
    ftmesh = jax_parallel.ft_init_mesh({"data": 1}, manager=manager)
    tx = optax.adamw(ADAMW["lr"], b1=ADAMW["b1"], b2=ADAMW["b2"], eps=ADAMW["eps"],
                     weight_decay=ADAMW["weight_decay"])
    jstep = jax_parallel.TrainStep(ftmesh, tx, lambda p, b: ref.loss_fn(p, b, jcfg),
                                   overlap_commit=True)
    p = jax.tree.map(jnp.asarray, params)
    opt_state = jstep.init_opt_state(p)
    jcommitted = []
    for b in batches:
        p, opt_state, _, ok = jstep.ft_step(p, opt_state, {k: jnp.asarray(v) for k, v in b.items()})
        jcommitted.append(bool(ok))

    runs = {}
    for overlap in (True, False):
        model = Transformer(TransformerConfig(**cfg, dtype=torch.float32), device="cpu")
        model.load_state_dict(params_from_jax(params))
        step = TrainStep(model, _adamw(model), loss_fn, _Group(votes), overlap_commit=overlap)
        committed = [step.ft_step(_tb(b))[1] for b in batches]
        assert committed == jcommitted == votes
        assert float(next(iter(step.optimizer.state.values()))["step"]) == 2.0
        runs[overlap] = step
    _assert_state_equal(_state(runs[True]), _state(runs[False]))
    want = params_from_jax(jax.tree.map(np.asarray, p))
    start = params_from_jax(params)
    moved = 0.0
    for name, t in runs[True].model.state_dict().items():
        moved = max(moved, float((t - start[name]).abs().max()))
        np.testing.assert_allclose(t.numpy(), want[name].numpy(), rtol=0, atol=5e-5,
                                   err_msg=name)
    assert moved > 1e-3  # the two committed steps moved the weights


def test_two_groups_that_refetch_after_a_failed_vote_match_jax() -> None:
    """Two port groups (a lighthouse, the TCP ring, the HTTP transport) with
    the overlap on: both report an error at the second step, so both votes
    fail, and at the retry both re-fetch each other's state while they
    participate (the quorum's force-recover after failed commits).  That
    step must take the serial update after the fetched state is installed:
    the groups end bitwise equal to each other and, within
    test_torch_slice's tolerance, to two AdamW steps of the JAX package on
    the mean gradients of the first and third batches."""
    import threading
    from datetime import timedelta

    import jax
    import jax.numpy as jnp
    import optax

    from test_torch_slice import CFG, HOST, _batches
    from torchft_tpu_torch import _native
    from torchft_tpu_torch.checkpointing import HTTPTransport
    from torchft_tpu_torch.collectives import TCPCollective
    from torchft_tpu_torch.manager import Manager

    ref = import_reference("torchft_tpu.models.transformer")
    jcfg = ref.TransformerConfig(**CFG, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, ref.init_params(jax.random.PRNGKey(1), jcfg))
    batches = [_batches(0), _batches(1)]
    lh = _native.LighthouseServer(bind=f"{HOST}:0", min_replicas=2, join_timeout_ms=2000,
                                  heartbeat_timeout_ms=5000)
    out, errors = {}, []

    def group(g: int) -> None:
        model = Transformer(TransformerConfig(**CFG, dtype=torch.float32), device="cpu")
        model.load_state_dict(params_from_jax(params))
        opt = _adamw(model)

        def load(sd):
            model.load_state_dict(sd["model"])
            opt.load_state_dict(sd["optim"])

        manager = Manager(
            collective=TCPCollective(timeout=60.0, host=HOST), load_state_dict=load,
            state_dict=lambda: {"model": model.state_dict(), "optim": opt.state_dict()},
            min_replica_size=2, rank=0, world_size=1, replica_id=f"refetch_g{g}",
            lighthouse_addr=lh.address(), store_addr=HOST, manager_bind=f"{HOST}:0",
            checkpoint_transport=HTTPTransport(timeout=60.0, host=HOST),
            timeout=timedelta(seconds=60), quorum_timeout=timedelta(seconds=60),
            init_sync=False)
        at = {"i": 0}

        def planted(m, b):
            loss = loss_fn(m, b)
            if at["i"] == 1:
                manager.report_error(RuntimeError("planted failed vote"))
            return loss

        step = TrainStep(model, opt, planted, manager, overlap_commit=True)
        log = []
        try:
            for i in range(3):
                at["i"] = i
                manager.start_quorum()
                committed = step.ft_step({k: torch.from_numpy(v).long()
                                          for k, v in batches[g][i].items()})[1]
                log.append((committed, manager.num_participants(), manager.is_healing(),
                            step.last_speculation is not None))
            out[g] = (log, {k: v.clone() for k, v in model.state_dict().items()},
                      float(next(iter(opt.state.values()))["step"]))
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)
        finally:
            manager.shutdown()

    threads = [threading.Thread(target=group, args=(g,)) for g in (0, 1)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads), "a replica group hung"
    finally:
        lh.shutdown()
    if errors:
        raise errors[0]
    for g in (0, 1):
        log, _, adam_step = out[g]
        # (committed, participants, healing, speculated): a speculative
        # step, a failed speculative step, a serial step that re-fetched.
        assert log == [(True, 2, False, True), (False, 2, False, True), (True, 2, True, False)]
        assert adam_step == 2.0
    for name, t in out[0][1].items():
        assert torch.equal(t, out[1][1][name]), name

    tx = optax.adamw(ADAMW["lr"], b1=ADAMW["b1"], b2=ADAMW["b2"], eps=ADAMW["eps"],
                     weight_decay=ADAMW["weight_decay"])
    p = jax.tree.map(jnp.asarray, params)
    state = tx.init(p)
    grad = jax.jit(jax.grad(lambda p, b: ref.loss_fn(p, b, jcfg)))
    for s in (0, 2):
        g = [grad(p, {k: jnp.asarray(v) for k, v in batches[grp][s].items()}) for grp in (0, 1)]
        updates, state = tx.update(jax.tree.map(lambda a, b: (a + b) / 2, g[0], g[1]), state, p)
        p = optax.apply_updates(p, updates)
    want = params_from_jax(jax.tree.map(np.asarray, p))
    for name, t in out[0][1].items():
        np.testing.assert_allclose(t.numpy(), want[name].numpy(), rtol=0, atol=5e-5,
                                   err_msg=name)
