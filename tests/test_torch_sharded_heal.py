"""Sharded-state healing end to end: the port's counterpart of
tests/test_sharded_healing.py, on the train_hsdp example's groups.

Two replica groups of two local ranks each ({fsdp 2}, gloo on the CPU)
run under the launcher; group 1 is SIGKILLed mid-run, restarts, and each of
its ranks heals its own DTensor shards live from the same rank of group 0,
over HTTP and over ``CollectiveTransport``.  Asserted: every rank of the
restarted group healed, what it received was DTensors with the survivor's
mesh dim names and placements, both groups end bitwise equal, and no rank
of the killed incarnation outlived it.  Also: a layout that differs from
the live twin's raises, and a disk save and resume per rank ends with an
uninterrupted run's ``params_sha256``."""

from __future__ import annotations

import json
import os
import re
import sys
import time

import pytest
import torch
import torch.distributed as dist

from torchft_tpu_torch.checkpointing.serialization import (
    dtensor_layout,
    flatten_state_dict,
    sharding_restorer,
    unflatten_state_dict,
)
from torchft_tpu_torch.examples.kill_heal import _Tail, kill_and_heal, stop_and_resume
from torchft_tpu_torch.launch import Launcher
from torchft_tpu_torch.models import TransformerConfig, param_axes
from torchft_tpu_torch.parallel import ShardingRules

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HSDP = ["--devices", "2", "--fsdp", "2", "--tensor", "1"]
ENV = {"OMP_NUM_THREADS": "1"}
DEMO = TransformerConfig(vocab_size=512, d_model=128, n_layers=2, n_heads=4, n_kv_heads=4,
                         d_ff=256, max_seq=64)
_HEALED = re.compile(r"\[group 1 rank (\d+)\] healed step=(\d+) .* layouts=(\{.*\})")


def _want_layouts() -> dict:
    """Each parameter's layout on a {fsdp 2, tensor 1} mesh, as
    ``dtensor_layout`` records it."""
    rules, names = ShardingRules(), ("fsdp", "tensor")
    out = {}
    shapes = {"embed.weight": (512, 128), "final_norm": (128,), "lm_head": (128, 512)}
    per_layer = {"attn_norm": (128,), "mlp_norm": (128,), "wq.weight": (128, 128),
                 "wk.weight": (128, 128), "wv.weight": (128, 128), "wo.weight": (128, 128),
                 "w_gate.weight": (256, 128), "w_up.weight": (256, 128),
                 "w_down.weight": (128, 256)}
    for i in range(DEMO.n_layers):
        shapes.update({f"layers.{i}.{k}": v for k, v in per_layer.items()})
    for name, axes in param_axes(DEMO).items():
        spec = rules.spec(axes, names)
        placements = [["shard", spec.index(a)] if a in spec else ["replicate"] for a in names]
        out[name] = [list(names), [2, 1], placements, list(shapes[name])]
    return out


@pytest.fixture(scope="module", params=["http", "collective"])
def healed(request, tmp_path_factory):
    log_dir = str(tmp_path_factory.mktemp(f"heal_{request.param}"))
    r = kill_and_heal("cpu", log_dir, steps=30, merged_before_kill=3, timeout_s=150.0,
                      env=ENV, example="train_hsdp",
                      args=[*HSDP, "--transport", request.param])
    tail = _Tail(os.path.join(log_dir, "g1.log"))
    tail.poll()
    r["healed_lines"] = [m.groups() for _, line in tail.lines for m in [_HEALED.search(line)]
                         if m]
    r["transport"] = request.param
    return r


def test_every_rank_of_the_restarted_group_healed(healed) -> None:
    after_kill = [(int(rank), int(step)) for rank, step, _ in healed["healed_lines"]
                  if int(step) > 0]
    assert sorted({rank for rank, _ in after_kill}) == [0, 1], healed["healed_lines"]


def test_healed_dtensors_carry_the_survivors_layout(healed) -> None:
    want = _want_layouts()
    lines = [json.loads(layouts) for _, step, layouts in healed["healed_lines"] if int(step) > 0]
    assert lines
    for layouts in lines:
        assert layouts == want


def test_groups_end_bitwise_equal(healed) -> None:
    # kill_and_heal raised unless both FINAL lines carry one step and one
    # params_sha256 over the gathered parameters.
    assert healed["restarts"] == [0, 1]
    assert re.fullmatch(r"[0-9a-f]{64}", healed["params_sha256"])


def test_sigkill_leaves_no_orphan_rank(healed) -> None:
    # kill_and_heal raised if any of these outlived the kill by 5 s.
    assert len(healed["killed_rank_pids"]) == 2


@pytest.fixture
def fake_world():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=1, world_size=2)
    yield
    dist.destroy_process_group()


def test_mismatched_layout_raises(fake_world) -> None:
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from torchft_tpu_torch.parallel import ft_init_mesh

    mesh = ft_init_mesh({"fsdp": 2}, device_type="cpu").mesh
    full = torch.arange(8.0).reshape(4, 2)

    def dt(placement, t=full):
        local = t.chunk(2)[1] if placement == Shard(0) else t
        return DTensor.from_local(local.clone(), mesh, [placement], run_check=False,
                                  shape=t.shape, stride=t.stride())

    saved = {"w": dt(Shard(0))}
    meta, bufs = flatten_state_dict(saved)
    assert meta.leaves[0][0] == "dtensor"
    assert meta.leaves[0][1][1] == dtensor_layout(saved["w"])
    # The same layout restores a DTensor of the twin's placements.
    got = unflatten_state_dict(meta, bufs, sharding_restorer(lambda: {"w": dt(Shard(0))}))["w"]
    assert isinstance(got, DTensor) and got.placements == (Shard(0),)
    assert torch.equal(got.to_local(), full[2:])
    # Without a restorer: the plain local shard.
    assert type(unflatten_state_dict(meta, bufs)["w"]) is torch.Tensor
    for twin in (dt(Replicate()), full.chunk(2)[1].clone(),
                 dt(Shard(0), torch.zeros(6, 2))):
        with pytest.raises(ValueError, match="layout"):
            unflatten_state_dict(meta, bufs, sharding_restorer(lambda: {"w": twin}))
    plain_meta, plain_bufs = flatten_state_dict({"w": full.chunk(2)[1].clone()})
    with pytest.raises(ValueError, match="layout"):
        unflatten_state_dict(plain_meta, plain_bufs, sharding_restorer(lambda: {"w": dt(Shard(0))}))


def _uninterrupted(log_dir: str, steps: int) -> str:
    """The FINAL params_sha256 of one job of both groups to ``steps``."""
    cmd = [sys.executable, "-m", "torchft_tpu_torch.examples.train_hsdp", "--device", "cpu",
           "--steps", str(steps), *HSDP]
    deadline = time.monotonic() + 150.0
    with Launcher(cmd, num_groups=2, lighthouse="embed", max_restarts=0, min_replicas=2,
                  log_dir=log_dir, env=ENV, cwd=REPO) as launcher:
        while launcher.running():
            launcher.supervise_once()
            assert time.monotonic() < deadline, "the uninterrupted job ran past 150 s"
            time.sleep(0.02)
        launcher.supervise_once()
        assert launcher.all_exited_clean()
    finals = []
    for g in (0, 1):
        tail = _Tail(os.path.join(log_dir, f"g{g}.log"))
        tail.close_writer()
        finals.append(tail.final())
    assert finals[0] == finals[1] and finals[0][0] == steps, finals
    return finals[0][1]


def test_disk_resume_per_rank_equals_an_uninterrupted_run(tmp_path) -> None:
    r = stop_and_resume("cpu", str(tmp_path / "stop"), steps=6, ckpt_every=3, timeout_s=150.0,
                        env=ENV, example="train_hsdp", args=HSDP)
    for g in (0, 1):
        for rank in (0, 1):
            assert os.listdir(os.path.join(r["ckpt_dir"], f"group_{g}", f"rank_{rank}"))
    assert r["resumed"]["params_sha256"] == _uninterrupted(str(tmp_path / "whole"), 12)
