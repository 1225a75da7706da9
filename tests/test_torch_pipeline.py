"""The port's pipeline schedules (``parallel/pipeline.py``) against the JAX
package's, on the CPU in float32: the counterparts of
tests/test_pipeline.py, on spawned ranks over gloo (the
tests/test_torch_hsdp.py pattern), weights carried from the JAX
``init_params`` with ``params_from_jax`` (each stage its slice of the
layers).

Held: the GPipe loss against the dense loss at (stages, microbatches) (2,
2), (2, 4) and (4, 2), rtol 1e-5; the GPipe and 1F1B gradients (every
stage's layers, and the replicated embedding and head, equal on every
stage) against ``jax.grad`` of the dense loss, rtol 2e-4, atol 2e-5; both
schedules on ``{data 2, pipeline 2}``; the refusals (layers that do not
divide over the stages, a mixture-of-experts config, a model not cut to
its stage); the stage inputs a rank holds at once, counted from the
schedule's own bookkeeping (1F1B at most ``min(M, 2 P - 1)``, GPipe all M);
``TrainStep(value_and_grad_fn=)``'s one-of check and three SGD
``full_step``s of 1F1B and of GPipe against the JAX ``TrainStep`` with the
JAX 1F1B; an overlapped ``ft_step`` of 1F1B (a failed vote) bitwise with a
serial one; and the ``train_pipeline`` example's two groups, one SIGKILLed
and healed stage by stage, ending with one ``params_sha256``."""

from __future__ import annotations

import json
import os
import re
import socket
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from torch_port_ref import import_reference
from torchft_tpu_torch.models import Transformer, TransformerConfig
from torchft_tpu_torch.parallel import TrainStep, pipeline_stage
from torchft_tpu_torch.parallel.pipeline import stage_layers
from torchft_tpu_torch.weights import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(vocab_size=128, d_model=64, n_layers=4, n_heads=4, n_kv_heads=4, d_ff=128,
           max_seq=32)
BATCH, SEQ, LR, SGD_STEPS = 8, 16, 0.1, 3
RTOL, ATOL = 2e-4, 2e-5
LOSS_RTOL = 1e-5
JOIN_S = 240.0
# Each spawned mesh and the schedules it runs: (schedule, microbatches).
MESHES = {
    "pipe2": ({"pipeline": 2}, [("gpipe", 2), ("gpipe", 4), ("1f1b", 4), ("gpipe", 8),
                                ("1f1b", 8)]),
    "pipe4": ({"pipeline": 4}, [("gpipe", 2), ("1f1b", 8)]),
    "data2_pipe2": ({"data": 2, "pipeline": 2}, [("gpipe", 2), ("1f1b", 2)]),
}


def _batch():
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, CFG["vocab_size"], size=(BATCH, SEQ)).astype(np.int32)
    return {"tokens": tokens, "targets": np.roll(tokens, -1, axis=1)}


_WORKER = r"""
import json, os, sys
sys.path.insert(0, os.environ["TPUFT_REPO"])
import torch
import torch.distributed as dist
from types import SimpleNamespace

rank, world, port, data_path, out_path, sizes, jobs = (
    int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5],
    json.loads(sys.argv[6]), json.loads(sys.argv[7]))
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                        world_size=world)
from torchft_tpu_torch.models import Transformer, TransformerConfig
from torchft_tpu_torch.parallel import (TrainStep, ft_init_mesh, pipeline_1f1b_value_and_grad,
                                        pipeline_loss_fn, pipeline_stage)
from torchft_tpu_torch.parallel import pipeline as pl
from torchft_tpu_torch.weights import load_params, params_from_jax

data = torch.load(data_path, weights_only=False)
cfg = TransformerConfig(**data["cfg"], dtype=torch.float32, remat=False)
mesh = ft_init_mesh(sizes, device_type="cpu")
shard, shards = mesh.batch_shard()
mine = {k: v.chunk(shards)[shard] for k, v in data["batch"].items()}

def stage_model():
    m = pipeline_stage(Transformer(cfg, device="cpu"), mesh)
    load_params(m, params_from_jax(data["params"], m.stage[2]))
    return m

def global_grads(m):
    lo = m.stage[2].start
    out = {}
    for name, p in m.named_parameters():
        parts = name.split(".")
        if parts[0] == "layers":
            parts[1] = str(lo + int(parts[1]))
        out[".".join(parts)] = p.grad.clone()
    return out

def run(schedule, m, batch, micro):
    if schedule == "gpipe":
        loss = pipeline_loss_fn(m, batch, mesh, num_microbatches=micro)
        loss.backward()
        return loss.detach()
    return pipeline_1f1b_value_and_grad(m, batch, mesh, num_microbatches=micro)

out = {"jobs": {}}
for schedule, micro in jobs:
    m = stage_model()
    loss = run(schedule, m, mine, micro)
    out["jobs"][f"{schedule}_{micro}"] = {"loss": loss, "grads": global_grads(m),
                                          "schedule": dict(pl.last_schedule)}

if sizes == {"pipeline": 2}:
    # Three SGD full_steps of each schedule through TrainStep.
    for schedule in ("1f1b", "gpipe"):
        m = stage_model()
        fn = (lambda mm, b: run("1f1b", mm, b, 4)) if schedule == "1f1b" else None
        kw = ({"value_and_grad_fn": fn} if fn else
              {"loss_fn": lambda mm, b: pipeline_loss_fn(mm, b, mesh, num_microbatches=4)})
        step = TrainStep(m, torch.optim.SGD(m.parameters(), lr=data["lr"]), **kw)
        out[f"sgd_{schedule}"] = [step.full_step(mine) for _ in range(data["sgd_steps"])]

    # An overlapped ft_step of 1F1B: a stand-in group alone in its ring
    # votes True, False, True; bitwise with the serial step.
    class Group:
        def __init__(self):
            self.votes = [True, False, True]
        wait_quorum = lambda self: None
        errored = lambda self: None
        collective = lambda self: SimpleNamespace(size=lambda: 1)
        is_participating = lambda self: True
        is_healing = lambda self: False
        def should_commit(self, timeout=None):
            return self.votes.pop(0)

    runs = {}
    for overlap in (True, False):
        m = stage_model()
        opt = torch.optim.AdamW(m.parameters(), lr=1e-2)
        ts = TrainStep(m, opt, manager=Group(), overlap_commit=overlap,
                       value_and_grad_fn=lambda mm, b: run("1f1b", mm, b, 2))
        losses, restored = [], []
        for _ in range(3):
            l, committed = ts.ft_step(mine)
            losses.append(l)
            restored.append(ts.last_speculation["restored"] if ts.last_speculation else None)
        runs[overlap] = (losses, {n: p.detach().clone() for n, p in m.named_parameters()},
                         restored)
    out["overlap_losses_equal"] = all(torch.equal(a, b) for a, b in zip(runs[True][0],
                                                                        runs[False][0]))
    out["overlap_params_equal"] = all(torch.equal(runs[True][1][n], runs[False][1][n])
                                      for n in runs[True][1])
    out["overlap_restored"] = runs[True][2]

every = [None] * world
dist.all_gather_object(every, (mesh.coordinate("pipeline"), mesh.coordinate("data"), out))
if rank == 0:
    torch.save(every, out_path)
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's dense loss and gradients and its TrainStep under the 1F1B
    schedule, then every mesh's port ranks on the same weights and batch."""
    ref_model = import_reference("torchft_tpu.models.transformer")
    ref_parallel = import_reference("torchft_tpu.parallel")
    ref_pipeline = import_reference("torchft_tpu.parallel.pipeline")
    import jax
    import jax.numpy as jnp
    import optax

    jcfg = ref_model.TransformerConfig(**CFG, dtype=jnp.float32, remat=False)
    params = ref_model.init_params(jax.random.PRNGKey(0), jcfg)
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    jloss, jgrads = jax.value_and_grad(lambda p: ref_model.loss_fn(p, batch, jcfg))(params)
    host = jax.tree.map(np.asarray, params)  # before the train step donates the buffers
    ftmesh = ref_parallel.ft_init_mesh({"pipeline": 2})
    sharded = ftmesh.shard_params(params, ref_model.param_axes(jcfg))
    step = ref_parallel.TrainStep(
        ftmesh, optax.sgd(LR), value_and_grad_fn=lambda p, b: (
            ref_pipeline.pipeline_1f1b_value_and_grad(p, b, jcfg, ftmesh.mesh,
                                                      num_microbatches=4)))
    p, opt_state, jlosses = sharded, step.init_opt_state(sharded), []
    for _ in range(SGD_STEPS):
        p, opt_state, l = step.full_step(p, opt_state, batch)
        jlosses.append(float(l))

    work = tmp_path_factory.mktemp("pipeline")
    data_path = str(work / "data.pt")
    torch.save({"cfg": CFG, "params": host, "lr": LR, "sgd_steps": SGD_STEPS,
                "batch": {k: torch.from_numpy(np.array(v)).long() for k, v in batch.items()}},
               data_path)
    out = {"jax_loss": float(jloss), "jax_grads": params_from_jax(jax.tree.map(np.asarray, jgrads)),
           "jax_sgd_losses": jlosses}
    for name, (sizes, jobs) in MESHES.items():
        world = int(np.prod(list(sizes.values())))
        out_path = str(work / f"{name}.pt")
        port = _free_port()
        env = dict(os.environ, TPUFT_REPO=REPO, OMP_NUM_THREADS="1")
        procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), str(world), str(port),
                                   data_path, out_path, json.dumps(sizes), json.dumps(jobs)],
                                  env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True)
                 for r in range(world)]
        outs = []
        try:
            for proc in procs:
                outs.append(proc.communicate(timeout=JOIN_S)[0])
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        for proc, text in zip(procs, outs):
            assert proc.returncode == 0, text[-4000:]
        out[name] = torch.load(out_path, weights_only=False)
    return out


def _ranks(runs, mesh_name, data: int = 0) -> list:
    """Each stage's results on data rank ``data``, in stage order."""
    return [o for s, d, o in sorted(runs[mesh_name], key=lambda r: r[0]) if d == data]


def _whole_grads(runs, mesh_name, job, data: int = 0) -> dict:
    """The model's gradients from its stages: each stage's layers, and the
    replicated parameters, asserted equal on every stage."""
    stages = _ranks(runs, mesh_name, data)
    out = {}
    for o in stages:
        for name, g in o["jobs"][job]["grads"].items():
            if name in out:
                assert torch.equal(out[name], g), f"{name} differs between stages"
            out[name] = g
    return out


@pytest.mark.parametrize("mesh_name,micro", [("pipe2", 2), ("pipe2", 4), ("pipe4", 2)])
def test_gpipe_loss_matches_dense(runs, mesh_name, micro) -> None:
    for o in _ranks(runs, mesh_name):
        np.testing.assert_allclose(float(o["jobs"][f"gpipe_{micro}"]["loss"]), runs["jax_loss"],
                                   rtol=LOSS_RTOL)


@pytest.mark.parametrize("mesh_name,job", [("pipe2", "gpipe_4"), ("pipe2", "1f1b_4"),
                                           ("pipe4", "gpipe_2"), ("pipe4", "1f1b_8")])
def test_schedule_grads_match_jax(runs, mesh_name, job) -> None:
    grads = _whole_grads(runs, mesh_name, job)
    assert set(grads) == set(runs["jax_grads"])
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), runs["jax_grads"][name].numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=f"{mesh_name} {job} {name}")
    if job.startswith("1f1b"):
        for o in _ranks(runs, mesh_name):
            np.testing.assert_allclose(float(o["jobs"][job]["loss"]), runs["jax_loss"],
                                       rtol=LOSS_RTOL)


@pytest.mark.parametrize("job", ["gpipe_2", "1f1b_2"])
def test_schedules_compose_with_data_parallel(runs, job) -> None:
    for data in (0, 1):
        for o in _ranks(runs, "data2_pipe2", data):
            np.testing.assert_allclose(float(o["jobs"][job]["loss"]), runs["jax_loss"],
                                       rtol=LOSS_RTOL)
        grads = _whole_grads(runs, "data2_pipe2", job, data)
        for name, g in grads.items():
            np.testing.assert_allclose(g.numpy(), runs["jax_grads"][name].numpy(), rtol=RTOL,
                                       atol=ATOL, err_msg=f"data {data} {job} {name}")


@pytest.mark.parametrize("mesh_name,micro", [("pipe2", 8), ("pipe4", 8)])
def test_1f1b_holds_at_most_the_ring(runs, mesh_name, micro) -> None:
    P = MESHES[mesh_name][0]["pipeline"]
    for s, o in enumerate(_ranks(runs, mesh_name)):
        held = o["jobs"][f"1f1b_{micro}"]["schedule"]
        assert held["ring"] == min(micro, 2 * P - 1)
        # Stage s holds 2 (P - 1 - s) + 1 microbatches at most.
        assert held["max_held"] == min(micro, 2 * (P - 1 - s) + 1) <= held["ring"]
        assert held["head_calls"] == (micro if s == P - 1 else 0)


@pytest.mark.parametrize("micro", [2, 4, 8])
def test_gpipe_holds_every_microbatch(runs, micro) -> None:
    for s, o in enumerate(_ranks(runs, "pipe2")):
        held = o["jobs"][f"gpipe_{micro}"]["schedule"]
        assert held["max_held"] == micro
        assert held["head_calls"] == (1 if s == 1 else 0)


@pytest.mark.parametrize("schedule", ["1f1b", "gpipe"])
def test_train_step_sgd_losses_match_jax(runs, schedule) -> None:
    for o in _ranks(runs, "pipe2"):
        got = torch.stack(o[f"sgd_{schedule}"])
        np.testing.assert_allclose(got.numpy(), np.array(runs["jax_sgd_losses"]),
                                   rtol=LOSS_RTOL, atol=1e-6)
        assert got[-1] < got[0]


def test_overlapped_1f1b_ft_step_is_bitwise_serial(runs) -> None:
    for o in _ranks(runs, "pipe2"):
        assert o["overlap_losses_equal"] and o["overlap_params_equal"]
        assert o["overlap_restored"] == [False, True, False]


def test_train_step_needs_exactly_one_loss() -> None:
    model = torch.nn.Linear(2, 2)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    with pytest.raises(ValueError, match="exactly one"):
        TrainStep(model, opt)
    with pytest.raises(ValueError, match="exactly one"):
        TrainStep(model, opt, lambda m, b: m(b).sum(), value_and_grad_fn=lambda m, b: 0)
    calls = []

    def value_and_grad(m, b):
        loss = m(b).sum()
        loss.backward()
        calls.append(loss)
        return loss

    step = TrainStep(model, opt, value_and_grad_fn=value_and_grad)
    before = model.weight.detach().clone()
    loss = step.full_step(torch.ones(3, 2))
    assert calls and not loss.requires_grad
    assert not torch.equal(model.weight, before)


def _mesh(stages: int, stage: int = 0):
    return SimpleNamespace(size=lambda a: stages if a == "pipeline" else 1,
                           coordinate=lambda a: stage if a == "pipeline" else 0)


@pytest.mark.parametrize("what", ["indivisible", "moe"])
def test_pipeline_refusals(what) -> None:
    kw = dict(CFG, dtype=torch.float32)
    if what == "indivisible":
        kw["n_layers"] = 3
        match = "not divisible"
    else:
        kw["moe_experts"] = 4
        match = "dense configs only"
    with pytest.raises(ValueError, match=match):
        pipeline_stage(Transformer(TransformerConfig(**kw), device="cpu"), _mesh(2))


def test_pipeline_stage_keeps_its_layers() -> None:
    model = Transformer(TransformerConfig(**CFG, dtype=torch.float32), device="cpu")
    third = model.layers[3]
    pipeline_stage(model, _mesh(2, 1))
    assert list(model.stage[2]) == [2, 3] == list(stage_layers(4, 1, 2))
    assert len(model.layers) == 2 and model.layers[1] is third
    names = {n.split(".")[0] for n, _ in model.named_parameters()}
    assert names == {"embed", "layers", "final_norm", "lm_head"}


def test_params_from_jax_carries_a_stage() -> None:
    rng = np.random.default_rng(0)
    L, E, F, V = 4, 8, 16, 32
    tree = {"embed": rng.standard_normal((V, E)), "final_norm": np.ones(E),
            "lm_head": rng.standard_normal((E, V)),
            "layers": {k: rng.standard_normal(shape) for k, shape in {
                "attn_norm": (L, E), "mlp_norm": (L, E), "wq": (L, E, E), "wk": (L, E, E),
                "wv": (L, E, E), "wo": (L, E, E), "w_gate": (L, E, F), "w_up": (L, E, F),
                "w_down": (L, F, E)}.items()}}
    whole, stage = params_from_jax(tree), params_from_jax(tree, range(2, 4))
    assert {k for k in stage if k.startswith("layers.")} == {
        k for k in whole if k.startswith(("layers.0.", "layers.1."))}
    for name, t in stage.items():
        src = name.replace("layers.0.", "layers.2.").replace("layers.1.", "layers.3.")
        assert torch.equal(t, whole[src]), name


_FINAL = re.compile(r"FINAL step=(\d+) params_sha256=([0-9a-f]+) stages=2 schedule=(\w+)")
_HEALED = re.compile(r"\[group 1 rank (\d+)\] healed step=(\d+) bytes=(\d+) .* layers=(\[.*\])")


@pytest.mark.parametrize("schedule", ["1f1b"])
def test_train_pipeline_kill_and_heal(tmp_path, schedule) -> None:
    """Two groups of {pipeline 2} under the launcher: group 1 SIGKILLed,
    each of its ranks heals its own stage from group 0's same rank, and
    both end with one params_sha256."""
    from torchft_tpu_torch.examples.kill_heal import _Tail, kill_and_heal

    r = kill_and_heal("cpu", str(tmp_path), steps=30, merged_before_kill=3, timeout_s=150.0,
                      env={"OMP_NUM_THREADS": "1"}, example="train_pipeline",
                      args=["--devices", "2", "--pipe", "2", "--schedule", schedule])
    assert r["restarts"] == [0, 1] and len(r["killed_rank_pids"]) == 2
    tails = {}
    for g in (0, 1):
        tails[g] = _Tail(os.path.join(str(tmp_path), f"g{g}.log"))
        tails[g].poll()
    finals = [m.groups() for g in (0, 1) for _, line in tails[g].lines
              for m in [_FINAL.search(line)] if m]
    assert len(finals) == 2 and finals[0] == finals[1] and finals[0][2] == schedule
    healed = {int(m[1]): (int(m[3]), json.loads(m[4])) for _, line in tails[1].lines
              for m in [_HEALED.search(line)] if m and int(m[2]) > 0}
    assert sorted(healed) == [0, 1], tails[1].lines[-20:]
    assert healed[0][1] == [0, 1] and healed[1][1] == [2, 3]
