"""The port's sharded transformer against the JAX package's, at
train_hsdp's size (d_model 128, 4 heads, 2 layers, vocab 512, seq 64, f32).

Four port ranks, spawned processes over gloo, form a {fsdp 2, tensor 2}
mesh with the JAX ``init_params`` weights carried across (each rank loads
its local shards).  The JAX side runs here, on conftest's 8 virtual CPU
devices, on the same mesh.  Held at rtol 1e-5, atol 1e-6: the sharded
loss and every gathered gradient against JAX's ``loss_fn`` on the mesh and
against the unsharded port model; three SGD ``full_step``s of ``TrainStep``
against JAX's ``TrainStep``.  Also checked in the ranks: no DTensor
reaches a kernel's autograd Function (the flash and fused cross-entropy
Functions, the latter forced on a {fsdp 4} mesh), ``tree_device_bytes``
counts local shards, and an overlapped ``ft_step`` (AdamW, a failed vote)
over DTensor parameters stays bitwise with a serial one."""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_port_ref import import_reference
from torchft_tpu_torch.weights import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(vocab_size=512, d_model=128, n_layers=2, n_heads=4, n_kv_heads=4, d_ff=256,
           max_seq=64)
BATCH, SEQ, LR, SGD_STEPS = 4, 64, 0.1, 3
RANKS = 4
JOIN_S = 240.0
RTOL, ATOL = 1e-5, 1e-6
# Logits are O(1): the row-parallel products' partial sums over "tensor",
# reassociated in f32, land a few 1e-6 off where a logit is near zero.
LOGITS_ATOL = 1e-5

_WORKER = r"""
import os, sys
sys.path.insert(0, os.environ["TPUFT_REPO"])
import torch
import torch.distributed as dist
from types import SimpleNamespace

rank, world, port, data_path, out_path = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                          sys.argv[4], sys.argv[5])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                        world_size=world)
from torch.distributed.tensor import DTensor
import torchft_tpu_torch.models.transformer as tr
from torchft_tpu_torch.ops import attention, cross_entropy
from torchft_tpu_torch.models import Transformer, TransformerConfig, parallelize
from torchft_tpu_torch.parallel import TrainStep, ft_init_mesh
from torchft_tpu_torch.parallel.trainer import tree_device_bytes
from torchft_tpu_torch.weights import load_params

data = torch.load(data_path)
cfg = TransformerConfig(**data["cfg"], dtype=torch.float32)
seen = []

def spy(name, fn):
    def apply(*args):
        seen.append((name, *(type(a).__name__ for a in args if isinstance(a, torch.Tensor))))
        assert not any(isinstance(a, DTensor) for a in args), "a DTensor reached a kernel"
        return fn(*args)
    return apply

attention._Flash.apply = spy("flash", attention._Flash.apply)
cross_entropy._FusedLinearCE.apply = spy("fused_ce", cross_entropy._FusedLinearCE.apply)

def sharded(mesh):
    m = Transformer(cfg, device="cpu")
    parallelize(m, mesh)
    load_params(m, data["params"])
    return m

def mean_over_world(x):
    x = x.detach().clone()
    dist.all_reduce(x)
    return x / world

mesh = ft_init_mesh({"fsdp": 2, "tensor": 2}, device_type="cpu")
shard, shards = mesh.batch_shard()
batch = data["batch"]
mine = {k: v.chunk(shards)[shard] for k, v in batch.items()}
out = {}

# Loss and gradients, sharded and unsharded.
model = sharded(mesh)
loss = model.loss(mine)
loss.backward()
out["loss"] = mean_over_world(loss)
out["grads"] = {n: mesh.full_tensor(p.grad) for n, p in model.named_parameters()}
out["types"] = sorted({type(p).__name__ for p in model.parameters()})
ref = Transformer(cfg, device="cpu")
ref.load_state_dict(data["params"])
ref_loss = ref.loss(batch)
ref_loss.backward()
out["ref_loss"] = ref_loss.detach()
out["ref_grads"] = {n: p.grad for n, p in ref.named_parameters()}

# Logits (the vocab-parallel head gathered over "tensor"), every rank on
# the whole batch.
with torch.no_grad():
    out["logits"] = model(batch["tokens"])
    out["ref_logits"] = ref(batch["tokens"])

# Bytes a rank holds: its local shards.
params = list(model.parameters())
out["local_bytes"] = tree_device_bytes(params)
out["local_numel"] = sum(p.to_local().numel() for p in params)
out["global_bytes"] = sum(p.numel() * p.element_size() for p in params)

# SGD steps of TrainStep.
model = sharded(mesh)
step = TrainStep(model, torch.optim.SGD(model.parameters(), lr=data["lr"]), tr.loss_fn)
out["sgd_losses"] = [mean_over_world(step.full_step(mine)) for _ in range(data["sgd_steps"])]

# The fused cross-entropy Function on a mesh whose ranks hold the whole
# lm head (fsdp only): forced on, its CPU path is the plain twin.
mesh4 = ft_init_mesh({"fsdp": 4}, device_type="cpu")
tr.fused_ce_applicable = lambda h, w: True
s4, n4 = mesh4.batch_shard()
model = sharded(mesh4)
loss4 = model.loss({k: v.chunk(n4)[s4] for k, v in batch.items()})
loss4.backward()
out["fused_loss"] = mean_over_world(loss4)
out["fused_grads"] = {n: mesh4.full_tensor(p.grad) for n, p in model.named_parameters()}
out["seen"] = seen

# The overlapped commit vote over DTensor parameters and AdamW state: a
# stand-in group alone in its ring votes True, False, True.
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
    model = sharded(mesh)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-2)
    ts = TrainStep(model, opt, tr.loss_fn, manager=Group(), overlap_commit=overlap)
    losses, specs = [], []
    for _ in range(3):
        l, committed = ts.ft_step(mine)
        losses.append(l)
        specs.append(ts.last_speculation)
    runs[overlap] = (losses, {n: mesh.full_tensor(p) for n, p in model.named_parameters()},
                     specs)
out["overlap_losses_equal"] = all(torch.equal(a, b) for a, b in zip(runs[True][0], runs[False][0]))
out["overlap_params_equal"] = all(torch.equal(runs[True][1][n], runs[False][1][n])
                                  for n in runs[True][1])
specs = runs[True][2]
out["overlap_restored"] = [s["restored"] for s in specs]
out["overlap_snapshot_bytes"] = specs[-1]["snapshot_bytes"]
if rank == 0:
    torch.save(out, out_path)
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """JAX's loss, gradients and TrainStep losses on {fsdp 2, tensor 2},
    then the port's four ranks on the same weights and batch."""
    ref_model = import_reference("torchft_tpu.models.transformer")
    ref_parallel = import_reference("torchft_tpu.parallel")
    import jax
    import jax.numpy as jnp
    import optax

    jcfg = ref_model.TransformerConfig(**CFG, dtype=jnp.float32)
    params = ref_model.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, CFG["vocab_size"], size=(BATCH, SEQ)).astype(np.int32)
    batch = {"tokens": jnp.asarray(tokens), "targets": jnp.asarray(np.roll(tokens, -1, axis=1))}
    ftmesh = ref_parallel.ft_init_mesh({"fsdp": 2, "tensor": 2})
    sharded = ftmesh.shard_params(params, ref_model.param_axes(jcfg))

    def loss(p, b):
        return ref_model.loss_fn(p, b, jcfg, ftmesh.mesh, ftmesh.rules)

    jloss, jgrads = jax.jit(jax.value_and_grad(loss))(sharded, batch)
    step = ref_parallel.TrainStep(ftmesh, optax.sgd(LR), loss)
    p, opt_state, jlosses = sharded, step.init_opt_state(sharded), []
    for _ in range(SGD_STEPS):
        p, opt_state, l = step.full_step(p, opt_state, batch)
        jlosses.append(float(l))

    host = jax.tree.map(np.asarray, params)
    work = tmp_path_factory.mktemp("hsdp")
    data_path, out_path = str(work / "data.pt"), str(work / "out.pt")
    torch.save({"cfg": CFG, "params": params_from_jax(host), "lr": LR, "sgd_steps": SGD_STEPS,
                "batch": {k: torch.from_numpy(np.array(v)).long() for k, v in batch.items()}},
               data_path)
    port = _free_port()
    env = dict(os.environ, TPUFT_REPO=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), str(RANKS), str(port),
                               data_path, out_path], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(RANKS)]
    outs = []
    try:
        for proc in procs:
            out, _ = proc.communicate(timeout=JOIN_S)
            outs.append(out)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for proc, out in zip(procs, outs):
        assert proc.returncode == 0, out[-4000:]
    return {"port": torch.load(out_path),
            "jax_loss": float(jloss),
            "jax_grads": params_from_jax(jax.tree.map(np.asarray, jgrads)),
            "jax_losses": jlosses}


def _close(got: torch.Tensor, want: torch.Tensor, what: str, atol: float = ATOL) -> None:
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL, atol=atol, err_msg=what)


def test_parameters_are_dtensors(run) -> None:
    assert run["port"]["types"] == ["DTensor"]


def test_sharded_loss_matches_jax_and_unsharded(run) -> None:
    port = run["port"]
    _close(port["loss"], torch.tensor(run["jax_loss"]), "loss vs JAX")
    _close(port["loss"], port["ref_loss"], "loss vs the unsharded port model")


@pytest.mark.parametrize("against", ["jax", "unsharded"])
def test_sharded_gradients_match(run, against) -> None:
    port = run["port"]
    want = run["jax_grads"] if against == "jax" else port["ref_grads"]
    assert set(port["grads"]) == set(want)
    for name, g in port["grads"].items():
        _close(g, want[name], f"{name} vs {against}")


def test_sharded_logits_match_unsharded(run) -> None:
    port = run["port"]
    assert port["logits"].shape == (BATCH, SEQ, CFG["vocab_size"])
    _close(port["logits"], port["ref_logits"], "logits", atol=LOGITS_ATOL)


def test_train_step_sgd_losses_match_jax(run) -> None:
    got = torch.stack(run["port"]["sgd_losses"])
    _close(got, torch.tensor(run["jax_losses"]), "SGD full_step losses")
    assert got[-1] < got[0]


def test_tree_device_bytes_counts_local_shards(run) -> None:
    port = run["port"]
    assert port["local_bytes"] == 4 * port["local_numel"]
    # {fsdp 2, tensor 2}: every parameter is split over fsdp (its embed
    # dim); the weights with a heads, mlp or vocab dim over tensor too.
    assert port["global_bytes"] // 4 < port["local_bytes"] < port["global_bytes"] // 2


def test_no_dtensor_reaches_a_kernel_function(run) -> None:
    seen = run["port"]["seen"]
    assert seen and all("DTensor" not in types for types in seen)
    # Both Functions ran: flash on every path, the fused CE where forced.
    assert {t[0] for t in seen} == {"flash", "fused_ce"}


def test_fused_cross_entropy_on_fsdp_matches_unsharded(run) -> None:
    port = run["port"]
    _close(port["fused_loss"], port["ref_loss"], "fused CE loss on fsdp 4")
    for name, g in port["fused_grads"].items():
        _close(g, port["ref_grads"][name], f"{name} on fsdp 4")


def test_overlapped_ft_step_over_dtensors_is_bitwise_serial(run) -> None:
    port = run["port"]
    assert port["overlap_losses_equal"] and port["overlap_params_equal"]
    assert port["overlap_restored"] == [False, True, False]
    assert port["overlap_snapshot_bytes"] > 0
