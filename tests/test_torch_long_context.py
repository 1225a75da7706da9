"""The port's long context (``ops/ring_attention.py``, ``ops/ulysses.py``,
the "sequence" axis, the model's ``attention`` and ``ring_layout``, and
``train_ring``) against the JAX package's, on the CPU in float32.

Port ranks are spawned processes over gloo (the tests/test_torch_pipeline.py
pattern) on three meshes, {data 2, sequence 2}, {sequence 4} and {tensor 2,
sequence 2}; the JAX side runs here on conftest's 8 virtual CPU devices, on
the same meshes.  Inputs come from numpy seeds; the model's weights are the
JAX ``init_params`` tree carried over with ``params_from_jax``.

Held: the ring body (contiguous and zigzag, causal and not) and the
Ulysses body, output and input gradients, against the JAX
``ring_attention_sharded`` / ``ulysses_attention_sharded`` and ``jax.grad``
through them, at the JAX tests' rtol 2e-5 / atol 2e-5; the model's loss
under ring, zigzag and Ulysses against the JAX ``loss_fn`` on the same mesh
at rtol 1e-5 / atol 1e-6 and every gathered gradient against ``jax.grad`` of
it; the zigzag permutations bitwise; both zigzag branches (j < i and j > i)
taken on the ranks of {sequence 4} that take them; a fully masked first
block; Ulysses over {tensor 2, sequence 2} with and without the GQA
broadcast; the divisibility errors with JAX's messages; the flash fallback's
warning; the refusals; and ``train_ring``'s two groups, one SIGKILLed and
healed rank by rank, ending with one ``params_sha256``."""

from __future__ import annotations

import os
import re
import socket
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from torch_port_ref import import_reference
from torchft_tpu_torch.models import Transformer, TransformerConfig, param_axes, parallelize
from torchft_tpu_torch.ops import ring_attention as ra
from torchft_tpu_torch.ops.ulysses import check_heads
from torchft_tpu_torch.weights import load_params, params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(vocab_size=512, d_model=256, n_layers=2, n_heads=2, n_kv_heads=2, d_ff=512,
           max_seq=256)
# {tensor 2, sequence 2}: Ulysses needs the heads of a tensor shard to
# divide over the sequence axis; the kv heads of "gqa_broadcast" do not (1
# a shard), those of "gqa_compressed" do (2 a shard).
TS_CFGS = {"gqa_broadcast": dict(CFG, n_heads=4, n_kv_heads=2),
           "gqa_compressed": dict(CFG, n_heads=8, n_kv_heads=4)}
BODY = (2, 8, 64, 16)  # B, H, S, D: the JAX Ulysses test's shapes
BODY_RTOL = BODY_ATOL = 2e-5
LOSS_RTOL, LOSS_ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 2e-4, 2e-5
JOIN_S = 240.0
MESHES = {
    "data2_seq2": {"data": 2, "sequence": 2},
    "seq4": {"sequence": 4},
    "tensor2_seq2": {"tensor": 2, "sequence": 2},
}
# Each mesh's model runs: (name, config overrides, batch rows, sequence).
MODEL_RUNS = {
    "data2_seq2": [("ring", dict(CFG, attention="ring"), 4, 64),
                   ("zigzag", dict(CFG, attention="ring", ring_layout="zigzag"), 4, 64),
                   ("ulysses", dict(CFG, attention="ulysses"), 4, 64)],
    "seq4": [("zigzag", dict(CFG, attention="ring", ring_layout="zigzag"), 2, 64)],
    "tensor2_seq2": [(name, dict(c, attention="ulysses"), 2, 64) for name, c in TS_CFGS.items()]
    + [("ring_gqa", dict(TS_CFGS["gqa_broadcast"], attention="ring"), 2, 64)],
}
BODY_RUNS = [("ring", True, "contiguous"), ("ring", False, "contiguous"),
             ("ring", True, "zigzag"), ("ring", False, "zigzag"), ("ulysses", True, None)]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _batch(rows: int, seq: int, seed: int):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, CFG["vocab_size"], size=(rows, seq)).astype(np.int32)
    return {"tokens": tokens, "targets": np.roll(tokens, -1, axis=1)}


def _body_inputs(seed: int = 0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(BODY).astype(np.float32) for _ in range(4)]  # q, k, v, g


_WORKER = r"""
import json, os, sys
sys.path.insert(0, os.environ["TPUFT_REPO"])
import torch
import torch.distributed as dist

rank, world, port, data_path, out_path, mesh_name = (
    int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5], sys.argv[6])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                        world_size=world)
import torchft_tpu_torch.models.transformer as tr
from torchft_tpu_torch.data import shard_batch, shard_sequence
from torchft_tpu_torch.models import Transformer, TransformerConfig, parallelize
from torchft_tpu_torch.ops import ring_attention as ra
from torchft_tpu_torch.ops.ulysses import ulysses_attention, ulysses_attention_sharded
from torchft_tpu_torch.parallel import ft_init_mesh
from torchft_tpu_torch.weights import load_params, params_from_jax

data = torch.load(data_path, weights_only=False)
mesh = ft_init_mesh(data["sizes"], device_type="cpu")
seq_rank, n = mesh.coordinate("sequence"), mesh.size("sequence")
out = {"coords": {a: mesh.coordinate(a) for a in data["sizes"]}, "body": {}, "model": {}}

# The ring and Ulysses bodies on this rank's block of the global inputs.
q, k, v, g = (torch.from_numpy(t) for t in data["body"])
for kind, causal, layout in data["body_runs"]:
    calls = []
    real = ra._block_attn
    def counted(*a, real=real):
        calls.append((tuple(a[0].shape), tuple(a[1].shape), a[4], a[5], a[6]))
        return real(*a)
    ra._block_attn = counted
    ins = [ra.local_block(mesh, t).requires_grad_() for t in (q, k, v)]
    if kind == "ring":
        o = ra.ring_attention(*ins, mesh.group("sequence"), causal=causal, layout=layout)
        ra._block_attn = real
        wrapped = ra.ring_attention_sharded(mesh, q, k, v, causal=causal, layout=layout)
    else:
        o = ulysses_attention(*ins, mesh.group("sequence"), causal=causal)
        ra._block_attn = real
        wrapped = ulysses_attention_sharded(mesh, q, k, v, causal=causal)
    o.backward(ra.local_block(mesh, g))
    key = f"{kind}_{causal}_{layout}"
    out["body"][key] = {"out": ra.global_block(mesh, o.detach()), "wrapped": wrapped,
                        "grads": [ra.global_block(mesh, t.grad) for t in ins],
                        "calls": calls}

# The model: this rank's rows over "data", its slice of each sequence.
shard, shards = mesh.batch_shard()
for name, cfg_kw, rows, seq in data["model_runs"]:
    cfg = TransformerConfig(**cfg_kw, dtype=torch.float32)
    batch = data["batches"][name]
    if cfg.ring_layout == "zigzag":
        batch = {k_: ra.to_zigzag(t, n, dim=1) for k_, t in batch.items()}
    mine = {k_: shard_sequence(t[shard_batch(range(rows), 0, 1, shard, shards)], seq_rank, n)
            for k_, t in batch.items()}
    model = parallelize(Transformer(cfg, device="cpu"), mesh)
    load_params(model, params_from_jax(data["params"][name]))
    kv_heads = []
    real_u = tr.ulysses_attention
    def spy(q_, k_, *a, real_u=real_u, **kw):
        kv_heads.append((q_.shape[1], k_.shape[1]))
        return real_u(q_, k_, *a, **kw)
    tr.ulysses_attention = spy
    loss = model.loss(mine)
    loss.backward()
    tr.ulysses_attention = real_u
    group_loss = loss.detach().clone()
    dist.all_reduce(group_loss)
    out["model"][name] = {"loss": loss.detach(), "group_loss": group_loss / world,
                          "grads": {p_: mesh.full_tensor(t.grad)
                                    for p_, t in model.named_parameters()},
                          "kv_heads": kv_heads}

every = [None] * world
dist.all_gather_object(every, out)
if rank == 0:
    torch.save(every, out_path)
dist.destroy_process_group()
"""


def _jax_mesh_runs(ref, sizes: dict, body, params_for, batches) -> dict:
    """The JAX side of one mesh: the bodies' outputs and input gradients, and
    each model run's loss and gradients on the mesh."""
    import jax
    import jax.numpy as jnp

    ref_model, ref_parallel, ref_ring, ref_ulysses = ref
    ftmesh = ref_parallel.ft_init_mesh(sizes)
    names = ftmesh.mesh.axis_names
    axes = dict(batch_axis="data" if "data" in names else None,
                head_axis="tensor" if "tensor" in names else None, seq_axis="sequence")
    out = {"body": {}, "model": {}}
    q, k, v, g = (jnp.asarray(t) for t in body)
    for kind, causal, layout in BODY_RUNS:
        if kind == "ring":
            fn = lambda q_, k_, v_: ref_ring.ring_attention_sharded(  # noqa: E731
                ftmesh.mesh, q_, k_, v_, causal=causal, layout=layout, **axes)
        else:
            fn = lambda q_, k_, v_: ref_ulysses.ulysses_attention_sharded(  # noqa: E731
                ftmesh.mesh, q_, k_, v_, causal=causal, **axes)
        o, vjp = jax.vjp(jax.jit(fn), q, k, v)
        out["body"][f"{kind}_{causal}_{layout}"] = {
            "out": np.asarray(o), "grads": [np.asarray(t) for t in vjp(g)]}
    for name, cfg_kw, _, _ in MODEL_RUNS[_mesh_name(sizes)]:
        jcfg = ref_model.TransformerConfig(**cfg_kw, dtype=jnp.float32)
        params = ftmesh.shard_params(jax.tree.map(jnp.asarray, params_for[name]),
                                     ref_model.param_axes(jcfg))
        batch = {k_: jnp.asarray(t) for k_, t in batches[name].items()}
        if jcfg.ring_layout == "zigzag":
            batch = {k_: ref_ring.to_zigzag(t, sizes["sequence"], axis=1)
                     for k_, t in batch.items()}
        batch = jax.device_put(batch, ftmesh.sharding("batch", "seq"))
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p, b: ref_model.loss_fn(p, b, jcfg, ftmesh.mesh, ftmesh.rules)))(params, batch)
        out["model"][name] = {"loss": float(loss),
                              "grads": params_from_jax(jax.tree.map(np.asarray, grads))}
    return out


def _mesh_name(sizes: dict) -> str:
    return next(k for k, v in MESHES.items() if v == sizes)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax

    ref = (import_reference("torchft_tpu.models.transformer"),
           import_reference("torchft_tpu.parallel"),
           import_reference("torchft_tpu.ops.ring_attention"),
           import_reference("torchft_tpu.ops.ulysses"))
    import jax.numpy as jnp

    body = _body_inputs()
    work = tmp_path_factory.mktemp("long_context")
    out = {}
    for m, (mesh_name, sizes) in enumerate(MESHES.items()):
        params, batches = {}, {}
        for r, (name, cfg_kw, rows, seq) in enumerate(MODEL_RUNS[mesh_name]):
            jcfg = ref[0].TransformerConfig(**cfg_kw, dtype=jnp.float32)
            params[name] = jax.tree.map(np.asarray,
                                        ref[0].init_params(jax.random.PRNGKey(m * 10 + r), jcfg))
            batches[name] = _batch(rows, seq, m * 10 + r)
        jax_out = _jax_mesh_runs(ref, sizes, body, params, batches)
        data_path, out_path = str(work / f"{mesh_name}_in.pt"), str(work / f"{mesh_name}.pt")
        torch.save({"sizes": sizes, "body": body, "body_runs": BODY_RUNS,
                    "model_runs": MODEL_RUNS[mesh_name], "params": params,
                    "batches": {k: {k_: torch.from_numpy(t).long() for k_, t in b.items()}
                                for k, b in batches.items()}}, data_path)
        world = int(np.prod(list(sizes.values())))
        port = _free_port()
        env = dict(os.environ, TPUFT_REPO=REPO, OMP_NUM_THREADS="1")
        procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), str(world), str(port),
                                   data_path, out_path, mesh_name],
                                  env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True)
                 for r in range(world)]
        texts = []
        try:
            for proc in procs:
                texts.append(proc.communicate(timeout=JOIN_S)[0])
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        for proc, text in zip(procs, texts):
            assert proc.returncode == 0, text[-4000:]
        out[mesh_name] = {"jax": jax_out, "port": torch.load(out_path, weights_only=False)}
    return out


BODY_CASES = [(m, f"{kind}_{causal}_{layout}") for m in MESHES
              for kind, causal, layout in BODY_RUNS]


@pytest.mark.parametrize("mesh_name,case", BODY_CASES)
def test_bodies_match_jax(runs, mesh_name, case) -> None:
    """Output and q/k/v gradients of each body (every rank's block
    gathered), and the sharded wrapper's output, against JAX's."""
    want = runs[mesh_name]["jax"]["body"][case]
    for rank, got in enumerate(runs[mesh_name]["port"]):
        body = got["body"][case]
        for what, g in (("out", body["out"]), ("wrapped", body["wrapped"])):
            np.testing.assert_allclose(g.numpy(), want["out"], rtol=BODY_RTOL, atol=BODY_ATOL,
                                       err_msg=f"{mesh_name} {case} rank {rank} {what}")
        for name, g, w in zip("qkv", body["grads"], want["grads"]):
            np.testing.assert_allclose(g.numpy(), w, rtol=BODY_RTOL, atol=BODY_ATOL,
                                       err_msg=f"{mesh_name} {case} rank {rank} d{name}")


MODEL_CASES = [(m, name) for m, rs in MODEL_RUNS.items() for name, *_ in rs]


@pytest.mark.parametrize("mesh_name,name", MODEL_CASES)
def test_model_loss_matches_jax(runs, mesh_name, name) -> None:
    """The loss on every rank (its value averaged over "sequence", then over
    "data") against the JAX ``loss_fn`` on the same mesh; the "sequence"
    ranks of a data rank report one value."""
    want = runs[mesh_name]["jax"]["model"][name]["loss"]
    ranks = runs[mesh_name]["port"]
    for rank, got in enumerate(ranks):
        np.testing.assert_allclose(float(got["model"][name]["group_loss"]), want,
                                   rtol=LOSS_RTOL, atol=LOSS_ATOL, err_msg=f"rank {rank}")
    by_data = {}
    for got in ranks:
        by_data.setdefault(got["coords"].get("data", 0), set()).add(
            float(got["model"][name]["loss"]))
    assert all(len(v) == 1 for v in by_data.values()), by_data


@pytest.mark.parametrize("mesh_name,name", MODEL_CASES)
def test_model_grads_match_jax(runs, mesh_name, name) -> None:
    want = runs[mesh_name]["jax"]["model"][name]["grads"]
    for rank, got in enumerate(runs[mesh_name]["port"]):
        grads = got["model"][name]["grads"]
        assert set(grads) == set(want)
        for p, g in grads.items():
            np.testing.assert_allclose(g.numpy(), want[p].numpy(), rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL, err_msg=f"{name} rank {rank} {p}")


def test_zigzag_takes_both_branches_on_sequence_4(runs) -> None:
    """Over {sequence 4} rank i meets sources j < i and j > i in its later
    rounds: both local chunks against the incoming early chunk ([c] x [c]
    twice), or the late chunk against the incoming pair ([c] x [2c])."""
    c = BODY[2] // 4 // 2
    for got in runs["seq4"]["port"]:
        i = got["coords"]["sequence"]
        later = [(qs[1], ks[1]) for qs, ks, _, _, causal in got["body"]["ring_True_zigzag"]["calls"]
                 if not causal]
        want = [(c, c), (c, c)] * i + [(c, 2 * c)] * (3 - i)
        assert sorted(later) == sorted(want), (i, later)
        if i in (1, 2):
            assert (c, c) in later and (c, 2 * c) in later


def test_ulysses_gqa_broadcast_only_where_needed(runs) -> None:
    """Over {tensor 2, sequence 2}: 2 kv heads (1 a tensor shard) are
    repeated to the q heads before the exchange; 4 (2 a shard) stay
    compressed."""
    for got in runs["tensor2_seq2"]["port"]:
        # A call a layer, and again in the backward's recompute (remat).
        assert got["model"]["gqa_broadcast"]["kv_heads"] == [(2, 2)] * 2 * CFG["n_layers"]
        assert got["model"]["gqa_compressed"]["kv_heads"] == [(4, 2)] * 2 * CFG["n_layers"]


@pytest.mark.parametrize("seq,n", [(8, 1), (16, 2), (64, 4), (96, 3), (256, 8)])
def test_zigzag_permutations_equal_jax(seq, n) -> None:
    ref_ring = import_reference("torchft_tpu.ops.ring_attention")
    perm, inv = ra.zigzag_permutation(seq, n), ra.inverse_zigzag_permutation(seq, n)
    np.testing.assert_array_equal(perm, ref_ring.zigzag_permutation(seq, n))
    np.testing.assert_array_equal(inv, ref_ring.inverse_zigzag_permutation(seq, n))
    assert perm.dtype == ref_ring.zigzag_permutation(seq, n).dtype
    x = torch.arange(2 * seq).reshape(2, seq)
    assert torch.equal(ra.from_zigzag(ra.to_zigzag(x, n, dim=1), n, dim=1), x)
    assert torch.equal(ra.to_zigzag(x, n, dim=1),
                       torch.from_numpy(np.array(ref_ring.to_zigzag(x.numpy(), n, axis=1))))
    with pytest.raises(ValueError, match="divisible by 2\\*n_shards"):
        ra.zigzag_permutation(seq + 1, n)


def test_fully_masked_first_block_gives_no_nan() -> None:
    """A block whose every row is masked (rows above its columns), merged
    first, then a visible block: the port's _block_attn / _merge against
    JAX's, and the output divides by l only where l != 0."""
    ref_ring = import_reference("torchft_tpu.ops.ring_attention")
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, 8, 16)).astype(np.float32) for _ in range(3))
    scale = 0.25

    def run(mod, arr, zeros, full, where):
        acc, m, l = zeros((2, 8, 16)), full((2, 8, 1), -1e30), zeros((2, 8, 1))
        masked = mod._block_attn(arr(q), arr(k), arr(v), scale, 0, 8, True)
        acc, m, l = mod._merge(acc, m, l, *masked)
        first = np.asarray(acc / where(l == 0.0, 1.0, l))
        acc, m, l = mod._merge(acc, m, l, *mod._block_attn(arr(q), arr(k), arr(v), scale, 8, 0,
                                                            True))
        return [np.asarray(t) for t in masked] + [first, np.asarray(acc / l)]

    got = run(ra, torch.from_numpy, lambda s: torch.zeros(s),
              lambda s, x: torch.full(s, x), torch.where)
    want = run(ref_ring, jnp.asarray, jnp.zeros, jnp.full, jnp.where)
    for g, w in zip(got, want):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
    assert (got[2] == 0).all() and (got[3] == 0).all()  # l = 0: the first block saw nothing


def test_divisibility_errors_carry_jax_messages() -> None:
    """Ulysses' two checks, in JAX's order: the "tensor" divisibility first
    (2 kv heads over tensor 4 would floor to 0 a shard), then the heads of a
    shard over the sequence axis."""
    ref_ulysses = import_reference("torchft_tpu.ops.ulysses")
    import jax.numpy as jnp

    ref_parallel = import_reference("torchft_tpu.parallel")
    for sizes, (hq, hkv) in (({"tensor": 4, "sequence": 2}, (8, 2)),
                             ({"sequence": 4}, (2, 2))):
        jmesh = ref_parallel.ft_init_mesh(sizes).mesh
        with pytest.raises(AssertionError) as want:
            ref_ulysses.ulysses_attention_sharded(
                jmesh, jnp.zeros((1, hq, 64, 16)), jnp.zeros((1, hkv, 64, 16)),
                jnp.zeros((1, hkv, 64, 16)), batch_axis=None,
                head_axis="tensor" if "tensor" in sizes else None)
        with pytest.raises(AssertionError, match="divisible") as got:
            check_heads(hq, hkv, sizes.get("tensor", 1), sizes["sequence"])
        assert str(got.value) == str(want.value)


def test_flash_fallback_warns_as_jax() -> None:
    """attention="ring" without a "sequence" axis warns with the JAX text
    and computes flash attention: the loss equals the flash config's."""
    ref_model = import_reference("torchft_tpu.models.transformer")
    import jax
    import jax.numpy as jnp

    small = dict(CFG, n_layers=1)
    jcfg = ref_model.TransformerConfig(**small, dtype=jnp.float32, attention="ring")
    params = ref_model.init_params(jax.random.PRNGKey(0), jcfg)
    batch = _batch(2, 32, 5)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ref_model.loss_fn(params, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    want = [str(w.message) for w in caught if "falling back" in str(w.message)]
    sd = params_from_jax(jax.tree.map(np.asarray, params))
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    losses = {}
    for attention in ("ring", "flash"):
        model = Transformer(TransformerConfig(**small, dtype=torch.float32, attention=attention),
                            device="cpu")
        load_params(model, sd)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            losses[attention] = model.loss(tb)
        got = [str(w.message) for w in caught if "falling back" in str(w.message)]
        assert got == (want[:1] * small["n_layers"] if attention == "ring" else [])
    assert want and torch.equal(losses["ring"], losses["flash"])


@pytest.fixture
def fake_world():
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def init(n: int, rank: int = 0) -> None:
        dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=n)

    yield init
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("what", ["flash", "pipeline"])
def test_refused_compositions_raise(fake_world, what) -> None:
    """Over "sequence" above 1: attention "flash" raises (it would attend
    each rank's slice alone), and the pipeline refuses the axis."""
    from torchft_tpu_torch.parallel import ft_init_mesh, pipeline_stage

    fake_world(4)
    if what == "pipeline":
        mesh = ft_init_mesh({"pipeline": 2, "sequence": 2}, device_type="cpu")
        model = Transformer(TransformerConfig(**CFG, dtype=torch.float32, attention="ring"),
                            device="cpu")
        with pytest.raises(ValueError, match="composes with 'data' only"):
            pipeline_stage(model, mesh)
        return
    mesh = ft_init_mesh({"data": 2, "sequence": 2}, device_type="cpu")
    with pytest.raises(ValueError, match="attends each rank's slice alone"):
        parallelize(Transformer(TransformerConfig(**CFG, dtype=torch.float32), device="cpu"),
                    mesh)


def test_config_asserts_as_jax() -> None:
    with pytest.raises(AssertionError, match="unknown attention backend"):
        TransformerConfig(attention="bogus")
    with pytest.raises(AssertionError, match="unknown ring_layout"):
        TransformerConfig(ring_layout="bogus")
    with pytest.raises(ValueError, match="unknown ring layout"):
        ra.ring_attention(*(torch.zeros(1, 1, 4, 8) for _ in range(3)), None, layout="bogus")
    with pytest.raises(ValueError, match="equal q/k/v shapes"):
        ra.ring_attention(torch.zeros(1, 2, 4, 8), *(torch.zeros(1, 1, 4, 8) for _ in range(2)),
                          None)
    with pytest.raises(ValueError, match="even local sequence length"):
        ra.ring_attention(*(torch.zeros(1, 1, 3, 8) for _ in range(3)), None, layout="zigzag")


def test_exchange_refuses_an_uneven_split(fake_world) -> None:
    import torch.distributed as dist

    from torchft_tpu_torch.parallel.functional import all_to_all

    fake_world(2)
    with pytest.raises(ValueError, match="does not split over 2 ranks"):
        all_to_all(torch.zeros(1, 3, 4, 8), 1, 2, dist.group.WORLD)


def test_ring_config_params_carry_over_unchanged() -> None:
    """A ring or Ulysses config adds no parameter: the JAX tree of a ring
    config is the flash config's, and it loads into the port's ring model
    name for name, unchanged."""
    ref_model = import_reference("torchft_tpu.models.transformer")
    import jax
    import jax.numpy as jnp

    trees = {a: jax.tree.map(np.asarray, ref_model.init_params(
        jax.random.PRNGKey(4), ref_model.TransformerConfig(**CFG, dtype=jnp.float32, attention=a)))
        for a in ("flash", "ring", "ulysses")}
    for a in ("ring", "ulysses"):
        for x, y in zip(jax.tree.leaves(trees[a]), jax.tree.leaves(trees["flash"])):
            np.testing.assert_array_equal(x, y)
    cfg = TransformerConfig(**CFG, dtype=torch.float32, attention="ring", ring_layout="zigzag")
    model = Transformer(cfg, device="cpu")
    sd = params_from_jax(trees["ring"])
    assert set(sd) == {n for n, _ in model.named_parameters()} == set(param_axes(cfg))
    load_params(model, sd)
    for name, p in model.named_parameters():
        assert torch.equal(p.detach(), sd[name]), name


_FINAL = re.compile(r"FINAL step=(\d+) params_sha256=([0-9a-f]+) ring_layout=(\w+)")
_HEALED = re.compile(r"\[group 1 rank (\d+)\] healed step=(\d+) bytes=(\d+) .* sequence=(\d+)")


@pytest.mark.parametrize("layout", ["zigzag", "contiguous"])
def test_train_ring_kill_and_heal(tmp_path, layout) -> None:
    """Two groups of {sequence 2} under the launcher: group 1 SIGKILLed,
    each of its ranks heals its own state from group 0's same rank, and
    both end with one params_sha256."""
    from torchft_tpu_torch.examples.kill_heal import _Tail, kill_and_heal

    r = kill_and_heal("cpu", str(tmp_path), steps=30, merged_before_kill=3, timeout_s=150.0,
                      env={"OMP_NUM_THREADS": "1"}, example="train_ring",
                      args=["--devices", "2", "--sequence", "2", "--layout", layout,
                            "--lr", "1e-2"])
    assert r["restarts"] == [0, 1] and len(r["killed_rank_pids"]) == 2
    tails = {}
    for g in (0, 1):
        tails[g] = _Tail(os.path.join(str(tmp_path), f"g{g}.log"))
        tails[g].poll()
    finals = [m.groups() for g in (0, 1) for _, line in tails[g].lines
              for m in [_FINAL.search(line)] if m]
    assert len(finals) == 2 and finals[0] == finals[1] and finals[0][2] == layout
    healed = {int(m[1]): int(m[4]) for _, line in tails[1].lines
              for m in [_HEALED.search(line)] if m and int(m[2]) > 0}
    assert healed == {0: 0, 1: 1}, tails[1].lines[-20:]

