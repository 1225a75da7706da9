"""The port's mixture of experts (``models/moe.py`` and the MoE
``Transformer``) against the JAX package's, on the CPU in float32, inputs
and weights from numpy seeds (the transformer's carried with
``params_from_jax``).

Held: ``moe_capacity`` over a grid; ``moe_ffn``'s output and aux against
the JAX ``moe_ffn`` (rtol 2e-4, atol 2e-5) with capacity to spare and where
tokens drop, and against the manual expert mix; the drop tests (8 of 64
kept at ``top_k`` 1; the tied router at ``top_k`` 2, where the lower index
must win as in ``jax.lax.top_k``); the MoE transformer's loss (rtol 1e-5)
and gradients (rtol 2e-4, atol 2e-5) against JAX's ``loss_fn`` and
``jax.grad``; ``param_axes``' MoE entries against the JAX
``PartitionSpec``s; remat bitwise against none; the slot offsets of a
hand-built count tensor over {data 2, sequence 2} against a brute count;
the F-split experts against the unsplit ones.  Spawned gloo ranks on every
mesh of ``CASES`` (over "expert", "tensor" and "sequence", alone and with
"data", "fsdp" or each other; under flash, Ulysses, the contiguous ring and
zigzag) route the group's whole batch: every layer's gate indices equal
JAX's on the same mesh and its kept choices the drop rule's over the
group's tokens in the order they arrive, at capacity 4.0 and at 0.5 (where
tokens drop), before their loss and gathered gradients are held against
``jax.value_and_grad`` of JAX's loss on the same mesh."""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_port_ref import import_reference
from torchft_tpu_torch.models import Transformer, TransformerConfig, moe_capacity, moe_ffn
from torchft_tpu_torch.models.moe import route_top_k
from torchft_tpu_torch.models.transformer import param_axes
from torchft_tpu_torch.parallel import ShardingRules
from torchft_tpu_torch.weights import load_params, params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MOE = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=4, d_ff=128,
           max_seq=64, moe_experts=4, moe_top_k=2)
RTOL, ATOL = 2e-4, 2e-5
LOSS_RTOL = 1e-5
# Capacity to spare, and a factor where tokens drop.
FACTORS = (4.0, 0.5)
# Each sharded case: its mesh and the config's attention.  Over "tensor"
# each rank holds F / 2 of every expert; over "sequence" each routes its
# slice of every sequence in the order the tokens arrive (zigzag's permuted
# one under that ring layout).
ULYSSES, RING = {"attention": "ulysses"}, {"attention": "ring"}
ZIGZAG = {"attention": "ring", "ring_layout": "zigzag"}
CASES = {
    "expert2": ({"expert": 2}, {}),
    "data2_expert2": ({"data": 2, "expert": 2}, {}),
    "fsdp2_expert2": ({"fsdp": 2, "expert": 2}, {}),
    "tensor2": ({"tensor": 2}, {}),
    "expert2_tensor2": ({"expert": 2, "tensor": 2}, {}),
    "seq2_ulysses": ({"sequence": 2}, ULYSSES),
    "seq2_ring": ({"sequence": 2}, RING),
    "seq2_zigzag": ({"sequence": 2}, ZIGZAG),
    "data2_seq2_zigzag": ({"data": 2, "sequence": 2}, ZIGZAG),
    "tensor2_seq2_ulysses": ({"tensor": 2, "sequence": 2}, ULYSSES),
}
BATCH, SEQ = 4, 32
JOIN_S = 240.0


@pytest.fixture(scope="module")
def ref():
    return (import_reference("torchft_tpu.models.moe"),
            import_reference("torchft_tpu.models.transformer"))


def _weights(seed: int = 0, n_exp: int = 4, E: int = 32, F: int = 64):
    rng = np.random.default_rng(seed)

    def s(shape, fan):
        return (rng.standard_normal(shape) * fan ** -0.5).astype(np.float32)

    return s((E, n_exp), E), s((n_exp, E, F), E), s((n_exp, E, F), E), s((n_exp, F, E), F)


def _x(shape, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _jax_moe(ref_moe, x, weights, **kw):
    import jax.numpy as jnp

    y, aux = ref_moe.moe_ffn(jnp.asarray(x), *map(jnp.asarray, weights), dtype=jnp.float32, **kw)
    return np.asarray(y), float(aux)


def _port_moe(x, weights, **kw):
    record = []
    y, aux = moe_ffn(torch.from_numpy(x), *map(torch.from_numpy, weights), dtype=torch.float32,
                     record=record, **kw)
    return y.numpy(), float(aux), record[0]


def _jax_gates(x, router, top_k):
    import jax
    import jax.numpy as jnp

    probs = jax.nn.softmax(jnp.asarray(x).reshape(-1, x.shape[-1]) @ jnp.asarray(router), axis=-1)
    return np.asarray(jax.lax.top_k(probs, top_k)[1])


def kept_by_rule(gate_idx: np.ndarray, n_exp: int, capacity: int) -> np.ndarray:
    """The drop rule over a whole batch, independently of either package:
    every token's choice j takes the next free slot of its expert after all
    tokens' earlier choices and the earlier tokens' choice j."""
    fill = np.zeros(n_exp, np.int64)
    kept = np.zeros(gate_idx.shape, bool)
    for j in range(gate_idx.shape[1]):
        for t in range(gate_idx.shape[0]):
            e = gate_idx[t, j]
            kept[t, j] = fill[e] < capacity
            fill[e] += 1
    return kept


@pytest.mark.parametrize("factor", [0.25, 0.5, 1.0, 1.25, 2.0, 4.0])
def test_moe_capacity_matches_jax(ref, factor) -> None:
    ref_moe = ref[0]
    for tokens in (1, 8, 64, 1000, 8192, 16384):
        for n_exp in (1, 4, 8, 64):
            for k in (1, 2):
                got = moe_capacity(tokens, n_exp, k, factor)
                assert got == ref_moe.moe_capacity(tokens, n_exp, k, factor)
                assert got % 8 == 0 and got >= 8


@pytest.mark.parametrize("factor", [8.0, 0.5])
def test_moe_ffn_matches_jax(ref, factor) -> None:
    weights = _weights()
    x = _x((2, 16, 32))
    y, aux = _jax_moe(ref[0], x, weights, top_k=2, capacity_factor=factor)
    py, paux, rec = _port_moe(x, weights, top_k=2, capacity_factor=factor)
    np.testing.assert_array_equal(rec["gate_idx"].numpy(), _jax_gates(x, weights[0], 2))
    np.testing.assert_array_equal(rec["kept"].numpy(),
                                  kept_by_rule(rec["gate_idx"].numpy(), 4, rec["capacity"]))
    if factor < 1:
        assert not rec["kept"].all()  # tokens drop here
    np.testing.assert_allclose(py, y, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(paux, aux, rtol=RTOL, atol=ATOL)


def test_moe_matches_manual_expert_mix() -> None:
    """With capacity to spare, the output is each token's top-k experts'
    FFNs mixed by the renormalised gates."""
    router, w_gate, w_up, w_down = map(torch.from_numpy, _weights())
    x = torch.from_numpy(_x((2, 8, 32)))
    y, aux = moe_ffn(x, router, w_gate, w_up, w_down, top_k=2, capacity_factor=8.0,
                     dtype=torch.float32)
    assert y.shape == x.shape and torch.isfinite(aux)
    xf = x.reshape(-1, 32)
    gv, gi = route_top_k(torch.softmax(xf @ router, dim=-1), 2)
    gv = gv / gv.sum(-1, keepdim=True)

    def expert(e, t):
        h = torch.nn.functional.silu(xf[t] @ w_gate[e]) * (xf[t] @ w_up[e])
        return h @ w_down[e]

    manual = torch.stack([sum(gv[t, j] * expert(int(gi[t, j]), t) for j in range(2))
                          for t in range(xf.shape[0])])
    np.testing.assert_allclose(y.reshape(-1, 32).numpy(), manual.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("factor", [8.0, 0.5])
def test_moe_route_replays_a_recorded_routing(factor) -> None:
    """``route=``: given its own recorded gate indices a call is bitwise the
    call without; given another router's, it takes those experts and their
    drops, gated by its own router's probabilities at them, and records its
    own router's choice apart."""
    weights = _weights()
    x = _x((2, 16, 32))
    y, aux, rec = _port_moe(x, weights, top_k=2, capacity_factor=factor)
    ry, raux, rrec = _port_moe(x, weights, top_k=2, capacity_factor=factor,
                               route=rec["gate_idx"])
    assert np.array_equal(ry, y) and raux == aux
    assert torch.equal(rrec["own_idx"], rec["gate_idx"])
    other = _weights(seed=5)
    _, _, orec = _port_moe(x, other, top_k=2, capacity_factor=factor)
    assert not torch.equal(orec["gate_idx"], rec["gate_idx"])
    my, _, mrec = _port_moe(x, weights, top_k=2, capacity_factor=factor, route=orec["gate_idx"])
    assert torch.equal(mrec["gate_idx"], orec["gate_idx"])
    assert torch.equal(mrec["kept"], orec["kept"])
    assert torch.equal(mrec["own_idx"], rec["gate_idx"])
    router, w_gate, w_up, w_down = map(torch.from_numpy, weights)
    xf = torch.from_numpy(x).reshape(-1, 32)
    gi = orec["gate_idx"]
    gv = torch.softmax(xf @ router, dim=-1).gather(1, gi)
    gv = gv / gv.sum(-1, keepdim=True) * orec["kept"]
    manual = torch.stack([sum(gv[t, j] * (torch.nn.functional.silu(xf[t] @ w_gate[gi[t, j]])
                                          * (xf[t] @ w_up[gi[t, j]])) @ w_down[gi[t, j]]
                              for j in range(2)) for t in range(xf.shape[0])])
    np.testing.assert_allclose(my.reshape(-1, 32), manual.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_drops_tokens_at_capacity(ref, top_k) -> None:
    """Every token's first choice is expert 0 (the router's only nonzero
    column; the others tie).  At top_k 1, capacity 8: 8 of 64 tokens kept,
    the rest contribute zero.  At top_k 2 the tied second choice goes to
    the lowest index, expert 1, as ``jax.lax.top_k`` has it."""
    weights = list(_weights())
    weights[0] = np.zeros_like(weights[0])
    weights[0][:, 0] = 1.0
    x = np.abs(_x((1, 64, 32))) + 0.1
    y, aux = _jax_moe(ref[0], x, weights, top_k=top_k, capacity_factor=0.25)
    py, paux, rec = _port_moe(x, weights, top_k=top_k, capacity_factor=0.25)
    gates = rec["gate_idx"].numpy()
    np.testing.assert_array_equal(gates, _jax_gates(x, weights[0], top_k))
    assert (gates[:, 0] == 0).all()
    if top_k == 1:
        nonzero = np.count_nonzero(np.abs(py.reshape(64, 32)).sum(-1) > 1e-9)
        assert nonzero == 8 and rec["capacity"] == 8
    else:
        assert (gates[:, 1] == 1).all()
    np.testing.assert_array_equal(rec["kept"].numpy(), kept_by_rule(gates, 4, rec["capacity"]))
    np.testing.assert_allclose(py, y, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(paux, aux, rtol=RTOL, atol=ATOL)


def _batch(seed: int = 0, b: int = BATCH, s: int = SEQ):
    tokens = np.random.default_rng(seed).integers(0, MOE["vocab_size"], (b, s)).astype(np.int32)
    return {"tokens": tokens, "targets": np.roll(tokens, -1, axis=1)}


def _jax_params(ref_tr, factor):
    """The JAX MoE transformer's weights from PRNGKey(0), on the host."""
    import jax
    import jax.numpy as jnp

    cfg = ref_tr.TransformerConfig(**MOE, moe_capacity_factor=factor, dtype=jnp.float32)
    return jax.tree.map(np.asarray, ref_tr.init_params(jax.random.PRNGKey(0), cfg))


def _jax_loss_grads(ref_tr, factor, sizes=None, cfg_kw=MOE):
    """JAX's loss and gradients of the MoE transformer (weights from
    PRNGKey(0)), on one device or on a mesh of ``sizes`` (the batch
    permuted into zigzag order first under that ring layout)."""
    import jax
    import jax.numpy as jnp

    cfg = ref_tr.TransformerConfig(**cfg_kw, moe_capacity_factor=factor, dtype=jnp.float32)
    host = _jax_params(ref_tr, factor)
    params = jax.tree.map(jnp.asarray, host)
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    if sizes is None:
        loss, grads = jax.value_and_grad(lambda p: ref_tr.loss_fn(p, batch, cfg))(params)
    else:
        ref_parallel = import_reference("torchft_tpu.parallel")
        ftmesh = ref_parallel.ft_init_mesh(sizes)
        if cfg.ring_layout == "zigzag":
            ref_ring = import_reference("torchft_tpu.ops.ring_attention")
            batch = {k: ref_ring.to_zigzag(v, sizes["sequence"], axis=1)
                     for k, v in batch.items()}
        sharded = ftmesh.shard_params(params, ref_tr.param_axes(cfg))
        b = jax.device_put(batch, ftmesh.sharding("batch", "seq"))
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: ref_tr.loss_fn(p, b, cfg, ftmesh.mesh, ftmesh.rules)))(sharded)
    return float(loss), params_from_jax(jax.tree.map(np.asarray, grads)), host


def _jax_layer_gates(ref_tr, host, factor, cfg_kw=MOE, n_seq=1):
    """Each MoE layer's gate indices in JAX's own forward on one device:
    its ``moe_ffn`` wrapped to record the top-k of its router probabilities
    (an eager, unrolled forward, so the values are concrete).  Under the
    zigzag ring layout over ``n_seq`` ranks the wrapper hands ``moe_ffn``
    each sequence in the zigzag order, as the sharded run's tokens arrive,
    and puts its output back: the routing, and the tokens dropped, of the
    group's tokens in that order."""
    import jax
    import jax.numpy as jnp

    ref_moe = import_reference("torchft_tpu.models.moe")
    cfg = ref_tr.TransformerConfig(**MOE, moe_capacity_factor=factor, dtype=jnp.float32,
                                   scan_unroll=MOE["n_layers"], remat=False)
    perm = np.arange(SEQ)
    if cfg_kw.get("ring_layout") == "zigzag" and n_seq > 1:
        perm = import_reference("torchft_tpu.ops.ring_attention").zigzag_permutation(SEQ, n_seq)
    seen = []
    inner = ref_moe.moe_ffn

    def recording(x, router, *a, **k):
        x = x[:, perm]
        seen.append(_jax_gates(np.asarray(x), np.asarray(router), k["top_k"]))
        y, aux = inner(x, router, *a, **k)
        return y[:, np.argsort(perm)], aux

    ref_moe.moe_ffn = recording
    try:
        ref_tr.loss_fn(jax.tree.map(jnp.asarray, host),
                       {k: jnp.asarray(v) for k, v in _batch().items()}, cfg)
    finally:
        ref_moe.moe_ffn = inner
    return seen


def _port_model(host, factor, **cfg_kw) -> Transformer:
    cfg = TransformerConfig(**MOE, moe_capacity_factor=factor, dtype=torch.float32, **cfg_kw)
    model = Transformer(cfg, device="cpu")
    load_params(model, params_from_jax(host))
    return model


def _tb(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


@pytest.mark.parametrize("factor", FACTORS)
def test_moe_transformer_loss_and_grads_match_jax(ref, factor) -> None:
    ref_tr = ref[1]
    jloss, jgrads, host = _jax_loss_grads(ref_tr, factor)
    model = _port_model(host, factor, remat=False)
    records = [[] for _ in model.layers]
    for layer, rec in zip(model.layers, records):
        layer.moe_record = rec
    loss = model.loss(_tb(_batch()))
    loss.backward()
    for rec, want in zip(records, _jax_layer_gates(ref_tr, host, factor)):
        np.testing.assert_array_equal(rec[0]["gate_idx"].numpy(), want)
    np.testing.assert_allclose(float(loss.detach()), jloss, rtol=LOSS_RTOL)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) == set(jgrads)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jgrads[name].numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=name)


def test_moe_param_axes_match_jax_partition_specs(ref) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    ref_tr = ref[1]
    ref_parallel = import_reference("torchft_tpu.parallel")
    jaxes = ref_tr.param_axes(ref_tr.TransformerConfig(**MOE, dtype=jnp.float32))["layers"]
    port = param_axes(TransformerConfig(**MOE))
    model = Transformer(TransformerConfig(**MOE, dtype=torch.float32), device="cpu")
    assert set(port) == {n for n, _ in model.named_parameters()}
    for sizes in ({"data": 2, "expert": 2}, {"fsdp": 2, "expert": 2}, {"expert": 4}):
        n = int(np.prod(list(sizes.values())))
        jmesh = Mesh(np.array(jax.devices()[:n]).reshape(tuple(sizes.values())), tuple(sizes))
        for name in ("router", "w_gate", "w_up", "w_down"):
            want = tuple(ref_parallel.ShardingRules().spec(jaxes[name], jmesh))[1:]  # no "layers"
            assert ShardingRules().spec(port[f"layers.0.{name}"], tuple(sizes)) == want, name


def test_moe_remat_is_bitwise_no_remat() -> None:
    torch.use_deterministic_algorithms(True)
    try:
        out = {}
        for remat in (False, True):
            cfg = TransformerConfig(**MOE, moe_capacity_factor=0.5, dtype=torch.float32,
                                    remat=remat)
            model = Transformer(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
            loss = model.loss(_tb(_batch()))
            loss.backward()
            out[remat] = (loss.detach(), {n: p.grad for n, p in model.named_parameters()})
        assert torch.equal(out[True][0], out[False][0])
        for name, g in out[False][1].items():
            assert torch.equal(out[True][1][name], g), name
    finally:
        torch.use_deterministic_algorithms(False)


class _StubMesh:
    """A mesh stand-in for one rank of {data D, sequence n}: its gathers
    return what every rank of the axis would send, from the whole count
    tensor ``counts`` [D, n, B, k, n_exp]."""

    def __init__(self, counts: torch.Tensor, data: int, seq: int) -> None:
        self.counts, self.data, self.seq = counts, data, seq

    def size(self, axis: str) -> int:
        return {"data": self.counts.shape[0], "sequence": self.counts.shape[1]}.get(axis, 1)

    def coordinate(self, axis: str) -> int:
        return {"data": self.data, "sequence": self.seq}.get(axis, 0)

    def group(self, axis: str) -> str:
        return axis

    def batch_shard(self) -> tuple:
        return self.data, self.counts.shape[0]

    def gather(self, x: torch.Tensor, dim: int, group: str) -> torch.Tensor:
        if group == "sequence":   # every "sequence" rank's [1, B, k, n_exp]
            return self.counts[self.data]
        return self.counts.sum((1, 2))[:, None]  # every data shard's [1, 1, k, n_exp]


def test_counts_before_offsets_rows_over_sequence_and_data(monkeypatch) -> None:
    """Each row's offset is the count of every (choice, expert) slot the
    group's k-major order puts before the row: all earlier choices, then
    the same choice's earlier data shards, the shard's earlier rows over
    both "sequence" ranks, and the lower "sequence" rank's part of the row."""
    from torchft_tpu_torch.models import moe as moe_mod

    D, n, B, k, X = 2, 2, 3, 2, 4
    counts = torch.from_numpy(np.random.default_rng(7).integers(0, 5, (D, n, B, k, X)))
    order = [(d, b, r) for d in range(D) for b in range(B) for r in range(n)]
    for d in range(D):
        for r in range(n):
            stub = _StubMesh(counts, d, r)
            monkeypatch.setattr(moe_mod, "all_gather_cat", stub.gather)
            offset, shards = moe_mod._counts_before(counts[d, r], stub)
            assert shards == D * n and offset.shape == (B, k, X)
            for b in range(B):
                before = order[:order.index((d, b, r))]
                for j in range(k):
                    earlier = sum((counts[q, p, c, j] for q, c, p in before),
                                  torch.zeros(X, dtype=torch.long))
                    want = counts[..., :j, :].sum((0, 1, 2, 3)) + earlier
                    assert torch.equal(offset[b, j], want), (d, r, b, j)


def test_f_split_experts_sum_to_the_unsplit(monkeypatch) -> None:
    """Over "tensor" 2 each rank runs F / 2 of every expert: the ranks'
    partial outputs (the axis's sums stubbed out) add up to the unsplit
    call's, at the same routing and aux, and each rank's expert gradients
    are its slices of the unsplit ones."""
    from types import SimpleNamespace

    from torchft_tpu_torch.models import moe as moe_mod

    monkeypatch.setattr(moe_mod, "copy_to", lambda x, group: x)
    monkeypatch.setattr(moe_mod, "reduce_from", lambda x, group: x)
    router, w_gate, w_up, w_down = map(torch.from_numpy, _weights())
    x = torch.from_numpy(_x((2, 16, 32)))
    g = torch.from_numpy(_x((2, 16, 32), seed=4))

    def run(ws, ftmesh):
        ws = [w.clone().requires_grad_() for w in ws]
        record = []
        y, aux = moe_ffn(x, router, *ws, top_k=2, capacity_factor=0.5, dtype=torch.float32,
                         ftmesh=ftmesh, record=record)
        (y * g).sum().backward()
        return y.detach(), aux, record[0], [w.grad for w in ws]

    y, aux, rec, grads = run([w_gate, w_up, w_down], None)
    assert not rec["kept"].all()
    half = w_gate.shape[-1] // 2
    parts = []
    for r in range(2):
        mesh = SimpleNamespace(size=lambda a: 2 if a == "tensor" else 1, group=lambda a: a,
                               coordinate=lambda a, r=r: r if a == "tensor" else 0)
        cut = slice(r * half, (r + 1) * half)
        py, paux, prec, pgrads = run([w_gate[..., cut], w_up[..., cut], w_down[:, cut]], mesh)
        assert torch.equal(prec["gate_idx"], rec["gate_idx"])
        assert torch.equal(prec["kept"], rec["kept"]) and float(paux) == float(aux)
        for got, want in zip(pgrads, (grads[0][..., cut], grads[1][..., cut], grads[2][:, cut])):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL, atol=ATOL)
        parts.append(py)
    np.testing.assert_allclose((parts[0] + parts[1]).numpy(), y.numpy(), rtol=RTOL, atol=ATOL)


_WORKER = r"""
import json, os, sys
sys.path.insert(0, os.environ["TPUFT_REPO"])
import torch
import torch.distributed as dist

rank, world, port, data_path, out_path = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                          sys.argv[4], sys.argv[5])
data = torch.load(data_path)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                        world_size=world)
from torchft_tpu_torch.data import shard_sequence
from torchft_tpu_torch.models import Transformer, TransformerConfig, parallelize
from torchft_tpu_torch.ops.ring_attention import to_zigzag
from torchft_tpu_torch.parallel import ft_init_mesh
from torchft_tpu_torch.weights import load_params

mesh = ft_init_mesh(data["sizes"], device_type="cpu")
shard, shards = mesh.batch_shard()
seq_rank, n = mesh.coordinate("sequence"), mesh.size("sequence")
out = {}
for case, cfg_kw in data["cases"]:
    for factor in data["factors"]:
        cfg = TransformerConfig(**cfg_kw, moe_capacity_factor=factor, dtype=torch.float32,
                                remat=False)
        model = parallelize(Transformer(cfg, device="cpu"), mesh)
        load_params(model, data["params"][factor])
        records = [[] for _ in model.layers]
        for layer, rec in zip(model.layers, records):
            layer.moe_record = rec
        batch = data["batch"]
        if cfg.attention == "ring" and cfg.ring_layout == "zigzag":
            batch = {k: to_zigzag(v, n, dim=1) for k, v in batch.items()}
        # This rank's contiguous rows (the JAX batch sharding), then its
        # slice of each sequence.
        mine = {k: shard_sequence(v.chunk(shards)[shard], seq_rank, n) for k, v in batch.items()}
        rows = mine["tokens"].shape[0]
        loss = model.loss(mine)
        loss.backward()
        total = loss.detach().clone()
        dist.all_reduce(total)
        first = mesh.coordinate("expert") == 0 and mesh.coordinate("tensor") == 0
        routes = [(shard, seq_rank, first,
                   [(r[0]["gate_idx"].reshape(rows, -1, r[0]["gate_idx"].shape[-1]),
                     r[0]["kept"].reshape(rows, -1, r[0]["kept"].shape[-1]), r[0]["capacity"])
                    for r in records])]
        every = [None] * world
        dist.all_gather_object(every, routes)
        layers = []
        for i in range(cfg.n_layers):
            # The group's [B * S, k] routing in the order the tokens arrive:
            # batch shards, then rows, then the "sequence" ranks' parts.
            parts = sorted((s, q, r[i]) for rs in every for s, q, keep, r in rs if keep)
            def whole(j):
                by_shard = [torch.cat([p[2][j] for p in parts if p[0] == s], dim=1)
                            for s in range(shards)]
                return torch.cat(by_shard).flatten(0, 1)
            layers.append({"gate_idx": whole(0), "kept": whole(1), "capacity": parts[0][2][2]})
        out.setdefault(case, {})[factor] = {
            "loss": total / world, "layers": layers,
            "grads": {k: mesh.full_tensor(p.grad) for k, p in model.named_parameters()},
            "types": sorted({type(p).__name__ for p in model.parameters()})}
if rank == 0:
    torch.save(out, out_path)
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _by_mesh() -> dict:
    """CASES grouped by mesh, so that one set of ranks runs a mesh's cases."""
    meshes: dict = {}
    for case, (sizes, extra) in CASES.items():
        key = json.dumps(sizes)
        meshes.setdefault(key, (sizes, []))[1].append((case, dict(MOE, **extra)))
    return meshes


@pytest.fixture(scope="module")
def sharded_runs(ref, tmp_path_factory):
    """For every case: JAX's loss, gradients and routing on its mesh at each
    factor, and the port's ranks on the same weights and batch.  Each
    mesh's ranks start first and run while the JAX side computes."""
    ref_tr = ref[1]
    work = tmp_path_factory.mktemp("moe")
    params = {f: params_from_jax(_jax_params(ref_tr, f)) for f in FACTORS}
    runs = {}
    for m, (sizes, cases) in enumerate(_by_mesh().values()):
        data_path, out_path = str(work / f"mesh{m}.pt"), str(work / f"mesh{m}_out.pt")
        torch.save({"sizes": sizes, "cases": cases, "params": params, "factors": FACTORS,
                    "batch": _tb(_batch())}, data_path)
        world = int(np.prod(list(sizes.values())))
        port = _free_port()
        env = dict(os.environ, TPUFT_REPO=REPO, OMP_NUM_THREADS="1")
        procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), str(world), str(port),
                                   data_path, out_path], env=env,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(world)]
        outs = []
        try:
            jax_side = {}
            for case, cfg_kw in cases:
                jax_side[case] = {}
                for factor in FACTORS:
                    loss, grads, host = _jax_loss_grads(ref_tr, factor, sizes, cfg_kw)
                    jax_side[case][factor] = {
                        "loss": loss, "grads": grads,
                        "gates": _jax_layer_gates(ref_tr, host, factor, cfg_kw,
                                                  sizes.get("sequence", 1))}
            for proc in procs:
                outs.append(proc.communicate(timeout=JOIN_S)[0])
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        for proc, out in zip(procs, outs):
            assert proc.returncode == 0, out[-4000:]
        port_side = torch.load(out_path)
        for case, _ in cases:
            runs[case] = {"jax": jax_side[case], "port": port_side[case]}
    return runs


@pytest.mark.parametrize("factor", FACTORS)
@pytest.mark.parametrize("mesh_name", list(CASES))
def test_sharded_moe_routes_the_whole_batch(sharded_runs, mesh_name, factor) -> None:
    """Every layer's gate indices gathered over the ranks equal JAX's on the
    same mesh, and its kept choices the drop rule's over the group's tokens
    in the order they arrive."""
    run = sharded_runs[mesh_name]
    layers = run["port"][factor]["layers"]
    for layer, want in zip(layers, run["jax"][factor]["gates"]):
        gates = layer["gate_idx"].numpy()
        np.testing.assert_array_equal(gates, want)
        np.testing.assert_array_equal(layer["kept"].numpy(),
                                      kept_by_rule(gates, MOE["moe_experts"], layer["capacity"]))
        assert layer["capacity"] == moe_capacity(BATCH * SEQ, MOE["moe_experts"],
                                                 MOE["moe_top_k"], factor)
    dropped = sum(int((~layer["kept"]).sum()) for layer in layers)
    assert (dropped > 0) == (factor < 1)


@pytest.mark.parametrize("factor", FACTORS)
@pytest.mark.parametrize("mesh_name", list(CASES))
def test_sharded_moe_loss_and_grads_match_jax(sharded_runs, mesh_name, factor) -> None:
    run = sharded_runs[mesh_name]
    port, jax_side = run["port"][factor], run["jax"][factor]
    assert port["types"] == ["DTensor"]
    np.testing.assert_allclose(float(port["loss"]), jax_side["loss"], rtol=LOSS_RTOL)
    assert set(port["grads"]) == set(jax_side["grads"])
    for name, g in port["grads"].items():
        np.testing.assert_allclose(g.numpy(), jax_side["grads"][name].numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=f"{mesh_name} {name}")
