"""The slice as a whole, on the CPU: two replica groups of the port (one
thread each, a lighthouse, TCP ring, HTTP transport) train a small
transformer for three fault-tolerant steps with AdamW on different batches.
Their parameters end bitwise equal to each other, and equal, within
float32 tolerance, to the same three steps computed by the JAX package:
the mean of the two groups' ``jax.grad`` and then ``optax.adamw`` with the
same hyperparameters (every one set explicitly: optax and torch defaults
differ)."""

from __future__ import annotations

import threading
from datetime import timedelta

import numpy as np
import torch

from torch_port_ref import import_reference
from torchft_tpu_torch import _native
from torchft_tpu_torch.checkpointing import HTTPTransport
from torchft_tpu_torch.collectives import TCPCollective
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.models import Transformer, TransformerConfig, loss_fn
from torchft_tpu_torch.parallel import TrainStep
from torchft_tpu_torch.weights import params_from_jax

CFG = dict(vocab_size=256, d_model=128, n_layers=2, n_heads=2, n_kv_heads=1, d_ff=256,
           max_seq=64)
ADAMW = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-2)
STEPS, BATCH, SEQ, HOST = 3, 2, 64, "127.0.0.1"


def _batches(group: int):
    rng = np.random.default_rng(100 + group)
    out = []
    for _ in range(STEPS):
        tokens = rng.integers(0, CFG["vocab_size"], (BATCH, SEQ)).astype(np.int32)
        out.append({"tokens": tokens, "targets": np.roll(tokens, -1, axis=1)})
    return out


def _jax_steps(ref, params, batches):
    import jax
    import jax.numpy as jnp
    import optax

    jcfg = ref.TransformerConfig(**CFG, dtype=jnp.float32, remat=False)
    tx = optax.adamw(ADAMW["lr"], b1=ADAMW["b1"], b2=ADAMW["b2"], eps=ADAMW["eps"],
                     weight_decay=ADAMW["weight_decay"])
    p = jax.tree.map(jnp.asarray, params)
    state = tx.init(p)
    grad = jax.jit(jax.grad(lambda p, b: ref.loss_fn(p, b, jcfg)))
    for s in range(STEPS):
        g = [grad(p, {k: jnp.asarray(v) for k, v in batches[grp][s].items()}) for grp in (0, 1)]
        mean = jax.tree.map(lambda a, b: (a + b) / 2, g[0], g[1])
        updates, state = tx.update(mean, state, p)
        p = optax.apply_updates(p, updates)
    return jax.tree.map(np.asarray, p)


def _port_group(group: int, lighthouse: str, params, batches, out: dict) -> None:
    model = Transformer(TransformerConfig(**CFG, dtype=torch.float32), device="cpu")
    model.load_state_dict(params_from_jax(params))
    opt = torch.optim.AdamW(model.parameters(), lr=ADAMW["lr"], betas=(ADAMW["b1"], ADAMW["b2"]),
                            eps=ADAMW["eps"], weight_decay=ADAMW["weight_decay"])

    def load(sd):
        model.load_state_dict(sd["model"])
        opt.load_state_dict(sd["optim"])

    manager = Manager(
        collective=TCPCollective(timeout=60.0, host=HOST),
        load_state_dict=load,
        state_dict=lambda: {"model": model.state_dict(), "optim": opt.state_dict()},
        min_replica_size=2,
        rank=0,
        world_size=1,
        replica_id=f"slice_g{group}",
        lighthouse_addr=lighthouse,
        store_addr=HOST,
        manager_bind=f"{HOST}:0",
        checkpoint_transport=HTTPTransport(timeout=60.0, host=HOST),
        timeout=timedelta(seconds=60),
        quorum_timeout=timedelta(seconds=60),
        init_sync=False,  # both groups start from the same weights
    )
    trainer = TrainStep(model, opt, loss_fn, manager)
    try:
        committed = []
        for s in range(STEPS):
            manager.start_quorum()
            b = {k: torch.from_numpy(v).long() for k, v in batches[s].items()}
            loss, ok = trainer.ft_step(b)
            committed.append((ok, manager.num_participants(), float(loss)))
        out[group] = (committed, {k: v.detach().clone() for k, v in model.state_dict().items()})
    finally:
        manager.shutdown()


def test_two_groups_train_like_jax() -> None:
    import jax

    ref = import_reference("torchft_tpu.models.transformer")
    jcfg = ref.TransformerConfig(**CFG, remat=False)
    params = jax.tree.map(np.asarray, ref.init_params(jax.random.PRNGKey(1), jcfg))
    batches = [_batches(0), _batches(1)]

    lh = _native.LighthouseServer(bind=f"{HOST}:0", http_bind=f"{HOST}:0", min_replicas=2,
                                  join_timeout_ms=100)
    out: dict = {}
    errors = []

    def run(g: int) -> None:
        try:
            _port_group(g, lh.address(), params, batches[g], out)
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(g,)) for g in (0, 1)]
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
        committed, _ = out[g]
        assert [(ok, n) for ok, n, _ in committed] == [(True, 2)] * STEPS
        assert all(np.isfinite(loss) for _, _, loss in committed)
    sd0, sd1 = out[0][1], out[1][1]
    for name in sd0:
        assert torch.equal(sd0[name], sd1[name]), name

    want = params_from_jax(_jax_steps(ref, params, batches))
    moved = 0.0
    for name, t in sd0.items():
        start = params_from_jax(params)[name]
        moved = max(moved, float((t - start).abs().max()))
        # 3 AdamW steps move a weight by at most ~3 * lr; float32 grads that
        # differ in summation order shift an update by a sliver of lr.
        np.testing.assert_allclose(t.numpy(), want[name].numpy(), rtol=0, atol=5e-5,
                                   err_msg=name)
    assert moved > 1e-3  # the steps really moved the weights
