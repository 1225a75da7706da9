"""The port's transformer against the JAX model from identical weights
(params_from_jax), on a small grouped-query config in float32 on the CPU:
logits, loss and every gradient.  Tolerances cover float32 summation-order
differences between XLA and PyTorch on two layers: 1e-4 on logits and
loss, 2e-4 (relative to each gradient's scale) on gradients."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from torch_port_ref import import_reference
from torchft_tpu_torch.models import Transformer, TransformerConfig
from torchft_tpu_torch.weights import params_from_jax

SMALL = dict(vocab_size=512, d_model=256, n_layers=2, n_heads=2, n_kv_heads=1,
             d_ff=512, max_seq=256)


@pytest.fixture(scope="module")
def ref():
    return import_reference("torchft_tpu.models.transformer")


def _setup(ref):
    import jax
    import jax.numpy as jnp

    jcfg = ref.TransformerConfig(**SMALL, dtype=jnp.float32, remat=False)
    params = jax.tree.map(np.asarray, ref.init_params(jax.random.PRNGKey(0), jcfg))
    model = Transformer(TransformerConfig(**SMALL, dtype=torch.float32), device="cpu")
    model.load_state_dict(params_from_jax(params))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, SMALL["vocab_size"], (2, 256)).astype(np.int32)
    batch = {"tokens": tokens, "targets": np.roll(tokens, -1, axis=1)}
    return jcfg, params, model, batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def test_params_from_jax_fills_every_parameter(ref) -> None:
    _, params, model, _ = _setup(ref)
    sd = params_from_jax(params)
    assert set(sd) == set(model.state_dict())
    for name, t in model.state_dict().items():
        assert torch.equal(t, sd[name]), name


def test_logits_and_loss_match_jax(ref) -> None:
    import jax.numpy as jnp

    jcfg, params, model, batch = _setup(ref)
    jparams = {k: v for k, v in params.items()}
    logits_j = np.asarray(ref.forward(jparams, jnp.asarray(batch["tokens"]), jcfg))
    loss_j = float(ref.loss_fn(jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg))
    tb = _torch_batch(batch)
    with torch.no_grad():
        logits = model(tb["tokens"])
        loss = model.loss(tb)
    np.testing.assert_allclose(logits.numpy(), logits_j, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(loss), loss_j, rtol=1e-4, atol=1e-4)


def test_grads_match_jax(ref) -> None:
    import jax
    import jax.numpy as jnp

    jcfg, params, model, batch = _setup(ref)
    jgrads = jax.grad(ref.loss_fn)(
        jax.tree.map(jnp.asarray, params), {k: jnp.asarray(v) for k, v in batch.items()}, jcfg
    )
    want = params_from_jax(jax.tree.map(np.asarray, jgrads))
    model.loss(_torch_batch(batch)).backward()
    for name, p in model.named_parameters():
        scale = float(want[name].abs().max())
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=2e-4,
                                   atol=2e-4 * scale, err_msg=name)
