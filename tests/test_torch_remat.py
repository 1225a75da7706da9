"""Rematerialisation in the port's transformer (``TransformerConfig.remat``,
on by default as in the JAX package): each block runs under
``torch.utils.checkpoint``, the JAX model's ``jax.checkpoint`` of its layer
body.  On the CPU, in float32: the port's remat gradients against the JAX
model's remat gradients (test_torch_model's tolerances), remat against no
remat in the port (bitwise: the recomputed forward is the same
arithmetic), every block's forward running twice a step under remat, and
the config's fields against the JAX config's.  The ``gpu`` test counts the
kernels' launches a step on the card."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from torch_port_ref import cuda_device, import_reference  # noqa: F401 - fixture
from torchft_tpu_torch.models import Transformer, TransformerConfig, flagship_config
from torchft_tpu_torch.ops import launch_counts, reset_launch_counts
from torchft_tpu_torch.weights import params_from_jax

SMALL = dict(vocab_size=512, d_model=256, n_layers=2, n_heads=2, n_kv_heads=1,
             d_ff=512, max_seq=256)
# The JAX config's fields that the port does not have yet (none), and
# those it leaves out by design: scan_unroll unrolls the JAX model's
# lax.scan over the stacked layers, and the port's eager blocks run as a
# Python loop, which has nothing to unroll.
NOT_YET_PORTED = ()
BY_DESIGN = ("scan_unroll",)


@pytest.fixture(scope="module")
def ref():
    return import_reference("torchft_tpu.models.transformer")


def _batch(seed: int = 0, b: int = 2, s: int = 256, vocab: int = SMALL["vocab_size"]):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (b, s)).astype(np.int32)
    return {"tokens": tokens, "targets": np.roll(tokens, -1, axis=1)}


def _tb(batch, device="cpu"):
    return {k: torch.from_numpy(v).long().to(device) for k, v in batch.items()}


def _block_calls(model: Transformer) -> list:
    calls = [0]

    def hook(*_):
        calls[0] += 1

    for layer in model.layers:
        layer.register_forward_pre_hook(hook)
    return calls


def test_remat_grads_match_jax_remat(ref) -> None:
    import jax
    import jax.numpy as jnp

    jcfg = ref.TransformerConfig(**SMALL, dtype=jnp.float32, remat=True)
    params = jax.tree.map(np.asarray, ref.init_params(jax.random.PRNGKey(0), jcfg))
    batch = _batch()
    jloss, jgrads = jax.value_and_grad(ref.loss_fn)(
        jax.tree.map(jnp.asarray, params), {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    want = params_from_jax(jax.tree.map(np.asarray, jgrads))
    cfg = TransformerConfig(**SMALL, dtype=torch.float32)
    assert cfg.remat is True
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params))
    calls = _block_calls(model)
    loss = model.loss(_tb(batch))
    loss.backward()
    assert calls[0] == 2 * SMALL["n_layers"]  # each block again in the backward
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4, atol=1e-4)
    for name, p in model.named_parameters():
        scale = float(want[name].abs().max())
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=2e-4,
                                   atol=2e-4 * scale, err_msg=name)


@pytest.fixture
def deterministic():
    """The CPU's embedding backward accumulates rows from several threads in
    any order, so two runs of one step differ by ulps with or without remat;
    the deterministic algorithms fix that order."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


@pytest.mark.parametrize("steps", [1, 3])
def test_remat_matches_no_remat_bitwise(deterministic, steps: int) -> None:
    """Losses and gradients of ``steps`` AdamW steps from one set of
    weights, with and without remat, are bitwise equal."""
    cfg = TransformerConfig(**SMALL, dtype=torch.float32)
    models = {r: Transformer(dataclasses.replace(cfg, remat=r), device="cpu",
                             generator=torch.Generator().manual_seed(4)) for r in (True, False)}
    calls = {r: _block_calls(m) for r, m in models.items()}
    opts = {r: torch.optim.AdamW(m.parameters(), lr=1e-3) for r, m in models.items()}
    for s in range(steps):
        batch = _tb(_batch(seed=s, s=64))
        losses = {}
        for r, m in models.items():
            opts[r].zero_grad(set_to_none=True)
            losses[r] = m.loss(batch)
            losses[r].backward()
        assert torch.equal(losses[True], losses[False]), s
        for (name, p), q in zip(models[True].named_parameters(), models[False].parameters()):
            assert torch.equal(p.grad, q.grad), (s, name)
        for o in opts.values():
            o.step()
    assert calls[True][0] == 2 * steps * SMALL["n_layers"]
    assert calls[False][0] == steps * SMALL["n_layers"]


def test_remat_does_not_recompute_without_grad() -> None:
    model = Transformer(TransformerConfig(**SMALL, dtype=torch.float32), device="cpu")
    calls = _block_calls(model)
    with torch.no_grad():
        model.loss(_tb(_batch(s=32)))
    assert calls[0] == SMALL["n_layers"]


def test_config_fields_match_the_jax_config(ref) -> None:
    """Every field of the JAX TransformerConfig is in the port's with the same
    default, or is named in NOT_YET_PORTED or BY_DESIGN."""
    jax_fields = {f.name: f.default for f in dataclasses.fields(ref.TransformerConfig)}
    port_fields = {f.name: f.default for f in dataclasses.fields(TransformerConfig)}
    assert set(NOT_YET_PORTED) | set(BY_DESIGN) <= set(jax_fields)
    assert not (set(NOT_YET_PORTED) | set(BY_DESIGN)) & set(port_fields)
    assert set(port_fields) <= set(jax_fields)
    for name, default in jax_fields.items():
        if name in NOT_YET_PORTED or name in BY_DESIGN:
            continue
        assert name in port_fields, name
        got = port_fields[name]
        if isinstance(got, torch.dtype):
            import jax.numpy as jnp

            assert str(got).removeprefix("torch.") == jnp.dtype(default).name, name
        else:
            assert got == default, name
    assert port_fields["remat"] is True


def test_flagship_config_keeps_remat_off() -> None:
    """The flagship runs without remat, as the JAX bench's flagship does
    (bench.py flagship_config): its activations fit the card."""
    cfg, batch, seq = flagship_config()
    assert cfg.remat is False
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.d_head, cfg.vocab_size, batch, seq) == (
        12, 768, 6, 128, 32000, 16, 1024)


@pytest.mark.gpu
@pytest.mark.parametrize("remat", [True, False])
def test_remat_launch_counts_on_card(cuda_device, remat: bool) -> None:
    """Under remat the flash forward runs twice a layer (the forward and its
    recomputation), its backward kernels and the cross-entropy kernels as
    often as without; the losses are bitwise equal."""
    cfg = TransformerConfig(vocab_size=1024, d_model=256, n_layers=2, n_heads=2, n_kv_heads=2,
                            d_ff=512, max_seq=256)
    losses = {}
    for r in (remat, not remat):
        model = Transformer(dataclasses.replace(cfg, remat=r), device=cuda_device,
                            generator=torch.Generator(device=cuda_device).manual_seed(0))
        reset_launch_counts()
        loss = model.loss(_tb(_batch(s=256, vocab=cfg.vocab_size), cuda_device))
        loss.backward()
        torch.cuda.synchronize()
        counts = launch_counts()
        losses[r] = loss.detach()
        if r == remat:
            L = cfg.n_layers
            want = {"flash_fwd": 2 * L if remat else L, "flash_bwd_dkdv": L, "flash_bwd_dq": L,
                    "ce_lse": 1, "ce_dlogits": 1}
            assert {k: counts[k] for k in want} == want, counts
    assert torch.equal(losses[True], losses[False])
