"""The train_ddp example's pieces against the JAX package, on the CPU: the
conv net (logits, loss, grads, three SGD steps) at the same weights through
``convnet_params_from_jax``, and the sampler's index streams.

Tolerances: logits and loss 1e-5 (float32 on both sides, other summation
orders in the convolution and the matrix products), grads 1e-4 (the same
orders, through the backward), parameters after three SGD steps at lr 0.01
1e-5.  The sampler is compared for equality: both sides draw the same numpy
permutation.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from torch_port_ref import import_reference
from torchft_tpu_torch.data import DistributedSampler
from torchft_tpu_torch.models import ConvNet, convnet_loss
from torchft_tpu_torch.weights import convnet_params_from_jax

LR = 0.01


@pytest.fixture(scope="module")
def jax_convnet():
    return import_reference("torchft_tpu.models.convnet")


@pytest.fixture(scope="module")
def params(jax_convnet):
    import jax

    return jax.tree.map(np.asarray, jax_convnet.init_convnet_params(jax.random.PRNGKey(3)))


def _batch(seed: int, n: int = 8):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 10, n).astype(np.int32))


def _port_model(params) -> ConvNet:
    model = ConvNet(device="cpu")
    model.load_state_dict(convnet_params_from_jax(params))
    return model


def test_logits_loss_and_grads_match_jax(jax_convnet, params) -> None:
    import jax
    import jax.numpy as jnp

    x, y = _batch(0)
    jp = jax.tree.map(jnp.asarray, params)
    jlogits = jax_convnet.convnet_forward(jp, jnp.asarray(x))
    jloss, jgrads = jax.value_and_grad(jax_convnet.convnet_loss)(jp, jnp.asarray(x),
                                                                jnp.asarray(y))
    model = _port_model(params)
    logits = model(torch.from_numpy(x))
    loss = convnet_loss(model, torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    want = convnet_params_from_jax(jax.tree.map(np.asarray, jgrads))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-4,
                                   err_msg=name)


def test_same_padding_is_all_after_the_image(params) -> None:
    """A 1 in the last row and column of the image reaches the last output
    row and column (SAME at stride 2 pads only after); symmetric padding
    would drop it."""
    model = _port_model(params)
    x = torch.zeros(1, 32, 32, 3)
    x[0, 31, 31, 0] = 1.0
    h = torch.nn.functional.pad(x.permute(0, 3, 1, 2), (0, 1, 0, 1))
    out = torch.nn.functional.conv2d(h, model.conv, stride=2)
    assert out[0, :, 15, 15].abs().sum() > 0
    sym = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), model.conv, stride=2, padding=1)
    assert not torch.allclose(out, sym)


def test_three_sgd_steps_match_optax(jax_convnet, params) -> None:
    import jax
    import jax.numpy as jnp
    import optax

    batches = [_batch(10 + s) for s in range(3)]
    tx = optax.sgd(LR)
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    grad = jax.jit(jax.value_and_grad(jax_convnet.convnet_loss))
    for x, y in batches:
        _, g = grad(jp, jnp.asarray(x), jnp.asarray(y))
        updates, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, updates)

    model = _port_model(params)
    opt = torch.optim.SGD(model.parameters(), lr=LR)
    for x, y in batches:
        opt.zero_grad()
        convnet_loss(model, torch.from_numpy(x), torch.from_numpy(y)).backward()
        opt.step()
    want = convnet_params_from_jax(jax.tree.map(np.asarray, jp))
    start = convnet_params_from_jax(params)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    assert max(float((p.detach() - start[n]).abs().max()) for n, p in
               model.named_parameters()) > 1e-4  # the steps moved the weights


def test_weight_mapper_layouts(params) -> None:
    sd = convnet_params_from_jax(params)
    assert sd["conv"].shape == (16, 3, 3, 3) and sd["w1"].shape == (64, 4096)
    assert sd["w2"].shape == (10, 64) and sd["b2"].shape == (10,)
    # HWIO [kh, kw, cin, cout] -> OIHW [cout, cin, kh, kw].
    assert float(sd["conv"][5, 2, 0, 1]) == float(params["conv"][0, 1, 2, 5])
    assert float(sd["w1"][7, 4095]) == float(params["w1"][4095, 7])


def test_model_draws_from_its_generator() -> None:
    a, b, c = (ConvNet(device="cpu", generator=torch.Generator().manual_seed(s)).state_dict()
               for s in (42, 42, 43))
    for name, p in a.items():
        assert torch.equal(p, b[name])
    assert not torch.equal(a["w1"], c["w1"])
    assert float(a["b1"].abs().sum()) == 0.0
    assert 0.05 < float(a["conv"].std()) < 0.15 and 0.015 < float(a["w1"].std()) < 0.025


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("shuffle", [True, False])
def test_sampler_index_streams_equal_jax(drop_last, shuffle) -> None:
    ref = import_reference("torchft_tpu.data")
    for dataset_len in (2048, 1001, 7):
        for groups in (1, 2, 3):
            for group in range(groups):
                for seed in (0, 5):
                    kw = dict(replica_group=group, num_replica_groups=groups, seed=seed,
                              shuffle=shuffle, drop_last=drop_last)
                    mine = DistributedSampler(dataset_len, **kw)
                    theirs = ref.DistributedSampler(dataset_len, **kw)
                    for epoch in (0, 3):
                        mine.set_epoch(epoch)
                        theirs.set_epoch(epoch)
                        assert list(mine) == list(theirs)
                        assert len(mine) == len(theirs)


def test_sampler_composes_local_ranks() -> None:
    ref = import_reference("torchft_tpu.data")
    kw = dict(replica_group=1, num_replica_groups=2, rank=1, num_replicas=2, seed=9)
    assert list(DistributedSampler(100, **kw)) == list(ref.DistributedSampler(100, **kw))
