"""K6, the RMSNorm kernel: the port's ``rms_norm_pallas`` against the JAX
package's on the same inputs (made with numpy from a seed).

On the CPU the port runs its plain version; the JAX side runs its Pallas
kernel ``_rms_pallas`` in interpret mode (as tests/test_ops.py does), its
public ``rms_norm_pallas`` (plain XLA off the TPU), and ``jax.grad`` through
its custom VJP.  Tolerances: 1e-5 for float32 values (both sides compute in
f32, in other summation orders), 1e-4 for the gradients (the same closed
form, whose f32 means differ in order), and one bf16 rounding step (up to
2^-7 of the value, just above a power of two) where x is bf16, since each
side rounds its f32 result to bf16 once and an f32 difference at a
rounding boundary flips one step.

The test marked ``gpu`` holds the Hopper kernel against the plain version
on the card; it skips where there is no card.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from torch_port_ref import cuda_device, import_reference  # noqa: F401 - fixture
from torchft_tpu_torch.ops import rmsnorm as R

EPS = 1e-6


@pytest.fixture(scope="module")
def jax_rms():
    return import_reference("torchft_tpu.ops.rmsnorm")


def _inputs(seed: int, *shape):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (1.0 + 0.3 * rng.standard_normal(shape[-1])).astype(np.float32)
    return x, w


@pytest.mark.parametrize("rows,d", [(96, 64), (600, 768)])
def test_forward_matches_pallas_interpret(jax_rms, rows, d) -> None:
    """(600, 768): two 512-row blocks on the TPU, the last one partial."""
    import jax.numpy as jnp

    x, w = _inputs(rows + d, rows, d)
    want = jax_rms._rms_pallas(jnp.asarray(x), jnp.asarray(w), EPS, interpret=True)
    got = R.rms_norm_pallas(torch.from_numpy(x), torch.from_numpy(w), EPS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(96, 64), (4, 8, 128), (33,)])
def test_forward_matches_the_jax_op(jax_rms, shape) -> None:
    import jax.numpy as jnp

    x, w = _inputs(7, *shape)
    want = jax_rms.rms_norm_pallas(jnp.asarray(x), jnp.asarray(w))
    got = R.rms_norm_pallas(torch.from_numpy(x), torch.from_numpy(w))
    assert got.shape == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(64, 96), (3, 16, 128)])
def test_grads_match_jax_custom_vjp(jax_rms, shape) -> None:
    """dx and dw through autograd against jax.grad through the hand-written
    VJP, for a loss that weights every output differently."""
    import jax
    import jax.numpy as jnp

    x, w = _inputs(11, *shape)
    c = np.random.default_rng(12).standard_normal(shape).astype(np.float32)

    def jloss(x, w):
        return jnp.sum(jax_rms.rms_norm_pallas(x, w) * c)

    jdx, jdw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx, tw = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    (R.rms_norm_pallas(tx, tw) * torch.from_numpy(c)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), rtol=1e-4, atol=1e-4)


def test_bf16_x_with_f32_w_matches_pallas_interpret(jax_rms) -> None:
    import jax.numpy as jnp

    x, w = _inputs(13, 128, 256)
    x_bf16 = torch.from_numpy(x).to(torch.bfloat16)
    want = jax_rms._rms_pallas(jnp.asarray(x_bf16.float().numpy(), dtype=jnp.bfloat16),
                               jnp.asarray(w), EPS, interpret=True)
    got = R.rms_norm_pallas(x_bf16, torch.from_numpy(w), EPS)
    assert got.dtype == torch.bfloat16
    want_f = np.asarray(want.astype(jnp.float32))
    # One bf16 step (at most 2^-7 of the value) where the two f32 results
    # straddle a rounding boundary; most elements are bitwise equal.
    np.testing.assert_allclose(got.float().numpy(), want_f, rtol=2 ** -7, atol=1e-6)
    assert np.mean(got.float().numpy() == want_f) > 0.99


# -- on the card -------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(16384, 768), (300, 1000), (300, 1001), (4, 50, 768), (768,)])
def test_rms_kernel_matches_plain_on_card(cuda_device, dtype, shape) -> None:
    """The kernel against ``_rms_reference`` on the same inputs: within two
    rounding steps of bf16 (2^-6 |ref|: one step is up to 2^-7 of the
    value, and rsqrtf and the shuffle-tree sum differ from torch in the
    last f32 bits, which flips one) or 1e-5 |ref| for f32, plus 1e-5; its
    launch count moves by one per call."""
    x, w = _inputs(21, *shape)
    tx = torch.from_numpy(x).to(cuda_device, dtype)
    tw = torch.from_numpy(w).to(cuda_device)
    before = R.RMS_NORM.launches
    got = R.rms_norm_pallas(tx, tw, EPS)
    torch.cuda.synchronize()
    assert R.RMS_NORM.launches == before + 1
    ref = R._rms_reference(tx, tw, EPS).float()
    rtol = 2 ** -6 if dtype == torch.bfloat16 else 1e-5
    over = ((got.float() - ref).abs() / (rtol * ref.abs() + 1e-5)).max()
    assert got.dtype == dtype and got.shape == tx.shape
    assert over <= 1.0, f"error {float(over):.3f}x its tolerance"
