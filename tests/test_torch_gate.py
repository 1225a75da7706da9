"""The model's shape gate: the port takes its Hopper kernels only where
``flash_applicable`` / ``fused_ce_applicable`` hold, and the plain PyTorch
math everywhere else, as the JAX model takes its Pallas kernels only where
``_use_pallas`` / ``fused_ce_applicable`` hold and its XLA path elsewhere.

The reference's predicates also require a TPU backend, so on the CPU they
are always false; their shape terms are computed here from the reference's
own block-size helpers and held against the port's documented table.  The
``gpu`` tests train one step of models the kernels do not fully take (head
dims 64 and 32) on the card against the same step on the CPU.
"""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from torch_port_ref import cuda_device, import_reference  # noqa: F401 - fixture
from torchft_tpu_torch.models import Transformer, TransformerConfig
from torchft_tpu_torch.ops import attention as A
from torchft_tpu_torch.ops import cross_entropy as C
from torchft_tpu_torch.ops import launch_counts, reset_launch_counts

# The port's documented table: the flash kernels are built for head dim 128
# and take one sequence length for q and k (any length >= 1); the
# cross-entropy kernels take E % 16 == 0 and V % 8 == 0.
FLASH_GRID = [(d, sq, sk) for d in (32, 64, 128, 256)
              for sq, sk in ((1024, 1024), (1000, 1000), (512, 1024))]
CE_GRID = [(16384, 768, 32000), (300, 256, 1000), (256, 784, 1000), (129, 16, 8),
           (1024, 100, 32000), (1024, 768, 1001), (1000, 128, 520), (512, 768, 32004)]


def _port_flash_table(d: int, sq: int, sk: int) -> bool:
    return d == 128 and sq == sk


def _port_ce_table(n: int, e: int, v: int) -> bool:
    return e % 16 == 0 and v % 8 == 0


@pytest.fixture(scope="module")
def ref_attention():
    return import_reference("torchft_tpu.ops.attention")


@pytest.fixture(scope="module")
def ref_ce():
    return import_reference("torchft_tpu.ops.cross_entropy")


@pytest.mark.parametrize("d, sq, sk", FLASH_GRID)
def test_flash_gate_against_the_reference_shape_terms(ref_attention, d, sq, sk) -> None:
    bq, bk = ref_attention._block_sizes(sq, sk)
    ref_shape = sq % bq == 0 and sk % bk == 0 and d % 128 == 0
    # The reference needs a TPU: off it, its predicate is always false.
    assert ref_attention._use_pallas(sq, sk, d) is False
    port = A.flash_shapes_supported(sq, sk, d)
    assert port == _port_flash_table(d, sq, sk)
    # Where the port takes the kernels, the reference's head-dim term holds
    # too; the port's kernels take ragged S the TPU's 512 blocks do not.
    if port:
        assert d % 128 == 0
    if ref_shape and sq == sk and d != 128:
        assert not port  # head dim 256: not built (ROADMAP queue 2.4)
    # CPU tensors never take the kernels, whatever their shape.
    q = torch.zeros(1, 2, sq, d, dtype=torch.bfloat16)
    k = torch.zeros(1, 2, sk, d, dtype=torch.bfloat16)
    assert not A.flash_applicable(q, k)


@pytest.mark.parametrize("n, e, v", CE_GRID)
def test_fused_ce_gate_against_the_reference_shape_terms(ref_ce, n, e, v) -> None:
    ref_shape = (ref_ce._block_v(v, e) is not None and ref_ce._block_rows(n, e) is not None
                 and e % 128 == 0)
    assert ref_ce.fused_ce_applicable(n, e, v) is False  # needs a TPU
    port = C.fused_ce_shapes_supported(n, e, v)
    assert port == _port_ce_table(n, e, v)
    # Every shape the reference's kernels tile, the port's take as well.
    if ref_shape:
        assert port
    x = torch.zeros(n, e, dtype=torch.bfloat16)
    w = torch.zeros(e, v, dtype=torch.bfloat16)
    assert not C.fused_ce_applicable(x, w)


@pytest.mark.parametrize("d_head", [32, 64])
def test_plain_attention_matches_jax_at_head_dims_the_kernels_do_not_take(
        ref_attention, d_head) -> None:
    """The gate's fallback is the same math as the reference's XLA path."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(d_head)
    q = rng.standard_normal((2, 4, 96, d_head)).astype(np.float32)
    k = rng.standard_normal((2, 2, 96, d_head)).astype(np.float32)
    v = rng.standard_normal((2, 2, 96, d_head)).astype(np.float32)

    def jloss(q, k, v):
        return jnp.sum(ref_attention.flash_attention(q, k, v, causal=True) ** 2)

    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    jout = ref_attention.flash_attention(jq, jk, jv, causal=True)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = A.plain_attention(tq, tk, tv, causal=True)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=1e-4, atol=1e-4)
    for mine, theirs in zip((tq.grad, tk.grad, tv.grad), jgrads):
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), rtol=1e-3, atol=1e-3)


def test_kernel_wrappers_still_raise_for_shapes_the_gate_rejects() -> None:
    """The gate lives in the model; a direct call still fails loudly (the
    check runs before any launch, so it fails here on a CPU-only host)."""
    with pytest.raises(ValueError, match="D in"):
        A._check_shapes("flash_fwd", torch.zeros(2, 16, 64))
    with pytest.raises(ValueError, match="E % 16"):
        C._check("ce_lse", torch.zeros(4, 100, dtype=torch.bfloat16),
                 torch.zeros(100, 8, dtype=torch.bfloat16))


# -- on the card ---------------------------------------------------------------

# Default TransformerConfig(): d_model 512 over 8 heads, head dim 64, vocab
# 32000 (E % 16 and V % 8 hold: the fused CE runs).  The d_head-32 model is
# the JAX examples' width (d_model 128, 4 heads) with a ragged vocab, so the
# CE takes its plain path too.
CARD_MODELS = {
    "default_d_head_64": (TransformerConfig(n_layers=2), {"ce_lse": 1, "ce_dlogits": 1}),
    "d_head_32_ragged_vocab": (
        TransformerConfig(vocab_size=1001, d_model=128, n_layers=2, n_heads=4, n_kv_heads=4,
                          d_ff=256, max_seq=256), {}),
}
# The CPU run rounds the same bf16 operands in another order; the random-init
# loss is ~ln V, and 2e-3 of it covers that with the whole step in bf16.
LOSS_RTOL = 2e-3


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CARD_MODELS))
def test_models_the_kernels_do_not_take_train_a_step_on_card(cuda_device, name) -> None:
    cfg, want_launches = CARD_MODELS[name]
    cpu = Transformer(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    card = copy.deepcopy(cpu).to(cuda_device)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 128))).long()
    batch = {"tokens": tokens, "targets": torch.roll(tokens, -1, dims=1)}
    loss_cpu = cpu.loss(batch)
    loss_cpu.backward()
    reset_launch_counts()
    loss = card.loss({k: t.to(cuda_device) for k, t in batch.items()})
    loss.backward()
    torch.cuda.synchronize()
    counts = launch_counts()
    assert {k: n for k, n in counts.items() if n} == want_launches, counts
    assert counts["flash_fwd"] == counts["flash_bwd_dkdv"] == counts["flash_bwd_dq"] == 0
    np.testing.assert_allclose(loss.detach().item(), loss_cpu.detach().item(), rtol=LOSS_RTOL)
    for p in card.parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all())
