"""Every module of the port that holds a kernel, held against the JAX
package on the same inputs (made with numpy from a seed).

On the CPU the port's ops run their plain versions; the JAX side runs its
Pallas kernels in interpret mode (as tests/test_ops.py does) or its XLA
reference.  Tolerances are the ones tests/test_ops.py uses for the same
comparisons (2e-3 for the flash kernels, 1e-5 / 1e-4 for cross-entropy),
all in float32.

The tests marked ``gpu`` hold the Hopper kernels against the plain versions
on the card, in bf16; they skip where there is no card.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from torch_port_ref import cuda_device, import_reference  # noqa: F401 - fixture
from torchft_tpu_torch.ops import attention as A
from torchft_tpu_torch.ops import cross_entropy as C
from torchft_tpu_torch.ops.rmsnorm import rms_norm

SCALE = 0.088


@pytest.fixture(scope="module")
def jax_attention():
    return import_reference("torchft_tpu.ops.attention")


@pytest.fixture(scope="module")
def jax_ce():
    return import_reference("torchft_tpu.ops.cross_entropy")


def _qkv(rng, bh: int, seq: int, n: int = 3):
    return [rng.standard_normal((bh, seq, 128)).astype(np.float32) for _ in range(n)]


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("causal", [True, False])
def test_flash_forward_matches_pallas_interpret(jax_attention, causal) -> None:
    import jax.numpy as jnp

    q, k, v = _qkv(np.random.default_rng(3), 2, 1024)
    o_pl, lse_pl = jax_attention._fa_pallas_call(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), SCALE, causal, interpret=True
    )
    o, lse = A.flash_fwd(*_t(q, k, v), SCALE, causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_pl), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_pl), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_matches_pallas_interpret(jax_attention, causal) -> None:
    """seq 1024: the TPU's merged one-pass backward (dq from f32 partials)."""
    import jax.numpy as jnp

    q, k, v, g = _qkv(np.random.default_rng(7), 2, 1024, n=4)
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    o, lse = jax_attention._fa_reference(jq, jk, jv, SCALE, causal)
    d_pl = jax_attention._fa_bwd_pallas(jq, jk, jv, o, lse, jg, SCALE, causal, interpret=True)
    d_port = A.flash_bwd(*_t(q, k, v, np.asarray(o), np.asarray(lse), g), SCALE, causal)
    for mine, theirs, name in zip(d_port, d_pl, ("dq", "dk", "dv")):
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), rtol=2e-3, atol=2e-3,
                                   err_msg=name)


def test_flash_backward_long_context_matches_xla(jax_attention) -> None:
    """seq 4096: where the TPU takes its two-pass (dq kernel) form."""
    import jax.numpy as jnp

    q, k, v, g = _qkv(np.random.default_rng(8), 1, 4096, n=4)
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    o, lse = jax_attention._fa_reference(jq, jk, jv, SCALE, True)
    d_ref = jax_attention._fa_bwd_xla(jq, jk, jv, o, lse, jg, SCALE, True)
    d_port = A.flash_bwd(*_t(q, k, v, np.asarray(o), np.asarray(lse), g), SCALE, True)
    for mine, theirs, name in zip(d_port, d_ref, ("dq", "dk", "dv")):
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), rtol=2e-3, atol=2e-3,
                                   err_msg=name)


def test_flash_attention_gqa_grads_match_jax(jax_attention) -> None:
    """The public op with grouped kv heads: values and autograd grads."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    q = rng.standard_normal((1, 4, 128, 64)).astype(np.float32)
    k = rng.standard_normal((1, 2, 128, 64)).astype(np.float32)
    v = rng.standard_normal((1, 2, 128, 64)).astype(np.float32)

    def jloss(q, k, v):
        return jnp.sum(jax_attention.flash_attention(q, k, v, causal=True) ** 2)

    jout = jax_attention.flash_attention(*(jnp.asarray(a) for a in (q, k, v)), causal=True)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = A.flash_attention(tq, tk, tv, causal=True)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=1e-4, atol=1e-4)
    for mine, theirs in zip((tq.grad, tk.grad, tv.grad), jgrads):
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), rtol=1e-3, atol=1e-3)


def _ce_inputs(seed: int, n: int = 256, e: int = 128, v: int = 512):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, e)).astype(np.float32)
    w = (rng.standard_normal((e, v)) * 0.1).astype(np.float32)
    t = rng.integers(0, v, n).astype(np.int32)
    return x, w, t


def test_ce_lse_and_dlogits_match_pallas_interpret(jax_ce) -> None:
    import jax.numpy as jnp

    x, w, t = _ce_inputs(12)
    lse_pl = jax_ce._ce_lse_pallas(jnp.asarray(x), jnp.asarray(w), interpret=True)
    lse = C.ce_lse(*_t(x, w))
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_pl), rtol=1e-5)
    tl = C._target_logit(*_t(x, w), torch.from_numpy(t))
    np.testing.assert_allclose(
        tl.numpy(), np.asarray(jax_ce._target_logit(jnp.asarray(x), jnp.asarray(w), jnp.asarray(t))),
        rtol=1e-5, atol=1e-5,
    )
    scale = 0.37
    dl_pl = jax_ce._ce_dlogits_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(t),
                                      lse_pl, scale, interpret=True)
    dl = C.ce_dlogits(*_t(x, w, t, np.asarray(lse_pl)), torch.tensor(scale))
    np.testing.assert_allclose(dl.numpy(), np.asarray(dl_pl), rtol=1e-4, atol=1e-5)


def test_fused_ce_autograd_matches_jax_grad(jax_ce) -> None:
    import jax
    import jax.numpy as jnp

    x, w, t = _ce_inputs(11, n=64, e=32, v=256)
    jx, jw, jt = jnp.asarray(x), jnp.asarray(w), jnp.asarray(t)
    jloss = jax_ce.fused_linear_cross_entropy(jx, jw, jt)
    jdx, jdw = jax.grad(jax_ce.fused_linear_cross_entropy, argnums=(0, 1))(jx, jw, jt)
    tx, tw = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    loss = C.fused_linear_cross_entropy(tx, tw, torch.from_numpy(t))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), rtol=1e-4, atol=1e-5)


def test_rms_norm_matches_jax() -> None:
    import jax
    import jax.numpy as jnp

    rms = import_reference("torchft_tpu.ops.rmsnorm")
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 8, 64)).astype(np.float32)
    w = rng.standard_normal((64,)).astype(np.float32)
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    jgx, jgw = jax.grad(lambda x, w: jnp.sum(rms.rms_norm(x, w) ** 2), argnums=(0, 1))(jx, jw)
    tx, tw = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    out = rms_norm(tx, tw)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(rms.rms_norm(jx, jw)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgw), rtol=1e-4, atol=1e-4)


# -- on the card -------------------------------------------------------------


def _bf16(rng, *shape, device, std=1.0):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * std).to(
        device=device, dtype=torch.bfloat16
    )


def _assert_close(got, ref, rtol: float, row: float, atol: float, what: str) -> None:
    """Element-wise: |got - ref| <= rtol |ref| + row x rms(ref's row) + atol,
    a row being the last axis (the tolerances chip_smoke.py states)."""
    ref = ref.float()
    allowed = rtol * ref.abs() + row * ref.square().mean(-1, keepdim=True).sqrt() + atol
    over = ((got.float() - ref).abs() / allowed).max()
    assert over <= 1.0, f"{what}: error {float(over):.3f}x its tolerance"


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("seq", [200, 1024])
def test_flash_kernels_match_plain_on_card(cuda_device, causal, seq) -> None:
    """Ragged (200) and tiled (1024) sequences; bf16 in.  O and the grads
    within 1e-2 |ref| + 2e-2 rms(ref row) + 1e-4 (bf16 outputs, bf16 P/dS
    in the products), lse within 1e-4."""
    rng = np.random.default_rng(21)
    q, k, v, g = (_bf16(rng, 4, seq, 128, device=cuda_device) for _ in range(4))
    o, lse = A.flash_fwd(q, k, v, SCALE, causal)
    o_ref, lse_ref = A._fa_reference(q.float(), k.float(), v.float(), SCALE, causal)
    _assert_close(o, o_ref, 1e-2, 2e-2, 1e-4, "O")
    _assert_close(lse, lse_ref, 0.0, 0.0, 1e-4, "lse")
    grads = A.flash_bwd(q, k, v, o, lse, g, SCALE, causal)
    refs = A._fa_bwd_reference(q.float(), k.float(), v.float(), o.float(), lse, g.float(),
                               SCALE, causal)
    for got, ref, name in zip(grads, refs, ("dq", "dk", "dv")):
        _assert_close(got, ref, 1e-2, 2e-2, 1e-4, name)


@pytest.mark.gpu
def test_ce_kernels_match_plain_on_card(cuda_device) -> None:
    """Ragged N and V (V % 8 == 0); lse within 1e-4, dlogits element-wise
    within 2e-2 |ref| + 1e-6 (a typical off-target entry is ~1e-3 here)."""
    rng = np.random.default_rng(22)
    n, e, v = 300, 256, 1000
    x = _bf16(rng, n, e, device=cuda_device)
    w = _bf16(rng, e, v, device=cuda_device, std=e ** -0.5)
    t = torch.from_numpy(rng.integers(0, v, n)).to(cuda_device)
    lse = C.ce_lse(x, w)
    lse_ref = C._ce_lse_reference(x, w)
    _assert_close(lse, lse_ref, 0.0, 0.0, 1e-4, "lse")
    one = torch.ones(1, device=cuda_device)
    dl = C.ce_dlogits(x, w, t, lse_ref, one)
    dl_ref = C._ce_dlogits_reference(x.float(), w.float(), t, lse_ref, 1.0)
    _assert_close(dl, dl_ref, 2e-2, 0.0, 1e-6, "dlogits")


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize(
    "what, call",
    [
        ("head dim 64", lambda: A.flash_fwd(*(_meta(2, 256, 64) for _ in range(3)), SCALE, True)),
        ("k shorter than q", lambda: A.flash_fwd(_meta(2, 256, 128), _meta(2, 128, 128),
                                                 _meta(2, 128, 128), SCALE, True)),
        ("not a CUDA tensor", lambda: A.flash_fwd(*(_meta(2, 256, 128) for _ in range(3)),
                                                  SCALE, True)),
        ("backward, head dim 64", lambda: A.flash_bwd(
            *(_meta(2, 256, 64) for _ in range(4)), _meta(2, 256, dtype=torch.float32),
            _meta(2, 256, 64), SCALE, True)),
        ("backward, not a CUDA tensor", lambda: A.flash_bwd(
            *(_meta(2, 256, 128) for _ in range(4)), _meta(2, 256, dtype=torch.float32),
            _meta(2, 256, 128), SCALE, True)),
    ],
)
def test_flash_wrappers_raise_before_launch(what, call) -> None:
    """A tensor the kernels do not take raises in the wrapper, before a
    kernel library is loaded and before a launch is counted."""
    kernels = (A.FLASH_FWD, A.FLASH_BWD_DKDV, A.FLASH_BWD_DQ)
    before = [(k.launches, k._fn) for k in kernels]
    with pytest.raises(ValueError):
        call()
    assert [(k.launches, k._fn) for k in kernels] == before, what


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("seq", [1000, 4096])
def test_flash_kernels_one_head_long_and_ragged_on_card(cuda_device, causal, seq) -> None:
    """One head (BH 1): a sequence that is not a multiple of the 128-row
    tiles, and a long one; the tolerances of the test above."""
    rng = np.random.default_rng(23)
    q, k, v, g = (_bf16(rng, 1, seq, 128, device=cuda_device) for _ in range(4))
    o, lse = A.flash_fwd(q, k, v, SCALE, causal)
    o_ref, lse_ref = A._fa_reference(q.float(), k.float(), v.float(), SCALE, causal)
    _assert_close(o, o_ref, 1e-2, 2e-2, 1e-4, "O")
    _assert_close(lse, lse_ref, 0.0, 0.0, 1e-4, "lse")
    grads = A.flash_bwd(q, k, v, o, lse, g, SCALE, causal)
    refs = A._fa_bwd_reference(q.float(), k.float(), v.float(), o.float(), lse, g.float(),
                               SCALE, causal)
    for got, ref, name in zip(grads, refs, ("dq", "dk", "dv")):
        _assert_close(got, ref, 1e-2, 2e-2, 1e-4, name)


@pytest.mark.gpu
def test_flash_bwd_dkdv_bitwise_repeatable_on_card(cuda_device) -> None:
    """No atomics and one writer per output tile: two launches on the same
    inputs give the same dK and dV bit for bit."""
    rng = np.random.default_rng(24)
    q, k, v, g = (_bf16(rng, 12, 1000, 128, device=cuda_device) for _ in range(4))
    o, lse = A.flash_fwd(q, k, v, SCALE, True)
    first = A.flash_bwd(q, k, v, o, lse, g, SCALE, True)
    second = A.flash_bwd(q, k, v, o, lse, g, SCALE, True)
    assert torch.equal(first[1], second[1]) and torch.equal(first[2], second[2])


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_dq_bitwise_repeatable_on_card(cuda_device, causal) -> None:
    """The dQ kernel, too, has one writer per output tile and no atomics."""
    rng = np.random.default_rng(25)
    q, k, v, g = (_bf16(rng, 12, 1000, 128, device=cuda_device) for _ in range(4))
    o, lse = A.flash_fwd(q, k, v, SCALE, causal)
    first = A.flash_bwd(q, k, v, o, lse, g, SCALE, causal)
    second = A.flash_bwd(q, k, v, o, lse, g, SCALE, causal)
    assert torch.equal(first[0], second[0])


@pytest.mark.gpu
@pytest.mark.parametrize("n, e, v", [(1000, 128, 520), (256, 784, 1000), (129, 16, 8)])
def test_ce_lse_ragged_edges_on_card(cuda_device, n, e, v) -> None:
    """Edges of ce_lse's tiles: 64-column boxes of w wholly past V (V 520
    in a 768-column tile), E not a multiple of the 64-wide chunks (784),
    and the smallest E and V the wrapper takes; lse within 1e-4."""
    rng = np.random.default_rng(26)
    x = _bf16(rng, n, e, device=cuda_device)
    w = _bf16(rng, e, v, device=cuda_device, std=e ** -0.5)
    _assert_close(C.ce_lse(x, w), C._ce_lse_reference(x, w), 0.0, 0.0, 1e-4, "lse")


@pytest.mark.gpu
@pytest.mark.parametrize("n, e, v", [(1000, 128, 520), (256, 784, 1000), (129, 16, 8)])
def test_ce_dlogits_ragged_edges_on_card(cuda_device, n, e, v) -> None:
    """The same edges for ce_dlogits, whose TMA stores must clip rows past
    N and columns past V (at V 8 all but 8 columns of the one 256-column
    tile); element-wise within 2e-2 |ref| + 1e-6."""
    rng = np.random.default_rng(27)
    x = _bf16(rng, n, e, device=cuda_device)
    w = _bf16(rng, e, v, device=cuda_device, std=e ** -0.5)
    t = torch.from_numpy(rng.integers(0, v, n)).to(cuda_device)
    lse = C._ce_lse_reference(x, w)
    dl = C.ce_dlogits(x, w, t, lse, torch.full((1,), 0.5, device=cuda_device))
    _assert_close(dl, C._ce_dlogits_reference(x.float(), w.float(), t, lse, 0.5), 2e-2, 0.0,
                  1e-6, "dlogits")


@pytest.mark.gpu
def test_ce_dlogits_bitwise_repeatable_on_card(cuda_device) -> None:
    """One writer per output element and no atomics: two launches on the
    same inputs give the same dlogits bit for bit."""
    rng = np.random.default_rng(28)
    n, e, v = 1000, 256, 4000
    x = _bf16(rng, n, e, device=cuda_device)
    w = _bf16(rng, e, v, device=cuda_device, std=e ** -0.5)
    t = torch.from_numpy(rng.integers(0, v, n)).to(cuda_device)
    lse = C.ce_lse(x, w)
    scale = torch.full((1,), 1.0 / n, device=cuda_device)
    assert torch.equal(C.ce_dlogits(x, w, t, lse, scale), C.ce_dlogits(x, w, t, lse, scale))


@pytest.mark.parametrize(
    "what, call",
    [
        ("ce_lse, E % 16 != 0", lambda: C.ce_lse(_meta(64, 40), _meta(40, 256))),
        ("ce_lse, V % 8 != 0", lambda: C.ce_lse(_meta(64, 32), _meta(32, 250))),
        ("ce_lse, mismatched E", lambda: C.ce_lse(_meta(64, 32), _meta(48, 256))),
        ("ce_lse, not a CUDA tensor", lambda: C.ce_lse(_meta(64, 32), _meta(32, 256))),
        ("ce_dlogits, E % 16 != 0", lambda: C.ce_dlogits(
            _meta(64, 40), _meta(40, 256), _meta(64, dtype=torch.int32),
            _meta(64, dtype=torch.float32), _meta(1, dtype=torch.float32))),
        ("ce_dlogits, V % 8 != 0", lambda: C.ce_dlogits(
            _meta(64, 32), _meta(32, 250), _meta(64, dtype=torch.int32),
            _meta(64, dtype=torch.float32), _meta(1, dtype=torch.float32))),
        ("ce_dlogits, mismatched E", lambda: C.ce_dlogits(
            _meta(64, 32), _meta(48, 256), _meta(64, dtype=torch.int32),
            _meta(64, dtype=torch.float32), _meta(1, dtype=torch.float32))),
        ("ce_dlogits, not a CUDA tensor", lambda: C.ce_dlogits(
            _meta(64, 32), _meta(32, 256), _meta(64, dtype=torch.int32),
            _meta(64, dtype=torch.float32), _meta(1, dtype=torch.float32))),
    ],
)
def test_ce_wrappers_raise_before_launch(what, call) -> None:
    """The cross-entropy twin of the test above: each input the kernels do
    not take raises its own error in the wrapper, before a kernel library
    is loaded and before a launch is counted."""
    match = {"E % 16": "E % 16", "V % 8": "V % 8", "mismatched E": r"x \[N, E\]",
             "not a CUDA": "CUDA device"}
    kernels = (C.CE_LSE, C.CE_DLOGITS)
    before = [(k.launches, k._fn) for k in kernels]
    with pytest.raises(ValueError, match=next(m for key, m in match.items() if key in what)):
        call()
    assert [(k.launches, k._fn) for k in kernels] == before, what


@pytest.mark.parametrize("n, v, blocks", [
    (16384, 32000, 132),  # the flagship
    (16384, 32000, 114),  # the flagship on a card with fewer SMs
    (300, 1000, 132),
    (1000, 520, 132),
    (16000, 32008, 132),
    (129, 8, 132),
    (128 * 132, 256 * 10, 132),
])
def test_vocab_slices_cover_v_in_whole_tiles(n, v, blocks) -> None:
    """ce_lse's slices: whole 256-column tiles, none empty, together exactly
    V's columns; and the busiest block holds at most 2% more tiles than an
    even spread, unless the slices are single tiles already."""
    per, slices = C._vocab_slices(n, v, blocks)
    assert per % 256 == 0 and per > 0
    assert (slices - 1) * per < v <= slices * per
    row_tiles, v_tiles = -(-n // 128), -(-v // 256)
    busiest = -(-(row_tiles * slices) // blocks) * (per // 256)
    assert per == 256 or busiest <= 1.02 * row_tiles * v_tiles / blocks
    if (n, v, blocks) == (16384, 32000, 132):
        assert (per, slices) == (768, 42)


@pytest.mark.parametrize("variant", ["full_tile_3_stages", "direct_st_global", "evict_first"])
def test_ce_dlogits_ab_variants_apply_to_the_kernel_source(variant) -> None:
    """tools/ab_ce_dlogits.py derives each design variant from
    csrc/cross_entropy.cu by text substitution: every substitution still
    finds its one anchor, and only the K5 epilogue or staging changes."""
    from torchft_tpu_torch import _build
    from torchft_tpu_torch.tools import ab_ce_dlogits as ab

    with open(f"{_build.CSRC_DIR}/cross_entropy.cu") as f:
        src = f.read()
    assert ab.variant_source("kept", src) == src
    out = ab.variant_source(variant, src)
    assert out != src
    assert out[: src.index("namespace dlogits {")].replace("STAGES = 3", "STAGES = 4") == \
        src[: src.index("namespace dlogits {")]
    assert ("STAGES = 3" in out) == (variant == "full_tile_3_stages")
    assert ("sm.out" in out) == (variant != "direct_st_global")
    assert ("L2::cache_hint" in out) == (variant == "evict_first")


def test_spill_bytes_reads_the_ptxas_report() -> None:
    """chip_smoke.py fails on a spill in a wgmma kernel; this is the parser
    it reads ptxas's remarks with."""
    from torchft_tpu_torch._build import spill_bytes

    log = (
        "ptxas info    : Compiling entry function '_ZN3tft3lse13ce_lse_kernelEii' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN3tft3lse13ce_lse_kernelEii\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 168 registers, used 1 barriers, 480 bytes cmem[0]\n"
        "ptxas info    : Function properties for _ZN3tft2dq19flash_bwd_dq_kernelEi\n"
        "    16 bytes stack frame, 12 bytes spill stores, 8 bytes spill loads\n"
    )
    assert spill_bytes(log) == {"_ZN3tft3lse13ce_lse_kernelEii": 0,
                                "_ZN3tft2dq19flash_bwd_dq_kernelEi": 20}
    assert spill_bytes("ptxas info    : 0 bytes gmem\n") == {}
