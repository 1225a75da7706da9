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

``rms_plan`` (the kernel's path, row ring and grid for a shape) is pure
Python and pinned here: the path for aligned and unaligned widths, the
ring within a block's shared memory, and the grid-stride walk covering
every row once.

The test marked ``gpu`` holds the Hopper kernel against the plain version
on the card; it skips where there is no card.
"""

from __future__ import annotations

import re

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


# -- the plan (no card) -------------------------------------------------------

BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("d,dtype,path", [
    (768, BF16, "tma"), (768, F32, "tma"), (2048, BF16, "tma"), (2048, F32, "tma"),
    (1000, BF16, "tma"), (1000, F32, "tma"), (8, BF16, "tma"), (4, F32, "tma"),
    (1001, BF16, "scalar"), (1001, F32, "scalar"), (1004, BF16, "scalar"), (6, F32, "scalar"),
    (28960, BF16, "tma"), (28968, BF16, "vector"), (28976, F32, "tma"), (28980, F32, "vector"),
])
def test_rms_plan_picks_the_path_by_shape(d, dtype, path) -> None:
    """A row that is a multiple of 16 bytes takes the rings while two stages
    of one row and w fit a block's shared memory, else the vector path; any
    other row the scalar path."""
    p = R.rms_plan(64, d, dtype)
    assert p.path == path
    if path != "tma":
        assert (p.rows_per_tile, p.stages, p.smem_bytes, p.blocks) == (0, 0, 0, 8)


def test_rms_plan_at_the_flagship_and_large_config_widths() -> None:
    """The arithmetic of the note at the head of csrc/rmsnorm.cu."""
    assert R.rms_plan(16384, 768, BF16) == R.RmsPlan("tma", 2, 2, 52864, 528, 1)
    assert R.rms_plan(8192, 2048, F32) == R.RmsPlan("tma", 1, 2, 66176, 396, 2)
    assert R.rms_plan(16384, 768, F32) == R.RmsPlan("tma", 1, 2, 49792, 528, 1)
    assert R.rms_plan(8192, 2048, BF16) == R.RmsPlan("tma", 1, 3, 107136, 264, 1)
    assert R.rms_plan(16384, 768, BF16, sms=100).blocks == 400


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("d", [768, 2048, 4096, 8192])
def test_rms_plan_rings_fit_shared_memory(d, dtype) -> None:
    """Every group's ring of R rows x stages, plus the barriers and (bf16
    rows) a copy of w, fits a block's shared memory, and the blocks an SM
    fit the SM's; a group's lanes hold its row in at most 8 vectors each."""
    p = R.rms_plan(16384, d, dtype)
    row = d * dtype.itemsize
    groups = 8 // p.warps_per_row
    rings = groups * p.rows_per_tile * p.stages * row
    assert p.path == "tma" and p.stages >= 2
    assert p.rows_per_tile * row <= max(R.TILE_BYTES, row)
    w_copy = -(-d * 4 // 128) * 128 if dtype == BF16 else 0
    assert p.smem_bytes == 640 + w_copy + rings <= R.SMEM_PER_BLOCK == 232448
    per_sm = p.blocks // 132
    assert per_sm >= 1 and per_sm * (p.smem_bytes + 1024) <= R.SMEM_PER_SM
    assert d // (16 // dtype.itemsize) <= 8 * 32 * p.warps_per_row


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("rows", [1, 15, 16383, 16384])
def test_rms_plan_walk_covers_every_row_once(rows, dtype) -> None:
    """The kernel's grid-stride walk as csrc/rmsnorm.cu runs it: group g of
    block b walks tiles b * groups + g, then every blocks * groups-th; its
    it-th tile waits on slot it % stages with parity (it / stages) & 1 and
    expects that tile's rows' bytes.  Every row is covered exactly once, a
    slot's phases alternate, and no block is left without a tile."""
    d = 768
    p = R.rms_plan(rows, d, dtype)
    rt, row = p.rows_per_tile, d * dtype.itemsize
    groups = 8 // p.warps_per_row
    ntiles = -(-rows // rt)
    walkers = p.blocks * groups
    assert (p.blocks - 1) * groups < ntiles
    seen = np.zeros(rows, dtype=np.int64)
    for walker in range(walkers):
        last_parity = {}
        for it, tile in enumerate(range(walker, ntiles, walkers)):
            slot, parity = it % p.stages, (it // p.stages) & 1
            assert last_parity.get(slot, 1) != parity
            last_parity[slot] = parity
            n = min(rt, rows - tile * rt)
            assert n >= 1 and (n * row) % 16 == 0
            seen[tile * rt: tile * rt + n] += 1
    assert (seen == 1).all()


def test_kernel_source_agrees_with_the_plan() -> None:
    """The wrapper's argument list is the one csrc/rmsnorm.cu takes, and the
    plan sizes its rings by the source's shared-memory layout (the kernel
    works the bytes out itself and refuses a ring that does not fit)."""
    from torchft_tpu_torch import _build

    with open(f"{_build.CSRC_DIR}/rmsnorm.cu") as f:
        src = f.read()
    sig = re.search(r'extern "C" int tf_rms_norm\(([^)]*)\)', src).group(1)
    assert len(sig.split(",")) == len(R.RMS_NORM._argtypes)
    assert f"constexpr int kHeadBytes = {R._HEAD_BYTES};" in src
    assert f"constexpr int kMaxSmem = {R.SMEM_PER_BLOCK};" in src
    assert "constexpr int kThreads = 256;" in src


def test_ab_rms_norm_tells_the_two_kernel_abis_apart() -> None:
    """The A/B tool binds each tree's ``tf_rms_norm`` by its own parameter
    names: this tree's as the wrapper binds it, and the earlier one (x, w,
    out, rows, d, eps, x_is_bf16, stream) without a plan."""
    import ctypes

    from torchft_tpu_torch import _build
    from torchft_tpu_torch.tools import ab_rms_norm as ab

    with open(f"{_build.CSRC_DIR}/rmsnorm.cu") as f:
        names, types = zip(*ab.signature(f.read()))
    assert list(types) == R.RMS_NORM._argtypes
    assert names[7:] == ("rows_per_tile", "stages", "warps_per_row", "blocks", "stream")
    old = ab.signature('extern "C" int tf_rms_norm(const void* x, const void* w, void* out, '
                       'int rows, int d, float eps,\n int x_is_bf16, void* stream) {')
    assert [n for n, _ in old] == ["x", "w", "out", "rows", "d", "eps", "x_is_bf16", "stream"]
    assert old[5][1] is ctypes.c_float


def test_ab_rms_norm_variants_apply_to_this_source() -> None:
    """Each design variant of the A/B tool changes this tree's source in one
    place, and each one-choice change of the plan at the timed shapes
    keeps a ring that fits a block's and an SM's shared memory."""
    from torchft_tpu_torch import _build
    from torchft_tpu_torch.tools import ab_rms_norm as ab

    with open(f"{_build.CSRC_DIR}/rmsnorm.cu") as f:
        src = f.read()
    variants = ab.variant_sources(src)
    assert set(variants) == {"new", *ab.SOURCE_VARIANTS} and len(set(variants.values())) == 4
    for rows, d in ab.TIMED:
        for dtype in (BF16, F32):
            plan = R.rms_plan(rows, d, dtype)
            for name in ab.PLAN_VARIANTS:
                p = ab.plan_variant(plan, name, rows, d, dtype, 132)
                if p is None:
                    continue
                assert p != plan and p.smem_bytes <= R.SMEM_PER_BLOCK
                assert p.blocks // 132 * (p.smem_bytes + 1024) <= R.SMEM_PER_SM
            assert ab.plan_variant(plan, "blocks_less", rows, d, dtype, 132) is not None


def _variant(rows: int, d: int, dtype) -> tuple:
    """The kernel instance csrc/rmsnorm.cu launches for a shape: the path,
    and on the ring the warps a row, the vectors a lane keeps in registers
    (the template: 4, 6 or 8) and whether the row fits them."""
    p = R.rms_plan(rows, d, dtype)
    if p.path != "tma":
        return (p.path,)
    nv = d // (16 // dtype.itemsize)
    lanes = 32 * p.warps_per_row
    per_lane = -(-nv // lanes)
    cache = 4 if per_lane <= 4 else 6 if per_lane <= 6 else 8
    return ("tma", p.warps_per_row, cache, nv <= cache * lanes)


# The card test's shapes: the timed ones, a partial last tile, one row, d
# 1000 and 1001, 3-D and 1-D, then one for each other variant of the kernel.
CARD_SHAPES = [(16384, 768), (8192, 2048), (16383, 768), (1, 768), (300, 1000), (300, 1001),
               (4, 50, 768), (768,), (64, 1536), (64, 512), (4100, 4096), (2640, 8192),
               (600, 20000), (2, 30000)]


def test_card_shapes_reach_every_variant_of_the_kernel() -> None:
    """Every path, every register template in both dtypes, groups of 1, 2,
    4 and 8 warps a row, and rows wider than the registers hold, are
    launched by the card test (and by chip_smoke.py's K6 checks, which take
    the same shapes); groups of several warps walk their rings more than
    once."""
    seen = set()
    for shape in CARD_SHAPES:
        rows = int(np.prod(shape[:-1]))
        for dtype in (BF16, F32):
            seen.add(_variant(rows, shape[-1], dtype) + (dtype,))
            p = R.rms_plan(rows, shape[-1], dtype)
            if p.path == "tma" and p.warps_per_row > 1 and rows > 64:
                walkers = p.blocks * 8 // p.warps_per_row
                assert -(-rows // p.rows_per_tile) > p.stages * walkers
    assert {v[0] for v in seen} == {"tma", "vector", "scalar"}
    for dtype in (BF16, F32):
        ring = {v[1:-1] for v in seen if v[0] == "tma" and v[-1] == dtype}
        assert {c for _, c, _ in ring} == {4, 6, 8}
        assert {g for g, _, _ in ring} == {1, 2, 4, 8}
        assert (8, 8, False) in ring
        assert ("vector", dtype) in seen and ("scalar", dtype) in seen


# -- on the card -------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", CARD_SHAPES)
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
