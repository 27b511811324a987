"""The port's nearest-code search (rqvae_tpu_torch.ops.rq_kernel) against the
JAX package: nearest_code_plain and the CPU nearest_code wrapper against
_nearest_code_xla and the Pallas kernel run with interpret=True, on
numpy-seeded data of a few shapes (ragged ones included). Codes must be
equal; each case first asserts that its data has no near-tie (an fp64 gap
above 1e-3 between the best two codes of every row), so that equal codes do
not hang on fp32 rounding. Planted duplicate codebook rows must give the
first index in both packages.

The CUDA kernel (csrc/nearest_code.cu, 3xTF32 on wgmma) runs only on the
card; here: its launch plan (every (row block, code tile) unit once over the
persistent CTAs, shared memory, scratch sizes) and its arithmetic restated
in fp64 from split_tf32 (the kernel's hi / lo split): the three products
pick the JAX codes on SHAPES and keep the planted ties.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rqvae_tpu.ops.rq_kernel import _nearest_code_pallas, _nearest_code_xla
from rqvae_tpu_torch.ops import decode_layer_kernel as DK
from rqvae_tpu_torch.ops import rq_kernel as RK

SHAPES = [  # (rows, dim, codes, seed): ragged against 128-code tiles and 16-wide dim steps
    (300, 48, 200, 1),
    (128, 16, 64, 100),
    (257, 64, 1000, 201),
    (40, 256, 2500, 301),
]


def _min_gap(x: np.ndarray, cb: np.ndarray) -> float:
    d = ((x[:, None, :].astype(np.float64) - cb[None].astype(np.float64)) ** 2).sum(-1)
    d.sort(axis=1)
    return float((d[:, 1] - d[:, 0]).min())


def _jax_codes(x, cb):
    xla = np.asarray(_nearest_code_xla(jnp.asarray(x), jnp.asarray(cb)))
    pallas = np.asarray(_nearest_code_pallas(jnp.asarray(x), jnp.asarray(cb), interpret=True))
    return xla, pallas


@pytest.mark.parametrize("n,dim,e,seed", SHAPES)
def test_nearest_code_matches_jax(n, dim, e, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, dim).astype(np.float32)
    cb = rng.randn(e, dim).astype(np.float32)
    assert _min_gap(x, cb) > 1e-3
    xla, pallas = _jax_codes(x, cb)
    plain = RK.nearest_code_plain(torch.from_numpy(x), torch.from_numpy(cb))
    wrapped = RK.nearest_code(torch.from_numpy(x), torch.from_numpy(cb))
    assert plain.dtype == torch.long and plain.shape == (n,)
    np.testing.assert_array_equal(plain.numpy(), xla)
    np.testing.assert_array_equal(wrapped.numpy(), pallas)


def test_nearest_code_keeps_leading_shape_and_casts_to_fp32():
    rng = np.random.RandomState(5)
    x = rng.randn(2, 3, 5, 32).astype(np.float32)
    cb = rng.randn(100, 32).astype(np.float32)
    want = np.asarray(_nearest_code_xla(jnp.asarray(x), jnp.asarray(cb)))
    got = RK.nearest_code(torch.from_numpy(x), torch.from_numpy(cb).double())
    assert got.shape == (2, 3, 5) and got.dtype == torch.long
    np.testing.assert_array_equal(got.numpy(), want)


TIE_CASES = [
    (300, 48, 200, [(3, 4), (1, 150), (10, 199)]),
    (64, 256, 3000, [(5, 2999), (100, 101), (7, 2048)]),
]


def _planted(n, dim, e, pairs):
    """Row hi of the codebook is a copy of row lo < hi; x rows 2i and 2i+1
    are row hi itself and row hi + 1e-3 noise: (x, cb, the codes those rows
    must get)."""
    rng = np.random.RandomState(7)
    cb = rng.randn(e, dim).astype(np.float32)
    x = rng.randn(n, dim).astype(np.float32)
    for i, (lo, hi) in enumerate(pairs):
        cb[hi] = cb[lo]
        x[2 * i] = cb[hi]
        x[2 * i + 1] = cb[hi] + 1e-3 * rng.randn(dim).astype(np.float32)
    return x, cb, np.repeat([lo for lo, _ in pairs], 2)


@pytest.mark.parametrize("n,dim,e,pairs", TIE_CASES)
def test_planted_ties_give_the_first_index(n, dim, e, pairs):
    """Both rows planted on a duplicated codebook row must get the lower index."""
    x, cb, want = _planted(n, dim, e, pairs)
    k = len(want)
    xla, pallas = _jax_codes(x, cb)
    got = RK.nearest_code(torch.from_numpy(x), torch.from_numpy(cb)).numpy()
    for name, codes in (("xla", xla), ("pallas", pallas), ("port", got)):
        np.testing.assert_array_equal(codes[:k], want, err_msg=name)
    np.testing.assert_array_equal(got, xla)


def test_wrapper_raises_on_a_device_without_a_kernel():
    x = torch.empty(4, 8, device="meta")
    cb = torch.empty(16, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        RK.nearest_code(x, cb)


@pytest.mark.parametrize("e,want", [(1, 1), (128, 1), (512, 2), (513, 3), (16384, 64)])
def test_codebook_splits_cover_every_code(e, want):
    """The launch keeps one partial per code tile of CODE_TILE (256) codes:
    the tiles must cover every code and leave none without one."""
    s = RK.splits(e)
    assert s == want
    assert (s - 1) * RK.CODE_TILE < e <= s * RK.CODE_TILE


PLANS = [  # (rows, dim, codes): the encode shape, the chip check's ragged ones, SHAPES
    (6400, 256, 16384), (300, 48, 200), (77, 20, 1000), (1, 256, 16384), (128, 16, 64), (257, 64, 1000),
    (40, 256, 2500),
]


@pytest.mark.parametrize("n,dim,e", PLANS)
@pytest.mark.parametrize("sms", [132, 7])
def test_plan_covers_every_unit_once(n, dim, e, sms):
    """nearest_plan: every (row block, code tile) unit, and so every (row,
    code) pair, once over the persistent CTAs; no CTA without a unit; each
    CTA's units in the order the kernel's producer and consumers walk them
    (rank u = b, b + grid, ...)."""
    plan = RK.nearest_plan(n, dim=dim, E=e, sms=sms)
    seen = [u for cta in range(plan.grid) for u in plan.units(cta)]
    assert sorted(seen) == [(rb, ct) for rb in range(plan.row_blocks) for ct in range(plan.code_tiles)]
    assert plan.grid == min(sms, len(seen)) and all(next(plan.units(c), None) for c in range(plan.grid))
    assert (plan.row_blocks - 1) * RK.ROW_TILE < n <= plan.row_blocks * RK.ROW_TILE
    assert plan.code_tiles == RK.splits(e)
    for cta in range(plan.grid):
        units = list(plan.units(cta))
        assert [rb + ct * plan.row_blocks for rb, ct in units] == list(range(cta, len(seen), plan.grid))


def test_plan_shared_memory_and_scratch():
    """Two 96 KB stages (x_hi, x_lo [128, 32], cb_hi, cb_lo [256, 32] fp32)
    and the mbarriers fit the 227 KB a block may hold; at the encode shape
    the split scratch is x 6.55 MB and the codebook 16.8 MB, twice each
    (hi and lo), cb_sq one float a code and one partial per (code tile,
    row); a ragged dim pads to 32 columns, a ragged E to a whole tile."""
    assert RK.smem_bytes() == 2 * 98304 + 32 + 1024 <= DK.SMEM_LIMIT == 232448
    sc = RK.nearest_plan(6400, 16384, 256).scratch()
    assert sc == {"xs": (6400, 512), "cs": (16384, 512), "cb_sq": (16384,), "part": (64, 6400)}
    assert 4 * 6400 * 256 == 6_553_600 and 4 * 16384 * 256 == 16_777_216
    sc = RK.nearest_plan(300, 200, 48).scratch()
    assert sc == {"xs": (300, 128), "cs": (200, 128), "cb_sq": (256,), "part": (1, 300)}
    with pytest.raises(ValueError, match="N, E, dim >= 1"):
        RK.nearest_plan(0, 16, 8)


def test_split_tf32_keeps_22_bits():
    """hi has the 13 low mantissa bits zero (a TF32 value), lo too, and hi +
    lo is v within 2^-22 |v|, over six decades and both signs."""
    rng = np.random.RandomState(11)
    v = torch.from_numpy((rng.randn(20000) * 10.0 ** rng.uniform(-3, 3, 20000)).astype(np.float32))
    hi, lo = RK.split_tf32(v)
    for part in (hi, lo):
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    err = (v.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0 ** -22 * v.double().abs()).all())
    assert float((hi.double() - v.double()).abs().max()) > 0  # the split is not the identity


def _three_product_codes(x: np.ndarray, cb: np.ndarray) -> np.ndarray:
    """The kernel's arithmetic, with every product and sum in fp64: cb_sq -
    2 (x_lo c_hi + x_hi c_lo + x_hi c_hi), first index on ties."""
    xh, xl = (t.double() for t in RK.split_tf32(torch.from_numpy(x)))
    ch, cl = (t.double() for t in RK.split_tf32(torch.from_numpy(cb)))
    cb_sq = torch.from_numpy(cb).double().square().sum(1)
    dot = xl @ ch.T + xh @ cl.T + xh @ ch.T
    return torch.argmin(cb_sq - 2.0 * dot, dim=1).numpy()


@pytest.mark.parametrize("n,dim,e,seed", SHAPES)
def test_three_product_split_picks_the_jax_codes(n, dim, e, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, dim).astype(np.float32)
    cb = rng.randn(e, dim).astype(np.float32)
    xla, pallas = _jax_codes(x, cb)
    got = _three_product_codes(x, cb)
    np.testing.assert_array_equal(got, xla)
    np.testing.assert_array_equal(got, pallas)


@pytest.mark.parametrize("n,dim,e,pairs", TIE_CASES)
def test_three_product_split_keeps_planted_ties(n, dim, e, pairs):
    x, cb, want = _planted(n, dim, e, pairs)
    got = _three_product_codes(x, cb)
    np.testing.assert_array_equal(got[: len(want)], want)
    np.testing.assert_array_equal(got, np.asarray(_nearest_code_xla(jnp.asarray(x), jnp.asarray(cb))))
