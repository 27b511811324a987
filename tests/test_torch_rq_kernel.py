"""The port's nearest-code search (rqvae_tpu_torch.ops.rq_kernel) against the
JAX package: nearest_code_plain and the CPU nearest_code wrapper against
_nearest_code_xla and the Pallas kernel run with interpret=True, on
numpy-seeded data of a few shapes (ragged ones included). Codes must be
equal; each case first asserts that its data has no near-tie (an fp64 gap
above 1e-3 between the best two codes of every row), so that equal codes do
not hang on fp32 rounding. Planted duplicate codebook rows must give the
first index in both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rqvae_tpu.ops.rq_kernel import _nearest_code_pallas, _nearest_code_xla
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


@pytest.mark.parametrize("n,dim,e,pairs", [
    (300, 48, 200, [(3, 4), (1, 150), (10, 199)]),
    (64, 256, 3000, [(5, 2999), (100, 101), (7, 2048)]),
])
def test_planted_ties_give_the_first_index(n, dim, e, pairs):
    """Row hi of the codebook is a copy of row lo < hi; x rows 2i and 2i+1
    are row hi itself and row hi + 1e-3 noise. Both must get lo."""
    rng = np.random.RandomState(7)
    cb = rng.randn(e, dim).astype(np.float32)
    x = rng.randn(n, dim).astype(np.float32)
    for i, (lo, hi) in enumerate(pairs):
        cb[hi] = cb[lo]
        x[2 * i] = cb[hi]
        x[2 * i + 1] = cb[hi] + 1e-3 * rng.randn(dim).astype(np.float32)
    want = np.repeat([lo for lo, _ in pairs], 2)
    k = 2 * len(pairs)
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


@pytest.mark.parametrize("e,want", [(1, 1), (128, 1), (512, 1), (513, 2), (16384, 32)])
def test_codebook_splits_cover_every_code(e, want):
    """The launch walks ceil(E / 128) code tiles, TILES_PER_SPLIT per block:
    the splits must cover every code and leave no block without one."""
    s = RK.splits(e)
    assert s == want
    tiles = -(-e // RK.CODE_TILE)
    assert (s - 1) * RK.TILES_PER_SPLIT < tiles <= s * RK.TILES_PER_SPLIT
