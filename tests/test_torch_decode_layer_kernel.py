"""The port's dense decode-layer functions (rqvae_tpu_torch.ops.
decode_layer_kernel) against JAX's fused_ln_qkv / fused_proj_mlp, whose
Pallas kernels run in interpret mode.

On the CPU the wrappers take their plain versions (the CUDA kernels are
compared with those on the card, by chip_smoke.py). fp32, C=128, atol 2e-5:
the JAX kernels' polynomial erf differs from the exact erf by < 1e-6 and
the products are summed in another order. Weights go to the port in the
nn.Linear [out, in] layout, to JAX in its [in, out] layout.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rqvae_tpu.ops import decode_layer_kernel as JDK
from rqvae_tpu_torch.ops import decode_layer_kernel as DK

C = 128
H = 4 * C


def _rand(r, *shape, std=1.0, mean=0.0):
    return (r.standard_normal(shape) * std + mean).astype(np.float32)


@pytest.mark.parametrize("B", [3, 8])
def test_fused_ln_qkv_matches_jax(B):
    r = np.random.RandomState(B)
    x = _rand(r, B, C)
    s, b = _rand(r, C, std=0.1, mean=1.0), _rand(r, C, std=0.1)
    w, bias = _rand(r, C, 3 * C, std=0.05), _rand(r, 3 * C, std=0.05)
    want = JDK.fused_ln_qkv(*map(jnp.asarray, (x, s, b, w, bias)), chunk=128, interpret=True)
    launches = DK.fused_ln_qkv.launches
    got = DK.fused_ln_qkv(*map(torch.from_numpy, (x, s, b, np.ascontiguousarray(w.T), bias)))
    assert DK.fused_ln_qkv.launches == launches  # CPU tensors: no kernel
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


@pytest.mark.parametrize("B,gelu", [(3, "v1"), (8, "v1"), (3, "v2")])
def test_fused_proj_mlp_matches_jax(B, gelu):
    r = np.random.RandomState(10 + B)
    x, y = _rand(r, B, C), _rand(r, B, C)
    s, b = _rand(r, C, std=0.1, mean=1.0), _rand(r, C, std=0.1)
    wo, bo = _rand(r, C, C, std=0.05), _rand(r, C, std=0.05)
    w1, b1 = _rand(r, C, H, std=0.05), _rand(r, H, std=0.05)
    w2, b2 = _rand(r, H, C, std=0.05), _rand(r, C, std=0.05)
    # chunk 128: the JAX kernel accumulates the MLP over four hidden chunks
    want = JDK.fused_proj_mlp(
        *map(jnp.asarray, (x, y, wo, bo, s, b, w1, b1, w2, b2)),
        gelu_version=gelu, chunk=128, interpret=True,
    )
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    launches = DK.fused_proj_mlp.launches
    got = DK.fused_proj_mlp(
        t(x), t(y), t(wo.T), t(bo), t(s), t(b), t(w1.T), t(b1), t(w2.T), t(b2), gelu_version=gelu
    )
    assert DK.fused_proj_mlp.launches == launches
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


@pytest.mark.parametrize("M,N,K", [(100, 4608, 1536), (100, 6144, 1536), (100, 1536, 1536), (100, 1536, 6144), (8, 4608, 1536), (3, 384, 128)])
def test_split_k_divides_the_reduction(M, N, K):
    """The CUDA GEMM needs K divisible by split * 64 and at least one chunk per split."""
    s = DK._splits(M, N, K)
    assert s >= 1 and K % (s * 64) == 0


@pytest.mark.parametrize("mlp", [False, True], ids=["ln_qkv", "proj_mlp"])
@pytest.mark.parametrize("C", DK.WIDTHS)
@pytest.mark.parametrize("M", [1, 37, 100, 129, 300, 500])
def test_dense_plan_covers_each_output_and_reduction_once(M, C, mlp):
    """decode_dense.cu's launch plan at every head width the port builds: the
    row tiles cover the M rows (none empty), every (row tile, weight row
    tile, 64-element K-chunk) of every product falls to exactly one CTA, and
    the launch fits the card: clusters of at most 8, one wave of 132 SMs,
    at most 232,448 bytes of shared memory, a ring of 4 to 16 stages, a row
    tile the kernel is built for."""
    N = (4 if mlp else 3) * C
    plan = DK.dense_plan(M, C, N, mlp)
    assert plan.cluster <= 8 and plan.cluster * plan.clusters <= 132
    assert plan.smem <= 232_448 and 4 <= plan.stages <= 16
    assert plan.smem == DK._smem_bytes(plan.row_tile, C // plan.cluster, plan.stages, mlp)
    assert plan.row_tile in (DK.ROW_TILES_MLP if mlp else DK.ROW_TILES_QKV)
    assert (plan.row_tiles - 1) * plan.row_tile < M <= plan.row_tiles * plan.row_tile
    products = plan.products()
    counts = [np.zeros((plan.row_tiles, tiles, k // 64), np.int32) for tiles, k in products]
    for cta in range(plan.cluster * plan.clusters):
        for i, m0, j, k0 in plan.units(cta):
            assert m0 % plan.row_tile == 0 and k0 % 64 == 0
            counts[i][m0 // plan.row_tile, j, k0 // 64] += 1
    want = [(C, C), (N, C), (C, N)] if mlp else [(N, C)]  # (weight rows, K): wo, w1, w2 / wqkv
    assert [(tiles * 64, k) for tiles, k in products] == want
    for (tiles, k), c in zip(products, counts):
        assert (c == 1).all(), f"product [{tiles * 64}, {k}]: counts {np.unique(c)}"


@pytest.mark.parametrize("most", [1, 7, 32])
def test_dense_plan_keeps_to_the_co_resident_clusters(most):
    """With fewer co-resident clusters than SMs allow (the device's count,
    cudaOccupancyMaxActiveClusters), the plan launches no more, and still
    covers every output and reduction element once."""
    plan = DK.dense_plan(100, 1536, 6144, True, max_clusters=lambda mlp, mt, s, smem: most)
    assert plan.clusters <= most
    seen = set()
    for cta in range(plan.cluster * plan.clusters):
        for unit in plan.units(cta):
            assert unit not in seen
            seen.add(unit)
    assert len(seen) == sum(plan.row_tiles * tiles * k // 64 for tiles, k in plan.products())


@pytest.mark.parametrize("M,C,N,mlp", [(100, 768, 2304, False), (100, 1536, 4096, False), (100, 1536, 4608, True),
                                       (0, 1536, 4608, False)])
def test_dense_plan_refuses_other_shapes(M, C, N, mlp):
    with pytest.raises(ValueError, match="decode_dense"):
        DK.dense_plan(M, C, N, mlp)
