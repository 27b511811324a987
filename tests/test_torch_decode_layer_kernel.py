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
