"""The port's decode attention (rqvae_tpu_torch.ops.attention_kernel) against
JAX's decode_attention_update, whose Pallas kernel runs in interpret mode.

On the CPU the port's wrapper takes its plain version (the CUDA kernel is
compared with that plain version on the card, by chip_smoke.py). fp32,
B=3 (a ragged batch against JAX's b_tile of 8), C=128 with two heads of 64,
a 32-row cache; y within 1e-5, the caches exact: row cur_len replaced by
k_new / v_new, every other row bit-identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rqvae_tpu.ops.attention_kernel import decode_attention_update as jax_decode_attention_update
from rqvae_tpu_torch.ops import attention_kernel as AK

B, T, C, NH = 3, 32, 128, 2


def _inputs(seed):
    r = np.random.RandomState(seed)
    q, kn, vn = (r.standard_normal((B, C)).astype(np.float32) for _ in range(3))
    kc, vc = (r.standard_normal((B, T, C)).astype(np.float32) for _ in range(2))
    return q, kn, vn, kc, vc


@pytest.mark.parametrize(
    "cur_len,window", [(0, None), (0, 8), (5, 8), (5, None), (16, 24), (16, None), (31, None), (31, 32)]
)
def test_plain_matches_jax_kernel(cur_len, window):
    q, kn, vn, kc, vc = _inputs(cur_len)
    y_j, k_j, v_j = jax_decode_attention_update(
        *(jnp.asarray(a) for a in (q, kn, vn, kc, vc)), jnp.int32(cur_len), NH,
        t_window=window, interpret=True,
    )
    k_t, v_t = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    launches = AK.decode_attention_update.launches
    y_t = AK.decode_attention_update(
        torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn), k_t, v_t, cur_len, NH,
        t_window=window,
    )
    assert AK.decode_attention_update.launches == launches  # CPU tensors: no kernel
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(k_t.numpy(), np.asarray(k_j))
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    np.testing.assert_array_equal(k_t[:, cur_len].numpy(), kn)
    keep = np.arange(T) != cur_len
    np.testing.assert_array_equal(k_t.numpy()[:, keep], kc[:, keep])
    np.testing.assert_array_equal(v_t.numpy()[:, keep], vc[:, keep])


def test_window_limits_the_attended_rows():
    """Rows at or past the window never reach y, whatever they hold."""
    q, kn, vn, kc, vc = _inputs(9)
    y0 = AK.decode_attention_update_plain(*map(torch.from_numpy, (q, kn, vn, kc.copy(), vc.copy())), 20, NH, 12)
    kc2, vc2 = kc.copy(), vc.copy()
    kc2[:, 12:], vc2[:, 12:] = 1e3, -1e3
    y1 = AK.decode_attention_update_plain(*map(torch.from_numpy, (q, kn, vn, kc2, vc2)), 20, NH, 12)
    assert torch.equal(y0, y1)


def test_wrapper_rejects_devices_without_a_kernel():
    q = torch.zeros(B, C, device="meta")
    caches = torch.zeros(B, T, C, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        AK.decode_attention_update(q, q, q, caches, caches, 0, NH)
