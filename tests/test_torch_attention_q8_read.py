"""The port's read-only q8 decode attention (decode_attention_q8) and the
decode attention at head size 104 against the JAX package, the head-size
checks of the kernel wrappers, and the port of tools/exp_attn_q8cache.py.

Head sizes 64 (C=128, 2 heads) and 104 (C=208, 2 heads, the zoo's
vqgan_large), B=3 (ragged against JAX's b_tile of 8), fp32 inputs from numpy
seeds on the CPU. The JAX side runs its Pallas kernels in interpret mode. On
the CPU the port's wrappers take their plain versions.

Tolerances, and why:
- decode_attention_q8 rounds to bf16 at fixed points whatever the input
  dtype. The port's plain version equals the JAX math (_attn_math_q8_val)
  run op by op within 1e-6: the same roundings, fp32 sums in another order.
  Under jit (the interpret-mode kernel) XLA on the CPU keeps excess
  precision and drops some of those bf16 roundings, so there each of y's
  terms p_t * v_t may differ by a bf16 rounding of its score product, its
  weight and its value product: |d| <= 2^-6 * sum_t p_t |v_t| (four units
  of bf16 roundoff 2^-8 of each term), plus 1e-5; as tests/test_torch_q8.py
  holds decode_attention_q8_update.
- the caches: bit-unchanged (the function only reads them).
- decode_attention / decode_attention_update at head size 104: 1e-5, as
  tests/test_torch_stacked.py at 64 (fp32 rounds nowhere; the sums run in
  another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rqvae_tpu.ops import attention_kernel as JAK
from rqvae_tpu_torch.ops import attention_kernel as AK
from rqvae_tpu_torch.ops import decode_megakernel as MK
from rqvae_tpu_torch.tools import _timing
from rqvae_tpu_torch.tools import exp_attn_q8cache as EXP

NH = 2
Q8_TOL = 2.0**-6  # times sum_t p_t |v_t| (module docstring)
HEAD_SIZES = [64, 104]


def _jnp32(a) -> np.ndarray:
    a = np.asarray(a)
    return a if a.dtype == np.int8 else a.astype(np.float32)


def _q8_cache(r, B, T, C):
    """An int8 cache made as the sampler makes it: JAX quantize_kv of random
    rows; the scales as bf16 values held in fp32."""
    out = []
    for _ in range(2):
        q, s = JAK.quantize_kv(jnp.asarray(r.standard_normal((B * T, C)).astype(np.float32)), NH)
        out += [np.array(q).reshape(B, T, C), _jnp32(jnp.asarray(s).astype(jnp.bfloat16)).reshape(B, T, NH)]
    return out  # kq, ks, vq, vs


def _attention_magnitude(q, k_new, v_new, kq, ks, vq, vs, n):
    """sum_t p_t |v_t| per output element (float64, dequantized cache)."""
    B, C = q.shape
    hs = C // NH
    kd = kq[:, :n].astype(np.float64).reshape(B, n, NH, hs) * ks[:, :n, :, None]
    vd = vq[:, :n].astype(np.float64).reshape(B, n, NH, hs) * vs[:, :n, :, None]
    qh = q.astype(np.float64).reshape(B, 1, NH, hs)
    s = np.concatenate([(kd * qh).sum(-1), (k_new.astype(np.float64).reshape(B, 1, NH, hs) * qh).sum(-1)], 1)
    s = s / np.sqrt(hs)
    p = np.exp(s - s.max(1, keepdims=True))
    p /= p.sum(1, keepdims=True)
    mag = (p[:, :n, :, None] * np.abs(vd)).sum(1) + p[:, n, :, None] * np.abs(v_new.reshape(B, NH, hs))
    return mag.reshape(B, C)


# (cur_len, window) on a 64-row cache: the self term alone, a short and a
# full window, and cur_len == T (the read-only form reads every row)
Q8_CASES = [(0, 32), (5, 32), (31, 64), (63, 64), (64, 64)]


@pytest.mark.parametrize("hs", HEAD_SIZES)
@pytest.mark.parametrize("cur_len,window", Q8_CASES)
def test_decode_attention_q8_plain_matches_jax(hs, cur_len, window):
    B, T, C = 3, 64, NH * hs
    r = np.random.RandomState(200 + hs + cur_len + window)
    q, kn, vn = (r.standard_normal((B, C)).astype(np.float32) for _ in range(3))
    cache = _q8_cache(r, B, T, C)
    jc = [jnp.asarray(cache[0]), jnp.asarray(cache[1]).astype(jnp.bfloat16), jnp.asarray(cache[2]),
          jnp.asarray(cache[3]).astype(jnp.bfloat16)]
    y_j = JAK.decode_attention_q8(jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), *jc, jnp.int32(cur_len), NH,
                                  t_window=window, interpret=True)
    seg = jnp.asarray((np.arange(C)[:, None] // hs == np.arange(NH)[None]).astype(np.float32))
    with jax.disable_jit():  # op by op: every bf16 rounding of the JAX math happens
        y_ops = JAK._attn_math_q8_val(
            jnp.int32(cur_len), jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
            *(c[:, :window] for c in jc), seg, n_head=NH, t_max=window,
        )
    tc = [torch.from_numpy(cache[0].copy()), torch.from_numpy(cache[1]).to(torch.bfloat16),
          torch.from_numpy(cache[2].copy()), torch.from_numpy(cache[3]).to(torch.bfloat16)]
    before = [c.clone() for c in tc]
    y_t = AK.decode_attention_q8_plain(torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn), *tc,
                                       cur_len, NH, t_window=window)
    assert y_t.dtype == torch.float32
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_ops), atol=1e-6, rtol=0)
    bound = Q8_TOL * _attention_magnitude(q, kn, vn, *cache, min(cur_len, window)) + 1e-5
    assert np.all(np.abs(y_t.numpy() - np.asarray(y_j)) <= bound)
    for got, old in zip(tc, before):  # read only
        assert torch.equal(got, old)


def test_decode_attention_q8_wrapper_on_cpu_is_the_plain_version():
    """CPU tensors take the plain version (no launch), in bf16 too; the
    read-only form takes cur_len == T; any device but CPU and CUDA raises."""
    B, T, hs = 3, 16, 104
    C = NH * hs
    r = np.random.RandomState(5)
    q, kn, vn = (torch.from_numpy(r.standard_normal((B, C)).astype(np.float32)).to(torch.bfloat16)
                 for _ in range(3))
    kq, ks, vq, vs = _q8_cache(r, B, T, C)
    cache = [torch.from_numpy(kq), torch.from_numpy(ks).to(torch.bfloat16), torch.from_numpy(vq),
             torch.from_numpy(vs).to(torch.bfloat16)]
    launches = AK.decode_attention_q8.launches
    for cur_len, window in ((T, None), (9, 4), (0, None)):
        got = AK.decode_attention_q8(q, kn, vn, *cache, cur_len, NH, t_window=window)
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, AK.decode_attention_q8_plain(q, kn, vn, *cache, cur_len, NH, t_window=window))
    assert AK.decode_attention_q8.launches == launches

    def z(*shape, dtype=torch.bfloat16):
        return torch.zeros(*shape, dtype=dtype, device="meta")

    x = z(B, C)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        AK.decode_attention_q8(x, x, x, z(B, T, C, dtype=torch.int8), z(B, T, NH), z(B, T, C, dtype=torch.int8),
                               z(B, T, NH), 0, NH)


def test_wrapper_checks_raise_only_for_head_sizes_without_an_instantiation():
    """The attention kernels serve head sizes 64 and 104; the fused q8 wo
    kernel and decode_layer_step serve 64 only. Read-only forms allow
    cur_len == T, the writing forms do not."""
    B, T = 2, 8

    def bf(*shape):
        return torch.zeros(*shape, dtype=torch.bfloat16)

    def q8(C, nh):
        return bf(B, C), bf(B, C), bf(B, C), torch.zeros(B, T, C, dtype=torch.int8), bf(B, T, nh), \
            torch.zeros(B, T, C, dtype=torch.int8), bf(B, T, nh)

    for hs in (64, 104):
        C = NH * hs
        AK._check("decode_attention", bf(B, C), bf(B, C), bf(B, C), bf(B, T, C), bf(B, T, C), T, NH, write=False)
        AK._check_q8(*q8(C, NH), T, NH, "decode_attention_q8", write=False)
        AK._check_q8(*q8(C, NH), T - 1, NH)
        with pytest.raises(ValueError, match="outside the cache"):
            AK._check("decode_attention_update", bf(B, C), bf(B, C), bf(B, C), bf(B, T, C), bf(B, T, C), T, NH,
                      write=True)
        with pytest.raises(ValueError, match="outside the cache"):
            AK._check_q8(*q8(C, NH), T, NH)
    for C, nh in ((NH * 96, NH), (NH * 128, NH), (130, 2), (128, 3)):
        with pytest.raises(ValueError, match="head sizes"):
            AK._check("decode_attention", bf(B, C), bf(B, C), bf(B, C), bf(B, T, C), bf(B, T, C), 0, nh, write=False)
        with pytest.raises(ValueError, match="head sizes"):
            AK._check_q8(*q8(C, nh), 0, nh)
    with pytest.raises(ValueError, match=r"head sizes \[64\]"):
        AK._check_q8(*q8(NH * 104, NH), 0, NH, "decode_attention_q8_update_wo", head_sizes=(AK.WO_HEAD_SIZE,))
    C, H = NH * 104, 4 * NH * 104
    params = dict(ln1_scale=bf(C), ln1_bias=bf(C), wqkv=bf(3 * C, C), bqkv=bf(3 * C), wo=bf(C, C), bo=bf(C),
                  ln2_scale=bf(C), ln2_bias=bf(C), w1=bf(H, C), b1=bf(H), w2=bf(C, H), b2=bf(C))
    with pytest.raises(ValueError, match="head size 64"):
        MK._check(bf(B, C), bf(B, T, C), bf(B, T, C), 0, params, NH, T)
    odd = bf(B * NH * 104 + 1)[1:].view(B, NH * 104)  # 2 bytes past an 8-byte boundary
    with pytest.raises(ValueError, match="bf16 tensor must start on a 8-byte boundary"):
        AK._check("decode_attention", odd, bf(B, 208), bf(B, 208), bf(B, T, 208), bf(B, T, 208), 0, NH, write=False)
    args = list(q8(208, NH))
    args[3] = torch.zeros(B * T * 208 + 2, dtype=torch.int8)[2:].view(B, T, 208)  # 2 bytes past a 4-byte boundary
    with pytest.raises(ValueError, match="int8 tensor must start on a 4-byte boundary"):
        AK._check_q8(*args, 0, NH, "decode_attention_q8", write=False)


# (cur_len, window) on a 32-row cache, as tests/test_torch_stacked.py at 64
READ_CASES = [(0, None), (5, 8), (16, 24), (32, None), (32, 16)]


@pytest.mark.parametrize("cur_len,window", READ_CASES)
def test_decode_attention_plain_matches_jax_at_head_size_104(cur_len, window):
    B, T, C = 3, 32, NH * 104
    r = np.random.RandomState(300 + cur_len + (window or 0))
    q, kn, vn = (r.standard_normal((B, C)).astype(np.float32) for _ in range(3))
    kc, vc = (r.standard_normal((B, T, C)).astype(np.float32) for _ in range(2))
    y_j = JAK.decode_attention(*(jnp.asarray(a) for a in (q, kn, vn, kc, vc)), jnp.int32(cur_len), NH,
                               t_window=window, interpret=True)
    k_t, v_t = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    launches = AK.decode_attention.launches
    y_t = AK.decode_attention(torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn), k_t, v_t, cur_len,
                              NH, t_window=window)
    assert AK.decode_attention.launches == launches  # CPU tensors: no kernel
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(k_t.numpy(), kc)
    np.testing.assert_array_equal(v_t.numpy(), vc)


@pytest.mark.parametrize("cur_len,window", [(0, None), (20, 24)])
def test_decode_attention_update_plain_matches_jax_at_head_size_104(cur_len, window):
    B, T, C = 3, 32, NH * 104
    r = np.random.RandomState(400 + cur_len)
    q, kn, vn = (r.standard_normal((B, C)).astype(np.float32) for _ in range(3))
    kc, vc = (r.standard_normal((B, T, C)).astype(np.float32) for _ in range(2))
    y_j, k_j, v_j = JAK.decode_attention_update(*(jnp.asarray(a) for a in (q, kn, vn, kc, vc)), jnp.int32(cur_len),
                                                NH, t_window=window, interpret=True)
    k_t, v_t = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    y_t = AK.decode_attention_update(torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn), k_t, v_t,
                                     cur_len, NH, t_window=window)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(k_t.numpy(), np.asarray(k_j))
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))


def test_experiment_main_runs_on_cpu(monkeypatch, capsys):
    monkeypatch.setenv("EXP_T", "8")
    monkeypatch.setenv("EXP_ITERS", "2")
    got = EXP.main(["2"], device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[1].split()[0] for ln in lines] == ["bf16", "q8", "eager"]
    assert all(ln.startswith("B=   2 T=8:") for ln in lines)
    assert "speedup" in lines[1] and "(int8 bytes)" in lines[1]
    assert set(got) == {2} and all(v > 0 for v in got[2].values())
    assert EXP.launches_per_batch(50) == 3 * 50 + 1 + 50 + 3 * 50
    assert EXP.BEST_OF == _timing.BEST_OF == 3 and EXP.card_line is _timing.card_line


def test_experiment_raises_without_a_cuda_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EXP.main(["2"])
