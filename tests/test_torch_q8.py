"""The port's int8 operating points against the JAX package: int8
weight-only quantization (quantize_transformer_params), the int8 KV cache
(quantize_kv, dequantize_cache, decode_attention_q8_update), the int8 dense
kernels' plain versions (fused_ln_qkv_q8, fused_proj_mlp_q8 against both
the grid and the ring JAX kernels), stack_step_unrolled with int8 caches and
weights, and greedy sampling at kv_q8 and int8 + kv_q8.

Small geometry of tests/test_torch_rqtransformer.py (C=128, 2 heads of 64,
2 + 2 layers, 8x8x4 codes, vocab 64), fp32 on the CPU, inputs from numpy
seeds. The JAX side runs its Pallas kernels in interpret mode. On the CPU the
port's wrappers take their plain versions.

Tolerances, and why:
- int8 weights, int8 cache rows and scales written from the same k / v,
  and greedy codes: exact.
- decode_attention_q8_update rounds to bf16 at fixed points whatever the
  input dtype. The port's plain version equals the JAX math
  (_attn_math_q8_val) run op by op within 1e-6: the same roundings, fp32
  sums in another order. Under jit (the interpret-mode kernel, the sampler)
  XLA on the CPU keeps excess precision and drops some of those bf16
  roundings, so there each of y's terms p_t * v_t may differ by a bf16
  rounding of its score product, its weight and its value product:
  |d| <= 2^-6 * sum_t p_t |v_t| (four units of bf16 roundoff 2^-8 of each
  term), plus 1e-5.
- Dense q8 functions in fp32: 2e-5, as the bf16 ones (polynomial vs exact
  erf < 1e-6; products summed in another order, with int8 values up to 127).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rqvae_tpu.models.rqtransformer import model as JM
from rqvae_tpu.models.rqtransformer import sampling as JS
from rqvae_tpu.ops import attention_kernel as JAK
from rqvae_tpu.ops import decode_layer_kernel as JDK
from rqvae_tpu_torch.checkpoint import from_jax
from rqvae_tpu_torch.models.rqtransformer import model as TM
from rqvae_tpu_torch.models.rqtransformer import sampling as TS
from rqvae_tpu_torch.ops import attention_kernel as AK
from rqvae_tpu_torch.ops import decode_layer_kernel as DK
from test_torch_rqtransformer import SMALL_ARCH, TOKEMB_ARCH, build_pair, to_torch

C, NH, HS = 128, 2, 64
H = 4 * C
Q8_TOL = 2.0**-6  # times sum_t p_t |v_t| (module docstring)


def _np(t: torch.Tensor) -> np.ndarray:
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _jnp32(a) -> np.ndarray:
    a = np.asarray(a)
    return a if a.dtype == np.int8 else a.astype(np.float32)


@pytest.mark.parametrize("arch", [SMALL_ARCH, TOKEMB_ARCH], ids=["shared_cls", "per_depth_cls"])
def test_int8_weights_equal_jax_bit_for_bit(arch):
    """quantize_int8 and from_jax of quantize_transformer_params give the
    same int8 values and bf16 scales as JAX; the quantized tree's state_dict
    loads with strict=True."""
    params, jcfg, _, _, model, _ = build_pair(arch)
    qparams = jax.device_get(JM.quantize_transformer_params(params))
    want = from_jax.rqtransformer_int8_from_jax(qparams)
    model.quantize_int8()
    slots = model._int8_slots()
    assert sorted(slots) == sorted(want)
    for name, (mod, attr) in slots.items():
        got = getattr(mod, attr)
        assert got.dtype == (torch.int8 if attr.endswith("_q") else torch.bfloat16), name
        np.testing.assert_array_equal(_np(got), want[name], err_msg=name)
    # the fused wqkv against JAX's own per-layer concatenation
    lp = JM.split_layer_params(qparams["body"], jcfg.body)[1]["attn"]["wqkv"]
    blk = model.body_transformer.blocks[1]
    np.testing.assert_array_equal(blk.wqkv_q.numpy(), np.asarray(lp.q).T)
    np.testing.assert_array_equal(_np(blk.wqkv_s), _jnp32(lp.scale)[0])

    other = TM.RQTransformer(model.config, device="cpu")
    other.load_state_dict(to_torch(from_jax.rqtransformer_state_dict_from_jax(qparams, jcfg)), strict=True)
    other.load_int8(want)
    q_blk = other.head_transformer.blocks[0]
    deq = q_blk.w1_q.float() * q_blk.w1_s.float()[:, None]
    assert torch.equal(q_blk.mlp[0].weight, deq)
    other.clear_int8()
    assert not q_blk.int8 and other.classifier.weight_q is None


def test_new_float_weights_drop_stale_int8_buffers():
    """The int8 buffers quantize the weights they were made from: loading a
    state_dict or re-initialising drops them, so no later step runs the
    old quantized weights; quantizing again sets them from the new ones."""
    model = TM.RQTransformer(TM.TransformerConfig.create(SMALL_ARCH), device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    model.quantize_int8()
    blk = model.body_transformer.blocks[0]
    assert blk.int8 and model.classifier.weight_q is not None
    fresh = TM.RQTransformer(model.config, device="cpu")
    fresh.init_weights(torch.Generator().manual_seed(1))
    model.load_state_dict(fresh.state_dict(), strict=True)
    assert not blk.int8 and model.classifier.weight_q is None
    model.quantize_int8()
    want_q, _ = TM.quantize_weight(blk.wqkv)
    assert torch.equal(blk.wqkv_q, want_q)
    model.init_weights(torch.Generator().manual_seed(2))
    assert not blk.int8 and model.classifier.weight_q is None


@pytest.mark.parametrize("seed,dtype", [(0, np.float32), (1, np.float32), (2, "bfloat16")])
def test_quantize_kv_and_dequantize_cache_equal_jax(seed, dtype):
    r = np.random.RandomState(seed)
    x = (r.standard_normal((40, C)) * r.uniform(0.01, 10.0, size=(40, 1))).astype(np.float32)
    x[3] = 0.0  # an all-zero row takes the 1e-8 floor
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    if dtype == "bfloat16":
        xj, xt = xj.astype(jnp.bfloat16), xt.to(torch.bfloat16)
    qj, sj = JAK.quantize_kv(xj, NH)
    qt, st = AK.quantize_kv(xt, NH)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    assert st.dtype == torch.float32
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    q3, s3 = qt.reshape(4, 10, C), st.reshape(4, 10, NH).to(torch.bfloat16)
    want = JAK.dequantize_cache(jnp.asarray(q3.numpy()), jnp.asarray(s3.float().numpy()).astype(jnp.bfloat16), NH)
    np.testing.assert_array_equal(_np(AK.dequantize_cache(q3, s3, NH)), _jnp32(want))


def _q8_cache(r, B, T):
    """An int8 cache made as the sampler makes it: quantize_kv of random rows."""
    out = []
    for _ in range(2):
        q, s = JAK.quantize_kv(jnp.asarray(r.standard_normal((B * T, C)).astype(np.float32)), NH)
        out += [np.array(q).reshape(B, T, C), _jnp32(jnp.asarray(s).astype(jnp.bfloat16)).reshape(B, T, NH)]
    return out  # kq, ks (bf16 values in fp32), vq, vs


def _to_port_cache(kq, ks, vq, vs):
    return [torch.from_numpy(kq.copy()), torch.from_numpy(ks).to(torch.bfloat16),
            torch.from_numpy(vq.copy()), torch.from_numpy(vs).to(torch.bfloat16)]


def _to_jax_cache(kq, ks, vq, vs):
    return [jnp.asarray(kq), jnp.asarray(ks).astype(jnp.bfloat16), jnp.asarray(vq), jnp.asarray(vs).astype(jnp.bfloat16)]


def _attention_magnitude(q, k_new, v_new, kq, ks, vq, vs, n):
    """sum_t p_t |v_t| per output element (float64, dequantized cache)."""
    B = q.shape[0]
    kd = kq[:, :n].astype(np.float64).reshape(B, n, NH, HS) * ks[:, :n, :, None]
    vd = vq[:, :n].astype(np.float64).reshape(B, n, NH, HS) * vs[:, :n, :, None]
    qh = q.astype(np.float64).reshape(B, 1, NH, HS)
    s = np.concatenate([(kd * qh).sum(-1), (k_new.astype(np.float64).reshape(B, 1, NH, HS) * qh).sum(-1)], 1)
    p = np.exp(s / np.sqrt(HS) - (s / np.sqrt(HS)).max(1, keepdims=True))
    p /= p.sum(1, keepdims=True)
    mag = (p[:, :n, :, None] * np.abs(vd)).sum(1) + p[:, n, :, None] * np.abs(v_new.reshape(B, NH, HS))
    return mag.reshape(B, C)


# (cur_len, window) on a 64-row cache; the JAX kernel needs cur_len < window
# (its cache write reads the 32-row tile of cur_len inside the window)
ATTN_CASES = [(0, 32), (5, 32), (31, 32), (0, 64), (5, 64), (31, 64), (63, 64)]


@pytest.mark.parametrize("cur_len,window", ATTN_CASES)
def test_decode_attention_q8_update_plain_matches_jax(cur_len, window):
    B, T = 3, 64
    r = np.random.RandomState(100 + cur_len + window)
    q, kn, vn = (r.standard_normal((B, C)).astype(np.float32) for _ in range(3))
    cache = _q8_cache(r, B, T)
    jc = _to_jax_cache(*cache)
    y_j, *caches_j = JAK.decode_attention_q8_update(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), *jc, jnp.int32(cur_len), NH,
        t_window=window, interpret=True,
    )
    seg = jnp.asarray((np.arange(C)[:, None] // HS == np.arange(NH)[None]).astype(np.float32))
    with jax.disable_jit():  # op by op: every bf16 rounding of the JAX math happens
        y_ops = JAK._attn_math_q8_val(
            jnp.int32(cur_len), jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
            *(c[:, :window] for c in jc), seg, n_head=NH, t_max=window,
        )
    tc = _to_port_cache(*cache)
    launches = AK.decode_attention_q8_update.launches
    y_t = AK.decode_attention_q8_update(
        torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn), *tc, cur_len, NH, t_window=window
    ).numpy()
    assert AK.decode_attention_q8_update.launches == launches  # CPU tensors: no kernel
    np.testing.assert_allclose(y_t, np.asarray(y_ops), atol=1e-6, rtol=0)
    bound = Q8_TOL * _attention_magnitude(q, kn, vn, *cache, min(cur_len, window)) + 1e-5
    assert np.all(np.abs(y_t - np.asarray(y_j)) <= bound)
    for got, want in zip(tc, caches_j):
        np.testing.assert_array_equal(_np(got), _jnp32(want))
    keep = np.arange(T) != cur_len
    for got, old in zip(tc, cache):
        np.testing.assert_array_equal(_np(got)[:, keep], old[:, keep])


def test_q8_window_limits_the_attended_rows():
    """Rows at or past the window never reach y, whatever they hold."""
    r = np.random.RandomState(7)
    q, kn, vn = (torch.from_numpy(r.standard_normal((2, C)).astype(np.float32)) for _ in range(3))
    cache = _q8_cache(r, 2, 32)
    y0 = AK.decode_attention_q8_update_plain(q, kn, vn, *_to_port_cache(*cache), 20, NH, 12)
    cache[0][:, 12:], cache[2][:, 12:] = 127, -127
    y1 = AK.decode_attention_q8_update_plain(q, kn, vn, *_to_port_cache(*cache), 20, NH, 12)
    assert torch.equal(y0, y1)


def _rand(r, *shape, std=1.0, mean=0.0):
    return (r.standard_normal(shape) * std + mean).astype(np.float32)


def _q(w):
    """JAX QuantizedWeight of an [in, out] weight, and the port's (q [out, in], s [out])."""
    jw = JM._quantize_weight(jnp.asarray(w))
    return jw, (torch.from_numpy(np.ascontiguousarray(np.asarray(jw.q).T)),
                torch.from_numpy(_jnp32(jw.scale)[0]).to(torch.bfloat16))


@pytest.mark.parametrize("B", [3, 8])
def test_fused_ln_qkv_q8_plain_matches_jax_grid_and_ring(B):
    r = np.random.RandomState(20 + B)
    x = _rand(r, B, C)
    s, b = _rand(r, C, std=0.1, mean=1.0), _rand(r, C, std=0.1)
    bias = _rand(r, 3 * C, std=0.05)
    jw, (wq, ws) = _q(_rand(r, C, 3 * C, std=0.05))
    args = (jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), jw.q, jw.scale, jnp.asarray(bias))
    grid = JDK.fused_ln_qkv_q8(*args, chunk=128, interpret=True)
    ring = JDK.fused_ln_qkv_q8_ring(*args, chunk=128, n_buf=2, interpret=True)
    launches = DK.fused_ln_qkv_q8.launches
    got = DK.fused_ln_qkv_q8(*map(torch.from_numpy, (x, s, b)), wq, ws, torch.from_numpy(bias)).numpy()
    assert DK.fused_ln_qkv_q8.launches == launches
    np.testing.assert_allclose(got, np.asarray(grid), atol=2e-5, rtol=0)
    np.testing.assert_allclose(got, np.asarray(ring), atol=2e-5, rtol=0)


@pytest.mark.parametrize("B,gelu", [(3, "v1"), (8, "v1"), (3, "v2")])
def test_fused_proj_mlp_q8_plain_matches_jax_grid_and_ring(B, gelu):
    r = np.random.RandomState(30 + B)
    x, y = _rand(r, B, C), _rand(r, B, C)
    s, b = _rand(r, C, std=0.1, mean=1.0), _rand(r, C, std=0.1)
    bo, b1, b2 = _rand(r, C, std=0.05), _rand(r, H, std=0.05), _rand(r, C, std=0.05)
    (jo, (wo, wos)), (j1, (w1, w1s)), (j2, (w2, w2s)) = (
        _q(_rand(r, *shape, std=0.05)) for shape in ((C, C), (C, H), (H, C)))
    jargs = (jnp.asarray(x), jnp.asarray(y), jo.q, jo.scale, jnp.asarray(bo), jnp.asarray(s), jnp.asarray(b),
             j1.q, j1.scale, jnp.asarray(b1), j2.q, j2.scale, jnp.asarray(b2))
    # chunk 128: the JAX kernels accumulate the MLP over four hidden chunks
    grid = JDK.fused_proj_mlp_q8(*jargs, gelu_version=gelu, chunk=128, interpret=True)
    ring = JDK.fused_proj_mlp_q8_ring(*jargs, gelu_version=gelu, chunk=128, n_buf=3, interpret=True)
    t = torch.from_numpy
    launches = DK.fused_proj_mlp_q8.launches
    got = DK.fused_proj_mlp_q8(
        t(x), t(y), wo, wos, t(bo), t(s), t(b), w1, w1s, t(b1), w2, w2s, t(b2), gelu_version=gelu
    ).numpy()
    assert DK.fused_proj_mlp_q8.launches == launches
    np.testing.assert_allclose(got, np.asarray(grid), atol=2e-5, rtol=0)
    np.testing.assert_allclose(got, np.asarray(ring), atol=2e-5, rtol=0)


# (stack, S, cur_len, window): body steps on a 64-row int8 cache (S == 1
# through the q8 attention, S > 1 the dequantizing prefill); head steps on
# the head's own fp32 4-row cache through the q8 dense kernels
Q8_STEP_CASES = [
    ("body", 1, 0, None),
    ("body", 1, 5, 32),
    ("body", 1, 40, None),
    ("head", 1, 0, None),
    ("head", 1, 2, None),
    ("body", 3, 0, None),
    ("body", 2, 6, 32),
]


@pytest.mark.parametrize("role,S,cur_len,window", Q8_STEP_CASES)
def test_stack_step_unrolled_int8_matches_jax(role, S, cur_len, window):
    params, jcfg, _, _, model, _ = build_pair()
    qparams = JM.quantize_transformer_params(params)
    model.quantize_int8()
    scfg = jcfg.body if role == "body" else jcfg.head
    stack = model.body_transformer if role == "body" else model.head_transformer
    B = 3
    r = np.random.RandomState(40 + cur_len)
    x = r.standard_normal((B, S, C)).astype(np.float32)
    if role == "body":
        caches = [_q8_cache(r, B, 64) for _ in range(scfg.n_layer)]
        jcaches = tuple(tuple(_to_jax_cache(*c)) for c in caches)
        tcaches = [_to_port_cache(*c) for c in caches]
    else:
        caches = [[r.standard_normal((B, 4, C)).astype(np.float32) for _ in range(2)] for _ in range(scfg.n_layer)]
        jcaches = tuple((jnp.asarray(k), jnp.asarray(v)) for k, v in caches)
        tcaches = [(torch.from_numpy(k.copy()), torch.from_numpy(v.copy())) for k, v in caches]
    policy = JM.DecodePolicy(attn="pallas", dense="pallas", unroll=True, kv_q8=True, interpret=True)
    lps = JM.split_layer_params(qparams[role], scfg)
    y_j, caches_j = JM.stack_step_unrolled(
        lps, jnp.asarray(x), jcaches, jnp.int32(cur_len), scfg, window=window, policy=policy
    )
    y_t, _ = TM.stack_step_unrolled(stack, torch.from_numpy(x), tcaches, cur_len, window=window)
    # body S == 1: the attention's excess-precision difference (module
    # docstring), carried through two layers: measured <= 2.3e-3, bound 1e-2.
    # Elsewhere the fp32 tolerance of the dense functions.
    atol = 1e-2 if (role == "body" and S == 1) else 1e-4
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=atol, rtol=0)
    # the new rows quantize k / v that reached them through other fp32 sums
    # (and, past layer 0, the attention difference above): a value on a
    # rounding boundary may go to the neighbouring integer, a scale to the
    # neighbouring bf16 value; fp32 head caches within 1e-5
    for cj, ct in zip(caches_j, tcaches):
        for a, b in zip(cj, ct):
            got, want = _np(b).astype(np.float32), _jnp32(a).astype(np.float32)
            if b.dtype == torch.int8:
                np.testing.assert_allclose(got, want, atol=1, rtol=0)
            elif b.dtype == torch.bfloat16:
                np.testing.assert_allclose(got, want, atol=0, rtol=2.0**-7)
            else:
                np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("int8", [False, True], ids=["kv_q8", "int8_kv_q8"])
def test_greedy_sample_equals_jax_sampler_at_int8_points(int8):
    params, jcfg, state, jq, model, books = build_pair()
    if int8:
        params = JM.quantize_transformer_params(params)
        model.quantize_int8()
    cond = np.array([3, 7], np.int32)
    policy = JM.DecodePolicy(attn="pallas", dense="pallas", interpret=True, kv_q8=True)
    want = JS.sample(
        params, jcfg, jax.random.PRNGKey(0), 2, cond=jnp.asarray(cond), vq_state=state,
        vq_config=jq, top_k=1, policy=policy,
    )
    got = TS.sample(model, 2, torch.Generator().manual_seed(0), cond=torch.from_numpy(cond).long(),
                    quantizer=books, top_k=1, kv_q8=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


DENSE_FNS = ("fused_ln_qkv", "fused_proj_mlp", "fused_ln_qkv_q8", "fused_proj_mlp_q8", "fused_ln_qkv_q8_plain",
             "fused_proj_mlp_q8_plain")
# (stack, int8 weights, attn_wo, kernels, S, stacked cache): the dense
# functions each layer of the step calls; on the CPU a kernel wrapper calls
# its plain version, so the wrappers' calls show in the plain counts too
DISPATCH_CASES = {
    "body_int8": ("body", True, False, True, 1, False, {"fused_ln_qkv_q8": 1, "fused_proj_mlp_q8": 1,
                                                         "fused_ln_qkv_q8_plain": 1, "fused_proj_mlp_q8_plain": 1}),
    "body_int8_attn_wo": ("body", True, True, True, 1, False, {"fused_ln_qkv_q8": 1, "fused_ln_qkv_q8_plain": 1}),
    "body_int8_plain": ("body", True, False, False, 1, False, {"fused_ln_qkv_q8_plain": 1,
                                                                "fused_proj_mlp_q8_plain": 1}),
    "body_bf16": ("body", False, False, True, 1, False, {}),
    "body_bf16_attn_wo": ("body", False, True, True, 1, False, {}),
    "body_int8_prefill": ("body", True, False, True, 3, False, {}),
    "body_int8_stacked": ("body", True, False, True, 1, True, {}),
    "head_int8": ("head", True, False, True, 1, False, {"fused_ln_qkv_q8": 1, "fused_proj_mlp_q8": 1,
                                                         "fused_ln_qkv_q8_plain": 1, "fused_proj_mlp_q8_plain": 1}),
}


@pytest.mark.parametrize("case", list(DISPATCH_CASES))
def test_int8_body_step_runs_the_int8_dense_pair(case, monkeypatch):
    """A body S == 1 step with int8 weights runs fused_ln_qkv_q8 and
    fused_proj_mlp_q8 per layer (the QKV half alone under attn_wo, whose MLP
    stays on _mm), their plain versions with kernels=False, as the head's
    S == 1 step does; a float-weight body step, a prefill and the stacked
    path call none of them. Spies on the DK functions count the calls; the
    wrappers' launch counters do not move on the CPU."""
    role, int8, attn_wo, kernels, S, stacked, want = DISPATCH_CASES[case]
    _, _, _, _, model, _ = build_pair()
    if int8:
        model.quantize_int8()
    wrappers = [getattr(DK, name) for name in DENSE_FNS[:4]]
    before = [fn.launches for fn in wrappers]
    calls = dict.fromkeys(DENSE_FNS, 0)
    for name in DENSE_FNS:
        def spy(*args, _fn=getattr(DK, name), _name=name, **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(DK, name, spy)
    stack = model.body_transformer if role == "body" else model.head_transformer
    cfg = model.config.body if role == "body" else model.config.head
    B, T, C = 3, 8, cfg.embed_dim
    x = torch.from_numpy(np.random.RandomState(7).standard_normal((B, S, C)).astype(np.float32))
    if stacked:
        TM.stack_step(stack, x, TM.init_kv_cache(cfg, B, T, torch.float32, "cpu"), 2, kernels=kernels)
    elif role == "body":
        caches = TM.init_unrolled_kv_cache_q8(cfg, B, T, "cpu")
        TM.stack_step_unrolled(stack, x, caches, 2, kernels=kernels, attn_wo=attn_wo)
    else:
        TM.stack_step_unrolled(stack, x, TM.init_unrolled_kv_cache(cfg, B, T, torch.float32, "cpu"), 2,
                               kernels=kernels)
    n = len(stack.blocks)
    assert calls == {name: want.get(name, 0) * n for name in DENSE_FNS}
    assert [fn.launches for fn in wrappers] == before
