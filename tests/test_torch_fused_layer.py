"""The port's fused body-layer decode paths against the JAX package:
decode_layer_step (the whole layer in one kernel, DecodePolicy.dense="mega")
and decode_attention_q8_update_wo (the q8 attention with wo, the residual
and LN2 folded in, DecodePolicy.attn_wo), each function's plain version,
stack_step_unrolled's two branches, greedy sampling at the three operating
points that run them, and the refusals where the JAX package would quietly
run its unfused path.

fp32 on the CPU, inputs from numpy seeds; the JAX side runs its Pallas
kernels in interpret mode. On the CPU the port's wrappers take their plain
versions.

Tolerances, and why:
- decode_layer_step in fp32: 2e-5. Both round at the same points (none in
  fp32); the JAX kernel runs the softmax online over 8-row cache chunks and
  its MLP over 256-column hidden chunks, the port in one pass: fp32 sums in
  another order, through five products of width <= 1024, and a polynomial
  erf within 1e-6 of the exact one. Measured <= 1.6e-6.
- decode_attention_q8_update_wo: its attention rounds to bf16 at fixed
  points whatever the input dtype, and y is cast to bf16 before wo. Against
  the same JAX math run op by op (every bf16 rounding happens): 1e-5 (fp32
  sums in another order). Against the interpret-mode kernel, where XLA on
  the CPU keeps excess precision and drops some bf16 roundings of the
  attention (tests/test_torch_q8.py docstring): y may differ by a bf16 step
  (2^-8 relative) wherever such a rounding falls on the other side, and
  then its bf16 cast by one more; x2 gathers C = 128 such terms through wo
  (std 0.05), measured <= 2.7e-3 here, bound 2e-2; h2 is x2 normalised by
  its row's spread (std ~1): measured <= 2.9e-3, bound the same. Op by op:
  measured <= 4.8e-7. The cache rows are quantize_kv of
  the same k_new / v_new on both sides: equal.
- stack_step_unrolled: dense="mega" in fp32 2e-5 (the decode_layer_step
  difference through two layers; measured <= 1.5e-6); attn_wo 1e-2, as the
  q8 path in tests/test_torch_q8.py (the attention's excess-precision
  difference, carried through two layers; measured <= 4.8e-3), with its
  cache rows within one int8 code and one bf16 step of the scale.
- Greedy codes: exact.
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
from rqvae_tpu.ops import decode_megakernel as JMK
from rqvae_tpu_torch.models.rqtransformer import model as TM
from rqvae_tpu_torch.models.rqtransformer import sampling as TS
from rqvae_tpu_torch.ops import attention_kernel as AK
from rqvae_tpu_torch.ops import decode_megakernel as MK
from test_torch_q8 import _jnp32, _np, _q, _q8_cache, _to_jax_cache, _to_port_cache
from test_torch_rqtransformer import build_pair


def _rand(r, *shape, std=1.0, mean=0.0):
    return (r.standard_normal(shape) * std + mean).astype(np.float32)


# decode_layer_step at B=6, C=256, 4 heads, H=1024, a 32-row cache:
# (cur_len, window, gelu); rows at and past min(cur_len, window) hold
# garbage that must not reach the output
MEGA_CASES = [(0, None, "v1"), (5, None, "v1"), (31, None, "v1"), (0, 16, "v2"), (5, 16, "v2"), (31, 16, "v2")]


@pytest.mark.parametrize("cur_len,window,gelu", MEGA_CASES)
def test_decode_layer_step_plain_matches_jax(cur_len, window, gelu):
    B, C, NH, T = 6, 256, 4, 32
    H = 4 * C
    r = np.random.RandomState(10 + cur_len + (window or 0))
    x = _rand(r, B, C)
    kc, vc = _rand(r, B, T, C), _rand(r, B, T, C)
    n = min(cur_len, window or T)
    kc[:, n:] *= 50.0
    vc[:, n:] *= 50.0
    ln = [_rand(r, C, std=0.1, mean=1.0), _rand(r, C, std=0.1), _rand(r, C, std=0.1, mean=1.0), _rand(r, C, std=0.1)]
    wqkv, wo, w1, w2 = (_rand(r, *s, std=0.05) for s in ((C, 3 * C), (C, C), (C, H), (H, C)))
    bqkv, bo, b1, b2 = (_rand(r, n_, std=0.05) for n_ in (3 * C, C, H, C))
    j = jnp.asarray
    out_j, k_j, v_j = JMK.decode_layer_step(
        j(x), j(kc), j(vc), jnp.int32(cur_len), j(ln[0]), j(ln[1]), j(wqkv), j(bqkv), j(wo), j(bo), j(ln[2]),
        j(ln[3]), j(w1), j(b1), j(w2), j(b2), n_head=NH, t_window=window, t_chunk=8, m_chunk=256,
        gelu_version=gelu, interpret=True,
    )
    t = torch.from_numpy
    k_t, v_t = t(kc.copy()), t(vc.copy())
    launches = MK.decode_layer_step.launches
    out_t = MK.decode_layer_step(
        t(x), k_t, v_t, cur_len, t(ln[0]), t(ln[1]), t(np.ascontiguousarray(wqkv.T)), t(bqkv),
        t(np.ascontiguousarray(wo.T)), t(bo), t(ln[2]), t(ln[3]), t(np.ascontiguousarray(w1.T)), t(b1),
        t(np.ascontiguousarray(w2.T)), t(b2), NH, t_window=window, gelu_version=gelu,
    )
    assert MK.decode_layer_step.launches == launches  # CPU tensors: no kernel
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=2e-5, rtol=0)
    np.testing.assert_allclose(k_t[:, cur_len].numpy(), np.asarray(k_j), atol=2e-5, rtol=0)
    np.testing.assert_allclose(v_t[:, cur_len].numpy(), np.asarray(v_j), atol=2e-5, rtol=0)
    keep = np.arange(T) != cur_len
    np.testing.assert_array_equal(k_t.numpy()[:, keep], kc[:, keep])
    np.testing.assert_array_equal(v_t.numpy()[:, keep], vc[:, keep])


# decode_attention_q8_update_wo at B=3, C=128, 2 heads, a 64-row int8 cache
# (the JAX kernel needs cur_len < window, as decode_attention_q8_update)
WO_CASES = [(0, 64), (5, 32), (31, 32), (63, 64)]


@pytest.mark.parametrize("int8_wo", [True, False], ids=["int8_wo", "fp32_wo"])
@pytest.mark.parametrize("cur_len,window", WO_CASES)
def test_decode_attention_q8_update_wo_plain_matches_jax(cur_len, window, int8_wo):
    B, C, NH, T = 3, 128, 2, 64
    r = np.random.RandomState(200 + cur_len + window + int8_wo)
    q, kn, vn, x = (_rand(r, B, C) for _ in range(4))
    cache = _q8_cache(r, B, T)
    bo, ln_s, ln_b = _rand(r, C, std=0.05), _rand(r, C, std=0.1, mean=1.0), _rand(r, C, std=0.1)
    wo = _rand(r, C, C, std=0.05)  # JAX [in, out]
    if int8_wo:
        jw, (wo_t, wo_s_t) = _q(wo)
        wo_j, wo_s_j = jw.q, jw.scale.reshape(C)
    else:
        wo_j, wo_s_j = jnp.asarray(wo), jnp.ones((C,), jnp.float32)
        wo_t, wo_s_t = torch.from_numpy(np.ascontiguousarray(wo.T)), None
    j = jnp.asarray
    jc = _to_jax_cache(*cache)
    x2_j, h2_j, *caches_j = JAK.decode_attention_q8_update_wo(
        j(q), j(kn), j(vn), *jc, jnp.int32(cur_len), j(x), wo_j, wo_s_j, j(bo), j(ln_s), j(ln_b), NH,
        t_window=window, interpret=True,
    )
    # the kernel body's math op by op: every bf16 rounding happens
    seg = jnp.asarray((np.arange(C)[:, None] // 64 == np.arange(NH)[None]).astype(np.float32))
    with jax.disable_jit():
        y = JAK._attn_math_q8_val(jnp.int32(cur_len), j(q), j(kn), j(vn), *(c[:, :window] for c in jc), seg,
                                  n_head=NH, t_max=window)
        proj = jnp.dot(y.astype(jnp.bfloat16), wo_j.astype(jnp.bfloat16),
                       preferred_element_type=jnp.float32) * wo_s_j.astype(jnp.float32)
        x2_ops = j(x) + (proj + j(bo))
        h2_ops = JDK._ln(x2_ops, j(ln_s), j(ln_b), jnp.float32)
    t = torch.from_numpy
    tc = _to_port_cache(*cache)
    launches = AK.decode_attention_q8_update_wo.launches
    x2_t, h2_t = AK.decode_attention_q8_update_wo(
        t(q), t(kn), t(vn), *tc, cur_len, t(x), wo_t, wo_s_t, t(bo), t(ln_s), t(ln_b), NH, t_window=window
    )
    assert AK.decode_attention_q8_update_wo.launches == launches  # CPU tensors: no kernel
    np.testing.assert_allclose(x2_t.numpy(), np.asarray(x2_ops), atol=1e-5, rtol=0)
    np.testing.assert_allclose(h2_t.numpy(), np.asarray(h2_ops), atol=1e-5, rtol=0)
    np.testing.assert_allclose(x2_t.numpy(), np.asarray(x2_j), atol=2e-2, rtol=0)
    np.testing.assert_allclose(h2_t.numpy(), np.asarray(h2_j), atol=2e-2, rtol=0)
    for got, want in zip(tc, caches_j):
        np.testing.assert_array_equal(_np(got), _jnp32(want))


def _jax_and_port_caches(r, q8, n_layer, B, T, C):
    if q8:
        caches = [_q8_cache(r, B, T) for _ in range(n_layer)]
        return tuple(tuple(_to_jax_cache(*c)) for c in caches), [_to_port_cache(*c) for c in caches]
    caches = [[_rand(r, B, T, C) for _ in range(2)] for _ in range(n_layer)]
    return (tuple((jnp.asarray(k), jnp.asarray(v)) for k, v in caches),
            [(torch.from_numpy(k.copy()), torch.from_numpy(v.copy())) for k, v in caches])


# (stack, S, cur_len, window) on the small geometry: body S == 1 steps take
# the fused path; a head step and a prefill (S > 1) keep theirs
MEGA_STEP_CASES = [("body", 1, 0, None), ("body", 1, 5, 32), ("body", 1, 40, None), ("head", 1, 2, None),
                   ("body", 3, 0, None)]


@pytest.mark.parametrize("role,S,cur_len,window", MEGA_STEP_CASES)
def test_stack_step_unrolled_mega_matches_jax(role, S, cur_len, window):
    params, jcfg, _, _, model, _ = build_pair()
    scfg = jcfg.body if role == "body" else jcfg.head
    stack = model.body_transformer if role == "body" else model.head_transformer
    B, C, T = 3, jcfg.embed_dim, 64 if role == "body" else 4
    r = np.random.RandomState(60 + cur_len)
    x = _rand(r, B, S, C)
    jcaches, tcaches = _jax_and_port_caches(r, False, scfg.n_layer, B, T, C)
    policy = JM.DecodePolicy(dense="mega", unroll=True, interpret=True)
    y_j, caches_j = JM.stack_step_unrolled(
        JM.split_layer_params(params[role], scfg), jnp.asarray(x), jcaches, jnp.int32(cur_len), scfg,
        window=window, policy=policy,
    )
    launches = MK.decode_layer_step.launches
    y_t, _ = TM.stack_step_unrolled(stack, torch.from_numpy(x), tcaches, cur_len, window=window, dense="mega")
    assert MK.decode_layer_step.launches == launches
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=2e-5, rtol=0)
    for cj, ct in zip(caches_j, tcaches):
        for a, b in zip(cj, ct):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=2e-5, rtol=0)


@pytest.mark.parametrize("int8", [False, True], ids=["float_w", "int8_w"])
@pytest.mark.parametrize("cur_len,window", [(0, None), (5, 32), (40, None)])
def test_stack_step_unrolled_attn_wo_matches_jax(cur_len, window, int8):
    params, jcfg, _, _, model, _ = build_pair()
    if int8:
        params = JM.quantize_transformer_params(params)
        model.quantize_int8()
    scfg = jcfg.body
    B, C = 3, jcfg.embed_dim
    r = np.random.RandomState(80 + cur_len)
    x = _rand(r, B, 1, C)
    jcaches, tcaches = _jax_and_port_caches(r, True, scfg.n_layer, B, 64, C)
    policy = JM.DecodePolicy(attn="pallas", kv_q8=True, attn_wo=True, unroll=True, interpret=True)
    y_j, caches_j = JM.stack_step_unrolled(
        JM.split_layer_params(params["body"], scfg), jnp.asarray(x), jcaches, jnp.int32(cur_len), scfg,
        window=window, policy=policy,
    )
    y_t, _ = TM.stack_step_unrolled(
        model.body_transformer, torch.from_numpy(x), tcaches, cur_len, window=window, attn_wo=True
    )
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-2, rtol=0)
    for cj, ct in zip(caches_j, tcaches):
        for a, b in zip(cj, ct):
            got, want = _np(b).astype(np.float32), _jnp32(a).astype(np.float32)
            if b.dtype == torch.int8:
                np.testing.assert_allclose(got, want, atol=1, rtol=0)
            else:
                np.testing.assert_allclose(got, want, atol=0, rtol=2.0**-7)


# the three operating points: (int8 weights, JAX policy, port options)
POINTS = {
    "bf16+mega": (False, dict(dense="mega"), dict(dense="mega")),
    "kv_q8+attn_wo": (False, dict(attn="pallas", kv_q8=True, attn_wo=True), dict(kv_q8=True, attn_wo=True)),
    "int8+kv_q8+attn_wo": (True, dict(attn="pallas", kv_q8=True, attn_wo=True), dict(kv_q8=True, attn_wo=True)),
}


@pytest.mark.parametrize("point", list(POINTS))
def test_greedy_sample_equals_jax_sampler_at_fused_points(point):
    int8, jpolicy, options = POINTS[point]
    params, jcfg, state, jq, model, books = build_pair()
    if int8:
        params = JM.quantize_transformer_params(params)
        model.quantize_int8()
    cond = np.array([3, 7], np.int32)
    want = JS.sample(
        params, jcfg, jax.random.PRNGKey(0), 2, cond=jnp.asarray(cond), vq_state=state, vq_config=jq,
        top_k=1, policy=JM.DecodePolicy(interpret=True, **jpolicy),
    )
    got = TS.sample(model, 2, torch.Generator().manual_seed(0), cond=torch.from_numpy(cond).long(),
                    quantizer=books, top_k=1, **options)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", ["mega_kv_q8", "mega_int8", "attn_wo_bf16", "dense_xla"])
def test_fused_paths_refuse_what_jax_would_not_fuse(case):
    _, _, _, _, model, books = build_pair()
    options = {
        "mega_kv_q8": dict(dense="mega", kv_q8=True),
        "mega_int8": dict(dense="mega"),
        "attn_wo_bf16": dict(attn_wo=True),
        "dense_xla": dict(dense="xla"),
    }[case]
    if case == "mega_int8":
        model.quantize_int8()
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError):
        TS.sample(model, 1, gen, cond=torch.tensor([1]), quantizer=books, **options)
    forced = torch.zeros(1, 8, 8, 4, dtype=torch.long)
    with pytest.raises(ValueError):
        TS.forced_logits(model, forced, torch.tensor([1]), books, **options)
    kv_q8 = options.pop("kv_q8", False)
    B, C, T = 1, model.config.embed_dim, 8
    if kv_q8:
        caches = TM.init_unrolled_kv_cache_q8(model.config.body, B, T, "cpu")
    else:
        caches = TM.init_unrolled_kv_cache(model.config.body, B, T, torch.float32, "cpu")
    with pytest.raises(ValueError):
        TM.stack_step_unrolled(model.body_transformer, torch.zeros(B, 1, C), caches, 0, **options)


def test_fused_wrappers_reject_devices_without_a_kernel():
    B, C, NH, T = 2, 128, 2, 8

    def z(*shape, dtype=torch.bfloat16):
        return torch.zeros(*shape, dtype=dtype, device="meta")

    x = z(B, C)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        MK.decode_layer_step(x, z(B, T, C), z(B, T, C), 0, z(C), z(C), z(3 * C, C), z(3 * C), z(C, C), z(C), z(C),
                             z(C), z(4 * C, C), z(4 * C), z(C, 4 * C), z(C), NH)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        AK.decode_attention_q8_update_wo(x, x, x, z(B, T, C, dtype=torch.int8), z(B, T, NH),
                                         z(B, T, C, dtype=torch.int8), z(B, T, NH), 0, x,
                                         z(C, C, dtype=torch.int8), z(C), z(C), z(C), z(C), NH)
