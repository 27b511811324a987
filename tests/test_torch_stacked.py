"""The port's stacked-cache decode path against the JAX package: the
read-only decode attention (decode_attention, decode_attention_stacked),
KVCache / init_kv_cache and stack_step, the sampler's stacked branch
(unroll=False, what `sample` resolves beyond 128 positions), forced_logits
through it, the measure_throughput zoo's configurations, and a JAX tree with
a 0-layer head loading into the port.

fp32 on the CPU, inputs from numpy seeds; the JAX attention kernels run in
interpret mode. On the CPU the port's wrappers take their plain versions.

Tolerances, and why:
- the attention functions: 1e-5. In fp32 both round nowhere; the sums run
  in another order (the TPU kernel sums heads through 0/1 matmuls).
- stack_step against JAX stack_step: 1e-5 for outputs and cache rows, as
  tests/test_rqtransformer_parity.py holds JAX's two step forms. JAX's XLA
  decode attention sums v * w in the cache dtype where the kernel's math
  (_attn_math, which the port follows) sums in fp32: in fp32 the same.
- port stack_step against port stack_step_unrolled: equal, bit for bit (the
  same operations on the same rows).
- greedy codes: exact. forced_logits: 1e-4, as the unrolled path's
  forced_logits test.
"""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rqvae_tpu.checkpoint import torch_export as te
from rqvae_tpu.models.rqtransformer import model as JM
from rqvae_tpu.models.rqtransformer import sampling as JS
from rqvae_tpu.ops import attention_kernel as JAK
from rqvae_tpu_torch.checkpoint import from_jax
from rqvae_tpu_torch.cli import measure_throughput as TMT
from rqvae_tpu_torch.models.rqtransformer import model as TM
from rqvae_tpu_torch.models.rqtransformer import sampling as TS
from rqvae_tpu_torch.models.rqtransformer.config import TransformerConfig
from rqvae_tpu_torch.ops import attention_kernel as AK
from test_torch_rqtransformer import SMALL_ARCH, build_pair, jax_config, to_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C, NH = 128, 2


def _rand(r, *shape):
    return r.standard_normal(shape).astype(np.float32)


# (cur_len, window) on a 32-row cache at B=3 (ragged against JAX's b_tile
# of 8); cur_len 0 is the self term alone, cur_len 32 reads every row
READ_CASES = [(0, None), (5, 8), (5, None), (16, 24), (31, None), (32, None), (32, 16)]


@pytest.mark.parametrize("cur_len,window", READ_CASES)
def test_decode_attention_plain_matches_jax(cur_len, window):
    B, T = 3, 32
    r = np.random.RandomState(cur_len + (window or 0))
    q, kn, vn = (_rand(r, B, C) for _ in range(3))
    kc, vc = _rand(r, B, T, C), _rand(r, B, T, C)
    y_j = JAK.decode_attention(*(jnp.asarray(a) for a in (q, kn, vn, kc, vc)), jnp.int32(cur_len), NH,
                               t_window=window, interpret=True)
    k_t, v_t = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    launches = AK.decode_attention.launches
    y_t = AK.decode_attention(torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn), k_t, v_t, cur_len,
                              NH, t_window=window)
    assert AK.decode_attention.launches == launches  # CPU tensors: no kernel
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(k_t.numpy(), kc)  # read only
    np.testing.assert_array_equal(v_t.numpy(), vc)


# (layer, cur_len) of a 3-layer, 16-row stack at B=8 (JAX's stacked kernel
# needs B % 8 == 0)
STACKED_CASES = [(0, 0), (1, 5), (2, 15), (1, 16)]


@pytest.mark.parametrize("layer,cur_len", STACKED_CASES)
def test_decode_attention_stacked_plain_matches_jax(layer, cur_len):
    L, B, T = 3, 8, 16
    r = np.random.RandomState(20 + 4 * layer + cur_len)
    q, kn, vn = (_rand(r, B, C) for _ in range(3))
    kc, vc = _rand(r, L, B, T, C), _rand(r, L, B, T, C)
    y_j = JAK.decode_attention_stacked(*(jnp.asarray(a) for a in (q, kn, vn, kc, vc)), jnp.int32(layer),
                                       jnp.int32(cur_len), NH, interpret=True)
    k_t, v_t = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    args = (torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn), k_t, v_t, layer, cur_len, NH)
    counts = AK.decode_attention_stacked.launches, AK.decode_attention.launches
    y_t = AK.decode_attention_stacked(*args)
    assert (AK.decode_attention_stacked.launches, AK.decode_attention.launches) == counts
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-5, rtol=0)
    assert torch.equal(AK.decode_attention_stacked_plain(*args), y_t)
    # layer l of the stack is decode_attention on that layer's [B, T, C] view
    assert torch.equal(AK.decode_attention_plain(*args[:3], k_t[layer], v_t[layer], cur_len, NH), y_t)
    np.testing.assert_array_equal(k_t.numpy(), kc)
    np.testing.assert_array_equal(v_t.numpy(), vc)


@pytest.mark.parametrize("hs", [64, 104])
def test_decode_attention_stacked_plain_matches_jax_at_the_long_window(hs):
    """The stacked sampler's longest read: cur_len 256 of a T = 257 stack
    (the condition and 256 positions), at head sizes 64 and 104."""
    L, B, T, c, layer, cur_len = 2, 8, 257, NH * hs, 1, 256
    r = np.random.RandomState(40 + hs)
    q, kn, vn = (_rand(r, B, c) for _ in range(3))
    kc, vc = _rand(r, L, B, T, c), _rand(r, L, B, T, c)
    y_j = JAK.decode_attention_stacked(*(jnp.asarray(a) for a in (q, kn, vn, kc, vc)), jnp.int32(layer),
                                       jnp.int32(cur_len), NH, interpret=True)
    k_t, v_t = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    y_t = AK.decode_attention_stacked_plain(torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn), k_t,
                                            v_t, layer, cur_len, NH)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(k_t.numpy(), kc)
    np.testing.assert_array_equal(v_t.numpy(), vc)


def test_read_only_wrappers_refuse_what_they_cannot_run():
    B, T, L = 2, 8, 3

    def z(*shape):
        return torch.zeros(*shape, dtype=torch.bfloat16, device="meta")

    x = z(B, C)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        AK.decode_attention(x, x, x, z(B, T, C), z(B, T, C), 0, NH)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        AK.decode_attention_stacked(x, x, x, z(L, B, T, C), z(L, B, T, C), 0, 0, NH)
    cpu = torch.zeros(B, C)
    for layer in (-1, L):
        with pytest.raises(ValueError, match="outside the stack"):
            AK.decode_attention_stacked(cpu, cpu, cpu, torch.zeros(L, B, T, C), torch.zeros(L, B, T, C), layer, 0, NH)
    with pytest.raises(ValueError, match=r"\[L, B, T, C\]"):
        AK.decode_attention_stacked(cpu, cpu, cpu, torch.zeros(B, T, C), torch.zeros(B, T, C), 0, 0, NH)


def _steps(r, B, S0=3, n=4):
    """A prefill of S0 rows, then n single-token steps: [(x [B, S, C], cur_len)]."""
    out, cur = [(_rand(r, B, S0, C), 0)], S0
    for _ in range(n):
        out.append((_rand(r, B, 1, C), cur))
        cur += 1
    return out


@pytest.mark.parametrize("role", ["body", "head"])
@pytest.mark.parametrize("int8", [False, True], ids=["float_w", "int8_w"])
def test_stack_step_matches_jax_and_unrolled(role, int8):
    """Port stack_step against JAX stack_step (prefill S = 3, then 4 decode
    steps; outputs and every layer's cache at 1e-5) and against the port's
    stack_step_unrolled on the same inputs (equal). The one exception: a
    body S == 1 step with int8 weights runs the int8 dense pair on the
    unrolled path (JAX's dense="pallas" route; its plain versions here,
    whose gelu is the JAX kernel's 0.5 t (1 + erf(t / sqrt 2)) form) and _mm
    with F.gelu on the stacked one (JAX's stack_step route): the same
    function in fp32, measured <= 2.4e-7 apart per layer, held to the JAX
    bound 1e-5."""
    params, jcfg, _, _, model, _ = build_pair()
    if int8:
        params = JM.quantize_transformer_params(params)
        model.quantize_int8()
    scfg = jcfg.body if role == "body" else jcfg.head
    stack = model.body_transformer if role == "body" else model.head_transformer
    B, T = 3, 9
    jcache = JM.init_kv_cache(scfg, B, T)
    cache = TM.init_kv_cache(stack.cfg, B, T, torch.float32, "cpu")
    assert cache.k.shape == (scfg.n_layer, B, T, C) and not cache.k.any()
    caches = TM.init_unrolled_kv_cache(stack.cfg, B, T, torch.float32, "cpu")
    same_route = not (int8 and role == "body")  # the docstring's one exception

    def agree(a, b):
        if same_route:
            assert torch.equal(a, b)
        else:
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0)

    for x, cur_len in _steps(np.random.RandomState(7), B):
        y_j, jcache = JM.stack_step(params[role], jnp.asarray(x), jcache, jnp.int32(cur_len), scfg)
        y_t, cache = TM.stack_step(stack, torch.from_numpy(x), cache, cur_len)
        y_u, _ = TM.stack_step_unrolled(stack, torch.from_numpy(x), caches, cur_len)
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-5, rtol=0)
        agree(y_t, y_u)
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(jcache.k), atol=1e-5, rtol=0)
    np.testing.assert_allclose(cache.v.numpy(), np.asarray(jcache.v), atol=1e-5, rtol=0)
    for layer, (k_l, v_l) in enumerate(caches):
        agree(cache.k[layer], k_l)
        agree(cache.v[layer], v_l)
    with pytest.raises(ValueError, match="outside the cache"):
        TM.stack_step(stack, torch.zeros(B, 2, C), cache, T - 1)


# three tiny geometries whose 12 x 12 = 144 positions resolve to the stacked
# path in both packages: the vqgan_* shape (D = 1, no head layers), the same
# at head size 104 (C 208, 2 heads: vqgan_large's head size), and a 2-depth
# one with a 1-layer head
ARCH_D1 = dict(SMALL_ARCH, block_size=[12, 12, 1], head={"n_layer": 0, "block": {"n_head": 2}})
ARCH_D1_HS104 = dict(ARCH_D1, embed_dim=208)
ARCH_D2 = dict(SMALL_ARCH, block_size=[12, 12, 2], head={"n_layer": 1, "block": {"n_head": 2}})
GEOMETRIES = {"12x12x1_head0": ARCH_D1, "12x12x2_head1": ARCH_D2, "12x12x1_head0_hs104": ARCH_D1_HS104}


def _stacked_pair(name):
    arch = GEOMETRIES[name]
    qcfg = dict(latent_shape=(12, 12, 16), code_shape=tuple(arch["block_size"]), n_embed=64, shared_codebook=True)
    return build_pair(arch, qcfg=qcfg)


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_greedy_sample_equals_jax_stacked_sampler(name):
    params, jcfg, state, jq, model, books = _stacked_pair(name)
    assert TS.resolve_unroll(model.config, None) is False
    cond = np.array([3, 7], np.int32)
    want = JS.sample(params, jcfg, jax.random.PRNGKey(0), 2, cond=jnp.asarray(cond), vq_state=state,
                     vq_config=jq, top_k=1)
    tcond = torch.from_numpy(cond).long()
    got = TS.sample(model, 2, torch.Generator().manual_seed(0), cond=tcond, quantizer=books, top_k=1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    unrolled = TS.sample(model, 2, torch.Generator().manual_seed(0), cond=tcond, quantizer=books, top_k=1,
                         unroll=True)
    assert torch.equal(unrolled, got)


def test_forced_logits_stacked_matches_jax(monkeypatch):
    params, jcfg, state, jq, model, books = _stacked_pair("12x12x1_head0")
    # JAX forced_logits calls these two per position; jitted once here, they
    # compute the same in a fraction of the time that eager tracing takes
    monkeypatch.setattr(JM, "stack_step", jax.jit(JM.stack_step, static_argnums=(4,)))
    monkeypatch.setattr(JM, "stack_forward", jax.jit(JM.stack_forward, static_argnums=(2,)))
    r = np.random.RandomState(3)
    forced = r.randint(0, 64, size=(2, 12, 12, 1))
    cond = np.array([1, 4], np.int32)
    want = JS.forced_logits(params, jcfg, jnp.asarray(forced), jnp.asarray(cond), state, jq)
    got = TS.forced_logits(model, torch.from_numpy(forced), torch.from_numpy(cond).long(), books, unroll=False)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("options", [dict(kv_q8=True), dict(dense="mega"), dict(attn_wo=True, kv_q8=True)],
                         ids=["kv_q8", "mega", "attn_wo"])
def test_stacked_path_refuses_the_unrolled_only_options(options):
    _, _, _, _, model, books = build_pair()
    with pytest.raises(ValueError, match="stacked-cache path"):
        TS.sample(model, 1, torch.Generator().manual_seed(0), cond=torch.tensor([1]), quantizer=books,
                  unroll=False, **options)
    with pytest.raises(ValueError, match="stacked-cache path"):
        TS.forced_logits(model, torch.zeros(1, 8, 8, 4, dtype=torch.long), torch.tensor([1]), books,
                         unroll=False, **options)


def _jax_measure_throughput():
    spec = importlib.util.spec_from_file_location("jax_measure_throughput",
                                                  os.path.join(ROOT, "cli", "measure_throughput.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# (f, model, d, c, cond_len, vocab_cond): the zoo's rows at f32-d4 and
# f16-d1 (the depth-1 body), f8, the text-conditional 650M and both VQGAN
# baselines
ZOO = [
    (32, "huge", 4, 16384, 1, 1000), (16, "huge", 1, 16384, 1, 1000), (8, "huge", 4, 16384, 1, 1000),
    (32, "large", 4, 16384, 1, 1000), (16, "large", 1, 16384, 1, 1000), (32, "medium", 4, 16384, 1, 1000),
    (32, "small", 4, 16384, 1, 1000), (32, "650M", 4, 16384, 32, 16384),
    (16, "vqgan_large", 1, 1024, 1, 1000), (16, "vqgan_huge", 1, 16384, 1, 1000),
]


@pytest.mark.parametrize("row", ZOO, ids=[f"f{r[0]}-{r[1]}-d{r[2]}" for r in ZOO])
def test_measure_throughput_build_equals_jax(row):
    jvq, jconf = _jax_measure_throughput().build(*row)
    vqvae, tconf = TMT.build(*row, device="meta")
    assert dataclasses.asdict(tconf) == dataclasses.asdict(jconf)
    for got, want in ((vqvae.hparams, jvq.hparams), (vqvae.ddconfig, jvq.ddconfig)):
        assert {f.name: getattr(got, f.name) for f in dataclasses.fields(got)} == {
            f.name: getattr(want, f.name) for f in dataclasses.fields(got)}
    assert vqvae.quantizer.config.code_shape == (*jvq.hparams.code_shape[:2], row[2])


def test_measure_throughput_build_refuses_a_vqgan_row_off_its_geometry():
    with pytest.raises(ValueError, match="f16-d1-c16384"):
        _jax_measure_throughput().build(32, "vqgan_huge", 1, 16384)
    with pytest.raises(ValueError, match="f16-d1-c16384"):
        TMT.build(32, "vqgan_huge", 1, 16384, device="meta")


def test_jax_tree_with_a_0_layer_head_loads_strict():
    """The vqgan_* shape: init_transformer_params gives the head a leading
    dim of 0 and pos_emb_d one row; the state_dict equals the JAX export and
    loads with strict=True, and the quantized tree's int8 buffers load."""
    jcfg = jax_config(ARCH_D1)
    params = jax.device_get(JM.init_transformer_params(jax.random.PRNGKey(0), jcfg))
    assert np.shape(params["head"]["ln1"]["scale"])[0] == 0
    want = te.export_rqtransformer(params, jcfg)
    got = from_jax.rqtransformer_state_dict_from_jax(params, jcfg)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    model = TM.RQTransformer(TransformerConfig.create(ARCH_D1), device="cpu")
    model.load_state_dict(to_torch(got), strict=True)
    assert len(model.head_transformer.blocks) == 0 and model.pos_emb_d.shape == (1, 1, C)
    model.load_int8(from_jax.rqtransformer_int8_from_jax(jax.device_get(JM.quantize_transformer_params(params))))
    assert model.body_transformer.blocks[0].int8
