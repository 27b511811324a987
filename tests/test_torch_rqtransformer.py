"""The port's RQ-Transformer (rqvae_tpu_torch) against the JAX package.

Small geometry (C=128, 2 heads of 64, 2 body and 2 head layers, 8x8x4 codes,
vocab 64, 10 classes, VQ-VAE input/head embeddings with the cumulative depth
context), fp32 on the CPU. Both sides load the same weights: the JAX init,
perturbed so that no bias is zero and no LayerNorm scale is one, goes
through checkpoint/from_jax into the port.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from rqvae_tpu.checkpoint import torch_export as te
from rqvae_tpu.models.rqtransformer import model as JM
from rqvae_tpu.models.rqtransformer import sampling as JS
from rqvae_tpu.models.rqtransformer.config import TransformerConfig as JTransformerConfig
from rqvae_tpu.ops import quantize as jrq
from rqvae_tpu.utils.config import Config, augment_arch_defaults
from rqvae_tpu_torch.checkpoint import from_jax
from rqvae_tpu_torch.models.rqtransformer import model as TM
from rqvae_tpu_torch.models.rqtransformer import sampling as TS
from rqvae_tpu_torch.models.rqtransformer.config import TransformerConfig
from rqvae_tpu_torch.ops.quantize import QuantizerConfig, RQCodebooks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(ROOT, "tests", "goldens")

SMALL_ARCH = dict(
    type="rq-transformer", vocab_size=64, block_size=[8, 8, 4], embed_dim=128,
    input_embed_dim=16, shared_tok_emb=True, shared_cls_emb=True,
    input_emb_vqvae=True, head_emb_vqvae=True, cumsum_depth_ctx=True,
    vocab_size_cond=10, block_size_cond=1,
    body={"n_layer": 2, "block": {"n_head": 2}},
    head={"n_layer": 2, "block": {"n_head": 2}},
)
# token-embedding mode: tuple embedding with offsets, per-depth classifier,
# a 2-token condition with its own classifier
TOKEMB_ARCH = dict(
    SMALL_ARCH, vocab_size=[64, 64, 48, 48], input_emb_vqvae=False,
    head_emb_vqvae=False, shared_tok_emb=False, shared_cls_emb=False,
    block_size_cond=2, block_size=[4, 4, 4],
)
BENCH_1P4B_ARCH = dict(
    SMALL_ARCH, vocab_size=16384, embed_dim=1536, input_embed_dim=256,
    vocab_size_cond=1000,
    body={"n_layer": 42, "block": {"n_head": 24}},
    head={"n_layer": 6, "block": {"n_head": 24}},
)
QCFG = dict(latent_shape=(8, 8, 16), code_shape=(8, 8, 4), n_embed=64, shared_codebook=True)


def jax_config(arch):
    return JTransformerConfig.create(augment_arch_defaults(Config(arch)).to_dict())


def load_manifest(path):
    out = {}
    with open(path) as f:
        for line in f:
            k, shape = line.rstrip("\n").split("\t")
            out[k] = tuple(int(s) for s in shape.strip("()").split(",") if s.strip())
    return out


def to_torch(sd):
    """numpy state_dict -> torch tensors (writable copies)."""
    return {k: torch.from_numpy(np.array(v, copy=True, order="C")) for k, v in sd.items()}


def build_pair(arch=SMALL_ARCH, seed=0, qcfg=QCFG):
    """(JAX params, JAX config, codebook state, JAX quantizer config, port
    model, port codebooks), all fp32 with equal values; `qcfg` is the
    quantizer's config (its code_shape matches the arch's block_size)."""
    jcfg = jax_config(arch)
    rng = np.random.RandomState(seed)
    params = jax.device_get(JM.init_transformer_params(jax.random.PRNGKey(seed), jcfg))
    params = jax.tree.map(
        lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32), params
    )
    jq = jrq.QuantizerConfig.create(**qcfg)
    state = jax.device_get(jrq.init_codebook_state(jax.random.PRNGKey(seed + 1), jq))

    model = TM.RQTransformer(TransformerConfig.create(arch), device="cpu")
    sd = to_torch(from_jax.rqtransformer_state_dict_from_jax(params, jcfg))
    model.load_state_dict(sd, strict=True)
    model.fuse_qkv()
    books = RQCodebooks(QuantizerConfig.create(**qcfg), device="cpu")
    with torch.no_grad():
        books.codebooks[0].weight[:-1] = torch.tensor(np.asarray(state.embed[0]))
    return params, jcfg, state, jq, model, books


def test_from_jax_state_dict_equals_export_and_loads_strict():
    for arch in (SMALL_ARCH, TOKEMB_ARCH):
        jcfg = jax_config(arch)
        params = jax.device_get(JM.init_transformer_params(jax.random.PRNGKey(0), jcfg))
        want = te.export_rqtransformer(params, jcfg)
        got = from_jax.rqtransformer_state_dict_from_jax(params, jcfg)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        model = TM.RQTransformer(TransformerConfig.create(arch), device="cpu")
        model.load_state_dict(to_torch(got), strict=True)


def test_full_size_1p4b_keys_match_reference_manifest():
    with torch.device("meta"):
        model = TM.RQTransformer(TransformerConfig.create(BENCH_1P4B_ARCH), device="meta")
    want = load_manifest(
        os.path.join(GOLDENS, "key_manifests", "imagenet256__stage2__in256-rqtransformer-8x8x4-1400M.txt")
    )
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == want


def _synth_stage2_arch():
    with open(os.path.join(GOLDENS, "synth_ckpt", "stage2", "config.yaml")) as f:
        return yaml.safe_load(f)["arch"]


def test_synth_stage2_checkpoint_loads_strict():
    model = TM.RQTransformer(TransformerConfig.create(_synth_stage2_arch()), device="cpu")
    ckpt = torch.load(os.path.join(GOLDENS, "synth_ckpt", "stage2", "model.pt"), map_location="cpu")
    model.load_state_dict(ckpt["state_dict"], strict=True)


@pytest.mark.parametrize("name", ["small", "tokemb", "bench_1p4b", "synth_stage2"])
def test_config_equals_jax(name):
    arch = {
        "small": SMALL_ARCH, "tokemb": TOKEMB_ARCH, "bench_1p4b": BENCH_1P4B_ARCH,
        "synth_stage2": _synth_stage2_arch() if name == "synth_stage2" else None,
    }[name]
    assert dataclasses.asdict(TransformerConfig.create(arch)) == dataclasses.asdict(jax_config(arch))


@pytest.mark.parametrize("arch", [SMALL_ARCH, TOKEMB_ARCH], ids=["shared", "per_depth_masked"])
def test_classifier_apply_matches_jax(arch):
    """All depths at once (with the logit mask of unequal codebooks) and one
    depth at a time, as the decode step calls it."""
    params, jcfg, _, _, model, _ = build_pair(arch)
    h = np.random.RandomState(5).standard_normal((3, 2, jcfg.depth, jcfg.embed_dim)).astype(np.float32)
    want = np.asarray(JM.classifier_apply(params, jcfg, jnp.asarray(h)))
    with torch.no_grad():
        got = TM.classifier_apply(model, torch.from_numpy(h)).numpy()
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
        np.testing.assert_allclose(got[np.isfinite(got)], want[np.isfinite(want)], atol=1e-5)
        for d in range(jcfg.depth):
            want_d = np.asarray(JM.classifier_apply(params, jcfg, jnp.asarray(h[:, 0, d]), depth_idx=d))
            got_d = TM.classifier_apply(model, torch.from_numpy(h[:, 0, d]), depth_idx=d).numpy()
            np.testing.assert_array_equal(np.isfinite(got_d), np.isfinite(want_d))
            np.testing.assert_allclose(got_d[np.isfinite(got_d)], want_d[np.isfinite(want_d)], atol=1e-5)


def test_init_weights_is_seeded_gpt_init():
    config = TransformerConfig.create(SMALL_ARCH)
    a, b = TM.RQTransformer(config, device="cpu"), TM.RQTransformer(config, device="cpu")
    a.init_weights(torch.Generator().manual_seed(3))
    b.init_weights(torch.Generator().manual_seed(3))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
    blk = a.body_transformer.blocks[0]
    assert torch.all(blk.ln1.weight == 1) and torch.all(blk.attn.query.bias == 0)
    assert abs(float(blk.mlp[0].weight.detach().std()) - 0.02) < 2e-3
    assert torch.equal(blk.wqkv[: config.embed_dim], blk.attn.query.weight)


# (stack, S, cur_len, window, cache T): body decode steps go through the
# port's attention kernel (plain on the CPU) and JAX's Pallas kernel in
# interpret mode; head steps through the dense kernels on both sides;
# S > 1 is the prefill
STEP_CASES = [
    ("body", 1, 0, None, 32),
    ("body", 1, 5, 16, 32),
    ("body", 1, 20, 24, 32),
    ("body", 1, 31, None, 32),
    ("head", 1, 0, None, 4),
    ("head", 1, 2, None, 4),
    ("body", 3, 0, None, 32),
    ("body", 2, 6, None, 32),
]


@pytest.mark.parametrize("role,S,cur_len,window,T", STEP_CASES)
def test_stack_step_unrolled_matches_jax(role, S, cur_len, window, T):
    params, jcfg, _, _, model, _ = build_pair()
    scfg = jcfg.body if role == "body" else jcfg.head
    stack = model.body_transformer if role == "body" else model.head_transformer
    B, C = 3, jcfg.embed_dim
    rng = np.random.RandomState(1)
    x = rng.standard_normal((B, S, C)).astype(np.float32)
    kc = [rng.standard_normal((B, T, C)).astype(np.float32) for _ in range(scfg.n_layer)]
    vc = [rng.standard_normal((B, T, C)).astype(np.float32) for _ in range(scfg.n_layer)]

    policy = JM.DecodePolicy(attn="pallas", dense="pallas", unroll=True, interpret=True)
    lps = JM.split_layer_params(params[role], scfg)
    jcaches = tuple((jnp.asarray(k), jnp.asarray(v)) for k, v in zip(kc, vc))
    y_j, caches_j = JM.stack_step_unrolled(
        lps, jnp.asarray(x), jcaches, jnp.int32(cur_len), scfg, window=window, policy=policy
    )

    tcaches = [(torch.from_numpy(k.copy()), torch.from_numpy(v.copy())) for k, v in zip(kc, vc)]
    y_t, caches_t = TM.stack_step_unrolled(stack, torch.from_numpy(x), tcaches, cur_len, window=window)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-5, rtol=1e-5)
    for (kj, vj), (kt, vt) in zip(caches_j, caches_t):
        np.testing.assert_allclose(kt.numpy(), np.asarray(kj), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=1e-5, rtol=1e-5)


def test_forced_logits_match_jax_at_every_position(monkeypatch):
    # JAX's forced_logits is an eager per-position loop; jit the three model
    # functions it calls (same math, compiled once instead of per call)
    monkeypatch.setattr(JM, "stack_forward", jax.jit(JM.stack_forward, static_argnums=(2,)))
    monkeypatch.setattr(JM, "stack_step", jax.jit(JM.stack_step, static_argnums=(4,)))
    monkeypatch.setattr(
        JM, "classifier_apply", jax.jit(JM.classifier_apply, static_argnums=(1,), static_argnames=("depth_idx",))
    )
    params, jcfg, state, jq, model, books = build_pair()
    B = 2
    rng = np.random.RandomState(2)
    forced = rng.randint(0, 64, size=(B, 8, 8, 4)).astype(np.int32)
    cond = np.array([3, 7], np.int32)
    want = JS.forced_logits(params, jcfg, jnp.asarray(forced), jnp.asarray(cond), state, jq)
    got = TS.forced_logits(model, torch.from_numpy(forced).long(), torch.from_numpy(cond).long(), books)
    assert got.shape == (B, 8, 8, 4, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
