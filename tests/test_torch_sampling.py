"""The port's sampler (rqvae_tpu_torch) against the JAX package.

The filters are compared on the same numpy logits; the kept sets must be
equal. Sampled codes cannot match the JAX sampler's draw for draw (the two
generators differ), so the end-to-end comparison is a greedy (top_k=1)
sample, which has no randomness left, against JAX's sampler running its
Pallas kernels in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rqvae_tpu.models.rqtransformer import model as JM
from rqvae_tpu.models.rqtransformer import sampling as JS
from rqvae_tpu_torch.models.rqtransformer import sampling as TS
from test_torch_rqtransformer import SMALL_ARCH, TOKEMB_ARCH, build_pair, jax_config

V = 64


def _logits(seed=0, B=6):
    return np.random.RandomState(seed).standard_normal((B, V)).astype(np.float32) * 2.0


@pytest.mark.parametrize("k", [1, 5, 17, 63])
def test_top_k_logits_equal_jax(k):
    x = _logits(k)
    got = TS.top_k_logits(torch.from_numpy(x), k).numpy()
    want = np.asarray(JS.top_k_logits(jnp.asarray(x), k))
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_array_equal(got[np.isfinite(got)], want[np.isfinite(want)])


@pytest.mark.parametrize("p", [0.1, 0.5, 0.9, 0.99])
def test_top_p_probs_equal_jax(p):
    x = _logits(int(p * 100))
    got = TS.top_p_probs(torch.softmax(torch.from_numpy(x), -1), p).numpy()
    want = np.asarray(JS.top_p_probs(jax.nn.softmax(jnp.asarray(x), -1), p))
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, atol=1e-6)


def _jax_exact_kept(x, temperature, k, p):
    """Vocabulary mask of the tokens the JAX exact path can draw."""
    logits = jnp.asarray(x) / temperature
    if k is not None and k < V:
        logits = JS.top_k_logits(logits, k)
    probs = jax.nn.softmax(logits, axis=-1)
    if p is not None:
        probs = JS.top_p_probs(probs, p)
    return np.asarray(probs) > 0


@pytest.mark.parametrize("k,p", [(None, 0.8), (10, None), (10, 0.8), (1, None), (64, 0.5), (None, None)])
def test_fast_path_kept_set_equals_jax_exact_path(k, p):
    x = _logits(3)
    vals, idx = TS.fast_candidates(torch.from_numpy(x), 0.7, k, p)
    kept = torch.zeros(x.shape, dtype=torch.bool)
    if idx is None:
        kept = torch.isfinite(vals)
    else:
        kept.scatter_(-1, idx, torch.isfinite(vals))
    np.testing.assert_array_equal(kept.numpy(), _jax_exact_kept(x, 0.7, k, p))


@pytest.mark.parametrize("exact", [True, False])
def test_draws_stay_in_the_kept_set(exact):
    x = torch.from_numpy(_logits(4, B=4)).repeat(50, 1)
    gen = torch.Generator().manual_seed(0)
    draw = TS.sample_from_logits if exact else TS.sample_from_logits_fast
    codes = draw(x, gen, 1.0, 3, 0.9)
    kept = torch.from_numpy(_jax_exact_kept(x.numpy(), 1.0, 3, 0.9))
    assert kept.gather(-1, codes[:, None]).all()


@pytest.mark.parametrize(
    "top_k,top_p", [(None, None), (5, 0.9), ([3], [0.5]), ([1, 2, 3, 100], [0.1, 0.2, 0.3, 2.0])]
)
def test_broadcast_topk_topp_equals_jax(top_k, top_p):
    for arch in (SMALL_ARCH, TOKEMB_ARCH):
        cfg = jax_config(arch)
        assert TS.broadcast_topk_topp(cfg, top_k, top_p) == JS.broadcast_topk_topp(cfg, top_k, top_p)


@pytest.mark.parametrize("exact", [False, True])
def test_greedy_sample_equals_jax_sampler_with_interpreted_kernels(exact):
    params, jcfg, state, jq, model, books = build_pair()
    cond = np.array([3, 7], np.int32)
    policy = JM.DecodePolicy(attn="pallas", dense="pallas", interpret=True, exact_sample=exact)
    want = JS.sample(
        params, jcfg, jax.random.PRNGKey(0), 2, cond=jnp.asarray(cond), vq_state=state,
        vq_config=jq, top_k=1, policy=policy,
    )
    got = TS.sample(model, 2, torch.Generator().manual_seed(0), cond=torch.from_numpy(cond).long(),
                    quantizer=books, top_k=1, exact_sample=exact)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_temperature_one_sample_codes_in_range_and_seeded():
    _, _, _, _, model, books = build_pair()
    cond = torch.tensor([1, 2, 3])
    a = TS.sample(model, 3, torch.Generator().manual_seed(5), cond=cond, quantizer=books)
    b = TS.sample(model, 3, torch.Generator().manual_seed(5), cond=cond, quantizer=books)
    assert a.shape == (3, 8, 8, 4)
    assert int(a.min()) >= 0 and int(a.max()) < V
    assert torch.equal(a, b)
    assert len(torch.unique(a)) > 8  # a temperature-1 draw, not a constant
