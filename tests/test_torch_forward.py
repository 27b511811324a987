"""The port's teacher-forced forward, losses and gradients against the JAX
package, in fp32 and under amp bf16 on the CPU.

Geometries and weights are tests/test_torch_rqtransformer.py's: SMALL_ARCH
(8x8x4 codes, VQ-VAE input and head embeddings with the depth cumsum,
shared token embedding and classifier) and TOKEMB_ARCH (4x4x4 codes, the
tuple token embedding, per-depth classifiers with the logit mask of
unequal codebooks, a 2-token condition with its own classifier), JAX's
init perturbed by seeded noise and loaded into the port through
checkpoint/from_jax. The frameworks draw different random bits, so the
parity tests run without dropout (deterministic=True); dropout has tests
of its own.

Tolerances: the forward in fp32 |got - ref| <= 1e-5 (1 + |ref|) (a few
ulps of the O(1) logits after 4 layers); under amp bf16 the bounds of
test_forward_matches_jax_amp_bf16 (each side rounds at its own points);
the losses 1e-6 relative;
the gradients in fp32: each tensor's max |got - ref| <= 1e-4 of its max
|ref|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rqvae_tpu.models.rqtransformer import model as JM
from rqvae_tpu.trainers import trainer_stage2 as J2
from rqvae_tpu_torch.checkpoint import from_jax
from rqvae_tpu_torch.models.rqtransformer import model as TM
from rqvae_tpu_torch.models.rqtransformer import sampling as TS
from rqvae_tpu_torch.trainers import trainer_stage2 as T2
from test_torch_rqtransformer import SMALL_ARCH, TOKEMB_ARCH, build_pair

ARCHS = {"shared": SMALL_ARCH, "tokemb": TOKEMB_ARCH}
B = 3


def _inputs(jcfg, seed):
    """Codes [B, H, W, D] within each depth's vocab, a condition of the
    config's length, code embeddings [B, HW, D, input_embed_dim] and soft
    targets [B, H, W, D, V] (softmax of random logits; equal vocabs only)."""
    rng = np.random.RandomState(seed)
    H, W, D = jcfg.block_size
    codes = np.stack([rng.randint(0, v, size=(B, H, W)) for v in jcfg.vocab_size], axis=-1).astype(np.int32)
    cond = rng.randint(0, jcfg.vocab_size_cond, size=(B, jcfg.block_size_cond)).astype(np.int32)
    xs_emb = None
    if jcfg.input_emb_vqvae or jcfg.head_emb_vqvae:
        xs_emb = rng.standard_normal((B, H * W, D, jcfg.input_embed_dim)).astype(np.float32)
    z = 3.0 * rng.standard_normal((B, H, W, D, jcfg.vocab_size_max))
    soft = np.exp(z - z.max(-1, keepdims=True))
    soft = (soft / soft.sum(-1, keepdims=True)).astype(np.float32)
    return codes, cond, xs_emb, soft


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a, copy=True))


@pytest.fixture(scope="module", params=list(ARCHS))
def case(request):
    params, jcfg, _, _, model, _ = build_pair(ARCHS[request.param])
    return request.param, params, jcfg, model, _inputs(jcfg, 7)


@pytest.fixture(scope="module")
def jax_forward():
    return jax.jit(JM.forward, static_argnums=(1,), static_argnames=("deterministic", "remat"))


def _check_logits(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    err = np.abs(got[fin] - want[fin]) / (1.0 + np.abs(want[fin]))
    assert err.max() <= tol, err.max()


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


def test_forward_matches_jax_fp32(case, jax_forward):
    name, params, jcfg, model, (codes, cond, xs_emb, _) = case
    want = jax_forward(params, jcfg, jnp.asarray(codes), jnp.asarray(cond),
                       None if xs_emb is None else jnp.asarray(xs_emb))
    with torch.no_grad():
        got = model(_t(codes).long(), _t(cond).long(), _t(xs_emb))
    assert len(_outputs(got)) == (2 if name == "tokemb" else 1)
    for g, w in zip(_outputs(got), _outputs(want)):
        _check_logits(g.numpy(), w, 1e-5)


def test_forward_matches_jax_amp_bf16(case, jax_forward):
    """Both sides cast every fp32 weight and the code embeddings to bf16,
    as their loss_fn does under amp_bf16. JAX's own bf16 logits lie up to
    2.5e-2 (1 + |ref|) from its fp32 logits at these weights (XLA keeps
    excess precision inside its fusions; the port rounds after each op),
    so two bf16 paths may sit that far on either side: the elementwise
    bound against JAX's bf16 is 4e-2 (1 + |ref|), the mean 5e-3 (under
    one bf16 ulp at the logits' scale), and the port's own distance from
    the fp32 logits is at most JAX's plus one bf16 ulp (2^-7 of 1 + |ref|)."""
    name, params, jcfg, model, (codes, cond, xs_emb, _) = case
    bf = lambda t: t.astype(jnp.bfloat16) if t.dtype == jnp.float32 else t  # noqa: E731
    args = (jnp.asarray(codes), jnp.asarray(cond))
    want = jax_forward(jax.tree.map(bf, jax.tree.map(jnp.asarray, params)), jcfg, *args,
                       None if xs_emb is None else jnp.asarray(xs_emb, jnp.bfloat16))
    want32 = jax_forward(params, jcfg, *args, None if xs_emb is None else jnp.asarray(xs_emb))
    p16 = {k: v.to(torch.bfloat16) for k, v in model.named_parameters()}
    emb = None if xs_emb is None else _t(xs_emb).to(torch.bfloat16)
    with torch.no_grad():
        got = torch.func.functional_call(model, p16, (_t(codes).long(), _t(cond).long(), emb))
    for g, w, w32 in zip(_outputs(got), _outputs(want), _outputs(want32)):
        assert g.dtype == torch.bfloat16
        g, w, w32 = g.float().numpy(), np.asarray(w, np.float32), np.asarray(w32)
        _check_logits(g, w, 4e-2)
        fin = np.isfinite(w32)
        assert (np.abs(g[fin] - w[fin]) / (1.0 + np.abs(w[fin]))).mean() <= 5e-3
        port_err = np.abs(g[fin] - w32[fin]) / (1.0 + np.abs(w32[fin]))
        jax_err = np.abs(w[fin] - w32[fin]) / (1.0 + np.abs(w32[fin]))
        assert port_err.max() <= jax_err.max() + 2**-7, (port_err.max(), jax_err.max())


LOSSES = ["soft_target_cross_entropy", "cross_entropy", "compute_loss_soft", "compute_loss_hard",
          "compute_cond_loss", "compute_codebook_loss_soft", "compute_codebook_loss_hard"]


@pytest.mark.parametrize("loss", LOSSES)
def test_losses_match_jax(loss):
    """On random logits [2, 4, 4, 3, 40] (a bf16 copy for the fp32
    log-softmax), soft targets over the first 32 entries, codes, and a
    3-token condition with its logits."""
    rng = np.random.RandomState(3)
    logits = (2.0 * rng.standard_normal((2, 4, 4, 3, 40))).astype(np.float32)
    soft = rng.uniform(size=(2, 4, 4, 3, 32)).astype(np.float32)
    soft /= soft.sum(-1, keepdims=True)
    codes = rng.randint(0, 40, size=(2, 4, 4, 3)).astype(np.int32)
    cond_logits = rng.standard_normal((2, 2, 10)).astype(np.float32)
    conds = rng.randint(0, 10, size=(2, 3)).astype(np.int32)
    l16 = jnp.asarray(logits, jnp.bfloat16)
    t16 = _t(logits).to(torch.bfloat16)
    calls = {
        "soft_target_cross_entropy": (lambda M, lg, a, b: M.soft_target_cross_entropy(lg, a, reduction="none"),
                                      soft, None),
        "cross_entropy": (lambda M, lg, a, b: M.cross_entropy(lg, a, reduction="none"), codes, None),
        "compute_loss_soft": (lambda M, lg, a, b: M.compute_loss(lg, a, use_soft_target=True), soft, None),
        "compute_loss_hard": (lambda M, lg, a, b: M.compute_loss(lg, a), codes, None),
        "compute_cond_loss": (lambda M, lg, a, b: M.compute_cond_loss(a, b), cond_logits, conds),
        "compute_codebook_loss_soft": (lambda M, lg, a, b: M.compute_codebook_loss(lg, a, use_soft_target=True),
                                       soft, None),
        "compute_codebook_loss_hard": (lambda M, lg, a, b: M.compute_codebook_loss(lg, a), codes, None),
    }
    fn, a, b = calls[loss]
    for lj, lt in ((jnp.asarray(logits), _t(logits)), (l16, t16)):
        want = np.asarray(fn(JM, lj, jnp.asarray(a), None if b is None else jnp.asarray(b)))
        got = fn(TM, lt, _t(a), _t(b)).numpy()
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def jax_grad():
    def grads(params, config, loss_cfg, codes, soft, cond, xs_emb):
        return jax.grad(J2.loss_fn, has_aux=True)(params, config, loss_cfg, codes, soft, cond, xs_emb, None,
                                                  deterministic=True)

    return jax.jit(grads, static_argnums=(1, 2))


def test_loss_fn_gradients_match_jax(case, jax_grad):
    """The gradients of loss_fn with respect to every parameter, fp32: soft
    targets in the shared geometry, codes and the condition's loss in the
    token-embedding one, against jax.grad of the JAX loss_fn, mapped by
    the parameters' own mapping (rqtransformer_state_dict_from_jax)."""
    name, params, jcfg, model, (codes, cond, xs_emb, soft) = case
    soft_targets = name == "shared"
    jl = J2.Stage2LossConfig(use_soft_target=soft_targets, amp_bf16=False)
    want_g, want_m = jax_grad(params, jcfg, jl, jnp.asarray(codes), jnp.asarray(soft) if soft_targets else None,
                              jnp.asarray(cond), None if xs_emb is None else jnp.asarray(xs_emb))
    want = from_jax.rqtransformer_state_dict_from_jax(jax.device_get(want_g), jcfg)
    tl = T2.Stage2LossConfig(use_soft_target=soft_targets, amp_bf16=False)
    model.zero_grad(set_to_none=True)
    loss, metrics = T2.loss_fn(model, tl, _t(codes).long(), _t(soft) if soft_targets else None, _t(cond).long(),
                               _t(xs_emb), None, deterministic=True)
    loss.backward()
    for key in want_m:
        np.testing.assert_allclose(metrics[key].detach().numpy(), np.asarray(want_m[key]), rtol=1e-5, atol=1e-6,
                                   err_msg=key)
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert set(grads) == set(want) - {"tok_emb.offsets"}
    scale = max(np.abs(np.asarray(v)).max() for v in want.values())
    for k, g in grads.items():
        ref = np.asarray(want[k])
        assert g is not None, k
        if k.endswith("attn.key.bias"):
            # exactly 0 in exact arithmetic (the softmax drops a shift common
            # to a query's scores): both sides hold rounding noise only
            assert max(np.abs(g.numpy()).max(), np.abs(ref).max()) <= 1e-6 * scale, k
            continue
        assert np.abs(g.numpy() - ref).max() <= 1e-4 * np.abs(ref).max(), k
    model.zero_grad(set_to_none=True)


def _drop_model(arch, seed=0):
    """The port's model of `arch` with resid_pdrop 0.1 and embd_pdrop 0.1."""
    arch = dict(arch, embd_pdrop=0.1, body={**arch["body"], "block": {**arch["body"]["block"], "resid_pdrop": 0.1}},
                head={**arch["head"], "block": {**arch["head"]["block"], "resid_pdrop": 0.1}})
    _, jcfg, _, _, model, _ = build_pair(arch, seed=seed)
    return jcfg, model


def _grads_with_dropout(model, inputs, seed, remat):
    codes, cond, xs_emb, soft = inputs
    gen = torch.Generator().manual_seed(seed)
    cfg = T2.Stage2LossConfig(amp_bf16=False, remat=remat)
    model.zero_grad(set_to_none=True)
    loss, _ = T2.loss_fn(model, cfg, _t(codes).long(), _t(soft), _t(cond).long(), _t(xs_emb), gen)
    loss.backward()
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads, gen.get_state()


def test_remat_gives_the_same_gradients_and_dropout_masks():
    """With dropout on and one seed, remat=True recomputes each layer with
    the forward's masks: the loss and every gradient equal remat=False's,
    and the generator ends where the plain pass left it. Another seed
    draws other masks."""
    jcfg, model = _drop_model(SMALL_ARCH)
    inputs = _inputs(jcfg, 8)
    loss0, g0, state0 = _grads_with_dropout(model, inputs, 5, remat=False)
    loss1, g1, state1 = _grads_with_dropout(model, inputs, 5, remat=True)
    assert loss1 == loss0
    assert torch.equal(state0, state1)
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=1e-6, atol=1e-7, msg=k)
    loss2, _, _ = _grads_with_dropout(model, inputs, 6, remat=False)
    assert loss2 != loss0
    codes, cond, xs_emb, soft = inputs
    with torch.no_grad():
        det, _ = T2.loss_fn(model, T2.Stage2LossConfig(amp_bf16=False), _t(codes).long(), _t(soft),
                            _t(cond).long(), _t(xs_emb), None, deterministic=True)
    assert float(det) not in (loss0, loss2)


def test_dropout_keeps_its_share_and_scales():
    x = torch.randn(1000, 1000, generator=torch.Generator().manual_seed(0))
    rate = 0.1
    y = TM.dropout(x, rate, torch.Generator().manual_seed(1), deterministic=False)
    kept = y != 0
    assert abs(float(kept.float().mean()) - (1 - rate)) < 3e-3  # 10 standard deviations of the share
    assert torch.equal(y[kept], x[kept] / (1 - rate))
    assert torch.equal(TM.dropout(x, rate, torch.Generator().manual_seed(1), deterministic=False), y)
    assert not torch.equal(TM.dropout(x, rate, torch.Generator().manual_seed(2), deterministic=False), y)
    assert TM.dropout(x, rate, None, deterministic=True) is x
    assert TM.dropout(x, 0.0, None, deterministic=False) is x
    yb = TM.dropout(x.to(torch.bfloat16), rate, torch.Generator().manual_seed(1), deterministic=False)
    assert yb.dtype == torch.bfloat16 and torch.equal(yb != 0, kept)
    with pytest.raises(ValueError, match="Generator"):
        TM.dropout(x, rate, None, deterministic=False)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_forward_agrees_with_the_samplers_forced_logits(arch):
    """The teacher-forced logits of codes equal the cached sampler's logits
    with the same codes forced (the decode path the port already holds
    against JAX), in fp32."""
    _, jcfg, _, _, model, books = build_pair(ARCHS[arch])
    codes, cond, _, _ = _inputs(jcfg, 9)
    codes_t, cond_t = _t(codes).long(), _t(cond).long()
    xs_emb = None
    if jcfg.input_emb_vqvae:
        from rqvae_tpu_torch.ops import quantize as tq

        xs_emb = tq.embed_code_with_depth(codes_t.reshape(B, -1, jcfg.depth), books)
    with torch.no_grad():
        got = _outputs(model(codes_t, cond_t, xs_emb))[0]
        want = TS.forced_logits(model, codes_t, cond_t, books, kernels=False)
    _check_logits(got.numpy(), want.numpy(), 1e-4)


def test_forward_refuses_int8_buffers():
    _, jcfg, _, _, model, _ = build_pair(SMALL_ARCH)
    codes, cond, xs_emb, _ = _inputs(jcfg, 10)
    model.quantize_int8()
    with pytest.raises(ValueError, match="clear_int8"):
        model(_t(codes).long(), _t(cond).long(), _t(xs_emb))
