"""The port's RQ-VAE encode side against the JAX package, in fp32 on the CPU:
Encoder / encode, residual quantization (quantize, find_nearest,
rq_bottleneck_forward), the forward, get_codes, get_soft_codes, the
partial-code decodes, compute_loss, and the committed synthetic stage-1
checkpoint. The model is test_torch_rqvae's small config (32x32 pixels,
ch 32, ch_mult (1, 2), attention at 16x16, 8x8x2 codes over a 16x16x8
latent, 64 codes per depth) with JAX's init plus seeded noise, mapped into
the port by from_jax.rqvae_state_dict_from_jax.

Tolerances: 1e-4 on conv-stack outputs (encode, reconstructions), as for
decode_code; 1e-5 on the quantizer's cumsums and losses (a few fp32 ulps
of O(1) values); soft targets relative to p, from the fp32 rounding of
the distances they exponentiate (see the test); codes equal.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from rqvae_tpu.checkpoint.torch_convert import convert_rqvae
from rqvae_tpu.models.rqvae.model import RQVAE as JRQVAE
from rqvae_tpu.models.rqvae.model import RQVAEHParams as JHParams
from rqvae_tpu.models.rqvae.modules import DDConfig as JDDConfig
from rqvae_tpu.ops import quantize as jrq
from rqvae_tpu_torch.models.rqvae.model import RQVAE, RQVAEHParams
from rqvae_tpu_torch.models.rqvae.modules import DDConfig
from rqvae_tpu_torch.ops import quantize as tq
from test_torch_rqtransformer import GOLDENS
from test_torch_rqvae import HP, _jax_model, _port_model


@pytest.fixture(scope="module")
def pair():
    """(JAX model with use_kernel=True, its variables, the port model, seeded
    pixels [2, 32, 32, 3] in [-1, 1] as numpy)."""
    jmodel, params, state = _jax_model()
    model = _port_model(params, state, jmodel.quantizer_config)
    xs = np.random.RandomState(11).uniform(-1.0, 1.0, size=(2, 32, 32, 3)).astype(np.float32)
    return jmodel.clone(use_kernel=True), {"params": params, "codebook": {"state": state}}, model, xs


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def test_encoder_and_encode_match_jax(pair):
    jmodel, variables, model, xs = pair
    want_enc = jmodel.apply(variables, jnp.asarray(xs), method=lambda m, x: m.encoder(x))
    want = jmodel.apply(variables, jnp.asarray(xs), method=JRQVAE.encode)
    with torch.no_grad():
        got_enc = model.encoder(_t(xs).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        got = model.encode(_t(xs))
    assert got.shape == (2, 16, 16, 8)
    np.testing.assert_allclose(got_enc.numpy(), np.asarray(want_enc), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_quantize_matches_jax(pair, use_kernel):
    jmodel, variables, model, xs = pair
    z_e = np.asarray(jmodel.apply(variables, jnp.asarray(xs), method=JRQVAE.encode))
    qcfg = jmodel.quantizer_config
    x = jrq.to_code_shape(jnp.asarray(z_e), qcfg)
    want_q, want_c = jrq.quantize(x, variables["codebook"]["state"], qcfg, use_kernel=use_kernel)
    got_x = tq.to_code_shape(_t(z_e), model.quantizer.config)
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(x))
    got_q, got_c = tq.quantize(got_x, model.quantizer, use_kernel=use_kernel)
    assert got_q.shape == (2, 2, 8, 8, 32) and got_c.shape == (2, 8, 8, 2) and got_c.dtype == torch.long
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_allclose(got_q.numpy(), np.asarray(want_q), atol=1e-5, rtol=0)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_find_nearest_matches_jax(pair, use_kernel):
    _, variables, model, _ = pair
    rng = np.random.RandomState(12)
    x = rng.randn(3, 5, 32).astype(np.float32)
    cb = np.asarray(variables["codebook"]["state"].embed[0])
    want = jrq.find_nearest(jnp.asarray(x), jnp.asarray(cb), use_kernel=use_kernel)
    got = tq.find_nearest(_t(x), model.quantizer.codebook(0), use_kernel=use_kernel)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(
        tq.compute_distances(_t(x), _t(cb)).numpy(), np.asarray(jrq.compute_distances(jnp.asarray(x), jnp.asarray(cb))),
        atol=1e-4, rtol=1e-6,
    )


def test_forward_matches_jax(pair):
    jmodel, variables, model, xs = pair
    want_out, want_loss, want_codes = jmodel.apply(variables, jnp.asarray(xs))
    with torch.no_grad():
        out, loss, codes = model(_t(xs))
        got_codes = model.get_codes(_t(xs))
    want_get = jmodel.apply(variables, jnp.asarray(xs), method=JRQVAE.get_codes)
    assert out.shape == (2, 32, 32, 3) and codes.shape == (2, 8, 8, 2)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want_codes))
    np.testing.assert_array_equal(got_codes.numpy(), np.asarray(want_get))
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=1e-4, rtol=0)
    np.testing.assert_allclose(float(loss), float(want_loss), atol=1e-5, rtol=0)


def test_bottleneck_straight_through_and_loss_match_jax(pair):
    jmodel, variables, model, xs = pair
    z_e = np.asarray(jmodel.apply(variables, jnp.asarray(xs), method=JRQVAE.encode))
    want_zq, want_loss, want_codes, _ = jrq.rq_bottleneck_forward(
        jnp.asarray(z_e), variables["codebook"]["state"], jmodel.quantizer_config
    )
    zq, loss, codes = tq.rq_bottleneck_forward(_t(z_e), model.quantizer)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want_codes))
    np.testing.assert_allclose(zq.numpy(), np.asarray(want_zq), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(loss), float(want_loss), atol=1e-5, rtol=0)


def test_training_branch_is_not_ported_yet(pair):
    """The training branch, once refused here, is ported (its tests against
    JAX: test_torch_quantize_train.py): with restarts on it needs a
    torch.Generator, and with one it runs, updating the codebooks."""
    _, _, model, xs = pair
    with pytest.raises(ValueError, match="Generator"):
        model(_t(xs), training=True)
    before = model.quantizer.codebook(0).clone()
    trained = copy.deepcopy(model)
    with torch.no_grad():
        out, _, codes = trained(_t(xs), training=True, generator=torch.Generator().manual_seed(0))
    assert out.shape == (2, 32, 32, 3) and codes.shape == (2, 8, 8, 2)
    assert not torch.equal(trained.quantizer.codebook(0), before)
    assert torch.equal(model.quantizer.codebook(0), before)


@pytest.mark.parametrize("temp", [1.0, 0.5])
def test_soft_codes_deterministic_match_jax(pair, temp):
    jmodel, variables, model, xs = pair
    want_soft, want_codes = jmodel.apply(variables, jnp.asarray(xs), temp, method=JRQVAE.get_soft_codes)
    with torch.no_grad():
        soft, codes = model.get_soft_codes(_t(xs), temp=temp)
    assert soft.shape == (2, 8, 8, 2, 64)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want_codes))
    # softmax(-dist / temp) moves p by p * (the logit errors); the two fp32
    # distance products round in another order, a few ulps of the largest
    # distance (~150 here, ulp 1.5e-5): allow 8 ulps, twice (the logit and
    # the normaliser)
    z = tq.to_code_shape(model.encode(_t(xs)).detach(), model.quantizer.config)
    max_dist = float(tq.compute_distances(z, model.quantizer.codebook(0)).max())
    rtol = 2 * 8 * np.finfo(np.float32).eps * max_dist / temp
    np.testing.assert_allclose(soft.numpy(), np.asarray(want_soft), rtol=rtol, atol=1e-12)


def test_soft_codes_stochastic_repeat_under_one_generator(pair):
    """JAX and torch draw different random bits, so the draws are checked
    for range and repeatability, and depth 0's soft targets (which no draw
    precedes) against the deterministic ones."""
    _, _, model, xs = pair
    with torch.no_grad():
        det_soft, _ = model.get_soft_codes(_t(xs), temp=2.0)
        runs = [model.get_soft_codes(_t(xs), 2.0, True, torch.Generator().manual_seed(s)) for s in (3, 3, 4)]
        with pytest.raises(ValueError, match="Generator"):
            model.get_soft_codes(_t(xs), 2.0, True)
    (soft_a, codes_a), (soft_b, codes_b), (_, codes_c) = runs
    assert codes_a.shape == (2, 8, 8, 2) and int(codes_a.min()) >= 0 and int(codes_a.max()) < 64
    assert torch.equal(codes_a, codes_b) and torch.equal(soft_a, soft_b)
    assert not torch.equal(codes_a, codes_c)
    torch.testing.assert_close(soft_a[..., 0, :], det_soft[..., 0, :], atol=0, rtol=0)


@pytest.mark.parametrize("decode_type", ["select", "add"])
@pytest.mark.parametrize("code_idx", [0, 1])
def test_partial_code_decodes_match_jax(pair, decode_type, code_idx):
    jmodel, variables, model, xs = pair
    codes = np.random.RandomState(13).randint(0, 65, size=(2, 8, 8, 2)).astype(np.int32)  # 64 = padding
    want = jmodel.apply(variables, jnp.asarray(codes), code_idx, decode_type, method=JRQVAE.decode_partial_code)
    want_fwd = jmodel.apply(variables, jnp.asarray(xs), code_idx, decode_type, method=JRQVAE.forward_partial_code)
    with torch.no_grad():
        got = model.decode_partial_code(_t(codes).long(), code_idx, decode_type)
        got_fwd = model.forward_partial_code(_t(xs), code_idx, decode_type)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_fwd.numpy(), np.asarray(want_fwd), atol=1e-4, rtol=0)


def test_code_emb_with_depth_and_recon_imgs_match_jax(pair):
    jmodel, variables, model, xs = pair
    codes = np.random.RandomState(14).randint(0, 65, size=(2, 8, 8, 2)).astype(np.int32)
    want = jmodel.apply(variables, jnp.asarray(codes), method=JRQVAE.get_code_emb_with_depth)
    got = model.get_code_emb_with_depth(_t(codes).long())
    assert got.shape == (2, 8, 8, 2, 32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    recon = 1.5 * xs
    for g, w in zip(RQVAE.get_recon_imgs(_t(xs), _t(recon)), JRQVAE.get_recon_imgs(jnp.asarray(xs), jnp.asarray(recon))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("loss_type", ["mse", "l1"])
@pytest.mark.parametrize("valid", [False, True])
def test_compute_loss_matches_jax(pair, loss_type, valid):
    jmodel, variables, _, xs = pair
    hp = dict(HP, loss_type=loss_type)
    jm = jmodel.clone(hparams=JHParams.create(hp))
    model = RQVAE(RQVAEHParams.create(hp), DDConfig.create(dict(
        double_z=False, z_channels=4, resolution=8, in_channels=3, out_ch=3, ch=8, ch_mult=[1],
        num_res_blocks=1, attn_resolutions=[], dropout=0.0)), device="cpu")
    rng = np.random.RandomState(15)
    out = rng.uniform(-1, 1, size=xs.shape).astype(np.float32)
    quant_loss = np.float32(0.37)
    codes = rng.randint(0, 64, size=(2, 8, 8, 2)).astype(np.int32)
    want = jm.apply(variables, jnp.asarray(out), jnp.asarray(quant_loss), jnp.asarray(codes), jnp.asarray(xs), valid,
                    method=JRQVAE.compute_loss)
    got = model.compute_loss(_t(out), torch.tensor(quant_loss), _t(codes), _t(xs), valid=valid)
    for key in ("loss_total", "loss_recon", "loss_latent"):
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-6, atol=1e-6, err_msg=key)
    assert len(got["codes"]) == 1 and got["codes"][0] is not None


def test_synth_stage1_checkpoint_encodes_like_jax():
    with open(os.path.join(GOLDENS, "synth_ckpt", "stage1", "config.yaml")) as f:
        arch = yaml.safe_load(f)["arch"]
    sd = torch.load(os.path.join(GOLDENS, "synth_ckpt", "stage1", "model.pt"), map_location="cpu")["state_dict"]
    model = RQVAE(RQVAEHParams.create(arch["hparams"]), DDConfig.create(arch["ddconfig"]), device="cpu")
    model.load_state_dict(sd, strict=True)
    jmodel = JRQVAE(hparams=JHParams.create(arch["hparams"]), ddconfig=JDDConfig.create(arch["ddconfig"]))
    params, state = convert_rqvae(sd, jmodel.quantizer_config)
    xs = np.random.RandomState(16).uniform(-1.0, 1.0, size=(2, 64, 64, 3)).astype(np.float32)
    want_out, want_loss, want_codes = jmodel.apply({"params": params, "codebook": {"state": state}}, jnp.asarray(xs))
    with torch.no_grad():
        out, loss, codes = model(_t(xs))
    assert codes.shape == (2, 8, 8, 2)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want_codes))
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=1e-4, rtol=0)
    np.testing.assert_allclose(float(loss), float(want_loss), atol=1e-5, rtol=0)
