"""The port's RQ-VAE decode side (rqvae_tpu_torch.models.rqvae) against the
JAX package: decode_code on a small config (32x32 pixels, ch 32,
ch_mult (1, 2), attention at 16x16, 8x8x2 codes over a 16x16x8 latent)
within 1e-4 in fp32, the state_dict bridge, and the reference key layout.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch
import yaml

from rqvae_tpu.checkpoint import torch_export as te
from rqvae_tpu.models.rqvae.model import RQVAE as JRQVAE
from rqvae_tpu.models.rqvae.model import RQVAEHParams as JHParams
from rqvae_tpu.models.rqvae.modules import DDConfig as JDDConfig
from rqvae_tpu.ops import quantize as jrq
from rqvae_tpu_torch.checkpoint import from_jax
from rqvae_tpu_torch.models.rqvae.model import RQVAE, RQVAEHParams
from rqvae_tpu_torch.models.rqvae.modules import DDConfig
from rqvae_tpu_torch.ops import quantize as tq
from test_torch_rqtransformer import GOLDENS, load_manifest, to_torch

DD = dict(double_z=False, z_channels=16, resolution=32, in_channels=3, out_ch=3, ch=32,
          ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[16], dropout=0.0)
HP = dict(embed_dim=8, n_embed=64, latent_shape=[16, 16, 8], code_shape=[8, 8, 2],
          shared_codebook=False, restart_unused_codes=True, loss_type="mse")


def _jax_model():
    model = JRQVAE(hparams=JHParams.create(HP), ddconfig=JDDConfig.create(DD), use_kernel=False)
    variables = model.init(
        {"params": jax.random.PRNGKey(0), "quantizer": jax.random.PRNGKey(1)},
        jnp.zeros((1, 32, 32, 3), jnp.float32),
    )
    # non-trivial norms and biases, so every tensor's use is checked
    rng = np.random.RandomState(0)
    params = jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        jax.device_get(variables["params"]),
    )
    state = jax.device_get(variables["codebook"]["state"])
    return model, params, state


def _port_model(params, state, qcfg):
    model = RQVAE(RQVAEHParams.create(HP), DDConfig.create(DD), device="cpu")
    sd = from_jax.rqvae_state_dict_from_jax(params, state, qcfg)
    model.load_state_dict(to_torch(sd), strict=True)
    return model


def test_state_dict_from_jax_equals_export():
    jmodel, params, state = _jax_model()
    want = te.export_rqvae(params, state, jmodel.quantizer_config)
    got = from_jax.rqvae_state_dict_from_jax(params, state, jmodel.quantizer_config)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_decode_code_matches_jax():
    jmodel, params, state = _jax_model()
    codes = np.random.RandomState(3).randint(0, 65, size=(2, 8, 8, 2)).astype(np.int32)  # 64 = padding
    want = jmodel.apply({"params": params, "codebook": {"state": state}}, jnp.asarray(codes),
                        method=JRQVAE.decode_code)
    model = _port_model(params, state, jmodel.quantizer_config)
    with torch.no_grad():
        got = model.decode_code(torch.from_numpy(codes).long())
    assert got.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_embed_code_matches_jax():
    jmodel, params, state = _jax_model()
    codes = np.random.RandomState(4).randint(0, 65, size=(3, 8, 8, 2)).astype(np.int32)
    want = jrq.embed_code(jnp.asarray(codes), state, jmodel.quantizer_config)
    model = _port_model(params, state, jmodel.quantizer_config)
    got = tq.embed_code(torch.from_numpy(codes).long(), model.quantizer)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_full_size_rqvae_keys_match_reference_manifest():
    dd = DDConfig.create(dict(double_z=False, z_channels=256, resolution=256, in_channels=3, out_ch=3,
                              ch=128, ch_mult=[1, 1, 2, 2, 4, 4], num_res_blocks=2,
                              attn_resolutions=[8], dropout=0.0))
    hp = RQVAEHParams.create(dict(embed_dim=256, n_embed=16384, latent_shape=[8, 8, 256],
                                  code_shape=[8, 8, 4], shared_codebook=True))
    model = RQVAE(hp, dd, device="meta")
    want = load_manifest(os.path.join(GOLDENS, "key_manifests", "imagenet256__stage1__in256-rqvae-8x8x4.txt"))
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == want


def test_synth_stage1_checkpoint_loads_strict():
    with open(os.path.join(GOLDENS, "synth_ckpt", "stage1", "config.yaml")) as f:
        arch = yaml.safe_load(f)["arch"]
    model = RQVAE(RQVAEHParams.create(arch["hparams"]), DDConfig.create(arch["ddconfig"]), device="cpu")
    ckpt = torch.load(os.path.join(GOLDENS, "synth_ckpt", "stage1", "model.pt"), map_location="cpu")
    model.load_state_dict(ckpt["state_dict"], strict=True)
    with torch.no_grad():
        pix = model.decode_code(torch.zeros(1, 8, 8, 2, dtype=torch.long))
    assert pix.shape == (1, 64, 64, 3) and bool(torch.isfinite(pix).all())
