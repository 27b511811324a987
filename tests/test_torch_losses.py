"""The port's stage-1 losses against the JAX package on the CPU: the GAN
losses, the PatchGAN discriminator (flax's BatchNorm statistics, ActNorm's
data-dependent init, the reference key layout) and LPIPS (fp32, bf16, the
torchvision / taming weight converters).

The discriminator is tests/test_trainers.py's NLayerDiscriminator(ndf=16,
n_layers=2) (and n_layers 3 with ActNorm) on 4 seeded 32x32 images, its
JAX init perturbed by seeded noise; LPIPS is JAX's init_lpips weights on 2
seeded 64x64 image pairs. Tolerances: discriminator logits and running
statistics 1e-5 (fp32 convs summed in other orders); LPIPS fp32 1e-5
relative; LPIPS bf16 within JAX's own bf16 error (|JAX bf16 - JAX fp32|)
plus one bf16 step (2^-8) of the fp32 value, not against JAX's bf16
output: the two frameworks round the bf16 tower at different points.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rqvae_tpu.losses import discriminator as JD
from rqvae_tpu.losses import gan as JG
from rqvae_tpu.losses import lpips as JL
from rqvae_tpu_torch.checkpoint import from_jax
from rqvae_tpu_torch.losses import discriminator as TD
from rqvae_tpu_torch.losses import gan as TG
from rqvae_tpu_torch.losses import lpips as TL
from test_torch_rqtransformer import to_torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _nchw(a) -> torch.Tensor:
    return _t(a).permute(0, 3, 1, 2).contiguous()


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("name", ["hinge", "vanilla"])
def test_gan_losses_match_jax(name):
    rng = np.random.RandomState(0)
    real, fake = (rng.standard_normal((4, 1, 6, 6)).astype(np.float32) * 2 for _ in range(2))
    got = TG.D_LOSSES[name](_t(real), _t(fake))
    want = JG.D_LOSSES[name](jnp.asarray(real), jnp.asarray(fake))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(float(TG.G_LOSSES["vanilla"](_t(fake))), float(JG.vanilla_g_loss(jnp.asarray(fake))),
                               rtol=1e-6)


# -- the discriminator ------------------------------------------------------------------------------------------


def _jax_disc(n_layers=2, use_actnorm=False, seed=0):
    disc = JD.NLayerDiscriminator(ndf=16, n_layers=n_layers, use_actnorm=use_actnorm)
    x0 = jnp.zeros((1, 32, 32, 3))
    variables = jax.device_get(disc.init(jax.random.PRNGKey(seed), x0, train=True))
    rng = np.random.RandomState(seed + 1)
    params = jax.tree.map(lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
                          variables["params"])
    stats = jax.tree.map(lambda a: (np.abs(a + 0.3 * rng.standard_normal(a.shape))).astype(np.float32),
                         variables.get("batch_stats", {}))
    return disc, params, stats


def _port_disc(params, stats, n_layers=2, use_actnorm=False):
    disc = TD.NLayerDiscriminator(ndf=16, n_layers=n_layers, use_actnorm=use_actnorm, device="cpu")
    disc.load_state_dict(to_torch(from_jax.discriminator_state_dict_from_jax(params, stats or None, n_layers)),
                         strict=True)
    return disc


def _images(n=4, seed=5):
    return np.random.RandomState(seed).uniform(-1.0, 1.0, size=(n, 32, 32, 3)).astype(np.float32)


def test_discriminator_key_layout():
    """main.{i}: conv 0; conv 3n - 1 and norm 3n for n = 1..n_layers; the
    output conv at 3 n_layers + 2; BatchNorm2d's buffer names."""
    disc = TD.NLayerDiscriminator(ndf=64, n_layers=3, device="meta")
    shapes = {k: tuple(v.shape) for k, v in disc.state_dict().items()}
    assert shapes["main.0.weight"] == (64, 3, 4, 4) and shapes["main.0.bias"] == (64,)
    for n, c in ((1, 128), (2, 256), (3, 512)):
        assert shapes[f"main.{3 * n - 1}.weight"][0] == c and f"main.{3 * n - 1}.bias" not in shapes
        for name in ("weight", "bias", "running_mean", "running_var"):
            assert shapes[f"main.{3 * n}.{name}"] == (c,)
        assert shapes[f"main.{3 * n}.num_batches_tracked"] == ()
    assert shapes["main.11.weight"] == (1, 512, 4, 4)
    actnorm = TD.NLayerDiscriminator(ndf=16, n_layers=3, use_actnorm=True, device="meta").state_dict()
    assert tuple(actnorm["main.3.loc"].shape) == (1, 32, 1, 1) and "main.3.initialized" in actnorm
    assert "main.2.bias" in actnorm


def test_discriminator_train_and_eval_match_jax():
    """Train mode (batch statistics) twice in a row, updating the running
    averages each time as the discriminator's step does (fake then real);
    the running averages after each; then eval mode on them."""
    jdisc, params, stats = _jax_disc()
    disc = _port_disc(params, stats)
    a, b = _images(seed=5), _images(seed=6)
    variables = {"params": params, "batch_stats": stats}
    for x in (a, b):
        want, mutated = jdisc.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
        variables = {"params": params, "batch_stats": jax.device_get(mutated["batch_stats"])}
        got = disc(_nchw(x), train=True, update_stats=True)
        assert got.shape == (4, 1, 6, 6)
        np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-5, rtol=1e-5)
        for n in (1, 2):
            bn = disc.main[3 * n]
            np.testing.assert_allclose(bn.running_mean.numpy(), variables["batch_stats"][f"norm_{n}"]["mean"],
                                       atol=1e-6, rtol=1e-5)
            np.testing.assert_allclose(bn.running_var.numpy(), variables["batch_stats"][f"norm_{n}"]["var"],
                                       atol=1e-6, rtol=1e-5)
    assert int(disc.main[3].num_batches_tracked) == 2
    want = jdisc.apply(variables, jnp.asarray(a), train=False)
    with torch.no_grad():
        got = disc(_nchw(a), train=False)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_discriminator_statistics_are_flax_not_torch():
    """The running variance moves towards the biased batch variance with
    momentum 0.9 (torch's BatchNorm2d would take the unbiased one with
    momentum 0.1 on the new value); update_stats=False leaves the averages
    and gradients flow through the batch statistics."""
    _, params, stats = _jax_disc()
    disc = _port_disc(params, stats)
    x = _nchw(_images())
    bn = disc.main[3]
    before = bn.running_var.clone(), bn.running_mean.clone()
    with torch.no_grad():
        h = disc.main[2](disc.main[1](disc.main[0](x)))
    disc(x, train=True, update_stats=False).sum().backward()
    assert torch.equal(bn.running_var, before[0]) and torch.equal(bn.running_mean, before[1])
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all()) for p in disc.parameters())
    with torch.no_grad():
        disc(x, train=True, update_stats=True)
    biased = h.var(dim=(0, 2, 3), unbiased=False)
    np.testing.assert_allclose(bn.running_var.numpy(), (0.9 * before[0] + 0.1 * biased).numpy(), rtol=1e-5, atol=1e-6)
    unbiased = h.var(dim=(0, 2, 3), unbiased=True)
    assert not np.allclose(bn.running_var.numpy(), (0.9 * before[0] + 0.1 * unbiased).numpy(), rtol=1e-5, atol=1e-6)


def test_actnorm_init_and_forward_match_jax():
    """initialize_actnorm on a batch (each norm sees the ones before it
    initialised) against JAX's, then the forward."""
    jdisc, params, _ = _jax_disc(n_layers=3, use_actnorm=True, seed=3)
    x = _images(seed=7)
    want_vars = JD.initialize_actnorm(jdisc, {"params": params}, jnp.asarray(x))
    disc = _port_disc(params, None, n_layers=3, use_actnorm=True)
    TD.initialize_actnorm(disc, _nchw(x))
    got_sd = disc.state_dict()
    want_sd = from_jax.discriminator_state_dict_from_jax(jax.device_get(want_vars["params"]), None, 3)
    for n in (1, 2, 3):
        for name in ("loc", "scale"):
            key = f"main.{3 * n}.{name}"
            np.testing.assert_allclose(got_sd[key].numpy(), want_sd[key], rtol=1e-4, atol=1e-5, err_msg=key)
        assert int(got_sd[f"main.{3 * n}.initialized"]) == 1
    want = jdisc.apply(want_vars, jnp.asarray(x), train=True)
    with torch.no_grad():
        got = disc(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-4, rtol=1e-4)
    with pytest.raises(ValueError, match="use_actnorm"):
        TD.initialize_actnorm(TD.NLayerDiscriminator(ndf=16, n_layers=2, device="cpu"), _nchw(x))


def test_discriminator_init_weights_follow_the_generator():
    disc = TD.NLayerDiscriminator(ndf=16, n_layers=2, device="cpu")
    disc.init_weights(torch.Generator().manual_seed(1))
    w = disc.main[0].weight
    assert abs(float(w.detach().std()) - 0.02) < 0.004 and float(disc.main[0].bias.abs().max()) == 0.0
    assert abs(float(disc.main[3].weight.mean()) - 1.0) < 0.01
    other = TD.NLayerDiscriminator(ndf=16, n_layers=2, device="cpu")
    other.init_weights(torch.Generator().manual_seed(1))
    assert all(torch.equal(a, b) for a, b in zip(disc.state_dict().values(), other.state_dict().values()))


# -- LPIPS ------------------------------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lpips_pair():
    """(JAX LPIPS variables of init_lpips, the port's LPIPS on their
    weights, two seeded [2, 64, 64, 3] image batches in [-1, 1])."""
    variables = jax.device_get(JL.init_lpips(jax.random.PRNGKey(2)))
    lpips = TL.LPIPS(device="cpu")
    lpips.load_state_dict(to_torch(from_jax.lpips_state_dict_from_jax(variables["params"])), strict=True)
    rng = np.random.RandomState(8)
    x = rng.uniform(-1.0, 1.0, size=(2, 64, 64, 3)).astype(np.float32)
    y = np.clip(x + 0.3 * rng.standard_normal(x.shape), -1.0, 1.0).astype(np.float32)
    return variables, lpips, x, y


def test_lpips_fp32_matches_jax(lpips_pair):
    variables, lpips, x, y = lpips_pair
    want = JL.LPIPS().apply(variables, jnp.asarray(x), jnp.asarray(y), reduction="none")
    got = lpips(_nchw(x), _nchw(y), reduction="none")
    assert got.shape == (2, 1, 1, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy()[:, :, 0, 0], np.asarray(want)[:, 0, 0, :], rtol=1e-5, atol=0)
    np.testing.assert_allclose(float(lpips(_nchw(x), _nchw(y))), float(np.mean(want)), rtol=1e-5)
    assert float(lpips(_nchw(x), _nchw(x))) == 0.0
    assert not any(p.requires_grad for p in lpips.parameters())


def test_lpips_bf16_within_jax_bf16_error(lpips_pair):
    """The bf16 tower's loss against JAX's fp32 one, within JAX's own bf16
    error plus 2^-8 of the value; fp32 out; the weights stay fp32 and the
    gradient to the input is finite."""
    variables, lpips, x, y = lpips_pair
    ref = float(JL.LPIPS().apply(variables, jnp.asarray(x), jnp.asarray(y)))
    jax_err = abs(float(JL.LPIPS(dtype=jnp.bfloat16).apply(variables, jnp.asarray(x), jnp.asarray(y))) - ref)
    target = _nchw(y).requires_grad_(True)
    got = lpips(_nchw(x), target, dtype=torch.bfloat16)
    assert got.dtype == torch.float32 and lpips.net.features[0].weight.dtype == torch.float32
    assert abs(float(got) - ref) <= jax_err + 2.0**-8 * abs(ref), (float(got), ref, jax_err)
    got.backward()
    assert bool(torch.isfinite(target.grad).all()) and float(target.grad.abs().max()) > 0


def test_convert_lpips_matches_jax(lpips_pair, tmp_path):
    """torchvision / taming state_dicts (made from JAX's tree) through
    convert_lpips equal the JAX tree JAX's convert_lpips makes from them;
    load_lpips_params reads them from files and says pretrained."""
    variables, lpips, x, y = lpips_pair
    sd = lpips.state_dict()
    vgg_sd = {k.replace("net.", ""): v.clone() for k, v in sd.items() if k.startswith("net.")}
    lin_sd = {k: v.clone() for k, v in sd.items() if k.startswith("lin")}
    assert len(vgg_sd) == 26 and len(lin_sd) == 5
    want = JL.convert_lpips(JL.init_lpips(jax.random.PRNGKey(9)), vgg_sd, lin_sd)
    got = TL.convert_lpips(vgg_sd, lin_sd)
    ref = from_jax.lpips_state_dict_from_jax(jax.device_get(want["params"]))
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), ref[k], err_msg=k)
    assert sorted(TL.convert_lpips(vgg_sd)) == sorted(k for k in ref if k.startswith("net."))
    torch.save(vgg_sd, tmp_path / "vgg16.pth")
    torch.save(lin_sd, tmp_path / "vgg_lpips.pth")
    loaded, pretrained = TL.load_lpips_params(str(tmp_path / "vgg16.pth"), str(tmp_path / "vgg_lpips.pth"),
                                              device="cpu")
    assert pretrained and all(torch.equal(loaded.state_dict()[k], v) for k, v in sd.items())
    synthetic, pretrained = TL.load_lpips_params(str(tmp_path / "absent.pth"), device="cpu")
    assert not pretrained and not torch.equal(synthetic.lin0.model[1].weight, sd["lin0.model.1.weight"])
    np.testing.assert_allclose(float(loaded(_nchw(x), _nchw(y))), float(lpips(_nchw(x), _nchw(y))), rtol=0)
