"""The port's FID Inception net and metric math against the JAX package, in
fp32 on the CPU: FIDInceptionV3 (pool features and logits) at 64, 256 and
512 pixels, the resize to 299 against jax.image.resize in both directions,
the FID pooling patches, frechet_distance, mean_covar and calculate_kl_div.

Both nets hold one seeded tree in the JAX layout (He-scaled conv kernels,
BatchNorm scale, bias and running statistics randomised, so BatchNorm does
real work), carried into the port by from_jax.inception_state_dict_from_jax
and loaded with strict=True. The tree's shapes come from jax.eval_shape, so
no flax init runs. Tolerances: the nets' outputs within 1e-4 (1 + |ref|)
(fp32 sums of ~100 conv layers in other orders); the resize within 5e-6
on [0, 1] pixels; the numpy metric code to 1e-10 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rqvae_tpu.metrics import fid as jfid
from rqvae_tpu.metrics import inception as jinc
from rqvae_tpu.metrics import is_score as jis
from rqvae_tpu_torch.checkpoint.from_jax import inception_state_dict_from_jax
from rqvae_tpu_torch.metrics import fid as tfid
from rqvae_tpu_torch.metrics import inception as tinc
from rqvae_tpu_torch.metrics import is_score as tis

NET_TOL = 1e-4
RESIZE_TOL = 5e-6  # the antialiased weights of a shrink are fp32 sums in another order (2.3e-6 seen)


def seeded_inception_tree(seed: int = 0) -> dict:
    """A FIDInceptionV3 param tree (numpy) in the JAX layout: conv kernels
    N(0, 2 / fan_in), BatchNorm scale U(0.8, 1.2), bias U(-0.1, 0.1), mean
    U(-0.2, 0.2), var U(0.7, 1.4), fc N(0, 1 / 2048), fc bias U(-0.1, 0.1)."""
    shapes = jax.eval_shape(jinc.FIDInceptionV3().init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))["params"]
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel" and len(shape) == 4:
            return (rng.standard_normal(shape) * np.sqrt(2.0 / np.prod(shape[:3]))).astype(np.float32)
        if name == "kernel":
            return (rng.standard_normal(shape) / np.sqrt(shape[0])).astype(np.float32)
        lo, hi = {"bn_scale": (0.8, 1.2), "bn_bias": (-0.1, 0.1), "bn_mean": (-0.2, 0.2), "bn_var": (0.7, 1.4),
                  "bias": (-0.1, 0.1)}[name]
        return rng.uniform(lo, hi, shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def port_inception(tree: dict) -> tinc.FIDInceptionV3:
    model = tinc.FIDInceptionV3(device="cpu")
    sd = {k: torch.from_numpy(np.array(v, copy=True)) for k, v in inception_state_dict_from_jax(tree).items()}
    model.load_state_dict(sd, strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def nets():
    tree = seeded_inception_tree()
    return jinc.FIDInceptionV3(), {"params": tree}, port_inception(tree)


@pytest.mark.parametrize("size", [64, 256, 512])
def test_inception_matches_jax(nets, size):
    jmodel, variables, model = nets
    imgs = np.random.RandomState(size).rand(2, size, size, 3).astype(np.float32)
    want_pool, want_logits = jax.jit(jmodel.apply)(variables, jnp.asarray(imgs))
    with torch.no_grad():
        pool, logits = model(torch.from_numpy(imgs).permute(0, 3, 1, 2))
    for got, want in ((pool, want_pool), (logits, want_logits)):
        want = np.asarray(want)
        assert got.shape == want.shape
        assert float(np.abs(want).mean()) > 0.05  # BatchNorm and the convs keep a scale that tests something
        np.testing.assert_array_less(np.abs(got.numpy() - want), NET_TOL * (1 + np.abs(want)))


def test_batchnorm_uses_running_statistics_in_train_mode(nets):
    """A block in train mode computes what it does in eval mode (inference
    BatchNorm), on Mixed_5b's input shape."""
    _, _, model = nets
    block = model.Mixed_5b
    x = torch.from_numpy(np.random.RandomState(3).standard_normal((2, 192, 9, 9)).astype(np.float32))
    with torch.no_grad():
        want = block(x)
        block.train()
        try:
            got = block(x)
        finally:
            block.eval()
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert float((want - torch.relu(want)).abs().max()) == 0 and float(want.std()) > 0.05


@pytest.mark.parametrize("shape", [(64, 64), (256, 256), (512, 512), (48, 600), (299, 299)],
                         ids=["up64", "up256", "down512", "mixed", "same"])
def test_resize_matches_jax_image_resize(shape):
    h, w = shape
    x = np.random.RandomState(h + w).rand(2, h, w, 3).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 299, 299, 3), method="bilinear"))
    got = tinc.resize_input(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=RESIZE_TOL, rtol=0)


def test_upsampling_is_plain_bilinear():
    """Upsampling: the resize is F.interpolate(bilinear, align_corners=False)."""
    x = torch.rand(1, 3, 64, 80, generator=torch.Generator().manual_seed(1))
    plain = torch.nn.functional.interpolate(x, size=(299, 299), mode="bilinear", align_corners=False)
    torch.testing.assert_close(tinc.resize_input(x), plain, rtol=0, atol=1e-6)


def test_fid_pooling_patches_match_jax():
    x = np.random.RandomState(4).standard_normal((2, 9, 7, 5)).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    want_avg = np.asarray(jinc.avg_pool_nopad_count(jnp.asarray(x)))
    want_max = np.asarray(jinc.max_pool_3_1(jnp.asarray(x)))
    np.testing.assert_allclose(tinc.avg_pool_nopad_count(xt).permute(0, 2, 3, 1).numpy(), want_avg, atol=1e-6)
    np.testing.assert_array_equal(tinc.max_pool_3_1(xt).permute(0, 2, 3, 1).numpy(), want_max)
    # the corner averages 4 values, not 9
    np.testing.assert_allclose(want_avg[:, 0, 0], x[:, :2, :2].mean(axis=(1, 2)), atol=1e-6)


def test_frechet_distance_and_mean_covar_match_jax():
    rng = np.random.RandomState(0)
    a = rng.standard_normal((500, 64)) @ rng.standard_normal((64, 64)) * 0.3
    b = rng.standard_normal((400, 64)) * 1.1 + 0.2
    for acts in (a, b):
        for got, want in zip(tfid.mean_covar(acts), jfid.mean_covar(acts)):
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    (mu1, s1), (mu2, s2) = tfid.mean_covar(a), tfid.mean_covar(b)
    got, want = tfid.frechet_distance(mu1, s1, mu2, s2), jfid.frechet_distance(mu1, s1, mu2, s2)
    assert got > 1.0
    np.testing.assert_allclose(got, want, rtol=1e-10)
    assert abs(tfid.frechet_distance(mu1, s1, mu1, s1)) < 1e-8 * np.trace(s1)


def test_frechet_distance_eps_path_matches_jax(monkeypatch, caplog):
    """Where sqrtm of the product has no finite root (the first call made to
    return none here), both add eps to the diagonal and take the root again.
    The port calls sqrtm without the JAX code's deprecated disp=False (which
    returned an error estimate beside the root)."""
    from scipy import linalg

    real_sqrtm = linalg.sqrtm
    calls = []

    def sqrtm(m, disp=True):
        calls.append(disp)
        root = real_sqrtm(m) if len(calls) > 1 else np.full_like(m, np.inf)
        return (root, 0.0) if disp is False else root

    monkeypatch.setattr(linalg, "sqrtm", sqrtm)
    rng = np.random.RandomState(1)
    (mu1, s1), (mu2, s2) = (tfid.mean_covar(rng.standard_normal((5, 8)) + k) for k in (0.0, 0.3))  # rank 4 of 8
    want = jfid.frechet_distance(mu1, s1, mu2, s2)
    assert calls == [False, True]
    calls.clear()
    with caplog.at_level("WARNING"):
        got = tfid.frechet_distance(mu1, s1, mu2, s2)
    assert calls == [True, True]
    assert np.isfinite(got) and got > 0
    np.testing.assert_allclose(got, want, rtol=1e-10)
    assert any("singular product" in r.message for r in caplog.records)


@pytest.mark.parametrize("splits", [1, 3, 10, 40])
def test_calculate_kl_div_matches_jax(splits):
    logits = np.random.RandomState(splits).standard_normal((30, 1008)) * 3
    ps = np.exp(logits - logits.max(-1, keepdims=True))
    ps /= ps.sum(-1, keepdims=True)
    got, want = tis.calculate_kl_div(ps, splits), jis.calculate_kl_div(ps, splits)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert got[0] >= 1.0  # one sample a split (splits > n) scores exactly 1
