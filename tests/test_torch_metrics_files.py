"""The port's metric file pipeline against the JAX package's, on the CPU:
InceptionExtractor, compute_statistics_from_files, compute_fid,
compute_inception_score_from_files and compute_rfid on the same
samples*.pkl files (NCHW, as the sampling CLIs write them).

Both extractors read one pytorch-fid checkpoint written into tmp_path: the
port's FIDInceptionV3 state_dict of test_torch_metrics' seeded tree (BatchNorm
statistics randomised), which the port loads with strict=True and the JAX
package converts with convert_fid_inception. The JAX extractor runs with
batch_size 4 (its padding to 256 is the slow part on the CPU).

At 2048-d with a handful of samples the covariances are singular, so FIDs
of port and JAX statistics are not compared against each other (sqrtm of
a singular product amplifies rounding); the pipelines are held at acts, mu
and sigma, and the FID checked as a self-FID near 0. Tolerances: acts and
logits within 1e-4 (1 + |ref|) as the nets; mu within 1e-4, sigma within
1e-4 of its largest entry; IS to 1e-4 relative.
"""

import pickle
import shutil

import numpy as np
import pytest
import torch

from rqvae_tpu.metrics import fid as jfid
from rqvae_tpu.metrics import is_score as jis
from rqvae_tpu_torch.metrics import fid as tfid
from rqvae_tpu_torch.metrics import is_score as tis
from test_torch_metrics import NET_TOL, port_inception, seeded_inception_tree


@pytest.fixture(scope="module")
def extractors(tmp_path_factory):
    """(port extractor, JAX extractor, weights path), both on one checkpoint."""
    path = str(tmp_path_factory.mktemp("fid_weights") / "pt_inception.pth")
    torch.save(port_inception(seeded_inception_tree(1)).state_dict(), path)
    port = tfid.InceptionExtractor(weights_path=path, batch_size=4, device="cpu")
    assert port.pretrained
    return port, jfid.InceptionExtractor(weights_path=path, batch_size=4), path


@pytest.fixture(scope="module")
def samples_dir(tmp_path_factory):
    """Two samples*.pkl shards of 3 NCHW images, 64 x 64, in [0, 1]."""
    d = tmp_path_factory.mktemp("samples")
    rng = np.random.RandomState(0)
    for i in range(2):
        with open(d / f"samples_{i}.pkl", "wb") as f:
            pickle.dump(rng.rand(3, 3, 64, 64).astype(np.float32), f)
    return d


def assert_stats_close(got, want):
    (mu, sigma, acts), (jmu, jsigma, jacts) = got, want
    assert acts.shape == jacts.shape == (6, 2048)
    np.testing.assert_array_less(np.abs(acts - jacts), NET_TOL * (1 + np.abs(jacts)))
    np.testing.assert_allclose(mu, jmu, atol=NET_TOL, rtol=0)
    np.testing.assert_allclose(sigma, jsigma, atol=NET_TOL * np.abs(jsigma).max(), rtol=0)


def test_statistics_from_files_match_jax(extractors, samples_dir):
    port, jax_ex, _ = extractors
    got = tfid.compute_statistics_from_files(str(samples_dir), extractor=port, return_acts=True)
    want = jfid.compute_statistics_from_files(str(samples_dir), extractor=jax_ex, return_acts=True)
    assert_stats_close(got, want)
    # NHWC input, a tensor and a list of images give what the NCHW array gives
    imgs = tfid.load_samples_from_files(str(samples_dir))[:2]
    ref = port.activations(imgs)
    for other in (imgs.transpose(0, 2, 3, 1), torch.from_numpy(imgs), list(imgs)):
        np.testing.assert_array_equal(port.activations(other), ref)


def test_compute_fid_writes_acts_and_is_near_zero_on_itself(extractors, samples_dir, tmp_path):
    port, jax_ex, _ = extractors
    fake = tmp_path / "fake"
    shutil.copytree(samples_dir, fake)
    mu, sigma, acts = jfid.compute_statistics_from_files(str(fake), extractor=jax_ex, return_acts=True)
    got_mu, got_sigma, _ = tfid.compute_statistics_from_files(str(fake), extractor=port, return_acts=True)
    np.savez(tmp_path / "ref_stats.npz", mu=got_mu, sigma=got_sigma)
    d = tfid.compute_fid(str(fake), str(tmp_path / "ref_stats.npz"), extractor=port)
    written = np.load(fake / "acts.npz")
    assert_stats_close((written["mu"], written["sigma"], written["acts"]), (mu, sigma, acts))
    assert abs(d) < 1e-6 * np.trace(got_sigma) + 1e-6


def test_inception_score_from_files_matches_jax(extractors, samples_dir):
    port, jax_ex, _ = extractors
    for splits in (1, 3):
        got = tis.compute_inception_score_from_files(str(samples_dir), splits=splits, extractor=port)
        want = jis.compute_inception_score_from_files(str(samples_dir), splits=splits, extractor=jax_ex)
        assert got[0] > 1.0
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_compute_rfid_matches_jax(extractors, monkeypatch):
    """rFID of 6 NHWC images in [-1, 1] against a reconstruction 0.8 x, in
    batches of 4 (a ragged tail): the statistics each hands to
    frechet_distance (a spy here: test_torch_metrics holds the distance
    itself to JAX's) agree with JAX's, which pads the tail, and each returns
    what frechet_distance returns."""
    port, jax_ex, _ = extractors
    rng = np.random.RandomState(5)
    images = rng.uniform(-1, 1, (6, 64, 64, 3)).astype(np.float32)

    class Dataset:
        def __len__(self):
            return len(images)

        def __getitem__(self, i):
            return images[i], 0

    seen = {}

    def spy(name):
        def fd(*stats):
            seen[name] = stats
            return -1.0
        return fd

    monkeypatch.setattr(jfid, "frechet_distance", spy("jax"))
    monkeypatch.setattr(tfid, "frechet_distance", spy("port"))
    assert jfid.compute_rfid(Dataset(), recon_fn=lambda x: 0.8 * x, batch_size=4, extractor=jax_ex) == -1.0
    calls = []

    def recon(x):
        calls.append(tuple(x.shape))
        return 0.8 * x

    assert tfid.compute_rfid(Dataset(), recon_fn=recon, batch_size=4, extractor=port) == -1.0
    assert calls == [(4, 3, 64, 64), (2, 3, 64, 64)]
    for got, want in zip(seen["port"], seen["jax"]):
        if got.ndim == 1:
            np.testing.assert_allclose(got, want, atol=NET_TOL, rtol=0)
        else:
            np.testing.assert_allclose(got, want, atol=NET_TOL * np.abs(want).max(), rtol=0)


def test_loader_reads_the_env_weights_and_warns_without(extractors, monkeypatch, caplog):
    from rqvae_tpu_torch.metrics.inception import load_fid_inception

    _, _, path = extractors
    monkeypatch.setenv("RQVAE_TPU_FID_WEIGHTS", path)
    model, pretrained = load_fid_inception(device="cpu")
    assert pretrained and not model.training
    want = torch.load(path)
    assert all(torch.equal(v, want[k]) for k, v in model.state_dict().items())
    monkeypatch.delenv("RQVAE_TPU_FID_WEIGHTS")
    with caplog.at_level("WARNING"):
        a, pretrained = load_fid_inception(device="cpu")
    assert not pretrained and any("RANDOM weights" in r.message for r in caplog.records)
    b, _ = load_fid_inception(device="cpu")
    assert all(torch.equal(v, b.state_dict()[k]) for k, v in a.state_dict().items())  # seeded


def test_extractor_restores_the_tf32_flags(extractors):
    port, _, _ = extractors
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, True
        seen = []
        real_forward = port.model.forward

        def forward(x):
            seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
            return real_forward(x)

        port.model.forward = forward
        try:
            port.features(np.zeros((1, 3, 32, 32), np.float32))
        finally:
            del port.model.forward
        assert seen == [(False, False)]
        assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == (True, True)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
