"""The port's evaluation CLIs against the JAX package's, on the CPU.

`python -m rqvae_tpu_torch.cli.main_sampling_fid` on the committed synthetic
checkpoints (config rewritten to this checkout), --top-k 1 (the one draw
that is determined, so the port's torch.Generator and JAX's PRNG key give
the same codes), 2 batches of 2, fp32 on the CPU, with --stats from seeded
activations; against JAX's cli/main_sampling_fid.py --no-metrics run as a
subprocess on the same checkpoint (RQVAE_TPU_CPU=1): samples_{i}.pkl
within 1e-5, targets_{i}.npz and seeds.txt equal; the port's acts.npz and
IS against JAX's metric functions run on JAX's samples (one FID
checkpoint, RQVAE_TPU_FID_WEIGHTS, for both: tolerances of
test_torch_metrics_files), its FID finite. Then compute_metrics prints FID
and IS, and its CLIP branch asks for the CLIP weights (their scoring of
cc3m samples: tests/test_torch_entry_cli.py).
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from rqvae_tpu.metrics import fid as jfid
from rqvae_tpu.metrics import is_score as jis
from rqvae_tpu_torch.cli import compute_metrics, main_sampling_fid
from test_torch_config import synth_stage2
from test_torch_metrics import NET_TOL, port_inception, seeded_inception_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both CLIs on one checkpoint: (port results, port out dir, JAX out
    dir, stats path, FID weights path)."""
    tmp = tmp_path_factory.mktemp("eval_cli")
    ckpt = synth_stage2(tmp)
    weights = str(tmp / "pt_inception.pth")
    torch.save(port_inception(seeded_inception_tree(2)).state_dict(), weights)
    rng = np.random.RandomState(3)
    mu, sigma = jfid.mean_covar(rng.standard_normal((2500, 2048)) * 0.2 + 0.3)
    stats = str(tmp / "fid_stats.npz")
    np.savez(stats, mu=mu, sigma=sigma)

    jax_out, port_out = str(tmp / "jax"), str(tmp / "port")
    args = ["-m", ckpt, "--top-k", "1", "-bs", "2", "-n", "4", "--seed", "0"]
    env = dict(os.environ, RQVAE_TPU_CPU="1", JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "cli/main_sampling_fid.py", *args, "--no-metrics", "-o", jax_out],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]

    saved = os.environ.get("RQVAE_TPU_FID_WEIGHTS")
    os.environ["RQVAE_TPU_FID_WEIGHTS"] = weights
    try:
        results = main_sampling_fid.main(args + ["--stats", stats, "-o", port_out, "--device", "cpu",
                                                 "--dtype", "float32"])
    finally:
        if saved is None:
            del os.environ["RQVAE_TPU_FID_WEIGHTS"]
        else:
            os.environ["RQVAE_TPU_FID_WEIGHTS"] = saved
    return results, port_out, jax_out, stats, weights


def test_samples_targets_and_seeds_equal_jax_cli(run):
    _, port_out, jax_out, _, _ = run
    assert sorted(os.listdir(port_out)) == ["acts.npz", "samples_0.pkl", "samples_1.pkl", "seeds.txt",
                                            "targets_0.npz", "targets_1.npz"]
    for i in range(2):
        with open(os.path.join(port_out, f"samples_{i}.pkl"), "rb") as f:
            got = pickle.load(f)
        with open(os.path.join(jax_out, f"samples_{i}.pkl"), "rb") as f:
            want = pickle.load(f)
        assert got.shape == want.shape == (2, 3, 64, 64) and got.dtype == want.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        t_got = np.load(os.path.join(port_out, f"targets_{i}.npz"))["targets"]
        t_want = np.load(os.path.join(jax_out, f"targets_{i}.npz"))["targets"]
        assert t_got.dtype == t_want.dtype
        np.testing.assert_array_equal(t_got, t_want)
    for name in ("seeds.txt",):
        with open(os.path.join(port_out, name)) as a, open(os.path.join(jax_out, name)) as b:
            assert a.read() == b.read()


def test_acts_is_and_fid_equal_jax_metrics_on_jax_samples(run):
    results, port_out, jax_out, stats, weights = run
    extractor = jfid.InceptionExtractor(weights_path=weights, batch_size=4)
    mu, sigma, acts = jfid.compute_statistics_from_files(jax_out, extractor=extractor, return_acts=True)
    got = np.load(os.path.join(port_out, "acts.npz"))
    np.testing.assert_array_less(np.abs(got["acts"] - acts), NET_TOL * (1 + np.abs(acts)))
    np.testing.assert_allclose(got["mu"], mu, atol=NET_TOL, rtol=0)
    np.testing.assert_allclose(got["sigma"], sigma, atol=NET_TOL * np.abs(sigma).max(), rtol=0)
    want_is = jis.compute_inception_score_from_files(jax_out, extractor=extractor)
    assert results["IS"][0] >= 1.0
    np.testing.assert_allclose(results["IS"], want_is, rtol=1e-4, atol=1e-6)
    # the FID of the port's statistics (held to JAX's above) against the
    # stats file; the distance itself is held to JAX's in test_torch_metrics
    ref = np.load(stats)
    assert np.isfinite(results["FID"]) and results["FID"] > 0.5 * np.trace(ref["sigma"])


def test_compute_metrics_prints_fid_and_is(run, capsys, monkeypatch):
    """compute_metrics hands frechet_distance the stats file's and acts.npz's
    mu and sigma (a spy: one 2048-d sqrtm is the CLI test's) and prints FID,
    IS and its std."""
    results, port_out, _, stats, weights = run
    monkeypatch.setenv("RQVAE_TPU_FID_WEIGHTS", weights)
    from rqvae_tpu_torch.metrics import fid as tfid

    seen = []
    monkeypatch.setattr(tfid, "frechet_distance", lambda *a: seen.append(a) or 12.5)
    got = compute_metrics.main([f"fake_path={port_out}", f"ref_stat_path={stats}", "dataset=imagenet",
                                "device=cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines == [f"FID: {12.5:.4f}", f"IS: {got['IS']:.4f}", f"IS_std: {got['IS_std']:.4f}"]
    ref, acts = np.load(stats), np.load(os.path.join(port_out, "acts.npz"))  # the sampling CLI's
    for a, b in zip(seen[0], (ref["mu"], ref["sigma"], acts["mu"], acts["sigma"])):
        np.testing.assert_array_equal(a, b)
    assert (got["IS"], got["IS_std"]) == pytest.approx(results["IS"], rel=1e-6)
    monkeypatch.delenv("RQVAE_TPU_CLIP_DIR", raising=False)
    with pytest.raises(FileNotFoundError, match="RQVAE_TPU_CLIP_DIR"):  # the CLIP weights are not in the repository
        compute_metrics.main([f"fake_path={port_out}", "dataset=cc3m", "device=cpu"])


def test_cli_arguments_and_label_layout():
    args = main_sampling_fid.parse_args(["-m", "x.pt"])
    assert (args.n_samples, args.batch_size, args.top_k, args.top_p, args.dtype, args.device, args.no_kernels) == (
        50000, 100, 0, 0.0, "bfloat16", None, False)
    # the JAX CLI's layout: each label repeated n // n_labels times, cut or cycled
    np.testing.assert_array_equal(main_sampling_fid.label_layout(10, 4, 2, 2), [0, 1, 2, 3])
    np.testing.assert_array_equal(main_sampling_fid.label_layout(2, 8, 4, 2), [0, 0, 0, 0, 1, 1, 1, 1])
    np.testing.assert_array_equal(main_sampling_fid.label_layout(3, 4, 2, 2), [0, 1, 2, 0])
    with pytest.raises(ValueError, match="multiple"):
        main_sampling_fid.main(["-m", "x.pt", "-n", "5", "-bs", "2", "--device", "cpu"])
