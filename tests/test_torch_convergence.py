"""The port's trainers learn: rqvae_tpu_torch/tools/train_convergence.py's
loops on the CPU at the tiny geometry of tests/test_convergence.py (32px,
8x8x2 codes over 64 shared codes, batch 8 of 16 images), with that test's
assertions. Stage 1 runs once (24 steps) and both stage-2 runs (48 steps
each, class- and caption-conditional) start from its model.

JAX's test asserts what 24 / 48 CPU steps reach (0.7x, where the full
on-card run asserts 0.5x / 0.3x): the reconstruction loss below 0.7x its
first value, every depth's code entropy above 1 bit, g_weight below 1e3,
everything finite; stage 2's loss below 0.7x; the text run's loss below
0.7x and its caption loss below 0.8x. The procedural images and captions
are bit-equal to the JAX tool's.
"""

import os
import sys

import numpy as np
import pytest
import torch

from rqvae_tpu_torch.tools import train_convergence as TC

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))

import train_convergence as JTC  # noqa: E402


@pytest.fixture(scope="module")
def stage1():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield TC.run_stage1(steps=24, res=32, bs=8, n_images=16, small=True, fetch_every=4, save_artifacts=False, seed=0,
                        device="cpu")
    torch.set_num_threads(n)


def test_dataset_and_captions_bit_equal_jax():
    for args in ((16, 32, 0), (3, 64, 5)):
        got, want = TC.make_dataset(*args), JTC.make_dataset(*args)
        assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)
    for args in ((16, 4, 16), (64, 8, 64)):
        got, want = TC.make_captions(*args), JTC.make_captions(*args)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    codes = np.random.RandomState(0).randint(0, 64, (8, 4, 4, 2))
    assert TC.code_entropy(codes) == JTC.code_entropy(codes)


def test_stage1_learns(stage1):
    _, _, s1, _ = stage1
    assert s1["finite"], s1
    assert s1["last_loss_recon"] < 0.7 * s1["first_loss_recon"], s1
    assert s1["max_g_weight"] < 1e3, s1
    assert min(s1["last_entropy"]) > 1.0, s1
    assert TC.stage1_ok(s1, 0.7)


def test_stage2_learns(stage1):
    state, model, _, data = stage1
    s2 = TC.run_stage2(state, model, data, steps=48, bs=8, small=True, fetch_every=8, save_artifacts=False, seed=10)
    assert np.isfinite(s2["last_loss"])
    assert s2["last_loss"] < 0.7 * s2["first_loss"], s2
    assert 0 <= s2["code_match_rate"] <= 1 and np.isfinite(s2["sampled_pixel_mse"]), s2
    assert np.isfinite(s2["rqvae_recon_mse_floor"]), s2


def test_stage2_text_conditional_learns(stage1):
    state, model, _, data = stage1
    st = TC.run_stage2_text(state, model, data, steps=48, bs=8, small=True, fetch_every=8, save_artifacts=False,
                            seed=20, cond_len=4, vocab_cond=16)
    assert np.isfinite(st["last_loss"]) and np.isfinite(st["last_loss_txt"])
    assert st["last_loss"] < 0.7 * st["first_loss"], st
    assert st["last_loss_txt"] < 0.8 * st["first_loss_txt"], st
    assert TC.text_ok(st, 0.7, 0.8)


def test_modes_and_pass_rules():
    """The JAX tool's modes: stage2 alone needs stage 1 (exit 2); the rules
    are strict inequalities on finite values."""
    with pytest.raises(ValueError, match="run 'both'"):
        TC.run("stage2", "cpu")
    with pytest.raises(SystemExit) as e:
        TC.main(["stage2", "--device", "cpu"])
    assert e.value.code == 2
    assert not TC.stage1_ok({"first_loss_recon": 1.0, "last_loss_recon": 0.5, "finite": True})
    assert not TC.stage1_ok({"first_loss_recon": 1.0, "last_loss_recon": 0.1, "finite": False})
    assert TC.stage2_ok({"first_loss": 1.0, "last_loss": 0.29}) and not TC.stage2_ok({"first_loss": 1.0,
                                                                                      "last_loss": float("nan")})
    assert not TC.text_ok({"first_loss": 1.0, "last_loss": 0.1, "first_loss_txt": 1.0, "last_loss_txt": 0.5})
