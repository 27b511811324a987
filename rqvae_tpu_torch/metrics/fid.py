"""FID and rFID: Inception activations, Gaussian statistics, Frechet distance.

Port of rqvae_tpu/metrics/fid.py with its file formats: `samples*.pkl`
sample stores (NCHW float in [0, 1]), `acts.npz` (acts, mu, sigma) written
beside them, and reference statistics npz files with mu and sigma.
`frechet_distance` and `mean_covar` are the same float64 numpy / scipy
code. `InceptionExtractor` runs FIDInceptionV3 on its device in batches
(no padding to a compile shape), with TF32 off around each forward, so that
its convolutions and the fc compute in fp32 as the JAX package's do.
"""

from __future__ import annotations

import contextlib
import glob
import logging
import os
import pickle
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch
from scipy import linalg

from rqvae_tpu_torch.metrics.inception import load_fid_inception


def frechet_distance(mu1, sigma1, mu2, sigma2, eps=1e-6):
    """||mu1-mu2||^2 + Tr(s1 + s2 - 2 sqrt(s1 s2)) (the reference's fid.py:61-115)."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2

    covmean = linalg.sqrtm(sigma1.dot(sigma2))  # the JAX code's disp=False only adds an error estimate
    if not np.isfinite(covmean).all():
        logging.warning("fid: singular product; adding %s to diagonal", eps)
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            m = np.max(np.abs(covmean.imag))
            raise ValueError(f"Imaginary component {m}")
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def mean_covar(acts: np.ndarray):
    acts = np.asarray(acts, np.float64)
    mu = acts.mean(axis=0)
    sigma = np.cov(acts, rowvar=False)
    return mu, sigma


@contextlib.contextmanager
def tf32_off():
    """cuDNN convolutions and fp32 matmuls without TF32 inside the block;
    the flags as they were afterwards."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def to_nchw(x) -> torch.Tensor:
    """An image batch as a float32 NCHW tensor: [B, 3, H, W] stays, NHWC is
    transposed (the JAX extractor's rule: NCHW when dim 1 is 3 and the last is not)."""
    x = torch.as_tensor(np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) else x).float()
    if x.dim() == 4 and not (x.shape[1] == 3 and x.shape[-1] != 3):
        x = x.permute(0, 3, 1, 2)
    return x


class InceptionExtractor:
    """Batched pool / logit extraction on `device` (CUDA when None). Inputs
    are images in [0, 1], NCHW or NHWC: a numpy array or tensor (on any
    device), or a sequence of images."""

    def __init__(self, weights_path: Optional[str] = None, batch_size: int = 256, device=None):
        self.model, self.pretrained = load_fid_inception(weights_path, device=device)
        self.device = self.model.fc.weight.device
        self.batch_size = batch_size

    @torch.no_grad()
    def features(self, x) -> tuple[torch.Tensor, torch.Tensor]:
        """(pool [B, 2048], logits [B, 1008]) of one batch, on the device."""
        with tf32_off():
            return self.model(to_nchw(x).to(self.device))

    def _run(self, batches, want: str) -> np.ndarray:
        outs = []
        for xs in batches:
            pool, logits = self.features(xs)
            outs.append((pool if want == "pool" else logits).cpu().numpy())
        return np.concatenate(outs, axis=0)

    def _batched(self, array_like):
        n = len(array_like)
        for i in range(0, n, self.batch_size):
            if isinstance(array_like, (np.ndarray, torch.Tensor)):
                yield array_like[i : i + self.batch_size]
            else:
                yield np.stack([np.asarray(array_like[j]) for j in range(i, min(i + self.batch_size, n))])

    def activations(self, images) -> np.ndarray:
        """images: an iterable or array of [0, 1] images -> [N, 2048]."""
        return self._run(self._batched(images), "pool")

    def logits(self, images) -> np.ndarray:
        return self._run(self._batched(images), "logits")

    def activations_batches(self, batch_iter) -> np.ndarray:
        return self._run(batch_iter, "pool")


# ---------------------------------------------------------------------------
# the file pipeline (the reference's formats)
# ---------------------------------------------------------------------------


def load_samples_from_files(path: str) -> np.ndarray:
    pkl_lists = sorted(glob.glob(os.path.join(path, "samples*.pkl")))
    if not pkl_lists:
        raise FileNotFoundError(f"no samples*.pkl under {path}")
    logging.info(
        "loading generated images from %s: [%s, ..., %s]",
        path, os.path.basename(pkl_lists[0]), os.path.basename(pkl_lists[-1]),
    )
    samples = []
    for pkl in pkl_lists:
        with open(pkl, "rb") as f:
            samples.append(np.asarray(pickle.load(f)))
    return np.concatenate(samples, axis=0)


def compute_statistics_from_files(
    path: str,
    batch_size: int = 256,
    extractor: Optional[InceptionExtractor] = None,
    return_acts: bool = False,
):
    extractor = extractor or InceptionExtractor(batch_size=batch_size)
    acts = extractor.activations(load_samples_from_files(path))
    mu, sigma = mean_covar(acts)
    if return_acts:
        return mu, sigma, acts
    return mu, sigma


def compute_fid(fake_path: str, ref_stat_path: str, batch_size: int = 256,
                extractor: Optional[InceptionExtractor] = None) -> float:
    """FID of the samples*.pkl under fake_path against precomputed dataset
    statistics (npz with mu, sigma); caches acts.npz beside the samples."""
    act_path = Path(fake_path) / "acts.npz"
    if not act_path.exists():
        mu, sigma, acts = compute_statistics_from_files(
            fake_path, batch_size=batch_size, extractor=extractor, return_acts=True
        )
        np.savez(act_path, acts=acts, mu=mu, sigma=sigma)
        logging.info("activations saved to %s", act_path.as_posix())
    acts_fake = np.load(act_path)
    stats_ref = np.load(ref_stat_path)
    return frechet_distance(stats_ref["mu"], stats_ref["sigma"], acts_fake["mu"], acts_fake["sigma"])


def compute_rfid(
    dataset,
    recon_fn: Callable,  # [B, 3, H, W] in [-1, 1] on the device -> the reconstruction in [-1, 1]
    batch_size: int = 64,
    extractor: Optional[InceptionExtractor] = None,
) -> float:
    """FID of a dataset's images (dataset[i][0], [-1, 1], NCHW or NHWC)
    against their reconstructions, whole batches at a time through
    recon_fn on the extractor's device."""
    extractor = extractor or InceptionExtractor()
    n = len(dataset)
    if n == 0:
        raise ValueError("empty dataset")
    acts_orig, acts_recon = [], []
    with torch.no_grad():
        for i in range(0, n, batch_size):
            items = [dataset[j][0] for j in range(i, min(i + batch_size, n))]
            stack = torch.stack if isinstance(items[0], torch.Tensor) else np.stack
            xs = to_nchw(stack(items)).to(extractor.device)
            recon = recon_fn(xs).float()
            acts_orig.append(extractor.features((xs * 0.5 + 0.5).clamp(0, 1))[0].cpu().numpy())
            acts_recon.append(extractor.features((recon * 0.5 + 0.5).clamp(0, 1))[0].cpu().numpy())
    mu_o, s_o = mean_covar(np.concatenate(acts_orig))
    mu_r, s_r = mean_covar(np.concatenate(acts_recon))
    return frechet_distance(mu_o, s_o, mu_r, s_r)
