"""Inception Score: softmax over the Inception logits, exp(mean KL) over
`splits` chunks. Port of rqvae_tpu/metrics/is_score.py (numpy, float64
where the JAX code is)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from rqvae_tpu_torch.metrics.fid import InceptionExtractor, load_samples_from_files


def calculate_kl_div(ps: np.ndarray, splits: int):
    scores = []
    n = ps.shape[0]
    splits = max(1, min(splits, n))  # no empty split on a small sample set
    for j in range(splits):
        part = ps[(j * n // splits) : ((j + 1) * n // splits)]
        kl = part * (np.log(part) - np.log(part.mean(axis=0, keepdims=True)))
        scores.append(np.exp(np.sum(kl, axis=1).mean()))
    scores = np.asarray(scores)
    std = float(scores.std(ddof=1)) if len(scores) > 1 else 0.0
    return float(scores.mean()), std


def compute_inception_score_from_files(
    path: str,
    splits: int = 10,
    batch_size: int = 256,
    extractor: Optional[InceptionExtractor] = None,
):
    extractor = extractor or InceptionExtractor(batch_size=batch_size)
    logits = extractor.logits(load_samples_from_files(path))
    logits = logits - logits.max(axis=-1, keepdims=True)
    ps = np.exp(logits)
    ps = ps / ps.sum(axis=-1, keepdims=True)
    return calculate_kl_div(ps, splits)
