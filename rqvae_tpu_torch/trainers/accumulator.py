"""Running means of the stage-2 metrics, and codebook-usage entropy.

Port of the stage-2 part of rqvae_tpu/trainers/accumulator.py (numpy on
the host): compute_entropy, Summary and AccmStage2. AccmStage1 comes with
the stage-1 trainer.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def compute_entropy(counts: np.ndarray, axis: int = -1) -> np.ndarray:
    """Entropy of normalized count histograms."""
    probs = counts / np.clip(counts.sum(axis=axis, keepdims=True), 1e-12, None)
    p = np.clip(probs, 1e-12, None)
    return -(probs * np.log(p)).sum(axis=axis)


class Summary(dict):
    def __getattr__(self, k):
        return self[k]

    @property
    def metrics(self):
        return {k: v for k, v in self.items() if k not in ("ent_codes_w_pad", "ent_codes_wo_pad", "xs")}

    def print_line(self) -> str:
        return ", ".join(f"{k}: {float(np.asarray(v)):.4f}" for k, v in self.metrics.items())


class AccmStage2:
    """Running means of the named scalar metrics (tensors, arrays or
    numbers), each update weighted by `count`."""

    def __init__(self, metric_names: Sequence[str]):
        self.metric_names = list(metric_names)
        self.init()

    def init(self):
        self.sums = {k: 0.0 for k in self.metric_names}
        self.counter = 0

    def update(self, metrics: dict, count: int = 1):
        for k in self.metric_names:
            if k in metrics and metrics[k] is not None:
                self.sums[k] += float(metrics[k]) * count
        self.counter += count

    def get_summary(self, n_inst: Optional[int] = None) -> Summary:
        n = n_inst if n_inst else max(self.counter, 1)
        return Summary({k: v / n for k, v in self.sums.items()})
