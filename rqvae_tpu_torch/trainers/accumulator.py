"""Running sums of the training metrics, and codebook-usage entropy.

Port of rqvae_tpu/trainers/accumulator.py (numpy on the host):
compute_entropy, Summary, AccmStage1 (metric sums and per-depth code
histograms) and AccmStage2.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

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


class AccmStage1:
    """Sums of the named metrics (each update adds the metric as given, not
    weighted by `count`) and, per hierarchy level, a [n_codebook,
    codebook_size (+ 1 with use_padding_idx)] histogram of the codes."""

    def __init__(self, metric_names: Sequence[str], n_codebook: int = 1, codebook_size=512, code_hier: int = 1,
                 use_padding_idx: bool = False):
        self.metric_names = list(metric_names)
        self.n_codebook = n_codebook
        self.max_codebook_size = max(codebook_size) if isinstance(codebook_size, Iterable) else codebook_size
        self.use_padding_idx = use_padding_idx
        if use_padding_idx:
            self.max_codebook_size += 1
        self.code_hier = code_hier
        self.init()

    def init(self):
        self.sums = {k: 0.0 for k in self.metric_names}
        self.codebooks = [np.zeros((self.n_codebook, self.max_codebook_size), np.int64)
                          for _ in range(self.code_hier)]
        self.counter = 0

    def update(self, codes, metrics: dict, count: int = 1):
        """codes: one [B, h, w, n_codebook] array or tensor per level."""
        for k in self.metric_names:
            if k in metrics and metrics[k] is not None:
                self.sums[k] += float(metrics[k])
        for level, code in enumerate(codes or []):
            flat = np.asarray(code.cpu() if hasattr(code, "cpu") else code)
            flat = flat.reshape(-1, flat.shape[-1])
            for b in range(self.n_codebook):
                self.codebooks[level][b] += np.bincount(flat[:, b], minlength=self.max_codebook_size)
        self.counter += count

    def get_summary(self, n_inst: Optional[int] = None) -> Summary:
        n = n_inst if n_inst else max(self.counter, 1)
        out = Summary({k: v / n for k, v in self.sums.items()})
        entropy = [compute_entropy(cb.astype(np.float64)) for cb in self.codebooks]
        if self.use_padding_idx:
            out["ent_codes_w_pad"] = entropy
            out["ent_codes_wo_pad"] = [compute_entropy(cb[:, :-1].astype(np.float64)) for cb in self.codebooks]
        else:
            out["ent_codes_w_pad"] = None
            out["ent_codes_wo_pad"] = entropy
        return out


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
