"""Data loader: a torch DataLoader over one process's shard of each epoch.

Port of rqvae_tpu/data/loader.py in PyTorch's idiom. `shard_indices` is
the JAX function (the reference's DistributedSampler semantics: a
permutation seeded by (seed, epoch), padded by wrap-around to a multiple
of process_count, strided by rank), so a process reads the same items in
the same order as the JAX loader's. `DataLoader` wraps
torch.utils.data.DataLoader over a sampler that yields that order, with
worker processes decoding and transforming the items (num_workers=0 runs
them in the caller), and hands each batch to `device`: pinned, then
copied non_blocking when the device is CUDA. Batches are
{"images": [B, 3, H, W] float32, "cond": [B] or [B, L] int64}. There is
no device-prefetch thread: the workers run ahead by prefetch_factor
batches each (torch's default).
"""

from __future__ import annotations

import os
from typing import Iterator, Optional

import numpy as np
import torch


def shard_indices(n: int, epoch: int, process_index: int, process_count: int, shuffle: bool = True,
                  seed: int = 0) -> np.ndarray:
    """This process's index shard for one epoch (DistributedSampler
    semantics): deterministic permutation of range(n), padded by
    wrap-around to a multiple of process_count, strided by rank."""
    if shuffle:
        rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
        idx = rng.permutation(n)
    else:
        idx = np.arange(n)
    total = ((n + process_count - 1) // process_count) * process_count
    if total > n:
        idx = np.concatenate([idx, idx[: total - n]])
    return idx[process_index::process_count]


def default_collate(items):
    """(image HWC, label or tokens) items -> {"images": [B, C, H, W]
    float32 (the text-only items' 0s stay [B]), "cond": [B] or [B, L]
    int64}."""
    imgs = torch.from_numpy(np.stack([np.asarray(it[0], np.float32) for it in items]))
    if imgs.dim() == 4:
        imgs = imgs.permute(0, 3, 1, 2).contiguous()
    cond = torch.from_numpy(np.stack([np.asarray(it[1], np.int64) for it in items]))
    return {"images": imgs, "cond": cond}


def default_workers() -> int:
    """Worker processes when the caller names none: one a CPU, at most 8."""
    return min(8, os.cpu_count() or 1)


class ShardSampler(torch.utils.data.Sampler):
    """The indices of shard_indices for the current epoch, cut to whole
    batches with drop_last."""

    def __init__(self, n: int, batch_size: int, shuffle: bool, seed: int, drop_last: bool, process_index: int,
                 process_count: int):
        self.n, self.batch_size, self.shuffle, self.seed, self.drop_last = n, batch_size, shuffle, seed, drop_last
        self.process_index, self.process_count = process_index, process_count
        self.epoch = 0

    def indices(self) -> np.ndarray:
        idx = shard_indices(self.n, self.epoch, self.process_index, self.process_count, self.shuffle, self.seed)
        if self.drop_last:
            idx = idx[: (len(idx) // self.batch_size) * self.batch_size]
        return idx

    def __iter__(self):
        return iter(self.indices().tolist())

    def __len__(self):
        return len(self.indices())


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,  # GLOBAL batch size (across all processes)
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        num_workers: Optional[int] = None,  # None: default_workers()
        process_index: int = 0,
        process_count: int = 1,
        device=None,  # where batches land; None keeps them on the host
    ):
        if batch_size % process_count:
            raise ValueError(f"global batch_size {batch_size} not divisible by process_count {process_count}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.process_index, self.process_count = process_index, process_count
        self.local_batch_size = batch_size // process_count
        self.num_workers = default_workers() if num_workers is None else num_workers
        self.device = torch.device(device) if device is not None else None
        self.sampler = ShardSampler(len(dataset), self.local_batch_size, shuffle, seed, drop_last, process_index,
                                    process_count)
        self.loader = torch.utils.data.DataLoader(
            dataset, batch_size=self.local_batch_size, sampler=self.sampler, drop_last=drop_last,
            collate_fn=default_collate, num_workers=self.num_workers,
            pin_memory=self.device is not None and self.device.type == "cuda",
        )

    def set_epoch(self, epoch: int):
        self.sampler.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __len__(self):
        n = len(self.dataset)
        per_proc = (n + self.process_count - 1) // self.process_count
        if self.drop_last:
            return per_proc // self.local_batch_size
        return (per_proc + self.local_batch_size - 1) // self.local_batch_size

    def __iter__(self) -> Iterator[dict]:
        for batch in self.loader:
            yield batch if self.device is None else {k: v.to(self.device, non_blocking=True)
                                                     for k, v in batch.items()}
