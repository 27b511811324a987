"""Experiment setup: logging, the scalar / image writer, provenance.

Port of rqvae_tpu/utils/setup.py (the reference's utils/setup.py:16-94
and writer.py:6-41): a file + stream logger, a Writer over three
TensorBoard SummaryWriters (train / valid / valid_ema) that falls back to
scalars.jsonl where tensorboard is not installed, the resolved config.yaml, and a copy of rqvae_tpu_torch/ (no
__pycache__; the kernels build outside the package, in build/) in the
result directory. Under data parallelism rank 0 names the directory and
writes it; the other ranks read its name, log nothing and write no
scalars.
"""

from __future__ import annotations

import datetime
import json
import logging
import os
import shutil
import sys
from pathlib import Path
from typing import Optional

import numpy as np

from rqvae_tpu_torch.parallel import dist as D


def create_logger(result_path: Optional[str], name: str = "rqvae_tpu_torch", silent: bool = False) -> logging.Logger:
    """The stream (and, with result_path, train.log) logger; `silent`
    drops every record."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    if silent:
        logger.addHandler(logging.NullHandler())
        logger.propagate = False
        return logger
    fmt = logging.Formatter("[%(asctime)s %(levelname)s] %(message)s")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if result_path:
        os.makedirs(result_path, exist_ok=True)
        fh = logging.FileHandler(os.path.join(result_path, "train.log"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    logger.propagate = False
    return logger


class Writer:
    """Three tensorboard writers keyed by mode (the reference's writer.py:6-41);
    without tensorboard, scalars go to scalars.jsonl and images nowhere."""

    def __init__(self, result_path: Optional[str]):
        self.result_path = result_path
        self.writers = {}
        self.jsonl = None
        if result_path is None:
            return
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:  # tensorboard absent: the file fallback
            self.jsonl = open(os.path.join(result_path, "scalars.jsonl"), "a")
            return
        for mode in ("train", "valid", "valid_ema"):
            self.writers[mode] = SummaryWriter(os.path.join(result_path, mode))

    def add_scalar(self, tag, value, mode="train", step=0):
        value = float(value)
        if mode in self.writers:
            self.writers[mode].add_scalar(tag, value, step)
        elif self.jsonl:
            self.jsonl.write(json.dumps({"tag": tag, "mode": mode, "step": step, "value": value}) + "\n")
            self.jsonl.flush()

    def add_image(self, tag, image_hwc, mode="train", step=0):
        """image: [H, W, C] float in [0, 1]."""
        if mode in self.writers:
            self.writers[mode].add_image(tag, np.transpose(np.asarray(image_hwc), (2, 0, 1)), step)

    def add_text(self, tag, text, mode="train", step=0):
        if mode in self.writers:
            self.writers[mode].add_text(tag, text, step)

    def close(self):
        for w in self.writers.values():
            w.close()
        if self.jsonl:
            self.jsonl.close()


def make_grid(images, nrow: int = 8, padding: int = 2):
    """[N, H, W, C] in [0, 1] -> one [H', W', C] grid (torchvision make_grid,
    the reference's trainer_rqvae.py:308-312)."""
    images = np.asarray(images)
    n, h, w, c = images.shape
    ncol = (n + nrow - 1) // nrow
    grid = np.ones((ncol * (h + padding) + padding, nrow * (w + padding) + padding, c), images.dtype)
    for i in range(n):
        r, col = divmod(i, nrow)
        y = r * (h + padding) + padding
        x = col * (w + padding) + padding
        grid[y : y + h, x : x + w] = images[i]
    return grid


def setup(args, config, extra_args=(), dist=None) -> tuple:
    """(config, logger, writer) with the result directory and its
    provenance (the reference's setup.py:39-94). The directory: for --eval
    <load_path's dir>/val/<time>; for --resume the directory of load_path
    (the run's config.yaml); else <result_path>/<config name>[__postfix]/<time>.
    With a parallel.dist.DistEnv `dist`, rank 0's directory on every rank;
    only rank 0 writes there, and the others get a silent logger and a
    writer of nothing."""
    now = datetime.datetime.now().strftime("%d%m%Y_%H%M%S")
    if getattr(args, "eval", False):
        load_path = getattr(args, "load_path", None)
        result_path = os.path.join(os.path.dirname(load_path), "val", now) if load_path else os.path.join(
            args.result_path, now)
    elif getattr(args, "resume", False):
        result_path = os.path.dirname(args.load_path)
    else:
        task_name = Path(getattr(args, "model_config", "config")).stem
        if getattr(args, "postfix", ""):
            task_name += f"__{args.postfix}"
        result_path = os.path.join(args.result_path, task_name, now)

    result_path = D.broadcast_object(result_path, dist)
    config.result_path = result_path
    if not D.is_master(dist):
        return config, create_logger(None, silent=True), Writer(None)
    os.makedirs(result_path, exist_ok=True)
    logger = create_logger(result_path)
    writer = Writer(result_path)

    with open(os.path.join(result_path, "config.yaml"), "w") as f:
        f.write(config.to_yaml())
    src_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    snapshot = os.path.join(result_path, "source", "rqvae_tpu_torch")
    if not os.path.exists(snapshot):
        shutil.copytree(src_dir, snapshot, ignore=shutil.ignore_patterns("__pycache__", "*.pyc"))
    logger.info("result path: %s", result_path)
    return config, logger, writer
