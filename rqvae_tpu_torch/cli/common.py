"""Shared CLI helpers: seeding, and loading a model or the stage-2 /
stage-1 pair from a checkpoint with its config.yaml beside it.

Port of cli/common.py (set_seed, load_model_from_ckpt, load_ar_and_vqvae).
Models are built on `device` (CUDA when None) in `dtype`.
"""

from __future__ import annotations

import os
import random

import numpy as np
import torch

from rqvae_tpu_torch.models import load_rqtransformer, load_rqvae
from rqvae_tpu_torch.utils.config import augment_arch_defaults, load_config


def set_seed(seed=None) -> int:
    """Seed Python's, numpy's and torch's global generators; returns the seed,
    from which a caller seeds its own torch.Generator."""
    if seed is None:
        seed = random.getrandbits(32)
    random.seed(seed)
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)
    return seed


def load_model_from_ckpt(ckpt_path: str, use_ema: bool = False, device=None, dtype=None):
    """A model and its config from a .pt path with config.yaml beside it:
    ('rq-vae', RQVAE, config) or ('rq-transformer', RQTransformer, config)."""
    config = load_config(os.path.join(os.path.dirname(ckpt_path), "config.yaml"))
    arch = augment_arch_defaults(config.arch)
    if arch.type == "rq-vae":
        return "rq-vae", load_rqvae(arch, ckpt_path, device=device, dtype=dtype), config
    if arch.type == "rq-transformer":
        return "rq-transformer", load_rqtransformer(arch, ckpt_path, use_ema, device, dtype), config
    raise ValueError(arch.type)


def load_ar_and_vqvae(ar_ckpt_path: str, use_ema: bool = False, device=None, dtype=None):
    """(RQTransformer, RQVAE, stage-2 config); the stage-1 checkpoint is the
    stage-2 config's vqvae.ckpt, with its own config.yaml beside it."""
    kind, model, config = load_model_from_ckpt(ar_ckpt_path, use_ema, device, dtype)
    if kind != "rq-transformer":
        raise ValueError(f"{ar_ckpt_path}: expected a stage-2 checkpoint, got {kind}")
    vq_ckpt = config.vqvae.ckpt
    vq_arch = augment_arch_defaults(load_config(os.path.join(os.path.dirname(vq_ckpt), "config.yaml")).arch)
    vqvae = load_rqvae(vq_arch, vq_ckpt, device=device, dtype=dtype)
    return model, vqvae, config
