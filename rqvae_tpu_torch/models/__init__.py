"""Model factories and checkpoint loading.

Port of rqvae_tpu/models/__init__.py (create_rqvae, create_rqtransformer,
load_rqvae, load_rqtransformer): the RQ-VAE and the RQ-Transformer as the
port's modules, built on `device` (CUDA when None) in `dtype`. A loader
reads a reference torch checkpoint (.pt, .pth, .ckpt): its `state_dict`,
or under `use_ema` its `state_dict_ema`, with strict=True. A native Orbax
directory is the JAX package's own format; loading one raises ValueError.
"""

from __future__ import annotations

import torch

from rqvae_tpu_torch.models.rqtransformer.config import TransformerConfig
from rqvae_tpu_torch.models.rqtransformer.model import RQTransformer
from rqvae_tpu_torch.models.rqvae.model import RQVAE, RQVAEHParams
from rqvae_tpu_torch.models.rqvae.modules import DDConfig, set_checkpointing

CKPT_SUFFIXES = (".pt", ".pth", ".ckpt")


def create_rqvae(arch_config, use_kernel: bool = True, device=None, dtype=None) -> RQVAE:
    """An RQVAE of a stage-1 `arch` config, its weights not initialised."""
    model = RQVAE(
        RQVAEHParams.create(arch_config["hparams"]), DDConfig.create(arch_config["ddconfig"]),
        device=device, dtype=dtype, use_kernel=use_kernel,
    )
    set_checkpointing(model, bool(arch_config.get("checkpointing", False)))
    return model


def create_rqtransformer(arch_config, device=None, dtype=None) -> RQTransformer:
    """An RQTransformer of a stage-2 `arch` config, its weights not initialised."""
    return RQTransformer(TransformerConfig.create(arch_config), device=device, dtype=dtype)


def _read_checkpoint(ckpt_path: str) -> dict:
    if not ckpt_path.endswith(CKPT_SUFFIXES):
        raise ValueError(
            f"{ckpt_path}: not a torch checkpoint ({', '.join(CKPT_SUFFIXES)}); a native Orbax directory is the "
            f"JAX package's format, which the port does not read: export it to .pt first"
        )
    # reference checkpoints pickle more than tensors (the optimizer, the epoch)
    return torch.load(ckpt_path, map_location="cpu", weights_only=False)


def load_rqvae(arch_config, ckpt_path: str, use_kernel: bool = True, device=None, dtype=None) -> RQVAE:
    """The RQVAE of a reference stage-1 checkpoint, loaded strictly."""
    model = create_rqvae(arch_config, use_kernel, device, dtype)
    ckpt = _read_checkpoint(ckpt_path)
    model.load_state_dict(ckpt.get("state_dict", ckpt), strict=True)
    return model


def load_rqtransformer(arch_config, ckpt_path: str, use_ema: bool = False, device=None,
                       dtype=None) -> RQTransformer:
    """The RQTransformer of a reference stage-2 checkpoint, loaded strictly;
    `use_ema` selects its EMA weights (state_dict_ema), as the reference's
    main_sampling_fid.py does for EMA-trained models."""
    model = create_rqtransformer(arch_config, device, dtype)
    ckpt = _read_checkpoint(ckpt_path)
    if use_ema:
        if "state_dict_ema" not in ckpt:
            raise ValueError(f"no state_dict_ema in {ckpt_path}")
        sd = ckpt["state_dict_ema"]
    else:
        sd = ckpt.get("state_dict", ckpt)
    model.load_state_dict(sd, strict=True)
    return model

