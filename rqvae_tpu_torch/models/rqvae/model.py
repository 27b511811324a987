"""RQ-VAE: the decode side in PyTorch.

Port of rqvae_tpu/models/rqvae/model.py: RQVAEHParams and an RQVAE module
with `decode` and `decode_code`. The state_dict has the reference layout
(encoder.*, decoder.*, quant_conv, post_quant_conv, quantizer.codebooks.*),
so a stage-1 checkpoint loads with strict=True. The public boundary keeps
the JAX package's layout: latents and pixels are NHWC, codes [B, h, w, D].
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from rqvae_tpu_torch import resolve_device
from rqvae_tpu_torch.models.rqvae.modules import DDConfig, Decoder, Encoder, init_conv_stack
from rqvae_tpu_torch.ops.quantize import QuantizerConfig, RQCodebooks, embed_code


@dataclasses.dataclass(frozen=True)
class RQVAEHParams:
    embed_dim: int = 64
    n_embed: object = 512  # int or per-depth list
    decay: object = 0.99
    loss_type: str = "mse"
    latent_loss_weight: float = 0.25
    bottleneck_type: str = "rq"
    latent_shape: tuple = ()
    code_shape: tuple = ()
    shared_codebook: bool = False
    restart_unused_codes: bool = True

    @staticmethod
    def create(cfg) -> "RQVAEHParams":
        return RQVAEHParams(
            embed_dim=cfg["embed_dim"],
            n_embed=cfg["n_embed"],
            decay=cfg.get("decay", 0.99),
            loss_type=cfg.get("loss_type", "l1"),
            latent_loss_weight=cfg.get("latent_loss_weight", 0.25),
            bottleneck_type=cfg.get("bottleneck_type", "rq"),
            latent_shape=tuple(cfg["latent_shape"]),
            code_shape=tuple(cfg["code_shape"]),
            shared_codebook=cfg.get("shared_codebook", False),
            restart_unused_codes=cfg.get("restart_unused_codes", True),
        )

    @property
    def quantizer_config(self) -> QuantizerConfig:
        if self.bottleneck_type != "rq":
            raise ValueError("only the 'rq' bottleneck is supported")
        listed = lambda v: list(v) if isinstance(v, (list, tuple)) else v  # noqa: E731
        return QuantizerConfig.create(
            latent_shape=self.latent_shape,
            code_shape=self.code_shape,
            n_embed=listed(self.n_embed),
            decay=listed(self.decay),
            shared_codebook=self.shared_codebook,
            restart_unused_codes=self.restart_unused_codes,
        )


class RQVAE(nn.Module):
    """Built on `device`, or on CUDA when it is None (resolve_device)."""

    def __init__(self, hparams: RQVAEHParams, ddconfig: DDConfig, device=None, dtype=None):
        super().__init__()
        fk = dict(device=resolve_device(device), dtype=dtype)
        self.hparams = hparams
        self.ddconfig = ddconfig
        self.encoder = Encoder(ddconfig, **fk)
        self.decoder = Decoder(ddconfig, **fk)
        z_out = 2 * ddconfig.z_channels if ddconfig.double_z else ddconfig.z_channels
        self.quant_conv = nn.Conv2d(z_out, hparams.embed_dim, 1, **fk)
        self.post_quant_conv = nn.Conv2d(hparams.embed_dim, ddconfig.z_channels, 1, **fk)
        self.quantizer = RQCodebooks(hparams.quantizer_config, **fk)

    def decode(self, z_q: torch.Tensor) -> torch.Tensor:
        """z_q [B, H, W, embed_dim] -> pixels [B, res, res, out_ch] in about [-1, 1]."""
        z = self.post_quant_conv(z_q.permute(0, 3, 1, 2))
        return self.decoder(z).permute(0, 2, 3, 1)

    def decode_code(self, codes: torch.Tensor) -> torch.Tensor:
        """codes [B, h, w, depth] -> pixels [B, res, res, out_ch] (NHWC)."""
        z_q = embed_code(codes, self.quantizer).to(self.post_quant_conv.weight.dtype)
        return self.decode(z_q)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Random weights drawn from `generator` (convs, codebooks)."""
        init_conv_stack(self, generator)
        self.quantizer.init_weights(generator)
