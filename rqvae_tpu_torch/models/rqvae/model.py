"""RQ-VAE in PyTorch: conv encoder -> residual quantization -> conv decoder.

Port of rqvae_tpu/models/rqvae/model.py: RQVAEHParams and an RQVAE module
with `encode`, `forward` (JAX's __call__), `forward_pre`, `get_codes`,
`get_soft_codes`, `decode`, `decode_code`, `get_code_emb_with_depth`,
`decode_partial_code`, `forward_partial_code`, `get_recon_imgs` and
`compute_loss`. Residual quantization finds codes with the nearest_code
kernel (use_kernel=True, as in JAX) or the argmin of the full distance
matrix. forward(training=True) updates the codebooks' EMA buffers in place
(ops/quantize.quantize_train), with dropout masks and code-restart draws
from the given torch.Generator. The state_dict has the reference layout
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
from rqvae_tpu_torch.ops import quantize as rq
from rqvae_tpu_torch.ops.quantize import QuantizerConfig, RQCodebooks


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
    """Built on `device`, or on CUDA when it is None (resolve_device).
    `use_kernel` picks how codes are found (rq.find_nearest);
    modules.set_checkpointing makes each ResnetBlock recompute itself in
    the backward pass."""

    def __init__(
        self, hparams: RQVAEHParams, ddconfig: DDConfig, device=None, dtype=None, use_kernel: bool = True
    ):
        super().__init__()
        fk = dict(device=resolve_device(device), dtype=dtype)
        self.hparams = hparams
        self.ddconfig = ddconfig
        self.use_kernel = use_kernel
        self.encoder = Encoder(ddconfig, **fk)
        self.decoder = Decoder(ddconfig, **fk)
        z_out = 2 * ddconfig.z_channels if ddconfig.double_z else ddconfig.z_channels
        self.quant_conv = nn.Conv2d(z_out, hparams.embed_dim, 1, **fk)
        self.post_quant_conv = nn.Conv2d(hparams.embed_dim, ddconfig.z_channels, 1, **fk)
        self.quantizer = RQCodebooks(hparams.quantizer_config, **fk)

    def encode(self, xs: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """pixels xs [B, res, res, in_channels] (NHWC, about [-1, 1]) -> z_e
        [B, H, W, embed_dim] in the model's dtype; dropout when given a
        generator."""
        x = xs.to(self.quant_conv.weight.dtype).permute(0, 3, 1, 2)
        return self.quant_conv(self.encoder(x, generator)).permute(0, 2, 3, 1)

    def forward(
        self, xs: torch.Tensor, training: bool = False, generator: torch.Generator | None = None,
        draw: rq.Draw | None = None, give_pre_end: bool = False,
    ):
        """pixels -> (reconstruction [B, res, res, out_ch], commitment loss,
        codes [B, h, w, depth]). training=True runs dropout and the EMA
        codebook update (restart draws from `draw`, else from
        `generator`); give_pre_end returns the decoder's activations
        before its tail, [B, ch, res, res] (NCHW), in place of the
        reconstruction."""
        gen = generator if training else None
        z_e = self.encode(xs, gen)
        z_q, quant_loss, codes = rq.rq_bottleneck_forward(
            z_e, self.quantizer, training=training, use_kernel=self.use_kernel, generator=generator, draw=draw
        )
        z = self.post_quant_conv(z_q.permute(0, 3, 1, 2))
        h = self.decoder(z, gen, give_pre_end=give_pre_end)
        return (h if give_pre_end else h.permute(0, 2, 3, 1)), quant_loss, codes

    def forward_pre(self, xs: torch.Tensor, training: bool = False, generator: torch.Generator | None = None,
                    draw: rq.Draw | None = None):
        """forward up to the decoder's tail (JAX forward_pre, the
        reference's give_pre_end): (h_pre [B, ch, res, res] NCHW, commitment
        loss, codes). decoder.tail(h_pre) is the reconstruction (NCHW)."""
        return self.forward(xs, training, generator, draw, give_pre_end=True)

    def get_codes(self, xs: torch.Tensor) -> torch.Tensor:
        """pixels -> codes [B, h, w, depth] (torch.long)."""
        z = rq.to_code_shape(self.encode(xs), self.quantizer.config)
        return rq.quantize(z, self.quantizer, use_kernel=self.use_kernel)[1]

    def get_soft_codes(
        self, xs: torch.Tensor, temp: float = 1.0, stochastic: bool = False,
        generator: torch.Generator | None = None,
    ):
        """pixels -> (soft targets [B, h, w, depth, n_embed], codes)."""
        return rq.get_soft_codes(self.encode(xs), self.quantizer, temp, stochastic, generator)

    def decode(self, z_q: torch.Tensor) -> torch.Tensor:
        """z_q [B, H, W, embed_dim] -> pixels [B, res, res, out_ch] in about [-1, 1]."""
        z = self.post_quant_conv(z_q.permute(0, 3, 1, 2))
        return self.decoder(z).permute(0, 2, 3, 1)

    def decode_code(self, codes: torch.Tensor) -> torch.Tensor:
        """codes [B, h, w, depth] -> pixels [B, res, res, out_ch] (NHWC)."""
        z_q = rq.embed_code(codes, self.quantizer).to(self.post_quant_conv.weight.dtype)
        return self.decode(z_q)

    def get_code_emb_with_depth(self, codes: torch.Tensor) -> torch.Tensor:
        return rq.embed_code_with_depth(codes, self.quantizer)

    def decode_partial_code(self, codes: torch.Tensor, code_idx: int, decode_type: str = "select"):
        """Pixels from depth code_idx alone ("select") or depths 0..code_idx
        ("add")."""
        z_q = rq.embed_partial_code(codes, code_idx, self.quantizer, decode_type)
        return self.decode(z_q.to(self.post_quant_conv.weight.dtype))

    def forward_partial_code(self, xs: torch.Tensor, code_idx: int, decode_type: str = "select"):
        return self.decode_partial_code(self.get_codes(xs), code_idx, decode_type)

    @staticmethod
    def get_recon_imgs(xs_real: torch.Tensor, xs_recon: torch.Tensor):
        """[-1, 1] pixels -> [0, 1]; the reconstruction clipped."""
        return xs_real * 0.5 + 0.5, (xs_recon * 0.5 + 0.5).clamp(0.0, 1.0)

    def compute_loss(self, out, quant_loss, codes, xs, valid: bool = False) -> dict:
        """Reconstruction (mse or l1) and latent losses; with `valid`, the
        batch- and channel-scaled sums of the reference's evaluation."""
        if self.hparams.loss_type == "mse":
            loss_recon = (out - xs).square().mean()
        elif self.hparams.loss_type == "l1":
            loss_recon = (out - xs).abs().mean()
        else:
            raise ValueError("incompatible loss type")
        loss_latent = quant_loss
        if valid:
            loss_recon = loss_recon * xs.shape[0] * xs.shape[-1]
            loss_latent = loss_latent * xs.shape[0]
        loss_total = loss_recon + self.hparams.latent_loss_weight * loss_latent
        return {"loss_total": loss_total, "loss_recon": loss_recon, "loss_latent": loss_latent, "codes": [codes]}

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Random weights drawn from `generator` (convs, codebooks)."""
        init_conv_stack(self, generator)
        self.quantizer.init_weights(generator)
