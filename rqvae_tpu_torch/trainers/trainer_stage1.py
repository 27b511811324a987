"""Stage-1 (RQ-VAE + VQGAN losses) training step.

Port of rqvae_tpu/trainers/trainer_stage1.py. One step: the generator's
forward (the RQ-VAE up to its decoder's tail, with the EMA codebook update
inside the quantizer, then the tail), the reconstruction, commitment,
LPIPS and adaptive-weighted GAN losses, the generator's update, then the
discriminator's (hinge or vanilla) with its own optimizer and schedule,
and the EMA of the parameters and the codebooks.

The adaptive GAN weight is the reference's calculate_adaptive_weight:
||d nll / d W|| / (||d g / d W|| + 1e-4), clipped to [0, 1e4] and
detached, W the decoder's conv_out weight and nll = recon + perceptual
weight * LPIPS. Both gradients come from torch.autograd.grad on the step's
own graph (retain_graph), which reaches W only through the tail, as JAX's
tail-only jacobian does. The generator's gradients are taken with
torch.autograd.grad over the RQ-VAE's parameters alone, so neither the
discriminator nor LPIPS (frozen) gathers a gradient from it.

The generator's pass runs the discriminator on batch statistics without
writing its running averages; the discriminator's step writes them twice,
on the fake batch and then on the real one.

With `amp_bf16` the RQ-VAE runs on bf16 copies of its fp32 parameters
(a differentiable .to(torch.bfloat16) passed in with
torch.func.functional_call, as the stage-2 trainer does); the codebooks,
their update, the discriminator and every loss stay fp32.

Images are NHWC in [-1, 1], as JAX's. Random bits (dropout, code
restarts) come from one torch.Generator on the model's device: the same
distributions as JAX's, not the same numbers; `draw` stands in for the
restart draws (ops/quantize.quantize_train). On CUDA the codes come from
the nearest_code kernel (one launch per depth) when the model's
use_kernel is on.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch

from rqvae_tpu_torch.losses import gan as gan_losses
from rqvae_tpu_torch.losses.discriminator import NLayerDiscriminator
from rqvae_tpu_torch.losses.lpips import LPIPS
from rqvae_tpu_torch.models.ema import averaged_weights, ema_update, init_ema
from rqvae_tpu_torch.models.rqvae.model import RQVAE
from rqvae_tpu_torch.models.rqvae.modules import decoder_tail
from rqvae_tpu_torch.ops import quantize as rq
from rqvae_tpu_torch.optim.optimizer import Optimizer, create_optimizer

TAIL = ("decoder.norm_out.weight", "decoder.norm_out.bias", "decoder.conv_out.weight", "decoder.conv_out.bias")


@dataclasses.dataclass
class Stage1State:
    """The RQ-VAE (its parameters the trained fp32 weights, its buffers the
    codebook state) and its optimizer, the discriminator (its buffers the
    BatchNorm running averages) and its optimizer, the EMA of the RQ-VAE's
    parameters and codebook buffers ({name: tensor}, or None), the number
    of updates applied, and the number of discriminator updates."""

    model: RQVAE
    optimizer: Optimizer
    disc: NLayerDiscriminator
    disc_optimizer: Optimizer
    ema: Optional[dict] = None
    step: int = 0
    disc_step: int = 0


@dataclasses.dataclass(frozen=True)
class GanLossConfig:
    disc_loss: str = "hinge"
    gen_loss: str = "vanilla"
    disc_weight: float = 0.75
    perceptual_weight: float = 1.0
    disc_start: int = 0
    # the train step's LPIPS tower in bf16 (weights fp32, loss fp32); the
    # eval step keeps fp32
    lpips_bf16: bool = True
    # the RQ-VAE's forward and backward on bf16 weight copies (codebooks,
    # discriminator and losses fp32)
    amp_bf16: bool = False


def init_state(model: RQVAE, disc: NLayerDiscriminator, optim_config, schedule, disc_optim_config, disc_schedule,
               use_ema: bool = False) -> Stage1State:
    """A fresh state around `model` and `disc` (built and initialised by the
    caller, fp32): each one's optimizer of its config and schedule and,
    with `use_ema`, a copy of the RQ-VAE's parameters and codebook buffers
    as their average."""
    return Stage1State(
        model=model,
        optimizer=create_optimizer(optim_config, schedule, model.parameters()),
        disc=disc,
        disc_optimizer=create_optimizer(disc_optim_config, disc_schedule, disc.parameters()),
        ema=init_ema(model, buffers=True) if use_ema else None,
    )


def _recon_loss(loss_type: str, out: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    if loss_type == "mse":
        return (out - xs).square().mean()
    return (out - xs).abs().mean()


def _set_grads(params: list, grads) -> None:
    for p, g in zip(params, grads):
        p.grad = torch.zeros_like(p) if g is None else g  # a parameter the loss misses: JAX's gradient is 0


def make_train_step(lpips: Optional[LPIPS], gan_cfg: GanLossConfig, *, use_discriminator: bool,
                    ema_mu: float = 0.9999):
    """train_step(state, batch, generator, draw=None) -> (state, metrics,
    codes), updating `state` in place. batch: {"images": [B, res, res, 3]}
    NHWC. `use_discriminator` (epoch >= disc_start) adds the GAN term and
    runs the discriminator's step. `lpips` may be None when
    perceptual_weight is 0, which skips the VGG tower. metrics: loss_total
    (without the GAN term), loss_recon, loss_latent, loss_pcpt, loss_gen,
    loss_disc, g_weight, logits_real, logits_fake."""
    d_loss_fn = gan_losses.D_LOSSES[gan_cfg.disc_loss]
    g_loss_fn = gan_losses.G_LOSSES[gan_cfg.gen_loss]
    p_weight = gan_cfg.perceptual_weight
    lpips_dtype = torch.bfloat16 if gan_cfg.lpips_bf16 else None
    if p_weight and lpips is None:
        raise ValueError("a perceptual_weight needs the LPIPS module")

    def train_step(state: Stage1State, batch: dict, generator: Optional[torch.Generator],
                   draw: Optional[rq.Draw] = None):
        model, disc = state.model, state.disc
        hp = model.hparams
        xs = batch["images"]
        x = xs.permute(0, 3, 1, 2)  # NCHW for the tail, LPIPS and the discriminator
        params = dict(model.named_parameters())
        kw = dict(training=True, generator=generator, draw=draw, give_pre_end=True)
        if gan_cfg.amp_bf16:
            cast = {k: v.to(torch.bfloat16) if v.dtype == torch.float32 else v for k, v in params.items()}
            h_pre, quant_loss, codes = torch.func.functional_call(model, cast, (xs.to(torch.bfloat16),), kw)
        else:
            cast = params
            h_pre, quant_loss, codes = model(xs, **kw)
        last = cast[TAIL[2]]
        out = decoder_tail(h_pre, *(cast[k] for k in TAIL))

        loss_recon = _recon_loss(hp.loss_type, out, x)
        loss_latent = quant_loss
        loss_pcpt = lpips(x, out, dtype=lpips_dtype) if p_weight else torch.zeros((), device=xs.device)
        zero = torch.zeros((), device=xs.device)
        if use_discriminator:
            disc_dtype = disc.main[0].weight.dtype
            loss_gen = g_loss_fn(disc(out.to(disc_dtype), train=True, update_stats=False))
            nll = loss_recon + p_weight * loss_pcpt if p_weight else loss_recon
            (g_nll,) = torch.autograd.grad(nll, last, retain_graph=True)
            (g_gen,) = torch.autograd.grad(loss_gen, last, retain_graph=True)
            nll_norm = torch.linalg.vector_norm(g_nll.float())
            g_norm = torch.linalg.vector_norm(g_gen.float())
            g_weight = (nll_norm / (g_norm + 1e-4)).clamp(0.0, 1e4).detach()
        else:
            loss_gen = g_weight = zero
        total = loss_recon + hp.latent_loss_weight * loss_latent + p_weight * loss_pcpt
        total = total + g_weight * gan_cfg.disc_weight * loss_gen
        gen_params = list(params.values())
        _set_grads(gen_params, torch.autograd.grad(total, gen_params, allow_unused=True))
        state.optimizer.step()

        if use_discriminator:
            fake = out.detach().to(disc_dtype)
            logits_fake = disc(fake, train=True, update_stats=True)
            logits_real = disc(x.to(disc_dtype), train=True, update_stats=True)
            loss_disc = d_loss_fn(logits_real, logits_fake)
            disc_params = list(disc.parameters())
            _set_grads(disc_params, torch.autograd.grad(gan_cfg.disc_weight * loss_disc, disc_params,
                                                        allow_unused=True))
            state.disc_optimizer.step()
            state.disc_step += 1
            logits = {"logits_real": logits_real.detach().mean(), "logits_fake": logits_fake.detach().mean()}
        else:
            loss_disc = zero
            logits = {"logits_real": zero, "logits_fake": zero}

        if state.ema is not None:
            ema_update(state.ema, model, state.step, ema_mu)
        state.step += 1
        metrics = {
            "loss_total": loss_recon + hp.latent_loss_weight * loss_latent + p_weight * loss_pcpt,
            "loss_recon": loss_recon,
            "loss_latent": loss_latent,
            "loss_pcpt": loss_pcpt,
            "loss_gen": loss_gen,
            "loss_disc": loss_disc,
            "g_weight": g_weight,
            **logits,
        }
        return state, {k: v.detach() for k, v in metrics.items()}, codes

    return train_step


def make_eval_step(lpips: LPIPS, gan_cfg: GanLossConfig, *, use_discriminator: bool, use_ema: bool = False):
    """eval_step(state, batch) -> (metrics, codes) without gradients, on the
    EMA parameters and codebooks with `use_ema` (when the state keeps
    them), with the reference's batch-scaled sums: recon by B * C, latent,
    LPIPS (fp32), GAN losses and mean logits by B; the discriminator on its
    running averages."""
    d_loss_fn = gan_losses.D_LOSSES[gan_cfg.disc_loss]
    g_loss_fn = gan_losses.G_LOSSES[gan_cfg.gen_loss]
    p_weight = gan_cfg.perceptual_weight

    @torch.no_grad()
    def eval_step(state: Stage1State, batch: dict):
        model, disc = state.model, state.disc
        xs = batch["images"]
        B = xs.shape[0]
        with averaged_weights(model, state.ema) if use_ema and state.ema is not None else contextlib.nullcontext():
            out, quant_loss, codes = model(xs)
        losses = model.compute_loss(out, quant_loss, codes, xs, valid=True)
        x, out_nchw = xs.permute(0, 3, 1, 2), out.permute(0, 3, 1, 2)
        loss_pcpt = lpips(x, out_nchw) * B
        if use_discriminator:
            logits_fake = disc(out_nchw, train=False)
            logits_real = disc(x, train=False)
            loss_gen = g_loss_fn(logits_fake) * B
            loss_disc = d_loss_fn(logits_real, logits_fake) * B
            logits = {"logits_real": logits_real.mean() * B, "logits_fake": logits_fake.mean() * B}
        else:
            zero = torch.zeros((), device=xs.device)
            loss_gen = loss_disc = zero
            logits = {"logits_real": zero, "logits_fake": zero}
        metrics = {
            "loss_total": losses["loss_total"] + p_weight * loss_pcpt,
            "loss_recon": losses["loss_recon"],
            "loss_latent": losses["loss_latent"],
            "loss_pcpt": loss_pcpt,
            "loss_gen": loss_gen,
            "loss_disc": loss_disc,
            **logits,
        }
        return metrics, codes

    return eval_step
