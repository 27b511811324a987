"""Stage-2 (RQ-Transformer) training step.

Port of rqvae_tpu/trainers/trainer_stage2.py: a frozen stage-1 encode,
soft targets and codes from the codebooks' distances, the teacher-forced
forward, the soft-target cross-entropy (plus txt_weight times the
condition's loss), gradients averaged over `grad_accum_steps` contiguous
microbatches, the optimizer (rqvae_tpu_torch/optim) and the EMA of the
parameters.

The parameters are the fp32 master weights of an RQTransformer. With
`amp_bf16` the forward runs on bf16 copies of them, made by a
differentiable .to(torch.bfloat16) and passed in with
torch.func.functional_call, so the gradients reach the fp32 parameters as
JAX's do through its tree cast; torch.autocast is not used (its casting
rules are not JAX's). LayerNorm statistics, attention scores and softmax
and the loss's log-softmax are fp32 inside the model either way.

Random bits (stochastic codes, dropout) come from one torch.Generator on
the model's device, drawn in order: the same distributions as JAX's, not
the same numbers. The step runs where the model lives; RQTransformer
builds on CUDA unless it is given device="cpu". TF32 is left as the
caller set it: compute_distances refuses it.

Data parallelism (`dist`, a parallel.dist.DistEnv; the batch is this
rank's share of the global batch, split into the same number of
microbatches on every rank) makes the step the global batch's: the
gradients are averaged over the ranks after the microbatch division and
before the global norm and the clip, and the metrics are averaged over
the ranks. Random bits are each rank's own generator's.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Optional

import torch

from rqvae_tpu_torch.models.ema import ema_update, init_ema
from rqvae_tpu_torch.models.rqtransformer import model as M
from rqvae_tpu_torch.models.rqvae.model import RQVAE
from rqvae_tpu_torch.ops import quantize as rq
from rqvae_tpu_torch.optim.optimizer import Optimizer, create_optimizer, global_norm
from rqvae_tpu_torch.parallel import dist as D


@dataclasses.dataclass
class Stage2State:
    """The model (its parameters are the trained fp32 weights), the
    optimizer, the EMA of the parameters ({name: tensor}, or None) and the
    number of updates applied."""

    model: M.RQTransformer
    optimizer: Optimizer
    ema: Optional[dict] = None
    step: int = 0


@dataclasses.dataclass(frozen=True)
class Stage2LossConfig:
    use_soft_target: bool = True
    temp: float = 1.0
    stochastic_codes: bool = False
    txt_weight: float = 0.1
    img_weight: float = 0.9
    # bf16 activations and products in the transformer's forward and
    # backward; parameters, optimizer state and gradient sums stay fp32
    amp_bf16: bool = True
    # recompute each layer's activations in the backward pass
    remat: bool = False


def init_state(model: M.RQTransformer, optim_config, schedule: Callable[[int], float],
               use_ema: bool = False) -> Stage2State:
    """A fresh state around `model` (built and initialised by the caller,
    fp32): the optimizer of `optim_config` and, with `use_ema`, a copy of
    the parameters as their average. The int8 buffers are dropped."""
    model.clear_int8()
    optimizer = create_optimizer(optim_config, schedule, model.parameters())
    return Stage2State(model=model, optimizer=optimizer, ema=init_ema(model) if use_ema else None)


def make_frozen_encode_fn(vqvae: RQVAE, dtype: Optional[torch.dtype] = torch.bfloat16,
                          chunk: Optional[int] = None) -> Callable[[torch.Tensor], torch.Tensor]:
    """The frozen stage-1 encode for stage-2 training: images [B, 3, res,
    res] (NCHW, about [-1, 1]) -> z_e [B, H, W, embed_dim] without
    gradients. With `dtype` (bf16 by default) the encoder and quant_conv
    run as a copy in that dtype (GroupNorm statistics stay fp32 inside);
    the codebooks, which the soft codes read, stay as they are. dtype=None
    runs the model's own weights. `chunk` encodes that many images at a
    time when it divides a larger batch, which caps the encoder's
    activations at one chunk."""
    encoder, quant_conv = vqvae.encoder, vqvae.quant_conv
    if dtype is not None:
        encoder, quant_conv = (copy.deepcopy(m).to(dtype).requires_grad_(False) for m in (encoder, quant_conv))

    @torch.no_grad()
    def encode(images: torch.Tensor) -> torch.Tensor:
        x = images.to(quant_conv.weight.dtype)
        parts = x.split(chunk) if chunk and x.shape[0] > chunk and x.shape[0] % chunk == 0 else (x,)
        return torch.cat([quant_conv(encoder(part)) for part in parts]).permute(0, 2, 3, 1)

    return encode


def make_soft_code_fn(quantizer: rq.RQCodebooks, loss_cfg: Stage2LossConfig):
    """(z_e, generator) -> (soft targets [B, h, w, D, n_embed], codes [B, h,
    w, D]) of a frozen stage-1 latent."""

    def fn(z_e: torch.Tensor, generator: Optional[torch.Generator]):
        return rq.get_soft_codes(z_e, quantizer, temp=loss_cfg.temp, stochastic=loss_cfg.stochastic_codes,
                                 generator=generator)

    return fn


def loss_fn(
    model: M.RQTransformer,
    loss_cfg: Stage2LossConfig,
    codes: torch.Tensor,  # [B, H, W, D]
    soft_targets: Optional[torch.Tensor],  # [B, h, w, D, V], or None for hard targets
    cond: Optional[torch.Tensor],  # [B] / [B, Lc], or None
    xs_emb: Optional[torch.Tensor],  # [B, HW, D, input_embed_dim], or None
    generator: Optional[torch.Generator],
    deterministic: bool = False,
    params: Optional[dict] = None,
):
    """(loss_total, metrics): the forward of `params` ({name: tensor}; the
    model's own parameters when None), cast to bf16 under amp_bf16, and
    the losses. metrics holds loss_img, loss_total, loss_txt when the
    condition is longer than one token, and codebook_loss [D] (without
    gradients)."""
    params = dict(model.named_parameters()) if params is None else params
    if loss_cfg.amp_bf16:
        params = {k: v.to(torch.bfloat16) if v.dtype == torch.float32 else v for k, v in params.items()}
        if xs_emb is not None and xs_emb.dtype == torch.float32:
            xs_emb = xs_emb.to(torch.bfloat16)
    out = torch.func.functional_call(
        model, params, (codes,),
        dict(cond=cond, xs_emb=xs_emb, generator=generator, deterministic=deterministic, remat=loss_cfg.remat),
    )
    logits, cond_logits = out if model.config.block_size_cond > 1 else (out, None)
    targets = soft_targets if loss_cfg.use_soft_target else codes
    if loss_cfg.use_soft_target and soft_targets is None:
        raise ValueError("use_soft_target needs soft targets")
    img_loss = M.compute_loss(logits, targets, use_soft_target=loss_cfg.use_soft_target)
    metrics = {"loss_img": img_loss}
    if cond_logits is not None:
        cond_loss = M.compute_cond_loss(cond_logits, cond)
        total = loss_cfg.img_weight * img_loss + loss_cfg.txt_weight * cond_loss
        metrics["loss_txt"] = cond_loss
    else:
        total = img_loss
    metrics["loss_total"] = total
    with torch.no_grad():
        metrics["codebook_loss"] = M.compute_codebook_loss(logits, targets, use_soft_target=loss_cfg.use_soft_target)
    return total, metrics


def _prepare(batch: dict, config, loss_cfg: Stage2LossConfig, encode_fn, soft_fn, quantizer, generator):
    """(codes, soft targets, xs_emb) of a batch of images (through the
    frozen encode and the soft codes) or of codes."""
    if "codes" in batch:
        codes, soft_targets = batch["codes"], batch.get("soft_targets")
        if soft_targets is None and loss_cfg.use_soft_target:
            raise ValueError("soft targets required when use_soft_target")
    else:
        if encode_fn is None or soft_fn is None:
            raise ValueError("a batch of images needs encode_fn and a quantizer")
        soft_targets, codes = soft_fn(encode_fn(batch["images"]), generator)
    xs_emb = None
    if config.input_emb_vqvae or config.head_emb_vqvae:
        xs_emb = rq.embed_code_with_depth(codes.reshape(codes.shape[0], -1, codes.shape[-1]), quantizer)
    return codes, soft_targets, xs_emb


def refresh_derived_buffers(model: M.RQTransformer) -> None:
    """After the weights changed: drop the int8 buffers and rebuild the
    fused QKV buffers where they exist, so that `sample` reads the new
    weights."""
    model.clear_int8()
    if any(blk.wqkv is not None for stack in (model.body_transformer, model.head_transformer)
           for blk in stack.blocks):
        model.fuse_qkv()


def make_train_step(
    loss_cfg: Stage2LossConfig,
    *,
    encode_fn: Optional[Callable] = None,  # images [B, 3, res, res] -> z_e (make_frozen_encode_fn)
    quantizer: Optional[rq.RQCodebooks] = None,  # the stage-1 codebooks
    grad_accum_steps: int = 1,
    ema_mu: float = 0.9999,
    dist: Optional[D.DistEnv] = None,
    zero: bool = False,
):
    """train_step(state, batch, generator) -> (state, metrics), updating
    `state` in place. batch: {"images": [B, 3, res, res]} (with encode_fn
    and quantizer) or {"codes": [B, H, W, D], "soft_targets": ...}, and an
    optional "cond". B must be divisible by grad_accum_steps. The metrics
    are the microbatches' means and grad_norm, the global norm of the
    averaged gradients before the clip. With `dist` each rank steps on its
    share of the global batch and takes the global step (module
    docstring); with `zero` too, the optimizer's ZeRO-1 step over it (each
    rank keeps its slice of the moments: optim/optimizer.py)."""
    soft_fn = make_soft_code_fn(quantizer, loss_cfg) if quantizer is not None and loss_cfg.use_soft_target else None

    def train_step(state: Stage2State, batch: dict, generator: Optional[torch.Generator]):
        model = state.model
        B = next(iter(batch.values())).shape[0]
        if B % grad_accum_steps:
            raise ValueError(f"batch {B} does not split into {grad_accum_steps} microbatches")
        m = B // grad_accum_steps
        model.clear_int8()  # a snapshot for sampling: the step trains the float weights
        model.zero_grad(set_to_none=True)
        per_micro = []
        for i in range(grad_accum_steps):
            micro = {k: v[i * m : (i + 1) * m] for k, v in batch.items()}
            with torch.no_grad():
                codes, soft_targets, xs_emb = _prepare(micro, model.config, loss_cfg, encode_fn, soft_fn, quantizer,
                                                       generator)
            loss, metrics = loss_fn(model, loss_cfg, codes, soft_targets, micro.get("cond"), xs_emb, generator)
            loss.backward()
            per_micro.append({k: v.detach() for k, v in metrics.items()})
        for p in model.parameters():
            if p.grad is None:  # a parameter the loss does not reach: JAX's gradient is 0
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in model.parameters()]
        if grad_accum_steps > 1:
            torch._foreach_div_(grads, grad_accum_steps)
        D.all_reduce_mean(grads, dist)
        metrics = {k: torch.stack([mm[k] for mm in per_micro]).mean(dim=0) for k in per_micro[0]}
        metrics = D.mean_metrics(metrics, dist)
        metrics["grad_norm"] = global_norm(grads)
        state.optimizer.step(zero=dist if zero else None)
        if state.ema is not None:
            ema_update(state.ema, model, state.step, ema_mu)
        state.step += 1
        refresh_derived_buffers(model)
        return state, metrics

    return train_step


def make_eval_step(loss_cfg: Stage2LossConfig, *, encode_fn: Optional[Callable] = None,
                   quantizer: Optional[rq.RQCodebooks] = None):
    """eval_step(state, batch, generator=None) -> metrics of the EMA
    parameters when the state keeps them (as Stage2Trainer.eval_epoch),
    else of the parameters, without dropout or gradients."""
    soft_fn = make_soft_code_fn(quantizer, loss_cfg) if quantizer is not None and loss_cfg.use_soft_target else None

    @torch.no_grad()
    def eval_step(state: Stage2State, batch: dict, generator: Optional[torch.Generator] = None) -> dict:
        model = state.model
        codes, soft_targets, xs_emb = _prepare(batch, model.config, loss_cfg, encode_fn, soft_fn, quantizer,
                                               generator)
        _, metrics = loss_fn(model, loss_cfg, codes, soft_targets, batch.get("cond"), xs_emb, None,
                             deterministic=True, params=state.ema)
        return metrics

    return eval_step
