"""Exponential moving average of a model's parameters (and buffers).

Port of rqvae_tpu/models/ema.py: the warmup decay min(mu, (1 + step) /
(10 + step)), with `step` the number of updates before this one, applied
to every averaged tensor. The stage-2 average covers named_parameters()
only: the derived buffers (a block's fused wqkv, the int8 buffers) are
rebuilt from the parameters and never averaged. The stage-1 average
(init_ema(..., buffers=True)) also covers the floating buffers, which in
an RQVAE are the quantizer's codebooks and their EMA statistics, as JAX's
ema_codebook averages its CodebookState (rqvae_tpu/trainers/
trainer_stage1.py:40-43, :279-284); a shared codebook's buffers appear
once, under depth 0's names.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn


def _averaged(model: nn.Module, buffers: bool) -> dict[str, torch.Tensor]:
    tensors = dict(model.named_parameters())
    if buffers:
        tensors.update((k, b) for k, b in model.named_buffers() if b.is_floating_point())
    return tensors


def init_ema(model: nn.Module, buffers: bool = False) -> dict[str, torch.Tensor]:
    """{name: a copy} of every named parameter and, with `buffers`, every
    floating buffer."""
    return {name: t.detach().clone() for name, t in _averaged(model, buffers).items()}


@torch.no_grad()
def ema_update(ema: dict[str, torch.Tensor], model: nn.Module, step: int, mu: float = 0.9999) -> None:
    """ema <- decay * ema + (1 - decay) * the model's tensors, in place,
    with decay = min(mu, (1 + step) / (10 + step)). The average holds
    buffers when init_ema was given buffers=True."""
    decay = min(mu, (1.0 + step) / (10.0 + step))
    params = dict(model.named_parameters())
    tensors = _averaged(model, buffers=not set(ema) <= set(params))
    if set(tensors) != set(ema):
        raise ValueError(f"ema_update: names in the average or the model alone: {sorted(set(ema) ^ set(tensors))}")
    names = list(ema)
    averages = [ema[n] for n in names]
    torch._foreach_mul_(averages, decay)
    torch._foreach_add_(averages, [tensors[n] for n in names], alpha=1.0 - decay)


@contextlib.contextmanager
def averaged_weights(model: nn.Module, ema: dict[str, torch.Tensor]):
    """Inside the block the model's tensors named in `ema` hold the
    average's values; after it, their own again. Values are copied in and
    out (a module that appears under several names, as a shared codebook
    does, keeps its one tensor; torch.func.functional_call would leave the
    average's tensor behind in such a module)."""
    tensors = _averaged(model, buffers=not set(ema) <= set(dict(model.named_parameters())))
    own = {k: tensors[k].detach().clone() for k in ema}
    with torch.no_grad():
        for k, v in ema.items():
            tensors[k].copy_(v)
    try:
        yield model
    finally:
        with torch.no_grad():
            for k, v in own.items():
                tensors[k].copy_(v)
