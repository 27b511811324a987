"""Exponential moving average of a model's parameters.

Port of rqvae_tpu/models/ema.py: the warmup decay min(mu, (1 + step) /
(10 + step)), with `step` the number of updates before this one, applied
to every parameter. The average covers named_parameters() only: the
derived buffers (a block's fused wqkv, the int8 buffers) are rebuilt from
the parameters and never averaged.
"""

from __future__ import annotations

import torch
from torch import nn


def init_ema(model: nn.Module) -> dict[str, torch.Tensor]:
    """{name: a copy of the parameter} for every named parameter."""
    return {name: p.detach().clone() for name, p in model.named_parameters()}


@torch.no_grad()
def ema_update(ema: dict[str, torch.Tensor], model: nn.Module, step: int, mu: float = 0.9999) -> None:
    """ema <- decay * ema + (1 - decay) * params, in place, with decay =
    min(mu, (1 + step) / (10 + step))."""
    decay = min(mu, (1.0 + step) / (10.0 + step))
    params = dict(model.named_parameters())
    if set(params) != set(ema):
        raise ValueError(f"ema_update: names in the average or the model alone: {sorted(set(ema) ^ set(params))}")
    names = list(ema)
    averages = [ema[n] for n in names]
    torch._foreach_mul_(averages, decay)
    torch._foreach_add_(averages, [params[n] for n in names], alpha=1.0 - decay)
