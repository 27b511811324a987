"""Learning-rate schedule: gradual warmup (and a buffer), then cosine.

Port of rqvae_tpu/optim/schedule.py as a plain function step -> lr: a
linear warmup to multiplier * base_lr (from zero, or from base_lr), an
optional hold for the buffer steps, then cosine annealing from base_lr to
min_lr over the remaining steps. The multiplier scales with the world
size by the warmup `mode` (linear, sqrt, fix, none). Stepped once per
update.
"""

from __future__ import annotations

import math
from typing import Callable


def warmup_multiplier(mode: str, multiplier: float, world_size: int) -> float:
    if mode == "linear":
        return max(1.0, multiplier * world_size)
    if mode == "sqrt":
        return max(1.0, multiplier * math.sqrt(world_size))
    if mode == "fix":
        return max(1.0, multiplier)
    if mode == "none":
        return multiplier
    raise NotImplementedError(f"{mode} is not a valid warmup policy")


def create_schedule(
    *,
    base_lr: float,
    warmup_config,
    steps_per_epoch: int,
    max_epoch: float,
    world_size: int = 1,
) -> Callable[[int], float]:
    """Returns step -> lr for the update counted from 0."""
    warmup_steps = int(warmup_config["epoch"] * steps_per_epoch)
    buffer_steps = int(warmup_config.get("buffer_epoch", 0) * steps_per_epoch)
    final_steps = int(max_epoch * steps_per_epoch)
    min_lr = float(warmup_config.get("min_lr", 0.0))
    mode = warmup_config.get("mode", "linear")
    start_from_zero = bool(warmup_config.get("start_from_zero", warmup_steps > 0))
    multiplier = (
        warmup_multiplier(mode, float(warmup_config.get("multiplier", 1)), world_size)
        if warmup_steps > 0
        else 1.0
    )
    t_max = max(final_steps - warmup_steps - buffer_steps, 1)

    def schedule(step: int) -> float:
        step = float(step)
        cos_step = min(max(step - warmup_steps - buffer_steps, 0.0), t_max)
        cos_lr = min_lr + (base_lr - min_lr) * 0.5 * (1.0 + math.cos(math.pi * cos_step / t_max))
        if warmup_steps == 0 or step > warmup_steps + buffer_steps:
            return cos_lr
        if step > warmup_steps:
            return base_lr * multiplier
        frac = min(1.0, step / warmup_steps)
        if start_from_zero:
            return base_lr * multiplier * frac
        return base_lr * (1.0 + (multiplier - 1.0) * frac)

    return schedule
