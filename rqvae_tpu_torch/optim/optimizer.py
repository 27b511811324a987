"""adamW, adam and sgd with an optional global-norm clip, with optax's
semantics.

Port of rqvae_tpu/optim/optimizer.py, which chains optax transforms; here
one torch.optim.Optimizer runs the same chain on the parameters' .grad:
  1. with `max_gn`, clip_by_global_norm: when the global norm g_norm of the
     gradients is >= max_gn, every gradient becomes (g / g_norm) * max_gn,
     and below it they stay as they are (torch's clip_grad_norm_ divides
     by g_norm + 1e-6 instead);
  2. adam and sgd: add_decayed_weights, g + weight_decay * p, before the
     step (what torch's Adam and SGD weight_decay do);
  3. the step: adam's bias-corrected moments, mu_hat / (sqrt(nu_hat) + eps),
     or sgd's trace, g + momentum * trace;
  4. adamW: the decoupled decay weight_decay * p added to the step, for
     every parameter alike (optax masks none: LayerNorm scales, biases and
     embeddings decay too);
  5. the update -lr * step, with lr = schedule(n) for update n counted
     from 0, so a schedule that starts from zero leaves the parameters of
     the first update as they were and moves only the moments.
The moments are kept beside each parameter in its dtype (fp32 for the
trainer's fp32 master weights). The arithmetic runs as foreach kernels
over chunks of at most CHUNK_ELEMENTS elements, so that its temporaries
stay small beside the moments. After step(), each .grad holds the
gradient as clipped.
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch

OPTIMIZERS = ("adamw", "adam", "sgd")
ADAM_EPS = 1e-8  # optax.adam's eps (eps_root 0)
CHUNK_ELEMENTS = 1 << 26  # 256 MB of fp32 temporaries at a time


def global_norm(tensors) -> torch.Tensor:
    """The square root of the sum of squares of every element
    (optax.global_norm), as an fp32 0-d tensor. Each tensor's norm is
    accumulated in fp64: the CPU's fp32 norm of a 25M-element tensor
    drifts by about 1e-3."""
    norms = torch._foreach_norm(list(tensors), 2, dtype=torch.float64)
    return torch.linalg.vector_norm(torch.stack(norms)).float()


def _chunks(params: list, limit: int = CHUNK_ELEMENTS) -> list[list[int]]:
    """Consecutive index runs of `params` of at most `limit` elements each
    (a larger tensor alone)."""
    runs, run, size = [], [], 0
    for i, p in enumerate(params):
        if run and size + p.numel() > limit:
            runs.append(run)
            run, size = [], 0
        run.append(i)
        size += p.numel()
    if run:
        runs.append(run)
    return runs


class Optimizer(torch.optim.Optimizer):
    """One parameter group; `kind` is "adamw", "adam" or "sgd" (module
    docstring). The group's `count` is the number of updates applied."""

    def __init__(
        self,
        params: Iterable[torch.Tensor],
        schedule: Callable[[int], float],
        kind: str = "adamw",
        betas=(0.9, 0.999),
        weight_decay: float = 0.0,
        momentum: float = 0.9,
        max_gn: float | None = None,
    ):
        kind = kind.lower()
        if kind not in OPTIMIZERS:
            raise ValueError(f"{kind} invalid: the optimizers are {OPTIMIZERS}")
        defaults = dict(kind=kind, betas=tuple(betas), weight_decay=float(weight_decay), momentum=float(momentum),
                        max_gn=None if max_gn is None else float(max_gn), count=0)
        super().__init__(params, defaults)
        if len(self.param_groups) != 1:
            raise ValueError("Optimizer takes one parameter group: every parameter is treated alike")
        self.schedule = schedule
        self._runs = _chunks(self.param_groups[0]["params"])

    def _moment(self, p: torch.Tensor, name: str) -> torch.Tensor:
        state = self.state[p]
        if name not in state:
            state[name] = torch.zeros_like(p, memory_format=torch.preserve_format)
        return state[name]

    @torch.no_grad()
    def step(self) -> None:
        group = self.param_groups[0]
        params = group["params"]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        kind, wd, n = group["kind"], group["weight_decay"], group["count"]
        lr = float(self.schedule(n))
        if group["max_gn"] is not None:
            g_norm = float(global_norm(grads))
            if g_norm >= group["max_gn"]:
                torch._foreach_div_(grads, g_norm)
                torch._foreach_mul_(grads, group["max_gn"])
        b1, b2 = group["betas"]
        for run in self._runs:
            ps, gs = [params[i] for i in run], [grads[i] for i in run]
            if kind != "adamw" and wd:
                gs = torch._foreach_add(gs, ps, alpha=wd)
            if kind == "sgd":
                trace = [self._moment(p, "trace") for p in ps]
                torch._foreach_mul_(trace, group["momentum"])
                torch._foreach_add_(trace, gs)
                update = torch._foreach_mul(trace, -lr)
            else:
                mu, nu = [self._moment(p, "mu") for p in ps], [self._moment(p, "nu") for p in ps]
                torch._foreach_mul_(mu, b1)
                torch._foreach_add_(mu, gs, alpha=1.0 - b1)
                torch._foreach_mul_(nu, b2)
                torch._foreach_addcmul_(nu, gs, gs, value=1.0 - b2)
                denom = torch._foreach_div(nu, 1.0 - b2 ** (n + 1))
                torch._foreach_sqrt_(denom)
                torch._foreach_add_(denom, ADAM_EPS)
                update = torch._foreach_div(mu, 1.0 - b1 ** (n + 1))
                torch._foreach_div_(update, denom)
                del denom
                if kind == "adamw" and wd:
                    torch._foreach_add_(update, ps, alpha=wd)
                torch._foreach_mul_(update, -lr)
            torch._foreach_add_(ps, update)
        group["count"] = n + 1


def create_optimizer(optim_config, schedule: Callable[[int], float], params: Iterable[torch.Tensor]) -> Optimizer:
    """The optimizer of a config's `optimizer` dict (type adamW / adam /
    sgd, betas, weight_decay, momentum, max_gn) over `params`."""
    return Optimizer(
        params,
        schedule,
        kind=optim_config["type"],
        betas=optim_config.get("betas", (0.9, 0.999)),
        weight_decay=float(optim_config.get("weight_decay", 0.0)),
        momentum=optim_config.get("momentum", 0.9),
        max_gn=optim_config.get("max_gn", None),
    )
