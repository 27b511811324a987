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

ZeRO-1 (step(zero=env)): each of env's ranks keeps and updates only its
slice of each moment, split over the ranks on its first dim that the world
size divides (parallel/mesh.py zero_dim; a tensor without one is kept
whole on every rank), from the gradient every rank already holds reduced
and clipped; the updated slices of the parameters are then all-gathered,
one collective for each run of parameters. Every operation is elementwise,
so the parameters equal the replicated step's.
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch
import torch.distributed as dist

from rqvae_tpu_torch.parallel import dist as D
from rqvae_tpu_torch.parallel.mesh import shard, zero_dim

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

    def _moment(self, p: torch.Tensor, name: str, view: torch.Tensor) -> torch.Tensor:
        """p's moment `name` for the update of `view` (p itself, or its ZeRO
        slice), made as zeros at the first step."""
        state = self.state[p]
        if name not in state:
            state[name] = torch.zeros_like(view, memory_format=torch.preserve_format)
        elif state[name].shape != view.shape:
            raise ValueError(f"a moment of shape {tuple(state[name].shape)} for {tuple(view.shape)}: the ZeRO-1 "
                             "split changed between steps")
        return state[name]

    @torch.no_grad()
    def step(self, zero: D.DistEnv | None = None) -> None:
        """One update of every parameter; with `zero` (a DistEnv over which
        the gradients are already reduced) the ZeRO-1 update (module
        docstring)."""
        group = self.param_groups[0]
        params = group["params"]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        kind, wd, count = group["kind"], group["weight_decay"], group["count"]
        lr = float(self.schedule(count))
        if group["max_gn"] is not None:
            g_norm = float(global_norm(grads))
            if g_norm >= group["max_gn"]:
                torch._foreach_div_(grads, g_norm)
                torch._foreach_mul_(grads, group["max_gn"])
        b1, b2 = group["betas"]
        n, rank = (zero.world_size, zero.world_rank) if D.world(zero) > 1 else (1, 0)
        dims = [zero_dim(p.shape, n) if n > 1 else None for p in params]
        views = [shard(p, d, rank, n) for p, d in zip(params, dims)]
        grads = [shard(g, d, rank, n) for g, d in zip(grads, dims)]
        runs = self._runs if n == 1 else _chunks(views)
        for run in runs:
            ps, gs = [views[i] for i in run], [grads[i] for i in run]

            def moments(name):
                return [self._moment(params[i], name, views[i]) for i in run]

            if kind != "adamw" and wd:
                gs = torch._foreach_add(gs, ps, alpha=wd)
            if kind == "sgd":
                trace = moments("trace")
                torch._foreach_mul_(trace, group["momentum"])
                torch._foreach_add_(trace, gs)
                update = torch._foreach_mul(trace, -lr)
            else:
                mu, nu = moments("mu"), moments("nu")
                torch._foreach_mul_(mu, b1)
                torch._foreach_add_(mu, gs, alpha=1.0 - b1)
                torch._foreach_mul_(nu, b2)
                torch._foreach_addcmul_(nu, gs, gs, value=1.0 - b2)
                denom = torch._foreach_div(nu, 1.0 - b2 ** (count + 1))
                torch._foreach_sqrt_(denom)
                torch._foreach_add_(denom, ADAM_EPS)
                update = torch._foreach_div(mu, 1.0 - b1 ** (count + 1))
                torch._foreach_div_(update, denom)
                del denom
                if kind == "adamw" and wd:
                    torch._foreach_add_(update, ps, alpha=wd)
                torch._foreach_mul_(update, -lr)
            torch._foreach_add_(ps, update)
            if n > 1:
                _gather_slices([params[i] for i in run if dims[i] is not None],
                               [dims[i] for i in run if dims[i] is not None], zero)
        group["count"] = count + 1


def _gather_slices(params: list, dims: list, env: D.DistEnv) -> None:
    """Every rank's updated ZeRO-1 slice of each parameter written into
    each rank's parameter: one all-gather of the run's slices, flat."""
    if not params:
        return
    n, rank = env.world_size, env.world_rank
    flat = torch.cat([shard(p, d, rank, n).reshape(-1) for p, d in zip(params, dims)])
    parts = [torch.empty_like(flat) for _ in range(n)]
    dist.all_gather(parts, flat, group=env.group)
    for r, part in enumerate(parts):
        offset = 0
        for p, d in zip(params, dims):
            view = shard(p, d, r, n)
            view.copy_(part[offset : offset + view.numel()].view(view.shape))
            offset += view.numel()


def moment_bytes(optimizer: torch.optim.Optimizer) -> int:
    """The bytes of every tensor in the optimizer's state on this rank."""
    return sum(t.numel() * t.element_size() for st in optimizer.state.values() for t in st.values()
               if isinstance(t, torch.Tensor))


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
