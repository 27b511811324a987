"""The distributed runtime: the process group, each rank's device, and the
collectives the trainers run.

Port of rqvae_tpu/parallel/dist.py. The reference trained with DDP over
NCCL, launched by torch.distributed.launch (rqvae/utils/dist.py:20-103);
the JAX package shards the global batch over a (data,) mesh and lets
GSPMD insert the reductions. Here a rank is a process with one device,
started by torchrun, and its loader shard is its share of the global
batch. `initialize` joins the group that torchrun's environment (or the
caller's arguments) describes; without either it makes none, and every
helper below is then the identity.

A step is the global step, as the JAX package's: the trainers sum or
average across ranks where one process on the whole batch would sum or
average over it (gradients, metrics, the codebooks' EMA counts and sums,
the discriminator's BatchNorm statistics). The helpers take a DistEnv,
or None for no group, and reduce a list of tensors in a few flat buckets
with one collective each, in place. The tensor-parallel model's
collectives (group_sum, group_gather_last, group_gather_first) take a
process group instead, the model or the data group of a parallel/mesh.py
Mesh, or None for the identity.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist

from rqvae_tpu_torch import resolve_device

BUCKET_BYTES = 64 << 20  # the most a flat bucket holds: one collective each


@dataclasses.dataclass
class DistEnv:
    world_size: int  # ranks, one device each
    world_rank: int
    local_rank: int
    num_processes: int
    master: bool
    device_name: str
    group: Any = None  # the process group, None when there is none

    @property
    def TOTAL_GPU(self):  # reference-compat alias (dist.py:23)
        return self.world_size

    @property
    def device(self) -> torch.device:
        return torch.device(self.device_name)


def _env_int(name: str) -> Optional[int]:
    return int(os.environ[name]) if name in os.environ else None


def initialize(backend: Optional[str] = None, init_method: Optional[str] = None, rank: Optional[int] = None,
               world_size: Optional[int] = None, device=None) -> DistEnv:
    """Join the process group that torchrun's RANK / WORLD_SIZE / LOCAL_RANK
    / MASTER_ADDR / MASTER_PORT (or the arguments) describe; with neither,
    world 1 and no group. The rank's device is cuda:LOCAL_RANK unless
    `device` names one (device="cpu" for the CPU); the backend is nccl on
    CUDA and gloo on the CPU unless `backend` names one (gloo also carries
    CUDA tensors, so two ranks may share one card)."""
    rank = _env_int("RANK") if rank is None else rank
    world_size = _env_int("WORLD_SIZE") if world_size is None else world_size
    if rank is None and world_size is None and init_method is None:
        return DistEnv(1, 0, 0, 1, True, str(resolve_device(device)))
    if rank is None or world_size is None:
        raise ValueError(f"a process group needs a rank and a world size (got rank {rank}, world size {world_size})")
    local_rank = _env_int("LOCAL_RANK")
    local_rank = rank if local_rank is None else local_rank
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("rank devices are cuda:LOCAL_RANK by default and torch.cuda.is_available() is False; "
                               "pass device='cpu' to train on the CPU")
        device = torch.device("cuda", local_rank)
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method or "env://", rank=rank, world_size=world_size)
    return DistEnv(world_size, rank, local_rank, world_size, rank == 0, str(device), dist.group.WORLD)


def active(env: Optional[DistEnv]) -> bool:
    """Whether env holds a process group (at any world size, 1 included)."""
    return env is not None and env.group is not None


def backend_name(env: Optional[DistEnv]) -> str:
    """The group's backend, or "no group"."""
    return dist.get_backend(env.group) if active(env) else "no group"


def world(env: Optional[DistEnv]) -> int:
    return env.world_size if active(env) else 1


def rank(env: Optional[DistEnv]) -> int:
    return env.world_rank if active(env) else 0


def is_master(env: Optional[DistEnv]) -> bool:
    return rank(env) == 0


def _buckets(tensors: Sequence[torch.Tensor]) -> list[list[int]]:
    """Indices of `tensors` in runs of one dtype and device, each run at
    most BUCKET_BYTES (a larger tensor alone)."""
    out, cur, size, key = [], [], 0, None
    for i, t in enumerate(tensors):
        k = (t.dtype, t.device)
        nbytes = t.numel() * t.element_size()
        if cur and (k != key or size + nbytes > BUCKET_BYTES):
            out.append(cur)
            cur, size = [], 0
        cur.append(i)
        size += nbytes
        key = k
    if cur:
        out.append(cur)
    return out


def _bucketed(tensors: Sequence[torch.Tensor], collective) -> list[torch.Tensor]:
    """collective(flat) on each bucket's flat copy, written back in place."""
    tensors = list(tensors)
    for idx in _buckets(tensors):
        if len(idx) == 1 and tensors[idx[0]].is_contiguous():
            collective(tensors[idx[0]])
            continue
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        collective(flat)
        offset = 0
        for i in idx:
            n = tensors[i].numel()
            tensors[i].copy_(flat[offset : offset + n].view_as(tensors[i]))
            offset += n
    return tensors


def all_reduce_sum(tensors: Sequence[torch.Tensor], env: Optional[DistEnv]) -> list[torch.Tensor]:
    """Each tensor summed over the ranks, in place."""
    if not active(env):
        return list(tensors)
    return _bucketed(tensors, lambda flat: dist.all_reduce(flat, group=env.group))


def all_reduce_mean(tensors: Sequence[torch.Tensor], env: Optional[DistEnv]) -> list[torch.Tensor]:
    """Each tensor averaged over the ranks (summed, then divided by the
    world size), in place."""
    tensors = all_reduce_sum(tensors, env)
    if active(env):
        torch._foreach_div_(tensors, float(env.world_size))
    return tensors


def mean_metrics(metrics: dict, env: Optional[DistEnv]) -> dict:
    """A dict of fp32 metric tensors averaged over the ranks in one
    collective (the dict itself when there is no group)."""
    if not active(env):
        return metrics
    keys = list(metrics)
    flat = torch.cat([metrics[k].detach().float().reshape(-1) for k in keys])
    all_reduce_mean([flat], env)
    out, offset = {}, 0
    for k in keys:
        n = metrics[k].numel()
        out[k] = flat[offset : offset + n].view(metrics[k].shape)
        offset += n
    return out


def broadcast(tensors: Sequence[torch.Tensor], env: Optional[DistEnv], src: int = 0) -> list[torch.Tensor]:
    """Rank src's tensors on every rank, in place."""
    if not active(env):
        return list(tensors)
    return _bucketed(tensors, lambda flat: dist.broadcast(flat, src=src, group=env.group))


def all_gather_cat(x: torch.Tensor, env: Optional[DistEnv]) -> torch.Tensor:
    """Every rank's x (one shape on every rank) concatenated along dim 0 in
    rank order (the reference's all_gather_cat, dist.py:94-103)."""
    return group_gather_first(x, env.group if active(env) else None)


def barrier(env: Optional[DistEnv]) -> None:
    """Every rank waits for the others (a one-element all-reduce on the
    rank's device, which every backend carries)."""
    if active(env):
        dist.all_reduce(torch.zeros(1, device=env.device), group=env.group)


def broadcast_object(obj, env: Optional[DistEnv], src: int = 0):
    """Rank src's picklable object on every rank."""
    if not active(env):
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=env.group, device=env.device)
    return box[0]


class _SumOverRanks(torch.autograd.Function):
    """x summed over the ranks; the gradient of each rank's sum is the sum
    of every rank's incoming gradient, so the backward is the same sum."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def sum_over_ranks(x: torch.Tensor, env: Optional[DistEnv]) -> torch.Tensor:
    """x summed over the ranks, differentiably: a loss on any rank that
    reads the sum sends its gradient to every rank's x (the global batch's
    statistics in the discriminator's BatchNorm). Every rank must run the
    forward and the backward in the same order."""
    if not active(env):
        return x
    return _SumOverRanks.apply(x, env.group)


def _sum_dtype(x: torch.Tensor) -> torch.dtype:
    """fp32 for bf16 and fp16 (a sum of partial products in bf16 would
    round once more than the unsharded product does), else x's dtype."""
    return torch.float32 if x.dtype in (torch.bfloat16, torch.float16) else x.dtype


def _exchange(x: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's x (one shape on every rank) in the group's rank order,
    as host tensors: each rank sends its x to every other rank of the group
    and receives theirs, point to point, in x's dtype. Gloo's
    point-to-point ops take host tensors only, so a CUDA x and the parts
    received are staged through pinned host memory (their copies to the
    card then run asynchronously). Between processes that share one card
    one exchange costs less than gloo's all-reduce of the CUDA tensor, a
    ring of two steps with the copies inside it."""
    ranks = dist.get_process_group_ranks(group)
    me = dist.get_rank(group)
    parts = [torch.empty(x.shape, dtype=x.dtype, pin_memory=x.is_cuda) for _ in ranks]
    parts[me].copy_(x)
    reqs = [dist.isend(parts[me], ranks[i], group=group) for i in range(len(ranks)) if i != me]
    reqs += [dist.irecv(parts[i], ranks[i], group=group) for i in range(len(ranks)) if i != me]
    for req in reqs:
        req.wait()
    return parts


def group_sum(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over the ranks of `group` (a process group, or None for the
    identity), in x's dtype; bf16 and fp16 are summed in fp32. The
    tensor-parallel model sums its row-parallel products with it. Every
    rank adds the parts in the group's rank order, so all hold the same
    bits. Under gloo (the CPU, or ranks that share one card: NCCL refuses
    two ranks on one card) the parts travel by _exchange in x's dtype;
    under NCCL by its all-reduce in the sum's dtype."""
    if group is None:
        return x
    acc = _sum_dtype(x)
    if dist.get_backend(group) != "gloo":
        wide = x.to(acc, copy=True)
        dist.all_reduce(wide, group=group)
        return wide.to(x.dtype)
    parts = [p.to(x.device, non_blocking=True) for p in _exchange(x, group)]
    out = parts[0].to(acc)
    for p in parts[1:]:
        out = out + p.to(acc)
    return out.to(x.dtype)


def group_gather_last(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's x (one shape on every rank) concatenated along the last
    dim in the group's rank order (the identity for group None): the
    vocabulary slices of the tensor-parallel classifier."""
    if group is None:
        return x
    return torch.cat(_gather(x.contiguous(), group), dim=-1)


def group_gather_first(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's x concatenated along dim 0 in the group's rank order
    (the identity for group None): the batch shards of the data axis."""
    if group is None:
        return x
    return torch.cat(_gather(x.contiguous(), group))


def _gather(x: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's x on x's device, in the group's rank order."""
    if dist.get_backend(group) != "gloo":
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return parts
    return [p.to(x.device, non_blocking=True) for p in _exchange(x, group)]


def shutdown(env: Optional[DistEnv]) -> None:
    """Leave the process group when there is one."""
    if active(env) and dist.is_initialized():
        dist.destroy_process_group()
