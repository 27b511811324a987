"""The (data, model) grid of ranks and the sharding rules.

Port of rqvae_tpu/parallel/mesh.py. There a jax.sharding.Mesh of devices
carries PartitionSpecs and GSPMD inserts the collectives; here a rank is a
process with one device, the grid is two families of process groups, and
the tensor-parallel model calls its collectives itself
(models/rqtransformer/model.py). The `model` axis splits the
RQ-Transformer Megatron-style: the query, key, value and first MLP
projections by output features (column-parallel), the attention output and
second MLP projections by input features (row-parallel, their outputs
summed over the model group), the classifiers by vocabulary. Rank r sits
at data coordinate r // n_model and model coordinate r % n_model.

A spec here is, for each key of the port's state_dict, the dim split over
the model axis or None for a replicated tensor. The port's nn.Linear
weights are [out, in], so JAX's P(None, MODEL) kernel [in, out] is dim 0
here and its P(MODEL, None) dim 1.

ZeRO-1: each optimizer moment is split over the data axis on its first dim
that the data size divides and that is at least as long
(zero_opt_state_specs); optim/optimizer.py keeps and updates each rank's
slice.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Optional

import torch
import torch.distributed as dist

from rqvae_tpu_torch.parallel import dist as D

@dataclasses.dataclass
class Mesh:
    """This rank's place in the (data, model) grid and its two groups: the
    ranks that share its data coordinate (`model_group`, over which the
    model is split) and those that share its model coordinate
    (`data_group`, over which the batch is split). A group of one rank is
    None, and its collectives are the identity."""

    n_data: int
    n_model: int
    data_rank: int
    model_rank: int
    data_group: Any = None
    model_group: Any = None


def create_mesh(n_data: Optional[int] = None, n_model: int = 1, env: Optional[D.DistEnv] = None) -> Mesh:
    """The grid of n_data x n_model ranks over env's group (world 1 without
    one); n_data defaults to the world size over n_model. Every rank of
    the world must call it alike: each family's groups are made in one
    order on every rank."""
    world = D.world(env)
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world or n_data < 1 or n_model < 1:
        raise ValueError(f"mesh {n_data}x{n_model} != {world} ranks")
    d, m = divmod(D.rank(env), n_model)
    data_group = model_group = None
    if D.active(env):
        for dd in range(n_data):  # each row of the grid: one model group
            g = dist.new_group([dd * n_model + mm for mm in range(n_model)])
            if dd == d and n_model > 1:
                model_group = g
        for mm in range(n_model):  # each column: one data group
            g = dist.new_group([dd * n_model + mm for dd in range(n_data)])
            if mm == m and n_data > 1:
                data_group = g
    return Mesh(n_data, n_model, d, m, data_group, model_group)


# (pattern of a state_dict key, the dim split over the model axis)
_STACK_RULES = (
    (r"attn\.(query|key|value)\.(weight|bias)", 0),  # column-parallel
    (r"attn\.proj\.weight", 1),  # row-parallel; its bias is replicated
    (r"mlp\.0\.(weight|bias)", 0),
    (r"mlp\.2\.weight", 1),
)
_STACK_KEY = re.compile(r"(body|head)_transformer\.blocks\.\d+\.(.*)")


def param_spec(key: str, ndim: int) -> Optional[int]:
    """The dim of state_dict tensor `key` (of `ndim` dims) split over the
    model axis, or None (transformer_param_specs)."""
    stack = _STACK_KEY.fullmatch(key)
    if stack:
        return next((dim for pattern, dim in _STACK_RULES if re.fullmatch(pattern, stack.group(2))), None)
    if key == "classifier.linear.weight":  # [V, C] shared, [D, C, V] per depth
        return 0 if ndim == 2 else 2
    if key == "classifier.linear.bias":  # [V] or [D, V]
        return ndim - 1
    if key in ("cond_classifier.linear.weight", "cond_classifier.linear.bias"):
        return 0
    return None  # LayerNorms, embeddings, positions, the embedding MLPs


def transformer_param_specs(state: dict) -> dict:
    """{key: the dim split over the model axis, or None} for every tensor of
    an RQTransformer state_dict (or of any {key: tensor} with its keys)."""
    return {k: param_spec(k, v.dim()) for k, v in state.items()}


def shard(x: torch.Tensor, dim: Optional[int], index: int, n: int) -> torch.Tensor:
    """Slice `index` of n equal slices of x along `dim` (x itself for None)."""
    if dim is None:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"a dim of {x.shape[dim]} does not split into {n} slices")
    size = x.shape[dim] // n
    return x.narrow(dim, index * size, size)


def shard_state_dict(state: dict, m: int, n_model: int) -> dict:
    """Model rank m's slice of every tensor of `state` (contiguous copies
    of the split ones, the replicated ones as they are)."""
    specs = transformer_param_specs(state)
    return {k: v if specs[k] is None else shard(v, specs[k], m, n_model).contiguous() for k, v in state.items()}


def zero_dim(shape, n_data: int) -> Optional[int]:
    """The first dim of `shape` that n_data divides and that is at least
    n_data long, or None (a scalar, or no such dim: replicated)."""
    return next((axis for axis, size in enumerate(shape) if size % n_data == 0 and size >= n_data), None)


def zero_opt_state_specs(opt_state, n_data: int):
    """ZeRO-1 specs of an optimizer state: for each tensor of a nested dict
    or list, the dim split over the data axis (zero_dim) or None; other
    leaves (step counts, hyperparameters) None."""
    if isinstance(opt_state, dict):
        return {k: zero_opt_state_specs(v, n_data) for k, v in opt_state.items()}
    if isinstance(opt_state, (list, tuple)):
        return type(opt_state)(zero_opt_state_specs(v, n_data) for v in opt_state)
    return zero_dim(opt_state.shape, n_data) if isinstance(opt_state, torch.Tensor) else None


def shard_opt_state_zero(opt_state, d: int, n_data: int):
    """Data rank d's ZeRO-1 slice of every tensor of an optimizer state (a
    nested dict or list; contiguous copies), other leaves as they are."""
    if isinstance(opt_state, dict):
        return {k: shard_opt_state_zero(v, d, n_data) for k, v in opt_state.items()}
    if isinstance(opt_state, (list, tuple)):
        return type(opt_state)(shard_opt_state_zero(v, d, n_data) for v in opt_state)
    if not isinstance(opt_state, torch.Tensor):
        return opt_state
    return shard(opt_state, zero_dim(opt_state.shape, n_data), d, n_data).contiguous()
