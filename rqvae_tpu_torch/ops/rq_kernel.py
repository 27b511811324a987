"""Nearest codebook entry: fused fp32 L2 distance + argmin.

Counterpart of rqvae_tpu/ops/rq_kernel.py. The CUDA kernel is
csrc/nearest_code.cu (its source note says what bounds it on the H100 and
how the design answers that); this module holds its wrapper and the plain
PyTorch version of the same function.

Contract (both versions): for x [..., dim] and a codebook [n_embed, dim],
code = argmin_e ||c_e||^2 - 2 <x, c_e> in fp32 (the ||x||^2 term is left out,
as in the JAX kernel: it does not move the argmin), the first (lowest) index
on ties, as torch.long of shape x.shape[:-1]. Both cast x and the codebook
to fp32 first. Neither computes in TF32: the plain version raises on CUDA
when torch.backends.cuda.matmul.allow_tf32 is on, and sets nothing global.
The TPU kernel's padding to 256-row and 2048-code tiles and its FLT_MAX/2
padded codes are not carried over: the CUDA kernel masks its own edges.
"""

from __future__ import annotations

import torch

from rqvae_tpu_torch.ops import _build

CODE_TILE = 128  # codes per tile of csrc/nearest_code.cu (kBN)
TILES_PER_SPLIT = 4  # code tiles each block walks: E = 16384 gives 32 splits


def require_fp32_matmul(t: torch.Tensor, name: str) -> None:
    """Raise if a float32 product on t's device would run in TF32."""
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            f"{name}: torch.backends.cuda.matmul.allow_tf32 is on, so the fp32 distances would "
            "be TF32; code indices need full fp32 (set it to False)"
        )


def nearest_code_plain(x2d: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version, as the JAX _nearest_code_xla: x2d [N, dim] ->
    codes [N] (torch.long)."""
    require_fp32_matmul(x2d, "nearest_code_plain")
    x32, cb32 = x2d.float(), codebook.float()
    cb_sq = cb32.square().sum(dim=-1)
    return torch.argmin(cb_sq - 2.0 * (x32 @ cb32.T), dim=-1)


def splits(n_embed: int) -> int:
    """Blocks along the codebook axis of one launch (csrc/nearest_code.cu)."""
    tiles = -(-n_embed // CODE_TILE)
    return -(-tiles // TILES_PER_SPLIT)


def nearest_code(x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Kernel wrapper: codes [...] (torch.long) of x [..., dim] against
    codebook [n_embed, dim]. The plain version for CPU tensors; for CUDA
    tensors it launches csrc/nearest_code.cu or raises. One launch adds one
    to `nearest_code.launches`."""
    lead = x.shape[:-1]
    if x.device.type == "cpu":
        return nearest_code_plain(x.reshape(-1, x.shape[-1]), codebook).reshape(lead)
    if x.device.type != "cuda":
        raise ValueError(f"nearest_code: no kernel for device {x.device}")
    if codebook.device != x.device:
        raise ValueError(f"nearest_code: codebook on {codebook.device}, x on {x.device}")
    if codebook.dim() != 2 or codebook.shape[1] != x.shape[-1] or codebook.shape[0] == 0:
        raise ValueError(
            f"nearest_code: codebook must be [n_embed >= 1, {x.shape[-1]}], got {tuple(codebook.shape)}"
        )
    x2d = x.reshape(-1, x.shape[-1]).float().contiguous()
    cb = codebook.float().contiguous()
    N, dim = x2d.shape
    E = cb.shape[0]
    if max(N * dim, E * dim) >= 2**31:
        raise ValueError(f"nearest_code: x [{N}, {dim}] or codebook [{E}, {dim}] too large for int32 indexing")
    code = torch.empty(N, dtype=torch.long, device=x.device)
    if N == 0:
        return code.reshape(lead)
    s = splits(E)
    cb_sq = torch.empty(E, dtype=torch.float32, device=x.device)
    part_d = torch.empty(s, N, dtype=torch.float32, device=x.device)
    part_e = torch.empty(s, N, dtype=torch.int32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rq_nearest_code(
            x2d.data_ptr(), cb.data_ptr(), cb_sq.data_ptr(), part_d.data_ptr(), part_e.data_ptr(),
            code.data_ptr(), N, E, dim, TILES_PER_SPLIT, stream,
        )
    _build.check(err, "rq_nearest_code")
    nearest_code.launches += 1
    return code.reshape(lead)


nearest_code.launches = 0
