"""Nearest codebook entry: fused fp32-accurate L2 distance + argmin.

Counterpart of rqvae_tpu/ops/rq_kernel.py. The CUDA kernel is
csrc/nearest_code.cu (3xTF32 products on wgmma, operands by TMA through a
shared-memory ring; its source note says what bounds it on the H100 and
how the design answers that); this module holds its wrapper, its launch
plan (`nearest_plan`) and the plain PyTorch version of the same function.

Contract (both versions): for x [..., dim] and a codebook [n_embed, dim],
code = argmin_e ||c_e||^2 - 2 <x, c_e> with fp32 accuracy (the ||x||^2
term is left out, as in the JAX kernel: it does not move the argmin), the
first (lowest) index on ties, as torch.long of shape x.shape[:-1]. Both
cast x and the codebook to fp32 first. The kernel splits each operand into
two TF32 parts itself (`split_tf32` restates the split) and sums three
products; it need not equal the plain version bit for bit, but two equal
codebook rows get equal distances. Neither version depends on torch's TF32
flags: the plain version raises on CUDA when
torch.backends.cuda.matmul.allow_tf32 is on, and sets nothing global. The
TPU kernel's padding to 256-row and 2048-code tiles and its FLT_MAX/2
padded codes are not carried over: the CUDA kernel masks its own edges.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from rqvae_tpu_torch.ops import _build
from rqvae_tpu_torch.ops import decode_layer_kernel as DK

# csrc/nearest_code.cu
ROW_TILE = 128  # x rows per unit: two consumer warpgroups of 64 (kRowBlock)
CODE_TILE = 256  # codes per unit: the wgmma N (kCodeTile)
K_STAGE = 32  # fp32 per 128-byte swizzled row of a ring stage (kKStage)
RING = 2  # ring stages (kRing)


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


def split_tf32(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of fp32 v as csrc/nearest_code.cu's split_kernel makes them:
    hi = v rounded to TF32 (10 mantissa bits, to nearest, ties away from
    zero: cvt.rna.tf32.f32), lo = v - hi rounded the same way. Plain torch,
    for the tests."""
    def rna(t):
        u = t.contiguous().view(torch.int32)
        return ((u + 0x1000) & ~0x1FFF).view(torch.float32)

    v = v.float()
    hi = rna(v)
    return hi, rna(v - hi)


def splits(n_embed: int) -> int:
    """Partials per row of one launch: one per code tile of CODE_TILE codes."""
    return -(-n_embed // CODE_TILE)


def smem_bytes() -> int:
    """Dynamic shared memory of nearest_kernel: RING stages of x_hi, x_lo
    [ROW_TILE, K_STAGE] and cb_hi, cb_lo [CODE_TILE, K_STAGE] fp32, the full
    and empty mbarriers, 1024 bytes of alignment slack (kSmem)."""
    return RING * (2 * ROW_TILE + 2 * CODE_TILE) * K_STAGE * 4 + 2 * RING * 8 + 1024


@dataclass(frozen=True)
class NearestPlan:
    """One launch of csrc/nearest_code.cu for x [N, dim] against E codes:
    units (row block, code tile), unit u = (u mod row_blocks, u div
    row_blocks), walked by a persistent grid of `grid` CTAs (CTA b takes u
    = b, b + grid, ...); ldk = dim rounded up to K_STAGE."""

    N: int
    E: int
    dim: int
    ldk: int
    row_blocks: int
    code_tiles: int
    grid: int

    def units(self, cta: int):
        """(row block, code tile) of each unit CTA `cta` computes, in order."""
        for u in range(cta, self.row_blocks * self.code_tiles, self.grid):
            yield u % self.row_blocks, u // self.row_blocks

    def scratch(self) -> dict[str, tuple[int, ...]]:
        """Shapes of the wrapper's scratch: the split operands (hi in columns
        [0, ldk), lo in [ldk, 2 ldk)), cb_sq padded to whole code tiles, the
        per-(code tile, row) partial distances and codes."""
        return {"xs": (self.N, 2 * self.ldk), "cs": (self.E, 2 * self.ldk),
                "cb_sq": (self.code_tiles * CODE_TILE,), "part": (self.code_tiles, self.N)}


def nearest_plan(N: int, E: int, dim: int, sms: int = DK.SMS) -> NearestPlan:
    """The launch plan for N >= 1 rows, E >= 1 codes of width dim >= 1: one
    CTA an SM (shared memory holds one), none idle when there are fewer
    units than SMs."""
    if min(N, E, dim) < 1:
        raise ValueError(f"nearest_plan: needs N, E, dim >= 1, got {N}, {E}, {dim}")
    row_blocks, code_tiles = -(-N // ROW_TILE), splits(E)
    return NearestPlan(N, E, dim, -(-dim // K_STAGE) * K_STAGE, row_blocks, code_tiles,
                       min(sms, row_blocks * code_tiles))


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
    code = torch.empty(N, dtype=torch.long, device=x.device)
    if N == 0:
        return code.reshape(lead)
    plan = nearest_plan(N, E, dim, torch.cuda.get_device_properties(x.device).multi_processor_count)
    if max(N, E) * 2 * plan.ldk >= 2**31:
        raise ValueError(f"nearest_code: x [{N}, {dim}] or codebook [{E}, {dim}] too large for int32 indexing")
    shapes = plan.scratch()
    split = torch.empty(N + E, 2 * plan.ldk, dtype=torch.float32, device=x.device)
    xs, cs = split[:N], split[N:]
    cb_sq = torch.empty(shapes["cb_sq"], dtype=torch.float32, device=x.device)
    part_d = torch.empty(shapes["part"], dtype=torch.float32, device=x.device)
    part_e = torch.empty(shapes["part"], dtype=torch.int32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.rq_nearest_code(
            x2d.data_ptr(), cb.data_ptr(), xs.data_ptr(), cs.data_ptr(), DK._tensor_map(xs, ROW_TILE),
            DK._tensor_map(cs, CODE_TILE), cb_sq.data_ptr(), part_d.data_ptr(), part_e.data_ptr(), code.data_ptr(),
            N, E, dim, plan.ldk, plan.grid, torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "rq_nearest_code")
    nearest_code.launches += 1
    return code.reshape(lead)


nearest_code.launches = 0
