"""The launch plan and the launch of csrc/dense_mlp.cu: the decode MLP
alone, one persistent launch on the machinery of csrc/decode_dense.cu.

Two forms of one kernel (the source note says what bounds them on the
H100 and how the design answers that):
- "mlp" (#15, tools/exp_mlp_kernel.py::pallas_mlp): out = bf16((x + t @
  w2^T) + b2), t = bf16(gelu(bf16(LN(x)) @ w1^T + b1)), bf16 weights, fp32
  LayerNorm parameters; its wrapper is ops/mlp_kernel.py::fused_mlp;
- "ring" (#20, tools/exp_q8_pipeline.py::ablate_ring): out = bf16(t @
  w2^T), t = bf16(gelu?(h @ w1^T * s1?)), int8 or bf16 packed weights; its
  wrapper is ops/q8_pipeline_kernel.py::ablate_ring.

The contract is that of decode_dense.cu's fused_proj_mlp (#3, #6): C in
decode_layer_kernel.WIDTHS, H = 4C, M >= 1; "ring" also a packed chunk
with chunk % 64 == 0 (a 64-wide tile of the packed w2 lies in one chunk).
Anything else raises ValueError before the kernel library or the device
is asked. One launch of the kernel at a time per device (its grid
barrier's counters), so the scratch is kept per device and plan: a CUDA
graph finds it at the same addresses.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from rqvae_tpu_torch.ops import _build
from rqvae_tpu_torch.ops import decode_layer_kernel as DK

FORMS = ("mlp", "ring")
ROW_TILES = (8, 16, 24, 32, 40, 48, 64, 80, 104, 128, 160, 192, 256)  # csrc/dense_mlp.cu RQ_TILES_DENSE_MLP
MIN_T_SLOTS = 2  # a t slot is refilled only after the unit before it was released
SPLIT_ROWS = 160  # csrc/dense_mlp.cu halves(): larger row tiles are split between the two consumer warpgroups


def smem_bytes(mt: int, k_slice: int, stages: int, t_slots: int, wbytes: int) -> int:
    """Dynamic shared memory of the kernel (csrc/dense_mlp.cu mlp_layout):
    decode_dense's layout with weight tiles alone in the ring and phase B's
    t_slots t tiles of mt x 64 bf16 in the panel's bytes."""
    return DK._smem_bytes(mt, k_slice, stages, False, wbytes, t_slots * mt * DK._BK * 2)


def w2_coords(chunk: int, C: int, k0: int, c0: int) -> tuple[int, int]:
    """The tensor-map coordinates (column, row) at which the kernel's
    producer reads the 64 x 64 tile of w2's output channels c0 .. c0 + 63
    and reduction elements k0 .. k0 + 63: (k0, c0) in w2 [C, H] (chunk 0);
    (k0 mod chunk, (k0 div chunk) C + c0) in the packed w2 [nc, C, chunk]
    seen as the matrix [nc C, chunk]."""
    if chunk == 0:
        return k0, c0
    return k0 % chunk, (k0 // chunk) * C + c0


@dataclass(frozen=True)
class MlpPlan:
    """One launch of csrc/dense_mlp.cu: `clusters` clusters of `cluster`
    CTAs (CTA b is rank b % cluster of cluster b // cluster), activation row
    tiles of `row_tile` rows (`row_tiles` of them, row_tiles * row_tile >=
    M), a ring of `stages` weight tiles of `wbytes`-byte elements, `t_slots`
    t tiles in the panel's bytes, `smem` bytes of dynamic shared memory;
    `chunk` the packed w2's chunk ("ring"; 0 for w2 [C, H])."""

    form: str
    M: int
    C: int
    H: int
    wbytes: int
    chunk: int
    cluster: int
    clusters: int
    row_tile: int
    row_tiles: int
    stages: int
    t_slots: int
    smem: int

    def products(self) -> list[tuple[int, int]]:
        """(weight row tiles, reduction length) of w1's and w2's products."""
        return [(self.H // DK._TILE, self.C), (self.C // DK._TILE, self.H)]

    units = DK.DensePlan.units

    def weight_passes(self) -> int:
        """How many times a call streams each weight tile: once per row tile."""
        return self.row_tiles


def _check(M: int, C: int, H: int, form: str, wbytes: int, chunk: int) -> None:
    """The contract (module docstring); ValueError otherwise."""
    if form not in FORMS or wbytes not in ((2,) if form == "mlp" else (1, 2)):
        raise ValueError(f"dense_mlp: form 'mlp' takes bf16 weights, 'ring' int8 or bf16; got {form!r} with "
                         f"{wbytes}-byte weights")
    if C not in DK.WIDTHS or H != 4 * C or M < 1:
        raise ValueError(f"dense_mlp: needs C in {DK.WIDTHS}, H = 4C and M >= 1, got M={M}, C={C}, H={H}")
    if form == "ring" and (chunk <= 0 or chunk % DK._BK or H % chunk):
        raise ValueError(f"dense_mlp: the packed w2's chunk must divide H and be a multiple of {DK._BK}, got "
                         f"chunk={chunk}, H={H}")


def _ring(mt: int, k_slice: int, wbytes: int):
    """(stages, t_slots, smem) of a row tile mt and a K-slice: t_slots the t
    tiles the panel's bytes hold (at least MIN_T_SLOTS), then as many ring
    stages as fit, up to 16 (at least 4; t_slots no more than the stages);
    None when not even four fit."""
    t_slots = max(MIN_T_SLOTS, k_slice // DK._BK)
    lo, hi = DK._STAGES
    for stages in range(hi, lo - 1, -1):
        slots = min(t_slots, stages)
        smem = smem_bytes(mt, k_slice, stages, slots, wbytes)
        if smem <= DK.SMEM_LIMIT:
            return stages, slots, smem
    return None


def mlp_plan(M: int, C: int, H: int, form: str, wbytes: int, chunk: int = 0, sms: int = DK.SMS,
             max_clusters=None) -> MlpPlan:
    """The launch plan of the kernel for M rows: for each cluster size s (C
    / s a multiple of 64), the fewest row tiles (of the built sizes) whose
    shared memory fits (_ring); at most sms // s
    clusters (one wave), no more than w1 has tiles, nor than
    max_clusters(form, row_tile, s, smem) when given. Of those, the one
    whose busiest CTA streams the fewest bytes: its weight tiles and phase
    B's t tiles, each cluster reduction priced at decode_layer_kernel.
    _ROUND_BYTES; ties go to the smaller cluster. ValueError outside the
    contract."""
    _check(M, C, H, form, wbytes, chunk)
    best, best_cost = None, None
    for s in DK.CLUSTER_SIZES:
        if C % (DK._BK * s):
            continue
        fit = None
        for n_rt in range(1, M + 1):
            mt = next((t for t in ROW_TILES if t >= -(-M // n_rt)), None)
            if mt is None:
                continue
            ring = _ring(mt, C // s, wbytes)
            if ring is not None:
                fit = (mt, n_rt, *ring)
                break
            if mt == ROW_TILES[0]:
                break
        if fit is None:
            continue
        mt, n_rt, stages, t_slots, smem = fit
        G = min(sms // s, H // DK._TILE)
        if max_clusters is not None:
            G = min(G, max_clusters(form, mt, s, smem))
        if G < 1:
            continue
        tile = DK._TILE * DK._BK * wbytes
        t_tile = mt * DK._BK * 2
        cost = n_rt * (-(-(H // DK._TILE) // G) * ((C // s // DK._BK) * tile + DK._ROUND_BYTES)
                       + -(-(C // DK._TILE) // G) * ((H // s // DK._BK) * (tile + t_tile) + DK._ROUND_BYTES))
        if best is None or cost < best_cost:
            best = MlpPlan(form, M, C, H, wbytes, chunk if form == "ring" else 0, s, G, mt, n_rt, stages, t_slots,
                           smem)
            best_cost = cost
    if best is None:
        raise ValueError(f"dense_mlp: no launch plan fits M={M}, C={C}, H={H}")
    return best


def _device_plan(M, C, H, form, wbytes, chunk, device) -> MlpPlan:
    """mlp_plan on this device (its SM count, its co-resident clusters),
    cached. Call with `device` current. A shape outside the contract raises
    ValueError before the device or the kernel library is asked anything."""
    key = ("dense_mlp", M, C, H, form, wbytes, chunk, device.index)
    plan = DK._plans.get(key)
    if plan is None:
        _check(M, C, H, form, wbytes, chunk)
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        plan = DK._plans[key] = mlp_plan(M, C, H, form, wbytes, chunk, sms,
                                         lambda form, mt, s, smem: max_clusters(form, mt, s, smem, wbytes))
    return plan


def max_clusters(form, mt, s, smem, wbytes) -> int:
    """How many clusters of s CTAs of the kernel (row tile mt, smem bytes of
    shared memory) the current device holds at once, from the library."""
    out = ctypes.c_int(0)
    _build.check(_build.library().rq_dense_mlp_max_clusters(int(form == "ring"), mt, s, smem, int(wbytes == 1),
                                                            ctypes.addressof(out)), "rq_dense_mlp_max_clusters")
    return out.value


def _t_scratch(x, plan: MlpPlan):
    """The t tiles [H / 64, row_tiles * row_tile, 64] bf16, kept per device
    and plan (one launch at a time per device)."""
    key = ("dense_mlp", x.get_device(), plan)
    buf = DK._scratch.get(key)
    if buf is None:
        if len(DK._scratch) >= 16:
            DK._scratch.clear()
        buf = DK._scratch[key] = torch.empty((plan.H // DK._BK, plan.row_tiles * plan.row_tile, DK._BK),
                                             dtype=torch.bfloat16, device=x.device)
    return buf


def launch(plan: MlpPlan, x, w1, w2, ln_w=None, ln_b=None, b1=None, b2=None, s1=None, gelu: int = 1,
           use_scale: bool = False):
    """One launch of csrc/dense_mlp.cu::rq_dense_mlp on checked CUDA tensors
    at `plan`: x [M, C] bf16; w1 [H, C]; w2 [C, H] ("mlp") or the packed
    [nc, C, chunk] ("ring"); "mlp": ln_w, ln_b fp32, b1, b2 bf16; "ring":
    s1 [H] bf16 (read when use_scale). gelu 0 (none), 1 (erf) or 2 (sigmoid
    form). Returns out [M, C]."""
    ring = plan.form == "ring"
    w2m = w2.reshape(-1, w2.shape[-1]) if ring else w2  # [nc * C, chunk]: the same bytes
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with DK._device(x):
        out = torch.empty_like(x)
        t = _t_scratch(x, plan)
        err = _build.library().rq_dense_mlp(
            int(ring), x.data_ptr(), DK._tensor_map(x, plan.row_tile), ptr(ln_w), ptr(ln_b),
            DK._tensor_map(w1.reshape(-1, w1.shape[-1])), ptr(b1), ptr(s1), DK._tensor_map(w2m), ptr(b2),
            out.data_ptr(), t.data_ptr(), plan.M, plan.C, plan.H, plan.chunk, plan.cluster, plan.clusters,
            plan.row_tile, plan.row_tiles, plan.stages, plan.t_slots, plan.smem, gelu, int(use_scale),
            int(plan.wbytes == 1), DK.LN_EPS, DK._stream(x),
        )
    _build.check(err, "rq_dense_mlp")
    return out


def device_plan(x, C, H, form, wbytes, chunk=0) -> MlpPlan:
    """_device_plan for x's rows on x's device (made current for the call)."""
    with DK._device(x):
        return _device_plan(x.shape[0], C, H, form, wbytes, chunk, x.device)
