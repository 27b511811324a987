"""The W8A8 decode proj + LN2 + MLP: the counterpart of
tools/exp_w8a8.py::fused_proj_mlp_q8a8 (#16).

#6's function (ops/decode_layer_kernel.py::fused_proj_mlp_q8) with the two
MLP products taken on int8 activations too: LN2's output and each chunk
of the gelu output are quantized per row to int8, the products are s8 x s8
-> s32, and the row scale times the column scale multiplies the int32
sums. The CUDA kernel is csrc/dense_w8a8.cu (one persistent launch on
csrc/decode_dense.cu's machinery, both MLP products on s8 wgmma; its
source note says what bounds it on the H100 and how the design answers
that); `w8a8_plan` is its launch plan. Its first design, csrc/w8a8.cu,
stays as the A/B baseline `fused_proj_mlp_q8a8_v1` that only
chip_smoke.py runs. This module holds their wrappers and the plain
PyTorch version.

Contract on the card: int8 weights, C in decode_layer_kernel.WIDTHS, H =
4C, chunk a multiple of 64 dividing H, M >= 1; ValueError otherwise, from
the plan, before the kernel library or the device is asked (the first
design took any C and chunk divisible by 64 and at most 512 rows). One
launch at a time per device (the library's own grid-barrier counters), so
the scratch is kept per device and plan: a CUDA graph finds it at the same
addresses.

Rounding points (tools/exp_w8a8.py:64-103): x2 = x + cast(y @ wo^T * s_o +
bo) as #6; h = LN2(x2) in fp32, never rounded to x2's dtype; hq, hs =
_quant_rows(h); for each hidden chunk j in order, t_j = gelu(int(hq @
w1_j^T) * hs * s_1j + b1_j) in fp32, tq_j, ts_j = _quant_rows(t_j), acc +=
int(tq_j @ w2_j^T) * ts_j in fp32; out = x2 + cast(acc * s_2 + b2). The
activation scale divides before its floor, max|v| / 127 then max(., 1e-8),
the reverse of the weight quantizer's (model.quantize_weight); rounding is
half to even. `chunk` is a parameter of the result, not only a tiling: ts_j
is taken over the chunk's hidden units.

Weights in the port's nn.Linear layout: wo_q [C, C], w1_q [H, C], w2_q [C,
H], int8 with one bf16 scale per output channel (model.quantize_weight);
checkpoint/from_jax.py::q8_pipeline_weights_from_jax turns the
experiment's arrays into these.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from rqvae_tpu_torch.ops import _build
from rqvae_tpu_torch.ops import decode_layer_kernel as DK
from rqvae_tpu_torch.ops import q8_pipeline_kernel as QP

# the N values of the s8 wgmma (PTX ISA: m64nNk32 .s32.s8.s8)
S8_WGMMA_N = (8, 16, 24) + tuple(range(32, 257, 16))
# csrc/dense_w8a8.cu RQ_TILES_W8A8: s8 N values, and above SPLIT_ROWS twice
# one, a tile split between the two consumer warpgroups
ROW_TILES = (8, 16, 24, 32, 48, 64, 96, 128, 160, 192)
SPLIT_ROWS = 64


def _quant_rows(x):
    """Per-row symmetric int8 (tools/exp_w8a8.py:43): (q int8, scale fp32
    [.., 1]), s = max(max|x| / 127, 1e-8), q = clip(round(x / s), +-127)."""
    x32 = x.float()
    s = (x32.abs().amax(-1, keepdim=True) / 127.0).clamp_min(1e-8)
    return torch.round(x32 / s).clamp(-127, 127).to(torch.int8), s


def _int_mm(a, w):
    """a @ w^T for int8 a [M, K], w [N, K]: the exact integer sums (fp64
    holds them), cast to fp32 as JAX casts the int32 sums."""
    return (a.double() @ w.double().t()).float()


def q8a8_steps(x, y, wo_q, wo_s, bo, ln_scale, ln_bias, w1_q, w1_s, b1, w2_q, w2_s, b2, gelu_version="v1",
               chunk=1536):
    """The plain version with its intermediates: (out, {"x2", "h", "hq",
    "hs", "tq": [tq_j], "ts": [ts_j]}) at the rounding points of the module
    docstring."""
    dt = x.dtype
    x2 = DK.proj_q8_plain(x, y, wo_q, wo_s, bo)
    h = DK._layer_norm(x2.float(), ln_scale, ln_bias)
    hq, hs = _quant_rows(h)
    acc = torch.zeros((x.shape[0], w2_q.shape[0]), dtype=torch.float32, device=x.device)
    tq, ts = [], []
    for j in range(w1_q.shape[0] // chunk):
        sl = slice(j * chunk, (j + 1) * chunk)
        t = DK._gelu32(_int_mm(hq, w1_q[sl]) * hs * w1_s[sl].float() + b1[sl].float(), gelu_version)
        q, s = _quant_rows(t)
        acc = acc + _int_mm(q, w2_q[:, sl]) * s
        tq.append(q)
        ts.append(s)
    out = x2 + (acc * w2_s.float() + b2.float()).to(dt)
    return out, dict(x2=x2, h=h, hq=hq, hs=hs, tq=tq, ts=ts)


def fused_proj_mlp_q8a8_plain(x, y, wo_q, wo_s, bo, ln_scale, ln_bias, w1_q, w1_s, b1, w2_q, w2_s, b2,
                              gelu_version="v1", chunk=1536):
    """The JAX kernel's function (module docstring), in PyTorch."""
    return q8a8_steps(x, y, wo_q, wo_s, bo, ln_scale, ln_bias, w1_q, w1_s, b1, w2_q, w2_s, b2, gelu_version,
                      chunk)[0]


def smem_bytes(mt: int, k_slice: int, stages: int) -> int:
    """Dynamic shared memory of the kernel (csrc/dense_w8a8.cu w8_layout):
    the ring (an int8 64 x 64 weight tile and an s8 tq tile of mt x 64
    bytes a stage, rounded up to 1024), the bf16 y panel (phase A's s8 hq
    panel in its bytes), the reduction buffer, hs per row, the mbarriers,
    the alignment slack."""
    stage = -(-(DK._TILE * DK._BK + mt * DK._BK) // 1024) * 1024
    red = (mt // 2 + DK.CLUSTER_SIZES[-1]) * 512
    return stages * stage + k_slice * mt * 2 + red + mt * 4 + (2 * stages + 4) * 8 + 1024


@dataclass(frozen=True)
class W8Plan:
    """One launch of csrc/dense_w8a8.cu: `clusters` clusters of `cluster`
    CTAs (CTA b is rank b % cluster of cluster b // cluster), activation row
    tiles of `row_tile` rows (`row_tiles` of them, row_tiles * row_tile >=
    M), a ring of `stages` stages, `smem` bytes of dynamic shared memory;
    `chunk` the hidden units of one activation scale."""

    M: int
    C: int
    H: int
    chunk: int
    cluster: int
    clusters: int
    row_tile: int
    row_tiles: int
    stages: int
    smem: int

    def products(self) -> list[tuple[int, int]]:
        """(weight row tiles, reduction length) of wo's, w1's and w2's products."""
        C, H = self.C, self.H
        return [(C // DK._TILE, C), (H // DK._TILE, C), (C // DK._TILE, H)]

    units = DK.DensePlan.units

    def warpgroup_rows(self) -> int:
        """The rows of a tile one consumer warpgroup multiplies (the N of its s8 wgmma)."""
        return self.row_tile // 2 if self.row_tile > SPLIT_ROWS else self.row_tile

    def folds(self, cta: int) -> list[tuple[int, int]]:
        """Phase B's K-slice of CTA `cta` as the kernel folds it (k_loop_s8):
        (first K element, activation chunk) of each run of 64-wide K tiles
        summed in s32 before one fold into fp32, in order."""
        rank = cta % self.cluster
        ks = self.H // self.cluster
        runs, start = [], None
        for kc in range(ks // DK._BK):
            k0 = rank * ks + kc * DK._BK
            start = k0 if start is None else start
            if (k0 + DK._BK) % self.chunk == 0 or kc + 1 == ks // DK._BK:
                runs.append((start, k0 // self.chunk))
                start = None
        return runs


def _check(M: int, C: int, H: int, chunk: int) -> None:
    """The contract on the card (module docstring); ValueError otherwise."""
    if C not in DK.WIDTHS or H != 4 * C or M < 1:
        raise ValueError(f"dense_w8a8: needs C in {DK.WIDTHS}, H = 4C and M >= 1, got M={M}, C={C}, H={H}")
    if chunk <= 0 or chunk % DK._BK or H % chunk:
        raise ValueError(f"dense_w8a8: chunk must divide H and be a multiple of {DK._BK}, got chunk={chunk}, H={H}")


def w8a8_plan(M: int, C: int, H: int, chunk: int, sms: int = DK.SMS, max_clusters=None) -> W8Plan:
    """The launch plan of the kernel for M rows: decode_layer_kernel.
    dense_plan's search (for each cluster size s with C / s a multiple of
    64, the fewest row tiles of ROW_TILES whose shared memory fits a ring of
    at least four stages, as many as fit up to sixteen; at most sms // s
    clusters, no more than w1 has tiles, nor than max_clusters(row_tile, s,
    smem) when given), priced as it prices int8 weights, plus phase B's
    streamed tq tiles. ValueError outside the contract."""
    _check(M, C, H, chunk)
    best, best_cost = None, None
    for s in DK.CLUSTER_SIZES:
        if C % (DK._BK * s):
            continue
        fit = None
        for n_rt in range(1, M + 1):
            mt = next((t for t in ROW_TILES if t >= -(-M // n_rt)), None)
            if mt is None:
                continue
            base = smem_bytes(mt, C // s, 0)
            stages = min(DK._STAGES[1], (DK.SMEM_LIMIT - base) // (smem_bytes(mt, C // s, 1) - base))
            if stages >= DK._STAGES[0]:
                fit = (mt, n_rt, stages, smem_bytes(mt, C // s, stages))
                break
            if mt == ROW_TILES[0]:
                break
        if fit is None:
            continue
        mt, n_rt, stages, smem = fit
        G = min(sms // s, H // DK._TILE)
        if max_clusters is not None:
            G = min(G, max_clusters(mt, s, smem))
        if G < 1:
            continue
        plan = W8Plan(M, C, H, chunk, s, G, mt, n_rt, stages, smem)
        cost = n_rt * (sum(-(-tiles // G) * (DK._TILE * (k // s) + DK._ROUND_BYTES) for tiles, k in plan.products())
                       + -(-(C // DK._TILE) // G) * (H // s // DK._BK) * mt * DK._BK)
        if best is None or cost < best_cost:
            best, best_cost = plan, cost
    if best is None:
        raise ValueError(f"dense_w8a8: no launch plan fits M={M}, C={C}, H={H}")
    return best


def _device_plan(M, C, H, chunk, device) -> W8Plan:
    """w8a8_plan on this device (its SM count, its co-resident clusters),
    cached. Call with `device` current. A shape outside the contract raises
    ValueError before the device or the kernel library is asked anything."""
    key = ("dense_w8a8", M, C, H, chunk, device.index)
    plan = DK._plans.get(key)
    if plan is None:
        _check(M, C, H, chunk)
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        plan = DK._plans[key] = w8a8_plan(M, C, H, chunk, sms, max_clusters)
    return plan


def max_clusters(mt, s, smem) -> int:
    """How many clusters of s CTAs of the kernel (row tile mt, smem bytes of
    shared memory) the current device holds at once, from the library."""
    out = ctypes.c_int(0)
    _build.check(_build.library().rq_dense_w8a8_max_clusters(mt, s, smem, ctypes.addressof(out)),
                 "rq_dense_w8a8_max_clusters")
    return out.value


def _scratch(x, plan: W8Plan):
    """The kernel's scratch, kept per device and plan (one launch at a time
    per device), rows = row_tiles * row_tile: x2 [M, C] bf16, hq [rows, C]
    int8 and hs [rows], the tq tile images [H / 64, rows, 64] int8 and t in
    fp32 in the same shape, tmax [H / 64, rows] and ts [H / chunk, rows],
    stats [M, C / 64, 2] fp32."""
    key = ("dense_w8a8", x.get_device(), plan)
    bufs = DK._scratch.get(key)
    if bufs is None:
        if len(DK._scratch) >= 16:
            DK._scratch.clear()
        rows, tiles, nc = plan.row_tiles * plan.row_tile, plan.H // DK._BK, plan.H // plan.chunk
        f32, i8 = torch.float32, torch.int8
        new = lambda *shape, dtype=f32: torch.empty(shape, dtype=dtype, device=x.device)  # noqa: E731
        bufs = DK._scratch[key] = dict(
            x2=new(plan.M, plan.C, dtype=torch.bfloat16), hq=new(rows, plan.C, dtype=i8), hs=new(rows),
            tq=new(tiles, rows, DK._BK, dtype=i8), tf=new(tiles, rows, DK._BK), tmax=new(tiles, rows), ts=new(nc, rows),
            stats=new(plan.M, plan.C // DK._TILE, 2),
        )
    return bufs


def launch(plan: W8Plan, x, y, wo_q, wo_s, bo, ln_scale, ln_bias, w1_q, w1_s, b1, w2_q, w2_s, b2, gelu_version="v1"):
    """One launch of csrc/dense_w8a8.cu::rq_dense_w8a8 on checked CUDA
    tensors at `plan`. Returns out [M, C]."""
    mt = plan.row_tile
    with DK._device(x):
        out = torch.empty_like(x)
        b = _scratch(x, plan)
        err = _build.library().rq_dense_w8a8(
            x.data_ptr(), y.data_ptr(), DK._tensor_map(y, mt), DK._tensor_map(wo_q), wo_s.data_ptr(), bo.data_ptr(),
            ln_scale.data_ptr(), ln_bias.data_ptr(), DK._tensor_map(w1_q), w1_s.data_ptr(), b1.data_ptr(),
            DK._tensor_map(w2_q), w2_s.data_ptr(), b2.data_ptr(), out.data_ptr(), b["x2"].data_ptr(),
            b["hq"].data_ptr(), DK._tensor_map(b["hq"], mt), b["hs"].data_ptr(), b["tq"].data_ptr(),
            b["tf"].data_ptr(), b["tmax"].data_ptr(), b["ts"].data_ptr(), b["stats"].data_ptr(), plan.M, plan.C,
            plan.H, plan.chunk, plan.cluster, plan.clusters, mt, plan.row_tiles, plan.stages, plan.smem,
            int(gelu_version == "v2"), DK.LN_EPS, DK._stream(x),
        )
    _build.check(err, "rq_dense_w8a8")
    return out


def _checked(name, x, y, wo_q, wo_s, bo, ln_scale, ln_bias, w1_q, w1_s, b1, w2_q, w2_s, b2, gelu_version, chunk):
    """The refusals on any device (int8 weights, the gelu version, an H that
    chunk divides); returns the kind of x's device."""
    kind = QP._device_kind(name, x)
    for arg, w in (("wo_q", wo_q), ("w1_q", w1_q), ("w2_q", w2_q)):
        if w.dtype != torch.int8:
            raise ValueError(f"{name}: {arg} must be int8, got {w.dtype}")
    if gelu_version not in ("v1", "v2"):
        raise ValueError(f"{name}: unknown gelu version {gelu_version!r}")
    QP._check_chunk(name, w1_q.shape[0], chunk, 1)
    return kind


def _check_cuda(name, x, y, wo_q, wo_s, bo, ln_scale, ln_bias, w1_q, w1_s, b1, w2_q, w2_s, b2):
    """The types and shapes of a CUDA call. Returns (M, C, H)."""
    M, C = x.shape
    H = w1_q.shape[0]
    bf, i8 = torch.bfloat16, torch.int8
    QP._check_tensors(
        name,
        [("x", x), ("y", y), ("wo_q", wo_q), ("wo_s", wo_s), ("bo", bo), ("ln_scale", ln_scale),
         ("ln_bias", ln_bias), ("w1_q", w1_q), ("w1_s", w1_s), ("b1", b1), ("w2_q", w2_q), ("w2_s", w2_s), ("b2", b2)],
        (bf, bf, i8, bf, bf, bf, bf, i8, bf, bf, i8, bf, bf),
    )
    QP._check_shapes(name, (
        ("y", tuple(y.shape), (M, C)), ("wo_q", tuple(wo_q.shape), (C, C)), ("wo_s", tuple(wo_s.shape), (C,)),
        ("bo", tuple(bo.shape), (C,)), ("ln_scale", tuple(ln_scale.shape), (C,)),
        ("ln_bias", tuple(ln_bias.shape), (C,)), ("w1_q", tuple(w1_q.shape), (H, C)),
        ("w1_s", tuple(w1_s.shape), (H,)), ("b1", tuple(b1.shape), (H,)), ("w2_q", tuple(w2_q.shape), (C, H)),
        ("w2_s", tuple(w2_s.shape), (C,)), ("b2", tuple(b2.shape), (C,)),
    ))
    return M, C, H


def fused_proj_mlp_q8a8(x, y, wo_q, wo_s, bo, ln_scale, ln_bias, w1_q, w1_s, b1, w2_q, w2_s, b2,
                        gelu_version="v1", chunk=1536):
    """Kernel wrapper (#16): the plain version for CPU tensors; for CUDA
    tensors it launches csrc/dense_w8a8.cu::rq_dense_w8a8 (one persistent
    launch) or raises. Refuses, on any device, weights that are not int8, an
    unknown gelu version and an H that chunk does not divide; on the card
    also what the contract (module docstring) leaves out, before the library
    is asked. One call on the card adds one to
    `fused_proj_mlp_q8a8.launches`."""
    name = "fused_proj_mlp_q8a8"
    args = (x, y, wo_q, wo_s, bo, ln_scale, ln_bias, w1_q, w1_s, b1, w2_q, w2_s, b2)
    if _checked(name, *args, gelu_version, chunk) == "cpu":
        return fused_proj_mlp_q8a8_plain(*args, gelu_version, chunk)
    M, C, H = _check_cuda(name, *args)
    with DK._device(x):
        plan = _device_plan(M, C, H, chunk, x.device)
    out = launch(plan, *args, gelu_version)
    fused_proj_mlp_q8a8.launches += 1
    return out


fused_proj_mlp_q8a8.launches = 0


def fused_proj_mlp_q8a8_v1(x, y, wo_q, wo_s, bo, ln_scale, ln_bias, w1_q, w1_s, b1, w2_q, w2_s, b2,
                           gelu_version="v1", chunk=1536):
    """fused_proj_mlp_q8a8 through its first design (csrc/w8a8.cu::
    rq_w8a8_mlp: one cooperative launch, a cp.async chunk ring, mma.sync s8,
    at most 512 rows), CUDA tensors only: the A/B baseline of chip_smoke.py.
    Adds one to `fused_proj_mlp_q8a8_v1.launches` per call."""
    name = "fused_proj_mlp_q8a8_v1"
    args = (x, y, wo_q, wo_s, bo, ln_scale, ln_bias, w1_q, w1_s, b1, w2_q, w2_s, b2)
    if _checked(name, *args, gelu_version, chunk) != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    M, C, H = _check_cuda(name, *args)
    i8 = torch.int8
    grid, n_buf = QP.ring_depth(name, x.device, M, C, H, chunk, 1, k_align=64)
    out, x2 = torch.empty_like(x), torch.empty_like(x)
    hq = torch.empty((M, C), dtype=i8, device=x.device)
    hs = torch.empty((M,), dtype=torch.float32, device=x.device)
    t = torch.empty((M, H), dtype=torch.float32, device=x.device)
    tq = torch.empty((M, H), dtype=i8, device=x.device)
    tmax = torch.zeros((H // chunk, M), dtype=torch.int32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.rq_w8a8_mlp(
            x.data_ptr(), y.data_ptr(), wo_q.data_ptr(), wo_s.data_ptr(), bo.data_ptr(), ln_scale.data_ptr(),
            ln_bias.data_ptr(), w1_q.data_ptr(), w1_s.data_ptr(), b1.data_ptr(), w2_q.data_ptr(), w2_s.data_ptr(),
            b2.data_ptr(), out.data_ptr(), x2.data_ptr(), hq.data_ptr(), hs.data_ptr(), t.data_ptr(),
            tq.data_ptr(), tmax.data_ptr(), M, C, H, chunk, n_buf, grid, 1 if gelu_version == "v1" else 2, DK.LN_EPS,
            torch.cuda.current_stream().cuda_stream,
        )
    QP._launched(err, "rq_w8a8_mlp", f"chunk {chunk} x n_buf {n_buf}")
    fused_proj_mlp_q8a8_v1.launches += 1
    return out


fused_proj_mlp_q8a8_v1.launches = 0
