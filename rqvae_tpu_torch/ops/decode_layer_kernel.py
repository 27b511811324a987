"""The dense half of a decode transformer layer: LN1+QKV and proj+LN2+MLP.

Counterparts of rqvae_tpu/ops/decode_layer_kernel.py::fused_ln_qkv and
::fused_proj_mlp, and of their int8-weight forms. The CUDA kernels of both
pairs are csrc/decode_dense.cu (wgmma, a TMA weight ring, split-K reduced
in a thread-block cluster's shared memory; one launch per call; an int8
weight tile widened to bf16 in the wgmma warpgroup's registers; its source
note says what bounds them on the H100 and how the design answers that);
`dense_plan` is their launch plan. Their first, split-K design (`*_splitk`,
kept as the A/B baseline that only chip_smoke.py runs) is
csrc/decode_layer.cu. This module holds their wrappers and the plain
PyTorch versions, and `fused_plan` with the launches of the fused
body-layer kernels of csrc/decode_fused.cu (#14 decode_layer_step, #13
decode_attention_q8_update_wo, whose wrappers are in decode_megakernel.py
and attention_kernel.py), built on the same machinery.

Weights come in the nn.Linear [out, in] layout (wqkv is the fused [3C, C]
buffer), not the JAX [in, out] one. Rounding points follow the JAX kernels
(decode_layer_kernel.py:88-105 and :292-323): one-pass fp32 LayerNorm cast
to the activation dtype; products accumulated in fp32; for QKV the bias is
added to the fp32 sum before the one cast; the projection is cast before
`+ bo` and the residual; gelu runs in fp32 and is cast; `+ b2` in fp32,
then the cast, then the residual. The exact erf replaces the JAX kernel's
polynomial erf, a Mosaic workaround within 1e-6 of it.

fused_ln_qkv, fused_proj_mlp and their q8 forms take the widths of the
head layers the port builds (WIDTHS: the zoo's 512, 1024 and 1280, the
1.4B's 1536, bench's 3800M 2560) with N = 3C and H = 4C, and any number of
rows M >= 1. fused_proj_mlp_splitk (and fused_proj_mlp_q8_splitk) on the
card is six launches behind one wrapper call (proj, its epilogue, LN2+w1,
gelu epilogue, w2, residual epilogue), since LN2 needs the whole of x2; it
counts as one launch of the function.

fused_ln_qkv_q8 / fused_proj_mlp_q8 take int8 weights [out, in] with one
bf16 scale per output channel (model.quantize_weight). They stand for both
JAX forms, ::fused_ln_qkv_q8 / ::fused_ln_qkv_q8_ring and ::fused_proj_mlp_q8
/ ::fused_proj_mlp_q8_ring, which differ only in TPU DMA depth. Their
rounding points (decode_layer_kernel.py:138-157, :511-553) are not those
of the bf16 pair: acc = h @ q in fp32; qkv = cast(acc * s + b);
x2 = x + cast(acc_o * s_o + bo) (bias added in fp32 before the cast);
t = cast(gelu(acc_1 * s_1 + b1)); out = x2 + cast(acc_2 * s_2 + b2), w2's
scale applied once to the whole sum.
"""

from __future__ import annotations

import contextlib
import ctypes
from dataclasses import dataclass

import torch

from rqvae_tpu_torch.ops import _build

LN_EPS = 1e-5
_BK = 64  # reduction chunk of the CUDA GEMMs (csrc/decode_layer.cu and decode_dense.cu kBK; bf16 and int8 tiles)
_TARGET_BLOCKS = 264  # two waves of the H100's 132 SMs (the split-K kernels)

# csrc/decode_dense.cu
WIDTHS = (512, 1024, 1280, 1536, 2560)  # C of the head layers the port builds
SMS = 132  # the H100's streaming multiprocessors
SMEM_LIMIT = 232_448  # dynamic shared memory one CTA may use
_TILE = 64  # weight rows per tile (the wgmma M)
_STAGES = (4, 16)  # least and most weight tiles in the ring
CLUSTER_SIZES = (1, 2, 4, 8)  # CTAs of a cluster: the split of K
ROW_TILES_MLP = tuple(range(8, 129, 8))  # activation rows per tile, the kernels built (RQ_TILES_*)
ROW_TILES_QKV = ROW_TILES_MLP + (160, 192, 224, 256)
# the plan's price of one tile's cluster reduction, in weight bytes (about
# the time an SM's share of the HBM rate takes to bring 16 KB)
_ROUND_BYTES = 16384
# csrc/decode_fused.cu: the row tiles its kernels are built for
# (RQ_TILES_FUSED), its consumer warps (kConsumers / 32), the shared memory
# that the scores of the warps that attend may take (decode_dense.cuh
# attn_warps)
ROW_TILES_FUSED = (8, 16, 24, 32, 40, 48, 64, 80, 104, 128)
_CONSUMER_WARPS = 8
_SCORE_BUDGET = 65536


def _layer_norm(x, weight, bias):
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = ((x32 * x32).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
    y = (x32 - mean) * torch.rsqrt(var + LN_EPS)
    return (y * weight.float() + bias.float()).to(x.dtype)


def _gelu32(t, version):
    if version == "v1":
        return 0.5 * t * (1.0 + torch.erf(t * 0.7071067811865476))
    return t * torch.sigmoid(1.702 * t)


def fused_ln_qkv_plain(x, ln_scale, ln_bias, wqkv, bqkv):
    """x [B, C] -> LN(x) @ wqkv^T + bqkv, wqkv [N, C]. Returns [B, N]."""
    h = _layer_norm(x, ln_scale, ln_bias)
    return (h.float() @ wqkv.float().t() + bqkv.float()).to(x.dtype)


def fused_proj_mlp_plain(x, y, wo, bo, ln_scale, ln_bias, w1, b1, w2, b2, gelu_version="v1"):
    """x2 = x + y @ wo^T + bo; out = x2 + gelu(LN(x2) @ w1^T + b1) @ w2^T + b2."""
    dt = x.dtype
    proj = (y.float() @ wo.float().t()).to(dt)
    x2 = x + (proj + bo)
    h = _layer_norm(x2, ln_scale, ln_bias)
    t = _gelu32(h.float() @ w1.float().t() + b1.float(), gelu_version).to(dt)
    m = (t.float() @ w2.float().t() + b2.float()).to(dt)
    return x2 + m


def fused_ln_qkv_q8_plain(x, ln_scale, ln_bias, wq, ws, bqkv):
    """x [B, C] -> (LN(x) @ wq^T) * ws + bqkv, wq int8 [N, C], ws [N]."""
    h = _layer_norm(x, ln_scale, ln_bias)
    acc = h.float() @ wq.float().t()
    return (acc * ws.float() + bqkv.float()).to(x.dtype)


def proj_q8_plain(x, y, wo_q, wo_s, bo):
    """x2 = x + cast(acc_o * s_o + bo), acc_o = y @ wo_q^T in fp32: the
    projection step of the q8 rounding points (module docstring)."""
    return x + ((y.float() @ wo_q.float().t()) * wo_s.float() + bo.float()).to(x.dtype)


def fused_proj_mlp_q8_plain(
    x, y, wo_q, wo_s, bo, ln_scale, ln_bias, w1_q, w1_s, b1, w2_q, w2_s, b2, gelu_version="v1"
):
    """fused_proj_mlp_plain for int8 wo / w1 / w2 with per-output-channel
    scales, at the q8 rounding points (module docstring)."""
    dt = x.dtype
    x2 = proj_q8_plain(x, y, wo_q, wo_s, bo)
    h = _layer_norm(x2, ln_scale, ln_bias)
    t = _gelu32((h.float() @ w1_q.float().t()) * w1_s.float() + b1.float(), gelu_version).to(dt)
    return x2 + ((t.float() @ w2_q.float().t()) * w2_s.float() + b2.float()).to(dt)


def _splits(M: int, N: int, K: int) -> int:
    """Split-K factor of the csrc/decode_layer.cu kernels (the q8 pair and
    the *_splitk baselines): enough blocks to fill the card, K divisible by
    the split times the staged chunk."""
    blocks = -(-N // 64) * -(-M // 128)
    s = max(1, min(K // _BK, -(-_TARGET_BLOCKS // blocks)))
    while K % (s * _BK):
        s -= 1
    return s


def _smem_bytes(mt: int, k_slice: int, stages: int, mlp: bool, wbytes: int = 2, scores: int = 0) -> int:
    """Dynamic shared memory of a decode_dense.cu or decode_fused.cu kernel
    (decode_dense.cuh `layout`): the ring (a 64 x 64 weight tile of
    wbytes-byte elements per stage, + a t tile for mlp), the resident B
    panel (or, when larger, the fused kernels' attention scores, `scores`
    bytes, which use the panel's bytes), the reduction buffer (red_bytes), a
    float2 per row, the LN parameters of the K-slice as float2, the
    mbarriers and 1024 bytes of alignment slack."""
    stage = _TILE * _BK * wbytes + (mt * _BK * 2 if mlp else 0)
    red = (mt // 2 + CLUSTER_SIZES[-1]) * 512
    panel = max((k_slice // _BK) * mt * _BK * 2, scores)
    return stages * stage + panel + red + mt * 8 + k_slice * 8 + (2 * stages + 4) * 8 + 1024


@dataclass(frozen=True)
class DensePlan:
    """The launch of one decode_dense.cu kernel: `clusters` clusters of
    `cluster` CTAs (grid cluster * clusters, CTA b is rank b % cluster of
    cluster b // cluster), activation row tiles of `row_tile` rows
    (`row_tiles` of them, row_tiles * row_tile >= M), a ring of `stages`
    weight tiles of `wbytes`-byte elements (2 bf16, 1 int8), `smem` bytes
    of dynamic shared memory."""

    mlp: bool
    M: int
    C: int
    N: int  # 3C (fused_ln_qkv) or H (fused_proj_mlp)
    wbytes: int
    cluster: int
    clusters: int
    row_tile: int
    row_tiles: int
    stages: int
    smem: int

    def products(self) -> list[tuple[int, int]]:
        """(weight row tiles, reduction length) of each product, in order."""
        C, N = self.C, self.N
        return [(C // _TILE, C), (N // _TILE, C), (C // _TILE, N)] if self.mlp else [(N // _TILE, C)]

    def units(self, cta: int):
        """What CTA `cta` computes, in the kernel's order: (product, first
        activation row, weight row tile, first reduction element) of each
        64 x 64 weight tile it multiplies."""
        cid, rank = divmod(cta, self.cluster)
        for i, (tiles, k) in enumerate(self.products()):
            ks = k // self.cluster
            for rt in range(self.row_tiles):
                for j in range(cid, tiles, self.clusters):
                    for kc in range(ks // _BK):
                        yield i, rt * self.row_tile, j, rank * ks + kc * _BK


def _check_shape(M: int, C: int, N: int, mlp: bool) -> None:
    """The widths decode_dense.cu takes: C in WIDTHS, N = 3C (ln_qkv) or H =
    4C (proj_mlp), M >= 1; ValueError otherwise."""
    if C not in WIDTHS or N != (4 if mlp else 3) * C or M < 1:
        raise ValueError(
            f"decode_dense: needs C in {WIDTHS}, {'H = 4C' if mlp else 'N = 3C'} and M >= 1, got M={M}, C={C}, "
            f"{'H' if mlp else 'N'}={N}"
        )


def dense_plan(M: int, C: int, N: int, mlp: bool, sms: int = SMS, max_clusters=None, wbytes: int = 2) -> DensePlan:
    """The launch plan of fused_ln_qkv (mlp False, N = 3C) or fused_proj_mlp
    (mlp True, N = H = 4C) for M rows, with bf16 (wbytes 2) or int8 (wbytes
    1) weights. For each cluster size s (C / s a multiple of 64, the
    reduction depth of a weight tile of either type), the fewest row tiles
    whose shared memory fits with a ring of at least four stages (as many
    as fit, up to sixteen); at most sms // s clusters (one wave), no more
    than the largest product has tiles, nor than max_clusters(mlp,
    row_tile, s, smem) (the device's count of co-resident clusters, when
    given). Of those, the one whose busiest CTA streams the fewest weight
    bytes, each cluster reduction priced at _ROUND_BYTES (so at int8 a
    round costs twice the weight elements it does at bf16); ties go to the
    smaller cluster."""
    _check_shape(M, C, N, mlp)
    tiles_built = ROW_TILES_MLP if mlp else ROW_TILES_QKV
    best, best_cost = None, None
    for s in CLUSTER_SIZES:
        if C % (_BK * s):
            continue
        fit = None
        for n_rt in range(1, M + 1):
            need = -(-M // n_rt)
            mt = next((t for t in tiles_built if t >= need), None)
            if mt is None:
                continue
            base = _smem_bytes(mt, C // s, 0, mlp, wbytes)
            stage = _smem_bytes(mt, C // s, 1, mlp, wbytes) - base
            stages = min(_STAGES[1], (SMEM_LIMIT - base) // stage)
            if stages >= _STAGES[0]:
                fit = (mt, n_rt, stages, _smem_bytes(mt, C // s, stages, mlp, wbytes))
                break
            if mt == tiles_built[0]:
                break
        if fit is None:
            continue
        mt, n_rt, stages, smem = fit
        plan = DensePlan(mlp, M, C, N, wbytes, s, 1, mt, n_rt, stages, smem)
        G = min(sms // s, max(tiles for tiles, _ in plan.products()))
        if max_clusters is not None:
            G = min(G, max_clusters(mlp, mt, s, smem))
        if G < 1:
            continue
        cost = n_rt * sum(-(-tiles // G) * (_TILE * (k // s) * wbytes + _ROUND_BYTES) for tiles, k in plan.products())
        if best is None or cost < best_cost:
            best = DensePlan(mlp, M, C, N, wbytes, s, G, mt, n_rt, stages, smem)
            best_cost = cost
    if best is None:
        raise ValueError(f"decode_dense: no launch plan fits M={M}, C={C}, N={N}")
    return best


_plans: dict = {}
_maps: dict = {}


def _device_plan(M, C, N, mlp, wbytes, device) -> DensePlan:
    """dense_plan on this device (its SM count, its co-resident clusters),
    cached. Call with `device` current. A shape outside the contract raises
    ValueError before the device or the kernel library is asked anything."""
    key = (M, C, N, mlp, wbytes, device.index)
    plan = _plans.get(key)
    if plan is None:
        _check_shape(M, C, N, mlp)

        def most(mlp, mt, s, smem):
            out = ctypes.c_int(0)
            _build.check(_build.library().rq_dense_max_clusters(int(mlp), mt, s, smem, int(wbytes == 1),
                                                                ctypes.addressof(out)), "rq_dense_max_clusters")
            return out.value

        sms = torch.cuda.get_device_properties(device).multi_processor_count
        plan = _plans[key] = dense_plan(M, C, N, mlp, sms, most, wbytes)
    return plan


def _map_key(t, box_rows: int) -> tuple:
    """The tensor-map cache key of t: its address, element type, shape and
    box (an int8 tensor the allocator places where a bf16 one of the same
    shape was gets a map of its own)."""
    return (t.data_ptr(), t.dtype, *t.shape, box_rows)


def _tensor_map(t, box_rows: int = _TILE) -> int:
    """Address of the TMA tensor map of the bf16 or int8 matrix t [rows,
    cols] in boxes of box_rows rows x 64 columns (fp32: 32 columns, for
    csrc/nearest_code.cu): a weight's (64), encoded once per weight tensor,
    or an activation's or a scratch buffer's (its row tile), encoded once
    per address the allocator hands out; keyed by _map_key, the cache
    emptied when it holds 4096."""
    key = _map_key(t, box_rows)
    buf = _maps.get(key)
    if buf is None:
        if len(_maps) >= 4096:
            _maps.clear()
        buf = (ctypes.c_uint8 * 128)()  # a CUtensorMap
        _build.check(_build.library().rq_dense_tensor_map(t.data_ptr(), t.shape[0], t.shape[1], box_rows,
                                                          t.element_size(), ctypes.addressof(buf)),
                     "rq_dense_tensor_map")
        _maps[key] = buf
    return ctypes.addressof(buf)


def _check_cuda(name, tensors, shapes, int8=()):
    """Every tensor contiguous, on one device, of its shape, and bf16 (int8
    for the argument names in `int8`); matrices 32-byte aligned, as the
    kernels' wmma and vector loads need."""
    dev = tensors[0][1].device
    for (arg, t), shape in zip(tensors, shapes):
        dtype = torch.int8 if arg in int8 else torch.bfloat16
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(
                f"{name}: {arg} must be a contiguous {dtype} tensor on {dev}, "
                f"got {t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
            )
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, expected {shape}")
        if t.dim() == 2 and t.data_ptr() % 32:
            raise ValueError(f"{name}: {arg} must start on a 32-byte boundary")


def _check_dense(name, tensors, shapes, int8=()):
    """_check_cuda for the decode_dense.cu wrappers, on their hot path: one
    pass of cheap tests, and _check_cuda's messages when one fails; every
    tensor also on a 16-byte boundary (the kernels' vector loads and TMA)."""
    dev = tensors[0][1].get_device()
    for (arg, t), shape in zip(tensors, shapes):
        if (t.dtype is not (torch.int8 if arg in int8 else torch.bfloat16) or t.shape != shape
                or t.get_device() != dev or not t.is_contiguous() or t.data_ptr() % 16):
            _check_cuda(name, tensors, shapes, int8)
            raise ValueError(f"{name}: {arg} must start on a 16-byte boundary")


def _device(x):
    """torch.cuda.device(x.device), or nothing when x's device is current."""
    return contextlib.nullcontext() if x.get_device() == torch.cuda.current_device() else torch.cuda.device(x.device)


_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream(x) -> int:
    """The current CUDA stream of x's device as an int (torch's raw accessor
    where it has one: torch.cuda.current_stream() builds a Python object,
    several us of host time a call)."""
    if _raw_stream is not None:
        return _raw_stream(x.get_device())
    return torch.cuda.current_stream(x.device).cuda_stream


_scratch: dict = {}


def _mlp_scratch(x, C, H, plan):
    """fused_proj_mlp's scratch (x2 [M, C], t [H / 64, rows, 64], stats [M,
    C / 64, 2] fp32), kept per device and shape: the kernel is one launch at
    a time on a device (its grid barrier's counters), so calls on a stream
    may share it, and the host saves three allocations a call."""
    M = x.shape[0]
    key = (x.get_device(), M, C, H, plan.row_tile, plan.row_tiles)
    bufs = _scratch.get(key)
    if bufs is None:
        if len(_scratch) >= 16:
            _scratch.clear()
        bufs = _scratch[key] = (
            torch.empty((M, C), dtype=x.dtype, device=x.device),
            torch.empty((H // _BK, plan.row_tiles * plan.row_tile, _BK), dtype=x.dtype, device=x.device),
            torch.empty((M, C // _TILE, 2), dtype=torch.float32, device=x.device),
        )
    return bufs


def _ln_qkv(x, ln_scale, ln_bias, w, ws, bqkv):
    """One launch of csrc/decode_dense.cu::rq_fused_ln_qkv on checked CUDA
    tensors: bf16 weights w (ws None) or int8 ones with their scales ws."""
    M, C = x.shape
    N = w.shape[0]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    with _device(x):
        plan = _device_plan(M, C, N, False, w.element_size(), x.device)
        err = _build.library().rq_fused_ln_qkv(
            x.data_ptr(), _tensor_map(x, plan.row_tile), ln_scale.data_ptr(), ln_bias.data_ptr(), _tensor_map(w),
            None if ws is None else ws.data_ptr(), bqkv.data_ptr(), out.data_ptr(), M, C, N, plan.cluster,
            plan.clusters, plan.row_tile, plan.row_tiles, plan.stages, plan.smem, LN_EPS, _stream(x),
        )
    _build.check(err, "rq_fused_ln_qkv")
    return out


def _proj_mlp(x, y, wo, wo_s, bo, ln_scale, ln_bias, w1, w1_s, b1, w2, w2_s, b2, gelu_version, chunk=0):
    """One persistent launch of csrc/decode_dense.cu::rq_fused_proj_mlp on
    checked CUDA tensors: bf16 weights (the scales None) or int8 ones with
    their scales; w1 [H, C]; w2 [C, H], or with `chunk` the packed w2 seen
    as the matrix [nc C, chunk] (chunk % 64 == 0, dividing H)."""
    if gelu_version not in ("v1", "v2"):
        raise ValueError(f"fused_proj_mlp: unknown gelu version {gelu_version!r}")
    M, C = x.shape
    H = w1.shape[0]
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with _device(x):
        plan = _device_plan(M, C, H, True, w1.element_size(), x.device)
        out = torch.empty_like(x)
        x2, t, stats = _mlp_scratch(x, C, H, plan)
        err = _build.library().rq_fused_proj_mlp(
            x.data_ptr(), y.data_ptr(), _tensor_map(y, plan.row_tile), _tensor_map(wo), ptr(wo_s), bo.data_ptr(),
            ln_scale.data_ptr(), ln_bias.data_ptr(), _tensor_map(w1), ptr(w1_s), b1.data_ptr(), _tensor_map(w2),
            ptr(w2_s), b2.data_ptr(), out.data_ptr(), x2.data_ptr(), _tensor_map(x2, plan.row_tile), t.data_ptr(),
            stats.data_ptr(), M, C, H, chunk, plan.cluster, plan.clusters, plan.row_tile, plan.row_tiles,
            plan.stages, plan.smem, int(gelu_version == "v2"), LN_EPS, _stream(x),
        )
    _build.check(err, "rq_fused_proj_mlp")
    return out


def fused_ln_qkv(x, ln_scale, ln_bias, wqkv, bqkv):
    """Kernel wrapper: the plain version for CPU tensors; for CUDA tensors it
    launches csrc/decode_dense.cu::rq_fused_ln_qkv (one launch) or raises.
    One call on the card adds one to `fused_ln_qkv.launches`."""
    if x.device.type == "cpu":
        return fused_ln_qkv_plain(x, ln_scale, ln_bias, wqkv, bqkv)
    if x.device.type != "cuda":
        raise ValueError(f"fused_ln_qkv: no kernel for device {x.device}")
    M, C = x.shape
    N = wqkv.shape[0]
    args = [("x", x), ("ln_scale", ln_scale), ("ln_bias", ln_bias), ("wqkv", wqkv), ("bqkv", bqkv)]
    _check_dense("fused_ln_qkv", args, [(M, C), (C,), (C,), (N, C), (N,)])
    out = _ln_qkv(x, ln_scale, ln_bias, wqkv, None, bqkv)
    fused_ln_qkv.launches += 1
    return out


fused_ln_qkv.launches = 0


def fused_proj_mlp(x, y, wo, bo, ln_scale, ln_bias, w1, b1, w2, b2, gelu_version="v1"):
    """Kernel wrapper: the plain version for CPU tensors; for CUDA tensors it
    launches csrc/decode_dense.cu::rq_fused_proj_mlp (one persistent
    launch) or raises. One call on the card adds one to
    `fused_proj_mlp.launches`."""
    if x.device.type == "cpu":
        return fused_proj_mlp_plain(x, y, wo, bo, ln_scale, ln_bias, w1, b1, w2, b2, gelu_version)
    if x.device.type != "cuda":
        raise ValueError(f"fused_proj_mlp: no kernel for device {x.device}")
    M, C = x.shape
    H = w1.shape[0]
    args = [("x", x), ("y", y), ("wo", wo), ("bo", bo), ("ln_scale", ln_scale), ("ln_bias", ln_bias),
            ("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2)]
    _check_dense("fused_proj_mlp", args, [(M, C), (M, C), (C, C), (C,), (C,), (C,), (H, C), (H,), (C, H), (C,)])
    out = _proj_mlp(x, y, wo, None, bo, ln_scale, ln_bias, w1, None, b1, w2, None, b2, gelu_version)
    fused_proj_mlp.launches += 1
    return out


fused_proj_mlp.launches = 0


def fused_ln_qkv_splitk(x, ln_scale, ln_bias, wqkv, bqkv):
    """fused_ln_qkv through its first, split-K design (csrc/decode_layer.cu::
    rq_fused_ln_qkv_splitk: the GEMM and its epilogue, two launches), CUDA
    tensors only: the A/B baseline of chip_smoke.py. Adds one to
    `fused_ln_qkv_splitk.launches` per call."""
    if x.device.type != "cuda":
        raise ValueError(f"fused_ln_qkv_splitk: no kernel for device {x.device}")
    M, C = x.shape
    N = wqkv.shape[0]
    _check_cuda(
        "fused_ln_qkv_splitk",
        [("x", x), ("ln_scale", ln_scale), ("ln_bias", ln_bias), ("wqkv", wqkv), ("bqkv", bqkv)],
        [(M, C), (C,), (C,), (N, C), (N,)],
    )
    if C % _BK or N % 16:
        raise ValueError(f"fused_ln_qkv_splitk: needs C % {_BK} == 0 and N % 16 == 0, got C={C}, N={N}")
    s = _splits(M, N, C)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    work = torch.empty((s, M, N), dtype=torch.float32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.rq_fused_ln_qkv_splitk(
            x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(), wqkv.data_ptr(),
            bqkv.data_ptr(), out.data_ptr(), work.data_ptr(), M, N, C, s, LN_EPS,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "rq_fused_ln_qkv_splitk")
    fused_ln_qkv_splitk.launches += 1
    return out


fused_ln_qkv_splitk.launches = 0


def fused_proj_mlp_splitk(x, y, wo, bo, ln_scale, ln_bias, w1, b1, w2, b2, gelu_version="v1"):
    """fused_proj_mlp through its first, split-K design (csrc/decode_layer.cu::
    rq_fused_proj_mlp_splitk, six launches), CUDA tensors only: the A/B
    baseline of chip_smoke.py. Adds one to `fused_proj_mlp_splitk.launches`
    per call."""
    if x.device.type != "cuda":
        raise ValueError(f"fused_proj_mlp_splitk: no kernel for device {x.device}")
    if gelu_version not in ("v1", "v2"):
        raise ValueError(f"fused_proj_mlp_splitk: unknown gelu version {gelu_version!r}")
    M, C = x.shape
    H = w1.shape[0]
    _check_cuda(
        "fused_proj_mlp_splitk",
        [("x", x), ("y", y), ("wo", wo), ("bo", bo), ("ln_scale", ln_scale), ("ln_bias", ln_bias),
         ("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2)],
        [(M, C), (M, C), (C, C), (C,), (C,), (C,), (H, C), (H,), (C, H), (C,)],
    )
    if C % _BK or H % _BK:
        raise ValueError(f"fused_proj_mlp_splitk: needs C and H divisible by {_BK}, got C={C}, H={H}")
    so, s1, s2 = _splits(M, C, C), _splits(M, H, C), _splits(M, C, H)
    out = torch.empty_like(x)
    x2 = torch.empty_like(x)
    hidden = torch.empty((M, H), dtype=x.dtype, device=x.device)
    work = torch.empty((max(so * C, s1 * H, s2 * C) * M,), dtype=torch.float32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.rq_fused_proj_mlp_splitk(
            x.data_ptr(), y.data_ptr(), wo.data_ptr(), bo.data_ptr(), ln_scale.data_ptr(),
            ln_bias.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            out.data_ptr(), x2.data_ptr(), hidden.data_ptr(), work.data_ptr(),
            M, C, H, so, s1, s2, int(gelu_version == "v2"), LN_EPS,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "rq_fused_proj_mlp_splitk")
    fused_proj_mlp_splitk.launches += 1
    return out


fused_proj_mlp_splitk.launches = 0


def fused_ln_qkv_q8(x, ln_scale, ln_bias, wq, ws, bqkv):
    """Kernel wrapper: the plain version for CPU tensors; for CUDA tensors it
    launches csrc/decode_dense.cu::rq_fused_ln_qkv with the int8 weight wq
    and its scales ws (one launch) or raises. One call on the card adds one
    to `fused_ln_qkv_q8.launches`."""
    if x.device.type == "cpu":
        return fused_ln_qkv_q8_plain(x, ln_scale, ln_bias, wq, ws, bqkv)
    if x.device.type != "cuda":
        raise ValueError(f"fused_ln_qkv_q8: no kernel for device {x.device}")
    M, C = x.shape
    N = wq.shape[0]
    args = [("x", x), ("ln_scale", ln_scale), ("ln_bias", ln_bias), ("wq", wq), ("ws", ws), ("bqkv", bqkv)]
    _check_dense("fused_ln_qkv_q8", args, [(M, C), (C,), (C,), (N, C), (N,), (N,)], int8=("wq",))
    out = _ln_qkv(x, ln_scale, ln_bias, wq, ws, bqkv)
    fused_ln_qkv_q8.launches += 1
    return out


fused_ln_qkv_q8.launches = 0


def fused_proj_mlp_q8(
    x, y, wo_q, wo_s, bo, ln_scale, ln_bias, w1_q, w1_s, b1, w2_q, w2_s, b2, gelu_version="v1"
):
    """Kernel wrapper: the plain version for CPU tensors; for CUDA tensors it
    launches csrc/decode_dense.cu::rq_fused_proj_mlp with the int8 weights
    and their scales (one persistent launch) or raises. One call on the card
    adds one to `fused_proj_mlp_q8.launches`."""
    if x.device.type == "cpu":
        return fused_proj_mlp_q8_plain(
            x, y, wo_q, wo_s, bo, ln_scale, ln_bias, w1_q, w1_s, b1, w2_q, w2_s, b2, gelu_version
        )
    if x.device.type != "cuda":
        raise ValueError(f"fused_proj_mlp_q8: no kernel for device {x.device}")
    M, C = x.shape
    H = w1_q.shape[0]
    _check_dense(
        "fused_proj_mlp_q8",
        [("x", x), ("y", y), ("wo_q", wo_q), ("wo_s", wo_s), ("bo", bo), ("ln_scale", ln_scale),
         ("ln_bias", ln_bias), ("w1_q", w1_q), ("w1_s", w1_s), ("b1", b1), ("w2_q", w2_q),
         ("w2_s", w2_s), ("b2", b2)],
        [(M, C), (M, C), (C, C), (C,), (C,), (C,), (C,), (H, C), (H,), (H,), (C, H), (C,), (C,)],
        int8=("wo_q", "w1_q", "w2_q"),
    )
    out = _proj_mlp(x, y, wo_q, wo_s, bo, ln_scale, ln_bias, w1_q, w1_s, b1, w2_q, w2_s, b2, gelu_version)
    fused_proj_mlp_q8.launches += 1
    return out


fused_proj_mlp_q8.launches = 0


def fused_ln_qkv_q8_splitk(x, ln_scale, ln_bias, wq, ws, bqkv):
    """fused_ln_qkv_q8 through its first, split-K design (csrc/decode_layer.cu::
    rq_fused_ln_qkv_q8_splitk: the GEMM and its epilogue, two launches),
    CUDA tensors only: the A/B baseline of chip_smoke.py. Adds one to
    `fused_ln_qkv_q8_splitk.launches` per call."""
    if x.device.type != "cuda":
        raise ValueError(f"fused_ln_qkv_q8_splitk: no kernel for device {x.device}")
    M, C = x.shape
    N = wq.shape[0]
    _check_cuda(
        "fused_ln_qkv_q8_splitk",
        [("x", x), ("ln_scale", ln_scale), ("ln_bias", ln_bias), ("wq", wq), ("ws", ws), ("bqkv", bqkv)],
        [(M, C), (C,), (C,), (N, C), (N,), (N,)],
        int8=("wq",),
    )
    if C % _BK or N % 16:
        raise ValueError(f"fused_ln_qkv_q8_splitk: needs C % {_BK} == 0 and N % 16 == 0, got C={C}, N={N}")
    s = _splits(M, N, C)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    work = torch.empty((s, M, N), dtype=torch.float32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.rq_fused_ln_qkv_q8_splitk(
            x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(), wq.data_ptr(), ws.data_ptr(),
            bqkv.data_ptr(), out.data_ptr(), work.data_ptr(), M, N, C, s, LN_EPS,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "rq_fused_ln_qkv_q8_splitk")
    fused_ln_qkv_q8_splitk.launches += 1
    return out


fused_ln_qkv_q8_splitk.launches = 0


def fused_proj_mlp_q8_splitk(
    x, y, wo_q, wo_s, bo, ln_scale, ln_bias, w1_q, w1_s, b1, w2_q, w2_s, b2, gelu_version="v1"
):
    """fused_proj_mlp_q8 through its first, split-K design (csrc/decode_layer.cu::
    rq_fused_proj_mlp_q8_splitk, six launches), CUDA tensors only: the A/B
    baseline of chip_smoke.py. Adds one to `fused_proj_mlp_q8_splitk.launches`
    per call."""
    if x.device.type != "cuda":
        raise ValueError(f"fused_proj_mlp_q8_splitk: no kernel for device {x.device}")
    if gelu_version not in ("v1", "v2"):
        raise ValueError(f"fused_proj_mlp_q8_splitk: unknown gelu version {gelu_version!r}")
    M, C = x.shape
    H = w1_q.shape[0]
    _check_cuda(
        "fused_proj_mlp_q8_splitk",
        [("x", x), ("y", y), ("wo_q", wo_q), ("wo_s", wo_s), ("bo", bo), ("ln_scale", ln_scale),
         ("ln_bias", ln_bias), ("w1_q", w1_q), ("w1_s", w1_s), ("b1", b1), ("w2_q", w2_q),
         ("w2_s", w2_s), ("b2", b2)],
        [(M, C), (M, C), (C, C), (C,), (C,), (C,), (C,), (H, C), (H,), (H,), (C, H), (C,), (C,)],
        int8=("wo_q", "w1_q", "w2_q"),
    )
    if C % _BK or H % _BK:
        raise ValueError(f"fused_proj_mlp_q8_splitk: needs C and H divisible by {_BK}, got C={C}, H={H}")
    so, s1, s2 = _splits(M, C, C), _splits(M, H, C), _splits(M, C, H)
    out = torch.empty_like(x)
    x2 = torch.empty_like(x)
    hidden = torch.empty((M, H), dtype=x.dtype, device=x.device)
    work = torch.empty((max(so * C, s1 * H, s2 * C) * M,), dtype=torch.float32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.rq_fused_proj_mlp_q8_splitk(
            x.data_ptr(), y.data_ptr(), wo_q.data_ptr(), wo_s.data_ptr(), bo.data_ptr(),
            ln_scale.data_ptr(), ln_bias.data_ptr(), w1_q.data_ptr(), w1_s.data_ptr(), b1.data_ptr(),
            w2_q.data_ptr(), w2_s.data_ptr(), b2.data_ptr(), out.data_ptr(), x2.data_ptr(),
            hidden.data_ptr(), work.data_ptr(), M, C, H, so, s1, s2, int(gelu_version == "v2"), LN_EPS,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "rq_fused_proj_mlp_q8_splitk")
    fused_proj_mlp_q8_splitk.launches += 1
    return out


fused_proj_mlp_q8_splitk.launches = 0


# ---- csrc/decode_fused.cu: the fused body-layer steps (#14 and #13) --------


def _attn_warps(window: int) -> int:
    """The consumer warps that attend (decode_dense.cuh attn_warps): all 8,
    or as many as keep their scores within _SCORE_BUDGET, at least one."""
    return min(_CONSUMER_WARPS, max(1, _SCORE_BUDGET // (32 * (window + 1))))


def _score_bytes(window: int) -> int:
    """The attention's shared memory in one CTA (decode_dense.cuh
    score_bytes): for each of an attending warp's 4 heads, window + 1
    scores and as many V scales, fp32."""
    return _attn_warps(window) * 4 * 2 * (window + 1) * 4


@dataclass(frozen=True)
class FusedPlan:
    """The launch of one decode_fused.cu kernel: the layer step (`layer`,
    bf16 weights; products wqkv, wo, w1, w2) or the q8 attention with wo
    (products: wo, of `wbytes`-byte elements), one grid of `clusters`
    clusters of `cluster` CTAs for every product and for the attention (a
    warp per row and 4 heads, keeping window + 1 scores and V scales of
    each), row tiles of
    `row_tile` rows, a ring of `stages` weight tiles, `smem` bytes."""

    layer: bool
    M: int
    C: int
    wbytes: int
    window: int
    cluster: int
    clusters: int
    row_tile: int
    row_tiles: int
    stages: int
    smem: int

    def products(self) -> list[tuple[int, int]]:
        """(weight row tiles, reduction length) of each product, in order."""
        C, H = self.C, 4 * self.C
        if self.layer:
            return [(3 * C // _TILE, C), (C // _TILE, C), (H // _TILE, C), (C // _TILE, H)]
        return [(C // _TILE, C)]

    units = DensePlan.units

    def attention_units(self, cta: int):
        """The (row, head) units CTA `cta` attends, in its warps' order (the
        kernel's attention_phase: CTA c takes rows b = c, c + grid, ..., its
        warp w < attn_warps the 4 heads 4 q .. 4 q + 3 of quads q = w, w +
        attn_warps, ...)."""
        grid, aw = self.cluster * self.clusters, _attn_warps(self.window)
        quads = self.C // 64 // 4
        for w in range(aw):
            for b in range(cta, self.M, grid):
                for q in range(w, quads, aw):
                    yield from ((b, 4 * q + g) for g in range(4))


def fused_plan(M: int, C: int, layer: bool, window: int, wbytes: int = 2, sms: int = SMS,
               max_clusters=None) -> FusedPlan:
    """The launch plan of decode_layer_step (layer True; bf16 weights, H =
    4C) or decode_attention_q8_update_wo (layer False; wo of wbytes 1 or 2)
    on csrc/decode_fused.cu, for M rows and a `window`-row attention window:
    dense_plan's search over cluster sizes and row tiles (ROW_TILES_FUSED)
    for all the kernel's products at once, the attention's scores in the
    panel's bytes; every cluster the SMs hold (the attention runs on all of
    them; clusters past a product's tiles skip it), no more than
    max_clusters(layer, row_tile, s, smem) when given. ValueError for C
    outside WIDTHS, M < 1 or a window outside [0, MAX_WINDOW]."""
    if C not in WIDTHS or M < 1 or not 0 <= window <= _build.MAX_WINDOW:
        raise ValueError(f"decode_fused: needs C in {WIDTHS}, M >= 1 and a window of 0 .. {_build.MAX_WINDOW} rows, "
                         f"got M={M}, C={C}, window={window}")
    scores = _score_bytes(window)
    best, best_cost = None, None
    for s in CLUSTER_SIZES:
        if C % (_BK * s):
            continue
        fit = None
        for n_rt in range(1, M + 1):
            mt = next((t for t in ROW_TILES_FUSED if t >= -(-M // n_rt)), None)
            if mt is None:
                continue
            base = _smem_bytes(mt, C // s, 0, layer, wbytes, scores)
            stage = _smem_bytes(mt, C // s, 1, layer, wbytes, scores) - base
            stages = min(_STAGES[1], (SMEM_LIMIT - base) // stage)
            if stages >= _STAGES[0]:
                fit = (mt, n_rt, stages, _smem_bytes(mt, C // s, stages, layer, wbytes, scores))
                break
            if mt == ROW_TILES_FUSED[0]:
                break
        if fit is None:
            continue
        mt, n_rt, stages, smem = fit
        G = sms // s
        if max_clusters is not None:
            G = min(G, max_clusters(layer, mt, s, smem))
        if G < 1:
            continue
        plan = FusedPlan(layer, M, C, wbytes, window, s, G, mt, n_rt, stages, smem)
        cost = n_rt * sum(-(-tiles // G) * (_TILE * (k // s) * wbytes + _ROUND_BYTES) for tiles, k in plan.products())
        if best is None or cost < best_cost:
            best, best_cost = plan, cost
    if best is None:
        raise ValueError(f"decode_fused: no launch plan fits M={M}, C={C}, window={window}")
    return best


def _fused_device_plan(M, C, layer, window, wbytes, device) -> FusedPlan:
    """fused_plan on this device, cached; as _device_plan, a shape outside
    the contract raises ValueError before the device or the library is asked."""
    key = ("fused", M, C, layer, window, wbytes, device.index)
    plan = _plans.get(key)
    if plan is None:
        fused_plan(M, C, layer, window, wbytes, max_clusters=lambda *a: SMS)  # the contract, on the host alone

        def most(layer, mt, s, smem):
            out = ctypes.c_int(0)
            _build.check(_build.library().rq_fused_max_clusters(int(layer), mt, s, smem, int(wbytes == 1),
                                                                ctypes.addressof(out)), "rq_fused_max_clusters")
            return out.value

        sms = torch.cuda.get_device_properties(device).multi_processor_count
        plan = _plans[key] = fused_plan(M, C, layer, window, wbytes, sms, most)
    return plan


def _fused_scratch(x, plan: FusedPlan):
    """A fused kernel's scratch, kept per device and plan (one launch of a
    decode_fused.cu kernel at a time per device, as _mlp_scratch): the layer
    step's qkv [M, 3C], att, x2 [M, C], t [H / 64, rows, 64] and stats [M,
    C / 64, 2] fp32; the attention with wo's att and stats."""
    M, C = plan.M, plan.C
    key = ("fused", x.get_device(), plan)
    bufs = _scratch.get(key)
    if bufs is None:
        if len(_scratch) >= 16:
            _scratch.clear()
        new = lambda *shape, dtype=x.dtype: torch.empty(shape, dtype=dtype, device=x.device)  # noqa: E731
        stats = new(M, C // _TILE, 2, dtype=torch.float32)
        if plan.layer:
            bufs = (new(M, 3 * C), new(M, C), new(M, C), new(4 * C // _BK, plan.row_tiles * plan.row_tile, _BK), stats)
        else:
            bufs = (new(M, C), stats)
        _scratch[key] = bufs
    return bufs


def fused_layer_step(x, k_cache, v_cache, cur_len, p, n_head, window, gelu_version):
    """One launch of csrc/decode_fused.cu::rq_fused_layer_step on checked
    CUDA tensors (ops/decode_megakernel.py::decode_layer_step's contract;
    p: its weights by keyword). Returns out [M, C]; writes row cur_len of
    the caches."""
    M, C = x.shape
    H = p["w1"].shape[0]
    with _device(x):
        plan = _fused_device_plan(M, C, True, window, 2, x.device)
        out = torch.empty_like(x)
        qkv, att, x2, t, stats = _fused_scratch(x, plan)
        mt = plan.row_tile
        err = _build.library().rq_fused_layer_step(
            x.data_ptr(), _tensor_map(x, mt), k_cache.data_ptr(), v_cache.data_ptr(), p["ln1_scale"].data_ptr(),
            p["ln1_bias"].data_ptr(), _tensor_map(p["wqkv"]), p["bqkv"].data_ptr(), _tensor_map(p["wo"]),
            p["bo"].data_ptr(), p["ln2_scale"].data_ptr(), p["ln2_bias"].data_ptr(), _tensor_map(p["w1"]),
            p["b1"].data_ptr(), _tensor_map(p["w2"]), p["b2"].data_ptr(), out.data_ptr(), qkv.data_ptr(),
            att.data_ptr(), _tensor_map(att, mt), x2.data_ptr(), _tensor_map(x2, mt), t.data_ptr(), stats.data_ptr(),
            M, k_cache.shape[1], C, H, n_head, window, cur_len, plan.cluster, plan.clusters, mt, plan.row_tiles,
            plan.stages, plan.smem, int(gelu_version == "v2"), LN_EPS, _stream(x),
        )
    _build.check(err, "rq_fused_layer_step")
    return out


def fused_attn_wo(q, k_new, v_new, kq, ks, vq, vs, cur_len, x, wo, wo_scale, bo, ln2_scale, ln2_bias, n_head, window):
    """One launch of csrc/decode_fused.cu::rq_fused_attn_wo on checked CUDA
    tensors (ops/attention_kernel.py::decode_attention_q8_update_wo's
    contract). Returns (x2, h2) [M, C]; writes row cur_len of the four caches."""
    M, C = q.shape
    with _device(q):
        plan = _fused_device_plan(M, C, False, window, wo.element_size(), q.device)
        x2, h2 = torch.empty_like(x), torch.empty_like(x)
        att, stats = _fused_scratch(q, plan)
        err = _build.library().rq_fused_attn_wo(
            q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), kq.data_ptr(), ks.data_ptr(), vq.data_ptr(),
            vs.data_ptr(), x.data_ptr(), _tensor_map(wo), None if wo_scale is None else wo_scale.data_ptr(),
            bo.data_ptr(), ln2_scale.data_ptr(), ln2_bias.data_ptr(), x2.data_ptr(), h2.data_ptr(), att.data_ptr(),
            _tensor_map(att, plan.row_tile), stats.data_ptr(), M, kq.shape[1], C, n_head, window, cur_len,
            plan.cluster, plan.clusters, plan.row_tile, plan.row_tiles, plan.stages, plan.smem, LN_EPS, _stream(q),
        )
    _build.check(err, "rq_fused_attn_wo")
    return x2, h2
