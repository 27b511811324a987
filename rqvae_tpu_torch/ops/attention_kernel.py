"""Decode attention over a KV cache: with the in-place row write, and read-only.

Counterpart of rqvae_tpu/ops/attention_kernel.py::decode_attention_update,
::decode_attention and ::decode_attention_stacked. All four attention forms,
bf16 and int8, update (decode_attention_update, decode_attention_q8_update)
and read-only (decode_attention, decode_attention_q8), launch
csrc/decode_attention_tma.cu: each batch row's window staged through
shared memory by bulk async copies, on the launch plan of attention_plan
(its source note says what bounds it on the H100 and how the design
answers that). The first design, csrc/decode_attention.cu and
csrc/decode_attention_q8.cu (one template each, with and without the row
write), stays reachable as the A/B baselines decode_attention_update_v1 /
decode_attention_q8_update_v1 / decode_attention_v1 /
decode_attention_q8_v1, which only chip_smoke.py runs. This module holds
the wrappers and the plain PyTorch versions of the same functions.

Contract (both versions): for q, k_new, v_new [B, C] and one layer's caches
k_cache, v_cache [B, T, C], the token attends cache rows
t < min(cur_len, W) (W = t_window, or T) plus its own k_new/v_new, with fp32
scores and softmax, and returns y [B, C]. Row cur_len of both caches is then
set to k_new / v_new IN PLACE: the caller's tensors are the updated caches.
This replaces the JAX kernel's `input_output_aliases` (a functional array
needs aliasing to update in place; a torch tensor simply is updated). The
TPU kernel's 0/1 segment matmuls and sublane-aligned windows were Mosaic
workarounds and are not carried over: W is taken as given.

decode_attention is the same attention with no write (the caches are only
read, and cur_len may reach T). decode_attention_stacked reads layer `layer`
of stacked [L, B, T, C] caches, all T rows masked by cur_len, by calling
decode_attention on the views k_cache[layer], v_cache[layer]: a view of a
contiguous stack is a pointer offset, which is what the TPU kernel's
index_map did. So each stacked launch is also a decode_attention launch,
and both counters count it. The TPU kernel's b_tile (B % b_tile == 0) was
a Mosaic constraint and is not carried over.

The int8 cache (kv_q8) is the counterpart of ::quantize_kv,
::dequantize_cache and ::decode_attention_q8_update (CUDA kernel
csrc/decode_attention_tma.cu; the first design csrc/decode_attention_q8.cu).
One layer's cache is (kq int8 [B, T, C], ks bf16 [B, T, n_head], vq, vs):
one scale per (row, head). quantize_kv
returns the fp32 scale; the cache stores it as bf16, but the int8 values
were rounded with the fp32 one.

decode_attention_q8 is the counterpart of ::decode_attention_q8: the same
q8 attention with no write (the four caches are only read, and cur_len may
reach T); its CUDA kernel is rq_attention_tma_q8_read, the read-only form of
the same device code. No sampling path calls it: the JAX sampler takes it
only for an int8 cache whose row count is not a multiple of 32 (its update
kernel's cache write reads 32-row tiles, a Mosaic constraint), and the
port's update kernel serves any row count. Its caller is the experiment
rqvae_tpu_torch/tools/exp_attn_q8cache.py.

decode_attention_q8_update_wo is the counterpart of
::decode_attention_q8_update_wo: the q8 attention, then the output
projection (int8 wo with its per-output scale, or a float wo), the residual
and LN2, returning (x2, h2) for the MLP. Its CUDA kernel is
csrc/decode_fused.cu::rq_fused_attn_wo: one persistent launch on
csrc/decode_dense.cu's machinery (the attention on the consumer warps
while the producer fills the weight ring with wo; wgmma, cluster split-K;
grid barriers), planned by ops/decode_layer_kernel.py::fused_plan; it
serves C in decode_layer_kernel.WIDTHS. Its first, cooperative design
(rq_decode_attention_q8_update_wo in csrc/decode_attention_q8.cu) stays as
the A/B baseline decode_attention_q8_update_wo_coop, which only
chip_smoke.py runs.

Head sizes: the attention kernels serve C / n_head in HEAD_SIZES (the CUDA
templates' instantiations: 64, and 104 for the zoo's vqgan_large; the
kernels of decode_attention_tma.cu need 16-byte aligned tensors and,
on an int8 cache at head size 104, an even n_head: their bulk copies move
16-byte multiples; a stack's layer view starts on one too, as C x 2 bytes
is a multiple of 16); the
fused decode_attention_q8_update_wo serves 64 only, since it runs only on
the unrolled sampling path (H·W <= 128), where every configuration of the
repository has head size 64.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from rqvae_tpu_torch.ops import _build
from rqvae_tpu_torch.ops import decode_layer_kernel as DK
from rqvae_tpu_torch.ops.decode_layer_kernel import LN_EPS, _layer_norm

# head sizes of the CUDA attention kernels (the instantiations in
# csrc/decode_attention.cu, csrc/decode_attention_q8.cu and
# csrc/decode_attention_tma.cu), each with the bytes of one lane's bf16 load
# in the first two, to which every bf16 pointer is aligned
HEAD_SIZES = {64: 4, 104: 8}
WO_HEAD_SIZE = 64  # the only head size of decode_attention_q8_update_wo


def _check_head(name, C, n_head, head_sizes, *bf16_tensors, int8_tensors=()):
    """Raise ValueError unless C / n_head is a head size the kernel serves
    and every bf16 tensor (int8 tensor) starts on the boundary of one lane's
    bf16 (int8) load, HEAD_SIZES[hs] (half that) bytes."""
    hs = C // n_head if n_head > 0 else 0
    if hs * n_head != C or hs not in head_sizes:
        raise ValueError(
            f"{name}: the kernel serves head sizes {sorted(head_sizes)}, got C={C}, n_head={n_head}"
        )
    for tensors, align, kind in ((bf16_tensors, HEAD_SIZES[hs], "bf16"), (int8_tensors, HEAD_SIZES[hs] // 2, "int8")):
        for t in tensors:
            if t.data_ptr() % align:
                raise ValueError(f"{name}: a {kind} tensor must start on a {align}-byte boundary at head size {hs}")


# csrc/decode_attention_tma.cu: consumer threads of a CTA (+ a producer
# warp), values per lane, the int8 scales of a unit a thread holds, floats
# per head of the reductions
TMA_THREADS = 256
TMA_VALS = 8
TMA_MAX_SCALES = 8
_TMA_RED_FLOATS = 2
SM_SMEM = 233_472  # shared memory of one SM; each resident CTA also takes 1 KB of it
TMA_STAGE_BYTES = 32_768  # a ring stage's target size
TMA_MAX_STAGES = 32
TMA_CTAS_PER_SM = 2  # resident CTAs per SM of the persistent grid
# the ring of the bf16 read-only form: two stages, measured 3-4% faster than
# the deeper rings at the stacked sampler's 256 rows at both head sizes
# (chip_smoke.py's sweep of read-only plans; PERF.md)
TMA_READ_STAGES = 2
TMA_MIN_PIECE = 512  # the smallest row piece of a group the plan picks: a bulk copy has a fixed cost
# the longest window of the update form: the unrolled sampler's caches hold
# cond_len + H W - 1 rows (at most 128 positions, sampling.resolve_unroll),
# rounded up to 32 at int8, so 512 leaves room for a long condition. The
# read-only form takes any window whose scores fit one CTA's shared memory
# (at int8 also whose scales its threads hold): the stacked sampler's T is
# cond_len + H W, up to 1024 positions at f8 (cli/measure_throughput.RQVAE_GEOM)
TMA_MAX_WINDOW = 512


def _round_up(v: int, a: int) -> int:
    return -(-v // a) * a


def _team_lanes(hs: int) -> int:
    """Lanes of one head's team: 8 at head size 64, 16 at 104 (13 hold columns)."""
    return 8 if hs <= 64 else 16


def _tma_smem(piece: int, hpc: int, window: int, rows: int, stages: int, q8: bool) -> int:
    """The shared-memory bytes of csrc/decode_attention_tma.cu::tma_layout:
    the ring, a full and an empty mbarrier a stage, the scores of `window`
    rows x hpc heads as floats and in the same bytes, after the V pass, the
    [n_sub, cols] partial y sums, (at int8) the V scales, the per-head self
    terms."""
    ring = stages * _round_up(rows * piece, 128)
    per_row = _round_up(window * hpc * 4, 16)
    return (_round_up(ring + 2 * stages * 8, 16) + max(per_row, TMA_THREADS * TMA_VALS * 4)
            + (per_row if q8 else 0) + _round_up(_TMA_RED_FLOATS * hpc * 4, 16))


@dataclass(frozen=True)
class AttentionPlan:
    """The launch of one csrc/decode_attention_tma.cu kernel: B batch rows
    of C columns in n_head heads, a window of `window` cache rows of
    `eb`-byte elements. Units (batch row b, head group g) of hpc heads, u = b
    groups + g, go round-robin to a persistent grid of `ctas` CTAs (CTA c
    takes units c, c + ctas, ...); each CTA streams its units' windows
    through `stages` stages of `rows` cache rows, `smem` bytes in all.
    `write`: the update form, which writes row cur_len of the unit's heads;
    else the caches are only read."""

    B: int
    C: int
    n_head: int
    window: int
    eb: int
    groups: int
    rows: int
    stages: int
    ctas: int
    smem: int
    write: bool = True

    @property
    def hs(self) -> int:
        return self.C // self.n_head

    @property
    def hpc(self) -> int:
        return self.n_head // self.groups

    @property
    def piece(self) -> int:
        """Bytes of one cache row's group columns: one bulk copy per row."""
        return self.hpc * self.hs * self.eb

    @property
    def n_sub(self) -> int:
        """Cache rows a CTA's consumers take at once (a team per head each)."""
        return TMA_THREADS // (self.hpc * _team_lanes(self.hs))

    def units(self, cta: int) -> range:
        """The units CTA `cta` takes, in order."""
        return range(cta, self.B * self.groups, self.ctas)

    def writes(self, cta: int) -> list[tuple[int, int, int]]:
        """The (batch row, first head, end head) slices of row cur_len that
        CTA `cta` writes: its units' heads in an update plan; nothing in the
        read-only form."""
        if not self.write:
            return []
        return [(u // self.groups, u % self.groups * self.hpc, (u % self.groups + 1) * self.hpc)
                for u in self.units(cta)]

    def copies(self, cta: int, n_valid: int, T: int):
        """The bulk copies of CTA `cta` in issue order, unit after unit:
        (chunk, unit, pass "k" or "v", source byte offset in the cache, stage
        byte offset, bytes), the cache a contiguous [B, T, C] tensor."""
        nck = -(-n_valid // self.rows)
        row_bytes = self.C * self.eb
        stage = _round_up(self.rows * self.piece, 128)
        for i, u in enumerate(self.units(cta)):
            b, g = divmod(u, self.groups)
            for k in range(2 * nck):
                c = i * 2 * nck + k
                which, r0 = ("k", k * self.rows) if k < nck else ("v", (k - nck) * self.rows)
                nr = min(self.rows, n_valid - r0)
                src = (b * T + r0) * row_bytes + g * self.piece
                dst = (c % self.stages) * stage
                if self.piece == row_bytes:
                    yield c, u, which, src, dst, nr * self.piece
                else:
                    for r in range(nr):
                        yield c, u, which, src + r * row_bytes, dst + r * self.piece, self.piece


def attention_plan(B: int, C: int, n_head: int, window: int, q8: bool, sms: int = DK.SMS,
                   groups: int | None = None, ctas_per_sm: int = TMA_CTAS_PER_SM,
                   stage_bytes: int = TMA_STAGE_BYTES, write: bool = True) -> AttentionPlan:
    """The launch plan of decode_attention_update (q8 False) or
    decode_attention_q8_update (q8 True) on csrc/decode_attention_tma.cu,
    or with `write` False of their read-only forms decode_attention /
    decode_attention_q8. Head groups: of those whose teams fit the
    consumers, whose row piece is a 16-byte multiple, (int8) whose window's
    scales the threads hold and whose plan fits a CTA's shared memory, and
    whose piece is at least TMA_MIN_PIECE bytes (else the fewest), the
    fewest that give every SM a unit (B * groups >= sms), else the most;
    `groups` pins them. Ring stages of at most about stage_bytes that split
    the window evenly (no short last chunk to wait for), as many as an SM's
    shared memory holds for ctas_per_sm CTAs, up to TMA_MAX_STAGES
    (TMA_READ_STAGES for the bf16 read-only form), so that the copies run
    ahead into the next unit. Where a long window's scores leave room for
    fewer than two, stages of half the size, down to a quarter of
    stage_bytes; where two of those do not fit either, the stages one CTA's
    whole shared memory holds, and one CTA an SM (the faster of the plans
    chip_smoke.py's sweep of long windows times); no more CTAs than units.
    ValueError for a head size outside HEAD_SIZES, B outside 1..65535, a
    window of the update form outside 0..TMA_MAX_WINDOW, or no such group
    (an int8 cache at head size 104 with an odd n_head: no 16-byte piece; a
    read-only window whose scores or scales no group holds)."""
    hs = C // n_head if n_head > 0 else 0
    eb = 1 if q8 else 2
    name = "decode_attention" + ("_q8" if q8 else "") + ("_update" if write else "")
    if hs * n_head != C or hs not in HEAD_SIZES:
        raise ValueError(f"{name}: the kernel serves head sizes {sorted(HEAD_SIZES)}, got C={C}, n_head={n_head}")
    if not 1 <= B <= 65535 or window < 0 or (write and window > TMA_MAX_WINDOW):
        raise ValueError(f"{name}: needs B in 1..65535 and a window of " + (f"0..{TMA_MAX_WINDOW}" if write else
                                                                               "0 or more")
                         + f" rows, got B={B}, window={window}")
    max_stages = TMA_MAX_STAGES if write or q8 else TMA_READ_STAGES
    cap = min(SM_SMEM // ctas_per_sm - 1024, DK.SMEM_LIMIT)

    def fit(G: int) -> AttentionPlan | None:
        shape = AttentionPlan(B, C, n_head, window, eb, G, 1, 1, 1, 0, write)
        for limit, per_sm, need in ((cap, ctas_per_sm, min(2, max_stages)), (DK.SMEM_LIMIT, 1, 1)):
            nck = max(1, -(-window * shape.piece // stage_bytes))  # chunks of a pass, the window split evenly
            while True:  # stages halved, down to a quarter of stage_bytes, until `need` of them fit
                rows = _round_up(max(1, -(-window // nck)), shape.n_sub)
                fits = [s for s in range(1, max_stages + 1)
                        if _tma_smem(shape.piece, shape.hpc, window, rows, s, q8) <= limit]
                if len(fits) >= need or 2 * rows * shape.piece < stage_bytes:
                    break
                nck *= 2
            if len(fits) >= need:
                return AttentionPlan(B, C, n_head, window, eb, G, rows, fits[-1], min(B * G, max(1, per_sm * sms)),
                                     _tma_smem(shape.piece, shape.hpc, window, rows, fits[-1], q8), write)
        return None

    plans = {G: fit(G) for G in range(1, n_head + 1)
             if n_head % G == 0 and (n_head // G) * _team_lanes(hs) <= TMA_THREADS
             and (C * eb) % 16 == 0 and (n_head // G * hs * eb) % 16 == 0
             and (not q8 or window * (n_head // G) <= TMA_MAX_SCALES * TMA_THREADS)
             and (groups is None or G == groups)}
    valid = [G for G, plan in plans.items() if plan is not None]
    if not valid:
        raise ValueError(f"{name}: no head group of C={C}, n_head={n_head}" + (f" at groups={groups}" if groups else "")
                         + f" is a 16-byte multiple of {eb}-byte elements (the bulk copies' unit) whose window's "
                         f"scales fit and whose plan of a {window}-row window fits {DK.SMEM_LIMIT} bytes of shared "
                         "memory")
    wide = [G for G in valid if n_head // G * hs * eb >= TMA_MIN_PIECE] or valid[:1]
    return plans[next((G for G in wide if B * G >= sms), wide[-1])]


_tma_plans: dict = {}


def _device_attention_plan(B, C, n_head, window, q8, device, write=True) -> AttentionPlan:
    """attention_plan on this device (its SM count), cached per (B, C,
    n_head, window, q8, write, device). A shape outside the contract raises
    ValueError before the device or the kernel library is asked anything."""
    key = (B, C, n_head, window, q8, write, device.index)
    plan = _tma_plans.get(key)
    if plan is None:
        attention_plan(B, C, n_head, window, q8, write=write)  # the contract, on the host alone
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        plan = _tma_plans[key] = attention_plan(B, C, n_head, window, q8, sms, write=write)
    return plan


def _check_tma(name, *tensors) -> None:
    """The bulk copies and 16-byte loads of decode_attention_tma.cu need
    every tensor on a 16-byte boundary."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: every tensor must start on a 16-byte boundary")


def decode_attention_plain(
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cur_len: int,
    n_head: int,
    t_window: int | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of decode_attention (the caches are only read).
    Rounding points follow the JAX kernel's _attn_math: elementwise q*k
    products in the cache dtype with fp32 sums, fp32 softmax, weights cast
    to the cache dtype, fp32 weighted sum of the cache rows, fp32 self term,
    one cast of y."""
    B, C = q.shape
    T = k_cache.shape[1]
    hs = C // n_head
    n_valid = min(cur_len, T if t_window is None else min(t_window, T))
    scale = 1.0 / math.sqrt(hs)
    cd = k_cache.dtype
    kc = k_cache[:, :n_valid].reshape(B, n_valid, n_head, hs)
    vc = v_cache[:, :n_valid].reshape(B, n_valid, n_head, hs)
    qh = q.to(cd).reshape(B, 1, n_head, hs)
    s_past = torch.sum(kc * qh, dim=-1, dtype=torch.float32) * scale  # [B, n, nh]
    s_self = torch.sum(
        (k_new * q).to(cd).reshape(B, 1, n_head, hs), dim=-1, dtype=torch.float32
    ) * scale  # [B, 1, nh]
    p = torch.softmax(torch.cat([s_past, s_self], dim=1), dim=1)
    w_past = p[:, :n_valid].to(cd)
    y = torch.sum(vc * w_past[..., None], dim=1, dtype=torch.float32)  # [B, nh, hs]
    y = y + v_new.float().reshape(B, n_head, hs) * p[:, n_valid, :, None]
    return y.reshape(B, C).to(q.dtype)


def decode_attention_update_plain(
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cur_len: int,
    n_head: int,
    t_window: int | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of decode_attention_update: decode_attention_plain,
    then row cur_len of both caches set to k_new / v_new in place."""
    y = decode_attention_plain(q, k_new, v_new, k_cache, v_cache, cur_len, n_head, t_window)
    k_cache[:, cur_len] = k_new.to(k_cache.dtype)
    v_cache[:, cur_len] = v_new.to(v_cache.dtype)
    return y


def _check(name, q, k_new, v_new, k_cache, v_cache, cur_len, n_head, write):
    B, C = q.shape
    for arg, t in (("q", q), ("k_new", k_new), ("v_new", v_new), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.device != q.device or t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(
                f"{name}: {arg} must be a contiguous bf16 tensor on "
                f"{q.device}, got {t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
            )
    if k_new.shape != (B, C) or v_new.shape != (B, C):
        raise ValueError(f"{name}: q, k_new, v_new must share shape [B, C]")
    if k_cache.dim() != 3 or k_cache.shape != v_cache.shape or k_cache.shape[::2] != (B, C):
        raise ValueError(f"{name}: caches must be [B, T, C] like q")
    _check_head(name, C, n_head, HEAD_SIZES, q, k_new, v_new, k_cache, v_cache)
    if cur_len < 0 or (write and cur_len >= k_cache.shape[1]):
        raise ValueError(f"{name}: cur_len={cur_len} outside the cache (T={k_cache.shape[1]})")


def _launch(entry, q, k_new, v_new, k_cache, v_cache, cur_len, n_head, t_window):
    """Launch rq_decode_attention_update or rq_decode_attention; returns y."""
    B, C = q.shape
    T = k_cache.shape[1]
    W = T if t_window is None else min(t_window, T)
    y = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(_build.library(), entry)(
            q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(), y.data_ptr(), B, T, C, n_head, W, cur_len, stream,
        )
    _build.check(err, entry)
    return y


def decode_attention_update(
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cur_len: int,
    n_head: int,
    t_window: int | None = None,
) -> torch.Tensor:
    """Kernel wrapper: the plain version for CPU tensors; for CUDA tensors it
    launches rq_attention_tma_update in csrc/decode_attention_tma.cu (bf16,
    a head size of HEAD_SIZES, contiguous, 16-byte aligned, a window of at
    most TMA_MAX_WINDOW rows) on the plan of attention_plan, or raises. One
    launch adds one to `decode_attention_update.launches`."""
    if q.device.type == "cpu":
        return decode_attention_update_plain(q, k_new, v_new, k_cache, v_cache, cur_len, n_head, t_window)
    name = "decode_attention_update"
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")
    _check(name, q, k_new, v_new, k_cache, v_cache, cur_len, n_head, write=True)
    y = _run_tma(name, "rq_attention_tma_update", (q, k_new, v_new, k_cache, v_cache), cur_len, n_head, t_window)
    decode_attention_update.launches += 1
    return y


decode_attention_update.launches = 0


def _run_tma(name, entry, tensors, cur_len, n_head, t_window):
    """The CUDA branch of the four wrappers of csrc/decode_attention_tma.cu:
    `tensors` (q, k_new, v_new, then the caches) on 16-byte boundaries, the
    cached plan of this shape (window min(t_window, T); int8 by the cache's
    dtype, the update form by `entry`), one launch of `entry`; returns y."""
    _check_tma(name, *tensors)
    q, cache = tensors[0], tensors[3]
    (B, C), T = q.shape, cache.shape[1]
    W = T if t_window is None else min(t_window, T)
    plan = _device_attention_plan(B, C, n_head, W, cache.dtype == torch.int8, q.device,
                                  write=entry.endswith("_update"))
    return _launch_tma(entry, plan, q, tensors, T, cur_len)


def _launch_tma(entry, plan: AttentionPlan, q, tensors, T, cur_len, probe=False):
    """Launch `entry` of csrc/decode_attention_tma.cu on `plan` with the
    pointers of `tensors` and a new y; returns y. `probe` streams the
    windows through the ring and computes and writes nothing (chip_smoke.py
    times the copies alone with it)."""
    y = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = getattr(_build.library(), entry)(
            *(t.data_ptr() for t in tensors), y.data_ptr(), plan.B, T, plan.C, plan.n_head, plan.window, cur_len,
            plan.groups, plan.rows, plan.stages, plan.ctas, int(probe),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, entry)
    return y


def decode_attention_update_v1(
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cur_len: int,
    n_head: int,
    t_window: int | None = None,
) -> torch.Tensor:
    """decode_attention_update through its first design
    (csrc/decode_attention.cu::rq_decode_attention_update, a block per
    (head, batch row)), CUDA tensors only: the A/B baseline of
    chip_smoke.py. Adds one to `decode_attention_update_v1.launches` per
    launch."""
    name = "decode_attention_update_v1"
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")
    _check(name, q, k_new, v_new, k_cache, v_cache, cur_len, n_head, write=True)
    y = _launch("rq_decode_attention_update", q, k_new, v_new, k_cache, v_cache, cur_len, n_head, t_window)
    decode_attention_update_v1.launches += 1
    return y


decode_attention_update_v1.launches = 0


def decode_attention(
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cur_len: int,
    n_head: int,
    t_window: int | None = None,
) -> torch.Tensor:
    """Kernel wrapper of the read-only attention: the plain version for CPU
    tensors; for CUDA tensors it launches rq_attention_tma_read in
    csrc/decode_attention_tma.cu (bf16, a head size of HEAD_SIZES,
    contiguous, 16-byte aligned, a window whose scores fit a CTA's shared
    memory; cur_len may reach T) on the read-only plan of attention_plan, or
    raises.
    One launch adds one to `decode_attention.launches`."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_new, v_new, k_cache, v_cache, cur_len, n_head, t_window)
    name = "decode_attention"
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")
    _check(name, q, k_new, v_new, k_cache, v_cache, cur_len, n_head, write=False)
    y = _run_tma(name, "rq_attention_tma_read", (q, k_new, v_new, k_cache, v_cache), cur_len, n_head, t_window)
    decode_attention.launches += 1
    return y


decode_attention.launches = 0


def decode_attention_v1(
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cur_len: int,
    n_head: int,
    t_window: int | None = None,
) -> torch.Tensor:
    """decode_attention through its first design
    (csrc/decode_attention.cu::rq_decode_attention, a block per (head,
    batch row)), CUDA tensors only: the A/B baseline of chip_smoke.py. Adds
    one to `decode_attention_v1.launches` per launch."""
    name = "decode_attention_v1"
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")
    _check(name, q, k_new, v_new, k_cache, v_cache, cur_len, n_head, write=False)
    y = _launch("rq_decode_attention", q, k_new, v_new, k_cache, v_cache, cur_len, n_head, t_window)
    decode_attention_v1.launches += 1
    return y


decode_attention_v1.launches = 0


def _check_layer(k_cache: torch.Tensor, v_cache: torch.Tensor, layer: int) -> None:
    if k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError("decode_attention_stacked: caches must be [L, B, T, C], both of one shape")
    if not 0 <= layer < k_cache.shape[0]:
        raise ValueError(f"decode_attention_stacked: layer={layer} outside the stack (L={k_cache.shape[0]})")


def decode_attention_stacked_plain(
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    layer: int,
    cur_len: int,
    n_head: int,
) -> torch.Tensor:
    """Plain PyTorch version of decode_attention_stacked: decode_attention_plain
    on layer `layer` of the stacked [L, B, T, C] caches (no window)."""
    _check_layer(k_cache, v_cache, layer)
    return decode_attention_plain(q, k_new, v_new, k_cache[layer], v_cache[layer], cur_len, n_head)


def decode_attention_stacked(
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    layer: int,
    cur_len: int,
    n_head: int,
) -> torch.Tensor:
    """Kernel wrapper: the plain version for CPU tensors; for CUDA tensors it
    launches decode_attention on the views k_cache[layer], v_cache[layer]
    (the layer's base pointer; nothing is copied) or raises. One launch adds
    one to `decode_attention_stacked.launches` and to
    `decode_attention.launches`."""
    if q.device.type == "cpu":
        return decode_attention_stacked_plain(q, k_new, v_new, k_cache, v_cache, layer, cur_len, n_head)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_stacked: no kernel for device {q.device}")
    _check_layer(k_cache, v_cache, layer)
    y = decode_attention(q, k_new, v_new, k_cache[layer], v_cache[layer], cur_len, n_head)
    decode_attention_stacked.launches += 1
    return y


decode_attention_stacked.launches = 0


def quantize_kv(x: torch.Tensor, n_head: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(row, head) symmetric int8 quantization of x [N, C]: returns
    (q int8 [N, C], scale fp32 [N, n_head]) with scale = max(absmax / 127,
    1e-8) and q = round(x / scale), half to even. Both divisions are
    elementwise tensor divisions (IEEE), as in the CUDA kernel."""
    N, C = x.shape
    xh = x.float().reshape(N, n_head, C // n_head)
    amax = xh.abs().amax(dim=-1)
    scale = (amax / torch.full_like(amax, 127.0)).clamp_min(1e-8)
    q = torch.round(xh / scale[..., None]).to(torch.int8)
    return q.reshape(N, C), scale


def dequantize_cache(q: torch.Tensor, scale: torch.Tensor, n_head: int) -> torch.Tensor:
    """int8 [B, T, C] with scales [B, T, n_head] -> the bf16 cache [B, T, C]."""
    B, T, C = q.shape
    x = q.float().reshape(B, T, n_head, C // n_head) * scale.float()[..., None]
    return x.reshape(B, T, C).to(torch.bfloat16)


def write_q8_rows(
    k: torch.Tensor, v: torch.Tensor, kq, ks, vq, vs, cur_len: int, n_head: int
) -> None:
    """Quantize k, v [B, S, C] and write them into rows cur_len .. cur_len +
    S of the four int8-cache tensors, in place."""
    B, S, C = k.shape
    for x, xq, xs in ((k, kq, ks), (v, vq, vs)):
        q, s = quantize_kv(x.reshape(B * S, C), n_head)
        xq[:, cur_len : cur_len + S] = q.reshape(B, S, C)
        xs[:, cur_len : cur_len + S] = s.reshape(B, S, n_head).to(xs.dtype)


def decode_attention_q8_update_plain(
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    kq: torch.Tensor,
    ks: torch.Tensor,
    vq: torch.Tensor,
    vs: torch.Tensor,
    cur_len: int,
    n_head: int,
    t_window: int | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of decode_attention_q8_update: y as
    _attention_q8 computes it, then k_new / v_new are quantized
    (quantize_kv) into row cur_len of the four caches IN PLACE. Returns y
    [B, C] in q's dtype."""
    y = _attention_q8(q, k_new, v_new, kq, ks, vq, vs, cur_len, n_head, t_window)
    write_q8_rows(k_new[:, None], v_new[:, None], kq, ks, vq, vs, cur_len, n_head)
    return y.to(q.dtype)


def _attention_q8(q, k_new, v_new, kq, ks, vq, vs, cur_len, n_head, t_window):
    """The q8 attention's fp32 y [B, C]. It rounds where the JAX kernel's
    _attn_math_q8_val does, in bf16 whatever the input dtype: products
    bf16(kq * q) summed per head in fp32, times ks, times 1/sqrt(hs); an
    explicit softmax (m, e, denom); weights bf16((e / denom) * vs); y = sum
    of bf16(vq * w) in fp32, plus the fp32 self term v_new * e_self /
    denom, whose score sums bf16(k_new * q)."""
    B, C = q.shape
    T = kq.shape[1]
    hs = C // n_head
    n = min(cur_len, T if t_window is None else min(t_window, T))
    scale = 1.0 / math.sqrt(hs)
    cd = torch.bfloat16
    f32 = torch.float32
    qh = q.to(cd).reshape(B, 1, n_head, hs)
    prod = kq[:, :n].to(cd).reshape(B, n, n_head, hs) * qh
    s_past = torch.sum(prod, dim=-1, dtype=f32) * ks[:, :n].float() * scale  # [B, n, nh]
    s_self = torch.sum((k_new * q).to(cd).reshape(B, 1, n_head, hs), dim=-1, dtype=f32) * scale
    m = s_self if n == 0 else torch.maximum(s_past.amax(dim=1, keepdim=True), s_self)
    e_past = torch.exp(s_past - m)
    e_self = torch.exp(s_self - m)
    denom = e_past.sum(dim=1, keepdim=True) + e_self
    w_past = ((e_past / denom) * vs[:, :n].float()).to(cd)
    y = torch.sum(vq[:, :n].to(cd).reshape(B, n, n_head, hs) * w_past[..., None], dim=1, dtype=f32)
    y = y + v_new.float().reshape(B, n_head, hs) * (e_self / denom)[:, 0, :, None]
    return y.reshape(B, C)


def _check_q8(q, k_new, v_new, kq, ks, vq, vs, cur_len, n_head, name="decode_attention_q8_update",
              write=True, head_sizes=HEAD_SIZES):
    """Raise ValueError unless the q8 kernels take these tensors: bf16 [B, C]
    activations, int8 [B, T, C] caches with bf16 [B, T, n_head] scales, a
    head size of `head_sizes`, and cur_len inside the cache (< T with the
    row write, any row count read-only)."""
    B, C = q.shape
    dev = q.device
    for arg, t, dtype in (
        ("q", q, torch.bfloat16), ("k_new", k_new, torch.bfloat16), ("v_new", v_new, torch.bfloat16),
        ("kq", kq, torch.int8), ("ks", ks, torch.bfloat16), ("vq", vq, torch.int8), ("vs", vs, torch.bfloat16),
    ):
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(
                f"{name}: {arg} must be a contiguous {dtype} tensor on {dev}, "
                f"got {t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
            )
    if k_new.shape != (B, C) or v_new.shape != (B, C):
        raise ValueError(f"{name}: q, k_new, v_new must share shape [B, C]")
    T = kq.shape[1] if kq.dim() == 3 else -1
    if kq.shape != (B, T, C) or vq.shape != kq.shape or ks.shape != (B, T, n_head) or vs.shape != ks.shape:
        raise ValueError(f"{name}: caches must be int8 [B, T, C] and bf16 scales [B, T, n_head]")
    _check_head(name, C, n_head, head_sizes, q, k_new, v_new, int8_tensors=(kq, vq))
    if cur_len < 0 or (write and cur_len >= T):
        raise ValueError(f"{name}: cur_len={cur_len} outside the cache (T={T})")


def _launch_q8(entry, q, k_new, v_new, kq, ks, vq, vs, cur_len, n_head, t_window):
    """Launch rq_decode_attention_q8_update or rq_decode_attention_q8; returns y."""
    B, C = q.shape
    T = kq.shape[1]
    W = T if t_window is None else min(t_window, T)
    y = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(_build.library(), entry)(
            q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), kq.data_ptr(), ks.data_ptr(),
            vq.data_ptr(), vs.data_ptr(), y.data_ptr(), B, T, C, n_head, W, cur_len, stream,
        )
    _build.check(err, entry)
    return y


def decode_attention_q8_update(
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    kq: torch.Tensor,
    ks: torch.Tensor,
    vq: torch.Tensor,
    vs: torch.Tensor,
    cur_len: int,
    n_head: int,
    t_window: int | None = None,
) -> torch.Tensor:
    """Kernel wrapper: the plain version for CPU tensors; for CUDA tensors it
    launches rq_attention_tma_q8_update in csrc/decode_attention_tma.cu
    (bf16 activations, int8 cache, a head size of HEAD_SIZES, an even n_head
    at head size 104, contiguous, 16-byte aligned, a window of at most
    TMA_MAX_WINDOW rows) on the plan of attention_plan, or raises. One launch
    adds one to `decode_attention_q8_update.launches`."""
    if q.device.type == "cpu":
        return decode_attention_q8_update_plain(q, k_new, v_new, kq, ks, vq, vs, cur_len, n_head, t_window)
    name = "decode_attention_q8_update"
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")
    _check_q8(q, k_new, v_new, kq, ks, vq, vs, cur_len, n_head)
    y = _run_tma(name, "rq_attention_tma_q8_update", (q, k_new, v_new, kq, ks, vq, vs), cur_len, n_head, t_window)
    decode_attention_q8_update.launches += 1
    return y


decode_attention_q8_update.launches = 0


def decode_attention_q8_update_v1(
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    kq: torch.Tensor,
    ks: torch.Tensor,
    vq: torch.Tensor,
    vs: torch.Tensor,
    cur_len: int,
    n_head: int,
    t_window: int | None = None,
) -> torch.Tensor:
    """decode_attention_q8_update through its first design
    (csrc/decode_attention_q8.cu::rq_decode_attention_q8_update, a block per
    (head, batch row)), CUDA tensors only: the A/B baseline of
    chip_smoke.py. Adds one to `decode_attention_q8_update_v1.launches` per
    launch."""
    name = "decode_attention_q8_update_v1"
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")
    _check_q8(q, k_new, v_new, kq, ks, vq, vs, cur_len, n_head, name)
    y = _launch_q8("rq_decode_attention_q8_update", q, k_new, v_new, kq, ks, vq, vs, cur_len, n_head, t_window)
    decode_attention_q8_update_v1.launches += 1
    return y


decode_attention_q8_update_v1.launches = 0


def decode_attention_q8_plain(
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    kq: torch.Tensor,
    ks: torch.Tensor,
    vq: torch.Tensor,
    vs: torch.Tensor,
    cur_len: int,
    n_head: int,
    t_window: int | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of decode_attention_q8: y as _attention_q8
    computes it, in q's dtype. The caches are only read."""
    return _attention_q8(q, k_new, v_new, kq, ks, vq, vs, cur_len, n_head, t_window).to(q.dtype)


def decode_attention_q8(
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    kq: torch.Tensor,
    ks: torch.Tensor,
    vq: torch.Tensor,
    vs: torch.Tensor,
    cur_len: int,
    n_head: int,
    t_window: int | None = None,
) -> torch.Tensor:
    """Kernel wrapper of the read-only q8 attention: the plain version for
    CPU tensors; for CUDA tensors it launches rq_attention_tma_q8_read in
    csrc/decode_attention_tma.cu (bf16 activations, int8 cache, a head size
    of HEAD_SIZES, an even n_head at head size 104, contiguous, 16-byte
    aligned, a window whose scores fit a CTA's shared memory and whose
    scales its threads hold; cur_len may reach T) on the read-only plan of attention_plan, or
    raises. One launch adds one to `decode_attention_q8.launches`."""
    if q.device.type == "cpu":
        return decode_attention_q8_plain(q, k_new, v_new, kq, ks, vq, vs, cur_len, n_head, t_window)
    name = "decode_attention_q8"
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")
    _check_q8(q, k_new, v_new, kq, ks, vq, vs, cur_len, n_head, name, write=False)
    y = _run_tma(name, "rq_attention_tma_q8_read", (q, k_new, v_new, kq, ks, vq, vs), cur_len, n_head, t_window)
    decode_attention_q8.launches += 1
    return y


decode_attention_q8.launches = 0


def decode_attention_q8_v1(
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    kq: torch.Tensor,
    ks: torch.Tensor,
    vq: torch.Tensor,
    vs: torch.Tensor,
    cur_len: int,
    n_head: int,
    t_window: int | None = None,
) -> torch.Tensor:
    """decode_attention_q8 through its first design
    (csrc/decode_attention_q8.cu::rq_decode_attention_q8, a block per (head,
    batch row)), CUDA tensors only: the A/B baseline of chip_smoke.py. Adds
    one to `decode_attention_q8_v1.launches` per launch."""
    name = "decode_attention_q8_v1"
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")
    _check_q8(q, k_new, v_new, kq, ks, vq, vs, cur_len, n_head, name, write=False)
    y = _launch_q8("rq_decode_attention_q8", q, k_new, v_new, kq, ks, vq, vs, cur_len, n_head, t_window)
    decode_attention_q8_v1.launches += 1
    return y


decode_attention_q8_v1.launches = 0


def decode_attention_q8_update_wo_plain(
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    kq: torch.Tensor,
    ks: torch.Tensor,
    vq: torch.Tensor,
    vs: torch.Tensor,
    cur_len: int,
    x: torch.Tensor,
    wo: torch.Tensor,
    wo_scale: torch.Tensor | None,
    bo: torch.Tensor,
    ln2_scale: torch.Tensor,
    ln2_bias: torch.Tensor,
    n_head: int,
    t_window: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of decode_attention_q8_update_wo. At the JAX
    kernel's rounding points (attention_kernel.py:680-699), bf16 whatever
    x's dtype: y = bf16(_attention_q8(...)), wo cast to bf16, their product
    summed in fp32 and times wo_scale [C] in fp32 (None: a float wo, a scale
    of ones); x2 = x + (proj + bo) cast to x's dtype; h2 = LN2(x2) in x's
    dtype. k_new / v_new are quantized into row cur_len of the four caches
    IN PLACE, as decode_attention_q8_update_plain does. wo is [C, C] int8
    or float, nn.Linear [out, in]. Returns (x2, h2) [B, C]."""
    y = _attention_q8(q, k_new, v_new, kq, ks, vq, vs, cur_len, n_head, t_window)
    write_q8_rows(k_new[:, None], v_new[:, None], kq, ks, vq, vs, cur_len, n_head)
    cd = torch.bfloat16
    proj = y.to(cd).float() @ wo.to(cd).float().t()
    if wo_scale is not None:
        proj = proj * wo_scale.float()
    x2 = x + (proj + bo.float()).to(x.dtype)
    return x2, _layer_norm(x2, ln2_scale, ln2_bias)


def decode_attention_q8_update_wo(
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    kq: torch.Tensor,
    ks: torch.Tensor,
    vq: torch.Tensor,
    vs: torch.Tensor,
    cur_len: int,
    x: torch.Tensor,
    wo: torch.Tensor,
    wo_scale: torch.Tensor | None,
    bo: torch.Tensor,
    ln2_scale: torch.Tensor,
    ln2_bias: torch.Tensor,
    n_head: int,
    t_window: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel wrapper: the plain version for CPU tensors; for CUDA tensors it
    launches csrc/decode_fused.cu::rq_fused_attn_wo (bf16 activations, int8
    cache, int8 or bf16 wo, head size WO_HEAD_SIZE = 64, C in
    decode_layer_kernel.WIDTHS, contiguous) or raises. One launch adds one
    to `decode_attention_q8_update_wo.launches`."""
    args = (q, k_new, v_new, kq, ks, vq, vs, cur_len, x, wo, wo_scale, bo, ln2_scale, ln2_bias, n_head, t_window)
    if q.device.type == "cpu":
        return decode_attention_q8_update_wo_plain(*args)
    W = _check_wo("decode_attention_q8_update_wo", *args)
    x2, h2 = DK.fused_attn_wo(*args[:-1], W)
    decode_attention_q8_update_wo.launches += 1
    return x2, h2


decode_attention_q8_update_wo.launches = 0


def _check_wo(name, q, k_new, v_new, kq, ks, vq, vs, cur_len, x, wo, wo_scale, bo, ln2_scale, ln2_bias, n_head,
              t_window) -> int:
    """The checks of the CUDA wrappers of decode_attention_q8_update_wo;
    returns the window W."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")
    _check_q8(q, k_new, v_new, kq, ks, vq, vs, cur_len, n_head, name, head_sizes=(WO_HEAD_SIZE,))
    B, C = q.shape
    T = kq.shape[1]
    W = T if t_window is None else min(t_window, T)
    if wo.dtype not in (torch.int8, torch.bfloat16) or wo.shape != (C, C):
        raise ValueError(f"{name}: wo must be int8 or bf16 [{C}, {C}], got {wo.dtype} {tuple(wo.shape)}")
    if wo.dtype == torch.int8 and wo_scale is None:
        raise ValueError(f"{name}: an int8 wo needs its per-output scale")
    vectors = [("x", x, (B, C)), ("wo", wo, (C, C)), ("bo", bo, (C,)), ("ln2_scale", ln2_scale, (C,)),
               ("ln2_bias", ln2_bias, (C,))] + ([("wo_scale", wo_scale, (C,))] if wo_scale is not None else [])
    for arg, t, shape in vectors:
        if t.device != q.device or (t.dtype != torch.bfloat16 and arg != "wo") or not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be a contiguous bf16 tensor on {q.device}, got {t.dtype} on {t.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, expected {shape}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must start on a 16-byte boundary")
    for arg, t in (("q", q), ("k_new", k_new), ("v_new", v_new), ("kq", kq), ("ks", ks), ("vq", vq), ("vs", vs)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must start on a 16-byte boundary")
    if W > _build.MAX_WINDOW:
        raise ValueError(f"{name}: the window holds at most {_build.MAX_WINDOW} rows, got {W}")
    return W


def decode_attention_q8_update_wo_coop(
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    kq: torch.Tensor,
    ks: torch.Tensor,
    vq: torch.Tensor,
    vs: torch.Tensor,
    cur_len: int,
    x: torch.Tensor,
    wo: torch.Tensor,
    wo_scale: torch.Tensor | None,
    bo: torch.Tensor,
    ln2_scale: torch.Tensor,
    ln2_bias: torch.Tensor,
    n_head: int,
    t_window: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """decode_attention_q8_update_wo through its first, cooperative design
    (csrc/decode_attention_q8.cu::rq_decode_attention_q8_update_wo), CUDA
    tensors only: the A/B baseline of chip_smoke.py. Adds one to
    `decode_attention_q8_update_wo_coop.launches` per launch."""
    name = "decode_attention_q8_update_wo_coop"
    W = _check_wo(name, q, k_new, v_new, kq, ks, vq, vs, cur_len, x, wo, wo_scale, bo, ln2_scale, ln2_bias, n_head,
                  t_window)
    B, C = q.shape
    T = kq.shape[1]
    x2, h2 = torch.empty_like(x), torch.empty_like(x)
    work = torch.empty(_build.MAX_SPLITS * B * C * 4 + B * C * 2, dtype=torch.uint8, device=q.device)
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = lib.rq_decode_attention_q8_update_wo(
            q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), kq.data_ptr(), ks.data_ptr(), vq.data_ptr(),
            vs.data_ptr(), x.data_ptr(), wo.data_ptr(), None if wo_scale is None else wo_scale.data_ptr(),
            bo.data_ptr(), ln2_scale.data_ptr(), ln2_bias.data_ptr(), x2.data_ptr(), h2.data_ptr(),
            work.data_ptr(), B, T, C, n_head, W, cur_len, int(wo.dtype == torch.int8), LN_EPS,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "rq_decode_attention_q8_update_wo")
    decode_attention_q8_update_wo_coop.launches += 1
    return x2, h2


decode_attention_q8_update_wo_coop.launches = 0
