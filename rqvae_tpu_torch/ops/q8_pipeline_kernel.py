"""The int8 weight-streaming MLP with an explicit pipeline of weight-chunk
copies, and its isolation probes: counterparts of the four Pallas kernels
of tools/exp_q8_pipeline.py.

- fused_proj_mlp_q8_ring (#17): #6's function (ops/decode_layer_kernel.py::
  fused_proj_mlp_q8), with the w1 / w2 chunks streamed through an
  n_buf-deep pipeline; w2 in the [C, H] layout.
- fused_proj_mlp_q8_packed (#18): the same on weights packed one chunk per
  contiguous block (pack_w1 / pack_w2).
- stream_probe (#19): the chunk stream alone, "dma" or "dequant".
- ablate_ring (#20): the MLP alone, Σ_j cast(gelu?(h @ w1_j^T × s1_j?)) @
  w2_j^T in fp32, cast to h's dtype; int8 or bf16 weights.

#17 and #18 launch #6's kernel, csrc/decode_dense.cu::rq_fused_proj_mlp
with int8 weights (one persistent launch, planned by decode_layer_kernel.
dense_plan), #18 with its w2 read through a tensor map of the packed [nc
C, chunk]; #19's kernel is csrc/stream_probe.cu, the TMA ring that #6
streams its weights through with the products taken out (its source note
says what bounds it on the H100 and how the design answers that; its plan
is #6's at B 100, probe_plan); #20's is the "ring" form of
csrc/dense_mlp.cu (one persistent launch on csrc/decode_dense.cu's
machinery, planned by ops/dense_mlp_kernel.py).
The first design of #17 / #18 / #20 (csrc/q8_pipeline.cu's cooperative
chunk-ring kernel, rq_q8_ring_mlp) stays as the A/B baselines
`fused_proj_mlp_q8_ring_v1`, `fused_proj_mlp_q8_packed_v1` and
`ablate_ring_v1` that only chip_smoke.py runs. This module holds their
wrappers, the plain PyTorch versions and the packed layout.

Layout. The port keeps weights in the nn.Linear [out, in] layout: w1 [H,
C], w2 [C, H], int8 with one bf16 scale per output channel (model.
quantize_weight). w1's chunk j is rows j*chunk.. (already contiguous);
w2's chunk j is the strided columns j*chunk.., the reverse of JAX's [in,
out] case, where w1's chunk is the strided one. pack_w1 makes [nc, chunk,
C] (the same bytes), pack_w2 [nc, C, chunk]. checkpoint/from_jax.py::
q8_pipeline_weights_from_jax turns the experiment's arrays into these.

`chunk` and `n_buf` keep the JAX meaning (the hidden slice whose w1 rows
and w2 columns travel together; the stages in flight). The result does not
depend on them. Only the first designs still run a ring of chunk stages:
on the card a point whose stages a block cannot hold raises ValueError
with the arithmetic, and nothing drops to a smaller depth. #17, #18, #19
and #20 plan their own depth: chunk is only the packed layout's (a
multiple of 64 dividing H), n_buf is still checked (1..8) and sets nothing.
"""

from __future__ import annotations

import functools

import torch

from rqvae_tpu_torch.ops import _build
from rqvae_tpu_torch.ops import decode_layer_kernel as DK
from rqvae_tpu_torch.ops import dense_mlp_kernel as DM

PROBE_LANES = 128
PROBE_ROWS = 100  # the batch of #6's plan whose ring #19 streams (the experiment's B)
_ROW_PAD = 16  # bytes after each staged row (csrc/q8_pipeline.cu kRowPad)
_MAX_TILES = 4  # most 8-row tiles a block owns in one share (kNT)
_MAX_ROWS = 128  # activation rows: 8 warps x 16
RING_ROWS = 512  # the row-grouped kernels (csrc/ring.cuh kMaxGroups x kGroupRows)
_STATIC_SMEM = 1056  # bytes of a block's shared memory held back for the ring kernels' static arrays
_SMEM_OPTIN = 232448  # a block's shared memory on the H100 when the device does not say


def pack_w1(w1, chunk):
    """w1 [H, C] -> [nc, chunk, C], chunk j = rows j*chunk.. (the same bytes)."""
    H, C = w1.shape
    _check_chunk("pack_w1", H, chunk, 1)
    return w1.reshape(H // chunk, chunk, C).contiguous()


def pack_w2(w2, chunk):
    """w2 [C, H] -> [nc, C, chunk], chunk j = columns j*chunk.., one block each."""
    C, H = w2.shape
    _check_chunk("pack_w2", H, chunk, 1)
    return w2.reshape(C, H // chunk, chunk).permute(1, 0, 2).contiguous()


def unpack_w1(w1p):
    nc, chunk, C = w1p.shape
    return w1p.reshape(nc * chunk, C)


def unpack_w2(w2p):
    nc, C, chunk = w2p.shape
    return w2p.permute(1, 0, 2).reshape(C, nc * chunk)


def _check_chunk(name, H, chunk, n_buf):
    if chunk <= 0 or H % chunk:
        raise ValueError(f"{name}: H % chunk must be 0, got H={H}, chunk={chunk}")
    if not 1 <= n_buf <= 8:
        raise ValueError(f"{name}: n_buf must lie in 1..8, got {n_buf}")


def _device_kind(name, t):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {t.device}")
    return t.device.type


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def fused_proj_mlp_q8_ring_plain(x, y, wo_q, wo_s, bo, ln_scale, ln_bias, w1_q, w1_s, b1, w2_q, w2_s, b2,
                                 gelu_version="v1"):
    """The JAX ring kernel's function: #6's, at #6's rounding points
    (tools/exp_q8_pipeline.py:78-109 against decode_layer_kernel.py:511-553)."""
    return DK.fused_proj_mlp_q8_plain(x, y, wo_q, wo_s, bo, ln_scale, ln_bias, w1_q, w1_s, b1, w2_q, w2_s, b2,
                                      gelu_version)


def fused_proj_mlp_q8_packed_plain(x, y, wo_q, wo_s, bo, ln_scale, ln_bias, w1p, w1_s, b1, w2p, w2_s, b2,
                                   gelu_version="v1"):
    """fused_proj_mlp_q8_ring_plain on packed w1 [nc, chunk, C], w2 [nc, C, chunk]."""
    return fused_proj_mlp_q8_ring_plain(x, y, wo_q, wo_s, bo, ln_scale, ln_bias, unpack_w1(w1p), w1_s, b1,
                                        unpack_w2(w2p), w2_s, b2, gelu_version)


def _i32_column0(wp, lanes):
    """The int32 values whose little-endian bytes are column 0 of rows 4l ..
    4l + 3 of each chunk of the int8 bytes wp [nc, rows, cols], l < lanes:
    JAX's row 0 of the transposed chunk viewed as int32. [nc, lanes] int64."""
    b = wp[:, : 4 * lanes, 0].long().reshape(wp.shape[0], lanes, 4)
    u = b & 0xFF
    return u[..., 0] + (u[..., 1] << 8) + (u[..., 2] << 16) + (b[..., 3] << 24)


def stream_probe_plain(w1p, w2p, mode="dma"):
    """What the JAX probe returns (tools/exp_q8_pipeline.py:259-299), [1,
    128] fp32, for the port's packed w1 [nc, chunk, C] and w2 [nc, C, chunk]
    (int8, or the same bytes viewed as int32 along the last dim):
    - "dma": one sum broadcast to all 128 lanes: over chunks, JAX's row 0,
      lanes < 128 of each w1 and w2 chunk (the port's column 0 of the first
      rows; as int32 values of four rows' bytes for the int32 view);
    - "dequant" (int8 only): lane l, over chunks, the sums of w1 row l and
      w2 row l (JAX's column sums) of the widened chunk.
    Integer sums, exact, cast to fp32 once."""
    if mode not in ("dma", "dequant"):
        raise ValueError(f"stream_probe: unknown mode {mode!r}")
    if w1p.dtype == torch.int32:
        if mode != "dma":
            raise ValueError("stream_probe: the int32 view streams the same bytes in 'dma' mode only")
        b1, b2 = w1p.view(torch.int8), w2p.view(torch.int8)
        s = _i32_column0(b1, min(PROBE_LANES, b1.shape[1] // 4)).sum() + _i32_column0(
            b2, min(PROBE_LANES, b2.shape[1] // 4)).sum()
        return torch.full((1, PROBE_LANES), float(s), dtype=torch.float32, device=w1p.device)
    if w1p.dtype != torch.int8:
        raise ValueError(f"stream_probe: weights must be int8 or int32, got {w1p.dtype}")
    l1, l2 = min(PROBE_LANES, w1p.shape[1]), min(PROBE_LANES, w2p.shape[1])
    if mode == "dma":
        s = w1p[:, :l1, 0].long().sum() + w2p[:, :l2, 0].long().sum()
        return torch.full((1, PROBE_LANES), float(s), dtype=torch.float32, device=w1p.device)
    out = torch.zeros(PROBE_LANES, dtype=torch.int64, device=w1p.device)
    out[:l1] += w1p[:, :l1].long().sum((0, 2))
    out[:l2] += w2p[:, :l2].long().sum((0, 2))
    return out.to(torch.float32)[None]


def ablate_ring_plain(h, w1p, w1_scale, w2p, w2_scale=None, use_gelu=True, use_scale=True):
    """Σ_j cast(gelu?(h @ w1_j^T × s1_j?)) @ w2_j^T in fp32, cast to h's
    dtype (tools/exp_q8_pipeline.py:353-373): no wo, LN or biases; gelu is
    always the "v1" form, and w2_scale is accepted and never read, as in
    JAX."""
    dt = h.dtype
    t = h.float() @ unpack_w1(w1p).float().t()
    if use_scale:
        t = t * w1_scale.reshape(-1).float()
    if use_gelu:
        t = DK._gelu32(t, "v1")
    return (t.to(dt).float() @ unpack_w2(w2p).float().t()).to(dt)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


def stage_bytes(C, chunk, weight_bytes, grid):
    """Shared-memory bytes of one stage (csrc/q8_pipeline.cu stage_geom): a
    block's share of one chunk, ceil(chunk / 8 / grid) tiles of 8 w1 rows of
    C weights and ceil(C / 8 / grid) tiles of 8 w2 rows of chunk weights,
    each row padded by 16 bytes, each part rounded up to 16 bytes."""
    def a16(v):
        return -(-v // 16) * 16

    tiles1, tiles2 = -(-(chunk // 8) // grid), -(-(C // 8) // grid)
    return a16(tiles1 * 8 * (C * weight_bytes + _ROW_PAD)) + a16(tiles2 * 8 * (chunk * weight_bytes + _ROW_PAD))


@functools.lru_cache(maxsize=None)
def _card(dev):
    """(grid: one block per SM, a block's shared-memory bytes) of a CUDA device."""
    props = torch.cuda.get_device_properties(dev)
    return props.multi_processor_count, getattr(props, "shared_memory_per_block_optin", _SMEM_OPTIN)


def _check_point(name, dev, M, C, chunk, n_buf, weight_bytes, max_rows=_MAX_ROWS, k_align=32):
    """The grid of a launch at this point, or ValueError with the reason the
    card cannot hold it."""
    grid, optin = _card(dev)
    if M > max_rows:
        raise ValueError(f"{name}: at most {max_rows} activation rows, got {M}")
    if C % k_align or chunk % k_align:
        raise ValueError(f"{name}: C and chunk must be multiples of {k_align}, got C={C}, chunk={chunk}")
    tiles = max(-(-(chunk // 8) // grid), -(-(C // 8) // grid))
    if tiles > _MAX_TILES:
        raise ValueError(f"{name}: a block's share of chunk {chunk} or C {C} over {grid} blocks is {tiles} "
                         f"tiles of 8 rows, more than {_MAX_TILES}")
    need = n_buf * stage_bytes(C, chunk, weight_bytes, grid)
    if need + _STATIC_SMEM > optin:
        raise ValueError(f"{name}: chunk {chunk} x n_buf {n_buf} needs {n_buf} stages of "
                         f"{stage_bytes(C, chunk, weight_bytes, grid)} B = {need} B of shared memory per block "
                         f"({grid} blocks), more than the {optin} B a block may hold")
    return grid


def ring_depth(name, dev, M, C, H, chunk, weight_bytes, k_align):
    """(grid, n_buf) of a launch of a row-grouped ring kernel (csrc/w8a8.cu,
    csrc/mlp.cu: up to RING_ROWS activation rows): n_buf the most stages, up
    to 4 and to the chunk count, that a block can hold; ValueError with the
    arithmetic when not even one stage fits."""
    grid = _check_point(name, dev, M, C, chunk, 1, weight_bytes, RING_ROWS, k_align)
    stage = stage_bytes(C, chunk, weight_bytes, grid)
    return grid, min(H // chunk, 4, (_card(dev)[1] - _STATIC_SMEM) // stage)


def _check_shapes(name, pairs):
    """ValueError for the first (argument, got, want) whose got != want."""
    for arg, got, want in pairs:
        if got != want:
            raise ValueError(f"{name}: {arg} has shape (or size) {got}, expected {want}")


def _launched(err, name, point):
    """Raise ValueError for a point the card refused (cudaErrorInvalidValue 1,
    cudaErrorCooperativeLaunchTooLarge 720), RuntimeError for other errors."""
    if err in (1, 720):
        raise ValueError(f"{name}: the card refused {point} (CUDA error {err})")
    _build.check(err, name)


def _check_tensors(name, tensors, dtypes):
    dev = tensors[0][1].device
    for (arg, t), dtype in zip(tensors, dtypes):
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be a contiguous {dtype} tensor on {dev}, "
                             f"got {t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must start on a 16-byte boundary")


def _checked_mlp(name, x, y, wo_q, wo_s, bo, ln_scale, ln_bias, w1, w1_s, b1, w2, w2_s, b2, gelu_version):
    """The types and shapes of a CUDA call of #17 / #18 or their first
    design; w1 [H, C] or [nc, chunk, C], w2 [C, H] or [nc, C, chunk] (the
    packed wrapper checked those shapes). Returns (M, C, H)."""
    if gelu_version not in ("v1", "v2"):
        raise ValueError(f"{name}: unknown gelu version {gelu_version!r}")
    M, C = x.shape
    H = w1_s.shape[0]
    bf, i8 = torch.bfloat16, torch.int8
    _check_tensors(
        name,
        [("x", x), ("y", y), ("wo_q", wo_q), ("wo_s", wo_s), ("bo", bo), ("ln_scale", ln_scale),
         ("ln_bias", ln_bias), ("w1_q", w1), ("w1_s", w1_s), ("b1", b1), ("w2_q", w2), ("w2_s", w2_s), ("b2", b2)],
        (bf, bf, i8, bf, bf, bf, bf, i8, bf, bf, i8, bf, bf),
    )
    _check_shapes(name, (
        ("y", tuple(y.shape), (M, C)), ("wo_q", tuple(wo_q.shape), (C, C)), ("wo_s", tuple(wo_s.shape), (C,)),
        ("bo", tuple(bo.shape), (C,)), ("ln_scale", tuple(ln_scale.shape), (C,)),
        ("ln_bias", tuple(ln_bias.shape), (C,)), ("w1_q", w1.numel(), H * C), ("b1", tuple(b1.shape), (H,)),
        ("w2_q", w2.numel(), C * H), ("w2_s", tuple(w2_s.shape), (C,)), ("b2", tuple(b2.shape), (C,)),
    ))
    if w1.dim() == 2:
        _check_shapes(name, (("w1_q", tuple(w1.shape), (H, C)), ("w2_q", tuple(w2.shape), (C, H))))
    return M, C, H


def dense_point(name, M, C, H, chunk):
    """The contract of #17 / #18 on the card, that of #6's kernel
    (decode_layer_kernel.dense_plan: C in WIDTHS, H = 4C, M >= 1) with a
    chunk that is a multiple of 64 (a 64-wide tile of the packed w2 lies in
    one chunk); ValueError otherwise, before the library is asked."""
    if chunk % DK._BK:
        raise ValueError(f"{name}: on the card chunk must be a multiple of {DK._BK}, got chunk={chunk}")
    DK._check_shape(M, C, H, True)


def _dense_mlp(name, x, y, wo_q, wo_s, bo, ln_scale, ln_bias, w1, w1_s, b1, w2, w2_s, b2, gelu_version, chunk,
               packed):
    """One launch of csrc/decode_dense.cu::rq_fused_proj_mlp on int8 weights
    (#6's kernel and plan): w1 [H, C] or packed [nc, chunk, C] (its bytes),
    w2 [C, H] or packed [nc, C, chunk] through a tensor map of [nc C, chunk]."""
    M, C, H = _checked_mlp(name, x, y, wo_q, wo_s, bo, ln_scale, ln_bias, w1, w1_s, b1, w2, w2_s, b2, gelu_version)
    dense_point(name, M, C, H, chunk)
    w2m = w2.reshape(-1, chunk) if packed else w2
    return DK._proj_mlp(x, y, wo_q, wo_s, bo, ln_scale, ln_bias, w1.reshape(H, C), w1_s, b1, w2m, w2_s, b2,
                        gelu_version, chunk if packed else 0)


def _ring_mlp(name, x, y, wo_q, wo_s, bo, ln_scale, ln_bias, w1, w1_s, b1, w2, w2_s, b2, gelu_version,
              chunk, n_buf, packed):
    """Launch the full form of csrc/q8_pipeline.cu::rq_q8_ring_mlp (one
    cooperative launch; the first design of #17 / #18); w1 [H, C] or [nc,
    chunk, C], w2 [C, H] or [nc, C, chunk]."""
    M, C, H = _checked_mlp(name, x, y, wo_q, wo_s, bo, ln_scale, ln_bias, w1, w1_s, b1, w2, w2_s, b2, gelu_version)
    grid = _check_point(name, x.device, M, C, chunk, n_buf, 1)
    out = torch.empty_like(x)
    x2, h = torch.empty_like(x), torch.empty_like(x)
    t = torch.empty((M, H), dtype=x.dtype, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.rq_q8_ring_mlp(
            x.data_ptr(), y.data_ptr(), wo_q.data_ptr(), wo_s.data_ptr(), bo.data_ptr(), ln_scale.data_ptr(),
            ln_bias.data_ptr(), w1.data_ptr(), w1_s.data_ptr(), b1.data_ptr(), w2.data_ptr(), w2_s.data_ptr(),
            b2.data_ptr(), None, out.data_ptr(), x2.data_ptr(), h.data_ptr(), t.data_ptr(),
            M, C, H, chunk, n_buf, grid, int(packed), 1, 1 if gelu_version == "v1" else 2, 1, 0, DK.LN_EPS,
            torch.cuda.current_stream().cuda_stream,
        )
    _launched(err, "rq_q8_ring_mlp", f"chunk {chunk} x n_buf {n_buf}")
    return out


def _packed_shapes(name, w1p, w2p, chunk):
    if w1p.dim() != 3 or w1p.shape[1] != chunk or tuple(w2p.shape) != (w1p.shape[0], w1p.shape[2], chunk):
        raise ValueError(f"{name}: w1p [nc, {chunk}, C] and w2p [nc, C, {chunk}] expected, got "
                         f"{tuple(w1p.shape)} and {tuple(w2p.shape)}")


def fused_proj_mlp_q8_ring(x, y, wo_q, wo_s, bo, ln_scale, ln_bias, w1_q, w1_s, b1, w2_q, w2_s, b2,
                           gelu_version="v1", chunk=1536, n_buf=4):
    """Kernel wrapper (#17): the plain version for CPU tensors; for CUDA
    tensors it launches #6's kernel, csrc/decode_dense.cu::rq_fused_proj_mlp
    on the int8 w1_q [H, C] and w2_q [C, H] (one persistent launch), or
    raises: C in decode_layer_kernel.WIDTHS, H = 4C, M >= 1 and chunk % 64
    == 0 (dense_point), ValueError otherwise before the library is asked.
    chunk must divide H and n_buf lie in 1..8 on any device; neither sets a
    depth any more (dense_plan sets the stages), so every point gives the
    same bits as decode_layer_kernel.fused_proj_mlp_q8. One call on the card
    adds one to `fused_proj_mlp_q8_ring.launches` (not to #6's count)."""
    name = "fused_proj_mlp_q8_ring"
    kind = _device_kind(name, x)
    _check_chunk(name, w1_q.shape[0], chunk, n_buf)
    if kind == "cpu":
        return fused_proj_mlp_q8_ring_plain(x, y, wo_q, wo_s, bo, ln_scale, ln_bias, w1_q, w1_s, b1, w2_q, w2_s,
                                            b2, gelu_version)
    out = _dense_mlp(name, x, y, wo_q, wo_s, bo, ln_scale, ln_bias, w1_q, w1_s, b1, w2_q, w2_s, b2, gelu_version,
                     chunk, packed=False)
    fused_proj_mlp_q8_ring.launches += 1
    return out


fused_proj_mlp_q8_ring.launches = 0


def fused_proj_mlp_q8_packed(x, y, wo_q, wo_s, bo, ln_scale, ln_bias, w1p, w1_s, b1, w2p, w2_s, b2,
                             gelu_version="v1", chunk=1536, n_buf=4):
    """Kernel wrapper (#18): fused_proj_mlp_q8_ring on packed w1p [nc, chunk,
    C] and w2p [nc, C, chunk]; the same kernel, its w1 map that of w1p as
    [H, C] (the same bytes), its w2 map that of w2p as [nc C, chunk] (the
    tile of K k0 lies at column k0 mod chunk, row (k0 div chunk) C + its
    first channel). One call on the card adds one to
    `fused_proj_mlp_q8_packed.launches`."""
    name = "fused_proj_mlp_q8_packed"
    kind = _device_kind(name, x)
    _packed_shapes(name, w1p, w2p, chunk)
    _check_chunk(name, w1p.shape[0] * chunk, chunk, n_buf)
    if kind == "cpu":
        return fused_proj_mlp_q8_packed_plain(x, y, wo_q, wo_s, bo, ln_scale, ln_bias, w1p, w1_s, b1, w2p, w2_s,
                                              b2, gelu_version)
    out = _dense_mlp(name, x, y, wo_q, wo_s, bo, ln_scale, ln_bias, w1p, w1_s, b1, w2p, w2_s, b2, gelu_version,
                     chunk, packed=True)
    fused_proj_mlp_q8_packed.launches += 1
    return out


fused_proj_mlp_q8_packed.launches = 0


def fused_proj_mlp_q8_ring_v1(x, y, wo_q, wo_s, bo, ln_scale, ln_bias, w1_q, w1_s, b1, w2_q, w2_s, b2,
                              gelu_version="v1", chunk=1536, n_buf=4):
    """fused_proj_mlp_q8_ring through its first design (csrc/q8_pipeline.cu::
    rq_q8_ring_mlp: one cooperative launch, an n_buf-deep cp.async ring of
    chunk stages, at most 128 rows), CUDA tensors only: the A/B baseline of
    chip_smoke.py. Adds one to `fused_proj_mlp_q8_ring_v1.launches` per call."""
    name = "fused_proj_mlp_q8_ring_v1"
    if _device_kind(name, x) != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    _check_chunk(name, w1_q.shape[0], chunk, n_buf)
    out = _ring_mlp(name, x, y, wo_q, wo_s, bo, ln_scale, ln_bias, w1_q, w1_s, b1, w2_q, w2_s, b2,
                    gelu_version, chunk, n_buf, packed=False)
    fused_proj_mlp_q8_ring_v1.launches += 1
    return out


fused_proj_mlp_q8_ring_v1.launches = 0


def fused_proj_mlp_q8_packed_v1(x, y, wo_q, wo_s, bo, ln_scale, ln_bias, w1p, w1_s, b1, w2p, w2_s, b2,
                                gelu_version="v1", chunk=1536, n_buf=4):
    """fused_proj_mlp_q8_packed through its first design (rq_q8_ring_mlp
    with the packed chunk address), CUDA tensors only: the A/B baseline of
    chip_smoke.py. Adds one to `fused_proj_mlp_q8_packed_v1.launches` per
    call."""
    name = "fused_proj_mlp_q8_packed_v1"
    if _device_kind(name, x) != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    _packed_shapes(name, w1p, w2p, chunk)
    _check_chunk(name, w1p.shape[0] * chunk, chunk, n_buf)
    out = _ring_mlp(name, x, y, wo_q, wo_s, bo, ln_scale, ln_bias, w1p, w1_s, b1, w2p, w2_s, b2,
                    gelu_version, chunk, n_buf, packed=True)
    fused_proj_mlp_q8_packed_v1.launches += 1
    return out


fused_proj_mlp_q8_packed_v1.launches = 0


@functools.lru_cache(maxsize=None)
def probe_plan(C, H, sms=DK.SMS, rows=PROBE_ROWS):
    """#19's launch on the card: #6's plan (decode_layer_kernel.dense_plan
    with int8 weights) at B `rows` for width C: its cluster split of K,
    clusters, row tile (the ring's stage stride), ring stages and shared
    memory. C in WIDTHS and H = 4C, as for #6; ValueError otherwise."""
    return DK.dense_plan(rows, C, H, True, sms, wbytes=1)


def probe_tiles(plan, chunk, cta):
    """What CTA `cta` of #19 streams, in its producer's order (decode_dense.
    cuh's kStream: w1 [H, C] from w1p's bytes, then w2 through the map of
    the packed [nc C, chunk]): (product, tensor-map column, tensor-map row)
    of each 64 x 64 tile."""
    cid, rank = divmod(cta, plan.cluster)
    C, H = plan.C, plan.N
    for i, (tiles, k) in enumerate(((H // DK._TILE, C), (C // DK._TILE, H))):
        ks = k // plan.cluster
        for j in range(cid, tiles, plan.clusters):
            for kc in range(ks // DK._BK):
                k0 = rank * ks + kc * DK._BK
                yield (i, k0, j * DK._TILE) if i == 0 else (i, *DM.w2_coords(chunk, C, k0, j * DK._TILE))


def stream_probe(w1p, w2p, chunk=1536, n_buf=4, mode="dma"):
    """Kernel wrapper (#19): the plain version for CPU tensors; for CUDA
    tensors it launches csrc/stream_probe.cu::rq_stream_probe (#6's TMA
    weight ring without its products: every tile lands; "dequant" widens
    and sums every row) or raises. w1p [nc, chunk, C], w2p [nc, C, chunk]
    int8, or the same bytes viewed as int32 ("dma" only). On the card C in
    decode_layer_kernel.WIDTHS, H = nc chunk = 4C and chunk % 64 == 0
    (ValueError before the library is asked); n_buf is checked (1..8) and
    sets nothing (probe_plan sets the ring). Returns [1, 128] fp32. One
    call on the card adds one to `stream_probe.launches`."""
    name = "stream_probe"
    kind = _device_kind(name, w1p)
    if mode not in ("dma", "dequant"):
        raise ValueError(f"{name}: unknown mode {mode!r}")
    div = 4 if w1p.dtype == torch.int32 else 1
    if w1p.dim() != 3 or w1p.shape[1] != chunk or tuple(w2p.shape) != (w1p.shape[0], w1p.shape[2] * div, chunk // div):
        raise ValueError(f"{name}: w1p [nc, {chunk}, C] and w2p [nc, C, {chunk}] expected (int32: the last "
                         f"dims / 4), got {tuple(w1p.shape)} and {tuple(w2p.shape)}")
    _check_chunk(name, w1p.shape[0] * chunk, chunk, n_buf)
    if kind == "cpu":
        return stream_probe_plain(w1p, w2p, mode)
    if w1p.dtype not in (torch.int8, torch.int32) or (div == 4 and mode != "dma"):
        raise ValueError(f"{name}: int8 weights, or int32 in 'dma' mode, got {w1p.dtype} in {mode!r}")
    _check_tensors(name, [("w1p", w1p), ("w2p", w2p)], (w1p.dtype, w1p.dtype))
    C, H = w1p.shape[2] * div, w1p.shape[0] * chunk
    dense_point(name, PROBE_ROWS, C, H, chunk)
    return launch_probe(w1p, w2p, chunk, mode, probe_plan(C, H, _card(w1p.device)[0]))


def launch_probe(w1p, w2p, chunk, mode, plan):
    """One launch of csrc/stream_probe.cu on a plan of #6's ring
    (probe_plan at any B; stream_probe's checked arguments): the same sums
    on every plan. Adds one to `stream_probe.launches`."""
    div = 4 if w1p.dtype == torch.int32 else 1
    C, H = w1p.shape[2] * div, w1p.shape[0] * chunk
    b1, b2 = w1p.view(torch.int8).reshape(H, C), w2p.view(torch.int8).reshape(-1, chunk)
    out = torch.empty((1, PROBE_LANES), dtype=torch.float32, device=w1p.device)
    lib = _build.library()
    with torch.cuda.device(w1p.device):
        err = lib.rq_stream_probe(
            DK._tensor_map(b1), DK._tensor_map(b2), out.data_ptr(), C, H, chunk, plan.cluster, plan.clusters,
            plan.row_tile, plan.stages, plan.smem, (2 if div == 4 else 0) if mode == "dma" else 1,
            torch.cuda.current_stream().cuda_stream,
        )
    _launched(err, "rq_stream_probe", f"chunk {chunk}")
    stream_probe.launches += 1
    return out


stream_probe.launches = 0


def _ablate_checked(name, h, w1p, w1_scale, w2p, chunk, n_buf):
    """ablate_ring's refusals on any device, then on CUDA the types and
    shapes; returns ("cpu" or "cuda", w1_scale as [H])."""
    kind = _device_kind(name, h)
    _packed_shapes(name, w1p, w2p, chunk)
    _check_chunk(name, w1p.shape[0] * chunk, chunk, n_buf)
    s1 = w1_scale.reshape(-1)
    if kind == "cuda":
        if w1p.dtype not in (torch.int8, torch.bfloat16):
            raise ValueError(f"{name}: int8 or bf16 weights, got {w1p.dtype}")
        _check_tensors(name, [("h", h), ("w1p", w1p), ("w2p", w2p), ("w1_scale", s1)],
                       (torch.bfloat16, w1p.dtype, w1p.dtype, torch.bfloat16))
        if w1p.shape[2] != h.shape[1] or s1.numel() != w1p.shape[0] * chunk:
            raise ValueError(f"{name}: h [M, {w1p.shape[2]}] and w1_scale [{w1p.shape[0] * chunk}] expected, got "
                             f"{tuple(h.shape)} and {tuple(w1_scale.shape)}")
    return kind, s1


def ablate_ring(h, w1p, w1_scale, w2p, w2_scale=None, chunk=1536, n_buf=4, use_gelu=True, use_scale=True):
    """Kernel wrapper (#20): the plain version for CPU tensors; for CUDA
    tensors it launches the "ring" form of csrc/dense_mlp.cu (one persistent
    launch) on packed int8 or bf16 weights or raises: C in decode_layer_kernel.
    WIDTHS, H = 4C and chunk % 64 == 0 (ops/dense_mlp_kernel.py's contract).
    `chunk` is the packed layout's; `n_buf` is still checked (1..8) but is
    no longer a ring depth: the plan sets the kernel's. One call on the card
    adds one to `ablate_ring.launches`."""
    name = "ablate_ring"
    kind, s1 = _ablate_checked(name, h, w1p, w1_scale, w2p, chunk, n_buf)
    if kind == "cpu":
        return ablate_ring_plain(h, w1p, w1_scale, w2p, w2_scale, use_gelu, use_scale)
    plan = DM.device_plan(h, h.shape[1], w1p.shape[0] * chunk, "ring", w1p.element_size(), chunk)
    out = DM.launch(plan, h, w1p, w2p, s1=s1, gelu=int(use_gelu), use_scale=use_scale)
    ablate_ring.launches += 1
    return out


ablate_ring.launches = 0


def ablate_ring_v1(h, w1p, w1_scale, w2p, w2_scale=None, chunk=1536, n_buf=4, use_gelu=True, use_scale=True):
    """ablate_ring through its first design (the MLP-only form of
    csrc/q8_pipeline.cu::rq_q8_ring_mlp: one cooperative launch, an
    n_buf-deep cp.async ring of chunk stages), CUDA tensors only: the A/B
    baseline of chip_smoke.py. Adds one to `ablate_ring_v1.launches` per
    call."""
    name = "ablate_ring_v1"
    kind, s1 = _ablate_checked(name, h, w1p, w1_scale, w2p, chunk, n_buf)
    if kind != "cuda":
        raise ValueError(f"{name}: no kernel for device {h.device}")
    M, C = h.shape
    H = w1p.shape[0] * chunk
    grid = _check_point(name, h.device, M, C, chunk, n_buf, w1p.element_size())
    out = torch.empty_like(h)
    t = torch.empty((M, H), dtype=h.dtype, device=h.device)
    lib = _build.library()
    with torch.cuda.device(h.device):
        err = lib.rq_q8_ring_mlp(
            None, None, None, None, None, None, None, w1p.data_ptr(), s1.data_ptr(), None, w2p.data_ptr(), None,
            None, h.data_ptr(), out.data_ptr(), None, None, t.data_ptr(),
            M, C, H, chunk, n_buf, grid, 1, 0, int(use_gelu), int(use_scale), int(w1p.dtype == torch.bfloat16),
            DK.LN_EPS, torch.cuda.current_stream().cuda_stream,
        )
    _launched(err, "rq_q8_ring_mlp", f"chunk {chunk} x n_buf {n_buf}")
    ablate_ring_v1.launches += 1
    return out


ablate_ring_v1.launches = 0
