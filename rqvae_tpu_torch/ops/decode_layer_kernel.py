"""The dense half of a decode transformer layer: LN1+QKV and proj+LN2+MLP.

Counterparts of rqvae_tpu/ops/decode_layer_kernel.py::fused_ln_qkv and
::fused_proj_mlp. The CUDA kernels are csrc/decode_layer.cu (its source
note says what bounds them on the H100 and how the design answers that);
this module holds their wrappers and the plain PyTorch versions.

Weights come in the nn.Linear [out, in] layout (wqkv is the fused [3C, C]
buffer), not the JAX [in, out] one. Rounding points follow the JAX kernels
(decode_layer_kernel.py:88-105 and :292-323): one-pass fp32 LayerNorm cast
to the activation dtype; products accumulated in fp32; for QKV the bias is
added to the fp32 sum before the one cast; the projection is cast before
`+ bo` and the residual; gelu runs in fp32 and is cast; `+ b2` in fp32,
then the cast, then the residual. The exact erf replaces the JAX kernel's
polynomial erf, a Mosaic workaround within 1e-6 of it.

fused_proj_mlp on the card is six launches behind one wrapper call (proj,
its epilogue, LN2+w1, gelu epilogue, w2, residual epilogue), since LN2
needs the whole of x2; it counts as one launch of the function.

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

import torch

from rqvae_tpu_torch.ops import _build

LN_EPS = 1e-5
_BK = 64  # reduction chunk of the CUDA GEMM (csrc/decode_layer.cu kBK)
_TARGET_BLOCKS = 264  # two waves of the H100's 132 SMs


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
    """Split-K factor: enough blocks to fill the card, K divisible by the
    split times the staged chunk."""
    blocks = -(-N // 64) * -(-M // 128)
    s = max(1, min(K // _BK, -(-_TARGET_BLOCKS // blocks)))
    while K % (s * _BK):
        s -= 1
    return s


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


def fused_ln_qkv(x, ln_scale, ln_bias, wqkv, bqkv):
    """Kernel wrapper: the plain version for CPU tensors; for CUDA tensors it
    launches csrc/decode_layer.cu::rq_fused_ln_qkv or raises. One call on
    the card adds one to `fused_ln_qkv.launches`."""
    if x.device.type == "cpu":
        return fused_ln_qkv_plain(x, ln_scale, ln_bias, wqkv, bqkv)
    if x.device.type != "cuda":
        raise ValueError(f"fused_ln_qkv: no kernel for device {x.device}")
    M, C = x.shape
    N = wqkv.shape[0]
    _check_cuda(
        "fused_ln_qkv",
        [("x", x), ("ln_scale", ln_scale), ("ln_bias", ln_bias), ("wqkv", wqkv), ("bqkv", bqkv)],
        [(M, C), (C,), (C,), (N, C), (N,)],
    )
    if C % _BK or N % 16:
        raise ValueError(f"fused_ln_qkv: needs C % {_BK} == 0 and N % 16 == 0, got C={C}, N={N}")
    s = _splits(M, N, C)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    work = torch.empty((s, M, N), dtype=torch.float32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.rq_fused_ln_qkv(
            x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(), wqkv.data_ptr(),
            bqkv.data_ptr(), out.data_ptr(), work.data_ptr(), M, N, C, s, LN_EPS,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "rq_fused_ln_qkv")
    fused_ln_qkv.launches += 1
    return out


fused_ln_qkv.launches = 0


def fused_proj_mlp(x, y, wo, bo, ln_scale, ln_bias, w1, b1, w2, b2, gelu_version="v1"):
    """Kernel wrapper: the plain version for CPU tensors; for CUDA tensors it
    runs the six launches of csrc/decode_layer.cu::rq_fused_proj_mlp or
    raises. One call on the card adds one to `fused_proj_mlp.launches`."""
    if x.device.type == "cpu":
        return fused_proj_mlp_plain(x, y, wo, bo, ln_scale, ln_bias, w1, b1, w2, b2, gelu_version)
    if x.device.type != "cuda":
        raise ValueError(f"fused_proj_mlp: no kernel for device {x.device}")
    if gelu_version not in ("v1", "v2"):
        raise ValueError(f"fused_proj_mlp: unknown gelu version {gelu_version!r}")
    M, C = x.shape
    H = w1.shape[0]
    _check_cuda(
        "fused_proj_mlp",
        [("x", x), ("y", y), ("wo", wo), ("bo", bo), ("ln_scale", ln_scale), ("ln_bias", ln_bias),
         ("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2)],
        [(M, C), (M, C), (C, C), (C,), (C,), (C,), (H, C), (H,), (C, H), (C,)],
    )
    if C % _BK or H % _BK:
        raise ValueError(f"fused_proj_mlp: needs C and H divisible by {_BK}, got C={C}, H={H}")
    so, s1, s2 = _splits(M, C, C), _splits(M, H, C), _splits(M, C, H)
    out = torch.empty_like(x)
    x2 = torch.empty_like(x)
    hidden = torch.empty((M, H), dtype=x.dtype, device=x.device)
    work = torch.empty((max(so * C, s1 * H, s2 * C) * M,), dtype=torch.float32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.rq_fused_proj_mlp(
            x.data_ptr(), y.data_ptr(), wo.data_ptr(), bo.data_ptr(), ln_scale.data_ptr(),
            ln_bias.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            out.data_ptr(), x2.data_ptr(), hidden.data_ptr(), work.data_ptr(),
            M, C, H, so, s1, s2, int(gelu_version == "v2"), LN_EPS,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "rq_fused_proj_mlp")
    fused_proj_mlp.launches += 1
    return out


fused_proj_mlp.launches = 0


def fused_ln_qkv_q8(x, ln_scale, ln_bias, wq, ws, bqkv):
    """Kernel wrapper: the plain version for CPU tensors; for CUDA tensors it
    launches csrc/decode_layer.cu::rq_fused_ln_qkv_q8 or raises. One call on
    the card adds one to `fused_ln_qkv_q8.launches`."""
    if x.device.type == "cpu":
        return fused_ln_qkv_q8_plain(x, ln_scale, ln_bias, wq, ws, bqkv)
    if x.device.type != "cuda":
        raise ValueError(f"fused_ln_qkv_q8: no kernel for device {x.device}")
    M, C = x.shape
    N = wq.shape[0]
    _check_cuda(
        "fused_ln_qkv_q8",
        [("x", x), ("ln_scale", ln_scale), ("ln_bias", ln_bias), ("wq", wq), ("ws", ws), ("bqkv", bqkv)],
        [(M, C), (C,), (C,), (N, C), (N,), (N,)],
        int8=("wq",),
    )
    if C % _BK or N % 16:
        raise ValueError(f"fused_ln_qkv_q8: needs C % {_BK} == 0 and N % 16 == 0, got C={C}, N={N}")
    s = _splits(M, N, C)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    work = torch.empty((s, M, N), dtype=torch.float32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.rq_fused_ln_qkv_q8(
            x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(), wq.data_ptr(), ws.data_ptr(),
            bqkv.data_ptr(), out.data_ptr(), work.data_ptr(), M, N, C, s, LN_EPS,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "rq_fused_ln_qkv_q8")
    fused_ln_qkv_q8.launches += 1
    return out


fused_ln_qkv_q8.launches = 0


def fused_proj_mlp_q8(
    x, y, wo_q, wo_s, bo, ln_scale, ln_bias, w1_q, w1_s, b1, w2_q, w2_s, b2, gelu_version="v1"
):
    """Kernel wrapper: the plain version for CPU tensors; for CUDA tensors it
    runs the six launches of csrc/decode_layer.cu::rq_fused_proj_mlp_q8 or
    raises. One call on the card adds one to `fused_proj_mlp_q8.launches`."""
    if x.device.type == "cpu":
        return fused_proj_mlp_q8_plain(
            x, y, wo_q, wo_s, bo, ln_scale, ln_bias, w1_q, w1_s, b1, w2_q, w2_s, b2, gelu_version
        )
    if x.device.type != "cuda":
        raise ValueError(f"fused_proj_mlp_q8: no kernel for device {x.device}")
    if gelu_version not in ("v1", "v2"):
        raise ValueError(f"fused_proj_mlp_q8: unknown gelu version {gelu_version!r}")
    M, C = x.shape
    H = w1_q.shape[0]
    _check_cuda(
        "fused_proj_mlp_q8",
        [("x", x), ("y", y), ("wo_q", wo_q), ("wo_s", wo_s), ("bo", bo), ("ln_scale", ln_scale),
         ("ln_bias", ln_bias), ("w1_q", w1_q), ("w1_s", w1_s), ("b1", b1), ("w2_q", w2_q),
         ("w2_s", w2_s), ("b2", b2)],
        [(M, C), (M, C), (C, C), (C,), (C,), (C,), (C,), (H, C), (H,), (H,), (C, H), (C,), (C,)],
        int8=("wo_q", "w1_q", "w2_q"),
    )
    if C % _BK or H % _BK:
        raise ValueError(f"fused_proj_mlp_q8: needs C and H divisible by {_BK}, got C={C}, H={H}")
    so, s1, s2 = _splits(M, C, C), _splits(M, H, C), _splits(M, C, H)
    out = torch.empty_like(x)
    x2 = torch.empty_like(x)
    hidden = torch.empty((M, H), dtype=x.dtype, device=x.device)
    work = torch.empty((max(so * C, s1 * H, s2 * C) * M,), dtype=torch.float32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.rq_fused_proj_mlp_q8(
            x.data_ptr(), y.data_ptr(), wo_q.data_ptr(), wo_s.data_ptr(), bo.data_ptr(),
            ln_scale.data_ptr(), ln_bias.data_ptr(), w1_q.data_ptr(), w1_s.data_ptr(), b1.data_ptr(),
            w2_q.data_ptr(), w2_s.data_ptr(), b2.data_ptr(), out.data_ptr(), x2.data_ptr(),
            hidden.data_ptr(), work.data_ptr(), M, C, H, so, s1, s2, int(gelu_version == "v2"), LN_EPS,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "rq_fused_proj_mlp_q8")
    fused_proj_mlp_q8.launches += 1
    return out


fused_proj_mlp_q8.launches = 0
