"""The W8A8 decode proj + LN2 + MLP: the counterpart of
tools/exp_w8a8.py::fused_proj_mlp_q8a8 (#16).

#6's function (ops/decode_layer_kernel.py::fused_proj_mlp_q8) with the two
MLP products taken on int8 activations too: LN2's output and each chunk
of the gelu output are quantized per row to int8, the products are s8 x s8
-> s32, and the row scale times the column scale multiplies the int32
sums. The CUDA kernel is csrc/w8a8.cu (its source note says what bounds it
on the H100 and how the design answers that); this module holds its
wrapper and the plain PyTorch version.

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

import torch

from rqvae_tpu_torch.ops import _build
from rqvae_tpu_torch.ops import decode_layer_kernel as DK
from rqvae_tpu_torch.ops import q8_pipeline_kernel as QP


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


def fused_proj_mlp_q8a8(x, y, wo_q, wo_s, bo, ln_scale, ln_bias, w1_q, w1_s, b1, w2_q, w2_s, b2,
                        gelu_version="v1", chunk=1536):
    """Kernel wrapper (#16): the plain version for CPU tensors; for CUDA
    tensors it launches csrc/w8a8.cu::rq_w8a8_mlp or raises. Refuses, on
    any device, weights that are not int8, an unknown gelu version and an H
    that chunk does not divide. One call on the card adds one to
    `fused_proj_mlp_q8a8.launches`."""
    name = "fused_proj_mlp_q8a8"
    kind = QP._device_kind(name, x)
    for arg, w in (("wo_q", wo_q), ("w1_q", w1_q), ("w2_q", w2_q)):
        if w.dtype != torch.int8:
            raise ValueError(f"{name}: {arg} must be int8, got {w.dtype}")
    if gelu_version not in ("v1", "v2"):
        raise ValueError(f"{name}: unknown gelu version {gelu_version!r}")
    M, C = x.shape
    H = w1_q.shape[0]
    QP._check_chunk(name, H, chunk, 1)
    if kind == "cpu":
        return fused_proj_mlp_q8a8_plain(x, y, wo_q, wo_s, bo, ln_scale, ln_bias, w1_q, w1_s, b1, w2_q, w2_s, b2,
                                         gelu_version, chunk)
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
    fused_proj_mlp_q8a8.launches += 1
    return out


fused_proj_mlp_q8a8.launches = 0
