"""The decode-shape MLP on bf16 weights: the counterpart of
tools/exp_mlp_kernel.py::pallas_mlp (#15).

out = x + gelu(LN(x) @ w1^T + b1) @ w2^T + b2, the decode MLP with no wo,
at the Pallas kernel's rounding points (tools/exp_mlp_kernel.py:48-72): LN
with one-pass fp32 statistics and rsqrt, h rounded to bf16; t = h @ w1^T +
b1 in fp32, gelu in fp32, t rounded to bf16; acc = t @ w2^T in fp32; out =
x + acc + b2 rounded once to x's dtype (where #3, #6 and #17 round the
MLP's output before they add it to the residual). h and t are bf16 whatever
x's dtype, as in the Pallas kernel's scratch. The JAX kernel has the erf
gelu only ("v1"); the port also takes "v2", the sigmoid form of the rest
of the package. `chunk` is a tiling: the result does not depend on it
beyond fp32 association.

The CUDA kernel is the "mlp" form of csrc/dense_mlp.cu (one persistent
launch on csrc/decode_dense.cu's machinery: wgmma, a TMA weight ring,
cluster split-K, one grid barrier; its source note says what bounds it on
the H100 and how the design answers that), planned by
ops/dense_mlp_kernel.py::mlp_plan: C in decode_layer_kernel.WIDTHS, H =
4C, any M >= 1. Its first design, csrc/mlp.cu::rq_mlp (a cooperative
cp.async ring, a grid barrier per chunk), stays as the A/B baseline
`fused_mlp_v1`, which only chip_smoke.py runs. This module holds the
wrappers and the plain PyTorch version. Weights in the port's nn.Linear
layout: w1 [H, C], w2 [C, H] (checkpoint/from_jax.py::mlp_weights_from_jax
turns the experiment's [C, H] / [H, C] arrays into these); the
LayerNorm's scale and bias are fp32, everything else bf16 on the card.
"""

from __future__ import annotations

import torch

from rqvae_tpu_torch.ops import _build
from rqvae_tpu_torch.ops import decode_layer_kernel as DK
from rqvae_tpu_torch.ops import dense_mlp_kernel as DM
from rqvae_tpu_torch.ops import q8_pipeline_kernel as QP


def fused_mlp_plain(x, ln_s, ln_b, w1, b1, w2, b2, gelu_version="v1"):
    """The JAX kernel's function (module docstring), in PyTorch."""
    bf = torch.bfloat16
    h = DK._layer_norm(x.float(), ln_s, ln_b).to(bf)
    t = DK._gelu32(h.float() @ w1.float().t() + b1.float(), gelu_version).to(bf)
    return (x.float() + t.float() @ w2.float().t() + b2.float()).to(x.dtype)


def _checked(name, x, ln_s, ln_b, w1, b1, w2, b2, gelu_version, chunk):
    """The wrappers' refusals on any device, then on CUDA the types and
    shapes; returns "cpu" or "cuda"."""
    kind = QP._device_kind(name, x)
    for arg, w in (("w1", w1), ("w2", w2)):
        if not w.dtype.is_floating_point:
            raise ValueError(f"{name}: {arg} must be floating point (bf16 on the card), got {w.dtype}")
    if gelu_version not in ("v1", "v2"):
        raise ValueError(f"{name}: unknown gelu version {gelu_version!r}")
    M, C = x.shape
    H = w1.shape[0]
    QP._check_chunk(name, H, chunk, 1)
    if kind == "cuda":
        bf, f32 = torch.bfloat16, torch.float32
        QP._check_tensors(name, [("x", x), ("ln_s", ln_s), ("ln_b", ln_b), ("w1", w1), ("b1", b1), ("w2", w2),
                                 ("b2", b2)], (bf, f32, f32, bf, bf, bf, bf))
        QP._check_shapes(name, (
            ("ln_s", tuple(ln_s.shape), (C,)), ("ln_b", tuple(ln_b.shape), (C,)), ("w1", tuple(w1.shape), (H, C)),
            ("b1", tuple(b1.shape), (H,)), ("w2", tuple(w2.shape), (C, H)), ("b2", tuple(b2.shape), (C,)),
        ))
    return kind


def fused_mlp(x, ln_s, ln_b, w1, b1, w2, b2, gelu_version="v1", chunk=1536):
    """Kernel wrapper (#15): the plain version for CPU tensors; for CUDA
    tensors it launches the "mlp" form of csrc/dense_mlp.cu (one persistent
    launch) or raises. Refuses, on any device, weights that are not floating
    point, an unknown gelu version and an H that chunk does not divide;
    `chunk` is a tiling of the hidden units that does not change the result,
    and the kernel's tiles do not depend on it. On the card also C outside
    decode_layer_kernel.WIDTHS or H != 4C. One call on the card adds one to
    `fused_mlp.launches`."""
    name = "fused_mlp"
    if _checked(name, x, ln_s, ln_b, w1, b1, w2, b2, gelu_version, chunk) == "cpu":
        return fused_mlp_plain(x, ln_s, ln_b, w1, b1, w2, b2, gelu_version)
    plan = DM.device_plan(x, x.shape[1], w1.shape[0], "mlp", 2)
    out = DM.launch(plan, x, w1, w2, ln_w=ln_s, ln_b=ln_b, b1=b1, b2=b2, gelu=1 if gelu_version == "v1" else 2)
    fused_mlp.launches += 1
    return out


fused_mlp.launches = 0


def fused_mlp_v1(x, ln_s, ln_b, w1, b1, w2, b2, gelu_version="v1", chunk=1536):
    """fused_mlp through its first design (csrc/mlp.cu::rq_mlp: one
    cooperative launch, a cp.async ring of n_buf chunk stages, a grid
    barrier per chunk; at most 512 rows), CUDA tensors only: the A/B
    baseline of chip_smoke.py. Adds one to `fused_mlp_v1.launches` per
    call."""
    name = "fused_mlp_v1"
    if _checked(name, x, ln_s, ln_b, w1, b1, w2, b2, gelu_version, chunk) != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    M, C = x.shape
    H = w1.shape[0]
    grid, n_buf = QP.ring_depth(name, x.device, M, C, H, chunk, 2, k_align=32)
    out, h = torch.empty_like(x), torch.empty_like(x)
    t = torch.empty((M, H), dtype=torch.bfloat16, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.rq_mlp(
            x.data_ptr(), ln_s.data_ptr(), ln_b.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), out.data_ptr(), h.data_ptr(), t.data_ptr(), M, C, H, chunk, n_buf, grid,
            1 if gelu_version == "v1" else 2, DK.LN_EPS, torch.cuda.current_stream().cuda_stream,
        )
    QP._launched(err, "rq_mlp", f"chunk {chunk} x n_buf {n_buf}")
    fused_mlp_v1.launches += 1
    return out


fused_mlp_v1.launches = 0
