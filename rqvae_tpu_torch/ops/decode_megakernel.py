"""One whole decode transformer layer step: LN1 + QKV, attention over the
KV cache with the in-place row write, wo + residual, LN2, MLP + residual.

Counterpart of rqvae_tpu/ops/decode_megakernel.py::decode_layer_step. The
CUDA kernel is csrc/decode_fused.cu::rq_fused_layer_step (one persistent
launch on csrc/decode_dense.cu's machinery: wgmma, a TMA weight ring,
cluster split-K, the attention on the consumer warps between grid
barriers; its source note says what bounds it on the H100 and how the
design answers that), planned by ops/decode_layer_kernel.py::fused_plan.
Its first, cooperative design (csrc/decode_megakernel.cu, nine phases of
wmma split-K tiles) stays as the A/B baseline `decode_layer_step_coop`,
which only chip_smoke.py runs. This module holds the wrappers and the
plain PyTorch version of the same function.

Contract (both versions): x [B, C], one layer's caches k_cache, v_cache
[B, T, C], weights in the nn.Linear [out, in] layout as the dense kernels
take them (wqkv the fused [3C, C] buffer, w1 [H, C], w2 [C, H]). Returns
out [B, C]; the layer's new k and v are written into row cur_len of both
caches IN PLACE (the JAX kernel returns them and its caller updates the
cache). The token attends cache rows t < min(cur_len, W) (W = t_window, or
T) plus its own k / v. Rounding points are the JAX kernel's
(decode_megakernel.py:70-206), in cd = x's dtype: h1 = LN1(x) in cd; q, k, v
summed in fp32 with the bias, one cast; score products k * q in cd summed
in fp32; fp32 softmax whose unnormalised weights are cast to cd before
v * w (in cd, summed in fp32) and the fp32 self term; att = (y / l) in cd;
x2 = x + (att @ wo + bo) cast; h2 = LN2(x2) in cd; t1 = gelu(h2 @ w1 + b1)
in fp32, cast; out = x2 + (t1 @ w2 + b2) cast. The JAX kernel runs the
softmax online over 16-row cache chunks; here it is one pass over the
window, which moves only where the weights round to cd (nothing in fp32).
The exact erf replaces the JAX kernel's polynomial one (within 1e-6).
"""

from __future__ import annotations

import math

import torch

from rqvae_tpu_torch.ops import _build
from rqvae_tpu_torch.ops import decode_layer_kernel as DK
from rqvae_tpu_torch.ops.decode_layer_kernel import LN_EPS, _gelu32, _layer_norm

# the only head size the CUDA kernel serves: it runs only on the unrolled
# sampling path (H·W <= 128), where every configuration of the repository
# has head size 64
HEAD_SIZE = 64


def decode_layer_step_plain(
    x, k_cache, v_cache, cur_len, ln1_scale, ln1_bias, wqkv, bqkv, wo, bo, ln2_scale, ln2_bias,
    w1, b1, w2, b2, n_head, t_window=None, gelu_version="v1",
):
    """Plain PyTorch version (module docstring)."""
    B, C = x.shape
    T = k_cache.shape[1]
    hs = C // n_head
    n = min(cur_len, T if t_window is None else min(t_window, T))
    scale = 1.0 / math.sqrt(hs)
    cd, f32 = x.dtype, torch.float32
    h1 = _layer_norm(x, ln1_scale, ln1_bias)
    q, k, v = (h1.float() @ wqkv.float().t() + bqkv.float()).to(cd).split(C, dim=-1)
    qh = q.reshape(B, 1, n_head, hs)
    kc = k_cache[:, :n].to(cd).reshape(B, n, n_head, hs)
    vc = v_cache[:, :n].to(cd).reshape(B, n, n_head, hs)
    s_past = torch.sum(kc * qh, dim=-1, dtype=f32) * scale  # [B, n, nh]
    s_self = torch.sum((k * q).reshape(B, 1, n_head, hs), dim=-1, dtype=f32) * scale
    s = torch.cat([s_past, s_self], dim=1)
    e = torch.exp(s - s.amax(dim=1, keepdim=True))
    y = torch.sum(vc * e[:, :n].to(cd)[..., None], dim=1, dtype=f32)  # [B, nh, hs]
    y = y + v.float().reshape(B, n_head, hs) * e[:, n, :, None]
    att = (y / e.sum(dim=1)[..., None]).reshape(B, C).to(cd)
    x2 = x + (att.float() @ wo.float().t() + bo.float()).to(cd)
    h2 = _layer_norm(x2, ln2_scale, ln2_bias)
    t1 = _gelu32(h2.float() @ w1.float().t() + b1.float(), gelu_version).to(cd)
    out = x2 + (t1.float() @ w2.float().t() + b2.float()).to(cd)
    k_cache[:, cur_len] = k.to(k_cache.dtype)
    v_cache[:, cur_len] = v.to(v_cache.dtype)
    return out


def _check(x, k_cache, v_cache, cur_len, params, n_head, W, name="decode_layer_step"):
    B, C = x.shape
    H = params["w1"].shape[0]
    shapes = {
        "x": (B, C), "ln1_scale": (C,), "ln1_bias": (C,), "wqkv": (3 * C, C), "bqkv": (3 * C,), "wo": (C, C),
        "bo": (C,), "ln2_scale": (C,), "ln2_bias": (C,), "w1": (H, C), "b1": (H,), "w2": (C, H), "b2": (C,),
    }
    T = k_cache.shape[1] if k_cache.dim() == 3 else -1
    tensors = {"x": x, "k_cache": k_cache, "v_cache": v_cache, **params}
    shapes.update(k_cache=(B, T, C), v_cache=(B, T, C))
    for arg, t in tensors.items():
        if t.device != x.device or t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(
                f"{name}: {arg} must be a contiguous bf16 tensor on {x.device}, "
                f"got {t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
            )
        if tuple(t.shape) != shapes[arg]:
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, expected {shapes[arg]}")
        if t.dim() >= 2 and t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must start on a 16-byte boundary")
    if C != n_head * HEAD_SIZE or H != 4 * C:
        raise ValueError(f"{name}: the kernel serves head size {HEAD_SIZE} and H == 4C, got C={C}, "
                         f"n_head={n_head}, H={H}")
    if not 0 <= cur_len < T:
        raise ValueError(f"{name}: cur_len={cur_len} outside the cache (T={T})")
    if W > _build.MAX_WINDOW:
        raise ValueError(f"{name}: the window holds at most {_build.MAX_WINDOW} rows, got {W}")


def _checked(name, x, k_cache, v_cache, cur_len, params, n_head, t_window, gelu_version) -> int:
    """The CUDA wrappers' checks (_check's and the device's, the gelu
    form's); returns the window W."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if gelu_version not in ("v1", "v2"):
        raise ValueError(f"{name}: unknown gelu version {gelu_version!r}")
    T = k_cache.shape[1]
    W = T if t_window is None else min(t_window, T)
    _check(x, k_cache, v_cache, cur_len, params, n_head, W, name)
    return W


def decode_layer_step(
    x, k_cache, v_cache, cur_len, ln1_scale, ln1_bias, wqkv, bqkv, wo, bo, ln2_scale, ln2_bias,
    w1, b1, w2, b2, n_head, t_window=None, gelu_version="v1",
):
    """Kernel wrapper: the plain version for CPU tensors; for CUDA tensors it
    launches csrc/decode_fused.cu::rq_fused_layer_step (bf16, head size 64,
    C in decode_layer_kernel.WIDTHS, H = 4C, contiguous) or raises. One
    launch adds one to `decode_layer_step.launches`."""
    params = dict(ln1_scale=ln1_scale, ln1_bias=ln1_bias, wqkv=wqkv, bqkv=bqkv, wo=wo, bo=bo,
                  ln2_scale=ln2_scale, ln2_bias=ln2_bias, w1=w1, b1=b1, w2=w2, b2=b2)
    if x.device.type == "cpu":
        return decode_layer_step_plain(x, k_cache, v_cache, cur_len, **params, n_head=n_head,
                                       t_window=t_window, gelu_version=gelu_version)
    W = _checked("decode_layer_step", x, k_cache, v_cache, cur_len, params, n_head, t_window, gelu_version)
    out = DK.fused_layer_step(x, k_cache, v_cache, cur_len, params, n_head, W, gelu_version)
    decode_layer_step.launches += 1
    return out


decode_layer_step.launches = 0


def decode_layer_step_coop(
    x, k_cache, v_cache, cur_len, ln1_scale, ln1_bias, wqkv, bqkv, wo, bo, ln2_scale, ln2_bias,
    w1, b1, w2, b2, n_head, t_window=None, gelu_version="v1",
):
    """decode_layer_step through its first, cooperative design
    (csrc/decode_megakernel.cu::rq_decode_layer_step), CUDA tensors only:
    the A/B baseline of chip_smoke.py. Adds one to
    `decode_layer_step_coop.launches` per launch."""
    params = dict(ln1_scale=ln1_scale, ln1_bias=ln1_bias, wqkv=wqkv, bqkv=bqkv, wo=wo, bo=bo,
                  ln2_scale=ln2_scale, ln2_bias=ln2_bias, w1=w1, b1=b1, w2=w2, b2=b2)
    W = _checked("decode_layer_step_coop", x, k_cache, v_cache, cur_len, params, n_head, t_window, gelu_version)
    B, C = x.shape
    T = k_cache.shape[1]
    H = w1.shape[0]
    out = torch.empty_like(x)
    work = torch.empty(_build.MAX_SPLITS * B * max(3 * C, H) * 4 + (2 * B * C + B * H) * 2,
                       dtype=torch.uint8, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.rq_decode_layer_step(
            x.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), ln1_scale.data_ptr(), ln1_bias.data_ptr(),
            wqkv.data_ptr(), bqkv.data_ptr(), wo.data_ptr(), bo.data_ptr(), ln2_scale.data_ptr(),
            ln2_bias.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
            work.data_ptr(), B, T, C, H, n_head, W, cur_len, int(gelu_version == "v2"), LN_EPS,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "rq_decode_layer_step")
    decode_layer_step_coop.launches += 1
    return out


decode_layer_step_coop.launches = 0
