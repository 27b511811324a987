#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (rqvae_tpu_torch) on one NVIDIA GPU.

Phases, in order; any failure raises and the script exits non-zero:
  1. device: require CUDA, print the card's name and power limit;
  2. build: compile the port's CUDA kernels from csrc/ with nvcc;
  3. each kernel against its plain PyTorch version on the card, at the
     shapes of the 1.4B main path (bf16, B=100, C=1536, 24 heads, T=64);
  4. the main path: 1.4B class-conditional sampling at bs100 (bench.py's
     geometry, random weights from a seed, bf16 KV cache, temperature 1,
     no top-k/top-p) and the RQ-VAE decode to 256x256 pixels, with launch
     counts, output checks and ms/sample;
  5. forced_logits at B=8 through the kernels and through the plain
     versions, compared.
The second-to-last line is a JSON table of the kernels, the last line
{"ok": true, "device": {...}}.

Run from the repository root on a machine with one CUDA device:
    python3 chip_smoke.py
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# bf16 keeps 8 significant bits (relative step 2**-8 ~ 3.9e-3). A kernel and
# its plain version round at the same points but sum in another order, so a
# rounding can fall on the other side and a bf16 intermediate or output can
# differ by an ulp or two; elementwise |kernel - plain| <= TOL * (1 + |plain|)
# leaves room for that and still catches any wrong index or missing term.
TOL = 2e-2
# forced logits pass 48 layers of bf16 activations per position; the two
# paths round differently inside each kernel, so the O(1) hidden states and
# the logits (std ~0.8 here) drift apart by a few bf16 ulps. Over the 33M
# logits the extreme tail reaches ~0.1, so the elementwise bound is loose;
# the mean bound (about 5 bf16 ulps at the logits' scale) is the sharp one:
# a wrong row, head or term moves the mean error to the logits' own scale.
LOGIT_TOL = 2.5e-1
LOGIT_MEAN_TOL = 2e-2
# the bf16 decoder against an fp32 copy of itself, on [0, 1] pixels
PIXEL_TOL = 1e-1

BATCH = 100
ARCH_1P4B = dict(  # bench.py:83-98
    type="rq-transformer", vocab_size=16384, block_size=[8, 8, 4], embed_dim=1536,
    input_embed_dim=256, shared_tok_emb=True, shared_cls_emb=True, input_emb_vqvae=True,
    head_emb_vqvae=True, cumsum_depth_ctx=True, vocab_size_cond=1000, block_size_cond=1,
    body={"n_layer": 42, "block": {"n_head": 24}}, head={"n_layer": 6, "block": {"n_head": 24}},
)
DDCONFIG = dict(  # bench.py:115-121
    double_z=False, z_channels=256, resolution=256, in_channels=3, out_ch=3, ch=128,
    ch_mult=[1, 1, 2, 2, 4, 4], num_res_blocks=2, attn_resolutions=[8], dropout=0.0,
)
HPARAMS = dict(  # bench.py:122-128
    embed_dim=256, n_embed=16384, loss_type="mse", latent_shape=[8, 8, 256],
    code_shape=[8, 8, 4], shared_codebook=True, restart_unused_codes=True,
)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fns, n: int, warmup: int = 3) -> float:
    """Mean ms per call over n calls, rotating through fns (distinct input
    sets, so the 50 MB L2 does not hold one call's operands for the next)."""
    for i in range(warmup):
        fns[i % len(fns)]()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(n):
        fns[i % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def wall_s(fn):
    """(result, seconds) of fn(), synchronised on both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def decode(vqvae, codes):
    with torch.no_grad():
        return vqvae.decode_code(codes)


def compare(name: str, got, want, tol: float = TOL, mean_tol: float | None = None) -> tuple[float, float]:
    """Elementwise |got - want| <= tol * (1 + |want|), and mean |got - want|
    <= mean_tol when given; prints the max and mean abs error and the max
    error relative to the largest |want|."""
    g, w = got.float(), want.float()
    if g.shape != w.shape:
        raise AssertionError(f"{name}: shape {tuple(g.shape)} != {tuple(w.shape)}")
    if not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{name}: output not finite")
    diff = (g - w).abs()
    max_abs, mean_abs = float(diff.max()), float(diff.mean())
    max_rel = max_abs / max(float(w.abs().max()), 1e-30)
    ok = bool((diff <= tol * (1.0 + w.abs())).all()) and (mean_tol is None or mean_abs <= mean_tol)
    bound = f"|d| <= {tol}*(1+|ref|)" + (f", mean |d| <= {mean_tol}" if mean_tol is not None else "")
    log(f"  {name}: max_abs_err {max_abs:.3e} mean_abs_err {mean_abs:.3e} max_rel_err {max_rel:.3e} "
        f"bound {bound} {'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError(f"{name}: disagreement beyond the bound")
    return max_abs, max_rel


def check_attention(AK, dev, gen):
    B, C, nh, T = BATCH, 1536, 24, 64

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    q, kn, vn = rnd(B, C), rnd(B, C), rnd(B, C)
    kc, vc = rnd(B, T, C), rnd(B, T, C)
    worst = 0.0
    for window in (32, 64):
        for cur in (0, 15, 16, 63):
            k1, v1, k0, v0 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
            y1 = AK.decode_attention_update(q, kn, vn, k1, v1, cur, nh, t_window=window)
            y0 = AK.decode_attention_update_plain(q, kn, vn, k0, v0, cur, nh, t_window=window)
            torch.cuda.synchronize()
            err, _ = compare(f"decode_attention_update cur_len={cur} window={window}", y1, y0)
            worst = max(worst, err)
            keep = torch.ones(T, dtype=torch.bool, device=dev)
            keep[cur] = False
            if not (torch.equal(k1[:, cur], kn) and torch.equal(v1[:, cur], vn)):
                raise AssertionError(f"cache row {cur} was not set to k_new/v_new")
            if not (torch.equal(k1[:, keep], kc[:, keep]) and torch.equal(v1[:, keep], vc[:, keep])):
                raise AssertionError(f"cache rows other than {cur} changed")
    log("  decode_attention_update: row cur_len written, every other cache row bit-unchanged")
    # time the heaviest main-path call (window 64, cur_len 63) on 4 distinct
    # cache pairs (4 x 39 MB), so L2 does not carry one call's cache over
    sets = [(rnd(B, T, C), rnd(B, T, C)) for _ in range(4)]
    ms = cuda_ms([lambda s=s: AK.decode_attention_update(q, kn, vn, *s, 63, nh, 64) for s in sets], 50)
    plain = cuda_ms([lambda s=s: AK.decode_attention_update_plain(q, kn, vn, *s, 63, nh, 64) for s in sets], 50)
    log(f"  decode_attention_update time: kernel {ms:.4f} ms, plain {plain:.4f} ms (B={B}, W=64)")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain}


def check_dense(DK, dev, gen):
    B, C = BATCH, 1536
    H = 4 * C

    def rnd(*shape, std=1.0, mean=0.0):
        return (torch.randn(*shape, generator=gen, device=dev) * std + mean).to(torch.bfloat16)

    x, y = rnd(B, C), rnd(B, C)
    ln_s, ln_b = rnd(C, std=0.1, mean=1.0), rnd(C, std=0.1)
    qkv_sets = [(rnd(3 * C, C, std=0.02), rnd(3 * C, std=0.02)) for _ in range(8)]  # 8 x 14 MB
    mlp_sets = [
        (rnd(C, C, std=0.02), rnd(C, std=0.02), rnd(H, C, std=0.02), rnd(H, std=0.02),
         rnd(C, H, std=0.02), rnd(C, std=0.02))
        for _ in range(3)  # 3 x 42 MB
    ]
    got = DK.fused_ln_qkv(x, ln_s, ln_b, *qkv_sets[0])
    want = DK.fused_ln_qkv_plain(x, ln_s, ln_b, *qkv_sets[0])
    torch.cuda.synchronize()
    qkv_err, _ = compare("fused_ln_qkv x[100,1536] wqkv[4608,1536]", got, want)
    qkv_ms = cuda_ms([lambda s=s: DK.fused_ln_qkv(x, ln_s, ln_b, *s) for s in qkv_sets], 50)
    qkv_plain = cuda_ms([lambda s=s: DK.fused_ln_qkv_plain(x, ln_s, ln_b, *s) for s in qkv_sets], 50)
    log(f"  fused_ln_qkv time: kernel {qkv_ms:.4f} ms, plain {qkv_plain:.4f} ms")

    def proj_mlp(fn, s):
        wo, bo, w1, b1, w2, b2 = s
        return fn(x, y, wo, bo, ln_s, ln_b, w1, b1, w2, b2)

    got = proj_mlp(DK.fused_proj_mlp, mlp_sets[0])
    want = proj_mlp(DK.fused_proj_mlp_plain, mlp_sets[0])
    torch.cuda.synchronize()
    mlp_err, _ = compare("fused_proj_mlp wo[1536,1536] w1[6144,1536] w2[1536,6144]", got, want)
    wo, bo, w1, b1, w2, b2 = mlp_sets[1]
    got = DK.fused_proj_mlp(x, y, wo, bo, ln_s, ln_b, w1, b1, w2, b2, gelu_version="v2")
    want = DK.fused_proj_mlp_plain(x, y, wo, bo, ln_s, ln_b, w1, b1, w2, b2, gelu_version="v2")
    torch.cuda.synchronize()
    compare("fused_proj_mlp gelu v2 (sigmoid form)", got, want)
    mlp_ms = cuda_ms([lambda s=s: proj_mlp(DK.fused_proj_mlp, s) for s in mlp_sets], 30)
    mlp_plain = cuda_ms([lambda s=s: proj_mlp(DK.fused_proj_mlp_plain, s) for s in mlp_sets], 30)
    log(f"  fused_proj_mlp time: kernel {mlp_ms:.4f} ms, plain {mlp_plain:.4f} ms")
    return (
        {"max_abs_err": qkv_err, "ms": qkv_ms, "plain_ms": qkv_plain},
        {"max_abs_err": mlp_err, "ms": mlp_ms, "plain_ms": mlp_plain},
    )


def main() -> None:
    # phase 1: device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this check needs a CUDA device")
    card = card_line()
    log(card)
    dev = torch.device("cuda", 0)
    log(f"# torch {torch.__version__}, CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")

    sys.path.insert(0, ROOT)
    from rqvae_tpu_torch.models.rqtransformer import sampling as S
    from rqvae_tpu_torch.models.rqtransformer.config import TransformerConfig
    from rqvae_tpu_torch.models.rqtransformer.model import RQTransformer
    from rqvae_tpu_torch.models.rqvae.model import RQVAE, RQVAEHParams
    from rqvae_tpu_torch.models.rqvae.modules import DDConfig
    from rqvae_tpu_torch.ops import _build
    from rqvae_tpu_torch.ops import attention_kernel as AK
    from rqvae_tpu_torch.ops import decode_layer_kernel as DK

    # phase 2: build
    log("# phase 2: build")
    lib_path, build_s = _build.build()
    log(f"  built {os.path.relpath(lib_path, ROOT)} in {build_s:.1f} s (0.0: it was already built)")
    for line in (lib_path.parent / "ptxas.log").read_text().splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")
    _build.library()

    # phase 3: kernels against their plain versions at main-path shapes
    log("# phase 3: kernels vs plain versions (bf16, B=100, C=1536, nh=24, T=64)")
    gen = torch.Generator(device=dev).manual_seed(0)
    attn = check_attention(AK, dev, gen)
    qkv, mlp = check_dense(DK, dev, gen)

    # phase 4: the main path at full width
    log(f"# phase 4: 1.4B class-conditional sampling + RQ-VAE decode, bs{BATCH}, bf16, on {card}")
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    tconf = TransformerConfig.create(ARCH_1P4B)
    model = RQTransformer(tconf, device=dev, dtype=torch.bfloat16)
    model.init_weights(gen)
    vqvae = RQVAE(RQVAEHParams.create(HPARAMS), DDConfig.create(DDCONFIG), device=dev, dtype=torch.bfloat16)
    vqvae.init_weights(gen)
    torch.cuda.synchronize()
    n_ar = sum(p.numel() for p in model.parameters())
    n_vq = sum(p.numel() for p in vqvae.parameters())
    log(f"  rq-transformer {n_ar / 1e6:.0f}M params, rq-vae {n_vq / 1e6:.0f}M params, "
        f"built and initialised in {time.perf_counter() - t0:.1f} s")
    cond = torch.arange(BATCH, device=dev) % tconf.vocab_size_cond

    def sample(seed, kernels=True):
        return S.sample(model, BATCH, torch.Generator(device=dev).manual_seed(seed), cond=cond,
                        quantizer=vqvae.quantizer, temperature=1.0, kernels=kernels)

    _, warm_s = wall_s(lambda: sample(99))
    log(f"  warm-up sample: {warm_s:.2f} s")
    counters = (AK.decode_attention_update, DK.fused_ln_qkv, DK.fused_proj_mlp)
    for fn in counters:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    codes, sample_s = wall_s(lambda: sample(1))
    launches = {fn.__name__: fn.launches for fn in counters}
    want = {"decode_attention_update": 42 * 64, "fused_ln_qkv": 6 * 4 * 64, "fused_proj_mlp": 6 * 4 * 64}
    log(f"  launches in one sample(bs{BATCH}): {launches} (expected {want})")
    if launches != want:
        raise AssertionError("the main path did not launch each kernel the expected number of times")
    if codes.shape != (BATCH, 8, 8, 4) or int(codes.min()) < 0 or int(codes.max()) >= 16384:
        raise AssertionError(f"codes out of shape or range: {tuple(codes.shape)} [{int(codes.min())}, {int(codes.max())}]")
    log(f"  codes {tuple(codes.shape)} in [{int(codes.min())}, {int(codes.max())}], "
        f"{len(torch.unique(codes))} distinct")

    decode(vqvae, codes[:10])  # warm-up (cuDNN algorithm selection)
    pixels, decode_s = wall_s(lambda: decode(vqvae, codes))
    if pixels.shape != (BATCH, 256, 256, 3) or not bool(torch.isfinite(pixels).all()):
        raise AssertionError(f"pixels not finite or of shape {tuple(pixels.shape)}")
    pixels = (0.5 * pixels.float() + 0.5).clamp(0.0, 1.0)
    log(f"  pixels {tuple(pixels.shape)} finite, mean {float(pixels.mean()):.4f}")
    vq32 = copy.deepcopy(vqvae).float()
    compare("decode_code bf16 vs fp32 copy (4 images, [0,1] pixels)", pixels[:4],
            (0.5 * decode(vq32, codes[:4]).float() + 0.5).clamp(0.0, 1.0), PIXEL_TOL)
    del vq32
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    _, plain_s = wall_s(lambda: sample(1, kernels=False))
    log(f"  sampling (kernels): {sample_s * 1e3 / BATCH:.3f} ms/sample; sampling (plain versions): "
        f"{plain_s * 1e3 / BATCH:.3f} ms/sample; decode: {decode_s * 1e3 / BATCH:.3f} ms/sample; "
        f"total {(sample_s + decode_s) * 1e3 / BATCH:.3f} ms/sample; peak memory {peak_gb:.1f} GiB; "
        f"bs{BATCH}, bf16 cache, {card}")

    # phase 5: the same path through the kernels and through the plain versions
    log("# phase 5: forced_logits at B=8, kernels vs plain versions")
    forced, fcond = codes[:8], cond[:8]
    got = S.forced_logits(model, forced, fcond, vqvae.quantizer, kernels=True)
    ref = S.forced_logits(model, forced, fcond, vqvae.quantizer, kernels=False)
    torch.cuda.synchronize()
    log(f"  logits {tuple(ref.shape)}, std {float(ref.std()):.3f}")
    compare("forced_logits kernels vs plain", got, ref, LOGIT_TOL, LOGIT_MEAN_TOL)

    kernels = [
        dict(name="decode_attention_update", route="cuda", source="rqvae_tpu_torch/csrc/decode_attention.cu",
             replaces="rqvae_tpu/ops/attention_kernel.py:316", **attn),
        dict(name="fused_ln_qkv", route="cuda", source="rqvae_tpu_torch/csrc/decode_layer.cu",
             replaces="rqvae_tpu/ops/decode_layer_kernel.py:109", **qkv),
        dict(name="fused_proj_mlp", route="cuda", source="rqvae_tpu_torch/csrc/decode_layer.cu",
             replaces="rqvae_tpu/ops/decode_layer_kernel.py:329", **mlp),
    ]
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
