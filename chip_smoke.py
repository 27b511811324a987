#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (rqvae_tpu_torch) on one NVIDIA GPU.

Phases, in order; any failure raises and the script exits non-zero:
  1. device: require CUDA, print the card's name and power limit; turn
     TF32 off for cuDNN and for fp32 matmuls, so that every fp32 reference
     below is fp32;
  2. build: compile the port's CUDA kernels from csrc/ with nvcc, one
     process per source, all at once; libw8a8.so must hold IMMA (s8
     tensor-core), libdense_w8a8.so IGMMA (s8 wgmma), and
     libdecode_dense.so, libdecode_fused.so, libdense_mlp.so,
     libdense_w8a8.so and libnearest_code.so HGMMA (wgmma) instructions,
     libnearest_code.so and libstream_probe.so UTMALDG (TMA tile loads),
     libstream_probe.so SYNCS (mbarrier);
  3. each of the sixteen kernels against its plain PyTorch version on the
     card, at the shapes of its main path (the sampling kernels: bf16
     activations, B=100, C=1536, 24 heads, T=64, H=6144; #2 fused_ln_qkv
     and #3 fused_proj_mlp (csrc/decode_dense.cu), and the same kernels on
     int8 weights, #5/#7 fused_ln_qkv_q8 and #6/#8 fused_proj_mlp_q8, also
     at B 37, 300 and 500, #3 / #6 with both gelu forms, and at C 2560
     (bench's 3800M width), each call one device kernel (torch.profiler),
     timed also against the split-K kernels they replaced (device time in
     CUDA graphs, eager time, the host time of a wrapper call); the read-only
     decode attention #10 / #12 (csrc/decode_attention_tma.cu's read-only
     form, one launch a call) also at the experiment's B 500, cur_len == T,
     on a [4, 100, 257, 1536] stack at cur_len 256 and 257, at head size
     104 on a [2, 100, 257, 1664] stack of 16 heads, and at the f8 stacked
     sampler's long windows (T 1025 and 1056) and T 2048, its caches
     bit-unchanged, timed at #10's own shape (B 100, T 64, cur_len 63), on
     the stacks at cur_len 1, 64, 128 and 256 and at T = cur_len = 1056 as
     CUDA-graph device time against its first design (decode_attention_v1),
     SDPA over the same rows and the bound, with a sweep of head groups and
     stage sizes at 256 rows and CTA 0's phases; the update
     attention #1 / #4 (csrc/decode_attention_tma.cu, one launch each) at
     B 100 at both sampler windows, B 37, B 8 and head size 104, #1's
     written row equal to k_new / v_new and every other row bit-unchanged,
     #4's four caches bit-equal to the plain version's, timed as CUDA-graph
     device time against their first design (*_v1) and SDPA, with a sweep
     of launch plans, each also streaming its copies alone, and CTA 0's
     phases; int8 caches and weights for the q8 kernels, and the read-only q8
     attention decode_attention_q8 (#11, the same file's read-only int8
     form) at the experiment's shapes (B 100 and 500), cur_len == T,
     cur_len 0, a ragged batch, head size 104 and windows of 1024 and 1056
     rows, its caches bit-unchanged,
     timed as CUDA-graph device time against its first design
     (decode_attention_q8_v1) and #10 on the same rows, with the plan sweep
     and CTA 0's phases;
     decode_layer_step (#14) and decode_attention_q8_update_wo (#13), one
     launch each of csrc/decode_fused.cu, also at a ragged batch of 37 rows,
     both windows, both gelu forms (#14), int8 and bf16 wo (#13), timed as
     device time in CUDA-graph replays against their cooperative first
     design (*_coop) and the unfused chains (#2 -> #1 -> #3; #4 -> the
     library's wo, residual and LayerNorm), with CTA 0's phase and
     attention-step stamps; nearest_code (csrc/nearest_code.cu, 3xTF32 on
     wgmma): fp32, 6400 rows of 256 against 16384 codes, with planted ties
     placed on its geometry, timed as CUDA-graph device time against the
     library's x @ cb.T and both bounds (3xTF32, fp32 SIMT); the q8 pipeline
     kernels of
     tools/exp_q8_pipeline.py at its shapes, C 1536, H 6144, int8 weights:
     #17 / #18 (#6's kernel, csrc/decode_dense.cu, one launch a call; #18
     through the packed w2's map) at B 37, 100 and 300, both gelu forms and
     five (chunk, n_buf) points, bit-equal to each other and to #6, timed as
     CUDA-graph device time against their first design (*_v1) and the
     library; #19 (csrc/stream_probe.cu: #6's TMA ring without its
     products, on #6's plan) in both modes, bit-equal, timed as CUDA-graph
     device time and GB/s beside #6's weight-stream rate, with CTA 0's
     stamps; #20 (the "ring" form of
     csrc/dense_mlp.cu, one launch a call) in the four ablation cases, timed
     as CUDA-graph device time against its first design (ablate_ring_v1) and
     the library, with CTA 0's phases; #16 of tools/exp_w8a8.py
     (csrc/dense_w8a8.cu, one launch a call, s8 wgmma) at B 100, chunks 1536
     and 768, both gelu forms, a ragged B 37, B 300 and 500 and C 2560, its
     output moving with the chunk as the plain version's does, timed as
     CUDA-graph device time against its first design (fused_proj_mlp_q8a8_v1),
     #6 and the library, with CTA 0's phases, and against #6 at B 300 and
     500; #15 of tools/exp_mlp_kernel.py (the
     "mlp" form of csrc/dense_mlp.cu, one launch a call) at B 37, 100, 129
     and 500, both gelu forms, timed at B 100 and 500 as CUDA-graph device
     time against its first design (fused_mlp_v1) and the library, at B 500
     also on 128-row tiles, with CTA 0's phases), timed against the plain
     version, a library call where one exists, and the card's bound; the
     fused kernels print where their time went, phase by phase;
  4. the main path at six operating points: bench.py's three (bf16 cache;
     int8 KV cache "kv_q8"; int8 weights + kv_q8, whose body S == 1 steps
     run the int8 dense pair #5 / #6 as the head's do), each also with its
     fused body-layer path (bf16+mega: decode_layer_step; kv_q8+attn_wo and
     int8+kv_q8+attn_wo: decode_attention_q8_update_wo, the int8 body's QKV
     half through #5): 1.4B
     class-conditional sampling at bs100 (bench.py's geometry, random
     weights from a seed, temperature 1, no top-k/top-p) and the RQ-VAE
     decode to 256x256 pixels, each point with its launch counts (all
     counts set to 0 just before each of its ROUNDS timed sample calls and
     checked after it), output checks, ms/sample (the median of those
     calls) and peak memory;
  5. forced_logits at B=8 through the kernels and through the plain
     versions, compared, at each operating point;
  6. the RQ-VAE encode side at full width, bf16, bs100: the forward
     (encode, residual quantization through nearest_code, decode) of the
     bf16 point's decoded images, with its launch counts (4 nearest_code
     per forward), output checks, ms/image for the forward and for
     get_codes, peak memory, and code agreement with use_kernel=False;
  7. the stacked-cache sampler (more than 128 positions) at the zoo's
     vqgan_huge (measure_throughput.build(16, "vqgan_huge", 1, 16384): embed
     1536, 48 body layers, no head layers, 24 heads, 16x16x1 codes, codebook
     16384, the f16 RQ-VAE), bs100, after phase 6 has freed the 1.4B model:
     launch counts of each of ROUNDS timed sample calls (48 x 257
     decode_attention_stacked, each also a decode_attention launch, no other
     kernel), output checks, ms/sample (median), decode ms/sample, peak
     memory, and forced_logits at B=8 through the kernels against the plain
     versions; then the same at the zoo's vqgan_large (embed 1664, 24 body
     layers, 16 heads of 104, codebook 1024): 24 x 257 launches per call;
  8. the port of tools/exp_attn_q8cache.py (rqvae_tpu_torch.tools.
     exp_attn_q8cache) at B 100 and 500, T 64, 50 calls per chain:
     decode_attention (#10) against decode_attention_q8 (#11), each chain
     captured in a CUDA graph and replayed, with the exact launch counts it
     issues (each replay counted) and every other counter 0, and which cache
     form it finds faster;
  9. the port of tools/exp_q8_pipeline.py (rqvae_tpu_torch.tools.
     exp_q8_pipeline) at B 100, C 1536, H 6144, 16 layers, the full sweeps
     and probes, chains of PIPE_ITERS x 16 calls captured in CUDA graphs:
     #6 against #17-#20, with the exact launch counts it issues, every other
     counter 0 (the first designs' too), and no FAILED point of #17 / #18
     (every chunk of the sweeps is in their contract);
 10. the port of tools/exp_w8a8.py (rqvae_tpu_torch.tools.exp_w8a8) at B
     100, 16 layers, chains of W8A8_ITERS x 16 calls captured in CUDA
     graphs: #3 (bf16) and #6 (q8), each the single-launch kernel (its
     chain time beside the split-K design's), and #16 (q8a8), with the
     exact launch counts it issues and every other counter 0;
 11. the port of tools/exp_mlp_kernel.py (rqvae_tpu_torch.tools.
     exp_mlp_kernel) at B 100 and 500, 24 layers, chains of MLP_ITERS x 24
     calls: the plain xla_mlp against #15, with #15's exact launch counts
     and every other counter 0 (fused_mlp_v1's too);
 12. the stage-2 trainer (rqvae_tpu_torch.trainers.trainer_stage2; no
     kernel on its path): (a) at full width and cut depth (embed 1536, 2
     body and 1 head layer, vocab 16384, 4 images of 256x256, fp32, TF32
     off, dropout 0, 2 microbatches) one train step on the card and the
     same step on this machine's CPU from the same weights, the frozen
     encode and soft codes compared, the losses, grad_norm, gradients and
     updated weights held to the TRAIN_* tolerances; (b) bench's 1.4B
     RQ-Transformer, amp bf16, resid_pdrop 0.1, with a frozen bf16 copy of
     bench's RQ-VAE encoder: 5 steps of 32 images as 2 microbatches on one
     fixed batch, every kernel count 0, finite losses, loss_total falling,
     the EMA moved, one eval step; ms/step, peak memory, tokens/s and the
     share of the bf16 dense peak; (c) the last step again with remat, its
     losses against the plain step's and its peak memory;
 13. the stage-1 trainer (rqvae_tpu_torch.trainers.trainer_stage1; #9
     nearest_code on its path, one launch per depth): (a) at the committed
     synthetic stage-1 geometry (tests/goldens/synth_ckpt/stage1: 64x64
     images, ch 32, 8x8x2 codes, 64 shared codes), B 4, for 3 seeds, 2
     fp32 steps with the discriminator and fp32 LPIPS on the card and on
     this machine's CPU from the same weights and restart draws, the CPU
     on the card's discriminator branches, the plain argmin on both:
     metrics, codes, both steps' gradients, the weights after step 2's
     Adam update, codebooks and running stats held to the S1_* bounds,
     beside the CPU's second conv path as a witness and a TF32 control
     that must break a bound; (b) the 8x8x4 RQ-VAE at full width
     (DDCONFIG / HPARAMS),
     NLayerDiscriminator(ndf 64, 3 layers), LPIPS on synthetic weights in
     bf16, Adam (0.5, 0.9) with the fix schedule for both, fp32: 5 steps
     of 32 random 256x256 images and an eval step, nearest_code launched
     4 x 5 + 4 times and no other kernel, finite losses and g_weight, the
     codebook moved; ms/step, images/s, peak memory, model TFLOP a step
     and its share of the peaks; checkpointing when the activations the
     step keeps do not fit beside 8 GiB (counted on the meta device); (c)
     the last step again with use_kernel=False (depth-0 codes on >= 99%,
     metrics within S1_PLAIN_RTOL), every row at each depth where #9's
     pick differs from the plain argmin's on #9's own inputs within
     NEAREST_TIE_TOL of the fp64 minimum, and #9's device us per launch
     in a profiled step.
The second-to-last line is a JSON table of the kernels, the last line
{"ok": true, "device": {...}}.

Run from the repository root on a machine with one CUDA device:
    python3 chip_smoke.py
`python3 chip_smoke.py dense` runs phases 1-2 and phase 3's checks of the
dense pair, bf16 and int8 (check_dense), and of the two fused kernels
(#14, #13), and prints no result line; `python3 chip_smoke.py fused` the
fused kernels' checks alone; `python3 chip_smoke.py attention` those of
the attention kernels of csrc/decode_attention_tma.cu alone: the update
forms #1 / #4, then the read-only forms #10 / #12 and #11; `python3
chip_smoke.py mlp` those of #15 and #20 (csrc/dense_mlp.cu) alone; `python3
chip_smoke.py q8` those of #16-#19 (csrc/dense_w8a8.cu, #6's kernel,
csrc/stream_probe.cu) alone; `python3 chip_smoke.py nearest` that of #9
(csrc/nearest_code.cu) alone; `python3 chip_smoke.py train` phases 1 and
12 alone (no build: no kernel lies on the stage-2 training path). Run from two source trees in one call, they
compare two designs of those kernels on one card. `python3 chip_smoke.py
stage1` runs phases 1, 2 and 13 alone.
"""

from __future__ import annotations

import copy
import json
import os
import re
import statistics
import subprocess
import sys
import time
import warnings
from unittest import mock

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))

# the card's peaks for the bound (NVIDIA H100 SXM data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
INT8_TENSOR_OPS = 1979e12
TF32_TENSOR_FLOPS = 495e12
FP32_FLOPS = 67e12

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
# nearest_code: a row's fp32 distances carry a few ulps of ||x||^2 + ||c||^2
# (the terms summed), so the kernel and the plain version may pick different
# codes only where two distances lie that close; the kernel's pick may
# exceed the fp64 minimum by at most this times ||x||^2 + ||c_pick||^2
NEAREST_TIE_TOL = 1e-5
NEAREST_AGREE = 0.999  # least share of rows on which kernel and plain codes are equal
ENCODE_AGREE = 0.99  # least depth-0 agreement of use_kernel=True and False codes

BATCH = 100
# timed sample calls per operating point: host-clock times vary by up to
# 50% between calls, so phase 4 reports their median
ROUNDS = 3
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

# phase 12: the stage-2 trainer. (a) the card's step against the CPU's at
# full width and cut depth, fp32; (b) bench's 1.4B at full depth, amp bf16
TRAIN_CUT_ARCH = dict(ARCH_1P4B, body={"n_layer": 2, "block": {"n_head": 24, "resid_pdrop": 0.0}},
                      head={"n_layer": 1, "block": {"n_head": 24, "resid_pdrop": 0.0}})
TRAIN_CUT_BATCH = 4
TRAIN_BATCH, TRAIN_ACCUM, TRAIN_STEPS, ENCODE_CHUNK = 32, 2, 5, 16
# adamW with the clip; cosine from the first update (no warmup), so that
# every update moves the weights
TRAIN_OPTIM = {"type": "adamW", "betas": [0.9, 0.95], "weight_decay": 1e-4, "max_gn": 1.0}
TRAIN_WARMUP = {"epoch": 0, "min_lr": 1e-5}
TRAIN_LR = 3e-4
# (a): fp32 on both sides, TF32 off, sums in other orders: losses and
# grad_norm to 1e-5 relative; each gradient to 1e-4 of its tensor's max
# (plus 1e-6 of the largest, for the key biases, whose gradient is 0 in
# exact arithmetic and rounding noise here); the updated weights to 1e-6
# where the CPU's gradient is above 1e-4 of its tensor's max and 1e-6 of
# the largest, and within two learning rates elsewhere (Adam's step there
# is +-lr whichever way noise tips the gradient)
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_TOL = 1e-4
TRAIN_PARAM_ATOL = 1e-6
REMAT_LOSS_TOL = 1e-3  # (c): remat against the plain step on the same weights and masks

# phase 13: the stage-1 trainer. (a) the card's fp32 step against the CPU's
# at the committed synthetic stage-1 geometry
# (tests/goldens/synth_ckpt/stage1/config.yaml); (b) the 8x8x4 RQ-VAE at
# full width (DDCONFIG / HPARAMS, tools/train_probe.py:37-46)
S1_CUT_DD = dict(double_z=False, z_channels=32, resolution=64, in_channels=3, out_ch=3, ch=32, ch_mult=[1, 2, 2, 2],
                 num_res_blocks=1, attn_resolutions=[8], dropout=0.0)
S1_CUT_HP = dict(bottleneck_type="rq", embed_dim=16, n_embed=64, latent_shape=[8, 8, 16], code_shape=[8, 8, 2],
                 shared_codebook=True, decay=0.99, restart_unused_codes=True, loss_type="mse", latent_loss_weight=0.25)
S1_CUT_BATCH, S1_CUT_STEPS, S1_CUT_SEEDS = 4, 2, (13, 14, 15)
S1_BATCH, S1_STEPS = 32, 5  # B 32: the reference's per-GPU batch (tools/train_probe.py:77)
S1_DISC = dict(ndf=64, n_layers=3)
# both optimizers: the configs' Adam (0.5, 0.9) at 4e-5 with the "fix"
# warmup from zero over half of a 10-step epoch
S1_OPTIM = {"type": "adam", "betas": [0.5, 0.9], "weight_decay": 0.0}
S1_WARMUP = {"epoch": 0.5, "multiplier": 1, "buffer_epoch": 0.0, "min_lr": 4e-5, "mode": "fix", "start_from_zero": True}
S1_LR = 4e-5
# (a): fp32 on both sides, TF32 off, the plain argmin on both, the CPU on
# the card's discriminator branches (stage1_vs_cpu). Without that, a
# LeakyReLU input within rounding of 0 that takes the other branch moves
# g_weight by up to 4e-4 and gradients by up to 2.5e-2 of their max (the
# CPU's oneDNN and native convs, seeds 13-15: every such reading came with
# such a flip, none without one); an H100 without the replay read 2.3e-4
# on g_weight at step 2. On the same branches the CPU's second path reads
# (seeds 13-15) losses to 5.2e-6 relative, g_weight to 1.8e-5, gradients to
# 2.3e-4 of a tensor's max (a GroupNorm'd conv bias, whose gradient is 0 in
# exact arithmetic, to 2e-6 of the largest), weights after step 2 to one
# fp32 ulp of a GroupNorm scale (0.015 lr) where a gradient is sure, and
# codebooks to 1.9e-6 of their max. On an H100 the card reads (seeds
# 13-15) 1.4e-5, 1.3e-5, 1.3e-4, 0.015 lr and 2.4e-6, and the control,
# the card's convs in TF32, 2.3e-2, 1.4e-2, 0.21, 1.9 lr and 4.6e-3: each
# bound below lies between the two. Step 1 runs at lr 0 (the warmup from
# zero), step 2 at 8e-6: its Adam update is compared.
S1_LOSS_RTOL = 1e-4
S1_G_WEIGHT_RTOL = 1e-4
S1_GRAD_TOL = 1e-3
S1_CODEBOOK_TOL = 1e-4
S1_PARAM_RTOL = 0.1
# (c): the last step again with use_kernel=False from the same state and
# draws. Each row where #9 and the plain argmin pick differently is held
# to NEAREST_TIE_TOL of the fp64 minimum at every depth, on the inputs #9
# saw; the codes moved so change the losses (2e-4 to 5e-4 relative on
# g_weight, the largest, on an H100), so each metric within 5e-3
# relative (+ 1e-5)
S1_PLAIN_RTOL = 5e-3


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


def graph_ms(fns, reps: int = 10) -> float:
    """Mean device ms per call of fns (distinct input sets, called in turn),
    captured once in a CUDA graph and replayed `reps` times: back to back on
    the device without the host's dispatch between the calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up outside the capture
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in fns:
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * len(fns))


def bound(n_bytes: float, flops: float, peak_flops: float, fp32_flops: float = 0.0, more=()) -> dict:
    """The least time the card could take: the larger of the bytes over HBM
    bandwidth (each input read once, each output written once) and the
    operations over the peak rate of their type (`flops` at `peak_flops`,
    plus `fp32_flops` at the fp32 peak for a kernel that does both, plus
    each (operations, peak) of `more`)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / peak_flops + fp32_flops / FP32_FLOPS + sum(f / peak for f, peak in more)
    by = "bytes" if t_bytes >= t_ops else "operations"
    return {"bound_ms": max(t_bytes, t_ops) * 1e3, "bound_by": by}


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


def timed_samples(name, sample, counters, want):
    """A warm-up call sample(99), then ROUNDS timed calls sample(1), each
    with every count set to 0 just before it and the counts `want` required
    just after; peak memory is reset after the warm-up. Returns (codes,
    ms/sample of each timed call, warm-up seconds)."""
    _, warm_s = wall_s(lambda: sample(99))
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(ROUNDS):
        for fn in counters:
            fn.launches = 0
        codes, sample_s = wall_s(lambda: sample(1))
        counts = {fn.__name__: fn.launches for fn in counters}
        if counts != want:
            raise AssertionError(f"[{name}] the sampler launched {counts}, not {want}")
        times.append(sample_s * 1e3 / BATCH)
    return codes, times, warm_s


def decode_checked(vqvae, codes, shape, vocab):
    """Check codes (their shape, values in [0, vocab)), decode them after a
    10-image warm-up (cuDNN's algorithm selection) and check the pixels
    (finite, [BATCH, 256, 256, 3]). Returns (pixels, decode seconds)."""
    if codes.shape != shape or int(codes.min()) < 0 or int(codes.max()) >= vocab:
        raise AssertionError(f"codes out of shape or range: {tuple(codes.shape)} [{int(codes.min())}, {int(codes.max())}]")
    decode(vqvae, codes[:10])
    pixels, decode_s = wall_s(lambda: decode(vqvae, codes))
    if pixels.shape != (BATCH, 256, 256, 3) or not bool(torch.isfinite(pixels).all()):
        raise AssertionError(f"pixels not finite or of shape {tuple(pixels.shape)}")
    return pixels, decode_s


def log_times(name, times, decode_s, card):
    """The sampling ms/sample (median of `times`), decode and peak memory line."""
    sample_ms = statistics.median(times)
    log(f"  [{name}] sampling (kernels): {sample_ms:.3f} ms/sample (median of "
        f"{', '.join(f'{t:.3f}' for t in times)}); decode: {decode_s * 1e3 / BATCH:.3f} ms/sample; total "
        f"{sample_ms + decode_s * 1e3 / BATCH:.3f} ms/sample; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; bs{BATCH}, {card}")


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
        excess = diff - tol * (1.0 + w.abs())
        i = int(excess.argmax())
        raise AssertionError(f"{name}: disagreement beyond the bound at {int((excess > 0).sum())} of {diff.numel()} "
                             f"elements, worst at flat index {i}: got {float(g.flatten()[i])}, "
                             f"want {float(w.flatten()[i])}")
    return max_abs, max_rel


# (B, C, n_head, cur_len, window) of phase 3's update-attention cases on a
# 64-row cache: the main path's B 100 at both sampler windows, a ragged
# batch of 37 and the forced-logits batch of 8, head size 104 (C 1664, 16
# heads)
ATTN_CASES = [(BATCH, 1536, 24, cur, window) for window in (32, 64) for cur in (0, 15, 16, 63)] + [
    (37, 1536, 24, 30, 24), (37, 1536, 24, 0, 24), (8, 1536, 24, 63, 64), (8, 1536, 24, 16, 32),
    (BATCH, 1664, 16, 63, 64), (37, 1664, 16, 30, 24)]
# plans of csrc/decode_attention_tma.cu timed at B 100 beside the plan's own
# choice: (head groups, CTAs per SM, stage bytes)
ATTN_SPLITS = tuple((g, k, sb) for k in (1, 2, 3) for g in (1, 2, 3, 4, 6, 8, 12)
                    for sb in (16384, 32768, 65536))


def check_tma_plan(AK, lib, B, C, nh, window, q8, write=True):
    """The plan of attention_plan, its shared memory equal to what the
    kernel library computes for it (csrc/decode_attention_tma.cu::tma_layout
    against its Python mirror)."""
    plan = AK.attention_plan(B, C, nh, window, q8, write=write)
    got = lib.rq_attention_tma_smem(C, nh, int(q8), window, plan.groups, plan.rows, plan.stages)
    if got != plan.smem:
        raise AssertionError(f"attention plan {plan}: the kernel computes {got} bytes of shared memory")
    return plan


# the mean window of the body attention over a 1.4B sample call's 64
# positions (cur_len 0 .. 63, the cond token first)
ATTN_MEAN_ROWS = 31.5
# CTA 0's first unit (rq_attention_tma_phase_ns)
ATTN_STAMPS = ("first chunk", "K pass", "self term + row write", "softmax", "V pass", "y")


def time_attention_splits(AK, entry, q8, q, tensor_sets, nh, write=True):
    """Device time (graph_ms) of the update kernel (`write`; else its
    read-only form) at B 100, cur_len 63, window 64 on each plan of
    ATTN_SPLITS, and of the same plan streaming its copies alone (probe):
    {(groups, CTAs per SM, stage bytes): (ms, copies-alone ms)}; prints
    them, fastest first, and CTA 0's phases of one call of the default
    plan."""
    B, C = q.shape
    out = {}
    for groups, per_sm, stage in ATTN_SPLITS:
        try:
            plan = AK.attention_plan(B, C, nh, 64, q8, groups=groups, ctas_per_sm=per_sm, stage_bytes=stage,
                                     write=write)
        except ValueError:
            continue
        out[(groups, per_sm, stage)] = tuple(
            graph_ms([lambda s=s: AK._launch_tma(entry, plan, q, s, 64, 63, probe) for s in tensor_sets])
            for probe in (False, True))
    log(f"  {entry} plans (groups, CTAs per SM, stage bytes) -> device ms (copies alone), fastest first: "
        + ", ".join(f"{k} {v[0]:.4f} ({v[1]:.4f})" for k, v in sorted(out.items(), key=lambda kv: kv[1][0])))
    AK._launch_tma(entry, AK.attention_plan(B, C, nh, 64, q8, write=write), q, tensor_sets[0], 64, 63)
    log_stamps(AK, entry)
    return out


def log_stamps(AK, what):
    """CTA 0's phases of the last launch of csrc/decode_attention_tma.cu."""
    torch.cuda.synchronize()
    ns = AK._build.stamps_ns("rq_attention_tma_phase_ns")
    log(f"  {what} CTA 0 of one call (us): " + ", ".join(
        f"{name} {(ns[i + 1] - ns[i]) / 1e3:.2f}" for i, name in enumerate(ATTN_STAMPS))
        + f", its end {(ns[7] - ns[0]) / 1e3:.2f}, the last CTA's end {(ns[8] - ns[0]) / 1e3:.2f}")


def check_attention(AK, dev, gen):
    """decode_attention_update (#1, csrc/decode_attention_tma.cu) against its
    plain version at ATTN_CASES: y within TOL, row cur_len equal to k_new /
    v_new, every other row bit-unchanged; one device kernel per call; timed
    eager and as graph-replay device time against its first design
    (decode_attention_update_v1), SDPA over the same rows, and the other
    head / window splits."""
    T = 64
    lib = AK._build.library()

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    worst = 0.0
    for B, C, nh, cur, window in ATTN_CASES:
        q, kn, vn, kc, vc = rnd(B, C), rnd(B, C), rnd(B, C), rnd(B, T, C), rnd(B, T, C)
        plan = check_tma_plan(AK, lib, B, C, nh, window, False)
        k1, v1, k0, v0 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
        y1 = AK.decode_attention_update(q, kn, vn, k1, v1, cur, nh, t_window=window)
        y0 = AK.decode_attention_update_plain(q, kn, vn, k0, v0, cur, nh, t_window=window)
        torch.cuda.synchronize()
        tag = (f"decode_attention_update B={B} C={C} head size {C // nh} cur_len={cur} window={window} (groups "
               f"{plan.groups}, {plan.ctas} CTAs, {plan.rows} rows x {plan.stages} stages, {plan.smem} B)")
        worst = max(worst, compare(tag, y1, y0)[0])
        keep = torch.ones(T, dtype=torch.bool, device=dev)
        keep[cur] = False
        if not (torch.equal(k1[:, cur], kn) and torch.equal(v1[:, cur], vn)):
            raise AssertionError(f"{tag}: cache row {cur} was not set to k_new/v_new")
        if not (torch.equal(k1[:, keep], kc[:, keep]) and torch.equal(v1[:, keep], vc[:, keep])):
            raise AssertionError(f"{tag}: cache rows other than {cur} changed")
    log("  decode_attention_update: y within the bound, row cur_len = k_new / v_new, every other cache row "
        "bit-unchanged, at head sizes 64 and 104")
    # time the heaviest main-path call (window 64, cur_len 63) on 4 distinct
    # cache pairs (4 x 39 MB), so L2 does not carry one call's cache over
    B, C, nh, n = BATCH, 1536, 24, 63
    q, kn, vn = rnd(B, C), rnd(B, C), rnd(B, C)
    sets = [(rnd(B, T, C), rnd(B, T, C)) for _ in range(4)]
    one_kernel("decode_attention_update", lambda: AK.decode_attention_update(q, kn, vn, *sets[0], n, nh, 64),
               "attention_tma_kernel")
    calls = {"kernel": lambda s: AK.decode_attention_update(q, kn, vn, *s, n, nh, 64),
             "first design (v1)": lambda s: AK.decode_attention_update_v1(q, kn, vn, *s, n, nh, 64),
             "library (SDPA over the 64 rows)": lambda s: sdpa_rows(q, *s, nh, 64)}
    ms = cuda_ms([lambda s=s: calls["kernel"](s) for s in sets], 50)
    v1 = cuda_ms([lambda s=s: calls["first design (v1)"](s) for s in sets], 50)
    plain = cuda_ms([lambda s=s: AK.decode_attention_update_plain(q, kn, vn, *s, n, nh, 64) for s in sets], 50)
    lib_ms = cuda_ms([lambda s=s: sdpa_rows(q, *s, nh, 64) for s in sets], 50)
    graph = {k: graph_ms([lambda s=s, f=f: f(s) for s in sets]) for k, f in calls.items()}
    graph["kernel, again"] = graph_ms([lambda s=s: calls["kernel"](s) for s in sets])
    b = bound(2 * B * n * C * 2 + 3 * B * C * 2 + B * C * 2 + 2 * B * C * 2, 4 * B * (n + 1) * C, FP32_FLOPS)
    mean = ATTN_MEAN_ROWS  # a sample call's mean window
    b_mean = bound(2 * B * mean * C * 2 + 3 * B * C * 2 + B * C * 2 + 2 * B * C * 2, 4 * B * (mean + 1) * C,
                   FP32_FLOPS)["bound_ms"]
    kernel_ms = max(graph["kernel"], graph["kernel, again"])
    splits = time_attention_splits(AK, "rq_attention_tma_update", False, q,
                                   [(q, kn, vn, *s) for s in sets], nh)
    plan = AK.attention_plan(B, C, nh, 64, False)
    log(f"  decode_attention_update time (eager): kernel {ms:.4f} ms, first design {v1:.4f} ms, plain {plain:.4f} ms, "
        f"library (scaled_dot_product_attention over the 64 rows, no cache write) {lib_ms:.4f} ms, bound "
        f"{b['bound_ms']:.4f} ms by {b['bound_by']} (B={B}, W=64, cur_len=63; {b_mean:.4f} ms at a sample call's "
        f"mean window of {mean} rows)")
    log(f"  decode_attention_update device time ({len(sets)} calls in a CUDA graph, replayed): "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in graph.items())
        + f"; {100 * b['bound_ms'] / kernel_ms:.1f}% of the bound (aim >= 70%), "
        f"{graph['library (SDPA over the 64 rows)'] / kernel_ms:.2f}x SDPA's speed (aim >= 1), "
        f"{graph['first design (v1)'] / kernel_ms:.2f}x the first design; {card_line()}")
    log(f"  decode_attention_update plan: groups {plan.groups}, {plan.ctas} CTAs, {plan.rows} rows x {plan.stages} "
        f"stages, {plan.smem} B")
    return {"max_abs_err": worst, "ms": ms, "graph_ms": graph["kernel"], "v1_ms": v1,
            "v1_graph_ms": graph["first design (v1)"], "plain_ms": plain, "library_ms": lib_ms,
            "library_graph_ms": graph["library (SDPA over the 64 rows)"],
            "splits_graph_ms": {"x".join(map(str, k)): v[0] for k, v in splits.items()}, "bound_mean_ms": b_mean,
            **b}


def sdpa_rows(q, k_cache, v_cache, nh, rows):
    """torch's scaled_dot_product_attention of q [B, C] over the first `rows`
    cache rows: the library's one call for the decode attention's math."""
    B, C = q.shape
    hs = C // nh
    k = k_cache[:, :rows].view(B, rows, nh, hs).transpose(1, 2)
    v = v_cache[:, :rows].view(B, rows, nh, hs).transpose(1, 2)
    return F.scaled_dot_product_attention(q.view(B, nh, 1, hs), k, v)


# the stacked sampler's read-only calls timed on the [L, 100, 257, C]
# stacks: its first position, 64 rows, a call's mean window (128 rows) and
# its longest (256 rows)
STACKED_CURS = (1, 64, 128, 256)
STACKED_MEAN = 128
# read-only plans timed at cur_len 256 beside the plan's own choice: (head
# groups, stage bytes)
READ_SPLITS = tuple((g, sb) for g in (1, 2, 3, 4, 6) for sb in (24576, 32768, 49152))
# the read-only form's long windows, (B, C, n_head, T, cur_len): the f8
# stacked sampler's T = cond_len + 32 x 32 (cond_len 1 and cc3m's 32; one
# ring stage at 2 CTAs an SM, or 2), and a 2048-row cache (one CTA an SM)
LONG_READS = ((BATCH, 1536, 24, 1025, 1025), (BATCH, 1536, 24, 1025, 600), (BATCH, 1664, 16, 1056, 1056),
              (37, 1664, 16, 1056, 1000), (BATCH, 1536, 24, 2048, 2048))


def read_bound(B, n, C, nh=0, q8=False) -> dict:
    """The read-only attention's bound: n cache rows of K and V (int8 with
    their bf16 scales, or bf16), q, k_new, v_new read and y written, fp32
    operations."""
    row = C + 2 * nh if q8 else 2 * C
    return bound(2 * B * n * row + 3 * B * C * 2 + B * C * 2, 4 * B * (n + 1) * C, FP32_FLOPS)


def check_attention_read_only(AK, dev, gen):
    """decode_attention (#10, read-only, csrc/decode_attention_tma.cu) and
    decode_attention_stacked (#12) against their plain versions: the
    experiment's shape (B 100 and 500, T 64, cur_len 63), cur_len == T, a
    window, cur_len 0, a ragged batch, and a 4-layer stack of the stacked
    sampler's rows at cur_len 256, 0 and others; the caches bit-unchanged;
    each call one device kernel. Timed at #10's own shape, and on the stack
    at STACKED_CURS as graph-replay device time against the first design
    (decode_attention_v1), SDPA over the same rows and the bound, with the
    sweep of plans and CTA 0's phases at 256 rows. Then the same at head
    size 104 (vqgan_large: C 1664, 16 heads) on a 2-layer stack, then the
    long windows (check_long_reads). Returns (#10's row, #12's head-size-64
    row with the long windows' worst difference, its head-size-104 row)."""
    B, C, nh, L, T = BATCH, 1536, 24, 4, 257
    lib = AK._build.library()

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    worst = 0.0

    def held(tag, got, want, *caches):
        nonlocal worst
        torch.cuda.synchronize()
        worst = max(worst, compare(tag, got, want)[0])
        for c, before in caches:
            if not torch.equal(c, before):
                raise AssertionError(f"{tag}: the kernel changed a cache it may only read")

    for b, t, window, cur in ((B, 64, 64, 63), (500, 64, 64, 63), (B, 64, 64, 64), (B, 64, 32, 16), (B, 64, 64, 0),
                              (37, 64, 24, 30), (8, 64, 64, 64)):
        q, kn, vn, kc, vc = rnd(b, C), rnd(b, C), rnd(b, C), rnd(b, t, C), rnd(b, t, C)
        plan = check_tma_plan(AK, lib, b, C, nh, window, False, write=False)
        k0, v0 = kc.clone(), vc.clone()
        got = AK.decode_attention(q, kn, vn, kc, vc, cur, nh, t_window=window)
        held(f"decode_attention B={b} T={t} window={window} cur_len={cur} (groups {plan.groups}, {plan.ctas} "
             f"CTAs, {plan.rows} rows x {plan.stages} stages, {plan.smem} B)", got,
             AK.decode_attention_plain(q, kn, vn, k0, v0, cur, nh, t_window=window), (kc, k0), (vc, v0))
    row10 = {"max_abs_err": worst, **time_read_at_64(AK, rnd, B, C, nh)}
    worst = 0.0  # the stacked cases' own
    q, kn, vn = rnd(B, C), rnd(B, C), rnd(B, C)
    ks, vs = rnd(L, B, T, C), rnd(L, B, T, C)  # 2 x 316 MB
    k0, v0 = ks.clone(), vs.clone()
    check_tma_plan(AK, lib, B, C, nh, T, False, write=False)
    for layer in range(L):
        for cur in (256, 0, 100 + layer, 257 - layer):
            got = AK.decode_attention_stacked(q, kn, vn, ks, vs, layer, cur, nh)
            held(f"decode_attention_stacked [{L},{B},{T},{C}] layer={layer} cur_len={cur}", got,
                 AK.decode_attention_stacked_plain(q, kn, vn, ks, vs, layer, cur, nh), (ks, k0), (vs, v0))
    del k0, v0
    qr, knr, vnr = rnd(37, C), rnd(37, C), rnd(37, C)
    kr, vr = rnd(2, 37, T, C), rnd(2, 37, T, C)
    held("decode_attention_stacked ragged B=37 layer=1 cur_len=200",
         AK.decode_attention_stacked(qr, knr, vnr, kr, vr, 1, 200, nh),
         AK.decode_attention_stacked_plain(qr, knr, vnr, kr, vr, 1, 200, nh))
    del qr, knr, vnr, kr, vr
    one_kernel("decode_attention_stacked", lambda: AK.decode_attention_stacked(q, kn, vn, ks, vs, 1, 256, nh),
               "attention_tma_kernel")
    log("  decode_attention / decode_attention_stacked: y within the bound, every cache bit-unchanged")
    row64 = {"max_abs_err": worst, **time_stacked(AK, q, kn, vn, ks, vs, nh, 40)}
    del ks, vs

    # head size 104: a [2, 100, 257, 1664] stack (2 x 171 MB), 16 heads
    worst, C, nh, L = 0.0, 1664, 16, 2
    q, kn, vn = rnd(B, C), rnd(B, C), rnd(B, C)
    ks, vs = rnd(L, B, T, C), rnd(L, B, T, C)
    k0, v0 = ks.clone(), vs.clone()
    check_tma_plan(AK, lib, B, C, nh, T, False, write=False)
    for layer in range(L):
        for cur in (256, 0, 257):
            got = AK.decode_attention_stacked(q, kn, vn, ks, vs, layer, cur, nh)
            held(f"decode_attention_stacked head size 104 [{L},{B},{T},{C}] layer={layer} cur_len={cur}", got,
                 AK.decode_attention_stacked_plain(q, kn, vn, ks, vs, layer, cur, nh), (ks, k0), (vs, v0))
    del k0, v0
    qr, knr, vnr = rnd(37, C), rnd(37, C), rnd(37, C)
    kr, vr = rnd(L, 37, T, C), rnd(L, 37, T, C)
    k0, v0 = kr.clone(), vr.clone()
    for cur in (256, 0):
        held(f"decode_attention_stacked head size 104 ragged B=37 layer=1 cur_len={cur}",
             AK.decode_attention_stacked(qr, knr, vnr, kr, vr, 1, cur, nh),
             AK.decode_attention_stacked_plain(qr, knr, vnr, kr, vr, 1, cur, nh), (kr, k0), (vr, v0))
    del qr, knr, vnr, kr, vr, k0, v0
    log("  decode_attention_stacked at head size 104: y within the bound, every cache bit-unchanged")
    row104 = {"max_abs_err": worst, **time_stacked(AK, q, kn, vn, ks, vs, nh, 40)}
    del q, kn, vn, ks, vs
    row64["max_abs_err"] = max(row64["max_abs_err"], check_long_reads(AK, rnd, lib, held))
    return row10, row64, row104


def check_long_reads(AK, rnd, lib, held):
    """decode_attention_stacked at LONG_READS on 2-layer stacks (layer 1's
    view), against its plain version with the caches bit-unchanged, one
    device kernel a call; then the f8 sampler's last call (T 1056, cur_len
    1056, head size 64) as graph-replay device time against the first
    design, SDPA over the same rows and the bound. Returns the worst
    |difference|."""
    worst = 0.0
    for b, C, nh, T, cur in LONG_READS:
        q, kn, vn = rnd(b, C), rnd(b, C), rnd(b, C)
        ks, vs = rnd(2, b, T, C), rnd(2, b, T, C)
        k0, v0 = ks.clone(), vs.clone()
        plan = check_tma_plan(AK, lib, b, C, nh, T, False, write=False)
        got = AK.decode_attention_stacked(q, kn, vn, ks, vs, 1, cur, nh)
        want = AK.decode_attention_stacked_plain(q, kn, vn, ks, vs, 1, cur, nh)
        held(f"decode_attention_stacked [2,{b},{T},{C}] head size {C // nh} layer=1 cur_len={cur} (groups "
             f"{plan.groups}, {plan.ctas} CTAs, {plan.rows} rows x {plan.stages} stages, {plan.smem} B)", got, want,
             (ks, k0), (vs, v0))
        worst = max(worst, (got.float() - want.float()).abs().max().item())
        del ks, vs, k0, v0
    B, C, nh, T = BATCH, 1536, 24, 1056
    q, kn, vn = rnd(B, C), rnd(B, C), rnd(B, C)
    ks, vs = rnd(2, B, T, C), rnd(2, B, T, C)
    one_kernel("decode_attention_stacked", lambda: AK.decode_attention_stacked(q, kn, vn, ks, vs, 1, T, nh),
               "attention_tma_kernel")
    calls = {"kernel": lambda l: AK.decode_attention_stacked(q, kn, vn, ks, vs, l, T, nh),
             "first design (v1)": lambda l: AK.decode_attention_v1(q, kn, vn, ks[l], vs[l], T, nh),
             "SDPA over the same rows": lambda l: sdpa_rows(q, ks[l], vs[l], nh, T)}
    graph = {k: graph_ms([lambda l=l, f=f: f(l) for l in range(2)]) for k, f in calls.items()}
    b = read_bound(B, T, C)
    plan = AK.attention_plan(B, C, nh, T, False, write=False)
    log(f"  decode_attention_stacked at the long windows {LONG_READS}: y within the bound, every cache "
        f"bit-unchanged; at B={B}, T={T}, cur_len={T} (groups {plan.groups}, {plan.ctas} CTAs, {plan.rows} rows x "
        f"{plan.stages} stages, {plan.smem} B) device time (2 calls in a CUDA graph, replayed) "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in graph.items())
        + f", bound {b['bound_ms']:.4f} ms by {b['bound_by']}, {100 * b['bound_ms'] / graph['kernel']:.1f}% of it; "
        f"{card_line()}")
    del q, kn, vn, ks, vs
    for B, T in LONG_SWEEP:
        time_long_plans(AK, rnd, B, C, nh, T)
    return worst


# the long windows' plans swept at cur_len = T, head size 64: (B, T)
LONG_SWEEP = ((BATCH, 1056), (500, 1056), (BATCH, 2048))


def time_long_plans(AK, rnd, B, C, nh, T):
    """Graph-replay device time of rq_attention_tma_read at cur_len = T on
    2-layer stacks over plans of the default plan's head groups with other
    stage rows, ring depths (1, 2) and CTAs an SM (1, 2), each where its
    shared memory fits that many CTAs: how the plan should trade stage size
    against ring depth when a long window's scores fill shared memory."""
    q, kn, vn = rnd(B, C), rnd(B, C), rnd(B, C)
    ks, vs = rnd(2, B, T, C), rnd(2, B, T, C)
    own = AK.attention_plan(B, C, nh, T, False, write=False)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    times = {}
    for rows in sorted({own.rows, *(r * own.n_sub for r in (1, 2, 4, 6, 11))}):
        for stages in (1, 2):
            smem = AK._tma_smem(own.piece, own.hpc, T, rows, stages, False)
            for per_sm in (1, 2):
                if smem > min(AK.SM_SMEM // per_sm - 1024, AK.DK.SMEM_LIMIT):
                    continue
                plan = AK.AttentionPlan(B, C, nh, T, 2, own.groups, rows, stages, min(B * own.groups, per_sm * sms),
                                        smem, False)
                times[(rows, stages, per_sm)] = graph_ms([
                    lambda l=l: AK._launch_tma("rq_attention_tma_read", plan, q, (q, kn, vn, ks[l], vs[l]), T, T)
                    for l in range(2)])
    log(f"  rq_attention_tma_read long-window plans at B={B}, T=cur_len={T}, head size {C // nh}, groups "
        f"{own.groups} (stage rows, stages, CTAs an SM) -> device ms, fastest first: " + ", ".join(
            f"{k} {v:.4f}" for k, v in sorted(times.items(), key=lambda kv: kv[1]))
        + f"; the plan's own: {own.rows} rows x {own.stages} stages, {own.ctas} CTAs, {own.smem} B; "
        f"bound {read_bound(B, T, C)['bound_ms']:.4f} ms; {card_line()}")


def time_read_at_64(AK, rnd, B, C, nh):
    """#10 at its own shape (phase 8's: B 100, T 64, cur_len 63) on 6
    distinct cache pairs (6 x 39 MB), one device kernel a call: eager and
    graph-replay device time against the first design, the plain version,
    SDPA over the 63 rows and the bound."""
    T, n = 64, 63
    q, kn, vn = rnd(B, C), rnd(B, C), rnd(B, C)
    sets = [(rnd(B, T, C), rnd(B, T, C)) for _ in range(6)]
    one_kernel("decode_attention", lambda: AK.decode_attention(q, kn, vn, *sets[0], n, nh), "attention_tma_kernel")
    calls = {"kernel": lambda s: AK.decode_attention(q, kn, vn, *s, n, nh),
             "first design (v1)": lambda s: AK.decode_attention_v1(q, kn, vn, *s, n, nh),
             "library (SDPA over the 63 rows)": lambda s: sdpa_rows(q, *s, nh, n)}
    eager = {k: cuda_ms([lambda s=s, f=f: f(s) for s in sets], 50) for k, f in calls.items()}
    plain = cuda_ms([lambda s=s: AK.decode_attention_plain(q, kn, vn, *s, n, nh) for s in sets], 50)
    graph = {k: graph_ms([lambda s=s, f=f: f(s) for s in sets]) for k, f in calls.items()}
    b = read_bound(B, n, C)
    log(f"  decode_attention (#10) at B={B}, T={T}, cur_len={n}: eager " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in eager.items()) + f", plain {plain:.4f} ms; device time ({len(sets)} calls in "
        f"a CUDA graph, replayed) " + ", ".join(f"{k} {v:.4f} ms" for k, v in graph.items())
        + f"; bound {b['bound_ms']:.4f} ms by {b['bound_by']}, {100 * b['bound_ms'] / graph['kernel']:.1f}% of it; "
        f"{card_line()}")
    return {"ms": eager["kernel"], "graph_ms": graph["kernel"], "v1_ms": eager["first design (v1)"],
            "v1_graph_ms": graph["first design (v1)"], "plain_ms": plain,
            "library_ms": eager["library (SDPA over the 63 rows)"],
            "library_graph_ms": graph["library (SDPA over the 63 rows)"], **b}


def time_stacked(AK, q, kn, vn, ks, vs, nh, n_calls):
    """Time the stacked sampler's calls on each layer of the [L, B, 257, C]
    stack in turn (each layer's 256 rows exceed L2): at cur_len 256 eager
    against the plain version and SDPA; at each of STACKED_CURS as
    graph-replay device time against the first design (decode_attention_v1),
    SDPA over the same rows and the bound; the sweep of READ_SPLITS at 256
    rows, each plan also streaming its copies alone (probe), and CTA 0's
    phases of one call of the default plan."""
    (B, C), L, T, n = q.shape, ks.shape[0], ks.shape[2], 256
    hs = C // nh
    ms = cuda_ms([lambda l=l: AK.decode_attention_stacked(q, kn, vn, ks, vs, l, n, nh) for l in range(L)], n_calls)
    v1 = cuda_ms([lambda l=l: AK.decode_attention_v1(q, kn, vn, ks[l], vs[l], n, nh) for l in range(L)], n_calls)
    plain = cuda_ms([lambda l=l: AK.decode_attention_stacked_plain(q, kn, vn, ks, vs, l, n, nh) for l in range(L)],
                    n_calls // 2)
    lib = cuda_ms([lambda l=l: sdpa_rows(q, ks[l], vs[l], nh, n) for l in range(L)], n_calls)
    b = read_bound(B, n, C)
    log(f"  decode_attention_stacked time (eager), head size {hs}: kernel {ms:.4f} ms, first design {v1:.4f} ms, "
        f"plain {plain:.4f} ms, library (scaled_dot_product_attention over the {n} rows) {lib:.4f} ms, bound "
        f"{b['bound_ms']:.4f} ms by {b['bound_by']} (B={B}, C={C}, T={T}, cur_len={n}); "
        f"{2 * B * n * C * 2 / ms / 1e9:.3f} TB/s of cache")
    by_cur = {}
    for cur in STACKED_CURS:
        calls = {"kernel": lambda l: AK.decode_attention_stacked(q, kn, vn, ks, vs, l, cur, nh),
                 "v1": lambda l: AK.decode_attention_v1(q, kn, vn, ks[l], vs[l], cur, nh),
                 "sdpa": lambda l: sdpa_rows(q, ks[l], vs[l], nh, cur)}
        row = {k: graph_ms([lambda l=l, f=f: f(l) for l in range(L)]) for k, f in calls.items()}
        if cur == n:
            row["kernel"] = max(row["kernel"], graph_ms([lambda l=l: calls["kernel"](l) for l in range(L)]))
        row["bound"] = read_bound(B, cur, C)["bound_ms"]
        by_cur[cur] = row
        log(f"  decode_attention_stacked device time ({L} calls in a CUDA graph, replayed), head size {hs}, "
            f"cur_len {cur}: kernel {row['kernel']:.4f} ms, first design {row['v1']:.4f} ms, SDPA over the same rows "
            f"{row['sdpa']:.4f} ms, bound {row['bound']:.4f} ms; {100 * row['bound'] / row['kernel']:.1f}% of the "
            f"bound, {row['sdpa'] / row['kernel']:.2f}x SDPA's speed, {row['v1'] / row['kernel']:.2f}x the first "
            f"design; {card_line()}")
    splits = {}
    for groups, stage in READ_SPLITS:
        try:
            plan = AK.attention_plan(B, C, nh, T, False, groups=groups, stage_bytes=stage, write=False)
        except ValueError:
            continue
        splits[(groups, stage)] = tuple(graph_ms(
            [lambda l=l: AK._launch_tma("rq_attention_tma_read", plan, q, (q, kn, vn, ks[l], vs[l]), T, n, probe)
             for l in range(L)]) for probe in (False, True))
    plan = AK.attention_plan(B, C, nh, T, False, write=False)
    log(f"  rq_attention_tma_read plans at cur_len {n}, head size {hs} (groups, stage bytes) -> device ms (copies "
        f"alone), fastest first: " + ", ".join(
            f"{k} {v[0]:.4f} ({v[1]:.4f})" for k, v in sorted(splits.items(), key=lambda kv: kv[1][0]))
        + f"; the plan's own: groups {plan.groups}, {plan.ctas} CTAs, {plan.rows} rows x {plan.stages} stages, "
        f"{plan.smem} B")
    AK.decode_attention_stacked(q, kn, vn, ks, vs, 0, n, nh)
    log_stamps(AK, f"decode_attention_stacked at cur_len {n}, head size {hs},")
    return {"ms": ms, "graph_ms": by_cur[n]["kernel"], "v1_ms": v1, "v1_graph_ms": by_cur[n]["v1"], "plain_ms": plain,
            "library_ms": lib, "library_graph_ms": by_cur[n]["sdpa"], **b,
            "bound_mean_ms": read_bound(B, STACKED_MEAN, C)["bound_ms"],
            "by_cur_len_graph_ms": {str(k): v for k, v in by_cur.items()},
            "splits_graph_ms": {"x".join(map(str, k)): v[0] for k, v in splits.items()}}


def q8_cache(AK, rnd, B, T, C, nh):
    """An int8 cache (kq, ks, vq, vs) made as the sampler makes it."""
    out = []
    for _ in range(2):
        q, s = AK.quantize_kv(rnd(B * T, C), nh)
        out += [q.view(B, T, C), s.view(B, T, nh).to(torch.bfloat16)]
    return out


def check_attention_q8(AK, dev, gen):
    """decode_attention_q8_update (#4, csrc/decode_attention_tma.cu) against
    its plain version at ATTN_CASES: y within TOL, all four caches bit-equal
    to the plain version's, row cur_len equal to quantize_kv(k_new / v_new);
    one device kernel per call; timed eager and as graph-replay device time
    against its first design (decode_attention_q8_update_v1) and the other
    head / window splits."""
    T = 64
    lib = AK._build.library()

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    worst = 0.0
    for B, C, nh, cur, window in ATTN_CASES:
        q, kn, vn = rnd(B, C), rnd(B, C), rnd(B, C)
        cache = q8_cache(AK, rnd, B, T, C, nh)
        plan = check_tma_plan(AK, lib, B, C, nh, window, True)
        got, ref = [c.clone() for c in cache], [c.clone() for c in cache]
        y1 = AK.decode_attention_q8_update(q, kn, vn, *got, cur, nh, t_window=window)
        y0 = AK.decode_attention_q8_update_plain(q, kn, vn, *ref, cur, nh, t_window=window)
        torch.cuda.synchronize()
        tag = (f"decode_attention_q8_update B={B} C={C} head size {C // nh} cur_len={cur} window={window} (groups "
               f"{plan.groups}, {plan.ctas} CTAs, {plan.rows} rows x {plan.stages} stages, {plan.smem} B)")
        worst = max(worst, compare(tag, y1, y0)[0])
        for name, a, b0 in zip(("kq", "ks", "vq", "vs"), got, ref):
            if not torch.equal(a, b0):
                raise AssertionError(f"{tag}: {name} after the kernel's write differs from the plain version's")
        kq_new, ks_new = AK.quantize_kv(kn, nh)
        if not (torch.equal(got[0][:, cur], kq_new) and torch.equal(got[1][:, cur], ks_new.to(torch.bfloat16))):
            raise AssertionError(f"{tag}: cache row {cur} is not quantize_kv(k_new)")
    log("  decode_attention_q8_update: all four caches bit-equal to the plain version's "
        "(row cur_len = quantize_kv(k_new/v_new), every other row unchanged), at head sizes 64 and 104")
    B, C, nh, n = BATCH, 1536, 24, 63
    q, kn, vn = rnd(B, C), rnd(B, C), rnd(B, C)
    sets = [q8_cache(AK, rnd, B, T, C, nh) for _ in range(6)]  # 6 x 19.7 MB
    one_kernel("decode_attention_q8_update", lambda: AK.decode_attention_q8_update(q, kn, vn, *sets[0], n, nh, 64),
               "attention_tma_kernel")
    calls = {"kernel": lambda s: AK.decode_attention_q8_update(q, kn, vn, *s, n, nh, 64),
             "first design (v1)": lambda s: AK.decode_attention_q8_update_v1(q, kn, vn, *s, n, nh, 64)}
    ms = cuda_ms([lambda s=s: calls["kernel"](s) for s in sets], 50)
    v1 = cuda_ms([lambda s=s: calls["first design (v1)"](s) for s in sets], 50)
    plain = cuda_ms([lambda s=s: AK.decode_attention_q8_update_plain(q, kn, vn, *s, n, nh, 64) for s in sets], 50)
    graph = {k: graph_ms([lambda s=s, f=f: f(s) for s in sets]) for k, f in calls.items()}
    graph["kernel, again"] = graph_ms([lambda s=s: calls["kernel"](s) for s in sets])
    b = bound(
        2 * B * n * (C + 2 * nh) + 3 * B * C * 2 + B * C * 2 + 2 * B * (C + 2 * nh),
        4 * B * (n + 1) * C, FP32_FLOPS,
    )
    mean = ATTN_MEAN_ROWS
    b_mean = bound(2 * B * mean * (C + 2 * nh) + 3 * B * C * 2 + B * C * 2 + 2 * B * (C + 2 * nh),
                   4 * B * (mean + 1) * C, FP32_FLOPS)["bound_ms"]
    kernel_ms = max(graph["kernel"], graph["kernel, again"])
    splits = time_attention_splits(AK, "rq_attention_tma_q8_update", True, q, [(q, kn, vn, *s) for s in sets], nh)
    plan = AK.attention_plan(B, C, nh, 64, True)
    log(f"  decode_attention_q8_update time (eager): kernel {ms:.4f} ms, first design {v1:.4f} ms, plain "
        f"{plain:.4f} ms, library: none (no torch call attends an int8 cache), bound {b['bound_ms']:.4f} ms by "
        f"{b['bound_by']} (B={B}, W=64, cur_len=63; {b_mean:.4f} ms at a sample call's mean window of {mean} rows)")
    log(f"  decode_attention_q8_update device time ({len(sets)} calls in a CUDA graph, replayed): "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in graph.items())
        + f"; {100 * b['bound_ms'] / kernel_ms:.1f}% of the bound (aim >= 50%), "
        f"{graph['first design (v1)'] / kernel_ms:.2f}x the first design (aim >= 2x); {card_line()}")
    log(f"  decode_attention_q8_update plan: groups {plan.groups}, {plan.ctas} CTAs, {plan.rows} rows x {plan.stages} "
        f"stages, {plan.smem} B")
    return {"max_abs_err": worst, "ms": ms, "graph_ms": graph["kernel"], "v1_ms": v1,
            "v1_graph_ms": graph["first design (v1)"], "plain_ms": plain, "library_ms": None,
            "splits_graph_ms": {"x".join(map(str, k)): v[0] for k, v in splits.items()}, "bound_mean_ms": b_mean,
            **b}


def check_attention_q8_read_only(AK, dev, gen):
    """decode_attention_q8 (#11, the read-only q8 attention,
    csrc/decode_attention_tma.cu) against its plain version at the
    experiment's shapes (B 100 and 500, T 64, cur_len 63, window 64), at
    cur_len == T, cur_len 0, a ragged B = 37, head size 104 and windows of
    1024 and 1056 rows; the four
    caches bit-unchanged; one device kernel a call; timed eager and as
    graph-replay device time against the first design
    (decode_attention_q8_v1), decode_attention (#10) on the same rows in
    bf16 and the bound, with the sweep of plans and CTA 0's phases."""
    B, C, nh, T = BATCH, 1536, 24, 64
    lib = AK._build.library()

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    worst = 0.0
    for b, c, heads, cur, window in ((B, C, nh, 63, 64), (500, C, nh, 63, 64), (B, C, nh, 64, 64), (B, C, nh, 0, 64),
                                     (B, C, nh, 15, 32), (37, C, nh, 30, 24), (B, 1664, 16, 63, 64),
                                     (37, 1664, 16, 64, 64)):
        q, kn, vn = rnd(b, c), rnd(b, c), rnd(b, c)
        cache = q8_cache(AK, rnd, b, T, c, heads)
        before = [t.clone() for t in cache]
        plan = check_tma_plan(AK, lib, b, c, heads, window, True, write=False)
        got = AK.decode_attention_q8(q, kn, vn, *cache, cur, heads, t_window=window)
        want = AK.decode_attention_q8_plain(q, kn, vn, *cache, cur, heads, t_window=window)
        torch.cuda.synchronize()
        tag = (f"decode_attention_q8 B={b} C={c} head size {c // heads} cur_len={cur} window={window} (groups "
               f"{plan.groups}, {plan.ctas} CTAs, {plan.rows} rows x {plan.stages} stages, {plan.smem} B)")
        worst = max(worst, compare(tag, got, want)[0])
        for name, a, b0 in zip(("kq", "ks", "vq", "vs"), cache, before):
            if not torch.equal(a, b0):
                raise AssertionError(f"{tag}: the kernel changed {name}, which it may only read")
    for b, c, heads, t, cur in ((B, C, nh, 1056, 1056), (37, 1664, 16, 1024, 700)):  # long windows, as LONG_READS
        q, kn, vn = rnd(b, c), rnd(b, c), rnd(b, c)
        cache = q8_cache(AK, rnd, b, t, c, heads)
        before = [x.clone() for x in cache]
        plan = check_tma_plan(AK, lib, b, c, heads, t, True, write=False)
        got = AK.decode_attention_q8(q, kn, vn, *cache, cur, heads)
        want = AK.decode_attention_q8_plain(q, kn, vn, *cache, cur, heads)
        torch.cuda.synchronize()
        tag = (f"decode_attention_q8 B={b} C={c} head size {c // heads} T={t} cur_len={cur} (groups {plan.groups}, "
               f"{plan.ctas} CTAs, {plan.rows} rows x {plan.stages} stages, {plan.smem} B)")
        worst = max(worst, compare(tag, got, want)[0])
        if not all(torch.equal(a, b0) for a, b0 in zip(cache, before)):
            raise AssertionError(f"{tag}: the kernel changed a cache it may only read")
    log("  decode_attention_q8: y within the bound, all four caches bit-unchanged, at head sizes 64 and 104 and at "
        "windows of 1024 and 1056 rows")
    # the main-path call on 6 distinct caches (6 x 19.7 MB int8, 6 x 39 MB
    # bf16 for #10 on the same rows), so L2 does not carry one call's rows over
    n = 63
    q, kn, vn = rnd(B, C), rnd(B, C), rnd(B, C)
    sets = [q8_cache(AK, rnd, B, T, C, nh) for _ in range(6)]
    bf16_sets = [(AK.dequantize_cache(s[0], s[1], nh), AK.dequantize_cache(s[2], s[3], nh)) for s in sets]
    one_kernel("decode_attention_q8", lambda: AK.decode_attention_q8(q, kn, vn, *sets[0], n, nh, 64),
               "attention_tma_kernel")
    calls = {"kernel": lambda s: AK.decode_attention_q8(q, kn, vn, *s, n, nh, 64),
             "first design (v1)": lambda s: AK.decode_attention_q8_v1(q, kn, vn, *s, n, nh, 64)}
    ms = cuda_ms([lambda s=s: calls["kernel"](s) for s in sets], 50)
    v1 = cuda_ms([lambda s=s: calls["first design (v1)"](s) for s in sets], 50)
    plain = cuda_ms([lambda s=s: AK.decode_attention_q8_plain(q, kn, vn, *s, n, nh, 64) for s in sets], 50)
    bf16_ms = cuda_ms([lambda s=s: AK.decode_attention(q, kn, vn, *s, n, nh, 64) for s in bf16_sets], 50)
    graph = {k: graph_ms([lambda s=s, f=f: f(s) for s in sets]) for k, f in calls.items()}
    graph["decode_attention (#10, bf16) on the same rows"] = graph_ms(
        [lambda s=s: AK.decode_attention(q, kn, vn, *s, n, nh, 64) for s in bf16_sets])
    graph["kernel, again"] = graph_ms([lambda s=s: calls["kernel"](s) for s in sets])
    b = read_bound(B, n, C, nh, q8=True)
    kernel_ms = max(graph["kernel"], graph["kernel, again"])
    splits = time_attention_splits(AK, "rq_attention_tma_q8_read", True, q, [(q, kn, vn, *s) for s in sets], nh,
                                   write=False)
    log(f"  decode_attention_q8 time (eager): kernel {ms:.4f} ms, first design {v1:.4f} ms, plain {plain:.4f} ms, "
        f"decode_attention (#10, bf16) on the same rows {bf16_ms:.4f} ms, library: none (no torch call attends an "
        f"int8 cache), bound {b['bound_ms']:.4f} ms by {b['bound_by']} (B={B}, W=64, cur_len={n}); "
        f"{2 * B * n * (C + 2 * nh) / ms / 1e6:.1f} GB/s of int8 cache and scales")
    log(f"  decode_attention_q8 device time ({len(sets)} calls in a CUDA graph, replayed): "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in graph.items())
        + f"; {100 * b['bound_ms'] / kernel_ms:.1f}% of the bound, {graph['first design (v1)'] / kernel_ms:.2f}x the "
        f"first design; {card_line()}")
    return {"max_abs_err": worst, "ms": ms, "graph_ms": graph["kernel"], "v1_ms": v1,
            "v1_graph_ms": graph["first design (v1)"], "plain_ms": plain, "library_ms": None,
            "splits_graph_ms": {"x".join(map(str, k)): v[0] for k, v in splits.items()}, **b}


def device_events(fn) -> list[tuple[str, float]] | None:
    """(name, device us) of each device kernel one call of fn issues
    (torch.profiler), or None. The profiler keeps only the device activity
    whose time, converted to the host's clock, lies inside the profile's
    window, and on the card that conversion appears to drift as a process
    runs: late in a full run it dropped the kernels launched at the start
    of a window (the first of nearest_code's three in phase 3; a marker
    launched first, in phase 13), a margin of 20 ms was often not enough,
    and the durations it kept read about half the graph-replay times. So
    fn runs between two marker kernels (torch.cuda._sleep's spin_kernel),
    the host waits a margin before the first and after the second, and
    only the events between the markers are returned; a profile that lost a
    marker is taken again with a longer margin, up to four times, then None.
    Which kernels a call issues is read from a CUDA graph (device_kernels),
    not from here."""
    from torch.profiler import ProfilerActivity, profile

    for margin in (0.5, 2.0, 8.0, 8.0):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(margin)
            torch.cuda._sleep(1000)
            fn()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(margin)
        events = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        marks = [i for i, (name, _) in enumerate(events) if "spin_kernel" in name]
        if len(marks) == 2:
            return events[marks[0] + 1:marks[1]]
        log(f"  (the profiler kept {len(marks)} of the 2 marker kernels around this call with a margin of "
            f"{margin} s; profiling it again)")
    return None


def device_kernels(fn) -> list[str]:
    """Names (mangled) of the device kernels one call of fn issues, in
    launch order: fn is captured in a CUDA graph, which is never run, and
    the graph's kernel nodes are read from its DOT dump
    (cudaGraphDebugDotPrint). This does not depend on the device's
    timestamps, as torch.profiler does (device_events)."""
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    graph.enable_debug_mode()
    with torch.cuda.graph(graph):
        fn()
    path = os.path.join(ROOT, "build", "device_kernels.dot")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # debug_dump warns that it was called
        graph.debug_dump(path)
    with open(path) as f:
        dot = f.read()
    os.remove(path)
    del graph
    # a kernel node's label: {KERNEL | {ID | 0 (topoId: 2) | <mangled name>\<\<\<grid,block,smem\>\>\>} | ...
    nodes = re.findall(r'label="\{KERNEL\s*\| \{ID \| (\d+)[^|]*\| ([^\\}]+)', dot)
    if not nodes and "KERNEL" in dot:
        raise AssertionError(f"device_kernels: no kernel name read from the graph's dump: {dot[:400]}")
    return [name for _, name in sorted(nodes, key=lambda node: int(node[0]))]


DENSE_BATCHES = (37, 100, 300, 500)  # phase 3's rows for #2 / #3 and #5-#8 at C 1536 (C 2560: B 100)
DENSE_QKV_PHASES = ("LN1 staged", "tiles")
DENSE_MLP_PHASES = ("proj", "barrier 1", "LN2 + w1", "barrier 2", "w2")


def host_us(fn, n: int = 200) -> float:
    """Host microseconds of one call of fn, back to back without a
    synchronisation (the wrapper's dispatch: its checks, allocations and
    launches; the device runs behind)."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def check_dense(DK, dev, gen, quantize_weight=None):
    """#2 and #3 (csrc/decode_dense.cu), or with quantize_weight given #5/#7
    and #6/#8 (the same kernels on int8 weights with per-channel scales),
    against their plain versions at B 37, 100, 300 and 500 (#3 / #6 with
    both gelu forms) at C 1536, and at B 100 at C 2560 (bench's 3800M
    width); one device kernel per call, and where the time of one call went
    (CTA 0's stamps); then, at B 100, C 1536, L2-cold (distinct weight sets
    of > 100 MB in turn), back to back and as device time in a CUDA graph:
    the kernel, its split-K predecessor (csrc/decode_layer.cu), the plain
    version and the library call (F.linear, on the dequantized bf16 weights
    for int8), with the bound; the host time of one wrapper call, new and
    split-K; the device time at B 1."""
    C = 1536
    H = 4 * C
    q8 = quantize_weight is not None
    sfx = "_q8" if q8 else ""
    nw = 2 if q8 else 1  # tensors per weight: (int8 weight, scales) or (bf16 weight,)
    qkv_fn, qkv_split, qkv_plain_fn = (getattr(DK, f"fused_ln_qkv{sfx}{t}") for t in ("", "_splitk", "_plain"))
    mlp_fn, mlp_split, mlp_plain_fn = (getattr(DK, f"fused_proj_mlp{sfx}{t}") for t in ("", "_splitk", "_plain"))

    def rnd(*shape, std=1.0, mean=0.0):
        return (torch.randn(*shape, generator=gen, device=dev) * std + mean).to(torch.bfloat16)

    def lin(*shape):
        w = rnd(*shape, std=0.02)
        return tuple(quantize_weight(w)) if q8 else (w,)

    def qkv_weights(C):
        return (*lin(3 * C, C), rnd(3 * C, std=0.02))

    def mlp_weights(C):
        return (*lin(C, C), rnd(C, std=0.02), *lin(4 * C, C), rnd(4 * C, std=0.02), *lin(C, 4 * C), rnd(C, std=0.02))

    def weights(C):
        return (rnd(C, std=0.1, mean=1.0), rnd(C, std=0.1)), qkv_weights(C), mlp_weights(C)

    def dense(w):
        """The weight of a (weight, scales) / (weight,) tuple as bf16: the library's operand."""
        return w[0].to(torch.bfloat16) * w[1][:, None] if q8 else w[0]

    def proj_mlp(fn, x, y, ln, s, gelu="v1"):
        return fn(x, y, *s[:nw + 1], *ln, *s[nw + 1:], gelu_version=gelu)

    def mlp_lib_weights(s):
        return [dense(s[i:i + nw]) for i in (0, nw + 1, 2 * nw + 2)]

    qkv_err = mlp_err = 0.0
    for width, batches in ((C, DENSE_BATCHES), (2560, (BATCH,))):
        ln, qkv_w, mlp_w = weights(width)
        for B in batches:
            x, y = rnd(B, width), rnd(B, width)
            plan = DK.dense_plan(B, width, 3 * width, False, wbytes=3 - nw)
            got = qkv_fn(x, *ln, *qkv_w)
            torch.cuda.synchronize()
            err, _ = compare(f"fused_ln_qkv{sfx} x[{B},{width}] wqkv[{3 * width},{width}] (cluster {plan.cluster}, "
                             f"row tile {plan.row_tile} x {plan.row_tiles})", got, qkv_plain_fn(x, *ln, *qkv_w))
            qkv_err = max(qkv_err, err)
            for gelu in ("v1", "v2"):
                got = proj_mlp(mlp_fn, x, y, ln, mlp_w, gelu)
                torch.cuda.synchronize()
                err, _ = compare(f"fused_proj_mlp{sfx} x[{B},{width}] H {4 * width} gelu {gelu}", got,
                                 proj_mlp(mlp_plain_fn, x, y, ln, mlp_w, gelu))
                mlp_err = max(mlp_err, err)
        del ln, qkv_w, mlp_w
    B = BATCH
    x, y = rnd(B, C), rnd(B, C)
    ln, qkv_w, mlp_w = weights(C)
    qkv_name, mlp_name = f"fused_ln_qkv{sfx}", f"fused_proj_mlp{sfx}"
    for name, fn in ((qkv_name, lambda: qkv_fn(x, *ln, *qkv_w)), (mlp_name, lambda: proj_mlp(mlp_fn, x, y, ln, mlp_w))):
        fn()  # the plan and tensor maps of these weights are made on the host before the profiled call
        kernels = device_kernels(fn)
        if len([k for k in kernels if "dense_kernel" in k]) != 1 or len(kernels) != 1:
            raise AssertionError(f"{name}: one call issued device kernels {kernels}, not one dense_kernel")
        log(f"  {name}: one call issues one device kernel ({kernels[0][:72]}...)")
    from rqvae_tpu_torch.ops import _build

    for name, fn, phases in ((qkv_name, lambda: qkv_fn(x, *ln, *qkv_w), DENSE_QKV_PHASES),
                             (mlp_name, lambda: proj_mlp(mlp_fn, x, y, ln, mlp_w), DENSE_MLP_PHASES)):
        fn()
        torch.cuda.synchronize()
        us = _build.phase_us("rq_dense_phase_ns", 6)  # csrc/decode_dense.cu g_stamps: CTA 0's timeline
        log(f"  {name} phases of one call (CTA 0, us): " + ", ".join(f"{n} {u:.1f}" for n, u in zip(phases, us)))

    wbytes = 3 - nw
    qkv_sets = [qkv_weights(C) for _ in range(8 * nw)]  # 8 x 14 MB bf16, 16 x 7.1 MB int8
    mlp_sets = [mlp_weights(C) for _ in range(3 * nw)]  # 3 x 42 MB bf16, 6 x 21.2 MB int8
    qkv_lib_w = [dense(s[:nw]) for s in qkv_sets[:8]]
    mlp_lib_w = [mlp_lib_weights(s) for s in mlp_sets[:3]]
    qkv_ms = cuda_ms([lambda s=s: qkv_fn(x, *ln, *s) for s in qkv_sets], 50)
    qkv_sk = cuda_ms([lambda s=s: qkv_split(x, *ln, *s) for s in qkv_sets], 50)
    qkv_plain = cuda_ms([lambda s=s: qkv_plain_fn(x, *ln, *s) for s in qkv_sets], 50)
    qkv_lib = cuda_ms([lambda w=w: F.linear(x, w) for w in qkv_lib_w], 50)
    qkv_ms2 = cuda_ms([lambda s=s: qkv_fn(x, *ln, *s) for s in qkv_sets], 50)
    qkv_b = bound(B * C * 2 + 2 * C * 2 + 3 * C * C * wbytes + 3 * C * 2 * nw + B * 3 * C * 2, 2 * B * 3 * C * C,
                  BF16_TENSOR_FLOPS)
    lib_what = "on the dequantized bf16 weights, " if q8 else ""
    log(f"  {qkv_name} time: kernel {qkv_ms:.4f} ms (again after the others: {qkv_ms2:.4f}), split-K kernel "
        f"{qkv_sk:.4f} ms ({qkv_sk / qkv_ms:.2f}x the kernel), plain {qkv_plain:.4f} ms, library (F.linear "
        f"{lib_what}the GEMM alone without LN or epilogue) {qkv_lib:.4f} ms, bound {qkv_b['bound_ms']:.4f} ms by "
        f"{qkv_b['bound_by']}")
    qkv_graph = {"kernel": graph_ms([lambda s=s: qkv_fn(x, *ln, *s) for s in qkv_sets]),
                 "split-K": graph_ms([lambda s=s: qkv_split(x, *ln, *s) for s in qkv_sets]),
                 "library": graph_ms([lambda w=w: F.linear(x, w) for w in qkv_lib_w])}
    log(f"  {qkv_name} device time ({len(qkv_sets)} calls in a CUDA graph, replayed): "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in qkv_graph.items()))
    mlp_ms = cuda_ms([lambda s=s: proj_mlp(mlp_fn, x, y, ln, s) for s in mlp_sets], 30)
    mlp_sk = cuda_ms([lambda s=s: proj_mlp(mlp_split, x, y, ln, s) for s in mlp_sets], 30)
    mlp_plain = cuda_ms([lambda s=s: proj_mlp(mlp_plain_fn, x, y, ln, s) for s in mlp_sets], 30)
    mlp_lib = cuda_ms([lambda w=w: gemms_alone(x, y, *w) for w in mlp_lib_w], 30)
    mlp_ms2 = cuda_ms([lambda s=s: proj_mlp(mlp_fn, x, y, ln, s) for s in mlp_sets], 30)
    mlp_b = proj_mlp_bound(B, C, H, wbytes)
    log(f"  {mlp_name} time: kernel {mlp_ms:.4f} ms (again after the others: {mlp_ms2:.4f}), split-K kernel "
        f"{mlp_sk:.4f} ms ({mlp_sk / mlp_ms:.2f}x the kernel), plain {mlp_plain:.4f} ms, library (three "
        f"F.linear {lib_what}the GEMMs alone without LN, gelu or epilogues) {mlp_lib:.4f} ms, bound "
        f"{mlp_b['bound_ms']:.4f} ms by {mlp_b['bound_by']}")
    mlp_graph = {"kernel": graph_ms([lambda s=s: proj_mlp(mlp_fn, x, y, ln, s) for s in mlp_sets]),
                 "split-K": graph_ms([lambda s=s: proj_mlp(mlp_split, x, y, ln, s) for s in mlp_sets]),
                 "library": graph_ms([lambda w=w: gemms_alone(x, y, *w) for w in mlp_lib_w])}
    log(f"  {mlp_name} device time ({len(mlp_sets)} calls in a CUDA graph, replayed): "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in mlp_graph.items()))
    x1, y1 = rnd(1, C), rnd(1, C)  # one row: the kernels' latency floor, with the same weight bytes
    log(f"  device time at B 1 (graph replay): {qkv_name} "
        f"{graph_ms([lambda s=s: qkv_fn(x1, *ln, *s) for s in qkv_sets]):.4f} ms, {mlp_name} "
        f"{graph_ms([lambda s=s: proj_mlp(mlp_fn, x1, y1, ln, s) for s in mlp_sets]):.4f} ms")
    host = {qkv_name: (host_us(lambda: qkv_fn(x, *ln, *qkv_sets[0])), host_us(lambda: qkv_split(x, *ln, *qkv_sets[0]))),
            mlp_name: (host_us(lambda: proj_mlp(mlp_fn, x, y, ln, mlp_sets[0])),
                       host_us(lambda: proj_mlp(mlp_split, x, y, ln, mlp_sets[0])))}
    log("  host time of one wrapper call (back to back, no synchronisation): " + "; ".join(
        f"{name} {new:.1f} us, split-K {old:.1f} us" for name, (new, old) in host.items()) + f"; {card_line()}")
    for name, eager, split, graph in ((qkv_name, max(qkv_ms, qkv_ms2), qkv_sk, qkv_graph),
                                      (mlp_name, max(mlp_ms, mlp_ms2), mlp_sk, mlp_graph)):
        log(f"  {name}: {graph['split-K'] / graph['kernel']:.2f}x faster than the split-K kernel on the device "
            f"(graph replay), {split / eager:.2f}x back to back from the host (the slower of the kernel's two "
            f"eager times: it includes the wrapper's host dispatch); the redesign's aim: >= 2x; {card_line()}")
    return tuple(
        {"max_abs_err": err, "ms": ms, "splitk_ms": sk, "plain_ms": plain, "library_ms": lib,
         "graph_ms": graph["kernel"], "splitk_graph_ms": graph["split-K"], "library_graph_ms": graph["library"],
         "host_us": host[name][0], "splitk_host_us": host[name][1], **b}
        for name, err, ms, sk, plain, lib, graph, b in (
            (qkv_name, qkv_err, qkv_ms, qkv_sk, qkv_plain, qkv_lib, qkv_graph, qkv_b),
            (mlp_name, mlp_err, mlp_ms, mlp_sk, mlp_plain, mlp_lib, mlp_graph, mlp_b)))


def gemms_alone(x, y, wo, w1, w2):
    """The proj/MLP's three bf16 products through F.linear (the library's
    GEMMs, without LN, gelu, biases or residuals)."""
    return F.linear(F.linear(F.linear(y, wo) + x, w1), w2)


def proj_mlp_bound(B, C, H, weight_bytes):
    """bound() of fused_proj_mlp(_q8): x, y, LN2, biases and weights in (plus
    bf16 column scales for int8 weights), out out; the three products."""
    n_bytes = 2 * B * C * 2 + 2 * C * 2 + (2 * C + H) * 2 + (C * C + 2 * C * H) * weight_bytes + B * C * 2
    if weight_bytes == 1:
        n_bytes += (2 * C + H) * 2
    return bound(n_bytes, 2 * B * (C * C + 2 * C * H), BF16_TENSOR_FLOPS)


# #19 also streams the ring of #6's plan at these batches: 16, 12 and 4
# stages at C 1536 (6 at its own B 100)
PROBE_DEPTH_ROWS = (1, 64, 500)
Q8_POINTS = (("ring", 1536, 4), ("ring", 768, 6), ("ring", 512, 2), ("packed", 1536, 2), ("packed", 3072, 2))
Q8_BATCHES = (37, 100, 300)


def check_q8_pipeline(QP, DK, quantize_weight, dev, gen):
    """#17 / #18 and #19 (ops/q8_pipeline_kernel.py) against their plain
    versions at the experiment's shapes: C 1536, H 6144, bf16 activations,
    int8 weights from quantize_weight, nonzero biases. #17 / #18 (#6's
    kernel, csrc/decode_dense.cu) at B 37, 100 and 300, both gelu forms, at
    every (chunk, n_buf) of Q8_POINTS: TOL against the plain version, and
    every point bit-equal to decode_layer_kernel.fused_proj_mlp_q8 (the
    result depends on neither); one device kernel a call (torch.profiler);
    at B 100, L2-cold (6 weight sets of 21.2 MB in turn), CUDA-graph device
    time of #17, #18, their first design (*_v1, csrc/q8_pipeline.cu), #6 and
    the library (three F.linear on the dequantized bf16 weights, the GEMMs
    alone), eager time of #17, #18 and the plain version, and the bound. #19
    in both modes at (1536, 4) and (768, 4), bit-equal to the plain version
    (integer sums, exact in fp32), the int32 view within 1e-6 of |ref|.
    Returns the JSON entries of #17, #18 and #19 (no launches yet)."""
    B, C = BATCH, 1536
    H = 4 * C

    def rnd(*shape, std=1.0, mean=0.0):
        return (torch.randn(*shape, generator=gen, device=dev) * std + mean).to(torch.bfloat16)

    def qw(*shape):
        return quantize_weight(rnd(*shape, std=0.02))

    ln_s, ln_b = rnd(C, std=0.1, mean=1.0), rnd(C, std=0.1)
    sets = [(*qw(C, C), rnd(C, std=0.02), *qw(H, C), rnd(H, std=0.02), *qw(C, H), rnd(C, std=0.02))
            for _ in range(6)]  # 6 x 21.2 MB
    pk = {}

    def packs(s, chunk):
        return QP.pack_w1(s[3], chunk), QP.pack_w2(s[6], chunk)

    def packed_w(i, chunk):  # set i's packed w1 and w2, made once
        if (i, chunk) not in pk:
            pk[i, chunk] = packs(sets[i], chunk)
        return pk[i, chunk]

    def args(i, x, y):
        s = sets[i]
        return (x, y, s[0], s[1], s[2], ln_s, ln_b, *s[3:])

    def call(point, i, x, y, gelu="v1", v1=False):
        kind, chunk, n_buf = point
        if kind == "ring":
            fn = QP.fused_proj_mlp_q8_ring_v1 if v1 else QP.fused_proj_mlp_q8_ring
            return fn(*args(i, x, y), gelu_version=gelu, chunk=chunk, n_buf=n_buf)
        fn = QP.fused_proj_mlp_q8_packed_v1 if v1 else QP.fused_proj_mlp_q8_packed
        s, (w1p, w2p) = sets[i], packed_w(i, chunk)
        return fn(x, y, s[0], s[1], s[2], ln_s, ln_b, w1p, s[4], s[5], w2p, s[7], s[8], gelu_version=gelu,
                  chunk=chunk, n_buf=n_buf)

    err = 0.0
    for b in Q8_BATCHES:
        x, y = rnd(b, C), rnd(b, C)
        plan = DK.dense_plan(b, C, H, True, wbytes=1)
        for gelu in ("v1", "v2"):
            want = QP.fused_proj_mlp_q8_ring_plain(*args(0, x, y), gelu_version=gelu)
            ref = DK.fused_proj_mlp_q8(*args(0, x, y), gelu_version=gelu)
            torch.cuda.synchronize()
            for n, point in enumerate(Q8_POINTS):
                got = call(point, 0, x, y, gelu)
                torch.cuda.synchronize()
                if n == 0:
                    err = max(err, compare(f"fused_proj_mlp_q8_ring {point[1:]} B={b} gelu {gelu} (cluster "
                                           f"{plan.cluster} x {plan.clusters}, row tile {plan.row_tile} x "
                                           f"{plan.row_tiles})", got, want)[0])
                if not torch.equal(got, ref):
                    d = float((got.float() - ref.float()).abs().max())
                    raise AssertionError(f"fused_proj_mlp_q8 {point} B={b} gelu {gelu} differs from "
                                         f"fused_proj_mlp_q8: max |d| {d:.3e}")
            log(f"  fused_proj_mlp_q8_ring / _packed B={b} gelu {gelu}: the {len(Q8_POINTS)} points {Q8_POINTS} "
                f"bit-equal to each other and to fused_proj_mlp_q8")
    x, y = rnd(B, C), rnd(B, C)
    for name, point in (("fused_proj_mlp_q8_ring", Q8_POINTS[0]), ("fused_proj_mlp_q8_packed", Q8_POINTS[3])):
        fn = lambda point=point: call(point, 0, x, y)  # noqa: E731
        fn()  # the plan, scratch and tensor maps are made on the host before the profiled call
        kernels = device_kernels(fn)
        if len(kernels) != 1 or "dense_kernel" not in kernels[0]:
            raise AssertionError(f"{name}: one call issued device kernels {kernels}, not one dense_kernel")
        log(f"  {name}: one call issues one device kernel ({kernels[0][:72]}...)")
    ring = [lambda i=i: call(Q8_POINTS[0], i, x, y) for i in range(6)]
    packed = [lambda i=i: call(Q8_POINTS[3], i, x, y) for i in range(6)]
    deq = [[(q.to(torch.bfloat16) * sc[:, None]) for q, sc in ((s[0], s[1]), (s[3], s[4]), (s[6], s[7]))]
           for s in sets[:3]]
    graph = {"#17": graph_ms(ring), "#18": graph_ms(packed),
             "#17 first design": graph_ms([lambda i=i: call(Q8_POINTS[0], i, x, y, v1=True) for i in range(6)]),
             "#18 first design": graph_ms([lambda i=i: call(Q8_POINTS[3], i, x, y, v1=True) for i in range(6)]),
             "#6": graph_ms([lambda i=i: DK.fused_proj_mlp_q8(*args(i, x, y)) for i in range(6)]),
             "library": graph_ms([lambda w=w: gemms_alone(x, y, *w) for w in deq])}
    ms, ms_packed = cuda_ms(ring, 30), cuda_ms(packed, 30)
    plain = cuda_ms([lambda i=i: QP.fused_proj_mlp_q8_ring_plain(*args(i, x, y)) for i in range(6)], 30)
    b = proj_mlp_bound(B, C, H, 1)
    log(f"  fused_proj_mlp_q8_ring (1536, 4) / _packed (1536, 2) time (B {B}): device (graph replay) "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in graph.items())
        + f" (the first designs {graph['#17 first design'] / graph['#17']:.2f}x / "
        f"{graph['#18 first design'] / graph['#18']:.2f}x the kernel); eager #17 {ms:.4f} ms, #18 {ms_packed:.4f} "
        f"ms, plain {plain:.4f} ms; bound {b['bound_ms']:.4f} ms by {b['bound_by']}; {card_line()}")
    del pk
    ring_entry = {"max_abs_err": err, "ms": ms, "graph_ms": graph["#17"], "v1_graph_ms": graph["#17 first design"],
                  "q8_graph_ms": graph["#6"], "plain_ms": plain, "library_ms": graph["library"], **b}
    packed_entry = {"max_abs_err": err, "ms": ms_packed, "graph_ms": graph["#18"],
                    "v1_graph_ms": graph["#18 first design"], "q8_graph_ms": graph["#6"], "plain_ms": plain,
                    "library_ms": graph["library"], **b}

    # #19: the chunk stream alone
    probe_ms = {}
    for chunk, n_buf in ((1536, 4), (768, 4)):
        w1p, w2p = packs(sets[2], chunk)
        for mode in ("dma", "dequant"):
            got = QP.stream_probe(w1p, w2p, chunk=chunk, n_buf=n_buf, mode=mode)
            want = QP.stream_probe_plain(w1p, w2p, mode)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"stream_probe {mode} ({chunk}, {n_buf}) not bit-equal to the plain version: "
                                     f"max |d| {float((got - want).abs().max()):.3e}")
            log(f"  stream_probe {mode} ({chunk}, {n_buf}): bit-equal to the plain version (lanes 0-2: "
                f"{[float(v) for v in got[0, :3]]})")
    w1p32, w2p32 = (w.view(torch.int32) for w in packs(sets[2], 1536))
    got = QP.stream_probe(w1p32, w2p32, chunk=1536, n_buf=4, mode="dma")
    want = QP.stream_probe_plain(w1p32, w2p32, "dma")
    torch.cuda.synchronize()
    d = float((got.double() - want.double()).abs().max())
    if d > 1e-6 * float(want.abs().max()):
        raise AssertionError(f"stream_probe dma-as-i32: |d| {d:.3e} beyond 1e-6 of |ref| {float(want.abs().max()):.3e}")
    log(f"  stream_probe dma-as-i32 (1536, 4): |d| {d:.3e} <= 1e-6 |ref| ({float(want[0, 0]):.6e}) ok")
    pks = [packs(s, 1536) for s in sets]
    probe_graph = {}
    for mode in ("dma", "dequant"):
        fns = [lambda p=p, mode=mode: QP.stream_probe(*p, chunk=1536, n_buf=4, mode=mode) for p in pks]
        probe_ms[mode] = cuda_ms(fns, 30)
        probe_graph[mode] = graph_ms(fns)
        QP.stream_probe(*pks[0], chunk=1536, n_buf=4, mode=mode)
        torch.cuda.synchronize()
        us = QP._build.phase_us("rq_stream_probe_phase_ns", 4)
        log(f"  stream_probe {mode}: CTA 0's stamps (us): first stage landed {us[0]:.2f}, then w1 streamed "
            f"{us[1]:.2f}, then w2 streamed and the sums added {us[2]:.2f}")
    probe_plain = cuda_ms([lambda p=p: QP.stream_probe_plain(*p, "dequant") for p in pks], 30)
    probe_lib = cuda_ms([lambda p=p: (torch.sum(p[0], 2, dtype=torch.float32), torch.sum(p[1], 2, dtype=torch.float32))
                         for p in pks], 30)
    pb = bound(2 * C * H + QP.PROBE_LANES * 4, 0, BF16_TENSOR_FLOPS)
    plan = QP.probe_plan(C, H)
    weight_bytes = C * C + 2 * C * H  # #6's int8 weights: wo, w1, w2
    aims = {"dma": 0.008, "dequant": 0.0094}
    log(f"  stream_probe plan (#6's at B {QP.PROBE_ROWS}): {plan.clusters} groups of {plan.cluster} CTAs, a ring of "
        f"{plan.stages} stages of one 4096 B int8 tile (#6's stage stride, {4096 + plan.row_tile * 128} B, with its "
        f"t tile), {plan.smem} B of shared memory")
    depth = {}  # the ring of #6's plan at other batches: as many stages as its shared memory leaves
    for rows in PROBE_DEPTH_ROWS:
        ring = QP.probe_plan(C, H, rows=rows)
        for m in ("dma", "dequant"):
            if not torch.equal(QP.launch_probe(*pks[0], 1536, m, ring), QP.stream_probe_plain(*pks[0], m)):
                raise AssertionError(f"stream_probe {m} on #6's ring at B {rows}: not bit-equal to the plain version")
        depth[rows] = (ring.stages, *(graph_ms([lambda w=w, m=m: QP.launch_probe(*w, 1536, m, ring) for w in pks])
                                      for m in ("dma", "dequant")))
    log("  stream_probe on #6's ring at other batches (graph replay; B: stages, dma, dequant): " + "; ".join(
        f"B {r}: {st} stages, {dma:.4f} ms ({2 * C * H / dma * 1e-6:.0f} GB/s), {deq:.4f} ms "
        f"({2 * C * H / deq * 1e-6:.0f} GB/s)" for r, (st, dma, deq) in depth.items()))
    log(f"  stream_probe time (1536, 4): device (graph replay) "
        + ", ".join(f"{m} {probe_graph[m]:.4f} ms ({2 * C * H / probe_graph[m] * 1e-6:.0f} GB/s, "
                    f"{pb['bound_ms'] / probe_graph[m]:.1%} of the bound; aim <= {aims[m]} ms "
                    f"{'met' if probe_graph[m] <= aims[m] else 'missed'})" for m in ("dma", "dequant"))
        + f"; #6 in the same run streams its {weight_bytes / 1e6:.1f} MB of weights at "
        f"{weight_bytes / graph['#6'] * 1e-6:.0f} GB/s; eager dma {probe_ms['dma']:.4f} ms, dequant "
        f"{probe_ms['dequant']:.4f} ms, plain (dequant) {probe_plain:.4f} ms, library (torch.sum(w, 2, "
        f"dtype=float32) over w1p and w2p, the row sums of the dequant mode; none computes dma's "
        f"one-value-per-row touch) {probe_lib:.4f} ms, bound {pb['bound_ms']:.4f} ms by {pb['bound_by']}; "
        f"{card_line()}")
    probe_entry = {"max_abs_err": 0.0,  # bit-equal, checked above
                   "ms": probe_ms["dequant"], "graph_ms": probe_graph["dequant"], "plain_ms": probe_plain,
                   "library_ms": probe_lib, **pb, "dma_ms": probe_ms["dma"], "dma_graph_ms": probe_graph["dma"],
                   "stages": plan.stages,
                   "by_stages": {st: {"dma_graph_ms": dma, "graph_ms": deq} for st, dma, deq in depth.values()}}

    return ring_entry, packed_entry, probe_entry


W8A8_PHASES = ("proj", "barrier 1", "LN2 + hq rows", "barrier 2", "phase A (w1)", "barrier 3", "tq", "barrier 4",
               "phase B (w2)")
# #16's quantized activations: the share of hq and tq entries that may
# differ from the plain version's, each by one (tests/test_torch_w8a8.py FLIPS)
W8A8_FLIPS = 0.005


def w8a8_stamps(what) -> dict:
    """CTA 0's phases of the last csrc/dense_w8a8.cu launch (us) and the K
    loop's end / the exchange's opening of phase A's first tiles (us into
    phase A), logged."""
    from rqvae_tpu_torch.ops import _build

    torch.cuda.synchronize()
    ns = _build.stamps_ns("rq_dense_w8a8_phase_ns")
    us = dict(zip(W8A8_PHASES, ((ns[i + 1] - ns[i]) / 1e3 for i in range(9))))
    tiles = [(ns[10 + i] - ns[4]) / 1e3 for i in range(6)]
    log(f"  {what} phases of one call (CTA 0, us): " + ", ".join(f"{k} {v:.1f}" for k, v in us.items())
        + "; phase A's first tiles' K loop end / exchange open (us into phase A): "
        + ", ".join(f"{tiles[i]:.1f} / {tiles[i + 1]:.1f}" for i in range(0, 6, 2)))
    return {**us, "tiles_us": tiles}


def q8a8_held(W8, name, args, chunk, gelu, got):
    """#16's output `got` against its plain version, with the kernel's own
    quantized activations (hq, the tq tile images and ts in its scratch,
    read right after the call) against the plain version's: at most
    W8A8_FLIPS of the hq and of the tq entries may differ, each by one, and
    elementwise |got - want| <= TOL (1 + |want|) + what they explain. An
    ulp of x2 or of LN2's statistics (cuBLAS's sums against the kernel's
    split-K ones) can move h / hs across a rounding half; the hq entry then
    differs by one, its row of t moves by hs w1 s1, some tq entries follow,
    and each moves an output by ts |w2| s2: the bound adds sum_j (ts_j |tq_j
    - tq_j'|) @ (|w2_j| s2)^T + |ts_j - ts_j'| |tq_j'| @ (|w2_j| s2)^T
    (tests/test_torch_w8a8.py, which holds the port to JAX the same way).
    Logs how many elements pass TOL alone. Returns the max |got - want|."""
    x, w1_q, w2_q, w2_s = args[0], args[7], args[10], args[11]
    M, C = x.shape
    H = w1_q.shape[0]
    want, st = W8.q8a8_steps(*args, gelu_version=gelu, chunk=chunk)
    torch.cuda.synchronize()
    plan = W8._device_plan(M, C, H, chunk, x.device)
    buf = W8._scratch(x, plan)
    rows = plan.row_tiles * plan.row_tile
    m = torch.arange(M, device=x.device)
    where = torch.arange(4, device=x.device)[None, :] ^ ((m[:, None] >> 1) & 3)  # row m's chunk c: at c ^ (m / 2 % 4)
    img = buf["tq"].view(H // 64, rows, 4, 16)[:, :M]
    tq = torch.gather(img, 2, where[None, :, :, None].expand(H // 64, M, 4, 16)).permute(1, 0, 2, 3).reshape(M, H)
    ts = buf["ts"][:, :M]
    flips = {}
    for what, a, b in (("hq", buf["hq"][:M], st["hq"]), ("tq", tq, torch.cat(st["tq"], 1))):
        d = (a.int() - b.int()).abs()
        flips[what] = int((d > 0).sum())
        if int(d.max()) > 1 or flips[what] > W8A8_FLIPS * d.numel():
            raise AssertionError(f"{name}: {flips[what]} of {d.numel()} {what} entries differ from the plain "
                                 f"version's, by up to {int(d.max())}")
    w2abs = w2_q.abs().float() * w2_s.float()[:, None]
    explained = torch.zeros((M, C), dtype=torch.float32, device=x.device)
    for j in range(H // chunk):
        sl = slice(j * chunk, (j + 1) * chunk)
        sk, sp = ts[j][:, None], st["ts"][j]
        dq = (tq[:, sl].float() - st["tq"][j].float()).abs()
        explained += (sk * dq) @ w2abs[:, sl].t() + ((sk - sp).abs() * st["tq"][j].float().abs()) @ w2abs[:, sl].t()
    diff = (got.float() - want.float()).abs()
    tol = TOL * (1 + want.float().abs())
    beyond = diff > tol + explained
    n_tol = int((diff > tol).sum())
    if bool(beyond.any()):
        i = int(((diff - tol - explained) * beyond).flatten().argmax())
        raise AssertionError(f"{name}: disagreement beyond TOL (1 + |ref|) + the flips' share at "
                             f"{int(beyond.sum())} of {diff.numel()} elements, worst at flat index {i}: got "
                             f"{float(got.flatten()[i])}, want {float(want.flatten()[i])}, explained "
                             f"{float(explained.flatten()[i]):.3e}")
    err = float(diff.max())
    log(f"  {name}: max_abs_err {err:.3e} mean_abs_err {float(diff.mean()):.3e}; hq entries differing {flips['hq']}, "
        f"tq {flips['tq']} (each by one); beyond TOL alone {n_tol} of {diff.numel()} elements, all within what the "
        f"flips explain; ok")
    return err


def check_w8a8(W8, DK, quantize_weight, dev, gen):
    """#16 (ops/w8a8_kernel.py; csrc/dense_w8a8.cu, s8 wgmma) against its
    plain version at the experiment's shapes: C 1536, H 6144, bf16
    activations, int8 weights from quantize_weight, nonzero biases; B 100 at
    chunks 1536 and 768 and both gelu forms, a ragged B 37, B 300 and B 500,
    and C 2560 (H 10240, chunk 2560) at B 100 both gelu forms: q8a8_held
    (TOL plus what the quantized activations that differ explain). The
    chunk is part of the result (ts_j is taken per chunk): the kernel's
    output at chunk 768 must differ from its output at 1536 by the plain
    version's mean |d| within 10%. One device kernel a call, CTA 0's
    phases. At (B 100, chunk 1536), L2-cold (6 weight sets of 21.2 MB in
    turn): CUDA-graph device time of the kernel, its first design
    (fused_proj_mlp_q8a8_v1, csrc/w8a8.cu), #6 (the same layer on bf16
    activations) and the library (F.linear for wo on the dequantized bf16
    wo, then two torch._int_mm over the whole H on int8 activations of the
    same shapes), eager time of the kernel and the plain version, and the
    bound (int8 products at the int8 peak, the wo product at the bf16
    peak); at B 300 and 500 the device time of the kernel and #6 on the same
    weight sets (where int8 activations pay). Returns the JSON entry (no
    launches yet)."""
    B, C = BATCH, 1536
    H = 4 * C

    def rnd(*shape, std=1.0, mean=0.0):
        return (torch.randn(*shape, generator=gen, device=dev) * std + mean).to(torch.bfloat16)

    def qw(*shape):
        return quantize_weight(rnd(*shape, std=0.02))

    def layer(C, H):
        return (*qw(C, C), rnd(C, std=0.02), *qw(H, C), rnd(H, std=0.02), *qw(C, H), rnd(C, std=0.02))

    ln_s, ln_b = rnd(C, std=0.1, mean=1.0), rnd(C, std=0.1)
    sets = [layer(C, H) for _ in range(6)]  # 6 x 21.2 MB

    def call(fn, x, y, s, chunk=1536, gelu="v1", ln=(ln_s, ln_b)):
        return fn(x, y, s[0], s[1], s[2], *ln, *s[3:], gelu_version=gelu, chunk=chunk)

    def held(tag, x, y, s, chunk=1536, gelu="v1", ln=(ln_s, ln_b)):
        got = call(W8.fused_proj_mlp_q8a8, x, y, s, chunk, gelu, ln)
        plan = W8._device_plan(x.shape[0], x.shape[1], s[3].shape[0], chunk, dev)
        err = q8a8_held(W8, f"fused_proj_mlp_q8a8 {tag} chunk={chunk} gelu {gelu} (cluster {plan.cluster} x "
                             f"{plan.clusters}, row tile {plan.row_tile} x {plan.row_tiles}, {plan.stages} stages)",
                        (x, y, s[0], s[1], s[2], *ln, *s[3:]), chunk, gelu, got)
        return err, got, call(W8.fused_proj_mlp_q8a8_plain, x, y, s, chunk, gelu, ln)

    x, y = rnd(B, C), rnd(B, C)
    err, outs = 0.0, {}
    for chunk, gelu in ((1536, "v1"), (768, "v1"), (1536, "v2")):
        e, got, want = held(f"B={B}", x, y, sets[0], chunk, gelu)
        err = max(err, e)
        outs[chunk, gelu] = got, want
    (k1, p1), (k2, p2) = outs[1536, "v1"], outs[768, "v1"]
    dk, dp = float((k1.float() - k2.float()).abs().mean()), float((p1.float() - p2.float()).abs().mean())
    if not (dp > 0 and abs(dk - dp) <= 0.1 * dp):
        raise AssertionError(f"fused_proj_mlp_q8a8: chunk 1536 -> 768 moves the kernel's output by mean |d| "
                             f"{dk:.4e}, the plain version's by {dp:.4e}")
    log(f"  fused_proj_mlp_q8a8 chunk 1536 -> 768: mean |d| kernel {dk:.4e}, plain {dp:.4e} (within 10%)")
    for b in (37, 300, 500):
        err = max(err, held(f"B={b}", rnd(b, C), rnd(b, C), sets[1])[0])
    wide = layer(2560, 10240)
    ln_wide = (rnd(2560, std=0.1, mean=1.0), rnd(2560, std=0.1))
    xw, yw = rnd(B, 2560), rnd(B, 2560)
    for gelu in ("v1", "v2"):
        err = max(err, held(f"C=2560 B={B}", xw, yw, wide, 2560, gelu, ln_wide)[0])
    del wide
    fn = lambda: call(W8.fused_proj_mlp_q8a8, x, y, sets[0])  # noqa: E731
    fn()  # the plan, scratch and tensor maps are made on the host before the profiled call
    kernels = device_kernels(fn)
    if len(kernels) != 1 or "w8a8_kernel" not in kernels[0]:
        raise AssertionError(f"fused_proj_mlp_q8a8: one call issued device kernels {kernels}, not one w8a8_kernel")
    log(f"  fused_proj_mlp_q8a8: one call issues one device kernel ({kernels[0][:72]}...)")
    fn()
    phases = w8a8_stamps(f"fused_proj_mlp_q8a8 B={B}")
    hq = torch.randint(-127, 128, (B, C), generator=gen, device=dev, dtype=torch.int8)
    tq = torch.randint(-127, 128, (B, H), generator=gen, device=dev, dtype=torch.int8)
    wo_bf = [s[0].to(torch.bfloat16) * s[1][:, None] for s in sets]
    kernel = [lambda s=s: call(W8.fused_proj_mlp_q8a8, x, y, s) for s in sets]
    library = [lambda s=s, w=w: (F.linear(y, w), torch._int_mm(hq, s[3].t()), torch._int_mm(tq, s[6].t()))
               for s, w in zip(sets, wo_bf)]
    graph = {"kernel": graph_ms(kernel),
             "first design": graph_ms([lambda s=s: call(W8.fused_proj_mlp_q8a8_v1, x, y, s) for s in sets]),
             "#6": graph_ms([lambda s=s: DK.fused_proj_mlp_q8(x, y, s[0], s[1], s[2], ln_s, ln_b, *s[3:])
                             for s in sets]),
             "library": graph_ms(library)}
    ms = cuda_ms(kernel, 30)
    plain = cuda_ms([lambda s=s: call(W8.fused_proj_mlp_q8a8_plain, x, y, s) for s in sets], 6)
    # where int8 activations pay: #16 against #6 at the larger batches, on the same weights
    wider = {}
    for b in (300, 500):
        xb, yb = rnd(b, C), rnd(b, C)
        wider[b] = {"graph_ms": graph_ms([lambda s=s: call(W8.fused_proj_mlp_q8a8, xb, yb, s) for s in sets]),
                    "q8_graph_ms": graph_ms([lambda s=s: DK.fused_proj_mlp_q8(xb, yb, s[0], s[1], s[2], ln_s, ln_b,
                                                                              *s[3:]) for s in sets])}
    log("  fused_proj_mlp_q8a8 against #6 (fused_proj_mlp_q8), device (graph replay): " + "; ".join(
        f"B {b} {r['graph_ms']:.4f} ms against {r['q8_graph_ms']:.4f} ({r['graph_ms'] / r['q8_graph_ms']:.2f}x #6's "
        f"time)" for b, r in wider.items()) + f"; {card_line()}")
    n_bytes = 2 * B * C * 2 + (C * C + 2 * C * H) + 2 * (2 * C + H) * 2 + 2 * C * 2 + B * C * 2
    b = bound(n_bytes, 2 * B * 2 * C * H, INT8_TENSOR_OPS, more=((2 * B * C * C, BF16_TENSOR_FLOPS),))
    log(f"  fused_proj_mlp_q8a8 time (B {B}, chunk 1536): device (graph replay) "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in graph.items())
        + f" (the first design {graph['first design'] / graph['kernel']:.2f}x the kernel; #6 "
        f"{graph['#6'] / graph['kernel']:.2f}x); eager kernel {ms:.4f} ms, plain {plain:.4f} ms; library = F.linear "
        f"for wo + two torch._int_mm over the whole H, no LN, quantization or epilogues; bound {b['bound_ms']:.4f} ms "
        f"by {b['bound_by']}; {card_line()}")
    return {"max_abs_err": err, "ms": ms, "graph_ms": graph["kernel"], "v1_graph_ms": graph["first design"],
            "q8_graph_ms": graph["#6"], "plain_ms": plain, "library_ms": graph["library"], **b, "phase_us": phases,
            "b300": wider[300], "b500": wider[500]}


MLP_KERNEL_PHASES = ("panel", "LN statistics", "normalise", "phase A tiles (w1)", "grid barrier", "phase B (w2)")


def dense_mlp_stamps(what) -> dict:
    """CTA 0's phases of the last csrc/dense_mlp.cu launch (us), and the K
    loop's end / the exchange's opening of its first tiles in each phase
    (us from the phase's first tile), logged."""
    from rqvae_tpu_torch.ops import _build

    torch.cuda.synchronize()
    ns = _build.stamps_ns("rq_dense_mlp_phase_ns")
    us = dict(zip(MLP_KERNEL_PHASES, ((ns[i + 1] - ns[i]) / 1e3 for i in range(6))))
    tiles = {"A": [(ns[7 + i] - ns[3]) / 1e3 for i in range(6)], "B": [(ns[13 + i] - ns[5]) / 1e3 for i in range(2)]}
    log(f"  {what} phases of one call (CTA 0, us): " + ", ".join(f"{k} {v:.1f}" for k, v in us.items())
        + "; first tiles' K loop end / exchange open (us into the phase): "
        + "; ".join(f"{ph} " + ", ".join(f"{t[i]:.1f} / {t[i + 1]:.1f}" for i in range(0, len(t), 2))
                    for ph, t in tiles.items()))
    return {**us, "tiles_us": tiles}


def one_dense_mlp(name, fn) -> None:
    """fn() issues exactly one device kernel, csrc/dense_mlp.cu's."""
    fn()  # the plan, scratch and tensor maps are made on the host before the profiled call
    kernels = device_kernels(fn)
    if len(kernels) != 1 or "dense_mlp_kernel" not in kernels[0]:
        raise AssertionError(f"{name}: one call issued device kernels {kernels}, not one dense_mlp_kernel")
    log(f"  {name}: one call issues one device kernel ({kernels[0][:72]}...)")


def check_mlp(MK, DM, dev, gen):
    """#15 (ops/mlp_kernel.py; the "mlp" form of csrc/dense_mlp.cu) against
    its plain version at the experiment's shapes: C 1536, H 6144, bf16 x,
    weights and biases (std 0.02), fp32 LayerNorm parameters; B 37, 100,
    129 and 500, both gelu forms: TOL; its first design (fused_mlp_v1,
    csrc/mlp.cu) at B 100 and 500 too. One device kernel per call, CTA 0's
    phases. At B 100 and 500, L2-cold (3 weight sets of 37.7 MB in turn):
    CUDA-graph device time of the kernel, the first design and the library
    (two bf16 F.linear, the GEMMs alone), eager time of the kernel, the
    plain version and the library, and the bound; at B 500 also the plan
    mlp_plan makes of 128-row tiles alone (four weight passes) against the
    kernel's own (two). Then C 2560, H 10240 at B 500 (three passes of 192-row tiles,
    split between the warpgroups), both gelu forms: TOL. Returns the JSON
    entry at B 100 with the B 500 row under "b500" (no launches yet)."""
    C = 1536
    H = 4 * C

    def rnd(*shape, std=1.0, mean=0.0):
        return (torch.randn(*shape, generator=gen, device=dev) * std + mean).to(torch.bfloat16)

    sets = [(rnd(C, std=0.1, mean=1.0).float(), rnd(C, std=0.1).float(), rnd(H, C, std=0.02), rnd(H, std=0.02),
             rnd(C, H, std=0.02), rnd(C, std=0.02)) for _ in range(3)]  # 3 x 37.7 MB
    err, rows = 0.0, {}
    for b in (37, 100, 129, 500):
        x = rnd(b, C)
        plan = DM.device_plan(x, C, H, "mlp", 2)
        for gelu in ("v1", "v2"):
            want = MK.fused_mlp_plain(x, *sets[0], gelu_version=gelu)
            got = MK.fused_mlp(x, *sets[0], gelu_version=gelu)
            torch.cuda.synchronize()
            err = max(err, compare(f"fused_mlp B={b} gelu {gelu} (cluster {plan.cluster} x {plan.clusters}, row tile "
                                   f"{plan.row_tile} x {plan.row_tiles}, {plan.stages} stages, {plan.t_slots} t slots)",
                                   got, want)[0])
        if b in (100, 500):
            compare(f"fused_mlp_v1 B={b} (the first design)", MK.fused_mlp_v1(x, *sets[0]),
                    MK.fused_mlp_plain(x, *sets[0]))
    x = rnd(BATCH, C)
    one_dense_mlp("fused_mlp", lambda: MK.fused_mlp(x, *sets[0]))
    phases = {}
    for b in (100, 500):
        x = rnd(b, C)
        MK.fused_mlp(x, *sets[0])
        phases[b] = dense_mlp_stamps(f"fused_mlp B={b}")
    for b in (100, 500):
        x = rnd(b, C)
        kernel = [lambda s=s: MK.fused_mlp(x, *s) for s in sets]
        v1 = [lambda s=s: MK.fused_mlp_v1(x, *s) for s in sets]
        library = [lambda s=s: F.linear(F.linear(x, s[2]), s[4]) for s in sets]
        ms = cuda_ms(kernel, 30)
        plain = cuda_ms([lambda s=s: MK.fused_mlp_plain(x, *s) for s in sets], 30)
        lib = cuda_ms(library, 30)
        graph = {"kernel": graph_ms(kernel), "first design": graph_ms(v1), "library": graph_ms(library)}
        bb = bound(2 * b * C * 2 + 2 * C * 4 + 2 * C * H * 2 + (H + C) * 2, 2 * b * 2 * C * H, BF16_TENSOR_FLOPS)
        plan = DM.device_plan(x, C, H, "mlp", 2)
        row = {"ms": ms, "plain_ms": plain, "library_ms": graph["library"], "library_eager_ms": lib,
               "graph_ms": graph["kernel"], "v1_graph_ms": graph["first design"], **bb,
               "plan": f"cluster {plan.cluster} x {plan.clusters}, row tile {plan.row_tile} x {plan.row_tiles}",
               "phase_us": phases[b]}
        if b == 500:  # the candidate plans: 256-row tiles (two weight passes) against 128-row ones (four)
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            with mock.patch.object(DM, "ROW_TILES", tuple(t for t in DM.ROW_TILES if t <= 128)):
                p128 = DM.mlp_plan(b, C, H, "mlp", 2, 0, sms,
                                   lambda form, mt, s, smem: DM.max_clusters(form, mt, s, smem, 2))
            s0 = sets[0]
            got = DM.launch(p128, x, s0[2], s0[4], ln_w=s0[0], ln_b=s0[1], b1=s0[3], b2=s0[5])
            torch.cuda.synchronize()
            compare(f"fused_mlp B=500 on 128-row tiles (cluster {p128.cluster} x {p128.clusters}, "
                    f"{p128.row_tiles} tiles)", got, MK.fused_mlp_plain(x, *s0))
            row["tiles128_graph_ms"] = graph_ms([lambda s=s: DM.launch(p128, x, s[2], s[4], ln_w=s[0], ln_b=s[1],
                                                                       b1=s[3], b2=s[5]) for s in sets])
            row["graph_ms_again"] = graph_ms(kernel)
            log(f"  fused_mlp B 500 plans (graph replay): {plan.row_tile}-row tiles x {plan.row_tiles} "
                f"{row['graph_ms']:.4f} / {row['graph_ms_again']:.4f} ms, 128-row tiles x {p128.row_tiles} "
                f"{row['tiles128_graph_ms']:.4f} ms")
        log(f"  fused_mlp time (B {b}): device (graph replay) kernel {graph['kernel']:.4f} ms, first design "
            f"{graph['first design']:.4f} ms ({graph['first design'] / graph['kernel']:.2f}x the kernel), library (two "
            f"F.linear, the GEMMs alone) {graph['library']:.4f} ms; eager kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"library {lib:.4f} ms; bound {bb['bound_ms']:.4f} ms by {bb['bound_by']}; {row['plan']}; {card_line()}")
        rows[b] = row
    C, H, b = 2560, 4 * 2560, 500  # the widest of WIDTHS: 192-row tiles, the warpgroups' halves
    w = (rnd(C, std=0.1, mean=1.0).float(), rnd(C, std=0.1).float(), rnd(H, C, std=0.02), rnd(H, std=0.02),
         rnd(C, H, std=0.02), rnd(C, std=0.02))
    x = rnd(b, C)
    plan = DM.device_plan(x, C, H, "mlp", 2)
    for gelu in ("v1", "v2"):
        got = MK.fused_mlp(x, *w, gelu_version=gelu, chunk=C)
        torch.cuda.synchronize()
        err = max(err, compare(f"fused_mlp C={C} B={b} gelu {gelu} (cluster {plan.cluster} x {plan.clusters}, row "
                               f"tile {plan.row_tile} x {plan.row_tiles})", got,
                               MK.fused_mlp_plain(x, *w, gelu_version=gelu))[0])
    return {"max_abs_err": err, **rows[100], "b500": rows[500]}


ABLATE_CASES = (("q8 full", True, True, True, 4), ("q8 no-gelu", True, False, True, 4),
                ("q8 no-gelu-noscale", True, False, False, 4), ("bf16 same-ring", False, True, True, 2))


def check_ablate(QP, quantize_weight, dev, gen):
    """#20 (ops/q8_pipeline_kernel.py::ablate_ring; the "ring" form of
    csrc/dense_mlp.cu) against its plain version in the four ablation cases
    at the experiment's shapes (B 100, C 1536, H 6144, chunk 1536, int8
    weights from quantize_weight and their dequantized bf16 copies), at the
    output's scale, as is its first design (ablate_ring_v1, the MLP-only
    form of csrc/q8_pipeline.cu's ring kernel); "q8 full" also at B 500
    (two passes of 256-row tiles, split between the warpgroups). One device
    kernel per call, CTA 0's phases. Each case L2-cold (3 weight sets in turn): CUDA-graph
    device time of the kernel, the first design and the library (two
    F.linear on the bf16 weights), eager time of the kernel, and the bound.
    Returns the JSON entry (no launches yet)."""
    from rqvae_tpu_torch.ops import dense_mlp_kernel as DM

    B, C = BATCH, 1536
    H = 4 * C

    def rnd(*shape, std=1.0, mean=0.0):
        return (torch.randn(*shape, generator=gen, device=dev) * std + mean).to(torch.bfloat16)

    q1 = [quantize_weight(rnd(H, C, std=0.02)) for _ in range(3)]
    q2 = [quantize_weight(rnd(C, H, std=0.02)) for _ in range(3)]
    deq = [(a.to(torch.bfloat16) * sa[:, None], b.to(torch.bfloat16) * sb[:, None]) for (a, sa), (b, sb) in zip(q1, q2)]
    packs = {True: [(QP.pack_w1(a, 1536), QP.pack_w2(b, 1536)) for (a, _), (b, _) in zip(q1, q2)],
             False: [(QP.pack_w1(a, 1536), QP.pack_w2(b, 1536)) for a, b in deq]}
    h = rnd(B, C)
    errs, rows = {}, {}
    for name, int8, g, sc, nb in ABLATE_CASES:
        def call(i, fn=QP.ablate_ring, int8=int8, g=g, sc=sc, nb=nb):
            w1p, w2p = packs[int8][i]
            kw = {} if fn is QP.ablate_ring_plain else dict(chunk=1536, n_buf=nb)
            return fn(h, w1p, q1[i][1], w2p, None, use_gelu=g, use_scale=sc, **kw)

        want = call(0, QP.ablate_ring_plain)
        # w2's scale is never applied (as in JAX), so the outputs reach ~1e3
        # (1e7 without gelu and scale): a bf16 rounding of t or of the output
        # moves an output by the output's scale times 2^-8, whatever its own
        # size. TOL therefore holds at that scale: both sides divided by
        # max |want|, |d| <= TOL * (max |want| + |want|)
        scale = float(want.float().abs().max())
        for fn in (QP.ablate_ring, QP.ablate_ring_v1):
            got = call(0, fn)
            torch.cuda.synchronize()
            e, _ = compare(f"{fn.__name__} {name} (1536, {nb}), at the output's scale {scale:.4g}",
                           got.float() / scale, want.float() / scale)
            if fn is QP.ablate_ring:
                errs[name] = e * scale
        if name == "q8 full":
            one_dense_mlp("ablate_ring", lambda: call(0))
            call(0)
            phases = dense_mlp_stamps("ablate_ring q8 full")
        kernel = [lambda i=i: call(i) for i in range(3)]
        graph = {"kernel": graph_ms(kernel), "first design": graph_ms([lambda i=i: call(i, QP.ablate_ring_v1)
                                                                      for i in range(3)])}
        rows[name] = {"graph_ms": graph["kernel"], "v1_graph_ms": graph["first design"], "ms": cuda_ms(kernel, 30)}
        log(f"  ablate_ring {name}: device (graph replay) kernel {graph['kernel']:.4f} ms, first design "
            f"{graph['first design']:.4f} ms ({graph['first design'] / graph['kernel']:.2f}x the kernel); eager kernel "
            f"{rows[name]['ms']:.4f} ms")
    h500 = rnd(500, C)
    want = QP.ablate_ring_plain(h500, *packs[True][0][:1], q1[0][1], packs[True][0][1])
    got = QP.ablate_ring(h500, *packs[True][0][:1], q1[0][1], packs[True][0][1], chunk=1536)
    torch.cuda.synchronize()
    scale = float(want.float().abs().max())
    plan = DM.device_plan(h500, C, H, "ring", 1, 1536)
    e, _ = compare(f"ablate_ring q8 full B=500 (row tile {plan.row_tile} x {plan.row_tiles}), at the output's scale "
                   f"{scale:.4g}", got.float() / scale, want.float() / scale)
    errs["q8 full B 500"] = e * scale
    plain = cuda_ms([lambda i=i: QP.ablate_ring_plain(h, *packs[True][i][:1], q1[i][1], packs[True][i][1])
                     for i in range(3)], 30)
    lib = graph_ms([lambda w=w: F.linear(F.linear(h, w[0]), w[1]) for w in deq])
    ab_b = bound(2 * C * H + H * 2 + 2 * B * C * 2, 2 * B * 2 * C * H, BF16_TENSOR_FLOPS)
    ab_b16 = bound(2 * C * H * 2 + H * 2 + 2 * B * C * 2, 2 * B * 2 * C * H, BF16_TENSOR_FLOPS)
    log(f"  ablate_ring: plain (q8 full) {plain:.4f} ms, library (two F.linear on bf16 weights, graph replay) "
        f"{lib:.4f} ms, bound {ab_b['bound_ms']:.4f} ms by {ab_b['bound_by']} (bf16 weights {ab_b16['bound_ms']:.4f} "
        f"ms); {card_line()}")
    full = rows["q8 full"]
    return {"max_abs_err": errs["q8 full"], "ms": full["ms"], "graph_ms": full["graph_ms"],
            "v1_graph_ms": full["v1_graph_ms"], "plain_ms": plain, "library_ms": lib, **ab_b,
            "cases_max_abs_err": errs, "cases": rows, "bf16_bound_ms": ab_b16["bound_ms"], "phase_us": phases}


def count_sass(lib_path, op) -> int:
    """Instructions of kind `op` (e.g. IMMA) in a built library's SASS
    (cuobjdump beside nvcc)."""
    from rqvae_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib_path)], capture_output=True, text=True, check=True).stdout
    return len(re.findall(rf"\b{op}\b", sass))


# CTA 0's phases of one fused kernel (csrc/decode_fused.cu g_stamps, rq_fused_phase_ns)
MEGA_PHASES = ("LN1 + QKV", "barrier 1", "attention", "barrier 2", "wo", "barrier 3", "LN2 + w1", "barrier 4", "w2")
WO_PHASES = ("attention", "barrier 1", "wo", "barrier 2", "LN2")
# the cooperative baselines' phases (their own stamps)
MEGA_COOP_PHASES = ("LN1", "QKV", "attention", "wo", "residual+LN2", "w1", "gelu", "w2", "residual")
WO_COOP_PHASES = ("attention", "wo", "residual+LN2")


def _build_phases(entry, names):
    """{phase: us} of a fused kernel's last launch (its globaltimer stamps)."""
    from rqvae_tpu_torch.ops import _build

    torch.cuda.synchronize()
    return {n: round(us, 1) for n, us in zip(names, _build.phase_us(entry, len(names) + 1))}


def attention_steps(first):
    """{step: us} of the attention of the last rq_fused_* launch, CTA 0's
    thread 0's first task: its K pass, softmax and V pass (g_stamps first ..
    first + 2) from the attention phase's start (stamp 2 of the layer step,
    0 of the attention with wo), then its other tasks up to the next barrier
    (stamp 3, 1)."""
    from rqvae_tpu_torch.ops import _build

    torch.cuda.synchronize()
    st = _build.stamps_ns("rq_fused_phase_ns")
    start, end = (2, 3) if first == 10 else (0, 1)
    order = ((start, first, "K pass"), (first, first + 1, "softmax"), (first + 1, first + 2, "V pass"),
             (first + 2, end, "the rest"))
    return {name: round((st[b] - st[a]) / 1e3, 1) for a, b, name in order}


def layer_weights(rnd, C, H):
    """One body layer's bf16 parameters for decode_layer_step, as a dict of
    its keyword arguments ([out, in] weights, std 0.02)."""
    return dict(
        ln1_scale=rnd(C, std=0.1, mean=1.0), ln1_bias=rnd(C, std=0.1), wqkv=rnd(3 * C, C, std=0.02),
        bqkv=rnd(3 * C, std=0.02), wo=rnd(C, C, std=0.02), bo=rnd(C, std=0.02), ln2_scale=rnd(C, std=0.1, mean=1.0),
        ln2_bias=rnd(C, std=0.1), w1=rnd(H, C, std=0.02), b1=rnd(H, std=0.02), w2=rnd(C, H, std=0.02),
        b2=rnd(C, std=0.02),
    )


def check_rows(name, got, want, old, cur):
    """Row cur of the caches `got` (kernel) within TOL of `want` (plain
    version), every other row bit-equal to `old`."""
    keep = torch.ones(old.shape[1], dtype=torch.bool, device=old.device)
    keep[cur] = False
    compare(f"{name} cache row {cur}", got[:, cur], want[:, cur])
    if not torch.equal(got[:, keep], old[:, keep]):
        raise AssertionError(f"{name}: cache rows other than {cur} changed")


def one_kernel(name, fn, kernel):
    """One call of fn issues one device kernel, whose name holds `kernel`."""
    fn()  # the plan, tensor maps and scratch are made on the host before the profiled call
    kernels = device_kernels(fn)
    if len(kernels) != 1 or kernel not in kernels[0]:
        raise AssertionError(f"{name}: one call issued device kernels {kernels}, not one {kernel}")
    log(f"  {name}: one call issues one device kernel ({kernels[0][:72]}...)")


def check_decode_layer_step(MK, DK, AK, dev, gen):
    """decode_layer_step (the whole body layer, csrc/decode_fused.cu) against
    its plain version at the main-path shapes, a ragged batch, both gelu
    forms, its written k/v rows within TOL and every other row unchanged;
    one device kernel per call; CTA 0's phases; timed (eager and as device
    time in CUDA-graph replays) against the cooperative kernel it replaced
    (decode_layer_step_coop), the unfused chain #2 -> #1 -> #3, the plain
    version and the library."""
    C, nh, T = 1536, 24, 64
    H = 4 * C

    def rnd(*shape, std=1.0, mean=0.0):
        return (torch.randn(*shape, generator=gen, device=dev) * std + mean).to(torch.bfloat16)

    worst = 0.0
    # (B, cur_len, window, gelu): the main path's batch at both sampler
    # windows, the ragged batch of 37 rows, both gelu forms
    cases = [(BATCH, 0, 64, "v1"), (BATCH, 15, 32, "v1"), (BATCH, 16, 32, "v2"), (BATCH, 63, 64, "v1"),
             (BATCH, 63, 64, "v2"), (37, 0, 24, "v1"), (37, 30, 24, "v2")]
    for B, cur, window, gelu in cases:
        x, kc, vc, w = rnd(B, C), rnd(B, T, C), rnd(B, T, C), layer_weights(rnd, C, H)
        k1, v1, k0, v0 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
        got = MK.decode_layer_step(x, k1, v1, cur, **w, n_head=nh, t_window=window, gelu_version=gelu)
        want = MK.decode_layer_step_plain(x, k0, v0, cur, **w, n_head=nh, t_window=window, gelu_version=gelu)
        torch.cuda.synchronize()
        plan = DK.fused_plan(B, C, True, window)
        tag = (f"decode_layer_step B={B} cur_len={cur} window={window} gelu {gelu} (cluster {plan.cluster} x "
               f"{plan.clusters}, row tile {plan.row_tile} x {plan.row_tiles}, {plan.stages} stages)")
        err, _ = compare(tag, got, want)
        worst = max(worst, err)
        check_rows(tag + " k", k1, k0, kc, cur)
        check_rows(tag + " v", v1, v0, vc, cur)
    log("  decode_layer_step: out and the written k/v rows within the bound, every other cache row bit-unchanged")
    # time the heaviest main-path call (window 64, cur_len 63) on 2 distinct
    # layers of weights and caches (2 x 96 MB), so L2 carries nothing over
    B = BATCH
    x = rnd(B, C)
    sets = [(layer_weights(rnd, C, H), rnd(B, T, C), rnd(B, T, C)) for _ in range(2)]

    def step(fn, s):
        return fn(x, s[1], s[2], 63, **s[0], n_head=nh, t_window=64)

    def unfused(s):  # #2 -> #1 -> #3, as the bf16 point's body would run them with the head's kernels
        w = s[0]
        q, k, v = DK.fused_ln_qkv(x, w["ln1_scale"], w["ln1_bias"], w["wqkv"], w["bqkv"]).split(C, dim=-1)
        y = AK.decode_attention_update(q.contiguous(), k.contiguous(), v.contiguous(), s[1], s[2], 63, nh,
                                       t_window=64)
        return DK.fused_proj_mlp(x, y, w["wo"], w["bo"], w["ln2_scale"], w["ln2_bias"], w["w1"], w["b1"], w["w2"],
                                 w["b2"])

    def library(w, kc, vc):
        q, k, v = F.linear(x, w["wqkv"]).split(C, dim=-1)
        y = sdpa_rows(q, kc, vc, nh, 64).reshape(B, C)
        return F.linear(F.linear(F.linear(y, w["wo"]), w["w1"]), w["w2"])

    one_kernel("decode_layer_step", lambda: step(MK.decode_layer_step, sets[0]), "fused_kernel")
    ms = cuda_ms([lambda s=s: step(MK.decode_layer_step, s) for s in sets], 30)
    coop = cuda_ms([lambda s=s: step(MK.decode_layer_step_coop, s) for s in sets], 30)
    plain = cuda_ms([lambda s=s: step(MK.decode_layer_step_plain, s) for s in sets], 30)
    lib = cuda_ms([lambda s=s: library(*s) for s in sets], 30)
    graph = {"kernel": graph_ms([lambda s=s: step(MK.decode_layer_step, s) for s in sets]),
             "cooperative": graph_ms([lambda s=s: step(MK.decode_layer_step_coop, s) for s in sets]),
             "unfused #2 -> #1 -> #3": graph_ms([lambda s=s: unfused(s) for s in sets]),
             "library": graph_ms([lambda s=s: library(*s) for s in sets])}
    graph["kernel, again"] = graph_ms([lambda s=s: step(MK.decode_layer_step, s) for s in sets])
    n = 63
    weights = (3 * C * C + C * C + 2 * C * H) * 2
    vectors = (3 * C + C + H + C + 4 * C) * 2  # biases and LN parameters
    b = bound(weights + vectors + 2 * B * n * C * 2 + B * C * 2 + 2 * B * C * 2 + B * C * 2,
              2 * B * (3 * C * C + C * C + 2 * C * H), BF16_TENSOR_FLOPS, 4 * B * (n + 1) * C)
    log(f"  decode_layer_step time: kernel {ms:.4f} ms, cooperative kernel {coop:.4f} ms, plain {plain:.4f} ms, "
        f"library (four F.linear bf16 GEMMs + scaled_dot_product_attention over the 64 rows, no LN, bias, gelu or "
        f"cache write) {lib:.4f} ms, bound {b['bound_ms']:.4f} ms by {b['bound_by']} (B={B}, W=64, cur_len=63)")
    kernel_ms = max(graph["kernel"], graph["kernel, again"])
    log(f"  decode_layer_step device time ({len(sets)} calls in a CUDA graph, replayed): "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in graph.items())
        + f"; {graph['cooperative'] / kernel_ms:.2f}x faster than the cooperative kernel (aim >= 2x), "
        f"{graph['unfused #2 -> #1 -> #3'] / kernel_ms:.2f}x the unfused chain's speed (aim >= 1); {card_line()}")
    step(MK.decode_layer_step, sets[0])
    log(f"  decode_layer_step phases of one call (CTA 0, us): {_build_phases('rq_fused_phase_ns', MEGA_PHASES)}; "
        f"its attention, CTA 0's first task (us): {attention_steps(10)}")
    step(MK.decode_layer_step_coop, sets[0])
    log(f"  decode_layer_step_coop phases of one call, us: "
        f"{_build_phases('rq_decode_layer_step_phase_ns', MEGA_COOP_PHASES)}")
    return {"max_abs_err": worst, "ms": ms, "graph_ms": graph["kernel"], "coop_ms": coop,
            "coop_graph_ms": graph["cooperative"], "unfused_graph_ms": graph["unfused #2 -> #1 -> #3"],
            "plain_ms": plain, "library_ms": lib, "library_graph_ms": graph["library"], **b}


def check_attention_q8_wo(AK, DK, quantize_weight, dev, gen):
    """decode_attention_q8_update_wo (csrc/decode_fused.cu) against its plain
    version with int8 and bf16 wo at the main-path shapes and a ragged
    batch, its four caches bit-equal to the plain version's; one device
    kernel per call; CTA 0's phases; timed (eager and as device time in
    CUDA-graph replays) against the cooperative kernel it replaced
    (decode_attention_q8_update_wo_coop), the unfused chain #4 -> the
    library's wo + residual + LayerNorm, the plain version and the library."""
    C, nh, T = 1536, 24, 64

    def rnd(*shape, std=1.0, mean=0.0):
        return (torch.randn(*shape, generator=gen, device=dev) * std + mean).to(torch.bfloat16)

    def wo_pair(int8):
        w = rnd(C, C, std=0.02)
        return quantize_weight(w) if int8 else (w, None)

    vec = (rnd(C, std=0.02), rnd(C, std=0.1, mean=1.0), rnd(C, std=0.1))  # bo, ln2 scale and bias
    worst = 0.0
    for int8 in (True, False):
        wo, wo_s = wo_pair(int8)
        for B, cur, window in ((BATCH, 0, 64), (BATCH, 15, 32), (BATCH, 16, 32), (BATCH, 63, 64), (37, 0, 24),
                               (37, 30, 24)):
            q, kn, vn, x = rnd(B, C), rnd(B, C), rnd(B, C), rnd(B, C)
            cache = q8_cache(AK, rnd, B, T, C, nh)
            got, ref = [c.clone() for c in cache], [c.clone() for c in cache]
            x2, h2 = AK.decode_attention_q8_update_wo(q, kn, vn, *got, cur, x, wo, wo_s, *vec, nh, t_window=window)
            x2_0, h2_0 = AK.decode_attention_q8_update_wo_plain(q, kn, vn, *ref, cur, x, wo, wo_s, *vec, nh,
                                                                t_window=window)
            torch.cuda.synchronize()
            plan = DK.fused_plan(B, C, False, window, 1 if int8 else 2)
            tag = (f"decode_attention_q8_update_wo {'int8' if int8 else 'bf16'} wo B={B} cur_len={cur} "
                   f"window={window} (cluster {plan.cluster} x {plan.clusters}, row tile {plan.row_tile}, "
                   f"{plan.stages} stages)")
            worst = max(worst, compare(tag + " x2", x2, x2_0)[0], compare(tag + " h2", h2, h2_0)[0])
            for name, a, b0 in zip(("kq", "ks", "vq", "vs"), got, ref):
                if not torch.equal(a, b0):
                    raise AssertionError(f"{tag}: {name} after the kernel's write differs from the plain version's")
    log("  decode_attention_q8_update_wo: all four caches bit-equal to the plain version's")
    B, n = BATCH, 63
    q, kn, vn, x = rnd(B, C), rnd(B, C), rnd(B, C), rnd(B, C)
    sets = [q8_cache(AK, rnd, B, T, C, nh) for _ in range(6)]  # 6 x 19.7 MB
    ln2 = (vec[1], vec[2])
    for int8 in (True, False):
        wos = [wo_pair(int8) for _ in range(6)]
        deq = [w.to(torch.bfloat16) * s[:, None] if int8 else w for w, s in wos]

        def call(fn, i):
            return fn(q, kn, vn, *sets[i], n, x, *wos[i], *vec, nh, t_window=64)

        def unfused(i):  # #4, then the library's wo (the dequantized weight), residual and LayerNorm
            y = AK.decode_attention_q8_update(q, kn, vn, *sets[i], n, nh, t_window=64)
            x2 = x + F.linear(y, deq[i], vec[0])
            return x2, F.layer_norm(x2, (C,), *ln2, eps=DK.LN_EPS)

        tag = f"decode_attention_q8_update_wo, {'int8' if int8 else 'bf16'} wo"
        one_kernel(tag, lambda: call(AK.decode_attention_q8_update_wo, 0), "fused_kernel")
        ms = cuda_ms([lambda i=i: call(AK.decode_attention_q8_update_wo, i) for i in range(6)], 50)
        coop = cuda_ms([lambda i=i: call(AK.decode_attention_q8_update_wo_coop, i) for i in range(6)], 50)
        plain = cuda_ms([lambda i=i: call(AK.decode_attention_q8_update_wo_plain, i) for i in range(6)], 50)
        lib = cuda_ms([lambda i=i: F.linear(x, deq[i]) for i in range(6)], 50)
        graph = {"kernel": graph_ms([lambda i=i: call(AK.decode_attention_q8_update_wo, i) for i in range(6)]),
                 "cooperative": graph_ms([lambda i=i: call(AK.decode_attention_q8_update_wo_coop, i)
                                          for i in range(6)]),
                 "unfused #4 -> library wo + LN": graph_ms([lambda i=i: unfused(i) for i in range(6)]),
                 "library": graph_ms([lambda i=i: F.linear(x, deq[i]) for i in range(6)])}
        graph["kernel, again"] = graph_ms([lambda i=i: call(AK.decode_attention_q8_update_wo, i) for i in range(6)])
        wo_bytes = C * C + C * 2 if int8 else C * C * 2
        b = bound(2 * B * n * (C + 2 * nh) + 4 * B * C * 2 + wo_bytes + 3 * C * 2 + 2 * B * C * 2
                  + 2 * B * (C + 2 * nh), 2 * B * C * C, BF16_TENSOR_FLOPS, 4 * B * (n + 1) * C)
        log(f"  {tag} time: kernel {ms:.4f} ms, cooperative kernel {coop:.4f} ms, plain {plain:.4f} ms, library "
            f"(F.linear, the wo GEMM alone: no torch call attends an int8 cache) {lib:.4f} ms, bound "
            f"{b['bound_ms']:.4f} ms by {b['bound_by']} (B={B}, W=64, cur_len=63)")
        kernel_ms = max(graph["kernel"], graph["kernel, again"])
        log(f"  {tag} device time (6 calls in a CUDA graph, replayed): "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in graph.items())
            + f"; {graph['cooperative'] / kernel_ms:.2f}x faster than the cooperative kernel (aim >= 2x), "
            f"{graph['unfused #4 -> library wo + LN'] / kernel_ms:.2f}x the unfused chain's speed (aim >= 1); "
            f"{card_line()}")
        call(AK.decode_attention_q8_update_wo, 0)
        log(f"  {tag} phases of one call (CTA 0, us): {_build_phases('rq_fused_phase_ns', WO_PHASES)}; "
            f"its attention, CTA 0's first task (us): {attention_steps(6)}")
        call(AK.decode_attention_q8_update_wo_coop, 0)
        log(f"  {tag}, cooperative kernel, phases of one call, us: "
            f"{_build_phases('rq_decode_attention_q8_update_wo_phase_ns', WO_COOP_PHASES)}")
        if int8:  # the kernels table lists the int8-wo point's numbers
            row = {"max_abs_err": worst, "ms": ms, "graph_ms": graph["kernel"], "coop_ms": coop,
                   "coop_graph_ms": graph["cooperative"], "unfused_graph_ms": graph["unfused #4 -> library wo + LN"],
                   "plain_ms": plain, "library_ms": lib, "library_graph_ms": graph["library"], **b}
    return row


def nearest_vs_fp64(x, cb, got, want) -> tuple[float, float, float]:
    """(share of rows where the codes got and want are equal, the largest
    fp64 distance of got's pick over the fp64 minimum, the largest ratio of
    that excess to NEAREST_TIE_TOL (||x||^2 + ||c_pick||^2)): a ratio above
    1 is a pick that no fp32 rounding explains."""
    x64, cb64 = x.double(), cb.double()
    x_sq, cb_sq = x64.square().sum(1), cb64.square().sum(1)
    d64 = (x_sq[:, None] + cb_sq) - 2.0 * (x64 @ cb64.T)
    excess = d64.gather(1, got[:, None])[:, 0] - d64.min(dim=1).values
    share = excess / (NEAREST_TIE_TOL * (x_sq + cb_sq[got]))
    return float((got == want).double().mean()), float(excess.max()), float(share.max())


# nearest_code's planted ties (lo, hi), row hi a copy of row lo, placed on
# the geometry of csrc/nearest_code.cu: units of 128 rows x 256 codes, each
# consumer warpgroup holding all 256 codes of its 64 rows, lane q of a row
# codes 8 j + 2 q and 8 j + 2 q + 1; at the encode shape unit u = (row
# block u mod 50, code tile u div 50), CTA b taking u = b, b + 132, ....
# The tie rows lie in row block 0: one thread's adjacent codes (100, 101),
# one thread's codes 24 apart (17, 41), two lanes of one row (3, 40), two
# lanes of code tile 3 (770, 1000), code tiles 0 and 1 (130, 500; CTAs 0
# and 50), tiles 0 and 3 (60, 800; tile 3 is unit 150, CTA 18's second),
# the first and the last tile (5, 16000). x rows 2i and 2i + 1 are row hi
# and row hi + noise: both must get lo.
NEAREST_KERNELS = ("split_kernel", "nearest_kernel", "nearest_code_reduce_kernel")  # one call's three, in order
NEAREST_TIES = ((100, 101), (17, 41), (3, 40), (770, 1000), (130, 500), (60, 800), (5, 16000))


def check_nearest_code(RK, dev, gen):
    """nearest_code (csrc/nearest_code.cu, 3xTF32 on wgmma) at one depth of
    the bs100 encode, x [6400, 256] against 16384 codes: the planted ties
    give the lower index exactly, >= NEAREST_AGREE of the codes equal the
    plain version's and no pick lies beyond NEAREST_TIE_TOL of the fp64
    minimum, there and at ragged shapes; then, L2-cold (5 sets of 117 MB in
    turn), CUDA-graph device time of the kernel (its three launches), the
    library's x @ cb.T (the GEMM alone, TF32 off) and the plain version,
    eager times, and both bounds: 3xTF32 on the tensor cores (the least
    time for fp32-accurate distances) and fp32 on the SIMT units. Returns
    its JSON entry (no launches yet)."""
    N, dim, E = BATCH * 64, 256, 16384  # one depth of the bs100 encode: 100 images x 8 x 8 codes

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    plan = RK.nearest_plan(N, E, dim, torch.cuda.get_device_properties(dev).multi_processor_count)
    log(f"  nearest_code plan: {plan.row_blocks} row blocks of {RK.ROW_TILE} x {plan.code_tiles} code tiles of "
        f"{RK.CODE_TILE} = {plan.row_blocks * plan.code_tiles} units on {plan.grid} persistent CTAs, a ring of "
        f"{RK.RING} stages of {(2 * RK.ROW_TILE + 2 * RK.CODE_TILE) * RK.K_STAGE * 4} B, {RK.smem_bytes()} B of "
        f"shared memory")
    x, cb = rnd(N, dim), rnd(E, dim)  # N(0, 1) codebook, as init_weights makes it
    for i, (lo, hi) in enumerate(NEAREST_TIES):
        cb[hi] = cb[lo]
        x[2 * i] = cb[hi]
        x[2 * i + 1] = cb[hi] + 0.01 * rnd(dim)
    got = RK.nearest_code(x, cb)
    want = RK.nearest_code_plain(x, cb)
    torch.cuda.synchronize()
    tie_rows = 2 * len(NEAREST_TIES)
    expect = torch.tensor([lo for lo, _ in NEAREST_TIES for _ in range(2)], device=dev)
    if not torch.equal(got[:tie_rows], expect):
        raise AssertionError(f"nearest_code planted ties: got {got[:tie_rows].tolist()}, want {expect.tolist()}")
    log(f"  nearest_code planted ties {NEAREST_TIES}: the lower index, exactly (plain version: "
        f"{'the same' if torch.equal(want[:tie_rows], expect) else want[:tie_rows].tolist()})")
    agree, excess, share = nearest_vs_fp64(x, cb, got, want)
    ok = agree >= NEAREST_AGREE and share <= 1.0
    log(f"  nearest_code x[{N},{dim}] codebook[{E},{dim}]: codes equal to the plain version's on "
        f"{agree:.6f} of rows ({int(((got != want).sum()))} differ; bound >= {NEAREST_AGREE}); kernel pick "
        f"over the fp64 minimum: max {excess:.3e}, max share of the bound {share:.3e} (bound "
        f"{NEAREST_TIE_TOL} (||x||^2 + ||c||^2)) {'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError("nearest_code: disagreement beyond the bound")
    for n, d, e in ((300, 48, 200), (77, 20, 1000), (1, 256, 16384)):  # ragged edges on every axis
        xr, cr = rnd(n, d), rnd(e, d)
        a, _, sh = nearest_vs_fp64(xr, cr, RK.nearest_code(xr, cr), RK.nearest_code_plain(xr, cr))
        log(f"  nearest_code x[{n},{d}] codebook[{e},{d}]: equal on {a:.4f} of rows, max share of the bound {sh:.3e}")
        if sh > 1.0:
            raise AssertionError(f"nearest_code at [{n},{d}] x [{e},{d}]: a pick beyond the fp64 bound")
    # 5 distinct (x, codebook) sets of 23.4 MB: 117 MB, so L2 is cold
    sets = [(rnd(N, dim), rnd(E, dim)) for _ in range(5)]
    kernel = [lambda s=s: RK.nearest_code(*s) for s in sets]
    library = [lambda s=s: s[0] @ s[1].T for s in sets]
    kernel[0]()  # the tensor maps are encoded on the host before the graph capture and the profiled call
    names = device_kernels(kernel[1])
    if len(names) != 3 or not all(k in n for k, n in zip(NEAREST_KERNELS, names)):
        raise AssertionError(f"nearest_code: one call issued device kernels {names}, not {NEAREST_KERNELS}")
    events = device_events(kernel[1])
    if events is not None and len(events) == 3 and all(k in n for k, (n, _) in zip(NEAREST_KERNELS, events)):
        log(f"  nearest_code: one call issues three device kernels (CUDA graph): {', '.join(NEAREST_KERNELS)}; "
            f"their device us (torch.profiler): " + ", ".join(f"{us:.1f}" for _, us in events))
    else:
        log(f"  nearest_code: one call issues three device kernels (CUDA graph): {', '.join(NEAREST_KERNELS)}; the "
            f"profile of their durations lost events ({None if events is None else [n for n, _ in events]})")
    graph = {"kernel": graph_ms(kernel), "library": graph_ms(library)}
    ms = cuda_ms(kernel, 20)
    plain = cuda_ms([lambda s=s: RK.nearest_code_plain(*s) for s in sets], 20)
    lib = cuda_ms(library, 20)
    n_bytes = N * dim * 4 + E * dim * 4 + N * 8
    b = bound(n_bytes, 3 * 2 * N * E * dim, TF32_TENSOR_FLOPS)
    b32 = bound(n_bytes, 2 * N * E * dim, FP32_FLOPS)
    log(f"  nearest_code time (N={N}, dim={dim}, E={E}): device (graph replay) kernel {graph['kernel']:.4f} ms, "
        f"library (the fp32 GEMM x @ cb.T alone, TF32 off) {graph['library']:.4f} ms "
        f"({graph['kernel'] / graph['library']:.2f}x); eager kernel {ms:.4f} ms, plain {plain:.4f} ms, library "
        f"{lib:.4f} ms; bound {b['bound_ms']:.4f} ms (3xTF32 on the tensor cores; the kernel at "
        f"{b['bound_ms'] / graph['kernel']:.1%}), fp32 SIMT bound {b32['bound_ms']:.4f} ms "
        f"({b32['bound_ms'] / graph['kernel']:.1%}); {card_line()}")
    return {"max_abs_err": excess, "ms": ms, "graph_ms": graph["kernel"], "plain_ms": plain, "library_ms": lib,
            "library_graph_ms": graph["library"], **b, "fp32_bound_ms": b32["bound_ms"]}


def build_main_path(dev):
    """(model, vqvae, cond) of the main path: the bf16 1.4B RQ-Transformer
    and RQ-VAE with random weights from seed 0, and bs100 class labels."""
    from rqvae_tpu_torch.models.rqtransformer.config import TransformerConfig
    from rqvae_tpu_torch.models.rqtransformer.model import RQTransformer
    from rqvae_tpu_torch.models.rqvae.model import RQVAE, RQVAEHParams
    from rqvae_tpu_torch.models.rqvae.modules import DDConfig

    gen = torch.Generator(device=dev).manual_seed(0)
    model = RQTransformer(TransformerConfig.create(ARCH_1P4B), device=dev, dtype=torch.bfloat16)
    model.init_weights(gen)
    vqvae = RQVAE(RQVAEHParams.create(HPARAMS), DDConfig.create(DDCONFIG), device=dev, dtype=torch.bfloat16)
    vqvae.init_weights(gen)
    return model, vqvae, torch.arange(BATCH, device=dev) % model.config.vocab_size_cond


def encode_phase(vqvae, xs, counters, card) -> int:
    """Phase 6: ROUNDS forwards of the bs100 images xs [B, 256, 256, 3] in
    [-1, 1], each with all counts set to 0 just before it and 4 nearest_code
    launches (one per depth) and no other required just after; output
    checks; ms/image; get_codes against use_kernel=False. Returns the
    nearest_code launches of one forward."""
    depth, n_embed = HPARAMS["code_shape"][2], HPARAMS["n_embed"]
    want = {fn.__name__: 0 for fn in counters} | {"nearest_code": depth}
    counts = {}

    def counted(fn):
        for c in counters:
            c.launches = 0
        out, s = wall_s(fn)
        counts.update({c.__name__: c.launches for c in counters})
        if counts != want:
            raise AssertionError(f"[encode] launched {counts}, not {want}")
        return out, s

    with torch.no_grad():
        counted(lambda: vqvae(xs))  # warm-up
        torch.cuda.reset_peak_memory_stats()
        fwd_s, code_s = [], []
        for _ in range(ROUNDS):
            (out, quant_loss, codes), s = counted(lambda: vqvae(xs))
            fwd_s.append(s)
        fwd_launches = counts["nearest_code"]
        for _ in range(ROUNDS):
            got, s = counted(lambda: vqvae.get_codes(xs))
            code_s.append(s)
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        if codes.shape != (BATCH, 8, 8, depth) or int(codes.min()) < 0 or int(codes.max()) >= n_embed:
            raise AssertionError(f"codes out of shape or range: {tuple(codes.shape)} [{int(codes.min())}, {int(codes.max())}]")
        if out.shape != xs.shape or not bool(torch.isfinite(out).all()) or not bool(torch.isfinite(quant_loss)):
            raise AssertionError(f"reconstruction {tuple(out.shape)} or quant_loss {float(quant_loss)} not finite")
        if not torch.equal(got, codes):
            raise AssertionError("get_codes and the forward gave different codes for the same images")
        log(f"  launches in each forward and get_codes (bs{BATCH}): nearest_code {depth}, every other kernel 0")
        log(f"  codes {tuple(codes.shape)} in [{int(codes.min())}, {int(codes.max())}], "
            f"{len(torch.unique(codes))} distinct; reconstruction {tuple(out.shape)} finite, "
            f"quant_loss {float(quant_loss):.4f}")
        # the forward's straight-through reconstruction against decode_code of its own codes
        compare("forward reconstruction vs decode_code(codes) ([0,1] pixels)",
                *(vqvae.get_recon_imgs(xs, r)[1] for r in (out, vqvae.decode_code(codes))), PIXEL_TOL)
        fwd_ms, code_ms = (statistics.median(t) * 1e3 / BATCH for t in (fwd_s, code_s))
        log(f"  [encode] forward: {fwd_ms:.3f} ms/image (median of {', '.join(f'{t * 1e3 / BATCH:.3f}' for t in fwd_s)}); "
            f"get_codes: {code_ms:.3f} ms/image (median of {', '.join(f'{t * 1e3 / BATCH:.3f}' for t in code_s)}); "
            f"peak memory {peak_gb:.1f} GiB; bs{BATCH}, {card}")
        vqvae.use_kernel = False
        try:
            ref = vqvae.get_codes(xs)
        finally:
            vqvae.use_kernel = True
    per_depth = [float((codes[..., d] == ref[..., d]).double().mean()) for d in range(depth)]
    log(f"  codes equal to use_kernel=False's, per depth: {', '.join(f'{a:.4f}' for a in per_depth)} "
        f"(bound >= {ENCODE_AGREE} at depth 0)")
    if per_depth[0] < ENCODE_AGREE:
        raise AssertionError("nearest_code and the plain argmin disagree at depth 0")
    return fwd_launches


def vqgan_phase(S, counters, dev, card, name) -> int:
    """Phase 7: the zoo's `name` (vqgan_huge, vqgan_large) bs100 through the
    stacked-cache sampler. ROUNDS timed sample calls, each with all counts
    set to 0 just before it and n_layer x 257 decode_attention_stacked (and
    decode_attention) launches and no other required just after; output
    checks; ms/sample; forced_logits at B=8, kernels vs plain. Returns the
    stacked launches of one call."""
    from rqvae_tpu_torch.cli import measure_throughput as MT
    from rqvae_tpu_torch.models.rqtransformer.model import RQTransformer

    t0 = time.perf_counter()
    codebook = MT.VQGAN_TRANSFORMERS[name][4]
    vqvae, tconf = MT.build(16, name, 1, codebook, device=dev, dtype=torch.bfloat16)
    model = RQTransformer(tconf, device=dev, dtype=torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(0)
    vqvae.init_weights(gen)
    model.init_weights(gen)
    torch.cuda.synchronize()
    H, W, D = tconf.block_size
    steps = tconf.body.n_layer * (tconf.block_size_cond + H * W)  # the prefill and every position
    log(f"  rq-transformer {sum(p.numel() for p in model.parameters()) / 1e6:.0f}M params ({tconf.body.n_layer} "
        f"body, {tconf.head.n_layer} head layers), rq-vae {sum(p.numel() for p in vqvae.parameters()) / 1e6:.0f}M "
        f"params, codes {H}x{W}x{D}, built and initialised in {time.perf_counter() - t0:.1f} s")
    cond = torch.arange(BATCH, device=dev) % tconf.vocab_size_cond

    def sample(seed, kernels=True):
        return S.sample(model, BATCH, torch.Generator(device=dev).manual_seed(seed), cond=cond,
                        quantizer=vqvae.quantizer, temperature=1.0, kernels=kernels)

    want = {fn.__name__: 0 for fn in counters} | {"decode_attention_stacked": steps, "decode_attention": steps}
    codes, times, warm_s = timed_samples(name, sample, counters, want)
    log(f"  [{name}] warm-up sample {warm_s:.2f} s; launches in each of {ROUNDS} timed sample(bs{BATCH}) calls: "
        f"decode_attention_stacked {steps}, decode_attention {steps} (the same launches), every other kernel 0")
    pixels, decode_s = decode_checked(vqvae, codes, (BATCH, H, W, D), tconf.vocab_size[0])
    log(f"  [{name}] codes {tuple(codes.shape)} in [{int(codes.min())}, {int(codes.max())}], "
        f"{len(torch.unique(codes))} distinct; pixels finite, mean {float((0.5 * pixels.float() + 0.5).clamp(0, 1).mean()):.4f}")
    log_times(name, times, decode_s, card)
    forced, fcond = codes[:8], cond[:8]
    got = S.forced_logits(model, forced, fcond, vqvae.quantizer, kernels=True)
    ref = S.forced_logits(model, forced, fcond, vqvae.quantizer, kernels=False)
    torch.cuda.synchronize()
    log(f"  [{name}] logits {tuple(ref.shape)}, std {float(ref.std()):.3f}")
    compare(f"[{name}] forced_logits kernels vs plain", got, ref, LOGIT_TOL, LOGIT_MEAN_TOL)
    return steps


def experiment_phase(AK, counters, dev, card) -> tuple[int, dict]:
    """Phase 8: the port of tools/exp_attn_q8cache.py at B 100 and 500, T
    64, 50 calls per chain: decode_attention (#10) against
    decode_attention_q8 (#11) in CUDA-graph-replayed chains. All counts set
    to 0 just before it; after it each of the two kernels must show the
    launches the experiment issues (its eager chains, a warm-up call, the
    chain once at capture and each of its replays, per batch) and every
    other kernel 0. Returns (#11's launches, the experiment's rows)."""
    from rqvae_tpu_torch.tools import exp_attn_q8cache as E

    batches, t, iters = [100, 500], 64, 50
    os.environ.update(EXP_T=str(t), EXP_ITERS=str(iters))
    for fn in counters:
        fn.launches = 0
    rows = E.main([str(b) for b in batches], device=dev)
    n = len(batches) * E.launches_per_batch(iters)
    want = {fn.__name__: 0 for fn in counters} | {"decode_attention": n, "decode_attention_q8": n}
    counts = {fn.__name__: fn.launches for fn in counters}
    if counts != want:
        raise AssertionError(f"[exp_attn_q8cache] launched {counts}, not {want}")
    log(f"  [exp_attn_q8cache] launches: decode_attention {n}, decode_attention_q8 {n} ({len(batches)} batches x "
        f"({E.BEST_OF} eager chains + 1 warm-up + the chain at capture + {E.BEST_OF} replays, chains of {iters})), "
        f"every other kernel 0; {card}")
    log("  [exp_attn_q8cache] the faster cache form, per batch: " + ", ".join(
        f"B {b} {'int8' if r['q8_us'] < r['bf16_us'] else 'bf16'} ({r['q8_us']:.1f} us int8, {r['bf16_us']:.1f} us "
        f"bf16)" for b, r in rows.items()))
    return n, rows


PIPE_ITERS = 30  # phase 9's chain iterations, the JAX experiment's default: the phase takes ~20 s


def q8_pipeline_phase(QP, counters, dev, card) -> dict:
    """Phase 9: the port of tools/exp_q8_pipeline.py at B 100, C 1536, H
    6144, 16 layers, the full sweeps and probes, PIPE_ITERS iterations per
    chain. All counts set to 0 just before it; after it each kernel must
    show the launches the experiment issues (per timed point: its eager
    chains, a warm-up call, the chain at capture and each replay; one call
    each of #6, #17 and #18 for the numeric checks), #6 the "shipped"
    chain's, and every other kernel 0 (the first designs' too). The points
    that print FAILED must be the ones #17 / #18's contract refuses (a chunk
    not a multiple of 64 or not dividing H): none of the sweeps'. Returns
    the launches of #17, #18, #19 and #20."""
    from rqvae_tpu_torch.tools import exp_q8_pipeline as E

    os.environ["EXP_ITERS"] = str(PIPE_ITERS)
    for name in ("EXP_SKIP_SWEEPS", "EXP_SKIP_PROBES"):
        os.environ.pop(name, None)
    H, L = 6144, 16
    predicted = [f"{kind} chunk={chunk:5d} n_buf={n_buf}"
                 for kind, chunks, depths in (("q8 ring", E.RING_CHUNKS, E.RING_NBUF),
                                              ("q8 PACKED", E.PACKED_CHUNKS, E.PACKED_NBUF))
                 for chunk in chunks for n_buf in depths if H // chunk >= n_buf and (chunk % 64 or H % chunk)]
    log(f"  predicted FAILED points (#17 / #18's contract: chunk % 64 == 0, dividing H): {predicted or 'none'}")
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    res = E.main([str(BATCH)], device=dev)
    seconds = time.perf_counter() - t0
    failed = [line.split(": FAILED")[0] for line in res["failed"]]
    if failed != predicted:
        raise AssertionError(f"[exp_q8_pipeline] FAILED points {failed}, predicted {predicted}")
    per_point = E.launches_per_point(PIPE_ITERS, L)
    ok = {}
    for kind, _, passed in res["points"]:
        ok[kind] = ok.get(kind, 0) + int(passed)
    checks = {"fused_proj_mlp_q8": 1, "fused_proj_mlp_q8_ring": 1, "fused_proj_mlp_q8_packed": 1}
    want = {fn.__name__: 0 for fn in counters} | {
        k: n * per_point + checks.get(k, 0) for k, n in ok.items()}
    counts = {fn.__name__: fn.launches for fn in counters}
    if counts != want:
        raise AssertionError(f"[exp_q8_pipeline] launched {counts}, not {want}")
    log(f"  [exp_q8_pipeline] launches: " + ", ".join(f"{k} {v}" for k, v in want.items() if v)
        + f" ({per_point} per timed point: {E.BEST_OF} eager chains + 1 warm-up + the chain at capture + "
        f"{E.BEST_OF} replays, chains of {PIPE_ITERS} x {L} calls; + 1 each of #6, #17, #18 for the numeric "
        f"checks), every other kernel 0; {len(res['points'])} points, FAILED: {failed or 'none'}; "
        f"{seconds:.1f} s; {card}")
    return {k: want[k] for k in ("fused_proj_mlp_q8_ring", "fused_proj_mlp_q8_packed", "stream_probe", "ablate_ring")}


W8A8_ITERS = 30  # phase 10's chain iterations, the JAX experiment's default
MLP_ITERS = 20  # phase 11's (the JAX experiment's default is 50): the phase takes ~20 s
MLP_MAXDIFF = 0.125  # phase 11: xla_mlp rounds each op to bf16: a few bf16 steps of an O(4) output


def w8a8_phase(counters, dev, card) -> int:
    """Phase 10: the port of tools/exp_w8a8.py at B 100, C 1536, H 6144, 16
    layers, W8A8_ITERS iterations per chain: #3 (bf16 chain), #6 (q8) and
    #16 (q8a8). All counts set to 0 just before it; after it each of the
    three must show the launches the experiment issues (its eager chains, a
    warm-up call, the chain at capture and each replay; one call each of #6
    and #16 for the error line) and every other kernel 0. The error line's
    mean |d| must lie between 0 and mean |q8|. Returns #16's launches."""
    from rqvae_tpu_torch.tools import exp_w8a8 as E

    os.environ["EXP_ITERS"] = str(W8A8_ITERS)
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    res = E.main([str(BATCH)], device=dev)
    seconds = time.perf_counter() - t0
    n = E.launches_per_chain(W8A8_ITERS, 16)
    want = {fn.__name__: 0 for fn in counters} | {
        "fused_proj_mlp": n, "fused_proj_mlp_q8": n + 1, "fused_proj_mlp_q8a8": n + 1}
    counts = {fn.__name__: fn.launches for fn in counters}
    if counts != want:
        raise AssertionError(f"[exp_w8a8] launched {counts}, not {want}")
    mean_d, max_d, mean_q8 = res["err"]
    if not 0 < mean_d < mean_q8:
        raise AssertionError(f"[exp_w8a8] q8a8 vs q8 mean |d| {mean_d} outside (0, mean |q8| {mean_q8})")
    log(f"  [exp_w8a8] bf16 and q8 chains through #3's and #6's single-launch kernel (csrc/decode_dense.cu): "
        f"{res['ms']['bf16']:.2f} and {res['ms']['q8']:.2f} ms per 16 layers (the split-K designs they replaced: 3.14 "
        f"and 3.29 ms on an NVIDIA H100 80GB HBM3, 700.00 W, PERF.md §6); q8a8 through #16's (csrc/dense_w8a8.cu): "
        f"{res['ms']['q8a8']:.2f} ms (its first design: 2.11 ms, PERF.md §6); {card}")
    log(f"  [exp_w8a8] launches: fused_proj_mlp {n}, fused_proj_mlp_q8 {n + 1}, fused_proj_mlp_q8a8 {n + 1} "
        f"({E.BEST_OF} eager chains + 1 warm-up + the chain at capture + {E.BEST_OF} replays, chains of "
        f"{W8A8_ITERS} x 16 calls; + 1 each of #6 and #16 for the error line), every other kernel 0; "
        f"{seconds:.1f} s; {card}")
    return n + 1


def mlp_phase(counters, dev, card) -> int:
    """Phase 11: the port of tools/exp_mlp_kernel.py at B 100 and 500, C
    1536, H 6144, 24 layers, MLP_ITERS iterations per chain, chunk 1536:
    the plain xla_mlp against #15. All counts set to 0 just before it;
    after it #15 must show the launches the experiment issues (per batch:
    its eager chains, a warm-up call, the chain at capture, each replay and
    the numeric check) and every other kernel 0; no FAIL, and each batch's
    maxdiff finite and within MLP_MAXDIFF. Returns #15's launches."""
    from rqvae_tpu_torch.tools import exp_mlp_kernel as E

    os.environ.update(EXP_ITERS=str(MLP_ITERS), EXP_CHUNK="1536")
    batches = [100, 500]
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    res = E.main([str(b) for b in batches], device=dev)
    seconds = time.perf_counter() - t0
    for b, row in res["rows"].items():
        if row["failed"] or not row["maxdiff"] <= MLP_MAXDIFF:
            raise AssertionError(f"[exp_mlp_kernel] B {b}: {row}")
    n = len(batches) * E.launches_per_batch(MLP_ITERS)
    want = {fn.__name__: 0 for fn in counters} | {"fused_mlp": n}
    counts = {fn.__name__: fn.launches for fn in counters}
    if counts != want:
        raise AssertionError(f"[exp_mlp_kernel] launched {counts}, not {want}")
    log(f"  [exp_mlp_kernel] launches: fused_mlp {n} ({len(batches)} batches x ({E.BEST_OF} eager chains + 1 "
        f"warm-up + the chain at capture + {E.BEST_OF} replays, chains of {MLP_ITERS} x {E.L} calls, + 1 numeric "
        f"check)), every other kernel 0; maxdiff " + ", ".join(f"B {b} {r['maxdiff']:.3e}" for b, r in
                                                               res["rows"].items())
        + f" (<= {MLP_MAXDIFF}); {seconds:.1f} s; {card}")
    return n


def stage2_step_flops(config, batch: int) -> float:
    """Model FLOPs of one stage-2 train step on `batch` samples: three times
    the forward's products (the backward does two per forward product), the
    attention's two products at the full square the plain attention
    computes; the frozen encode, the soft codes and a recompute not counted."""
    C, D, HW = config.embed_dim, config.depth, config.hw

    def stack(cfg, sequences, T):
        return cfg.n_layer * sequences * T * (2 * 12 * C * C + 2 * 2 * T * C)

    fwd = stack(config.body, batch, config.block_size_cond + HW - 1) + stack(config.head, batch * HW, D)
    fwd += 2 * batch * HW * D * C * config.vocab_size_max  # classifier
    fwd += 2 * 2 * batch * HW * D * config.input_embed_dim * C  # input_mlp, head_mlp
    return 3.0 * fwd


def build_stage2(arch, dev, gen):
    """(fp32 RQ-Transformer of `arch`, fp32 RQ-VAE of bench's geometry) on
    `dev`, random weights from `gen`."""
    from rqvae_tpu_torch.models.rqtransformer.config import TransformerConfig
    from rqvae_tpu_torch.models.rqtransformer.model import RQTransformer
    from rqvae_tpu_torch.models.rqvae.model import RQVAE, RQVAEHParams
    from rqvae_tpu_torch.models.rqvae.modules import DDConfig

    model = RQTransformer(TransformerConfig.create(arch), device=dev)
    model.init_weights(gen)
    vqvae = RQVAE(RQVAEHParams.create(HPARAMS), DDConfig.create(DDCONFIG), device=dev)
    vqvae.init_weights(gen)
    return model, vqvae


def train_schedule():
    from rqvae_tpu_torch.optim.schedule import create_schedule

    return create_schedule(base_lr=TRAIN_LR, warmup_config=TRAIN_WARMUP, steps_per_epoch=1000, max_epoch=1)


def train_vs_cpu(dev, card) -> None:
    """Phase 12 (a): one fp32 train step at full width and cut depth
    (TRAIN_CUT_ARCH, vocab 16384, TRAIN_CUT_BATCH 256x256 images as 2
    microbatches, dropout 0) on the card and on this machine's CPU, from
    the same weights. The frozen encode and soft codes run on both and are
    compared; both steps then take the card's codes and soft targets (a
    near tie of two codes may fall either way between two summation
    orders, and the steps are compared on equal inputs). Losses,
    grad_norm, each gradient and the updated weights are held to the
    TRAIN_* tolerances."""
    from rqvae_tpu_torch.trainers import trainer_stage2 as T2

    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(12)
    model_cpu, vq_cpu = build_stage2(TRAIN_CUT_ARCH, cpu, gen)
    res = DDCONFIG["resolution"]
    images = torch.rand(TRAIN_CUT_BATCH, 3, res, res, generator=gen) * 2 - 1
    cond = torch.arange(TRAIN_CUT_BATCH) * 97 % model_cpu.config.vocab_size_cond
    model_dev, vq_dev = copy.deepcopy(model_cpu).to(dev), copy.deepcopy(vq_cpu).to(dev)
    loss_cfg = T2.Stage2LossConfig(amp_bf16=False)
    sides = {}
    for name, model, vq in (("card", model_dev, vq_dev), ("cpu", model_cpu, vq_cpu)):
        d = model.pos_emb_hw.device
        t0 = time.perf_counter()
        z = T2.make_frozen_encode_fn(vq, dtype=None)(images.to(d))
        soft, codes = T2.make_soft_code_fn(vq.quantizer, loss_cfg)(z, None)
        sides[name] = dict(z=z.cpu(), soft=soft, codes=codes, model=model, vq=vq, encode_s=time.perf_counter() - t0)
    on_card, host = sides["card"], sides["cpu"]
    z_err = float((on_card["z"] - host["z"]).abs().max()) / float(host["z"].abs().max())
    agree = float((on_card["codes"].cpu() == host["codes"]).double().mean())
    soft_err = float((on_card["soft"].cpu() - host["soft"]).abs().max())
    log(f"  (a) frozen fp32 encode + soft codes, {TRAIN_CUT_BATCH} images: z_e max |card - cpu| {z_err:.2e} of "
        f"max |z_e|, codes equal on {agree:.4f}, soft targets max |card - cpu| {soft_err:.2e}")
    if z_err > 1e-4 or agree < ENCODE_AGREE:
        raise AssertionError("the card's frozen encode disagrees with the CPU's")
    for name in ("card", "cpu"):
        side = sides[name]
        d = side["model"].pos_emb_hw.device
        state = T2.init_state(side["model"], TRAIN_OPTIM, train_schedule())
        step = T2.make_train_step(loss_cfg, quantizer=side["vq"].quantizer, grad_accum_steps=TRAIN_ACCUM)
        batch = {"codes": on_card["codes"].to(d), "soft_targets": on_card["soft"].to(d), "cond": cond.to(d)}
        t0 = time.perf_counter()
        _, metrics = step(state, batch, None)
        side["metrics"] = {k: v.detach().double().cpu() for k, v in metrics.items()}
        side["step_s"] = time.perf_counter() - t0
    bad = []
    for k, want in host["metrics"].items():
        got = on_card["metrics"][k]
        rel = float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())
        log(f"  (a) {k}: card {got.tolist()}, cpu {want.tolist()}, relative {rel:.2e} (<= {TRAIN_LOSS_RTOL})")
        if rel > TRAIN_LOSS_RTOL:
            bad.append(k)
    cpu_params = dict(model_cpu.named_parameters())
    gscale = max(float(p.grad.abs().max()) for p in cpu_params.values())
    worst_p, kept, total, lr = 0.0, 0, 0, train_schedule()(0)
    rows = []  # (share of the gradient bound, name, max |card - cpu| / max |cpu|, card norm, cpu norm)
    for k, p in model_dev.named_parameters():
        ref, g = cpu_params[k], p.grad.detach().cpu()
        gmax = float(ref.grad.abs().max())
        err = float((g - ref.grad).abs().max())
        rows.append((err / (TRAIN_GRAD_TOL * gmax + 1e-6 * gscale), k, err / max(gmax, 1e-30), float(g.norm()),
                     float(ref.grad.norm())))
        d = (p.detach().cpu() - ref.detach()).abs()
        sure = ref.grad.abs() > max(1e-4 * gmax, 1e-6 * gscale)
        kept, total = kept + int(sure.sum()), total + sure.numel()
        worst_p = max(worst_p, float(d[sure].max()) if bool(sure.any()) else 0.0)
        if float(d.max()) > 2 * lr + TRAIN_PARAM_ATOL:
            bad.append(f"{k} (a weight more than two learning rates from the CPU's)")
    rows.sort(reverse=True)
    for share, k, rel, n_card, n_cpu in rows[:6]:
        log(f"  (a) gradient {k}: max |card - cpu| {rel:.2e} of its max, {share:.3f} of its bound; norm card "
            f"{n_card:.6e}, cpu {n_cpu:.6e}")
    worst_g = rows[0][0]
    log(f"  (a) gradients: max |card - cpu| at {worst_g:.3f} of its bound ({TRAIN_GRAD_TOL} of each tensor's max + "
        f"1e-6 of the largest); updated weights: max |card - cpu| {worst_p:.2e} (<= {TRAIN_PARAM_ATOL}) on the "
        f"{kept / total:.4f} of entries whose gradient is above 1e-4 of its tensor's max and 1e-6 of the largest, "
        f"within 2 lr elsewhere; card step {on_card['step_s']:.2f} s (first call), cpu step {host['step_s']:.2f} s; {card}")
    if bad or worst_g > 1.0 or worst_p > TRAIN_PARAM_ATOL:
        raise AssertionError(f"(a) the card's step disagrees with the CPU's: {bad}, gradients at {worst_g:.3f} of "
                             f"their bound, weights {worst_p:.2e}")


def train_phase(counters, dev, card) -> None:
    """Phase 12: the stage-2 trainer. (a) train_vs_cpu; (b) bench's 1.4B
    (ARCH_1P4B, resid_pdrop 0.1, amp bf16) with a frozen bf16 copy of
    bench's RQ-VAE encoder (chunks of ENCODE_CHUNK images) and soft targets
    at temp 1: TRAIN_STEPS steps of TRAIN_BATCH images (TRAIN_ACCUM
    microbatches) on one fixed batch of 256x256 images, every kernel count 0
    over them, finite losses and grad_norm, loss_total falling from the
    first step to the last, the EMA moved, one eval step (on the EMA);
    ms/step (median of steps 2-5), peak memory, tokens/s and the share of
    the bf16 dense peak; (c) the last step again from the same weights and
    dropout seed with remat=True: losses within REMAT_LOSS_TOL of the plain
    step's, and its peak memory."""
    import dataclasses

    from rqvae_tpu_torch.trainers import trainer_stage2 as T2

    log(f"  matmul: allow_tf32={torch.backends.cuda.matmul.allow_tf32}, allow_bf16_reduced_precision_reduction="
        f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}")
    train_vs_cpu(dev, card)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    model, vqvae = build_stage2(ARCH_1P4B, dev, gen)
    config = model.config
    state = T2.init_state(model, TRAIN_OPTIM, train_schedule(), use_ema=True)
    loss_cfg = T2.Stage2LossConfig()
    encode = T2.make_frozen_encode_fn(vqvae, chunk=ENCODE_CHUNK)
    kw = dict(encode_fn=encode, quantizer=vqvae.quantizer)
    step = T2.make_train_step(loss_cfg, grad_accum_steps=TRAIN_ACCUM, **kw)
    res = DDCONFIG["resolution"]
    batch = {"images": torch.rand(TRAIN_BATCH, 3, res, res, generator=gen, device=dev) * 2 - 1,
             "cond": torch.arange(TRAIN_BATCH, device=dev) * 31 % config.vocab_size_cond}
    ema_before = state.ema["classifier.linear.weight"].clone()
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    log(f"  (b) rq-transformer {n_params / 1e6:.0f}M fp32 parameters with AdamW moments and EMA, rq-vae "
        f"{sum(p.numel() for p in vqvae.parameters()) / 1e6:.0f}M (encoder in bf16), built in "
        f"{time.perf_counter() - t0:.1f} s; {torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")

    def run(step_fn, n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, m = step_fn(state, batch, torch.Generator(device=dev).manual_seed(100 + n))
        m = {k: v.detach().double().cpu() for k, v in m.items()}
        return m, time.perf_counter() - t

    for fn in counters:
        fn.launches = 0
    metrics, times = [], []
    for n in range(TRAIN_STEPS):
        if n == 1:
            torch.cuda.reset_peak_memory_stats()
        if n == TRAIN_STEPS - 1:
            weights = {k: p.detach().to("cpu", copy=True) for k, p in model.named_parameters()}
        m, s = run(step, n)
        metrics.append(m)
        times.append(s)
        log(f"  (b) step {n + 1}: loss_total {float(m['loss_total']):.4f}, loss_img {float(m['loss_img']):.4f}, "
            f"grad_norm {float(m['grad_norm']):.4f}, codebook_loss {[round(x, 4) for x in m['codebook_loss'].tolist()]}, "
            f"{s * 1e3:.1f} ms")
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts = {fn.__name__: fn.launches for fn in counters}
    if any(counts.values()):
        raise AssertionError(f"(b) the train steps launched kernels: {counts}")
    if not all(bool(torch.isfinite(v).all()) for m in metrics for v in m.values()):
        raise AssertionError("(b) a loss or grad_norm is not finite")
    if not float(metrics[-1]["loss_total"]) < float(metrics[0]["loss_total"]):
        raise AssertionError("(b) loss_total did not fall from the first step to the last")
    ema_moved = float((state.ema["classifier.linear.weight"] - ema_before).abs().max())
    if not ema_moved > 0:
        raise AssertionError("(b) the EMA did not move")
    ev = T2.make_eval_step(loss_cfg, **kw)(state, {k: v[: TRAIN_BATCH // TRAIN_ACCUM] for k, v in batch.items()})
    if not all(bool(torch.isfinite(v).all()) for v in ev.values()):
        raise AssertionError("(b) the eval step's losses are not finite")
    ms = statistics.median(times[1:]) * 1e3
    tokens = TRAIN_BATCH * config.hw * config.depth
    flops = stage2_step_flops(config, TRAIN_BATCH)
    log(f"  (b) {TRAIN_STEPS} steps, no kernel launched; loss_total {float(metrics[0]['loss_total']):.4f} -> "
        f"{float(metrics[-1]['loss_total']):.4f}; EMA moved by up to {ema_moved:.2e}; eval (EMA, "
        f"{TRAIN_BATCH // TRAIN_ACCUM} images): loss_total {float(ev['loss_total']):.4f}")
    log(f"  [train 1.4B] {ms:.1f} ms/step (median of steps 2-{TRAIN_STEPS}: "
        f"{', '.join(f'{t * 1e3:.1f}' for t in times[1:])}; first step {times[0] * 1e3:.1f}), B {TRAIN_BATCH} as "
        f"{TRAIN_ACCUM} x {TRAIN_BATCH // TRAIN_ACCUM}, {tokens / (ms / 1e3):.0f} tokens/s ({tokens} codes a step), "
        f"{flops / 1e12:.2f} model TFLOP a step, {flops / (ms / 1e3) / 1e12:.1f} TFLOP/s = "
        f"{flops / (ms / 1e3) / BF16_TENSOR_FLOPS:.1%} of the bf16 dense peak; peak memory {peak:.1f} GiB; {card}")

    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(weights[k])
    del weights
    T2.refresh_derived_buffers(model)
    torch.cuda.reset_peak_memory_stats()
    remat_step = T2.make_train_step(dataclasses.replace(loss_cfg, remat=True), grad_accum_steps=TRAIN_ACCUM, **kw)
    m, s = run(remat_step, TRAIN_STEPS - 1)
    remat_peak = torch.cuda.max_memory_allocated() / 2**30
    diffs = {k: float((m[k] - metrics[-1][k]).abs().max()) for k in ("loss_total", "loss_img", "codebook_loss")}
    log(f"  (c) remat step {TRAIN_STEPS} again from the same weights and seed: loss_total "
        f"{float(m['loss_total']):.4f} (plain {float(metrics[-1]['loss_total']):.4f}), max |remat - plain| "
        + ", ".join(f"{k} {v:.2e}" for k, v in diffs.items()) + f" (<= {REMAT_LOSS_TOL}); grad_norm "
        f"{float(m['grad_norm']):.4f} (plain {float(metrics[-1]['grad_norm']):.4f}); {s * 1e3:.1f} ms; peak memory "
        f"{remat_peak:.1f} GiB (plain {peak:.1f} GiB); {card}")
    if max(diffs.values()) > REMAT_LOSS_TOL:
        raise AssertionError("(c) the remat step's losses differ from the plain step's")


def build_stage1(dd, hp, dev, gen, use_kernel=True):
    """(RQ-VAE, NLayerDiscriminator(S1_DISC), LPIPS) on `dev` with random
    weights from `gen` (the LPIPS weights synthetic: the VGG16 and linear
    weights are not in the repository)."""
    from rqvae_tpu_torch.losses.discriminator import NLayerDiscriminator
    from rqvae_tpu_torch.losses.lpips import LPIPS
    from rqvae_tpu_torch.models.rqvae.model import RQVAE, RQVAEHParams
    from rqvae_tpu_torch.models.rqvae.modules import DDConfig

    model = RQVAE(RQVAEHParams.create(hp), DDConfig.create(dd), device=dev, use_kernel=use_kernel)
    model.init_weights(gen)
    disc = NLayerDiscriminator(**S1_DISC, device=dev)
    disc.init_weights(gen)
    lpips = LPIPS(device=dev)
    lpips.init_weights(gen)
    return model, disc, lpips


def host_copy(obj):
    """A copy of obj on the host: its tensors copied to the CPU, through
    dicts, lists and tuples (a state_dict, an optimizer's)."""
    if isinstance(obj, torch.Tensor):
        return obj.to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: host_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(host_copy(v) for v in obj)
    return copy.deepcopy(obj)


def stage1_schedule():
    from rqvae_tpu_torch.optim.schedule import create_schedule

    return create_schedule(base_lr=S1_LR, warmup_config=S1_WARMUP, steps_per_epoch=10, max_epoch=10)


def seeded_draw(seed: int):
    """A restart draw that takes its noise and permutation from a CPU
    generator seeded `seed`, so that the card and the CPU draw the same."""
    from rqvae_tpu_torch.ops import quantize as Q

    gen = torch.Generator().manual_seed(seed)

    def draw(d, vectors, n_embed):
        n, dim = vectors.shape
        uniform = None
        if n < n_embed:
            uniform = torch.rand(-(-n_embed // n) * n, dim, generator=gen).to(vectors.device)
        perm = torch.randperm(n if uniform is None else uniform.shape[0], generator=gen).to(vectors.device)
        return Q.restart_candidates(vectors, n_embed, perm, uniform)

    return draw


def disc_branches(disc, replay=None):
    """Forward hooks on the discriminator's LeakyReLUs. Without `replay`
    each call records its branch (input > 0, on the host) in `branches`;
    with `replay` (a list recorded so) each call takes the recorded branch
    in order instead of its own and adds to `flips` the entries whose own
    sign differs. Returns (branches, flips, handles)."""
    branches, flips, handles = [], [], []
    queue = iter(replay or ())

    def hook(mod, inputs, out):
        x = inputs[0]
        if replay is None:
            branches.append((x > 0).cpu())
            return None
        mask = next(queue).to(x.device)
        flips.append(int(((x > 0) != mask).sum()))
        return x * torch.where(mask, 1.0, mod.negative_slope).to(x.dtype)

    for m in disc.main:
        if isinstance(m, torch.nn.LeakyReLU):
            handles.append(m.register_forward_hook(hook))
    return branches, flips, handles


def stage1_side(parts, images, dev, replay=None) -> dict:
    """S1_CUT_STEPS fp32 stage-1 steps with the discriminator (fp32 LPIPS)
    on copies of `parts` on `dev`, restart draws seeded_draw(100 + step):
    each step's metrics, codes and gradients (RQ-VAE and discriminator),
    the state_dicts after the last step, and the discriminator's branches
    (recorded, or replayed from `replay` with the count of flips)."""
    from rqvae_tpu_torch.trainers import trainer_stage1 as T1

    model, disc, lpips = (copy.deepcopy(p).to(dev) for p in parts)
    branches, flips, handles = disc_branches(disc, replay)
    state = T1.init_state(model, disc, S1_OPTIM, stage1_schedule(), S1_OPTIM, stage1_schedule())
    step = T1.make_train_step(lpips, T1.GanLossConfig(lpips_bf16=False), use_discriminator=True)
    out = dict(metrics=[], codes=[], grads=[])
    t0 = time.perf_counter()
    for n in range(S1_CUT_STEPS):
        _, m, codes = step(state, {"images": images.to(dev)}, None, draw=seeded_draw(100 + n))
        out["metrics"].append({k: v.detach().double().cpu() for k, v in m.items()})
        out["codes"].append(codes.cpu())
        out["grads"].append({f"{name}.{k}": p.grad.detach().cpu()
                             for name, mod in (("vq", model), ("disc", disc)) for k, p in mod.named_parameters()})
    out["s"] = time.perf_counter() - t0
    for h in handles:
        h.remove()
    out["state"] = {f"{name}.{k}": v.cpu() for name, mod in (("vq", model), ("disc", disc))
                    for k, v in mod.state_dict().items()}
    out["branches"], out["flips"] = branches, sum(flips)
    return out


def stage1_shares(got: dict, ref: dict) -> dict:
    """Each of (a)'s comparisons of `got` against `ref` as a share of its
    bound (above 1 fails): losses, g_weight, codes (the least agreement of
    a depth against ENCODE_AGREE, above 1 when lower), gradients of every
    step, the weights after the last step where a gradient is sure (and
    `far`: the largest weight difference in learning rates of the last
    step), the codebook buffers and the discriminator's running stats."""
    sh = dict(losses=0.0, g_weight=0.0, codes=0.0, gradients=0.0)
    for n, want in enumerate(ref["metrics"]):
        for k, w in want.items():
            tol = S1_G_WEIGHT_RTOL if k == "g_weight" else S1_LOSS_RTOL
            rel = float((got["metrics"][n][k] - w).abs() / (w.abs() + 1e-6))
            key = "g_weight" if k == "g_weight" else "losses"
            sh[key] = max(sh[key], rel / tol)
        for d in range(ref["codes"][n].shape[-1]):
            agree = float((got["codes"][n][..., d] == ref["codes"][n][..., d]).double().mean())
            sh["codes"] = max(sh["codes"], (1.0 - agree) / (1.0 - ENCODE_AGREE))
        gscale = max(float(g.abs().max()) for g in ref["grads"][n].values())
        for k, g in ref["grads"][n].items():
            err = float((got["grads"][n][k] - g).abs().max())
            sh["gradients"] = max(sh["gradients"], err / (S1_GRAD_TOL * float(g.abs().max()) + 1e-5 * gscale))
    lr = stage1_schedule()(S1_CUT_STEPS - 1)
    sh["weights"], sh["far"] = 0.0, 0.0
    for k, g in ref["grads"][-1].items():
        d = (got["state"][k] - ref["state"][k]).abs()
        sure = torch.zeros_like(d, dtype=torch.bool)
        for grads in ref["grads"]:
            gs = max(float(v.abs().max()) for v in grads.values())
            sure |= grads[k].abs() > max(1e-2 * float(grads[k].abs().max()), 1e-5 * gs)
        if bool(sure.any()):
            sh["weights"] = max(sh["weights"], float(d[sure].max()) / (S1_PARAM_RTOL * lr))
        sh["far"] = max(sh["far"], float(d.max()) / lr)
    books = [k for k in ref["state"] if k.startswith("vq.quantizer.") or "running_" in k]
    sh["codebooks"] = max(float((got["state"][k] - ref["state"][k]).abs().max())
                          / max(float(ref["state"][k].abs().max()), 1e-30) for k in books) / S1_CODEBOOK_TOL
    return sh


def stage1_vs_cpu(dev, card) -> list[str]:
    """Phase 13 (a): stage1_side at the synthetic stage-1 geometry, B
    S1_CUT_BATCH, for each of S1_CUT_SEEDS (weights, images): on the card,
    then on this machine's CPU taking the card's discriminator branches
    (a LeakyReLU input within rounding of 0 takes either branch, a
    discrete change like a code's, which the check would otherwise read
    as error), held to the S1_* bounds (stage1_shares); the witness is
    the CPU's second fp32 path (oneDNN off: other conv algorithms) on the
    same branches against the first, the readings a correct fp32 step
    gives; the control is the first seed's card step with cuDNN's convs
    in TF32, against the CPU on its branches, which must break a bound.
    use_kernel=False everywhere. Returns what disagreed (stage1_phase
    fails on it after (b) and (c))."""
    cpu = torch.device("cpu")
    bad = []
    keys = ("losses", "g_weight", "codes", "gradients", "weights", "codebooks")
    for i, seed in enumerate(S1_CUT_SEEDS):
        gen = torch.Generator().manual_seed(seed)
        parts = build_stage1(S1_CUT_DD, S1_CUT_HP, cpu, gen, use_kernel=False)
        res = S1_CUT_DD["resolution"]
        images = torch.rand(S1_CUT_BATCH, res, res, 3, generator=gen) * 2 - 1
        on_card = stage1_side(parts, images, dev)
        host = stage1_side(parts, images, cpu, replay=on_card["branches"])
        with torch.backends.mkldnn.flags(enabled=False):
            witness = stage1_side(parts, images, cpu, replay=on_card["branches"])
        got, wit = stage1_shares(on_card, host), stage1_shares(witness, host)
        g_card = [f"{float(m['g_weight']):.6f}" for m in on_card["metrics"]]
        log(f"  (a) seed {seed}: share of the bound card / witness: "
            + ", ".join(f"{k} {got[k]:.3f} / {wit[k]:.3f}" for k in keys)
            + f"; weights at most {got['far']:.2f} / {wit['far']:.2f} lr from the CPU's; discriminator branches "
            f"the CPU's own sign would flip {host['flips']} of {sum(int(b.numel()) for b in on_card['branches'])} "
            f"(witness {witness['flips']}); g_weight card {', '.join(g_card)}; card {on_card['s']:.2f} s, cpu "
            f"{host['s']:.2f} s, witness {witness['s']:.2f} s")
        bad += [f"seed {seed} {k} at {got[k]:.3f} of its bound" for k in keys if got[k] > 1.0]
        if got["far"] > 2.0 + S1_PARAM_RTOL:
            bad.append(f"seed {seed} a weight {got['far']:.2f} learning rates from the CPU's")
        if i == 0:
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
                control = stage1_side(parts, images, dev)
            ctl = stage1_shares(control, stage1_side(parts, images, cpu, replay=control["branches"]))
            log(f"  (a) control, seed {seed} with the card's convs in TF32: share of the bound "
                + ", ".join(f"{k} {ctl[k]:.3f}" for k in keys))
            if max(ctl[k] for k in ("losses", "g_weight", "gradients")) <= 1.0:
                bad.append("the TF32 control broke no bound: the bounds cannot tell TF32 from fp32")
    log(f"  (a) bounds: losses {S1_LOSS_RTOL} relative (+ 1e-6), g_weight {S1_G_WEIGHT_RTOL}, codes >= {ENCODE_AGREE} "
        f"at each depth, every step's gradients {S1_GRAD_TOL} of each tensor's max + 1e-5 of the largest, weights "
        f"after step {S1_CUT_STEPS} to {S1_PARAM_RTOL} of its lr ({stage1_schedule()(S1_CUT_STEPS - 1):.1e}) where a "
        f"step's gradient is above 1e-2 of its tensor's max and 1e-5 of the largest and within 2 lr elsewhere, "
        f"codebook buffers and running stats {S1_CODEBOOK_TOL} of their max; {card}")
    return [f"(a) {b}" for b in bad]


def stage1_flops(model, disc, lpips, batch: int) -> tuple[float, float]:
    """(fp32, bf16) model FLOPs of one stage-1 step at `batch` images,
    counted from the shapes (torch.utils.flop_counter on the meta device,
    convs and products): 3 x the RQ-VAE's forward (with its tail); the
    discriminator's forward 3 x in the generator's pass (the forward and
    the input gradients of g_weight's and the total's backward) and 3 x on
    each of the fake and real batches in its step; LPIPS (bf16) forward on
    both images and twice the input gradient of the reconstruction's branch.
    A recompute (checkpointing) is not counted."""
    from torch.utils.flop_counter import FlopCounterMode

    res = model.ddconfig.resolution
    meta = [copy.deepcopy(m).to("meta") for m in (model, disc, lpips)]
    x = torch.empty(batch, res, res, 3, device="meta")
    counts = []
    for fn in (lambda: meta[0].decoder.tail(meta[0].decoder(meta[0].post_quant_conv(
                   meta[0].encode(x).permute(0, 3, 1, 2)), give_pre_end=True)),
               lambda: meta[1](x.permute(0, 3, 1, 2), train=True, update_stats=False),
               lambda: meta[2].net(x.permute(0, 3, 1, 2))):
        with FlopCounterMode(display=False) as fc:
            with torch.no_grad():
                fn()
        counts.append(fc.get_total_flops())
    vq, d, lp = counts
    return 3 * vq + 3 * d + 2 * 3 * d, 4 * lp


def saved_activation_gib(model, disc, lpips, batch: int, checkpointing: bool) -> float:
    """GiB of activations the generator's pass keeps for its backward at
    `batch` images (each saved tensor once, on the meta device): the
    RQ-VAE's forward with its tail, LPIPS (bf16) on both images, the
    discriminator on the reconstruction."""
    from rqvae_tpu_torch.models.rqvae.modules import set_checkpointing

    res = model.ddconfig.resolution
    vq, dc, lp = (copy.deepcopy(m).to("meta") for m in (model, disc, lpips))
    set_checkpointing(vq, checkpointing)
    saved = {}

    def pack(t):
        if t.dim() >= 3 and t.shape[0] == batch:
            saved[id(t)] = (t, t.numel() * t.element_size())  # the tensor itself keeps its id unique
        return t

    x = torch.empty(batch, res, res, 3, device="meta")
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = vq.decoder.tail(vq.decoder(vq.post_quant_conv(vq.encode(x).permute(0, 3, 1, 2)), give_pre_end=True))
        lp(x.permute(0, 3, 1, 2), out, dtype=torch.bfloat16)
        dc(out, train=True, update_stats=False)
    return sum(n for _, n in saved.values()) / 2**30


def stage1_checkpointing(model, disc, lpips, dev) -> bool:
    """Turn the RQ-VAE's checkpointing on when the activations a B S1_BATCH
    step keeps (saved_activation_gib), its weights, gradients, moments, EMA
    and a copy (6 x the parameters) and 8 GiB for the backward's
    transients exceed the card's memory; returns whether it did."""
    from rqvae_tpu_torch.models.rqvae.modules import set_checkpointing

    total_gib = torch.cuda.get_device_properties(dev).total_memory / 2**30
    state_gib = 6 * sum(p.numel() for p in model.parameters()) * 4 / 2**30
    plain_gib = saved_activation_gib(model, disc, lpips, S1_BATCH, False)
    remat_gib = saved_activation_gib(model, disc, lpips, S1_BATCH, True)
    checkpointing = plain_gib + state_gib + 8.0 > total_gib
    log(f"  saved activations of a B {S1_BATCH} stage-1 step (meta device): {plain_gib:.1f} GiB plain, {remat_gib:.1f} "
        f"GiB with checkpointing; weights, gradients, moments, EMA and a copy {state_gib:.1f} GiB; the card "
        f"{total_gib:.1f} GiB: checkpointing={checkpointing}")
    set_checkpointing(model, checkpointing)
    return checkpointing


def stage1_phase(counters, dev, card) -> int:
    """Phase 13: the stage-1 trainer. (a) stage1_vs_cpu; (b) the 8x8x4
    RQ-VAE at full width (DDCONFIG / HPARAMS), NLayerDiscriminator(ndf 64,
    3 layers), LPIPS on synthetic weights in bf16, Adam (0.5, 0.9) with
    the fix schedule for both, use_discriminator, fp32: S1_STEPS steps of
    S1_BATCH random 256x256 images from a seed, each count set to 0 before
    them, then one eval step; nearest_code launched 4 x S1_STEPS + 4 times
    and no other kernel; finite losses and g_weight; the codebook moved;
    ms/step (median of steps 2-5), images/s, peak memory, model TFLOP a
    step and its share of the peaks; checkpointing as stage1_checkpointing
    decides; (c) the last step again from the
    same state and draws with use_kernel=False: depth-0 codes on >=
    ENCODE_AGREE of positions and each metric within S1_PLAIN_RTOL; at
    each depth of the last step, #9's picks against the plain argmin's on
    the inputs #9 saw, each differing row within NEAREST_TIE_TOL of the
    fp64 minimum (nearest_vs_fp64); #9's
    device us per launch in a step (torch.profiler). Returns the
    nearest_code launches of (b) and its eval step."""
    from rqvae_tpu_torch.trainers import trainer_stage1 as T1

    log(f"  matmul: allow_tf32={torch.backends.cuda.matmul.allow_tf32}, cudnn allow_tf32="
        f"{torch.backends.cudnn.allow_tf32}")
    failed = stage1_vs_cpu(dev, card)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    model, disc, lpips = build_stage1(DDCONFIG, HPARAMS, dev, gen)
    checkpointing = stage1_checkpointing(model, disc, lpips, dev)
    fp32_flops, bf16_flops = stage1_flops(model, disc, lpips, S1_BATCH)
    state = T1.init_state(model, disc, S1_OPTIM, stage1_schedule(), S1_OPTIM, stage1_schedule(), use_ema=True)
    gan = T1.GanLossConfig()
    step = T1.make_train_step(lpips, gan, use_discriminator=True)
    res = DDCONFIG["resolution"]
    batch = {"images": torch.rand(S1_BATCH, res, res, 3, generator=gen, device=dev) * 2 - 1}
    book = model.quantizer.codebook(0).clone()
    torch.cuda.synchronize()
    log(f"  (b) rq-vae {sum(p.numel() for p in model.parameters()) / 1e6:.1f}M fp32 parameters, discriminator "
        f"{sum(p.numel() for p in disc.parameters()) / 1e6:.2f}M, LPIPS {sum(p.numel() for p in lpips.parameters()) / 1e6:.1f}M "
        f"(synthetic); built in {time.perf_counter() - t0:.1f} s; {torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")

    def run(n, use_kernel=True):
        model.use_kernel = use_kernel
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, m, codes = step(state, batch, torch.Generator(device=dev).manual_seed(200 + n))
        m = {k: v.detach().double().cpu() for k, v in m.items()}
        torch.cuda.synchronize()
        model.use_kernel = True
        return m, codes, time.perf_counter() - t

    from rqvae_tpu_torch.ops import quantize as Q
    from rqvae_tpu_torch.ops import rq_kernel as RK

    find_nearest = Q.find_nearest
    picks = []  # (x, codebook, #9's codes) of each depth of the last step

    def keep_picks(x, codebook, use_kernel=True):
        got = find_nearest(x, codebook, use_kernel=use_kernel)
        picks.append((x.detach().reshape(-1, x.shape[-1]).clone(), codebook.detach().clone(), got.reshape(-1).clone()))
        return got

    for fn in counters:
        fn.launches = 0
    metrics, times = [], []
    for n in range(S1_STEPS):
        if n == 1:
            torch.cuda.reset_peak_memory_stats()
        if n == S1_STEPS - 1:
            saved = host_copy({"model": model.state_dict(), "disc": disc.state_dict(),
                               "opt": state.optimizer.state_dict(), "disc_opt": state.disc_optimizer.state_dict(),
                               "ema": state.ema, "steps": (state.step, state.disc_step)})
            with mock.patch.object(Q, "find_nearest", keep_picks):
                m, codes, s = run(n)
        else:
            m, codes, s = run(n)
        metrics.append(m)
        times.append(s)
        log(f"  (b) step {n + 1}: " + ", ".join(f"{k} {float(v):.4f}" for k, v in m.items()) + f"; {s * 1e3:.1f} ms")
    peak = torch.cuda.max_memory_allocated() / 2**30
    ev, ev_codes = T1.make_eval_step(lpips, gan, use_discriminator=True, use_ema=True)(state, batch)
    counts = {fn.__name__: fn.launches for fn in counters}
    want = {fn.__name__: 0 for fn in counters} | {"nearest_code": 4 * S1_STEPS + 4}
    if counts != want:
        raise AssertionError(f"(b) the stage-1 steps and the eval step launched {counts}, not {want}")
    if not all(bool(torch.isfinite(v).all()) for m in metrics for v in m.values()):
        raise AssertionError("(b) a loss or g_weight is not finite")
    if not all(bool(torch.isfinite(v).all()) for v in ev.values()):
        raise AssertionError("(b) the eval step's losses are not finite")
    moved = float((model.quantizer.codebook(0) - book).abs().max())
    if not moved > 0:
        raise AssertionError("(b) the codebook did not move")
    ms = statistics.median(times[1:]) * 1e3
    floor_ms = (fp32_flops / FP32_FLOPS + bf16_flops / BF16_TENSOR_FLOPS) * 1e3
    log(f"  (b) {S1_STEPS} steps and an eval step (EMA): nearest_code {counts['nearest_code']} launches "
        f"(4 a step), every other kernel 0; codes {tuple(codes.shape)} in [{int(codes.min())}, {int(codes.max())}], "
        f"{len(torch.unique(codes[..., 0]))} distinct at depth 0; the codebook moved by up to {moved:.3e}; eval "
        f"loss_total {float(ev['loss_total']):.4f}")
    log(f"  [train stage 1] {ms:.1f} ms/step (median of steps 2-{S1_STEPS}: {', '.join(f'{t * 1e3:.1f}' for t in times[1:])}; "
        f"first step {times[0] * 1e3:.1f}), B {S1_BATCH}, {S1_BATCH / (ms / 1e3):.1f} images/s, checkpointing="
        f"{checkpointing}, peak memory {peak:.1f} GiB; model {fp32_flops / 1e12:.2f} TFLOP fp32 (convs with TF32 off, "
        f"on the fp32 SIMT peak {FP32_FLOPS / 1e12:.0f} TFLOP/s) + {bf16_flops / 1e12:.2f} TFLOP bf16 (LPIPS, dense peak "
        f"{BF16_TENSOR_FLOPS / 1e12:.0f}) a step: {fp32_flops / (ms / 1e3) / 1e12:.1f} + {bf16_flops / (ms / 1e3) / 1e12:.1f} "
        f"TFLOP/s; the least time at those peaks {floor_ms:.1f} ms = {floor_ms / ms:.1%} of the step; {card}")

    # (c): the last step again, through the plain argmin
    model.load_state_dict(saved["model"])
    disc.load_state_dict(saved["disc"])
    state.optimizer.load_state_dict(saved["opt"])
    state.disc_optimizer.load_state_dict(saved["disc_opt"])
    for k, v in saved["ema"].items():
        state.ema[k].copy_(v)
    state.step, state.disc_step = saved["steps"]
    del saved
    m_plain, plain_codes, s_plain = run(S1_STEPS - 1, use_kernel=False)
    agree = [float((plain_codes[..., d] == codes[..., d]).double().mean()) for d in range(codes.shape[-1])]
    rel = {k: float((m_plain[k] - v).abs() / (v.abs() + 1e-5 / S1_PLAIN_RTOL)) for k, v in metrics[-1].items()}
    log(f"  (c) step {S1_STEPS} again with use_kernel=False: codes equal to #9's per depth "
        f"{', '.join(f'{a:.4f}' for a in agree)} (>= {ENCODE_AGREE} at depth 0); relative |plain - kernel| "
        + ", ".join(f"{k} {r:.1e}" for k, r in rel.items()) + f" (<= {S1_PLAIN_RTOL}); {s_plain * 1e3:.1f} ms")
    if agree[0] < ENCODE_AGREE or max(rel.values()) > S1_PLAIN_RTOL:
        failed.append("(c) the plain argmin's step disagrees with #9's")
    if len(picks) != 4:
        raise AssertionError(f"(c) step {S1_STEPS} looked up codes {len(picks)} times, not 4")
    for d, (x, cb, got) in enumerate(picks):
        want = RK.nearest_code_plain(x, cb)
        same, excess, share = nearest_vs_fp64(x, cb, got, want)
        _, plain_excess, plain_share = nearest_vs_fp64(x, cb, want, want)
        log(f"  (c) depth {d} of step {S1_STEPS}, on #9's own inputs: {int((got != want).sum())} of {got.numel()} rows "
            f"pick another code than the plain argmin ({same:.4f} equal); #9's pick over the fp64 minimum: max "
            f"{excess:.3e}, {share:.3e} of the bound (plain argmin's: {plain_excess:.3e}, {plain_share:.3e}); bound "
            f"{NEAREST_TIE_TOL} (||x||^2 + ||c_pick||^2)")
        if share > 1.0:
            failed.append(f"(c) depth {d}: a pick of #9 beyond rounding of the minimum")
    del picks

    qcfg = model.quantizer.config
    rows = S1_BATCH * qcfg.code_shape[0] * qcfg.code_shape[1]
    x = torch.randn(rows, qcfg.embed_dim, generator=gen, device=dev)
    cb = model.quantizer.codebook(0)
    launch_us = graph_ms([lambda: RK.nearest_code(x, cb)]) * 1e3
    events = device_events(lambda: step(state, batch, torch.Generator(device=dev).manual_seed(300)))
    if events is None:
        raise AssertionError("(c) every profile of a step lost a marker kernel")
    ran = [sum(f"::{k}(" in name for name, _ in events) for k in NEAREST_KERNELS]
    if ran != [4, 4, 4]:
        raise AssertionError(f"(c) a profiled step ran nearest_code's kernels {NEAREST_KERNELS} {ran} times, not 4 each")
    log(f"  (c) a profiled step ran each of nearest_code's kernels {NEAREST_KERNELS} 4 times; nearest_code at N "
        f"{rows} rows x {qcfg.n_embed[0]} codes, dim {qcfg.embed_dim}: {launch_us:.1f} device us per launch (graph "
        f"replay; split, main, reduce), 4 launches {4 * launch_us / (ms * 1e3):.2%} of the step's {ms:.1f} ms; {card}")
    if failed:
        raise AssertionError(f"phase 13: {failed}")
    return counts["nearest_code"]


def main() -> None:
    mode = sys.argv[1] if len(sys.argv) == 2 else None
    if sys.argv[1:] and mode not in ("dense", "fused", "attention", "mlp", "q8", "nearest", "train", "stage1"):
        raise SystemExit(f"chip_smoke: unknown arguments {sys.argv[1:]}; the only ones are 'dense', 'fused', "
                         f"'attention', 'mlp', 'q8', 'nearest', 'train' and 'stage1'")
    # phase 1: device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this check needs a CUDA device")
    card = card_line()
    log(card)
    dev = torch.device("cuda", 0)
    log(f"# torch {torch.__version__}, CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"  TF32: torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, "
        f"torch.backends.cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    sys.path.insert(0, ROOT)
    from rqvae_tpu_torch.models.rqtransformer import sampling as S
    from rqvae_tpu_torch.models.rqtransformer.model import quantize_weight
    from rqvae_tpu_torch.ops import _build
    from rqvae_tpu_torch.ops import attention_kernel as AK
    from rqvae_tpu_torch.ops import decode_layer_kernel as DK
    from rqvae_tpu_torch.ops import decode_megakernel as MK
    from rqvae_tpu_torch.ops import dense_mlp_kernel as DM
    from rqvae_tpu_torch.ops import mlp_kernel as MLP
    from rqvae_tpu_torch.ops import q8_pipeline_kernel as QP
    from rqvae_tpu_torch.ops import rq_kernel as RK
    from rqvae_tpu_torch.ops import w8a8_kernel as W8

    # every kernel wrapper's launch count, in the order of phase 4's tables
    counters = (AK.decode_attention_update, DK.fused_ln_qkv, DK.fused_proj_mlp,
                AK.decode_attention_q8_update, DK.fused_ln_qkv_q8, DK.fused_proj_mlp_q8, RK.nearest_code,
                MK.decode_layer_step, AK.decode_attention_q8_update_wo, AK.decode_attention,
                AK.decode_attention_stacked, AK.decode_attention_q8, QP.fused_proj_mlp_q8_ring,
                QP.fused_proj_mlp_q8_packed, QP.stream_probe, QP.ablate_ring, W8.fused_proj_mlp_q8a8, MLP.fused_mlp,
                MK.decode_layer_step_coop, AK.decode_attention_q8_update_wo_coop, AK.decode_attention_update_v1,
                AK.decode_attention_q8_update_v1, AK.decode_attention_v1, AK.decode_attention_q8_v1,
                MLP.fused_mlp_v1, QP.ablate_ring_v1, QP.fused_proj_mlp_q8_ring_v1, QP.fused_proj_mlp_q8_packed_v1,
                W8.fused_proj_mlp_q8a8_v1)
    if mode == "train":
        log(f"# phase 12: the stage-2 trainer (no kernel on its path, so no build), on {card}")
        train_phase(counters, dev, card)
        return

    # phase 2: build
    log("# phase 2: build")
    build_dir, build_s, per_source = _build.build()
    log(f"  built {os.path.relpath(build_dir, ROOT)} in {build_s:.1f} s (0.0: it was already built); "
        f"one nvcc per source, all at once: " + ", ".join(f"{k} {v:.1f} s" for k, v in per_source.items())
        + f" (sum {sum(per_source.values()):.1f} s)")
    for line in (build_dir / "ptxas.log").read_text().splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line or "wgmma" in line:
            log(f"  ptxas: {line.strip()}")
    _build.library()
    imma = count_sass(build_dir / "libw8a8.so", "IMMA")
    if imma == 0:
        raise AssertionError("libw8a8.so holds no IMMA instruction: #16's products are not on the int8 tensor cores")
    log(f"  libw8a8.so: {imma} IMMA (s8 x s8 -> s32 tensor-core) instructions, "
        f"{count_sass(build_dir / 'libw8a8.so', 'HMMA')} HMMA (the bf16 wo product)")
    igmma = count_sass(build_dir / "libdense_w8a8.so", "IGMMA")
    if igmma == 0:
        raise AssertionError("libdense_w8a8.so holds no IGMMA instruction: #16's MLP products are not on s8 wgmma")
    log(f"  libdense_w8a8.so: {igmma} IGMMA (s8 x s8 -> s32 wgmma) instructions")
    for lib, what in (("libdecode_dense.so", "#2 / #3, #5-#8 and #17 / #18"), ("libdecode_fused.so", "#13 / #14"),
                      ("libdense_mlp.so", "#15 / #20"), ("libdense_w8a8.so", "#16's wo product")):
        hgmma = count_sass(build_dir / lib, "HGMMA")
        if hgmma == 0:
            raise AssertionError(f"{lib} holds no HGMMA instruction: {what} do not run on wgmma")
        log(f"  {lib}: {hgmma} HGMMA (wgmma) instructions, {count_sass(build_dir / lib, 'UTMALDG')} UTMALDG "
            f"(TMA tile loads)")
    log(f"  libdecode_attention_tma.so: {count_sass(build_dir / 'libdecode_attention_tma.so', 'UBLKCP')} UBLKCP "
        f"(bulk async copies), {count_sass(build_dir / 'libdecode_attention_tma.so', 'SYNCS')} SYNCS (mbarrier) "
        f"instructions")
    for lib, ops, what in (("libnearest_code.so", ("HGMMA", "UTMALDG"), "#9's 3xTF32 products and TMA ring"),
                           ("libstream_probe.so", ("UTMALDG", "SYNCS"), "#19's TMA ring and its mbarriers")):
        found = {op: count_sass(build_dir / lib, op) for op in ops}
        if not all(found.values()):
            raise AssertionError(f"{lib}: {found}: {what} are not in its code")
        log(f"  {lib}: " + ", ".join(f"{n} {op}" for op, n in found.items()) + f" instructions ({what})")

    # phase 3: kernels against their plain versions at main-path shapes
    log("# phase 3: kernels vs plain versions (bf16 activations, B=100, C=1536, nh=24, T=64)")
    gen = torch.Generator(device=dev).manual_seed(0)
    if mode == "dense":
        check_dense(DK, dev, gen)
        check_dense(DK, dev, gen, quantize_weight)
    if mode in ("dense", "fused"):
        check_decode_layer_step(MK, DK, AK, dev, gen)
        check_attention_q8_wo(AK, DK, quantize_weight, dev, gen)
        return
    if mode == "mlp":
        check_mlp(MLP, DM, dev, gen)
        check_ablate(QP, quantize_weight, dev, gen)
        return
    if mode == "q8":
        check_q8_pipeline(QP, DK, quantize_weight, dev, gen)
        check_w8a8(W8, DK, quantize_weight, dev, gen)
        return
    if mode == "nearest":
        check_nearest_code(RK, dev, gen)
        return
    if mode == "stage1":
        log(f"# phase 13: stage-1 training (nearest_code on its path), on {card}")
        stage1_phase(counters, dev, card)
        return
    if mode == "attention":
        check_attention(AK, dev, gen)
        check_attention_q8(AK, dev, gen)
        check_attention_read_only(AK, dev, gen)
        check_attention_q8_read_only(AK, dev, gen)
        return
    attn = check_attention(AK, dev, gen)
    attn_read10, attn_read, attn_read104 = check_attention_read_only(AK, dev, gen)
    qkv, mlp = check_dense(DK, dev, gen)
    attn_q8 = check_attention_q8(AK, dev, gen)
    attn_q8_read = check_attention_q8_read_only(AK, dev, gen)
    qkv_q8, mlp_q8 = check_dense(DK, dev, gen, quantize_weight)
    nearest = check_nearest_code(RK, dev, gen)
    mega = check_decode_layer_step(MK, DK, AK, dev, gen)
    attn_wo = check_attention_q8_wo(AK, DK, quantize_weight, dev, gen)
    pipe_ring, pipe_packed, pipe_probe = check_q8_pipeline(QP, DK, quantize_weight, dev, gen)
    pipe_ablate = check_ablate(QP, quantize_weight, dev, gen)
    w8a8 = check_w8a8(W8, DK, quantize_weight, dev, gen)
    mlp15 = check_mlp(MLP, DM, dev, gen)

    # phase 4: the main path at full width, at each operating point
    log(f"# phase 4: 1.4B class-conditional sampling + RQ-VAE decode, bs{BATCH}, on {card}")
    t0 = time.perf_counter()
    model, vqvae, cond = build_main_path(dev)
    torch.cuda.synchronize()
    n_ar = sum(p.numel() for p in model.parameters())
    n_vq = sum(p.numel() for p in vqvae.parameters())
    log(f"  rq-transformer {n_ar / 1e6:.0f}M params, rq-vae {n_vq / 1e6:.0f}M params, "
        f"built and initialised in {time.perf_counter() - t0:.1f} s")

    def sample(seed, kernels=True, **options):
        return S.sample(model, BATCH, torch.Generator(device=dev).manual_seed(seed), cond=cond,
                        quantizer=vqvae.quantizer, temperature=1.0, kernels=kernels, **options)

    def set_int8(int8):
        if int8 != model.body_transformer.blocks[0].int8:
            model.quantize_int8() if int8 else model.clear_int8()

    attn_steps, head_steps = 42 * 64, 6 * 4 * 64  # cond_len 1 included; 4 depths at 64 positions
    A, D = attn_steps, head_steps
    points = [  # (name, int8 weights, sample options, launches each counter must show)
        ("bf16", False, {}, (A, D, D, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0)),
        ("bf16+mega", False, dict(dense="mega"),
         (0, D, D, 0, 0, 0, 0, A, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0)),
        ("kv_q8", False, dict(kv_q8=True),
         (0, D, D, A, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0)),
        ("kv_q8+attn_wo", False, dict(kv_q8=True, attn_wo=True),
         (0, D, D, 0, 0, 0, 0, 0, A, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0)),
        # int8 weights: the body's S == 1 steps run the int8 dense pair too (its
        # QKV half alone under attn_wo, whose MLP stays on the plain _mm)
        ("int8+kv_q8", True, dict(kv_q8=True),
         (0, 0, 0, A, D + A, D + A, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0)),
        ("int8+kv_q8+attn_wo", True, dict(kv_q8=True, attn_wo=True),
         (0, 0, 0, 0, D + A, D, 0, 0, A, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0)),
    ]
    assert all(len(expect) == len(counters) for *_, expect in points)
    launches, results = {}, {}
    for name, int8, options, expect in points:
        set_int8(int8)
        want = {fn.__name__: n for fn, n in zip(counters, expect)}
        codes, times, warm_s = timed_samples(name, lambda seed: sample(seed, **options), counters, want)
        log(f"  [{name}] warm-up sample {warm_s:.2f} s; launches in each sample(bs{BATCH}): {want}")
        for k, v in want.items():  # a kernel's most launches at any point (#5 / #6: int8+kv_q8's)
            launches[k] = max(launches.get(k, 0), v)
        pixels, decode_s = decode_checked(vqvae, codes, (BATCH, 8, 8, 4), 16384)
        results[name] = codes
        if name == "bf16":
            images = pixels  # phase 6 encodes them
        agree = f", codes equal to bf16's at {float((codes == results['bf16']).float().mean()):.3f}" if name != "bf16" else ""
        log(f"  [{name}] codes {tuple(codes.shape)} in [{int(codes.min())}, {int(codes.max())}], "
            f"{len(torch.unique(codes))} distinct{agree}; pixels finite")
        log_times(name, times, decode_s, card)
    # the decode against an fp32 copy of itself, and the bf16 point's plain path
    pixels = (0.5 * decode(vqvae, results["bf16"][:4]).float() + 0.5).clamp(0.0, 1.0)
    log(f"  pixels mean {float(pixels.mean()):.4f}")
    vq32 = copy.deepcopy(vqvae).float()
    compare("decode_code bf16 vs fp32 copy (4 images, [0,1] pixels)", pixels,
            (0.5 * decode(vq32, results["bf16"][:4]).float() + 0.5).clamp(0.0, 1.0), PIXEL_TOL)
    del vq32
    set_int8(False)
    _, plain_s = wall_s(lambda: sample(1, kernels=False))
    log(f"  [bf16] sampling (plain versions): {plain_s * 1e3 / BATCH:.3f} ms/sample; {card}")

    # phase 5: the same path through the kernels and through the plain versions
    log("# phase 5: forced_logits at B=8, kernels vs plain versions")
    for name, int8, options, _ in points:
        set_int8(int8)
        forced, fcond = results[name][:8], cond[:8]
        got = S.forced_logits(model, forced, fcond, vqvae.quantizer, kernels=True, **options)
        ref = S.forced_logits(model, forced, fcond, vqvae.quantizer, kernels=False, **options)
        torch.cuda.synchronize()
        log(f"  [{name}] logits {tuple(ref.shape)}, std {float(ref.std()):.3f}")
        compare(f"[{name}] forced_logits kernels vs plain", got, ref, LOGIT_TOL, LOGIT_MEAN_TOL)
    set_int8(False)

    # phase 6: the encode side at full width
    log(f"# phase 6: RQ-VAE encode + residual quantization + decode, bf16, bs{BATCH}, on {card}")
    launches["nearest_code"] = encode_phase(vqvae, images.clamp(-1.0, 1.0), counters, card)

    # phase 7: the stacked-cache sampler at vqgan_huge and vqgan_large, once the 1.4B model is freed
    del model, vqvae, images, results, pixels
    torch.cuda.empty_cache()
    log(f"# phase 7: vqgan_huge (f16-d1-c16384), then vqgan_large (f16-d1-c1024, head size 104), "
        f"class-conditional sampling through the stacked-cache sampler + RQ-VAE decode, bs{BATCH}, on {card}")
    launches["decode_attention_stacked"] = launches["decode_attention"] = vqgan_phase(S, counters, dev, card,
                                                                                    "vqgan_huge")
    torch.cuda.empty_cache()
    attn_read104["launches"] = vqgan_phase(S, counters, dev, card, "vqgan_large")
    torch.cuda.empty_cache()

    # phase 8: the ported experiment, #10 against #11
    log(f"# phase 8: rqvae_tpu_torch.tools.exp_attn_q8cache, B 100 and 500, T 64, 50 calls per chain, on {card}")
    launches["decode_attention_q8"], chains = experiment_phase(AK, counters, dev, card)
    attn_read10["chain_us"] = {b: r["bf16_us"] for b, r in chains.items()}
    attn_q8_read["chain_us"] = {b: r["q8_us"] for b, r in chains.items()}

    # phase 9: the ported q8 pipeline experiment, #6 against #17-#20
    log(f"# phase 9: rqvae_tpu_torch.tools.exp_q8_pipeline, B {BATCH}, the full sweeps and probes, "
        f"{PIPE_ITERS} iterations of 16 layers per chain, on {card}")
    launches.update(q8_pipeline_phase(QP, counters, dev, card))

    # phase 10: the ported W8A8 experiment, #3 / #6 against #16
    log(f"# phase 10: rqvae_tpu_torch.tools.exp_w8a8, B {BATCH}, {W8A8_ITERS} iterations of 16 layers per chain, "
        f"on {card}")
    launches["fused_proj_mlp_q8a8"] = w8a8_phase(counters, dev, card)

    # phase 11: the ported MLP microbench, xla_mlp against #15
    log(f"# phase 11: rqvae_tpu_torch.tools.exp_mlp_kernel, B 100 and 500, {MLP_ITERS} iterations of 24 layers per "
        f"chain, on {card}")
    launches["fused_mlp"] = mlp_phase(counters, dev, card)
    torch.cuda.empty_cache()

    # phase 12: the stage-2 trainer, after phase 11 has freed its memory
    log(f"# phase 12: stage-2 training: (a) a full-width, 2 + 1-layer step on the card against the CPU's, fp32; "
        f"(b) the 1.4B RQ-Transformer, amp bf16, {TRAIN_STEPS} steps of B {TRAIN_BATCH}; (c) remat; on {card}")
    train_phase(counters, dev, card)
    torch.cuda.empty_cache()

    # phase 13: the stage-1 trainer, #9 on its path
    log(f"# phase 13: stage-1 training: (a) {S1_CUT_STEPS} steps of the synthetic stage-1 geometry on the card against "
        f"the CPU's, fp32; (b) the 8x8x4 RQ-VAE at full width, {S1_STEPS} steps of B {S1_BATCH} with the PatchGAN and "
        f"LPIPS; (c) the last step through the plain argmin; on {card}")
    launches["nearest_code"] += stage1_phase(counters, dev, card)

    kernels = [
        dict(name="decode_attention_update", route="cuda", source="rqvae_tpu_torch/csrc/decode_attention_tma.cu",
             replaces="rqvae_tpu/ops/attention_kernel.py:316", **attn),
        dict(name="fused_ln_qkv", route="cuda", source="rqvae_tpu_torch/csrc/decode_dense.cu",
             replaces="rqvae_tpu/ops/decode_layer_kernel.py:109", **qkv),
        dict(name="fused_proj_mlp", route="cuda", source="rqvae_tpu_torch/csrc/decode_dense.cu",
             replaces="rqvae_tpu/ops/decode_layer_kernel.py:329", **mlp),
        dict(name="decode_attention_q8_update", route="cuda", source="rqvae_tpu_torch/csrc/decode_attention_tma.cu",
             replaces="rqvae_tpu/ops/attention_kernel.py:577", **attn_q8),
        dict(name="fused_ln_qkv_q8", route="cuda", source="rqvae_tpu_torch/csrc/decode_dense.cu",
             replaces="rqvae_tpu/ops/decode_layer_kernel.py:246 (ring) and :161 (grid)", **qkv_q8),
        dict(name="fused_proj_mlp_q8", route="cuda", source="rqvae_tpu_torch/csrc/decode_dense.cu",
             replaces="rqvae_tpu/ops/decode_layer_kernel.py:451 (ring) and :559 (grid)", **mlp_q8),
        dict(name="nearest_code", route="cuda", source="rqvae_tpu_torch/csrc/nearest_code.cu",
             replaces="rqvae_tpu/ops/rq_kernel.py:69", **nearest),
        dict(name="decode_layer_step", route="cuda", source="rqvae_tpu_torch/csrc/decode_fused.cu",
             replaces="rqvae_tpu/ops/decode_megakernel.py:215", **mega),
        dict(name="decode_attention_q8_update_wo", route="cuda", source="rqvae_tpu_torch/csrc/decode_fused.cu",
             replaces="rqvae_tpu/ops/attention_kernel.py:728", **attn_wo),
        dict(name="decode_attention", route="cuda", source="rqvae_tpu_torch/csrc/decode_attention_tma.cu",
             replaces="rqvae_tpu/ops/attention_kernel.py:209", **attn_read10),
        dict(name="decode_attention_stacked", route="cuda", source="rqvae_tpu_torch/csrc/decode_attention_tma.cu",
             replaces="rqvae_tpu/ops/attention_kernel.py:149", **attn_read,
             head_size_104=attn_read104),  # the same kernel on vqgan_large's path
        dict(name="decode_attention_q8", route="cuda", source="rqvae_tpu_torch/csrc/decode_attention_tma.cu",
             replaces="rqvae_tpu/ops/attention_kernel.py:830", **attn_q8_read),
        dict(name="fused_proj_mlp_q8_ring", route="cuda", source="rqvae_tpu_torch/csrc/decode_dense.cu",
             replaces="tools/exp_q8_pipeline.py:115", **pipe_ring),
        dict(name="fused_proj_mlp_q8_packed", route="cuda", source="rqvae_tpu_torch/csrc/decode_dense.cu",
             replaces="tools/exp_q8_pipeline.py:216 (the same kernel as :115, packed w2 map)", **pipe_packed),
        dict(name="stream_probe", route="cuda", source="rqvae_tpu_torch/csrc/stream_probe.cu",
             replaces="tools/exp_q8_pipeline.py:302", **pipe_probe),
        dict(name="ablate_ring", route="cuda", source="rqvae_tpu_torch/csrc/dense_mlp.cu",
             replaces="tools/exp_q8_pipeline.py:379", **pipe_ablate),
        dict(name="fused_proj_mlp_q8a8", route="cuda", source="rqvae_tpu_torch/csrc/dense_w8a8.cu",
             replaces="tools/exp_w8a8.py:107", **w8a8),
        dict(name="fused_mlp", route="cuda", source="rqvae_tpu_torch/csrc/dense_mlp.cu",
             replaces="tools/exp_mlp_kernel.py:75", **mlp15),
    ]
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
