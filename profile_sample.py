#!/usr/bin/env python3
"""Where the device time of one 1.4B bs100 sample call of the PyTorch/CUDA
port goes, at each of bench.py's operating points, of one bs100 RQ-VAE
forward (encode, residual quantization, decode), and of one bs100 sample
call of the zoo's vqgan_huge and vqgan_large through the stacked-cache
sampler, on one CUDA device.

The model is chip_smoke.py's main path (`build_main_path`): bench.py's 1.4B
geometry with random weights from a seed, bs100, temperature 1, no
top-k/top-p. The operating points are the bf16 KV cache, the int8 KV cache
(kv_q8) and int8 weights + kv_q8, each also with its fused body-layer path
(dense="mega" at bf16, attn_wo at the two kv_q8 points). Per point, after
one warm-up call, one sample call runs under torch.profiler. Reported: host
operations (the top-level aten operators the Python code dispatched, plus
the kernel wrappers' calls, whose ctypes launches are no aten operators),
device operations (kernel launches and copies), their summed device time
per sample, the top device operations, and the device time per call of
each of the port's kernel wrappers (their launches are wrapped in
record_function ranges for this run only). The unprofiled ms/sample is chip_smoke.py's (phase 4); the device
busy share is this script's device ms/sample over that. The RQ-VAE forward
(point "encode") runs on 100 images decoded from random codes, after one
warm-up forward; its wall ms/image is chip_smoke.py's (phase 6). Points
"vqgan_huge" and "vqgan_large" are chip_smoke.py's phase 7 models
(measure_throughput.build(16, name, 1, codebook), random bf16 weights from
a seed, 16x16x1 codes, the stacked-cache sampler; vqgan_large at head size
104), each built once the model before it is freed; their wall ms/sample
is chip_smoke.py's (phase 7). Point "train" is one stage-2 train step of
chip_smoke.py's phase 12 (b) (the 1.4B RQ-Transformer, amp bf16, 32 images
as 2 microbatches through a frozen bf16 encoder, AdamW, EMA; no kernel
wrapper on its path), after one warm-up step, reported per step; its
unprofiled ms/step is chip_smoke.py's (phase 12).

Prints one JSON line per point, then the card's name and power limit; the
profiler tables go to --out. The points to run are named on the command
line (all of them when none is named); each takes one to three minutes
under the profiler.

    python3 profile_sample.py --out build/profile bf16 vqgan_huge vqgan_large
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from chip_smoke import BATCH, build_main_path, card_line

ROOT = os.path.dirname(os.path.abspath(__file__))
POINTS = (  # (name, int8 weights, sample options), as chip_smoke.py phase 4
    ("bf16", False, {}),
    ("bf16+mega", False, dict(dense="mega")),
    ("kv_q8", False, dict(kv_q8=True)),
    ("kv_q8+attn_wo", False, dict(kv_q8=True, attn_wo=True)),
    ("int8+kv_q8", True, dict(kv_q8=True)),
    ("int8+kv_q8+attn_wo", True, dict(kv_q8=True, attn_wo=True)),
)
VQGAN_POINTS = ("vqgan_huge", "vqgan_large")  # measure_throughput's VQ-GAN rows
POINT_NAMES = [name for name, _, _ in POINTS] + ["encode", *VQGAN_POINTS, "train"]


def _annotated(fn):
    @functools.wraps(fn)  # carries the `launches` counter the wrapper increments
    def call(*args, **kwargs):
        with record_function(f"wrapper::{fn.__name__}"):
            return fn(*args, **kwargs)

    return call


def host_ops(prof) -> int:
    """Host operations of a profiled call: top-level aten operators and
    kernel-wrapper calls (module docstring); a wrapper called by another
    (decode_attention under decode_attention_stacked) is one operation."""
    cpu = torch.autograd.DeviceType.CPU

    def counts(e):
        if e.name.startswith("wrapper::"):
            return e.cpu_parent is None or not e.cpu_parent.name.startswith("wrapper::")
        return e.name.startswith("aten::") and e.cpu_parent is None

    return sum(1 for e in prof.events() if e.device_type == cpu and counts(e))


def report(name: str, prof, prof_s: float, out_dir: str, per=("sample", BATCH)) -> None:
    """One JSON line for a profiled call: host and device operations and ms
    per `per` (a sample, an image or a step, and how many the call made),
    the top device operations, per-wrapper device time."""
    events = prof.key_averages()
    # a record_function range also shows as a device-side annotation
    # spanning its kernels: it gives the wrapper's device time (the
    # CPU op does not, for kernels launched through ctypes) and is
    # left out of the device sums, which would count those kernels twice
    cuda = torch.autograd.DeviceType.CUDA
    device = [e for e in events if e.device_type == cuda and not e.key.startswith("wrapper::")]
    device_us = sum(e.self_device_time_total for e in device)
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:8]
    per_wrapper = {
        e.key.split("::", 1)[1]: {"calls": e.count, "device_us_per_call": e.self_device_time_total / e.count}
        for e in events if e.device_type == cuda and e.key.startswith("wrapper::")
    }
    with open(os.path.join(out_dir, f"{name.replace('+', '_')}.txt"), "w") as f:
        f.write(events.table(sort_by="self_device_time_total", row_limit=40))
    unit, n = per
    print(json.dumps({
        "point": name, f"profiled_ms_per_{unit}": prof_s * 1e3 / n, "host_ops": host_ops(prof),
        "device_ops": sum(e.count for e in device), f"device_ms_per_{unit}": device_us / 1e3 / n,
        "top_device_ops": [{"name": e.key[:80], "calls": e.count, "ms": e.self_device_time_total / 1e3}
                           for e in top],
        "wrappers": per_wrapper,
    }), flush=True)


def profiled(name: str, fn, out_dir: str, per=("sample", BATCH)) -> None:
    """One warm-up call of fn, then one call under the profiler, reported."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    report(name, prof, prof_s, out_dir, per)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "profile"))
    ap.add_argument("points", nargs="*", help=f"points to run, of {POINT_NAMES} (default: all)")
    args = ap.parse_args()
    names = args.points or POINT_NAMES
    unknown = sorted(set(names) - set(POINT_NAMES))
    if unknown:
        ap.error(f"unknown points {unknown}; the points are {POINT_NAMES}")
    if not torch.cuda.is_available():
        raise SystemExit("profile_sample: torch.cuda.is_available() is False; this needs a CUDA device")
    os.makedirs(args.out, exist_ok=True)
    card = card_line()
    dev = torch.device("cuda", 0)

    sys.path.insert(0, ROOT)
    from rqvae_tpu_torch.cli import measure_throughput as MT
    from rqvae_tpu_torch.models.rqtransformer import sampling as S
    from rqvae_tpu_torch.models.rqtransformer.model import RQTransformer
    from rqvae_tpu_torch.ops import attention_kernel as AK
    from rqvae_tpu_torch.ops import decode_layer_kernel as DK
    from rqvae_tpu_torch.ops import decode_megakernel as MK
    from rqvae_tpu_torch.ops import rq_kernel as RK

    def sampler(model, vqvae, cond, options):
        return lambda: S.sample(model, BATCH, torch.Generator(device=dev).manual_seed(1), cond=cond,
                                quantizer=vqvae.quantizer, **options)

    wrappers = {
        (AK, "decode_attention_update"), (AK, "decode_attention_q8_update"), (DK, "fused_ln_qkv"),
        (DK, "fused_ln_qkv_q8"), (DK, "fused_proj_mlp"), (DK, "fused_proj_mlp_q8"), (RK, "nearest_code"),
        (MK, "decode_layer_step"), (AK, "decode_attention_q8_update_wo"), (AK, "decode_attention"),
        (AK, "decode_attention_stacked"), (AK, "decode_attention_q8"),
    }
    originals = {(m, n): getattr(m, n) for m, n in wrappers}
    for (m, n), fn in originals.items():
        setattr(m, n, _annotated(fn))
    try:
        if set(names) - set(VQGAN_POINTS) - {"train"}:
            model, vqvae, cond = build_main_path(dev)
            for name, int8, options in POINTS:
                if name in names:
                    if int8 != model.body_transformer.blocks[0].int8:
                        model.quantize_int8() if int8 else model.clear_int8()
                    profiled(name, sampler(model, vqvae, cond, options), args.out)
            if "encode" in names:
                gen = torch.Generator(device=dev).manual_seed(2)
                codes = torch.randint(0, 16384, (BATCH, 8, 8, 4), generator=gen, device=dev)
                with torch.no_grad():
                    xs = vqvae.decode_code(codes).clamp(-1.0, 1.0)
                    profiled("encode", lambda: vqvae(xs), args.out)
            del model, vqvae
            torch.cuda.empty_cache()
        for name in [n for n in VQGAN_POINTS if n in names]:
            vqvae, tconf = MT.build(16, name, 1, MT.VQGAN_TRANSFORMERS[name][4], device=dev, dtype=torch.bfloat16)
            model = RQTransformer(tconf, device=dev, dtype=torch.bfloat16)
            gen = torch.Generator(device=dev).manual_seed(0)
            vqvae.init_weights(gen)
            model.init_weights(gen)
            cond = torch.arange(BATCH, device=dev) % tconf.vocab_size_cond
            profiled(name, sampler(model, vqvae, cond, {}), args.out)
            del model, vqvae
            torch.cuda.empty_cache()
        if "train" in names:
            import chip_smoke as C
            from rqvae_tpu_torch.trainers import trainer_stage2 as T2

            gen = torch.Generator(device=dev).manual_seed(0)
            model, vqvae = C.build_stage2(C.ARCH_1P4B, dev, gen)
            state = T2.init_state(model, C.TRAIN_OPTIM, C.train_schedule(), use_ema=True)
            step = T2.make_train_step(T2.Stage2LossConfig(), grad_accum_steps=C.TRAIN_ACCUM, quantizer=vqvae.quantizer,
                                      encode_fn=T2.make_frozen_encode_fn(vqvae, chunk=C.ENCODE_CHUNK))
            res = C.DDCONFIG["resolution"]
            batch = {"images": torch.rand(C.TRAIN_BATCH, 3, res, res, generator=gen, device=dev) * 2 - 1,
                     "cond": torch.arange(C.TRAIN_BATCH, device=dev) * 31 % model.config.vocab_size_cond}
            profiled("train", lambda: step(state, batch, torch.Generator(device=dev).manual_seed(100)), args.out,
                     per=("step", 1))
            del model, vqvae, state
            torch.cuda.empty_cache()
    finally:
        for (m, n), fn in originals.items():
            setattr(m, n, fn)
    print(card, flush=True)


if __name__ == "__main__":
    main()
