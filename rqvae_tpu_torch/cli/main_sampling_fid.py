"""Class-conditional sampling, then FID / IS of the samples.

Port of cli/main_sampling_fid.py: sample n_samples images across the label
set with the stage-2 RQ-Transformer, decode them with the stage-1 RQ-VAE,
write samples_{i}.pkl (NCHW float32 in [0, 1]) and targets_{i}.npz per
batch and seeds.txt, then acts.npz, the Inception Score and, with --stats,
the FID against precomputed statistics. Sampling is
`sampling.sample` with its defaults (the kernels on), its draws from one
torch.Generator seeded with --seed; the sampled codes equal the JAX CLI's
only where the draw is determined (--top-k 1).

    python -m rqvae_tpu_torch.cli.main_sampling_fid -m <stage2 model.pt> \\
        --temp 1.0 --top-k 0 --top-p 0.92 -bs 100 -n 50000 [--stats <fid_stats.npz>]

The JAX CLI's arguments, plus --device (default: the first CUDA device;
`--device cpu` runs on the CPU), --dtype (default bfloat16, the kernels'
dtype; float32 runs the models as loaded) and --no-kernels (the kernels'
plain versions on the same device, for a geometry the kernels do not
serve: ops/ raise ValueError for it).
"""

from __future__ import annotations

import argparse
import logging
import os
import pickle
import time

import numpy as np
import torch

from rqvae_tpu_torch import resolve_device
from rqvae_tpu_torch.cli.common import load_ar_and_vqvae, set_seed
from rqvae_tpu_torch.metrics import fid as fid_lib
from rqvae_tpu_torch.metrics import is_score as is_lib
from rqvae_tpu_torch.models.rqtransformer import sampling as S
from rqvae_tpu_torch.utils.config import env_flag

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-m", "--model-path", type=str, required=True)
    p.add_argument("-o", "--out-dir", type=str, default="")
    p.add_argument("-n", "--n-samples", type=int, default=50000)
    p.add_argument("-bs", "--batch-size", type=int, default=100)
    p.add_argument("--n-labels", type=int, default=0, help="0 = from config")
    p.add_argument("--temp", type=float, default=1.0)
    p.add_argument("--top-k", type=int, default=0, help="0 = no top-k")
    p.add_argument("--top-p", type=float, default=0.0, help="0 = no top-p")
    p.add_argument("--stats", type=str, default="", help="reference FID stats npz")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ema", action="store_true", help="sample with EMA weights")
    p.add_argument("--no-metrics", action="store_true")
    p.add_argument("--device", type=str, default=None, help="default: the first CUDA device")
    p.add_argument("--dtype", choices=sorted(DTYPES), default="bfloat16")
    p.add_argument("--no-kernels", action="store_true", help="the kernels' plain versions")
    return p.parse_args(argv)


def label_layout(n_labels: int, n_samples: int, num_batches: int, batch_size: int) -> np.ndarray:
    """The class of every sample: each label repeated n_samples // n_labels
    times (the reference's arange(n_labels).repeat_interleave), cut or
    cycled to num_batches * batch_size."""
    all_conds = np.repeat(np.arange(n_labels), max(n_samples // n_labels, 1))[: num_batches * batch_size]
    if len(all_conds) < num_batches * batch_size:
        all_conds = np.resize(all_conds, num_batches * batch_size)
    return all_conds


@torch.no_grad()
def sample_to_files(model, vqvae, out_dir: str, n_samples: int, batch_size: int, n_labels: int, generator,
                    temp: float = 1.0, top_k=None, top_p=None, kernels: bool = True, smoke: bool = False) -> list:
    """Sample, decode and write samples_{i}.pkl and targets_{i}.npz per
    batch; returns each batch's seconds (sampling + decode + write)."""
    num_batches = max(n_samples // batch_size, 1)
    all_conds = label_layout(n_labels, n_samples, num_batches, batch_size)
    device = model.pos_emb_hw.device
    seconds = []
    t0 = time.time()
    for batch_idx in range(num_batches):
        tb = time.time()
        cond = torch.as_tensor(all_conds[batch_idx * batch_size : (batch_idx + 1) * batch_size], device=device)
        codes = S.sample(model, batch_size, generator, cond=cond, quantizer=vqvae.quantizer, temperature=temp,
                         top_k=top_k, top_p=top_p, kernels=kernels)
        pixels = (vqvae.decode_code(codes).float() * 0.5 + 0.5).clamp(0.0, 1.0)
        pixels_nchw = pixels.permute(0, 3, 1, 2).cpu().numpy().astype(np.float32)  # the reference's layout
        with open(os.path.join(out_dir, f"samples_{batch_idx}.pkl"), "wb") as f:
            pickle.dump(pixels_nchw, f)
        np.savez(os.path.join(out_dir, f"targets_{batch_idx}.npz"), targets=cond.cpu().numpy().astype(np.int32))
        seconds.append(time.time() - tb)
        done = (batch_idx + 1) * batch_size
        logging.info("batch %d/%d (%.1f ms/sample)", batch_idx + 1, num_batches, (time.time() - t0) / done * 1000)
        if smoke:
            break
    return seconds


def score_files(out_dir: str, stats: str = "", extractor=None) -> dict:
    """acts.npz, then IS and, given reference `stats`, FID of the samples in
    out_dir: {"IS": (mean, std)[, "FID": d]}."""
    extractor = extractor or fid_lib.InceptionExtractor()
    mu, sigma, acts = fid_lib.compute_statistics_from_files(out_dir, extractor=extractor, return_acts=True)
    np.savez(os.path.join(out_dir, "acts.npz"), acts=acts, mu=mu, sigma=sigma)
    m_is, s_is = is_lib.compute_inception_score_from_files(out_dir, extractor=extractor)
    logging.info("IS: %.4f +- %.4f", m_is, s_is)
    results = {"IS": (m_is, s_is)}
    if stats:
        results["FID"] = fid_lib.compute_fid(out_dir, stats)
        logging.info("FID: %.4f", results["FID"])
    return results


def main(argv=None):
    """The CLI; returns score_files' results (None under --no-metrics)."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    seed = set_seed(args.seed)
    smoke = env_flag("SMOKE_TEST")
    device = resolve_device(args.device)

    if args.n_samples % args.batch_size != 0 and not smoke:
        raise ValueError(f"--n-samples {args.n_samples} is not a multiple of --batch-size {args.batch_size}")
    model, vqvae, _ = load_ar_and_vqvae(args.model_path, use_ema=args.ema, device=device,
                                        dtype=DTYPES[args.dtype])
    n_labels = args.n_labels or max(model.config.vocab_size_cond, 1)
    top_k = args.top_k if args.top_k > 0 else None
    top_p = args.top_p if args.top_p > 0 else None

    out_dir = args.out_dir or os.path.join(
        os.path.dirname(args.model_path), f"samples_temp{args.temp}_top_k_{top_k}_top_p_{top_p}"
    )
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "seeds.txt"), "a") as f:
        f.write(f"seed={args.seed} n={args.n_samples} bs={args.batch_size}\n")

    generator = torch.Generator(device=device).manual_seed(seed)
    sample_to_files(model, vqvae, out_dir, args.n_samples, args.batch_size, n_labels, generator, args.temp, top_k,
                    top_p, kernels=not args.no_kernels, smoke=smoke)
    if args.no_metrics:
        return None
    return score_files(out_dir, args.stats, fid_lib.InceptionExtractor(device=device))


if __name__ == "__main__":
    main()
