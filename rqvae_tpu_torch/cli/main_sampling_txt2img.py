"""Text-to-image sampling over the cc3m / coco caption sets.

Port of cli/main_sampling_txt2img.py (the reference's
main_sampling_txt2img.py:77-212): the captions of Cc3mTextOnly /
CocoTextOnly, in order and tokenized as the stage-2 config says, condition
`sampling.sample` (cond [B, context_length]; the kernels on); the stage-1
RQ-VAE decodes the codes, and samples_{batch:05d}.pkl (NCHW float32 in
[0, 1]) hold them in dataset order, for compute_clip_score and FID. The
last batch repeats the last caption to fill it.

    python -m rqvae_tpu_torch.cli.main_sampling_txt2img -m <stage2 model.pt> -d cc3m --dataset-root data/cc3m

The JAX CLI's arguments, plus --device (default: the first CUDA device;
`--device cpu` runs on the CPU), --dtype (default bfloat16, the kernels'
dtype) and --no-kernels (the kernels' plain versions, for a geometry the
kernels do not serve). `main(argv)` returns the output directory.
"""

from __future__ import annotations

import argparse
import logging
import os
import pickle

import numpy as np
import torch

from rqvae_tpu_torch import resolve_device
from rqvae_tpu_torch.cli.common import load_ar_and_vqvae, set_seed
from rqvae_tpu_torch.cli.main_sampling_fid import DTYPES
from rqvae_tpu_torch.data.textimg import Cc3mTextOnly, CocoTextOnly
from rqvae_tpu_torch.models.rqtransformer import sampling as S
from rqvae_tpu_torch.utils.config import env_flag


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-m", "--model-path", type=str, required=True)
    p.add_argument("-o", "--out-dir", type=str, default="")
    p.add_argument("-d", "--dataset", type=str, default="cc3m", choices=["cc3m", "coco"])
    p.add_argument("--dataset-root", type=str, default="")
    p.add_argument("--split", type=str, default="val")
    p.add_argument("-bs", "--batch-size", type=int, default=100)
    p.add_argument("--temp", type=float, default=1.0)
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--top-p", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ema", action="store_true", help="sample with EMA weights")
    p.add_argument("--device", type=str, default=None, help="default: the first CUDA device")
    p.add_argument("--dtype", choices=sorted(DTYPES), default="bfloat16")
    p.add_argument("--no-kernels", action="store_true", help="the kernels' plain versions")
    return p.parse_args(argv)


@torch.no_grad()
def main(argv=None) -> str:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    seed = set_seed(args.seed)
    smoke = env_flag("SMOKE_TEST")
    device = resolve_device(args.device)

    model, vqvae, config = load_ar_and_vqvae(args.model_path, use_ema=args.ema, device=device,
                                             dtype=DTYPES[args.dtype])
    root = args.dataset_root or f"data/{args.dataset}"
    ds_cls = Cc3mTextOnly if args.dataset == "cc3m" else CocoTextOnly
    txt_dataset = ds_cls(root, args.split, tok_name=config.dataset.txt_tok_name, transform=None,
                         context_length=config.dataset.context_length)
    logging.info("#text conds: %d", len(txt_dataset))

    top_k = args.top_k if args.top_k > 0 else None
    top_p = args.top_p if args.top_p > 0 else None
    out_dir = args.out_dir or os.path.join(
        os.path.dirname(args.model_path), f"{args.dataset}_{args.split}_temp{args.temp}_top_k_{top_k}_top_p_{top_p}")
    os.makedirs(out_dir, exist_ok=True)

    generator = torch.Generator(device=device).manual_seed(seed)
    bs, n = args.batch_size, len(txt_dataset)
    num_batches = (n + bs - 1) // bs
    for batch_idx in range(num_batches):
        idxs = [min(i, n - 1) for i in range(batch_idx * bs, (batch_idx + 1) * bs)]
        conds = torch.from_numpy(np.stack([np.asarray(txt_dataset[i][1], np.int64) for i in idxs])).to(device)
        codes = S.sample(model, bs, generator, cond=conds, quantizer=vqvae.quantizer, temperature=args.temp,
                         top_k=top_k, top_p=top_p, kernels=not args.no_kernels)
        pixels = (vqvae.decode_code(codes).float() * 0.5 + 0.5).clamp(0.0, 1.0)
        with open(os.path.join(out_dir, f"samples_{batch_idx:05d}.pkl"), "wb") as f:
            pickle.dump(pixels.permute(0, 3, 1, 2).cpu().numpy().astype(np.float32), f)
        logging.info("batch %d/%d", batch_idx + 1, num_batches)
        if smoke:
            break
    logging.info("samples saved under %s", out_dir)
    return out_dir


if __name__ == "__main__":
    main()
