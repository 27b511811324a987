"""rFID: FID between a dataset's images and their stage-1 reconstructions.

Port of cli/compute_rfid.py (the reference's compute_rfid.py:54-82, in
whole batches): the RQ-VAE of a stage-1 model.pt with its config.yaml, its
dataset's eval split through metrics/fid.compute_rfid, the codes through
the nearest_code kernel on CUDA. The FID Inception's weights come from
RQVAE_TPU_FID_WEIGHTS (synthetic without them: the number is then not
comparable to published ones).

    python -m rqvae_tpu_torch.cli.compute_rfid -m <stage1 model.pt> [--batch-size 64] [--root <dataset root>]

The JAX CLI's arguments, plus --device (default: the first CUDA device;
`--device cpu` runs on the CPU). `main(argv)` returns the rFID.
"""

from __future__ import annotations

import argparse
import logging

from rqvae_tpu_torch import resolve_device
from rqvae_tpu_torch.cli.common import load_model_from_ckpt
from rqvae_tpu_torch.data import create_dataset
from rqvae_tpu_torch.metrics.fid import InceptionExtractor, compute_rfid
from rqvae_tpu_torch.utils.config import augment_defaults


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-m", "--model-path", type=str, required=True)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--split", type=str, default="val")
    p.add_argument("--root", type=str, default="", help="dataset root override")
    p.add_argument("--device", type=str, default=None, help="default: the first CUDA device")
    return p.parse_args(argv)


def main(argv=None) -> float:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    device = resolve_device(args.device)

    kind, model, config = load_model_from_ckpt(args.model_path, device=device)
    if kind != "rq-vae":
        raise ValueError(f"{args.model_path}: compute_rfid needs a stage-1 checkpoint, got {kind}")
    config = augment_defaults(config)
    if "experiment" not in config:
        config.experiment = {"total_batch_size": args.batch_size}
    if args.root:
        config.dataset.root = args.root
    trn, val = create_dataset(config, is_eval=True)
    dataset = val if args.split == "val" else trn

    def recon_fn(xs):  # NCHW in, NCHW out
        out, _, _ = model(xs.permute(0, 2, 3, 1))
        return out.permute(0, 3, 1, 2)

    rfid = compute_rfid(dataset, recon_fn, batch_size=args.batch_size, extractor=InceptionExtractor(device=device))
    logging.info("rFID: %.4f", rfid)
    print(f"rFID: {rfid:.4f}")
    return rfid


if __name__ == "__main__":
    main()
