"""Metrics over a directory of samples*.pkl: FID against precomputed
dataset statistics, IS for imagenet, CLIP score for cc3m / coco.

Port of cli/compute_metrics.py. Arguments are key=value, as the JAX CLI's,
plus device (default: the first CUDA device; device=cpu runs on the CPU):

    python -m rqvae_tpu_torch.cli.compute_metrics fake_path=<dir> ref_stat_path=<npz> dataset=imagenet

For cc3m / coco the CLIP score of the samples against the split's captions
(clip_dataset_root=<dir>, split=val; CLIP weights from RQVAE_TPU_CLIP_DIR).
"""

from __future__ import annotations

import logging
import sys


def parse_kv(argv):
    out = {}
    for a in argv:
        if "=" not in a:
            raise SystemExit(f"compute_metrics: arguments are key=value, got {a!r}")
        k, v = a.split("=", 1)
        out[k] = v
    return out


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    kv = parse_kv(sys.argv[1:] if argv is None else argv)
    fake_path = kv["fake_path"]
    dataset = kv.get("dataset", "imagenet")

    from rqvae_tpu_torch.metrics import fid as fid_lib
    from rqvae_tpu_torch.metrics import is_score as is_lib

    extractor = fid_lib.InceptionExtractor(device=kv.get("device"))
    results = {}
    if "ref_stat_path" in kv:
        results["FID"] = fid_lib.compute_fid(fake_path, kv["ref_stat_path"], extractor=extractor)
    if dataset == "imagenet":
        m, s = is_lib.compute_inception_score_from_files(fake_path, extractor=extractor)
        results["IS"] = m
        results["IS_std"] = s
    if dataset in ("cc3m", "coco"):
        from rqvae_tpu_torch.metrics.clip_score import compute_clip_score

        results["CLIP_score"] = compute_clip_score(
            fake_path,
            dataset_name=dataset,
            dataset_root=kv.get("clip_dataset_root"),
            split=kv.get("split", "val"),
            device=kv.get("device"),
        )
    for k, v in results.items():
        print(f"{k}: {v:.4f}")
    return results


if __name__ == "__main__":
    main()
