"""Dataset factories: port of rqvae_tpu/data/__init__.py (the reference's
img_datasets/__init__.py:29-66 and txtimg_datasets/__init__.py:23-64),
with the SMOKE_TEST truncation of each split to 2 x total_batch_size
items."""

from __future__ import annotations

import os

import numpy as np

from rqvae_tpu_torch.data.datasets import FFHQ, ImageFolder, LSUNClass, Subset
from rqvae_tpu_torch.data.loader import DataLoader, default_collate
from rqvae_tpu_torch.data.textimg import Cc3m, Cc3mRawTextOnly, Cc3mTextOnly, Coco, CocoRawTextOnly, CocoTextOnly
from rqvae_tpu_torch.data.transforms import create_transforms, create_txtimg_transforms
from rqvae_tpu_torch.utils.config import env_flag


def _maybe_truncate(dataset, config, seed=0):
    if not env_flag("SMOKE_TEST"):
        return dataset
    n = config["experiment"].get("total_batch_size", 64) * 2
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(dataset))[:n]
    return Subset(dataset, idx)


def create_dataset(config, is_eval: bool = False, logger=None):
    """(train, val) image datasets per config.dataset.type."""
    dcfg = config["dataset"]
    t_trn = create_transforms(dcfg, split="train", is_eval=is_eval)
    t_val = create_transforms(dcfg, split="val", is_eval=is_eval)
    root = dcfg.get("root", None)
    dtype = dcfg["type"]

    if dtype in ("imagenet", "imagenet_u"):
        root = root or "data/imagenet"
        labels = dtype == "imagenet"  # imagenet_u: all labels -> 0
        trn = ImageFolder(os.path.join(root, "train"), t_trn, labels=labels)
        val = ImageFolder(os.path.join(root, "val"), t_val, labels=labels)
    elif dtype == "ffhq":
        root = root or "data/ffhq"
        trn = FFHQ(root, split="train", transform=t_trn)
        val = FFHQ(root, split="val", transform=t_val)
    elif dtype in ("LSUN-cat", "LSUN-church", "LSUN-bedroom"):
        root = root or "data/lsun"
        category = dtype.split("-")[-1]
        cat_root = os.path.join(root, category) if os.path.isdir(os.path.join(root, category)) else root
        trn = LSUNClass(cat_root, transform=t_trn, category=category)
        # the reference's quirk: LSUN val reuses the TRAIN data and train
        # transforms (img_datasets/__init__.py:53-54)
        val = LSUNClass(cat_root, transform=t_trn, category=category)
    else:
        raise ValueError(f"{dtype} not supported...")

    trn = _maybe_truncate(trn, config)
    val = _maybe_truncate(val, config)
    if logger is not None:
        logger.info(f"#train samples: {len(trn)}, #valid samples: {len(val)}")
    return trn, val


def create_datasets(config, is_eval: bool = False, logger=None):
    """(train, val) text-image datasets per config.dataset.dataset."""
    dcfg = config["dataset"]
    t_trn = create_txtimg_transforms(dcfg, split="train", is_eval=is_eval)
    t_val = create_txtimg_transforms(dcfg, split="valid", is_eval=is_eval)
    root = dcfg.get("root", None)
    name = dcfg["dataset"]

    if name == "coco":
        root = root or "data/coco"
        cls = Coco
    elif name == "cc3m":
        root = root or "data/cc3m"
        cls = Cc3m
    else:
        raise NotImplementedError(name)

    trn = cls(root, split="train" if name == "cc3m" else "val", tok_name=dcfg["txt_tok_name"], transform=t_trn,
              context_length=dcfg["context_length"], dropout=dcfg.get("bpe_dropout"))
    val = cls(root, split="val", tok_name=dcfg["txt_tok_name"], transform=t_val,
              context_length=dcfg["context_length"], dropout=None)
    trn = _maybe_truncate(trn, config)
    val = _maybe_truncate(val, config)
    if logger is not None:
        logger.info(f"#train samples: {len(trn)}, #valid samples: {len(val)}")
    return trn, val


__all__ = [
    "DataLoader", "default_collate", "create_dataset", "create_datasets", "create_transforms",
    "create_txtimg_transforms", "Cc3m", "Cc3mTextOnly", "Cc3mRawTextOnly", "Coco", "CocoTextOnly",
    "CocoRawTextOnly", "ImageFolder", "FFHQ", "LSUNClass", "Subset",
]
