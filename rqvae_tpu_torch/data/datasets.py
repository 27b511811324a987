"""Image datasets: ImageNet-layout folders, FFHQ split lists, LSUN.

Port of rqvae_tpu/data/datasets.py (the reference's img_datasets:
__init__.py:29-66, ffhq.py:21-75, lsun.py:27-78). Files are read by
data/image_io.read_image (PNG without PIL). Items are (the transformed
image, HWC float32, int label); the transform's draws come from
np.random.SeedSequence([seed, epoch, index]), as JAX's.
"""

from __future__ import annotations

import os
import pickle
from typing import Sequence, Tuple

import numpy as np

from rqvae_tpu_torch.data.image_io import read_image
from rqvae_tpu_torch.data.transforms import Transform

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".webp", ".tif")


class ImageDataset:
    """Base: list of (path_or_bytes, label) + per-item transform."""

    def __init__(self, items: Sequence[Tuple], transform: Transform, seed: int = 0):
        self.items = list(items)
        self.transform = transform
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int):
        """Fresh augmentation draws per epoch; the loader calls it with its own."""
        self.epoch = epoch

    def __len__(self):
        return len(self.items)

    def load_image(self, spec) -> np.ndarray:
        return read_image(spec)

    def __getitem__(self, index: int):
        spec, label = self.items[index]
        img = self.load_image(spec)
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, self.epoch, index]))
        return self.transform(img, rng), label


class ImageFolder(ImageDataset):
    """Class-per-subdirectory layout (torchvision ImageFolder equivalent)."""

    def __init__(self, root: str, transform: Transform, labels: bool = True, **kw):
        classes = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
        self.classes = classes
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        items = []
        for c in classes:
            cdir = os.path.join(root, c)
            for fn in sorted(os.listdir(cdir)):
                if fn.lower().endswith(IMG_EXTENSIONS):
                    items.append((os.path.join(cdir, fn), self.class_to_idx[c] if labels else 0))
        super().__init__(items, transform, **kw)

    @property
    def n_classes(self):
        return len(self.classes)


class FFHQ(ImageDataset):
    """Flat image dir + train/val split list files (ffhqtrain.txt /
    ffhqvalidation.txt); without them a 90/10 split of the sorted files."""

    def __init__(self, root: str, split: str, transform: Transform, list_dir=None, **kw):
        list_dir = list_dir or root
        list_name = "ffhqtrain.txt" if split == "train" else "ffhqvalidation.txt"
        list_path = os.path.join(list_dir, list_name)
        if os.path.exists(list_path):
            with open(list_path) as f:
                names = [line.strip() for line in f if line.strip()]
        else:
            names = sorted(fn for fn in os.listdir(root) if fn.lower().endswith(IMG_EXTENSIONS))
            cut = int(len(names) * 0.9)
            names = names[:cut] if split == "train" else names[cut:]
        items = [(os.path.join(root, n), 0) for n in names]
        super().__init__(items, transform, **kw)


class LSUNClass(ImageDataset):
    """LSUN lmdb reader with a cached key list, or a plain image directory
    where there are no .mdb files. `category` "cat" reads the two corrupt
    records as the one before each (the reference's lsun.py:57-60)."""

    CAT_EXCEPTION_IDX = (29343, 88863)

    def __init__(self, root: str, transform: Transform, category: str = "", **kw):
        self.exception_idx = self.CAT_EXCEPTION_IDX if category == "cat" else ()
        self.lmdb_env = None
        if os.path.isdir(root) and any(f.endswith(".mdb") for f in os.listdir(root)):
            try:
                import lmdb
            except ImportError as e:
                raise ImportError(
                    "LSUN lmdb databases require the 'lmdb' package (not baked "
                    "into this image); extract to an image folder instead"
                ) from e
            self.lmdb_env = lmdb.open(root, max_readers=128, readonly=True, lock=False, readahead=False,
                                      meminit=False)
            cache_file = os.path.join(root, "_key_cache.pkl")
            if os.path.isfile(cache_file):
                with open(cache_file, "rb") as f:
                    keys = pickle.load(f)
            else:
                with self.lmdb_env.begin(write=False) as txn:
                    keys = [key for key in txn.cursor().iternext(keys=True, values=False)]
                with open(cache_file, "wb") as f:
                    pickle.dump(keys, f)
            items = [(k, 0) for k in keys]
        else:
            items = [(os.path.join(root, fn), 0) for fn in sorted(os.listdir(root))
                     if fn.lower().endswith(IMG_EXTENSIONS)]
        super().__init__(items, transform, **kw)

    def __getitem__(self, index: int):
        if index in self.exception_idx:
            index = index - 1
        return super().__getitem__(index)

    def load_image(self, spec):
        if self.lmdb_env is not None:
            with self.lmdb_env.begin(write=False) as txn:
                return read_image(bytes(txn.get(spec)))
        return super().load_image(spec)


class Subset:
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[self.indices[i]]

    def __getattr__(self, name):
        if name == "dataset":  # unpickling: the attribute is not set yet
            raise AttributeError(name)
        return getattr(self.dataset, name)
