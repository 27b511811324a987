"""Text-image datasets: CC-3M and MS-COCO captions.

Port of rqvae_tpu/data/textimg.py (the reference's txtimg_datasets/
cc3m.py:26-98 and coco.py:24-111). Items are (the transformed image, HWC
float32, or the HWC uint8 image without a transform; the token ids,
int32), (0, ids) for the *TextOnly variants, and the raw caption for the
*RawTextOnly ones. Images are read by data/image_io.read_image.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from rqvae_tpu_torch.data.image_io import read_image
from rqvae_tpu_torch.data.tokenizers import create_tokenizer, prepare_tokenizer
from rqvae_tpu_torch.data.transforms import Transform


def _read_list(root: str, split: str) -> list[tuple[str, str]]:
    """{split}_list.txt: tab-separated (image path, caption) rows."""
    items = []
    with open(f"{root}/{split}_list.txt") as f:
        for line in f:
            toks = line.strip().split("\t")
            assert len(toks) == 2
            items.append((toks[0], toks[1]))
    return items


class _Tokenized:
    """The tokenizer of a caption dataset, padded and truncated to context_length."""

    def _init_tokenizer(self, tok_name: str, context_length: int, dropout):
        self.tokenizer = prepare_tokenizer(create_tokenizer(tok_name, lowercase=True, dropout=dropout),
                                           context_length)

    def _encode(self, text: str) -> np.ndarray:
        return np.asarray(self.tokenizer.encode(text).ids, np.int32)


class Cc3m(_Tokenized):
    splits = {"train", "val"}

    def __init__(self, root: str, split: str, tok_name: str, transform: Optional[Transform] = None,
                 context_length: int = 77, dropout=None, seed: int = 0):
        assert split in self.splits
        self.root = root
        self.split = split
        self.transform = transform
        self.seed = seed
        self._init_tokenizer(tok_name, context_length, dropout)
        self.items = [(os.path.join(root, path), text) for path, text in _read_list(root, split)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i: int):
        imgpath, text = self.items[i]
        img = read_image(imgpath)
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, i]))
        if self.transform:
            img = self.transform(img, rng)
        return img, self._encode(text)


class Cc3mTextOnly(Cc3m):
    def __getitem__(self, i: int):
        _, text = self.items[i]
        return 0, self._encode(text)


class Cc3mRawTextOnly:
    def __init__(self, root: str, split: str):
        self.items = [text for _, text in _read_list(root, split)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


class _CocoCaptions:
    """COCO captions (torchvision CocoCaptions over
    annotations/captions_val2014_30K_samples.json): sorted image ids, each
    with its captions in file order."""

    def __init__(self, img_root: str, ann_file: str):
        with open(ann_file) as f:
            ann = json.load(f)
        self.img_root = img_root
        images = {im["id"]: im["file_name"] for im in ann["images"]}
        caps: dict = {}
        for a in ann["annotations"]:
            caps.setdefault(a["image_id"], []).append(a["caption"])
        self.ids = sorted(images.keys())
        self.file_names = images
        self.captions = caps

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, i: int):
        img_id = self.ids[i]
        img = read_image(os.path.join(self.img_root, self.file_names[img_id]))
        return img, self.captions.get(img_id, [""])

    def first_caption(self, i: int) -> str:
        return self.captions.get(self.ids[i], [""])[0]


def _coco_captions(root: str) -> _CocoCaptions:
    return _CocoCaptions(f"{root}/images/val2014", f"{root}/annotations/captions_val2014_30K_samples.json")


class Coco(_Tokenized):
    splits = {"val"}

    def __init__(self, root: str, split: str, tok_name: str, transform: Optional[Transform] = None,
                 context_length: int = 77, dropout=None, seed: int = 0):
        assert split in self.splits
        self.split = split
        self.transform = transform
        self.seed = seed
        self._init_tokenizer(tok_name, context_length, dropout)
        self.dataset = _coco_captions(root)

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, i: int):
        img, texts = self.dataset[i]
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, i]))
        if self.transform:
            img = self.transform(img, rng)
        text = texts[int(rng.integers(0, len(texts)))] if self.split == "train" else texts[0]
        return img, self._encode(text)


class CocoTextOnly(Coco):
    def __getitem__(self, i: int):
        return 0, self._encode(self.dataset.first_caption(i))


class CocoRawTextOnly:
    def __init__(self, root: str, split: str = "val"):
        self.dataset = _coco_captions(root)

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, i):
        return self.dataset.first_caption(i)
