"""Image transforms on HWC uint8 RGB arrays, ending in HWC float32.

Port of rqvae_tpu/data/transforms.py (the reference's torchvision
pipelines: imagenet256x256, ffhq*, LSUN*, and the text-image dalle,
dalle-vqvae, clip and clip-dvae ones) on arrays in place of PIL images.
Each random op makes the JAX function's numpy draws, in the same order,
from the np.random.Generator it is given, so a seed gives the same crops
and flips. Crops read zeros outside the image, as PIL's crop does.

`pil_resize` is PIL's resampling (Resample.c) restated in torch: for each
axis that changes size, horizontal first, the filter's weights over a
support widened by the downscale factor, normalised, rounded to 22-bit
fixed point, applied in integers with a rounding half up, and clipped to
uint8 after each pass. It equals PIL's BILINEAR and BICUBIC resize of an
8-bit image; the CLIP preprocessing (metrics/clip_model.py) uses it too.

Pipelines end with to_array (float32 in [0, 1]) and a rescale to [-1, 1]
(or DALL-E's 0.1 + 0.8 x); default_collate (data/loader.py) stacks the
HWC items into an NCHW batch.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

PRECISION_BITS = 32 - 8 - 2


def _bilinear(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


RESAMPLE_FILTERS = {"bilinear": (_bilinear, 1.0), "bicubic": (_bicubic, 2.0)}


def resample_coeffs(in_size: int, out_size: int, resample: str = "bilinear") -> tuple[np.ndarray, np.ndarray]:
    """(index [out, k], fixed-point weight [out, k]) of one axis: PIL's
    precompute_coeffs and normalize_coeffs_8bpp in float64, with the
    window's unused taps at weight 0 and a clamped index."""
    fn, base_support = RESAMPLE_FILTERS[resample]
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = base_support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)  # C's (int) cast truncates
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size) - xmin
    taps = np.arange(ksize)
    w = fn(((taps[None, :] + xmin[:, None]) - center[:, None] + 0.5) * (1.0 / filterscale))
    w = np.where(taps[None, :] < xmax[:, None], w, 0.0)
    ww = np.add.accumulate(w, axis=1)[:, -1]  # summed in tap order, as the C loop
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None], w)
    fixed = np.where(w < 0, -0.5 + w * (1 << PRECISION_BITS), 0.5 + w * (1 << PRECISION_BITS))
    index = np.minimum(taps[None, :] + xmin[:, None], in_size - 1)
    return index, np.trunc(fixed).astype(np.int64)


def _resample_axis(x: torch.Tensor, dim: int, out_size: int, resample: str) -> torch.Tensor:
    index, weight = resample_coeffs(x.shape[dim], out_size, resample)
    index = torch.from_numpy(index).to(x.device)
    weight = torch.from_numpy(weight).to(x.device)
    src = x.movedim(dim, -1)
    acc = torch.full((*src.shape[:-1], out_size), 1 << (PRECISION_BITS - 1), dtype=torch.int64, device=x.device)
    for k in range(index.shape[1]):
        acc += src.index_select(-1, index[:, k]) * weight[:, k]
    return (acc >> PRECISION_BITS).clamp_(0, 255).movedim(-1, dim)


def pil_resize(x: torch.Tensor, size: tuple[int, int], resample: str = "bilinear") -> torch.Tensor:
    """[..., H, W] uint8 values (any dtype holding integers) -> [..., h, w]
    resampled as PIL's Image.resize((w, h), resample) of an 8-bit image,
    in x's dtype, on x's device."""
    h, w = size
    y = x.to(torch.int64)
    if w != x.shape[-1]:
        y = _resample_axis(y, -1, w, resample)
    if h != x.shape[-2]:
        y = _resample_axis(y, -2, h, resample)
    return y.to(x.dtype)


# ---- primitive ops on [H, W, 3] uint8 arrays (PIL / torchvision semantics) ----


def _resize(img: np.ndarray, h: int, w: int) -> np.ndarray:
    if (h, w) == img.shape[:2]:
        return img
    t = torch.from_numpy(np.require(img, requirements=["C", "W"])).permute(2, 0, 1)
    return pil_resize(t, (h, w), "bilinear").permute(1, 2, 0).contiguous().numpy()


def crop(img: np.ndarray, left: int, top: int, right: int, bottom: int) -> np.ndarray:
    """PIL's crop((left, top, right, bottom)): zeros outside the image."""
    h, w = img.shape[:2]
    out = np.zeros((bottom - top, right - left) + img.shape[2:], img.dtype)
    y0, y1, x0, x1 = max(top, 0), min(bottom, h), max(left, 0), min(right, w)
    if y1 > y0 and x1 > x0:
        out[y0 - top : y1 - top, x0 - left : x1 - left] = img[y0:y1, x0:x1]
    return out


def resize_shorter(img: np.ndarray, size: int) -> np.ndarray:
    """torchvision Resize(int): shorter side -> size, keep aspect."""
    h, w = img.shape[:2]
    if (w <= h and w == size) or (h <= w and h == size):
        return img
    if w < h:
        return _resize(img, max(1, round(size * h / w)), size)
    return _resize(img, size, max(1, round(size * w / h)))


def resize_exact(img: np.ndarray, size: tuple) -> np.ndarray:
    """size: (h, w)."""
    return _resize(img, size[0], size[1])


def center_crop(img: np.ndarray, size: int) -> np.ndarray:
    h, w = img.shape[:2]
    left = int(round((w - size) / 2.0))
    top = int(round((h - size) / 2.0))
    return crop(img, left, top, left + size, top + size)


def random_crop(img: np.ndarray, size: int, rng: np.random.Generator) -> np.ndarray:
    h, w = img.shape[:2]
    if w == size and h == size:
        return img
    top = int(rng.integers(0, h - size + 1))
    left = int(rng.integers(0, w - size + 1))
    return crop(img, left, top, left + size, top + size)


def random_hflip(img: np.ndarray, rng: np.random.Generator, p=0.5) -> np.ndarray:
    if rng.random() < p:
        return img[:, ::-1]
    return img


def random_resized_crop(img: np.ndarray, size: int, rng: np.random.Generator, scale=(0.08, 1.0),
                        ratio=(3 / 4, 4 / 3)) -> np.ndarray:
    """torchvision RandomResizedCrop: 10 area/ratio tries, center fallback."""
    h, w = img.shape[:2]
    area = w * h
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        aspect = math.exp(rng.uniform(log_ratio[0], log_ratio[1]))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            top = int(rng.integers(0, h - ch + 1))
            left = int(rng.integers(0, w - cw + 1))
            return _resize(crop(img, left, top, left + cw, top + ch), size, size)
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        cw, ch = int(round(h * ratio[1])), h
    else:
        cw, ch = w, h
    left, top = (w - cw) // 2, (h - ch) // 2
    return _resize(crop(img, left, top, left + cw, top + ch), size, size)


def augmentation_dalle(img: np.ndarray, size: int, rng: np.random.Generator) -> np.ndarray:
    """Off-center square crop + random resize (the reference's
    txtimg_datasets/transforms.py:26-48)."""
    h, w = img.shape[:2]
    s_min = min(w, h)
    off_h = int(rng.integers(3 * (h - s_min) // 8, max(3 * (h - s_min) // 8 + 1, 5 * (h - s_min) // 8)))
    off_w = int(rng.integers(3 * (w - s_min) // 8, max(3 * (w - s_min) // 8 + 1, 5 * (w - s_min) // 8)))
    img = crop(img, off_w, off_h, off_w + s_min, off_h + s_min)
    t_max = max(min(s_min, round(9 / 8 * size)), size)
    t = int(rng.integers(size, t_max + 1))
    return _resize(img, t, t)


def to_array(img: np.ndarray) -> np.ndarray:
    return np.asarray(img, dtype=np.float32) / 255.0  # HWC [0, 1]


def normalize_pm1(arr: np.ndarray) -> np.ndarray:
    return arr * 2.0 - 1.0


def rescale_dalle(arr: np.ndarray) -> np.ndarray:
    """(1 - 2*0.1) * x + 0.1 (the reference's Rescale)."""
    return 0.8 * arr + 0.1


# ---- pipeline factory ----------------------------------------------------------


class Transform:
    """A composed transform: (HWC uint8 array, rng) -> HWC float32 array."""

    def __init__(self, fn: Callable, out_size: int):
        self.fn = fn
        self.out_size = out_size

    def __call__(self, img: np.ndarray, rng: Optional[np.random.Generator] = None):
        rng = rng if rng is not None else np.random.default_rng()
        return self.fn(img, rng)


def create_transforms(config, split: str = "train", is_eval: bool = False) -> Transform:
    """The image datasets' pipelines (the reference's img_datasets/transforms.py:17-66)."""
    ttype = config["transforms"]["type"]
    train = split == "train" and not is_eval

    if ttype == "imagenet256x256":
        if train:
            def fn(img, rng):
                img = resize_shorter(img, 256)
                img = random_crop(img, 256, rng)
                img = random_hflip(img, rng)
                return normalize_pm1(to_array(img))
        else:
            def fn(img, rng):
                img = resize_shorter(img, 256)
                img = center_crop(img, 256)
                img = resize_exact(img, (256, 256))
                return normalize_pm1(to_array(img))
        return Transform(fn, 256)

    if "ffhq" in ttype:
        resolution = int(ttype.split("_")[0].split("x")[-1])
        if train:
            def fn(img, rng):
                img = random_resized_crop(img, resolution, rng, scale=(0.75, 1.0), ratio=(1.0, 1.0))
                img = random_hflip(img, rng)
                return normalize_pm1(to_array(img))
        else:
            def fn(img, rng):
                img = resize_shorter(img, resolution)
                img = center_crop(img, resolution)
                return normalize_pm1(to_array(img))
        return Transform(fn, resolution)

    if ttype in ("LSUN", "LSUN-cat", "LSUN-church", "LSUN-bedroom"):
        def fn(img, rng):
            img = resize_shorter(img, 256)
            img = center_crop(img, 256)
            return normalize_pm1(to_array(img))

        return Transform(fn, 256)

    if ttype in ("none", None):
        return Transform(lambda img, rng: normalize_pm1(to_array(img)), -1)

    raise NotImplementedError(f"{ttype} not implemented..")


def create_txtimg_transforms(config, split: str = "train", is_eval: bool = False) -> Transform:
    """The text-image datasets' pipelines (the reference's txtimg_datasets/transforms.py:60-123)."""
    ttype = config["transforms"]
    res = config["image_resolution"]
    train = split == "train" and not is_eval

    def build(aug_train, final):
        if train:
            def fn(img, rng):
                return final(to_array(aug_train(img, rng)))
        else:
            def fn(img, rng):
                return final(to_array(resize_exact(img, (res, res))))
        return Transform(fn, res)

    def dalle_crop(img, rng):
        return random_crop(augmentation_dalle(img, res, rng), res, rng)

    def clip_crop(img, rng):
        return random_resized_crop(resize_exact(img, (res, res)), res, rng, scale=(0.8, 1.0))

    if ttype == "dalle":
        return build(dalle_crop, rescale_dalle)
    if ttype == "dalle-vqvae":
        return build(dalle_crop, normalize_pm1)
    if ttype == "clip":
        return build(clip_crop, normalize_pm1)
    if ttype == "clip-dvae":
        return build(clip_crop, rescale_dalle)
    if ttype in ("none", None):
        return Transform(lambda img, rng: normalize_pm1(to_array(img)), res)
    raise NotImplementedError(f"{ttype} not implemented..")
