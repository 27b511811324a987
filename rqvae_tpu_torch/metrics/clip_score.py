"""CLIP score: cosine(image embedding, text embedding) per image-text pair.

Port of rqvae_tpu/metrics/clip_score.py: `CLIPScorer` (the module, its
config and the BPE tokenizer), `load_clip` and `clip_score`. Weights come
from a local directory (RQVAE_TPU_CLIP_DIR) holding the OpenAI ViT-B-32.pt
(a TorchScript archive) or a HuggingFace openai/clip-vit-base-patch32
checkout (.bin, .pth or .safetensors, read by this module's own reader of
that format), with bpe_simple_vocab_16e6.txt.gz beside them. Without the
published weights no score is comparable to published ones.
`compute_clip_score` scores a directory of samples against a caption set's
texts (data/textimg.py).
"""

from __future__ import annotations

import json
import os
import struct
import zipfile
from typing import Optional

import numpy as np
import torch

from rqvae_tpu_torch.data.clip_tokenizer import SimpleTokenizer
from rqvae_tpu_torch.data.textimg import Cc3mRawTextOnly, CocoRawTextOnly
from rqvae_tpu_torch.metrics import clip_model as C
from rqvae_tpu_torch.metrics.fid import load_samples_from_files, tf32_off, to_nchw


class CLIPScorer:
    """A CLIP module (eval mode, on its device) and its tokenizer."""

    def __init__(self, model: C.CLIP, tokenizer):
        self.model = model
        self.config = model.config
        self.tokenizer = tokenizer

    def tokenize(self, texts) -> np.ndarray:
        """clip.tokenize semantics: [sot] + bpe + [eot], zero-padded to the
        context length; on truncation the last slot stays the eot token (it
        is also the argmax-pooling anchor)."""
        L = self.config.context_length
        self.tokenizer.enable_truncation(L)
        self.tokenizer.enable_padding(L, pad_id=0)
        out = np.zeros((len(texts), L), np.int32)
        for i, t in enumerate(texts):
            ids = self.tokenizer.encode(t).ids
            if ids[L - 1] not in (0, self.tokenizer.eot):
                ids[L - 1] = self.tokenizer.eot
            out[i] = ids
        return out

    @torch.no_grad()
    def __call__(self, pixels01, texts) -> np.ndarray:
        """pixels01: [B, H, W, 3] or [B, 3, H, W] in [0, 1]; texts: list[str] -> [B]."""
        dev = self.model.token_embedding.weight.device
        pixels = C.preprocess_images(to_nchw(pixels01).to(dev), self.config.image_size)
        tokens = torch.from_numpy(self.tokenize(texts)).long().to(dev)
        with tf32_off():
            return C.clip_scores(self.model, pixels, tokens).cpu().numpy()


def load_clip(model_dir: Optional[str] = None, device=None) -> CLIPScorer:
    """The scorer of the checkpoint in `model_dir` or RQVAE_TPU_CLIP_DIR, on
    `device` (CUDA when None)."""
    model_dir = model_dir or os.environ.get("RQVAE_TPU_CLIP_DIR")
    if not model_dir or not os.path.isdir(model_dir):
        raise FileNotFoundError(
            "CLIP weights unavailable. Set RQVAE_TPU_CLIP_DIR to a local ViT-B/32 checkpoint dir: either the "
            "OpenAI ViT-B-32.pt or a HuggingFace openai/clip-vit-base-patch32 checkout (torch weights + the "
            "bpe_simple_vocab_16e6.txt.gz merges file)."
        )
    sd, config = C.convert_torch_clip(_load_state_dict(model_dir))
    vocab = os.path.join(model_dir, "bpe_simple_vocab_16e6.txt.gz")
    tokenizer = SimpleTokenizer(bpe_path=vocab if os.path.exists(vocab) else None)
    return CLIPScorer(C.build_clip(sd, config, device), tokenizer)


_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16, "I64": torch.int64,
    "I32": torch.int32, "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}


def read_safetensors(path: str) -> dict:
    """The tensors of a .safetensors file: an 8-byte little-endian header
    length, a JSON header {name: {dtype, shape, data_offsets}}, then the
    little-endian data."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = f.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, which this reader does not know")
        begin, end = info["data_offsets"]
        dtype = _SAFETENSORS_DTYPES[info["dtype"]]
        flat = torch.frombuffer(bytearray(data[begin:end]), dtype=dtype) if end > begin else torch.empty(0, dtype=dtype)
        out[name] = flat.reshape(info["shape"])
    return out


def _is_torchscript(path: str) -> bool:
    """A TorchScript archive (the published ViT-B-32.pt) holds constants.pkl."""
    if not zipfile.is_zipfile(path):
        return False
    with zipfile.ZipFile(path) as z:
        return any(n.rsplit("/", 1)[-1] == "constants.pkl" for n in z.namelist())


def _load_state_dict(model_dir: str) -> dict:
    for name in sorted(os.listdir(model_dir)):
        path = os.path.join(model_dir, name)
        if name.endswith(".safetensors"):
            return read_safetensors(path)
        if name.endswith((".pt", ".bin", ".pth")):
            if _is_torchscript(path):
                return torch.jit.load(path, map_location="cpu").state_dict()
            obj = torch.load(path, map_location="cpu", weights_only=True)
            if hasattr(obj, "state_dict"):
                obj = obj.state_dict()
            if isinstance(obj, dict) and "state_dict" in obj:
                obj = obj["state_dict"]
            return obj
    raise FileNotFoundError(f"no torch weights (*.pt/*.bin/*.pth/*.safetensors) in {model_dir}")


def clip_score(pixels01, texts, scorer: CLIPScorer) -> np.ndarray:
    """pixels01 in [0, 1] and texts -> per-pair cosine scores (the
    reference's clip_score.py:34-47)."""
    return scorer(pixels01, texts)


def compute_clip_score(
    fake_path: str,
    dataset_name: str = "cc3m",
    dataset_root: Optional[str] = None,
    split: str = "val",
    batch_size: int = 100,
    model_dir: Optional[str] = None,
    device=None,
) -> float:
    """The mean CLIP score of the samples*.pkl under fake_path against the
    first captions of a cc3m / coco split, in order (samples past the
    captions, a sampler's padding, are left out); CLIP on `device` (CUDA
    when None)."""
    scorer = load_clip(model_dir, device=device)
    samples = load_samples_from_files(fake_path)
    if dataset_name == "cc3m":
        txt_dataset = Cc3mRawTextOnly(dataset_root or "data/cc3m", split=split)
    elif dataset_name == "coco":
        txt_dataset = CocoRawTextOnly(dataset_root or "data/coco", split=split)
    else:
        raise ValueError(f"Unsupported dataset: {dataset_name}")
    n = len(txt_dataset)
    if len(samples) < n:
        raise ValueError(f"{fake_path}: {len(samples)} samples for {n} captions")
    scores = [scorer(samples[i : i + batch_size], [txt_dataset[k] for k in range(i, min(i + batch_size, n))])
              for i in range(0, n, batch_size)]
    return float(np.concatenate(scores).mean())
