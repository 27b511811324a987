"""Residual quantization: config, codebooks and the code -> embedding path.

Port of the slice of rqvae_tpu/ops/quantize.py that sampling and decoding
use: QuantizerConfig, the codebooks, embed_lookup and embed_code. The
encode side (nearest-code search, EMA updates, code restarts) is not ported
yet; it waits for the nearest_code kernel.

Each codebook is a buffer in the reference layout
(quantizer.codebooks.{d}.weight [n_embed + 1, dim] with a zero padding row,
.cluster_size_ema [n_embed], .embed_ema [n_embed, dim]). A shared codebook
is one module repeated at every depth, so its keys appear once per depth,
as in the reference checkpoints.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from rqvae_tpu_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class QuantizerConfig:
    latent_shape: tuple  # (H, W, D_latent)
    code_shape: tuple  # (h, w, depth)
    n_embed: tuple  # per-depth codebook sizes
    decay: tuple  # per-depth EMA decay
    shared_codebook: bool = False
    restart_unused_codes: bool = True
    ema: bool = True
    eps: float = 1e-5

    @property
    def depth(self) -> int:
        return self.code_shape[2]

    @property
    def embed_dim(self) -> int:
        h_ratio = self.latent_shape[0] // self.code_shape[0]
        w_ratio = self.latent_shape[1] // self.code_shape[1]
        return h_ratio * w_ratio * self.latent_shape[2]

    @property
    def n_codebooks(self) -> int:
        return 1 if self.shared_codebook else self.depth

    def codebook_index(self, d: int) -> int:
        return 0 if self.shared_codebook else d

    @staticmethod
    def create(latent_shape, code_shape, n_embed, decay=0.99, **kw) -> "QuantizerConfig":
        if not (len(code_shape) == len(latent_shape) == 3):
            raise ValueError("incompatible code shape or latent shape")
        if any(y % x != 0 for x, y in zip(code_shape[:2], latent_shape[:2])):
            raise ValueError("incompatible code shape or latent shape")
        depth = code_shape[2]
        if not isinstance(n_embed, (list, tuple)):
            n_embed = [n_embed] * depth
        if not isinstance(decay, (list, tuple)):
            decay = [decay] * depth
        if len(n_embed) != depth or len(decay) != depth:
            raise ValueError("n_embed and decay need one entry per depth")
        if kw.get("shared_codebook") and (len(set(n_embed)) != 1 or len(set(decay)) != 1):
            raise ValueError("a shared codebook needs one n_embed and one decay")
        return QuantizerConfig(
            latent_shape=tuple(latent_shape),
            code_shape=tuple(code_shape),
            n_embed=tuple(n_embed),
            decay=tuple(decay),
            **kw,
        )


class VQEmbedding(nn.Module):
    """One codebook: `weight` [n_embed + 1, dim] (last row the zero padding
    code) and the EMA statistics, all buffers."""

    def __init__(self, n_embed: int, dim: int, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.register_buffer("weight", torch.zeros(n_embed + 1, dim, **fk))
        self.register_buffer("cluster_size_ema", torch.zeros(n_embed, **fk))
        self.register_buffer("embed_ema", torch.zeros(n_embed, dim, **fk))


class RQCodebooks(nn.Module):
    """The quantizer's codebooks (reference key prefix `quantizer.`), built
    on `device`, or on CUDA when it is None (resolve_device)."""

    def __init__(self, config: QuantizerConfig, device=None, dtype=None):
        super().__init__()
        self.config = config
        device = resolve_device(device)
        books = [
            VQEmbedding(config.n_embed[b], config.embed_dim, device, dtype)
            for b in range(config.n_codebooks)
        ]
        self.codebooks = nn.ModuleList(books[config.codebook_index(d)] for d in range(config.depth))

    def codebook(self, d: int) -> torch.Tensor:
        """Depth d's codebook without the padding row: [n_embed[d], dim]."""
        return self.codebooks[d].weight[: self.config.n_embed[d]]

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """N(0, 1) codes (torch nn.Embedding's default), zero padding row."""
        for b in range(self.config.n_codebooks):
            book = self.codebooks[b]
            n = self.config.n_embed[b]
            codes = torch.randn(book.embed_ema.shape, generator=generator, device=book.weight.device)
            book.weight.zero_()
            book.weight[:n] = codes.to(book.weight.dtype)
            book.embed_ema.copy_(codes)
            book.cluster_size_ema.zero_()


def embed_lookup(codebook: torch.Tensor, idxs: torch.Tensor) -> torch.Tensor:
    """codebook [n_embed, dim] rows at idxs; index n_embed is the zero
    padding code."""
    n_embed = codebook.shape[0]
    out = codebook[idxs.clamp(0, n_embed - 1)]
    return out.masked_fill((idxs == n_embed)[..., None], 0.0)


def to_latent_shape(x: torch.Tensor, config: QuantizerConfig) -> torch.Tensor:
    """[B, h, w, rH * rW * D] -> [B, h * rH, w * rW, D] (depth-to-space)."""
    B, h, w, _ = x.shape
    D = config.latent_shape[2]
    rH = config.latent_shape[0] // config.code_shape[0]
    rW = config.latent_shape[1] // config.code_shape[1]
    x = x.reshape(B, h, w, rH, rW, D).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, h * rH, w * rW, D)


def embed_code(codes: torch.Tensor, quantizer: RQCodebooks) -> torch.Tensor:
    """codes [B, h, w, depth] -> latent [B, H, W, D]: the sum over depths of
    each depth's code embedding."""
    config = quantizer.config
    total = None
    for d in range(config.depth):
        e = embed_lookup(quantizer.codebook(d), codes[..., d])
        total = e if total is None else total + e
    return to_latent_shape(total, config)
