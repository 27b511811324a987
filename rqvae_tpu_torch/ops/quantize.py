"""Residual quantization: config, codebooks, the encode and decode paths.

Port of rqvae_tpu/ops/quantize.py: QuantizerConfig, the codebooks,
compute_distances, find_nearest (through the nearest_code kernel of
ops/rq_kernel.py, or JAX's own argmin of the full distances),
to_code_shape / to_latent_shape, quantize, quantize_train (the EMA
codebook update with code restarts, over the global batch under data
parallelism), rq_bottleneck_forward, embed_lookup,
embed_code, embed_code_with_depth, embed_partial_code and get_soft_codes.

Each codebook is a buffer in the reference layout
(quantizer.codebooks.{d}.weight [n_embed + 1, dim] with a zero padding row,
.cluster_size_ema [n_embed], .embed_ema [n_embed, dim]). A shared codebook
is one module repeated at every depth, so its keys appear once per depth,
as in the reference checkpoints. Distances are fp32 whatever the codebook's
dtype, and never TF32 (ops/rq_kernel.require_fp32_matmul).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch
from torch import nn

from rqvae_tpu_torch import resolve_device
from rqvae_tpu_torch.ops import rq_kernel
from rqvae_tpu_torch.parallel import dist as D


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


def compute_distances(x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances ||x||^2 + ||c||^2 - 2 x.c in fp32: x [..., dim],
    codebook [n_embed, dim] -> [..., n_embed]."""
    rq_kernel.require_fp32_matmul(x, "compute_distances")
    x32, cb32 = x.float(), codebook.float()
    x_sq = x32.square().sum(dim=-1, keepdim=True)
    cb_sq = cb32.square().sum(dim=-1)
    return x_sq + cb_sq - 2.0 * (x32 @ cb32.T)


def find_nearest(x: torch.Tensor, codebook: torch.Tensor, use_kernel: bool = True) -> torch.Tensor:
    """argmin_e ||x - codebook[e]||^2 -> codes (torch.long) of shape
    x.shape[:-1]: the nearest_code kernel, or the argmin of the full
    compute_distances matrix when use_kernel is False."""
    if use_kernel:
        return rq_kernel.nearest_code(x, codebook)
    return torch.argmin(compute_distances(x, codebook), dim=-1)


def to_code_shape(x: torch.Tensor, config: QuantizerConfig) -> torch.Tensor:
    """[B, H, W, D] -> [B, H / rH, W / rW, rH * rW * D] (space-to-depth)."""
    B, H, W, D = x.shape
    rH = config.latent_shape[0] // config.code_shape[0]
    rW = config.latent_shape[1] // config.code_shape[1]
    x = x.reshape(B, H // rH, rH, W // rW, rW, D).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H // rH, W // rW, rH * rW * D)


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


def quantize(
    x: torch.Tensor, quantizer: RQCodebooks, use_kernel: bool = True
) -> tuple[torch.Tensor, torch.Tensor]:
    """Inference residual quantization (no EMA update) of x [B, h, w, dim]
    in code shape: returns (quants_cumsum [depth, B, h, w, dim] fp32, codes
    [B, h, w, depth] torch.long). Depth d quantizes the residual left by
    depths < d with its own codebook."""
    config = quantizer.config
    residual = x.detach().float()
    aggregated = torch.zeros_like(residual)
    quant_list, code_list = [], []
    for d in range(config.depth):
        cb = quantizer.codebook(d)
        code = find_nearest(residual, cb, use_kernel=use_kernel)
        quant = embed_lookup(cb, code)
        residual = residual - quant
        aggregated = aggregated + quant
        quant_list.append(aggregated)
        code_list.append(code)
    return torch.stack(quant_list), torch.stack(code_list, dim=-1)


def restart_candidates(
    vectors: torch.Tensor, n_embed: int, perm: torch.Tensor, uniform: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """The vectors that unused codes restart from, given the random draws:
    vectors [N, dim] (fp32), tiled ceil(n_embed / N) times with
    uniform [N', dim] in [0, 1) times 0.01 / sqrt(dim) added when N <
    n_embed, then the rows perm[:n_embed] of that pool (perm a permutation
    of its rows). JAX _ema_update_one's draw (rqvae_tpu/ops/quantize.py
    :227-236)."""
    n, dim = vectors.shape
    pool = vectors
    if n < n_embed:
        if uniform is None:
            raise ValueError(f"restart_candidates: {n} vectors for {n_embed} codes need the tiling noise")
        std = 0.01 / math.sqrt(dim)
        pool = vectors.repeat(-(-n_embed // n), 1) + uniform * std
    return pool[perm[:n_embed]]


def draw_restart(vectors: torch.Tensor, n_embed: int, generator: torch.Generator) -> torch.Tensor:
    """restart_candidates with the noise and the permutation drawn from
    `generator`: uniform noise for the tiled pool when there are fewer
    vectors than codes, then a permutation of the pool's rows."""
    n = vectors.shape[0]
    uniform = None
    if n < n_embed:
        shape = (-(-n_embed // n) * n, vectors.shape[1])
        uniform = torch.rand(shape, generator=generator, device=vectors.device, dtype=torch.float32)
    perm = torch.randperm(n if uniform is None else uniform.shape[0], generator=generator, device=vectors.device)
    return restart_candidates(vectors, n_embed, perm, uniform)


@torch.no_grad()
def ema_update(
    book: VQEmbedding,
    vectors: torch.Tensor,  # [N, dim] fp32
    idxs: torch.Tensor,  # [N]
    n_embed: int,
    decay: float,
    eps: float,
    candidates: Optional[torch.Tensor],
    dist: Optional[D.DistEnv] = None,
) -> None:
    """One codebook's EMA step, in place (JAX _ema_update_one, the
    reference's _update_buffers / _update_embedding): the codes' hit counts
    and vector sums into cluster_size_ema and embed_ema; with `candidates`
    [n_embed, dim] (restart_unused_codes), every code whose count fell
    below 1 restarts from its candidate with a count of 1; then weight =
    embed_ema over the Laplace-smoothed counts. The counts and sums are
    fp32 index additions (no product, so no TF32); the padding row is not
    written. With `dist`, the counts and sums are summed over the ranks
    first (JAX's psum over axis_name), so every rank takes the global
    batch's step; `candidates` must then be the same on every rank."""
    counts = torch.bincount(idxs, minlength=n_embed).float()
    sums = torch.zeros(n_embed, vectors.shape[1], dtype=torch.float32, device=vectors.device)
    sums.index_add_(0, idxs, vectors)
    D.all_reduce_sum([counts, sums], dist)
    cluster_size = book.cluster_size_ema.float() * decay + counts * (1.0 - decay)
    embed_ema = book.embed_ema.float() * decay + sums * (1.0 - decay)
    if candidates is not None:
        usage = (cluster_size >= 1.0).float()[:, None]
        embed_ema = embed_ema * usage + candidates * (1.0 - usage)
        cluster_size = cluster_size * usage[:, 0] + (1.0 - usage[:, 0])
    n = cluster_size.sum()
    normalized = n * (cluster_size + eps) / (n + n_embed * eps)
    book.weight[:n_embed] = embed_ema / normalized[:, None]
    book.cluster_size_ema.copy_(cluster_size)
    book.embed_ema.copy_(embed_ema)


# draw(depth, vectors [N, dim], n_embed) -> restart candidates [n_embed, dim]
Draw = Callable[[int, torch.Tensor, int], torch.Tensor]


def _candidates(d: int, vectors: torch.Tensor, n_embed: int, draw: Draw, dist: Optional[D.DistEnv]) -> torch.Tensor:
    """Depth d's restart candidates: draw(d, vectors, n_embed), or under
    `dist` rank 0's draw on every rank's vectors in rank order, broadcast
    to the others."""
    if not D.active(dist):
        return draw(d, vectors, n_embed)
    gathered = D.all_gather_cat(vectors, dist)
    if dist.master:
        candidates = draw(d, gathered, n_embed).contiguous()
    else:
        candidates = torch.empty(n_embed, vectors.shape[1], dtype=torch.float32, device=vectors.device)
    return D.broadcast([candidates], dist)[0]


def quantize_train(
    x: torch.Tensor,
    quantizer: RQCodebooks,
    generator: Optional[torch.Generator] = None,
    use_kernel: bool = True,
    draw: Optional[Draw] = None,
    dist: Optional[D.DistEnv] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Training residual quantization of x [B, h, w, dim] with the EMA
    codebook update, in place in the quantizer's buffers: returns
    (quants_cumsum [depth, B, h, w, dim] fp32, codes [B, h, w, depth]).
    At each depth the codes come from the codebook as it stands, the
    quantized value uses it before the update, and the update is written
    before the next depth reads it (a shared codebook is one module at
    every depth, so depth d + 1 reads depth d's write). With
    restart_unused_codes, each depth's candidates come from draw(d,
    vectors, n_embed), by default draw_restart on `generator`.

    With `dist` (data parallelism; x is this rank's share of the global
    batch) the step is the global batch's, as the JAX CLI's sharded step:
    the EMA sums over the ranks, and rank 0 draws the candidates from every
    rank's vectors gathered in rank order, on its own generator, then
    broadcasts them; the other ranks neither draw nor consume their
    generator."""
    config = quantizer.config
    if config.ema and config.restart_unused_codes and draw is None and D.is_master(dist):
        if generator is None:
            raise ValueError("quantize_train with restart_unused_codes needs a torch.Generator or a draw")
        draw = lambda d, vectors, n: draw_restart(vectors, n, generator)  # noqa: E731
    residual = x.detach().float()
    aggregated = torch.zeros_like(residual)
    quant_list, code_list = [], []
    for d in range(config.depth):
        n_embed = config.n_embed[d]
        cb = quantizer.codebook(d)
        code = find_nearest(residual, cb, use_kernel=use_kernel)
        quant = embed_lookup(cb, code)  # a copy, before the update below
        if config.ema:
            vectors = residual.reshape(-1, residual.shape[-1])
            candidates = _candidates(d, vectors, n_embed, draw, dist) if config.restart_unused_codes else None
            ema_update(quantizer.codebooks[d], vectors, code.reshape(-1), n_embed, config.decay[d], config.eps,
                       candidates, dist)
        residual = residual - quant
        aggregated = aggregated + quant
        quant_list.append(aggregated)
        code_list.append(code)
    return torch.stack(quant_list), torch.stack(code_list, dim=-1)


def rq_bottleneck_forward(
    z_e: torch.Tensor,
    quantizer: RQCodebooks,
    training: bool = False,
    use_kernel: bool = True,
    generator: Optional[torch.Generator] = None,
    draw: Optional[Draw] = None,
    dist: Optional[D.DistEnv] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The bottleneck: space-to-depth, residual quantization (with the EMA
    update when `training` and the config has ema, over the ranks of
    `dist`), the commitment loss
    averaged over depths, and the straight-through z_q. z_e [B, H, W, D]
    -> (z_q [B, H, W, D] in z_e's dtype, commitment loss (fp32 scalar),
    codes [B, h, w, depth]). The loss and z_q carry gradients to z_e."""
    config = quantizer.config
    x = to_code_shape(z_e, config)
    if training and config.ema:
        quants, codes = quantize_train(x, quantizer, generator, use_kernel=use_kernel, draw=draw, dist=dist)
    else:
        quants, codes = quantize(x, quantizer, use_kernel=use_kernel)
    commitment_loss = (x[None].float() - quants.detach()).square().mean()
    quants_trunc = to_latent_shape(quants[-1], config)
    z_q = z_e + (quants_trunc.to(z_e.dtype) - z_e).detach()
    return z_q, commitment_loss, codes


def embed_code_with_depth(codes: torch.Tensor, quantizer: RQCodebooks) -> torch.Tensor:
    """codes [..., depth] -> per-depth embeddings [..., depth, dim], not
    summed."""
    config = quantizer.config
    return torch.stack(
        [embed_lookup(quantizer.codebook(d), codes[..., d]) for d in range(config.depth)], dim=-2
    )


def embed_partial_code(
    codes: torch.Tensor, code_idx: int, quantizer: RQCodebooks, decode_type: str = "select"
) -> torch.Tensor:
    """Latent [B, H, W, D] from a subset of depths: depth code_idx alone
    ("select") or the sum of depths 0..code_idx ("add")."""
    embs = embed_code_with_depth(codes, quantizer)
    if decode_type == "select":
        out = embs[..., code_idx, :]
    elif decode_type == "add":
        out = embs[..., : code_idx + 1, :].sum(dim=-2)
    else:
        raise NotImplementedError(decode_type)
    return to_latent_shape(out, quantizer.config)


def get_soft_codes(
    z_e: torch.Tensor,
    quantizer: RQCodebooks,
    temp: float = 1.0,
    stochastic: bool = False,
    generator: torch.Generator | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Soft targets softmax(-dist / temp) [B, h, w, depth, n_embed] and codes
    [B, h, w, depth] for stage-2 training: the argmin of the distances, or
    with `stochastic` a draw from softmax(-dist / temp) by the Gumbel-max
    trick on noise from `generator` (as jax.random.categorical; the two
    frameworks' random bits differ)."""
    if stochastic and generator is None:
        raise ValueError("get_soft_codes(stochastic=True) needs a torch.Generator")
    config = quantizer.config
    residual = to_code_shape(z_e, config).detach().float()
    soft_list, code_list = [], []
    for d in range(config.depth):
        cb = quantizer.codebook(d)
        dist = compute_distances(residual, cb)
        logits = -dist / temp
        soft_list.append(torch.softmax(logits, dim=-1))
        if stochastic:
            noise = torch.empty_like(logits).exponential_(generator=generator)
            code = torch.argmax(logits - noise.log(), dim=-1)  # -log Exp(1) is Gumbel(0, 1)
        else:
            code = torch.argmin(dist, dim=-1)
        residual = residual - embed_lookup(cb, code)
        code_list.append(code)
    return torch.stack(soft_list, dim=-2), torch.stack(code_list, dim=-1)
