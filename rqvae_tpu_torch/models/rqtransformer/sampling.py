"""Autoregressive sampling for the RQ-Transformer in PyTorch.

Port of rqvae_tpu/models/rqtransformer/sampling.py: top-k / top-p filters,
the exact and fast draws, per-depth top-k/top-p lists, `sample` and
`forced_logits`. The JAX sampler is one jitted lax.scan; here the position
loop is a Python loop over the same cached steps. `unroll` picks the step,
as the JAX DecodePolicy.unroll does, and None resolves to H*W <= 128:

- unrolled (model.stack_step_unrolled, one (k, v) cache pair per layer,
  updated in place): the class token is prefilled through the body, then
  each of the H*W positions runs the depth head D times (each followed by
  the classifier and a draw) and, except at the last position, one body
  step, in 2 phases of growing cache window;
- stacked (model.stack_step on one [L, B, T, C] KVCache per stack, the JAX
  sampler's "r1 structure" for long code maps): a body cache of
  cond_len + H*W rows and stacked head caches of D rows; every one of the
  H*W positions runs the depth head and then a body step, the last one
  included; no windows, no phases. It runs the bf16/fp32 cache and the
  unfused body only: kv_q8, dense="mega" and attn_wo raise ValueError
  there (JAX drops kv_q8 with a warning and ignores the other two).

In the unrolled form, with `kv_q8` the body cache is int8
(per-layer (kq, ks, vq, vs), rows allocated rounded up to 32 as in JAX);
the head's D-row caches stay in the model dtype. int8 weights come from
the model (RQTransformer.quantize_int8). `dense="mega"` and `attn_wo` select
the fused body-layer paths (model module docstring); they are checked once
per call, and the caches stay as they are: the (k, v) body cache keeps its
exact cond_len + HW - 1 rows, since no kernel here needs aligned rows.
Random draws come from an explicit
torch.Generator (Gumbel-max on the filtered log-probabilities, the same
categorical distribution as jax.random.categorical, not the same numbers).

A model split over a mesh (model.py's tensor parallelism) runs the
unrolled form on its shards: the group comes from the model (JAX finds the
mesh from the parameters' shardings). Its caches are the local [B, T,
C/tp]; the dense products run on F.linear, so no dense kernel launches,
and the body's attention kernels run per shard. The stacked form,
dense="mega" and attn_wo raise ValueError there. The batch is split over
the mesh's data axis: data rank d samples rows d*B/n_data onwards and the
codes (forced_logits' logits) are gathered over the data group, so every
rank returns the whole batch. Each draw takes the uniforms of the whole
batch from the generator and keeps its rows, and every rank of a model
group draws on the same gathered logits: ranks seeded alike return the
same codes, the single process's for the same logits.

Sampling semantics follow the reference sample_from_logits: fp32 cast,
temperature, top-k on logits (keeping ties with the k-th value), NaN guard,
softmax, top-p on probabilities (sorted cumsum shifted right), draw.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from rqvae_tpu_torch.models.rqtransformer.config import TransformerConfig
from rqvae_tpu_torch.models.rqtransformer.model import (
    RQTransformer,
    check_fused_path,
    classifier_apply,
    init_kv_cache,
    init_unrolled_kv_cache,
    init_unrolled_kv_cache_q8,
    stack_step,
    stack_step_unrolled,
)
from rqvae_tpu_torch.ops.quantize import RQCodebooks, embed_lookup
from rqvae_tpu_torch.parallel import dist as pdist

# the position loop runs in 2 phases of growing cache window (the JAX
# sampler's default); the results do not depend on it
N_PHASES = 2


def top_k_logits(logits: torch.Tensor, k: int) -> torch.Tensor:
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, float("-inf"))


def top_p_probs(probs: torch.Tensor, p: float) -> torch.Tensor:
    sorted_probs, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    remove_sorted = sorted_probs.cumsum(dim=-1) >= p
    # keep the first token that crosses p (shift right)
    remove_sorted = torch.cat([torch.zeros_like(remove_sorted[..., :1]), remove_sorted[..., :-1]], dim=-1)
    remove = torch.zeros_like(remove_sorted).scatter(-1, idx, remove_sorted)
    probs = probs.masked_fill(remove, 0.0)
    return probs / probs.sum(dim=-1, keepdim=True)


def _categorical(logits: torch.Tensor, generator: torch.Generator, rows: Optional[tuple] = None) -> torch.Tensor:
    """One draw per row from softmax(logits) by Gumbel-max. With `rows`
    (first, total) the logits are rows first .. of a batch of `total`: the
    uniforms of the whole batch are drawn and these rows' kept."""
    if rows is None:
        u = torch.rand(logits.shape, generator=generator, device=logits.device)
    else:
        first, total = rows
        u = torch.rand((total, *logits.shape[1:]), generator=generator, device=logits.device)
        u = u[first : first + logits.shape[0]]
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    return torch.argmax(logits + gumbel, dim=-1)


def sample_from_logits(
    logits: torch.Tensor,  # [B, V]
    generator: torch.Generator,
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    rows: Optional[tuple] = None,
) -> torch.Tensor:
    """The reference-exact draw (keeps every logit tied with the k-th);
    `rows` as _categorical's."""
    logits = logits.float() / temperature
    if top_k is not None and top_k < logits.shape[-1]:
        logits = top_k_logits(logits, top_k)
    logits = logits.masked_fill(torch.isnan(logits), float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    if top_p is not None:
        probs = top_p_probs(probs, top_p)
    log_probs = torch.where(probs > 0, torch.log(probs.clamp_min(1e-38)), float("-inf"))
    return _categorical(log_probs, generator, rows)


def fast_candidates(
    logits: torch.Tensor, temperature: float, top_k: Optional[int], top_p: Optional[float]
) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The fast path's kept set: (candidate logits with -inf for dropped
    ones, their vocabulary indices or None for the whole vocabulary). The
    top-p filter runs inside the sorted top-k candidates, so no full-vocab
    sort is needed; the kept set equals the exact path's except for exact
    ties at the k-th logit (the exact path keeps ties, this keeps k)."""
    V = logits.shape[-1]
    logits = logits.float() / temperature
    logits = logits.masked_fill(torch.isnan(logits), float("-inf"))
    if top_p is None and (top_k is None or top_k >= V):
        return logits, None
    k = top_k if (top_k is not None and top_k < V) else V
    vals, idx = torch.topk(logits, k, dim=-1)  # sorted descending
    if top_p is not None:
        remove = torch.softmax(vals, dim=-1).cumsum(dim=-1) >= top_p
        remove = torch.cat([torch.zeros_like(remove[..., :1]), remove[..., :-1]], dim=-1)
        vals = vals.masked_fill(remove, float("-inf"))
    return vals, idx


def sample_from_logits_fast(
    logits: torch.Tensor,
    generator: torch.Generator,
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    rows: Optional[tuple] = None,
) -> torch.Tensor:
    """The distribution-identical fast draw (draws in top-k space); `rows`
    as _categorical's."""
    vals, idx = fast_candidates(logits, temperature, top_k, top_p)
    j = _categorical(vals, generator, rows)
    return j if idx is None else idx.gather(-1, j[..., None])[..., 0]


def broadcast_topk_topp(config: TransformerConfig, top_k, top_p):
    """Per-depth top-k / top-p lists from scalar, length-1 or length-D inputs."""
    D = config.depth
    if top_k is None:
        top_k_list = [config.vocab_size[i] for i in range(D)]
    elif isinstance(top_k, int):
        top_k_list = [min(top_k, config.vocab_size[i]) for i in range(D)]
    elif len(top_k) == 1:
        top_k_list = [min(top_k[0], config.vocab_size[i]) for i in range(D)]
    else:
        top_k_list = [min(top_k[i], config.vocab_size[i]) for i in range(D)]

    if top_p is None:
        top_p_list = [None] * D
    elif isinstance(top_p, float):
        top_p_list = [min(top_p, 1.0)] * D
    elif len(top_p) == 1:
        top_p_list = [min(top_p[0], 1.0)] * D
    else:
        top_p_list = [min(top_p[i], 1.0) for i in range(D)]
    return top_k_list, top_p_list


# pick(t, d, logits [b, V]) -> codes [b] for position t, depth d of this
# rank's rows (the batch's data shard)
Pick = Callable[[int, int, torch.Tensor], torch.Tensor]


def resolve_unroll(config: TransformerConfig, unroll: Optional[bool]) -> bool:
    """`unroll`, or when it is None the JAX sampler's rule H*W <= 128."""
    H, W, _ = config.block_size
    return H * W <= 128 if unroll is None else unroll


@torch.no_grad()
def _decode(
    model: RQTransformer,
    batch_size: int,
    pick: Pick,
    cond: Optional[torch.Tensor],
    quantizer: Optional[RQCodebooks],
    kernels: bool,
    kv_q8: bool,
    dense: str,
    attn_wo: bool,
    unroll: Optional[bool],
) -> torch.Tensor:
    """The cached decode loop shared by `sample` and `forced_logits`, over
    `batch_size` rows (cond's, this rank's data shard). Returns codes
    [batch_size, H, W, D] (int64)."""
    config = model.config
    unroll = resolve_unroll(config, unroll)
    tp = model.tp_group is not None
    n_model = 1 if model.mesh is None else model.mesh.n_model
    if tp and not unroll:
        raise ValueError("a tensor-parallel model samples through the unrolled caches (unroll=True); the stacked "
                         "cache is not ported for it")
    if not unroll and (kv_q8 or dense == "mega" or attn_wo):
        raise ValueError("the stacked-cache path (unroll=False) runs the bf16/fp32 KV cache and the unfused "
                         "body layer: not kv_q8, dense='mega' or attn_wo")
    body_blocks = model.body_transformer.blocks
    check_fused_path(dense, attn_wo, kv_q8, len(body_blocks) > 0 and body_blocks[0].int8, tp)
    fused = dict(dense=dense, attn_wo=attn_wo)
    H, W, D = config.block_size
    HW = H * W
    C = config.embed_dim
    B = batch_size
    cond_len = config.block_size_cond
    dtype = model.pos_emb_hw.dtype
    device = model.pos_emb_hw.device
    if (config.input_emb_vqvae or config.head_emb_vqvae) and quantizer is None:
        raise ValueError("this configuration embeds codes through the RQ-VAE codebooks: pass `quantizer`")
    model.fuse_qkv()

    def vq_lookup(d, code):
        return embed_lookup(quantizer.codebook(d), code)

    def body_emb_of_code(d, code):
        """Input-side embedding of one depth's codes -> [B, C]."""
        if config.input_emb_vqvae:
            return F.linear(vq_lookup(d, code), model.input_mlp.weight, model.input_mlp.bias).to(dtype)
        off = 0 if config.shared_tok_emb else int(model.tok_emb.offsets[d])
        return model.tok_emb.weight[code + off].to(dtype)

    def head_row_of_prefix(d, raw_cum, code):
        """Head-context row for depth d + 1 given the codes up to depth d."""
        if config.head_emb_vqvae:
            e = vq_lookup(d, code).float()
            raw_cum = raw_cum + e if config.cumsum_depth_ctx else e
            row = F.linear(raw_cum, model.head_mlp.weight.float(), model.head_mlp.bias.float())
            return raw_cum, row.to(dtype)
        off = 0 if config.shared_tok_emb else int(model.tok_emb.offsets[d])
        return raw_cum, model.tok_emb.weight[code + off].to(dtype)

    if cond is None:
        cond = torch.zeros(B, cond_len, dtype=torch.long, device=device)
    cond = cond.reshape(B, cond_len).to(device)
    conds_emb = (model.cond_emb.weight[cond] + model.pos_emb_cond[:, :cond_len]).to(dtype)

    body, head = model.body_transformer, model.head_transformer
    if unroll:
        t_max = cond_len + HW - 1  # the last position's k/v are never read
        if kv_q8:
            t_alloc = -(-t_max // 32) * 32  # the JAX sampler's int8 row tile; rows >= cur_len are never read
            body_caches = init_unrolled_kv_cache_q8(config.body, B, t_alloc, device, n_model)
        else:
            body_caches = init_unrolled_kv_cache(config.body, B, t_max, dtype, device, n_model)

        def body_step(x, cur_len, window=None):
            return stack_step_unrolled(body, x, body_caches, cur_len, window=window, kernels=kernels, **fused)[0]

        def head_step(row, caches, d):
            return stack_step_unrolled(head, row, caches, d, kernels=kernels)[0]

        def init_head_caches():
            return init_unrolled_kv_cache(config.head, B, D, dtype, device, n_model)

        # phased position loop over the first HW - 1 positions: a phase's
        # steps attend only a prefix `window` of each cache (the rows any of
        # its steps can see); the last position's body step is skipped
        n_steps = HW - 1
        n_phases = min(N_PHASES, max(1, n_steps // 8))
        bounds = [round(n_steps * i / n_phases) for i in range(n_phases + 1)]
        phases = [(s, e, min(t_max, cond_len + e)) for s, e in zip(bounds[:-1], bounds[1:])]
    else:
        body_cache = init_kv_cache(config.body, B, cond_len + HW, dtype, device)

        def body_step(x, cur_len, window=None):
            return stack_step(body, x, body_cache, cur_len, kernels=kernels)[0]

        def head_step(row, cache, d):
            return stack_step(head, row, cache, d, kernels=kernels)[0]

        def init_head_caches():
            return init_kv_cache(config.head, B, D, dtype, device)

        phases = [(0, HW, None)]  # one pass over all HW positions, the last body step included

    spatial_ctx = body_step(conds_emb, 0)[:, -1]
    pos_hw = model.pos_emb_hw[0].to(dtype)
    pos_d = model.pos_emb_d[0].to(dtype)
    raw_dim = quantizer.config.embed_dim if config.head_emb_vqvae else 1

    def depth_sample(t, spatial_ctx):
        """The D codes of position t through the depth head (D-row caches)."""
        raw_cum = torch.zeros(B, raw_dim, dtype=torch.float32, device=device)
        body_sum = torch.zeros(B, C, dtype=dtype, device=device)
        head_caches = init_head_caches()
        row = (spatial_ctx + pos_d[0])[:, None]
        codes_t = []
        for d in range(D):
            h = head_step(row, head_caches, d)
            code_d = pick(t, d, classifier_apply(model, h[:, 0], depth_idx=d))
            codes_t.append(code_d)
            body_sum = body_sum + body_emb_of_code(d, code_d)
            if d < D - 1:
                raw_cum, r = head_row_of_prefix(d, raw_cum, code_d)
                row = (r + pos_d[d + 1])[:, None]
        return torch.stack(codes_t, dim=-1), body_sum

    codes = []
    for s, e, window in phases:
        for t in range(s, e):
            codes_t, body_sum = depth_sample(t, spatial_ctx)
            codes.append(codes_t)
            u = (body_sum + pos_hw[t])[:, None]
            spatial_ctx = body_step(u, cond_len + t, window)[:, 0]
    if unroll:  # the last position needs only its depth codes
        codes_last, _ = depth_sample(HW - 1, spatial_ctx)
        codes.append(codes_last)
    return torch.stack(codes, dim=1).reshape(B, H, W, D)


def sample(
    model: RQTransformer,
    batch_size: int,
    generator: torch.Generator,
    cond: Optional[torch.Tensor] = None,  # [B] or [B, cond_len] class ids
    quantizer: Optional[RQCodebooks] = None,  # the RQ-VAE's codebooks
    temperature: float = 1.0,
    top_k=None,  # int or per-depth list
    top_p=None,  # float or per-depth list
    exact_sample: bool = False,
    kernels: bool = True,
    kv_q8: bool = False,
    dense: str = "auto",
    attn_wo: bool = False,
    unroll: Optional[bool] = None,
) -> torch.Tensor:
    """Sample codes [B, H, W, D] (int64). `exact_sample` selects the
    reference-exact top-k tie semantics over the fast path;
    `kernels=False` runs the plain versions of the kernels (model module
    docstring); `kv_q8` keeps the body's KV cache in int8; `dense="mega"`
    runs each body layer step as one decode_layer_step, `attn_wo` folds
    the body's wo, residual and LN2 into its int8-cache attention (both
    ValueError where they cannot run: model.check_fused_path); `unroll`
    picks the unrolled or the stacked-cache loop (module docstring; None:
    H*W <= 128). A model on a mesh samples its data shard of the batch
    and returns the whole batch (module docstring)."""
    top_k_list, top_p_list = broadcast_topk_topp(model.config, top_k, top_p)
    draw = sample_from_logits if exact_sample else sample_from_logits_fast
    first, b, data_group = data_shard(model, batch_size)
    rows = None if data_group is None else (first, batch_size)

    def pick(t, d, logits):
        return draw(logits, generator, temperature, top_k_list[d], top_p_list[d], rows)

    cond = None if cond is None else cond[first : first + b]
    codes = _decode(model, b, pick, cond, quantizer, kernels, kv_q8, dense, attn_wo, unroll)
    return pdist.group_gather_first(codes, data_group)


def data_shard(model: RQTransformer, batch_size: int) -> tuple[int, int, object]:
    """(first row, rows, data group) of this rank's shard of a batch: the
    whole batch and None without a mesh or with one data rank."""
    mesh = model.mesh
    if mesh is None or mesh.n_data == 1:
        return 0, batch_size, None
    if batch_size % mesh.n_data:
        raise ValueError(f"a batch of {batch_size} does not split over {mesh.n_data} data ranks")
    b = batch_size // mesh.n_data
    return mesh.data_rank * b, b, mesh.data_group


def forced_logits(
    model: RQTransformer,
    forced: torch.Tensor,  # [B, H, W, D] codes
    cond: Optional[torch.Tensor] = None,
    quantizer: Optional[RQCodebooks] = None,
    kernels: bool = True,
    kv_q8: bool = False,
    dense: str = "auto",
    attn_wo: bool = False,
    unroll: Optional[bool] = None,
) -> torch.Tensor:
    """Per-position decode logits [B, H, W, D, Vmax] (fp32) with the codes
    forced to `forced`: the sampler's cached path (`sample`'s options) with
    the draw replaced by the given codes."""
    B, H, W, D = forced.shape
    first, b, data_group = data_shard(model, B)
    forced_flat = forced[first : first + b].reshape(b, H * W, D).to(model.pos_emb_hw.device)
    out = torch.empty(b, H * W, D, model.config.vocab_size_max, dtype=torch.float32, device=forced_flat.device)

    def pick(t, d, logits):
        out[:, t, d] = logits.float()
        return forced_flat[:, t, d]

    cond = None if cond is None else cond[first : first + b]
    _decode(model, b, pick, cond, quantizer, kernels, kv_q8, dense, attn_wo, unroll)
    return pdist.group_gather_first(out, data_group).reshape(B, H, W, D, -1)
