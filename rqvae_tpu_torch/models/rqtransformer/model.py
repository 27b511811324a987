"""RQ-Transformer in PyTorch: the spatial "body" transformer over H*W
positions and the depth "head" transformer over D residual levels.

Port of the cached-decode slice of rqvae_tpu/models/rqtransformer/model.py:
the N(0, 0.02) init, one-pass LayerNorm, exact-erf gelu, the transformer
blocks, tok_emb_offsets, classifier_apply, int8 weight-only quantization
(quantize_transformer_params, _mm), init_unrolled_kv_cache / _q8 and
stack_step_unrolled for the bf16/fp32 cache and the int8 cache (S == 1
decode and S > 1 prefill), and the stacked-cache form that the sampler runs
beyond 128 positions: KVCache / init_kv_cache (k, v each [n_layer, B, T, C])
and stack_step. Module names follow the reference state_dict
({body,head}_transformer.blocks.{i}.{ln1,ln2,attn.{query,key,value,proj},
mlp.{0,2}}, ...), so reference checkpoints and the JAX export load with
strict=True.

int8 weights live in non-persistent buffers beside the float weights
(RQTransformer.quantize_int8 / load_int8): per block wqkv_q / wo_q / w1_q /
w2_q int8 [out, in] with bf16 scales *_s [out], and the classifier's
weight_q / weight_s. The state_dict keeps the reference layout either way.

Kernel dispatch is one fixed rule, with no environment knobs (the JAX
package's DecodePolicy / resolve_* tables were tuned for the TPU v5e):
  - a body S == 1 step runs its attention through the decode attention
    kernel (ops/attention_kernel.py: decode_attention_update for (k, v)
    caches, decode_attention_q8_update for int8 caches, the read-only
    decode_attention_stacked on layer l of a stacked cache in stack_step),
    and its dense half as torch.matmul for float weights; with int8 weights
    stack_step_unrolled runs it through the two int8 dense kernels
    (ops/decode_layer_kernel.py: fused_ln_qkv_q8, fused_proj_mlp_q8; the
    JAX route dense="pallas"), stack_step through the plain _mm (no
    operating point runs int8 weights on the stacked path);
  - with dense="mega" (DecodePolicy.dense; (k, v) caches and float weights
    only) a body S == 1 step is one decode_layer_step per layer
    (ops/decode_megakernel.py): the whole layer in one kernel;
  - with attn_wo=True (DecodePolicy.attn_wo; int8 caches only) a body
    S == 1 step runs its QKV half as above (fused_ln_qkv_q8 for int8
    weights, torch.matmul for float ones), decode_attention_q8_update_wo
    per layer (the q8 attention with wo, the residual and LN2 folded in),
    then the MLP alone as torch.matmul (the plain _mm for int8 weights: no
    kernel computes the MLP without wo and LN2);
  - a head S == 1 step runs its dense half through the two dense kernels
    (ops/decode_layer_kernel.py; the _q8 pair when the block's weights are
    int8); its attention over <= D cache rows stays plain;
  - everything else (the S > 1 prefill) is plain PyTorch; with an int8
    cache it dequantizes the past rows and quantizes the new ones.
Where the JAX package quietly runs its unfused path (dense="mega" with an
int8 cache or int8 weights, attn_wo without an int8 cache), the port
raises ValueError. `kernels=False` swaps every kernel for its plain version
(the same path on the same device), which is how the card compares the
two paths.

Tensor parallelism (the JAX package's Megatron split under a mesh, model
_pallas_attn_sharded / _pallas_attn_q8_sharded and the psum after wo and
w2): an RQTransformer built with a parallel/mesh.py Mesh of n_model > 1
holds model rank m's slice of every tensor that mesh.transformer_param_specs
splits, under the unsharded model's state_dict keys
(mesh.shard_state_dict makes it from the full one). Each block keeps its
head group, n_head / n_model heads: query, key, value and the first MLP
projection split by output features (so the fused wqkv is [3C/tp, C]),
proj and the second MLP projection by input features, their products
summed over the model group before the replicated bias and the residual
(dist.group_sum); the classifiers split by vocabulary, their logit slices
gathered (dist.group_gather_last) before the mask and the draw. The caches
are the local [B, T, C/tp] (int8 scales [B, T, n_head/tp]), so a body
S == 1 step runs the same attention kernels per shard. Dense runs on
F.linear (_mm for int8 weights) in both stacks, as JAX's sampler pins
dense to XLA under a mesh (_tp_safe_policy); dense="mega" and attn_wo
raise ValueError (JAX drops them without a word), and so do the stacked
cache (stack_step) and the teacher-forced forward, which are not ported
for a split model.

The training half is the teacher-forced `forward` (RQTransformer.forward):
the embeddings (tuple_tok_emb, input_embed, head_embed), `stack_forward`
over the body and the head with causal attention in fp32 scores and
softmax, the classifier (classifier_apply) and, with a condition longer
than one token, the cond classifier; then the losses
(soft_target_cross_entropy, cross_entropy, compute_loss,
compute_cond_loss, compute_codebook_loss) with the log-softmax in fp32.
It reads the separate query / key / value weights, never the derived
wqkv or int8 buffers, and is plain PyTorch throughout: the JAX training
path reaches no Pallas kernel. `remat` recomputes each layer's
activations in the backward pass (torch.utils.checkpoint). Dropout masks
come from an explicit torch.Generator: the same distribution as JAX's
jax.random.bernoulli, not the same bits; under `remat` the generator's
state is saved before each layer and set again for its recompute, so the
recomputed masks are the forward's.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from rqvae_tpu_torch import resolve_device
from rqvae_tpu_torch.models.rqtransformer.config import StackConfig, TransformerConfig
from rqvae_tpu_torch.ops import attention_kernel as AK
from rqvae_tpu_torch.ops import decode_layer_kernel as DK
from rqvae_tpu_torch.ops import decode_megakernel as MK
from rqvae_tpu_torch.parallel import dist as pdist
from rqvae_tpu_torch.parallel.mesh import param_spec

LN_EPS = 1e-5  # torch nn.LayerNorm default


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """LayerNorm with one-pass fp32 statistics (mean and E[x^2]), cast back
    to x's dtype, as rqvae_tpu's model.layer_norm."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = ((x32 * x32).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
    y = (x32 - mean) * torch.rsqrt(var + LN_EPS)
    return (y * weight + bias).to(x.dtype)


def gelu(x: torch.Tensor, version: str) -> torch.Tensor:
    if version == "v1":
        return F.gelu(x)  # exact erf
    return x * torch.sigmoid(1.702 * x)


def tok_emb_offsets(config: TransformerConfig) -> np.ndarray:
    return np.cumsum([0] + list(config.vocab_size[:-1])).astype(np.int64)


def quantize_weight(w: torch.Tensor, in_dim: int = -1, group=None) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 weight-only quantization with one scale per output channel, as
    the JAX _quantize_weight: scale = max(amax over the input dim, 1e-8) /
    127 in fp32, q = clip(round(w / scale), -127, 127) with the fp32 scale
    (half to even). Returns (q int8 of w's shape, scale bf16 without the
    input dim). `in_dim` is -1 for nn.Linear [out, in], -2 for [.., in, out].
    For a weight split by input features over the model group `group`, the
    amax is the group's maximum: the unsharded weight's scale."""
    w32 = w.detach().float()
    amax = w32.abs().amax(dim=in_dim, keepdim=True)
    if group is not None:
        torch.distributed.all_reduce(amax, op=torch.distributed.ReduceOp.MAX, group=group)
    amax = amax.clamp_min(1e-8)
    scale = amax / torch.full_like(amax, 127.0)
    q = torch.round(w32 / scale).clamp(-127, 127).to(torch.int8)
    return q, scale.squeeze(in_dim).to(torch.bfloat16)


def _mm(h: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """h @ w for an int8 weight q [out, in] with scales [out]: the JAX
    _mm, (h @ q.astype(h.dtype)) * scale.astype(h.dtype)."""
    return F.linear(h, q.to(h.dtype)) * scale.to(h.dtype)


class Attention(nn.Module):
    """The four projections; split over n_model ranks, query / key / value
    hold C / n_model output features and proj as many input features."""

    def __init__(self, C: int, fk, n_model: int = 1):
        super().__init__()
        self.query = nn.Linear(C, C // n_model, **fk)
        self.key = nn.Linear(C, C // n_model, **fk)
        self.value = nn.Linear(C, C // n_model, **fk)
        self.proj = nn.Linear(C // n_model, C, **fk)


INT8_WEIGHTS = ("wqkv", "wo", "w1", "w2")  # a block's int8 buffers: {name}_q, {name}_s


class Block(nn.Module):
    """One transformer layer's weights. `wqkv` / `bqkv` are the fused
    [3C, C] / [3C] query-key-value projection: derived, non-persistent
    buffers (the state_dict keeps the reference layout), rebuilt by
    `fuse_qkv`. The int8 buffers {wqkv,wo,w1,w2}_{q,s} are None until
    RQTransformer.quantize_int8 or load_int8 sets them. Split over n_model
    ranks (module docstring), the block holds its slice of each."""

    def __init__(self, cfg: StackConfig, fk, n_model: int = 1):
        super().__init__()
        C, H = cfg.embed_dim, 4 * cfg.embed_dim // n_model
        self.ln1 = nn.LayerNorm(C, eps=LN_EPS, **fk)
        self.ln2 = nn.LayerNorm(C, eps=LN_EPS, **fk)
        self.attn = Attention(C, fk, n_model)
        self.mlp = nn.Sequential(nn.Linear(C, H, **fk), nn.GELU(), nn.Linear(H, C, **fk))
        self.register_buffer("wqkv", None, persistent=False)
        self.register_buffer("bqkv", None, persistent=False)
        for name in INT8_WEIGHTS:
            self.register_buffer(f"{name}_q", None, persistent=False)
            self.register_buffer(f"{name}_s", None, persistent=False)

    @property
    def int8(self) -> bool:
        return self.wqkv_q is not None

    def float_weights(self) -> dict:
        """The [out, in] float weights that the int8 buffers quantize."""
        return {"wqkv": self.wqkv, "wo": self.attn.proj.weight, "w1": self.mlp[0].weight,
                "w2": self.mlp[2].weight}

    @torch.no_grad()
    def fuse_qkv(self) -> None:
        a = self.attn
        self.wqkv = torch.cat([a.query.weight, a.key.weight, a.value.weight]).contiguous()
        self.bqkv = torch.cat([a.query.bias, a.key.bias, a.value.bias]).contiguous()


class Stack(nn.Module):
    """The body or the head stack; `role` selects its kernels (module doc).
    `n_head` and `width` are this rank's heads and cache width (the whole
    stack's without a model group), `group` the model group or None."""

    def __init__(self, cfg: StackConfig, role: str, fk, n_model: int = 1, group=None):
        super().__init__()
        if role not in ("body", "head"):
            raise ValueError(f"unknown stack role {role!r}")
        self.cfg = cfg
        self.role = role
        self.n_head = cfg.n_head // n_model
        self.width = cfg.embed_dim // n_model
        self.group = group
        self.blocks = nn.ModuleList(Block(cfg, fk, n_model) for _ in range(cfg.n_layer))


class Classifier(nn.Module):
    """LayerNorm + a shared nn.Linear, or per-depth weights [D, C, V]. With
    int8 weights, weight_q has the weight's layout and weight_s [V] or
    [D, V] holds the per-output scales. Split over n_model ranks, it holds
    V / n_model of the vocabulary."""

    def __init__(self, config: TransformerConfig, fk, n_model: int = 1):
        super().__init__()
        C = config.embed_dim
        self.register_buffer("weight_q", None, persistent=False)
        self.register_buffer("weight_s", None, persistent=False)
        self.layer_norm = nn.LayerNorm(C, eps=LN_EPS, **fk)
        if config.shared_cls_emb:
            self.linear = nn.Linear(C, config.vocab_size[0] // n_model, **fk)
        else:
            self.linear = nn.Module()
            D, V = config.depth, config.vocab_size_max // n_model
            self.linear.weight = nn.Parameter(torch.empty(D, C, V, **fk))
            self.linear.bias = nn.Parameter(torch.empty(D, V, **fk))


def check_tensor_parallel(config: TransformerConfig, n_model: int) -> None:
    """Raise ValueError unless n_model splits the model: the width, each
    stack's heads, the vocabulary and (with a condition longer than one
    token) the condition's vocabulary."""
    sizes = {"embed_dim": config.embed_dim, "body n_head": config.body.n_head, "head n_head": config.head.n_head,
             "vocab_size": config.vocab_size_max}
    if config.block_size_cond > 1:
        sizes["vocab_size_cond"] = config.vocab_size_cond
    bad = {k: v for k, v in sizes.items() if v % n_model}
    if bad:
        raise ValueError(f"tensor parallelism over {n_model} ranks splits each of {sorted(sizes)}: "
                         f"{n_model} does not divide {bad}")


class RQTransformer(nn.Module):
    """Built on `device`, or on CUDA when it is None (resolve_device). With
    a parallel/mesh.py Mesh of n_model > 1 it holds this rank's slice of
    the model (module docstring); `mesh` is kept as the model's."""

    def __init__(self, config: TransformerConfig, device=None, dtype=None, mesh=None):
        super().__init__()
        device = resolve_device(device)
        fk = dict(device=device, dtype=dtype)
        C, D = config.embed_dim, config.depth
        n_model = 1 if mesh is None else mesh.n_model
        check_tensor_parallel(config, n_model)
        group = None if mesh is None else mesh.model_group
        self.config = config
        self.mesh = mesh
        self.cond_emb = nn.Embedding(config.vocab_size_cond, C, **fk)
        self.pos_emb_cond = nn.Parameter(torch.empty(1, config.block_size_cond, C, **fk))
        self.pos_emb_hw = nn.Parameter(torch.empty(1, config.hw, C, **fk))
        self.pos_emb_d = nn.Parameter(torch.empty(1, D, C, **fk))
        self.body_transformer = Stack(config.body, "body", fk, n_model, group)
        self.head_transformer = Stack(config.head, "head", fk, n_model, group)
        if config.input_emb_vqvae:
            self.input_mlp = nn.Linear(config.input_embed_dim, C, **fk)
        if config.head_emb_vqvae:
            self.head_mlp = nn.Linear(config.input_embed_dim, C, **fk)
        if not (config.input_emb_vqvae and config.head_emb_vqvae):
            if config.shared_tok_emb:
                self.tok_emb = nn.Embedding(config.vocab_size[0], C, **fk)
            else:
                # one table for all depths, indexed with per-depth offsets
                self.tok_emb = nn.Embedding(sum(config.vocab_size), C, **fk)
                self.tok_emb.register_buffer(
                    "offsets", torch.as_tensor(tok_emb_offsets(config), device=device)
                )
        self.classifier = Classifier(config, fk, n_model)
        if config.block_size_cond > 1:
            self.cond_classifier = nn.Module()
            self.cond_classifier.layer_norm = nn.LayerNorm(C, eps=LN_EPS, **fk)
            self.cond_classifier.linear = nn.Linear(C, config.vocab_size_cond // n_model, **fk)
        # new float weights make the int8 buffers stale: drop them
        self.register_load_state_dict_post_hook(lambda module, _: module.clear_int8())

    @property
    def tp_group(self):
        """The model group this model is split over, or None."""
        return self.body_transformer.group

    def forward(self, xs, cond=None, xs_emb=None, generator=None, deterministic=True, remat=False):
        """The teacher-forced forward: the module-level `forward`."""
        return forward(self, xs, cond, xs_emb, generator, deterministic, remat)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator, split_generator: torch.Generator | None = None) -> None:
        """GPT-style init from `generator`: N(0, 0.02) for every weight matrix,
        embedding and position table; zero biases; unit LayerNorm scales.
        The tensors that a model group splits draw from `split_generator`
        when it is given (a generator seeded per rank; the replicated ones
        then draw alike on every rank from `generator`)."""
        ln_scales = {id(m.weight) for m in self.modules() if isinstance(m, nn.LayerNorm)}
        for name, p in self.named_parameters():
            if id(p) in ln_scales:
                p.fill_(1.0)
            elif name.endswith("bias"):
                p.zero_()
            else:
                split = split_generator is not None and param_spec(name, p.dim()) is not None
                gen = split_generator if split else generator
                p.copy_(torch.randn(p.shape, generator=gen, device=p.device) * 0.02)
        self.fuse_qkv()
        self.clear_int8()

    def fuse_qkv(self) -> None:
        """Rebuild every block's fused QKV buffers from the current weights
        (after loading a state_dict or changing dtype/device)."""
        for stack in (self.body_transformer, self.head_transformer):
            for blk in stack.blocks:
                blk.fuse_qkv()

    @torch.no_grad()
    def quantize_int8(self) -> None:
        """int8 weight-only quantization of the decode-heavy weights, as the
        JAX quantize_transformer_params: every block's wqkv, wo, w1 and w2
        and the classifier projection (quantize_weight). Embeddings, norms,
        biases and the embedding MLPs stay as they are. Quantizing the
        fused [3C, C] wqkv equals quantizing wq, wk, wv apart: the scales
        are per output channel. The buffers are a snapshot of the float
        weights, which stay beside them: load_state_dict and init_weights
        drop them; after changing weights in place, quantize again. A split
        model quantizes its slices with the unsharded model's scales, as
        JAX's quantize_transformer_params of sharded parameters does (GSPMD
        takes the amax of wo and w2 over the whole input dim), so each rank
        holds its slice of the unsharded model's int8 weights."""
        self.fuse_qkv()
        buffers = {}
        for sname in ("body_transformer", "head_transformer"):
            for i, blk in enumerate(getattr(self, sname).blocks):
                for name, w in blk.float_weights().items():
                    q, scale = quantize_weight(w, group=self.tp_group if name in ("wo", "w2") else None)
                    buffers[f"{sname}.blocks.{i}.{name}_q"] = q
                    buffers[f"{sname}.blocks.{i}.{name}_s"] = scale
        q, scale = quantize_weight(self.classifier.linear.weight, -1 if self.config.shared_cls_emb else -2)
        buffers["classifier.weight_q"], buffers["classifier.weight_s"] = q, scale
        self.load_int8(buffers)

    def _int8_slots(self) -> dict:
        """{buffer name: (module, attribute)} of every int8 buffer slot."""
        return {
            f"{prefix}.{b}" if prefix else b: (mod, b)
            for prefix, mod in self.named_modules()
            for b in mod._buffers
            if b.endswith(("_q", "_s"))
        }

    def load_int8(self, buffers: dict) -> None:
        """Set the int8 buffers from {buffer name: tensor or array}, under the
        names quantize_int8 uses (checkpoint/from_jax.rqtransformer_int8_from_jax
        maps a quantized JAX tree to them). Every buffer must be given."""
        slots = self._int8_slots()
        if set(buffers) != set(slots):
            raise ValueError(f"load_int8: expected buffers {sorted(slots)}, got {sorted(buffers)}")
        device = self.pos_emb_hw.device
        for name, value in buffers.items():
            mod, attr = slots[name]
            dtype = torch.int8 if attr.endswith("_q") else torch.bfloat16
            setattr(mod, attr, torch.as_tensor(value).to(device=device, dtype=dtype).contiguous())

    def clear_int8(self) -> None:
        """Drop the int8 buffers: the model runs on its float weights again."""
        for mod, attr in self._int8_slots().values():
            setattr(mod, attr, None)


def init_unrolled_kv_cache(cfg: StackConfig, batch: int, t_max: int, dtype, device, n_model: int = 1):
    """Per-layer (k, v) caches, each [batch, t_max, C / n_model], zeroed."""
    shape = (batch, t_max, cfg.embed_dim // n_model)
    return [
        (torch.zeros(shape, dtype=dtype, device=device), torch.zeros(shape, dtype=dtype, device=device))
        for _ in range(cfg.n_layer)
    ]


def init_unrolled_kv_cache_q8(cfg: StackConfig, batch: int, t_max: int, device, n_model: int = 1):
    """Per-layer int8 caches (kq, ks, vq, vs), zeroed: values int8
    [batch, t_max, C / n_model], per-(row, head) scales bf16 [batch, t_max,
    n_head / n_model]."""
    shape = (batch, t_max, cfg.embed_dim // n_model)
    sshape = (batch, t_max, cfg.n_head // n_model)

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    return [
        (z(shape, torch.int8), z(sshape, torch.bfloat16), z(shape, torch.int8), z(sshape, torch.bfloat16))
        for _ in range(cfg.n_layer)
    ]


def _attention_prefill(q, k, v, k_past, v_past, n_head):
    """S > 1 rows: causal attention over the past rows plus the new chunk,
    fp32 scores and softmax (stack_step_unrolled's S > 1 branch)."""
    B, S, C = q.shape
    hs = C // n_head
    n_past = k_past.shape[1]
    q4, k4, v4 = (t.reshape(B, S, n_head, hs) for t in (q, k, v))
    kc = k_past.reshape(B, n_past, n_head, hs)
    vc = v_past.reshape(B, n_past, n_head, hs)
    scale = 1.0 / math.sqrt(hs)
    att_past = torch.einsum("bshd,bthd->bhst", q4.float(), kc.float()) * scale
    att_new = torch.einsum("bshd,bthd->bhst", q4.float(), k4.float()) * scale
    causal = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    att_new = att_new.masked_fill(~causal, float("-inf"))
    att = torch.softmax(torch.cat([att_past, att_new], dim=-1), dim=-1).to(v.dtype)
    y = torch.einsum("bhst,bthd->bshd", att[..., :n_past], vc) + torch.einsum(
        "bhst,bthd->bshd", att[..., n_past:], v4
    )
    return y.reshape(B, S, C)


@torch.no_grad()
def stack_step_unrolled(
    stack: Stack,
    x: torch.Tensor,  # [B, S, C]
    caches,  # per-layer (k [B, T, C], v [B, T, C]) or int8 (kq, ks, vq, vs)
    cur_len: int,  # rows already in the caches
    window: int | None = None,  # attention reads cache rows < window only
    kernels: bool = True,
    dense: str = "auto",  # "mega": a body S == 1 step is one decode_layer_step per layer
    attn_wo: bool = False,  # fold wo + residual + LN2 into the body's q8 attention
):
    """One cached step of a stack: S == 1 decode or S > 1 prefill.

    Writes the new k/v rows at cur_len IN PLACE into `caches` (quantized
    per (row, head) for int8 caches) and returns (out [B, S, C], caches).
    A block with int8 buffers uses them for its four dense products. The
    kernel rule, and what `dense` and `attn_wo` select, is in the module
    docstring; a split stack (its model group) runs the per-shard form
    there."""
    if len(stack.blocks) == 0:
        return x, caches
    B, S, _ = x.shape
    n_head, C, group = stack.n_head, stack.width, stack.group
    q8_cache = len(caches[0]) == 4
    check_fused_path(dense, attn_wo, q8_cache, stack.blocks[0].int8, group is not None)
    T = caches[0][0].shape[1]
    t_max = T if window is None else min(window, T)
    body_step = stack.role == "body" and S == 1
    if body_step and dense == "mega":
        step = MK.decode_layer_step if kernels else MK.decode_layer_step_plain
        xt = x[:, 0]
        for blk, (k_l, v_l) in zip(stack.blocks, caches):
            xt = step(
                xt, k_l, v_l, cur_len, blk.ln1.weight, blk.ln1.bias, blk.wqkv, blk.bqkv,
                blk.attn.proj.weight, blk.attn.proj.bias, blk.ln2.weight, blk.ln2.bias, blk.mlp[0].weight,
                blk.mlp[0].bias, blk.mlp[2].weight, blk.mlp[2].bias, n_head, t_window=t_max,
                gelu_version=stack.cfg.gelu,
            )
        return xt[:, None], caches
    attn_wo_fn = AK.decode_attention_q8_update_wo if kernels else AK.decode_attention_q8_update_wo_plain
    body_attn = kernels and body_step
    # the dense kernel pair: a head S == 1 step, and a body one with int8
    # weights; a split stack runs F.linear / _mm (JAX's _tp_safe_policy)
    fused_dense = S == 1 and (stack.role == "head" or stack.blocks[0].int8) and group is None
    if q8_cache:
        attn_fn = AK.decode_attention_q8_update if body_attn else AK.decode_attention_q8_update_plain
    else:
        attn_fn = AK.decode_attention_update if body_attn else AK.decode_attention_update_plain

    for blk, cache_l in zip(stack.blocks, caches):
        q, k, v = _block_qkv(blk, x, fused_dense, kernels).split(C, dim=-1)
        if body_step and attn_wo:
            wo, wo_s = (blk.wo_q, blk.wo_s) if blk.int8 else (blk.attn.proj.weight, None)
            x2, h2 = attn_wo_fn(
                q[:, 0].contiguous(), k[:, 0].contiguous(), v[:, 0].contiguous(), *cache_l, cur_len,
                x[:, 0], wo, wo_s, blk.attn.proj.bias, blk.ln2.weight, blk.ln2.bias, n_head, t_window=t_max,
            )
            x = (x2 + _mlp(blk, h2, stack.cfg.gelu))[:, None]
            continue
        if S == 1:
            y = attn_fn(
                q[:, 0].contiguous(), k[:, 0].contiguous(), v[:, 0].contiguous(),
                *cache_l, cur_len, n_head, t_window=t_max,
            )[:, None]
        else:
            n_past = min(cur_len, t_max)
            if q8_cache:
                kq, ks, vq, vs = cache_l
                k_past = AK.dequantize_cache(kq[:, :n_past], ks[:, :n_past], n_head).to(x.dtype)
                v_past = AK.dequantize_cache(vq[:, :n_past], vs[:, :n_past], n_head).to(x.dtype)
                y = _attention_prefill(q, k, v, k_past, v_past, n_head)
                AK.write_q8_rows(k, v, *cache_l, cur_len, n_head)
            else:
                k_l, v_l = cache_l
                y = _attention_prefill(q, k, v, k_l[:, :n_past], v_l[:, :n_past], n_head)
                k_l[:, cur_len : cur_len + S] = k.to(k_l.dtype)
                v_l[:, cur_len : cur_len + S] = v.to(v_l.dtype)
        x = _block_out(blk, x, y, fused_dense, kernels, stack.cfg.gelu, group)
    return x, caches


def _block_qkv(blk: Block, x: torch.Tensor, fused_dense: bool, kernels: bool) -> torch.Tensor:
    """LN1 and the fused QKV projection of x [B, S, C] -> [B, S, 3C]. An
    S == 1 step given `fused_dense` runs fused_ln_qkv (fused_ln_qkv_q8 for
    int8 weights), or its plain version when not `kernels`; anything else
    runs F.linear (_mm for int8 weights)."""
    ln1 = (blk.ln1.weight, blk.ln1.bias)
    if fused_dense and blk.int8:
        fn = DK.fused_ln_qkv_q8 if kernels else DK.fused_ln_qkv_q8_plain
        return fn(x[:, 0], *ln1, blk.wqkv_q, blk.wqkv_s, blk.bqkv)[:, None]
    if fused_dense:
        fn = DK.fused_ln_qkv if kernels else DK.fused_ln_qkv_plain
        return fn(x[:, 0], *ln1, blk.wqkv, blk.bqkv)[:, None]
    if blk.int8:
        return _mm(layer_norm(x, *ln1), blk.wqkv_q, blk.wqkv_s) + blk.bqkv
    return F.linear(layer_norm(x, *ln1), blk.wqkv, blk.bqkv)


def _block_out(blk: Block, x: torch.Tensor, y: torch.Tensor, fused_dense: bool, kernels: bool,
               gelu_version: str, group=None) -> torch.Tensor:
    """The rest of the block after attention: x2 = x + y @ wo + bo, then
    x2 + MLP(LN2(x2)). An S == 1 step given `fused_dense` runs
    fused_proj_mlp (fused_proj_mlp_q8 for int8 weights), or its plain
    version when not `kernels`; anything else F.linear (_mm for int8
    weights). With a model group the row-parallel products are summed over
    it before their bias is added."""
    mlp0, mlp2 = blk.mlp[0], blk.mlp[2]
    ln2, bo = (blk.ln2.weight, blk.ln2.bias), blk.attn.proj.bias
    if fused_dense and blk.int8:
        fn = DK.fused_proj_mlp_q8 if kernels else DK.fused_proj_mlp_q8_plain
        return fn(
            x[:, 0], y[:, 0], blk.wo_q, blk.wo_s, bo, *ln2, blk.w1_q, blk.w1_s, mlp0.bias,
            blk.w2_q, blk.w2_s, mlp2.bias, gelu_version=gelu_version,
        )[:, None]
    if fused_dense:
        fn = DK.fused_proj_mlp if kernels else DK.fused_proj_mlp_plain
        return fn(
            x[:, 0], y[:, 0], blk.attn.proj.weight, bo, *ln2, mlp0.weight, mlp0.bias,
            mlp2.weight, mlp2.bias, gelu_version=gelu_version,
        )[:, None]
    if group is not None:
        proj = _mm(y, blk.wo_q, blk.wo_s) if blk.int8 else F.linear(y, blk.attn.proj.weight)
        x2 = x + pdist.group_sum(proj, group) + bo
        return x2 + pdist.group_sum(_mlp(blk, layer_norm(x2, *ln2), gelu_version, with_b2=False), group) + mlp2.bias
    x2 = x + (_mm(y, blk.wo_q, blk.wo_s) + bo if blk.int8 else F.linear(y, blk.attn.proj.weight, bo))
    return x2 + _mlp(blk, layer_norm(x2, *ln2), gelu_version)


class KVCache(NamedTuple):
    """The stacked KV cache of one stack: k, v [n_layer, B, T, C], updated
    in place by stack_step."""

    k: torch.Tensor
    v: torch.Tensor


def init_kv_cache(cfg: StackConfig, batch: int, t_max: int, dtype, device) -> KVCache:
    """A stacked KVCache with k and v each [n_layer, batch, t_max, C], zeroed."""
    shape = (cfg.n_layer, batch, t_max, cfg.embed_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device), torch.zeros(shape, dtype=dtype, device=device))


@torch.no_grad()
def stack_step(stack: Stack, x: torch.Tensor, cache: KVCache, cur_len: int, kernels: bool = True):
    """One cached step of a stack on its stacked cache (x [B, S, C]; S == 1
    decode or S > 1 prefill), the counterpart of the JAX stack_step.

    Each layer reads layer l of the cache only: a body S == 1 step through
    the read-only decode_attention_stacked kernel (its plain version when
    not `kernels`, and for the head, whose dense half runs the dense
    kernels as in stack_step_unrolled); S > 1 through the plain
    _attention_prefill over rows < cur_len. After the layer loop the new
    k/v rows of all layers go into rows cur_len .. cur_len + S with one
    indexed write per cache, as JAX's single dynamic_update_slice. Blocks
    with int8 weights use them through _mm (and the head's _q8 kernels).
    The JAX `window` argument, which its sampler never passes here, is left
    out: every step reads all rows < cur_len. Returns (out [B, S, C], cache)."""
    if len(stack.blocks) == 0:
        return x, cache
    if stack.group is not None:
        raise ValueError("stack_step: the stacked cache is not ported for a tensor-parallel model; "
                         "sample it unrolled (unroll=True)")
    B, S, C = x.shape
    if cur_len + S > cache.k.shape[2]:
        raise ValueError(f"stack_step: rows {cur_len} .. {cur_len + S} outside the cache (T={cache.k.shape[2]})")
    n_head = stack.cfg.n_head
    head_dense = stack.role == "head" and S == 1
    kernel_attn = kernels and stack.role == "body"
    attn_fn = AK.decode_attention_stacked if kernel_attn else AK.decode_attention_stacked_plain
    k_rows, v_rows = [], []
    for layer, blk in enumerate(stack.blocks):
        q, k, v = _block_qkv(blk, x, head_dense, kernels).split(C, dim=-1)
        if S == 1:
            y = attn_fn(
                q[:, 0].contiguous(), k[:, 0].contiguous(), v[:, 0].contiguous(), cache.k, cache.v, layer,
                cur_len, n_head,
            )[:, None]
        else:
            y = _attention_prefill(q, k, v, cache.k[layer, :, :cur_len], cache.v[layer, :, :cur_len], n_head)
        k_rows.append(k)
        v_rows.append(v)
        x = _block_out(blk, x, y, head_dense, kernels, stack.cfg.gelu)
    cache.k[:, :, cur_len : cur_len + S] = torch.stack(k_rows)
    cache.v[:, :, cur_len : cur_len + S] = torch.stack(v_rows)
    return x, cache


def _mlp(blk, h: torch.Tensor, gelu_version: str, with_b2: bool = True) -> torch.Tensor:
    """The block's MLP on h (LN2's output): int8 weights through _mm;
    without the second bias when not `with_b2` (a split block adds it
    after the sum over its model group)."""
    mlp0, mlp2 = blk.mlp[0], blk.mlp[2]
    b2 = mlp2.bias if with_b2 else None
    if blk.int8:
        out = _mm(gelu(_mm(h, blk.w1_q, blk.w1_s) + mlp0.bias, gelu_version), blk.w2_q, blk.w2_s)
        return out if b2 is None else out + b2
    return F.linear(gelu(F.linear(h, mlp0.weight, mlp0.bias), gelu_version), mlp2.weight, b2)


def check_fused_path(dense: str, attn_wo: bool, q8_cache: bool, int8_weights: bool,
                     tensor_parallel: bool = False) -> None:
    """Raise ValueError for a fused body path that cannot run: dense not in
    ("auto", "mega"); dense="mega" with an int8 cache or int8 weights;
    attn_wo without an int8 cache; either fused path on a split model.
    (The JAX package runs its unfused path there without a word.)"""
    if dense not in ("auto", "mega"):
        raise ValueError(f"dense={dense!r}: the port serves 'auto' and 'mega'")
    if tensor_parallel and (dense == "mega" or attn_wo):
        raise ValueError("a tensor-parallel model runs the unfused body layer (its dense products on F.linear, "
                         "summed over the model group): not dense='mega' or attn_wo")
    if dense == "mega" and (q8_cache or int8_weights):
        raise ValueError("dense='mega' runs bf16 or fp32 (k, v) caches and float weights: "
                         "not with an int8 KV cache (kv_q8) or int8 weights")
    if attn_wo and not q8_cache:
        raise ValueError("attn_wo folds wo into the int8-cache attention: it needs kv_q8")


def apply_logit_mask(logits: torch.Tensor, config: TransformerConfig) -> torch.Tensor:
    """-inf past each depth's codebook size when the sizes differ. [..., D, V]."""
    if not config.heterogeneous_vocab:
        return logits
    col = torch.arange(config.vocab_size_max, device=logits.device)
    valid = col[None, :] < torch.as_tensor(config.vocab_size, device=logits.device)[:, None]
    return logits.masked_fill(~valid, float("-inf"))


def classifier_apply(model: RQTransformer, h: torch.Tensor, depth_idx: int | None = None) -> torch.Tensor:
    """h [..., D, C] (all depths) or [..., C] with depth_idx (a decode step):
    LayerNorm, then the shared or per-depth projection (int8 through the
    JAX _mm rounding when the classifier holds int8 buffers), then the
    logit mask. A split classifier's vocabulary slices are gathered over
    the model group before the mask."""
    config = model.config
    cls = model.classifier
    group = model.tp_group
    h = layer_norm(h, cls.layer_norm.weight, cls.layer_norm.bias)
    if config.shared_cls_emb:
        if cls.weight_q is not None:
            logits = _mm(h, cls.weight_q, cls.weight_s) + cls.linear.bias
        else:
            logits = F.linear(h, cls.linear.weight, cls.linear.bias)
        logits = pdist.group_gather_last(logits, group)
        return logits if depth_idx is not None else apply_logit_mask(logits, config)
    w, b = cls.linear.weight, cls.linear.bias
    if cls.weight_q is not None:  # int8 [D, C, V] with scales [D, V]
        w = cls.weight_q.to(h.dtype)
    if depth_idx is None:
        logits = torch.einsum("...dc,dcv->...dv", h, w)
        if cls.weight_q is not None:
            logits = logits * cls.weight_s.to(h.dtype)
        return apply_logit_mask(pdist.group_gather_last(logits + b, group), config)
    logits = h @ w[depth_idx]
    if cls.weight_q is not None:
        logits = logits * cls.weight_s[depth_idx].to(h.dtype)
    logits = pdist.group_gather_last(logits + b[depth_idx], group)
    if config.heterogeneous_vocab:
        col = torch.arange(config.vocab_size_max, device=logits.device)
        logits = logits.masked_fill(col >= config.vocab_size[depth_idx], float("-inf"))
    return logits


# ---------------------------------------------------------------------------
# teacher-forced forward (training)
# ---------------------------------------------------------------------------


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None, deterministic: bool) -> torch.Tensor:
    """The JAX _dropout: keep each element with probability 1 - rate and
    scale the kept ones by 1 / (1 - rate). The mask is drawn from
    `generator` (F.dropout takes none); the identity when `deterministic`
    or rate == 0."""
    if deterministic or rate == 0.0:
        return x
    if generator is None:
        raise ValueError(f"dropout at rate {rate} needs a torch.Generator (or deterministic=True)")
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_head: int) -> torch.Tensor:
    """q, k, v [B, T, C] -> [B, T, C]: causal attention with the scores in
    fp32 (q and k cast before the product, as JAX's preferred_element_type:
    a bf16 product is exact in fp32) and the fp32 softmax cast to v's dtype."""
    B, T, C = q.shape
    hs = C // n_head
    q4, k4, v4 = (t.reshape(B, T, n_head, hs).transpose(1, 2) for t in (q, k, v))
    att = torch.matmul(q4.float(), k4.float().transpose(-1, -2)) * (1.0 / math.sqrt(hs))
    causal = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    att = torch.softmax(att.masked_fill(~causal, float("-inf")), dim=-1).to(v.dtype)
    return torch.matmul(att, v4).transpose(1, 2).reshape(B, T, C)


def _block_weights(blk: Block) -> tuple:
    """The float weights one training layer reads, in _layer_body's order."""
    a = blk.attn
    return (blk.ln1.weight, blk.ln1.bias, a.query.weight, a.query.bias, a.key.weight, a.key.bias,
            a.value.weight, a.value.bias, a.proj.weight, a.proj.bias, blk.ln2.weight, blk.ln2.bias,
            blk.mlp[0].weight, blk.mlp[0].bias, blk.mlp[2].weight, blk.mlp[2].bias)


def _layer_body(x, weights, cfg: StackConfig, generator, deterministic):
    """One pre-LN layer (the JAX _layer_body), a function of its weights
    alone so that a recompute reads the tensors the forward read."""
    ln1w, ln1b, wq, bq, wk, bk, wv, bv, wo, bo, ln2w, ln2b, w1, b1, w2, b2 = weights
    h = layer_norm(x, ln1w, ln1b)
    y = causal_attention(F.linear(h, wq, bq), F.linear(h, wk, bk), F.linear(h, wv, bv), cfg.n_head)
    x = x + dropout(F.linear(y, wo, bo), cfg.resid_pdrop, generator, deterministic)
    m = F.linear(gelu(F.linear(layer_norm(x, ln2w, ln2b), w1, b1), cfg.gelu), w2, b2)
    return x + dropout(m, cfg.resid_pdrop, generator, deterministic)


def _recomputed_layer(x, weights, cfg: StackConfig, generator, deterministic):
    """_layer_body under torch.utils.checkpoint: its activations are
    recomputed in the backward pass. The recompute first sets `generator`
    to its state before this layer, so it draws the forward's dropout
    masks, and then puts back the state it found."""
    saved = generator.get_state() if generator is not None else None
    calls = []

    def run(x, *weights):
        recompute = bool(calls)
        calls.append(1)
        found = None
        if recompute and saved is not None:
            found = generator.get_state()
            generator.set_state(saved)
        try:
            return _layer_body(x, weights, cfg, generator, deterministic)
        finally:
            if found is not None:
                generator.set_state(found)

    return torch.utils.checkpoint.checkpoint(run, x, *weights, use_reentrant=False, preserve_rng_state=False)


def stack_forward(stack: Stack, x: torch.Tensor, generator=None, deterministic: bool = True,
                  remat: bool = False) -> torch.Tensor:
    """The full causal forward of a stack over x [B, T, C] (the JAX
    stack_forward); `remat` recomputes each layer in the backward pass."""
    layer = _recomputed_layer if remat else _layer_body
    for blk in stack.blocks:
        x = layer(x, _block_weights(blk), stack.cfg, generator, deterministic)
    return x


def tuple_tok_emb(model: RQTransformer, xs: torch.Tensor) -> torch.Tensor:
    """Token embeddings of per-depth codes xs [..., D] -> [..., D, C]: one
    shared table, or one table for all depths at per-depth offsets."""
    if model.config.shared_tok_emb:
        return F.embedding(xs, model.tok_emb.weight)
    return F.embedding(xs + model.tok_emb.offsets, model.tok_emb.weight)


def input_embed(model: RQTransformer, xs: torch.Tensor, xs_emb: torch.Tensor | None) -> torch.Tensor:
    """The body's per-depth embeddings [B, T, D, C]: input_mlp of the
    RQ-VAE's code embeddings xs_emb, or the token embeddings."""
    if model.config.input_emb_vqvae:
        return F.linear(xs_emb, model.input_mlp.weight, model.input_mlp.bias)
    return tuple_tok_emb(model, xs)


def head_embed(model: RQTransformer, xs: torch.Tensor, xs_emb: torch.Tensor | None) -> torch.Tensor:
    """The head's per-depth context [B, T, D, C]: head_mlp of the code
    embeddings (summed over depth first with cumsum_depth_ctx), or the
    token embeddings."""
    config = model.config
    if config.head_emb_vqvae:
        e = xs_emb.cumsum(dim=-2) if config.cumsum_depth_ctx else xs_emb
        return F.linear(e, model.head_mlp.weight, model.head_mlp.bias)
    return tuple_tok_emb(model, xs)


def forward(
    model: RQTransformer,
    xs: torch.Tensor,  # [B, H, W, D] codes
    cond: torch.Tensor | None = None,  # [B] or [B, block_size_cond] ids
    xs_emb: torch.Tensor | None = None,  # [B, H * W, D, input_embed_dim]
    generator: torch.Generator | None = None,
    deterministic: bool = True,
    remat: bool = False,
):
    """The teacher-forced forward (the JAX model.forward): seq_logits
    [B, H, W, D, Vmax], and (seq_logits, cond_logits [B, cond_len - 1,
    vocab_size_cond]) when block_size_cond > 1. embd_pdrop and resid_pdrop
    draw their masks from `generator` unless `deterministic`. Activations
    take the weights' dtype, so a bf16 copy of the weights
    (torch.func.functional_call) runs it in bf16. A model holding int8
    buffers raises: the forward trains the float weights."""
    config = model.config
    if model.classifier.weight_q is not None:
        raise ValueError("forward runs the float weights; call clear_int8() first")
    if model.tp_group is not None:
        raise ValueError("the teacher-forced forward is not ported for a tensor-parallel model")
    B, H, W, D = xs.shape
    seq_len, cond_len = H * W, config.block_size_cond
    xs_flat = xs.reshape(B, seq_len, D)
    if cond is None:
        cond = torch.zeros(B, cond_len, dtype=torch.long, device=xs.device)
    cond = cond.reshape(B, cond_len)

    conds_emb = model.cond_emb(cond) + model.pos_emb_cond[:, :cond_len]
    xs_sum = input_embed(model, xs_flat, xs_emb).sum(dim=-2) + model.pos_emb_hw[:, :seq_len]
    latents = torch.cat([conds_emb, xs_sum[:, :-1]], dim=1)
    latents = dropout(latents, config.embd_pdrop, generator, deterministic)
    h = stack_forward(model.body_transformer, latents, generator, deterministic, remat)

    cond_logits = None
    if cond_len > 1:
        cc = model.cond_classifier
        cond_ctx = layer_norm(h[:, : cond_len - 1], cc.layer_norm.weight, cc.layer_norm.bias)
        cond_logits = F.linear(cond_ctx, cc.linear.weight, cc.linear.bias)

    depth_ctx = head_embed(model, xs_flat, xs_emb)
    depth_full = torch.cat([h[:, cond_len - 1 :, None, :], depth_ctx[:, :, :-1, :]], dim=-2)
    depth_full = depth_full.reshape(B * seq_len, D, -1) + model.pos_emb_d[:, :D]
    head_out = stack_forward(model.head_transformer, depth_full, generator, deterministic, remat)
    seq_logits = classifier_apply(model, head_out.reshape(B, H, W, D, -1))
    return seq_logits if cond_logits is None else (seq_logits, cond_logits)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def soft_target_cross_entropy(logits: torch.Tensor, soft_targets: torch.Tensor, reduction: str = "mean"):
    """-sum(p * log_softmax(logits)) with the log-softmax in fp32, over the
    soft targets' vocab (they cover the true vocab only)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    loss = -(soft_targets * logp[..., : soft_targets.shape[-1]]).sum(dim=-1)
    return loss.mean() if reduction == "mean" else loss


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor, reduction: str = "mean"):
    """-log_softmax(logits)[target] with the log-softmax in fp32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    loss = -logp.gather(-1, targets[..., None].long())[..., 0]
    return loss.mean() if reduction == "mean" else loss


def compute_loss(logits: torch.Tensor, targets: torch.Tensor, use_soft_target: bool = False):
    """The mean token loss of logits [..., V] against codes or soft targets."""
    logits = logits.reshape(-1, logits.shape[-1])
    if use_soft_target:
        return soft_target_cross_entropy(logits, targets.reshape(-1, targets.shape[-1]))
    return cross_entropy(logits, targets.reshape(-1))


def compute_cond_loss(cond_logits: torch.Tensor, conds: torch.Tensor):
    """Cross-entropy of the condition's next tokens, conds[:, 1:]."""
    if cond_logits.shape[1] != conds.shape[1] - 1:
        raise ValueError(f"cond_logits {tuple(cond_logits.shape)} do not predict conds {tuple(conds.shape)}[:, 1:]")
    return cross_entropy(cond_logits.reshape(-1, cond_logits.shape[-1]), conds[:, 1:].reshape(-1))


def compute_codebook_loss(logits: torch.Tensor, targets: torch.Tensor, use_soft_target: bool = False):
    """The token loss per depth [D], for logging."""
    D = logits.shape[-2]
    logits = logits.reshape(-1, logits.shape[-1])
    if use_soft_target:
        tok = soft_target_cross_entropy(logits, targets.reshape(-1, targets.shape[-1]), reduction="none")
    else:
        tok = cross_entropy(logits, targets.reshape(-1), reduction="none")
    return tok.reshape(-1, D).mean(dim=0)
