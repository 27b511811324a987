"""RQ-Transformer configuration.

Port of rqvae_tpu/models/rqtransformer/config.py (frozen dataclasses, same
fields and properties). `TransformerConfig.create` takes the `arch` dict of
a stage-2 config and fills in the defaults that the JAX package's
utils/config.py::augment_arch_defaults would (RQTRANSFORMER_DEFAULTS and
ATTENTION_BLOCK_DEFAULTS), so a raw arch dict and an augmented one give the
same config. No YAML is needed here.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple

# the defaults of rqvae_tpu/utils/config.py RQTRANSFORMER_DEFAULTS that
# TransformerConfig reads
_ARCH_DEFAULTS = {
    "vocab_size_cond": 0,
    "block_size_cond": 0,
    "input_embed_dim": None,
    "input_emb_vqvae": False,
    "head_emb_vqvae": False,
    "cumsum_depth_ctx": False,
    "shared_tok_emb": False,
    "shared_cls_emb": False,
    "embd_pdrop": 0.0,
}
# ATTENTION_BLOCK_DEFAULTS (embed_dim None -> the arch embed_dim)
_BLOCK_DEFAULTS = {
    "embed_dim": None,
    "mlp_bias": True,
    "attn_bias": True,
    "attn_pdrop": 0.0,
    "resid_pdrop": 0.1,
    "gelu": "v1",
}


@dataclasses.dataclass(frozen=True)
class StackConfig:
    n_layer: int
    n_head: int
    embed_dim: int
    mlp_bias: bool = True
    attn_bias: bool = True
    attn_pdrop: float = 0.0
    resid_pdrop: float = 0.1
    gelu: str = "v1"


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: Tuple[int, ...]  # per-depth codebook sizes
    block_size: Tuple[int, int, int]  # (H, W, D)
    embed_dim: int
    body: StackConfig
    head: StackConfig
    vocab_size_cond: int = 1  # >=1; 1 => a start-of-sequence token only
    block_size_cond: int = 1
    input_embed_dim: Optional[int] = None
    input_emb_vqvae: bool = False
    head_emb_vqvae: bool = False
    cumsum_depth_ctx: bool = False
    shared_tok_emb: bool = False
    shared_cls_emb: bool = False
    embd_pdrop: float = 0.0

    @property
    def depth(self) -> int:
        return self.block_size[2]

    @property
    def hw(self) -> int:
        return self.block_size[0] * self.block_size[1]

    @property
    def vocab_size_max(self) -> int:
        return max(self.vocab_size)

    @property
    def heterogeneous_vocab(self) -> bool:
        return [self.vocab_size[0]] * len(self.vocab_size) != list(self.vocab_size)

    @staticmethod
    def create(arch: Mapping) -> "TransformerConfig":
        """From a stage-2 `arch` dict, raw or already augmented."""
        cfg = {**_ARCH_DEFAULTS, **arch}
        block_size = tuple(cfg["block_size"])
        depth = block_size[2]
        vocab = cfg["vocab_size"]
        vocab = tuple(vocab) if isinstance(vocab, (list, tuple)) else (vocab,) * depth
        if len(vocab) != depth:
            raise ValueError(f"vocab_size has {len(vocab)} entries for depth {depth}")
        if (cfg["shared_tok_emb"] or cfg["shared_cls_emb"]) and len(set(vocab)) != 1:
            raise ValueError("shared tok/cls embedding requires equal codebook sizes")

        def stack(s):
            b = {**_BLOCK_DEFAULTS, **s["block"]}
            return StackConfig(
                n_layer=s["n_layer"],
                n_head=b["n_head"],
                embed_dim=b["embed_dim"] or cfg["embed_dim"],
                mlp_bias=b["mlp_bias"],
                attn_bias=b["attn_bias"],
                attn_pdrop=b["attn_pdrop"],
                resid_pdrop=b["resid_pdrop"],
                gelu=b["gelu"],
            )

        vocab_size_cond = max(cfg["vocab_size_cond"] or 0, 1)
        block_size_cond = max(cfg["block_size_cond"] or 0, 1)
        if block_size_cond > 1 and vocab_size_cond == 1:
            raise ValueError("block_size_cond > 1 needs a condition vocabulary")

        return TransformerConfig(
            vocab_size=vocab,
            block_size=block_size,
            embed_dim=cfg["embed_dim"],
            body=stack(cfg["body"]),
            head=stack(cfg["head"]),
            vocab_size_cond=vocab_size_cond,
            block_size_cond=block_size_cond,
            input_embed_dim=cfg["input_embed_dim"],
            input_emb_vqvae=cfg["input_emb_vqvae"],
            head_emb_vqvae=cfg["head_emb_vqvae"],
            cumsum_depth_ctx=cfg["cumsum_depth_ctx"],
            shared_tok_emb=cfg["shared_tok_emb"],
            shared_cls_emb=cfg["shared_cls_emb"],
            embd_pdrop=cfg["embd_pdrop"],
        )
