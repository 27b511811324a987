"""CLIP (ViT-B/32 by default) in PyTorch, and its state_dict layouts.

Port of rqvae_tpu/metrics/clip_model.py: a patch-conv vision transformer
and a causal text transformer, both pre-LN with quickGELU MLPs, projected
into one embedding space. Text is pooled at argmax(token ids) (the
end-of-text token has the highest id in the CLIP vocabulary). The module's
state_dict is the OpenAI `clip` package's layout ("visual.conv1.weight",
packed "attn.in_proj_weight", ...); `convert_openai_clip`, `convert_hf_clip`
(HuggingFace CLIPModel: split q/k/v under "vision_model." / "text_model.")
and `convert_torch_clip` (which sniffs the two) turn a checkpoint's
state_dict into that layout and a CLIPConfig, and `build_clip` loads it with
strict=True. Attention is the library's scaled_dot_product_attention: no
Pallas kernel lies on this path.

`preprocess_images` is CLIP's transform without PIL: truncation to uint8,
a bicubic resize of the short side equal to PIL's (data/transforms.py
pil_resize: PIL's fixed-point weights, one side at a time, rounded to
uint8 after each), a centre crop, then the normalisation.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from rqvae_tpu_torch import resolve_device
from rqvae_tpu_torch.data.transforms import pil_resize


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    image_size: int = 224
    patch_size: int = 32
    vision_width: int = 768
    vision_layers: int = 12
    vision_heads: int = 12
    text_width: int = 512
    text_layers: int = 12
    text_heads: int = 8
    vocab_size: int = 49408
    context_length: int = 77
    embed_dim: int = 512
    ln_eps: float = 1e-5


# CLIP's torchvision preprocessing constants (clip.load -> _transform)
IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class Attention(nn.Module):
    """Packed-QKV multi-head self-attention (nn.MultiheadAttention's keys)."""

    def __init__(self, width: int, n_head: int, fk):
        super().__init__()
        self.n_head = n_head
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width, **fk))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width, **fk))
        self.out_proj = nn.Linear(width, width, **fk)

    def forward(self, x: torch.Tensor, causal: bool) -> torch.Tensor:
        B, T, W = x.shape
        q, k, v = (t.reshape(B, T, self.n_head, W // self.n_head).transpose(1, 2)
                   for t in F.linear(x, self.in_proj_weight, self.in_proj_bias).split(W, dim=-1))
        o = F.scaled_dot_product_attention(q, k, v, is_causal=causal)
        return self.out_proj(o.transpose(1, 2).reshape(B, T, W))


class MLP(nn.Module):
    def __init__(self, width: int, fk):
        super().__init__()
        self.c_fc = nn.Linear(width, 4 * width, **fk)
        self.c_proj = nn.Linear(4 * width, width, **fk)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c_proj(quick_gelu(self.c_fc(x)))


class ResidualBlock(nn.Module):
    def __init__(self, width: int, n_head: int, eps: float, fk):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width, eps=eps, **fk)
        self.attn = Attention(width, n_head, fk)
        self.ln_2 = nn.LayerNorm(width, eps=eps, **fk)
        self.mlp = MLP(width, fk)

    def forward(self, x: torch.Tensor, causal: bool) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), causal)
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, n_head: int, eps: float, fk):
        super().__init__()
        self.resblocks = nn.ModuleList([ResidualBlock(width, n_head, eps, fk) for _ in range(layers)])

    def forward(self, x: torch.Tensor, causal: bool) -> torch.Tensor:
        for blk in self.resblocks:
            x = blk(x, causal)
        return x


class VisionTransformer(nn.Module):
    def __init__(self, c: CLIPConfig, fk):
        super().__init__()
        W, grid = c.vision_width, c.image_size // c.patch_size
        self.conv1 = nn.Conv2d(3, W, c.patch_size, stride=c.patch_size, bias=False, **fk)
        self.class_embedding = nn.Parameter(torch.empty(W, **fk))
        self.positional_embedding = nn.Parameter(torch.empty(grid * grid + 1, W, **fk))
        self.ln_pre = nn.LayerNorm(W, eps=c.ln_eps, **fk)
        self.transformer = Transformer(W, c.vision_layers, c.vision_heads, c.ln_eps, fk)
        self.ln_post = nn.LayerNorm(W, eps=c.ln_eps, **fk)
        self.proj = nn.Parameter(torch.empty(W, c.embed_dim, **fk))

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        x = self.conv1(pixels.to(self.conv1.weight.dtype)).flatten(2).transpose(1, 2)  # [B, grid^2, W]
        cls = self.class_embedding.expand(x.shape[0], 1, -1)
        x = self.ln_pre(torch.cat([cls, x], dim=1) + self.positional_embedding)
        x = self.transformer(x, causal=False)
        return self.ln_post(x[:, 0]) @ self.proj


class CLIP(nn.Module):
    """Built on `device`, or on CUDA when it is None (resolve_device)."""

    def __init__(self, config: CLIPConfig, device=None, dtype=None):
        super().__init__()
        fk = dict(device=resolve_device(device), dtype=dtype)
        c = self.config = config
        self.visual = VisionTransformer(c, fk)
        self.token_embedding = nn.Embedding(c.vocab_size, c.text_width, **fk)
        self.positional_embedding = nn.Parameter(torch.empty(c.context_length, c.text_width, **fk))
        self.transformer = Transformer(c.text_width, c.text_layers, c.text_heads, c.ln_eps, fk)
        self.ln_final = nn.LayerNorm(c.text_width, eps=c.ln_eps, **fk)
        self.text_projection = nn.Parameter(torch.empty(c.text_width, c.embed_dim, **fk))

    def encode_image(self, pixels: torch.Tensor) -> torch.Tensor:
        """pixels [B, 3, S, S] preprocessed (normalised) -> [B, embed_dim]."""
        return self.visual(pixels)

    def encode_text(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B, T] -> [B, embed_dim], pooled at the argmax token id."""
        x = self.token_embedding(tokens) + self.positional_embedding[: tokens.shape[1]]
        x = self.ln_final(self.transformer(x, causal=True))
        x = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(dim=-1)]
        return x @ self.text_projection


def clip_scores(model: CLIP, pixels: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """cosine(image embedding, text embedding) per pair (the reference's clip_score.py:46)."""
    img = model.encode_image(pixels)
    txt = model.encode_text(tokens)
    img = img / img.norm(dim=-1, keepdim=True)
    txt = txt / txt.norm(dim=-1, keepdim=True)
    return (img * txt).sum(-1)


def preprocess_images(pixels01: torch.Tensor, image_size: int = 224) -> torch.Tensor:
    """[B, 3, H, W] in [0, 1] -> normalised [B, 3, S, S] fp32 (CLIP's
    _transform: bicubic resize of the short side, centre crop, normalise)."""
    x = (pixels01.float().clamp(0.0, 1.0) * 255.0).floor()  # (p * 255).astype(uint8)
    h, w = x.shape[-2:]
    s = image_size / min(w, h)
    new_w, new_h = max(image_size, round(w * s)), max(image_size, round(h * s))
    x = pil_resize(x, (new_h, new_w), "bicubic")
    top, left = (new_h - image_size) // 2, (new_w - image_size) // 2
    x = x[..., top : top + image_size, left : left + image_size] / 255.0
    mean = torch.tensor(IMAGE_MEAN, device=x.device)[:, None, None]
    std = torch.tensor(IMAGE_STD, device=x.device)[:, None, None]
    return (x - mean) / std


# ---------------------------------------------------------------------------
# checkpoint layouts -> the module's (OpenAI) layout
# ---------------------------------------------------------------------------

_BLOCK_KEYS = ("ln_1.weight", "ln_1.bias", "attn.in_proj_weight", "attn.in_proj_bias", "attn.out_proj.weight",
               "attn.out_proj.bias", "ln_2.weight", "ln_2.bias", "mlp.c_fc.weight", "mlp.c_fc.bias",
               "mlp.c_proj.weight", "mlp.c_proj.bias")
_TOP_KEYS = ("visual.conv1.weight", "visual.class_embedding", "visual.positional_embedding", "visual.ln_pre.weight",
             "visual.ln_pre.bias", "visual.ln_post.weight", "visual.ln_post.bias", "visual.proj",
             "token_embedding.weight", "positional_embedding", "ln_final.weight", "ln_final.bias", "text_projection")


def _float(t) -> torch.Tensor:
    return torch.as_tensor(t).detach().to("cpu", torch.float32)


def _n_layers(sd, prefix: str, index: int) -> int:
    return 1 + max(int(k.split(".")[index]) for k in sd if k.startswith(prefix))


def convert_openai_clip(sd, vision_heads: Optional[int] = None,
                        text_heads: Optional[int] = None) -> tuple[dict, CLIPConfig]:
    """The OpenAI `clip` package's state_dict (the published ViT-B-32.pt) ->
    (the module's state_dict, CLIPConfig). Dims come from the tensors' shapes;
    head counts default to the CLIP family's head size of 64."""
    vw, _, p, _ = sd["visual.conv1.weight"].shape
    n_vis = _n_layers(sd, "visual.transformer.resblocks.", 3)
    n_txt = _n_layers(sd, "transformer.resblocks.", 2)
    tw = sd["ln_final.weight"].shape[0]
    grid = int(round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5))
    config = CLIPConfig(
        image_size=grid * p, patch_size=p, vision_width=vw, vision_layers=n_vis,
        vision_heads=vision_heads or vw // 64, text_width=tw, text_layers=n_txt,
        text_heads=text_heads or tw // 64, vocab_size=sd["token_embedding.weight"].shape[0],
        context_length=sd["positional_embedding"].shape[0], embed_dim=sd["text_projection"].shape[1],
    )
    keys = list(_TOP_KEYS)
    keys += [f"visual.transformer.resblocks.{i}.{k}" for i in range(n_vis) for k in _BLOCK_KEYS]
    keys += [f"transformer.resblocks.{i}.{k}" for i in range(n_txt) for k in _BLOCK_KEYS]
    return {k: _float(sd[k]) for k in keys}, config


def convert_hf_clip(sd, vision_heads: Optional[int] = None,
                    text_heads: Optional[int] = None) -> tuple[dict, CLIPConfig]:
    """A HuggingFace CLIPModel state_dict (openai/clip-vit-base-patch32) ->
    (the module's state_dict, CLIPConfig): q/k/v packed into in_proj."""
    out = {
        "visual.conv1.weight": sd["vision_model.embeddings.patch_embedding.weight"],
        "visual.class_embedding": sd["vision_model.embeddings.class_embedding"],
        "visual.positional_embedding": sd["vision_model.embeddings.position_embedding.weight"],
        # HF spells the pre-LN "pre_layrnorm"
        "visual.ln_pre.weight": sd.get("vision_model.pre_layrnorm.weight", sd.get("vision_model.pre_layernorm.weight")),
        "visual.ln_pre.bias": sd.get("vision_model.pre_layrnorm.bias", sd.get("vision_model.pre_layernorm.bias")),
        "visual.ln_post.weight": sd["vision_model.post_layernorm.weight"],
        "visual.ln_post.bias": sd["vision_model.post_layernorm.bias"],
        "visual.proj": _float(sd["visual_projection.weight"]).T,
        "token_embedding.weight": sd["text_model.embeddings.token_embedding.weight"],
        "positional_embedding": sd["text_model.embeddings.position_embedding.weight"],
        "ln_final.weight": sd["text_model.final_layer_norm.weight"],
        "ln_final.bias": sd["text_model.final_layer_norm.bias"],
        "text_projection": _float(sd["text_projection.weight"]).T,
    }
    for ours, theirs in (("visual.transformer.resblocks", "vision_model.encoder.layers"),
                         ("transformer.resblocks", "text_model.encoder.layers")):
        for i in range(_n_layers(sd, f"{theirs}.", 3)):
            a, b = f"{ours}.{i}", f"{theirs}.{i}"
            for k in ("weight", "bias"):
                out[f"{a}.attn.in_proj_{k}"] = torch.cat(
                    [_float(sd[f"{b}.self_attn.{x}_proj.{k}"]) for x in "qkv"], dim=0)
                out[f"{a}.attn.out_proj.{k}"] = sd[f"{b}.self_attn.out_proj.{k}"]
                out[f"{a}.ln_1.{k}"] = sd[f"{b}.layer_norm1.{k}"]
                out[f"{a}.ln_2.{k}"] = sd[f"{b}.layer_norm2.{k}"]
                out[f"{a}.mlp.c_fc.{k}"] = sd[f"{b}.mlp.fc1.{k}"]
                out[f"{a}.mlp.c_proj.{k}"] = sd[f"{b}.mlp.fc2.{k}"]
    return convert_openai_clip(out, vision_heads, text_heads)


def convert_torch_clip(sd) -> tuple[dict, CLIPConfig]:
    """Either layout, told apart by its key prefixes."""
    if any(k.startswith("visual.conv1") for k in sd):
        return convert_openai_clip(sd)
    if any(k.startswith("vision_model.") for k in sd):
        return convert_hf_clip(sd)
    raise ValueError(
        "unrecognized CLIP state_dict layout (expected OpenAI `visual.*` or "
        f"HuggingFace `vision_model.*` keys; got e.g. {list(sd)[:3]})"
    )


def build_clip(state_dict: dict, config: CLIPConfig, device=None) -> CLIP:
    """A CLIP on `device` (CUDA when None) holding `state_dict` (strict), in eval mode."""
    model = CLIP(config, device=device)
    model.load_state_dict(state_dict, strict=True)
    return model.eval()
