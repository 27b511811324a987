"""VQGAN-style conv encoder/decoder in PyTorch (NCHW inside).

Port of rqvae_tpu/models/rqvae/modules.py. Module names follow the
reference state_dict layout (conv_in, mid.block_1, up.{i}.block.{j},
up.{i}.attn.{j}, up.{i}.upsample.conv, norm_out, conv_out; down.* for the
encoder), so reference checkpoints and the JAX export load with
strict=True. Convolution weights are OIHW: the JAX HWIO kernels transpose
as in rqvae_tpu/checkpoint/torch_export.py:27-29.

The Encoder maps pixels [B, in_channels, res, res] to [B, z, res /
2^(L-1), ...], the Decoder back. Given a torch.Generator (training), each
ResnetBlock applies dropout with masks drawn from it; without one it runs
as at inference. `set_checkpointing` makes each ResnetBlock recompute
itself in the backward pass (torch.utils.checkpoint; JAX's nn.remat),
with the dropout mask drawn once, before the block. `decoder_tail` is the Decoder's last
norm, swish and conv on given weights, as the stage-1 trainer needs it
(JAX modules.decoder_tail).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn


@dataclasses.dataclass(frozen=True)
class DDConfig:
    """ddconfig block of a stage-1 config."""

    ch: int
    out_ch: int
    in_channels: int
    num_res_blocks: int
    z_channels: int
    resolution: int
    ch_mult: tuple = (1, 2, 4, 8)
    attn_resolutions: tuple = ()
    dropout: float = 0.0
    resamp_with_conv: bool = True
    double_z: bool = True

    @staticmethod
    def create(cfg) -> "DDConfig":
        return DDConfig(
            ch=cfg["ch"],
            out_ch=cfg["out_ch"],
            in_channels=cfg["in_channels"],
            num_res_blocks=cfg["num_res_blocks"],
            z_channels=cfg["z_channels"],
            resolution=cfg["resolution"],
            ch_mult=tuple(cfg.get("ch_mult", (1, 2, 4, 8))),
            attn_resolutions=tuple(cfg.get("attn_resolutions", ())),
            dropout=cfg.get("dropout", 0.0),
            resamp_with_conv=cfg.get("resamp_with_conv", True),
            double_z=cfg.get("double_z", True),
        )


def swish(x):
    return x * torch.sigmoid(x)


class GroupNorm32(nn.GroupNorm):
    """GroupNorm(32, eps=1e-6) with fp32 statistics whatever the activation
    dtype (min(32, C) groups, for narrow test configs)."""

    def __init__(self, channels: int, device=None, dtype=None):
        super().__init__(min(32, channels), channels, eps=1e-6, device=device, dtype=dtype)

    def forward(self, x):
        y = F.group_norm(x.float(), self.num_groups, self.weight.float(), self.bias.float(), self.eps)
        return y.to(x.dtype)


def _conv(cin, cout, k, fk, stride=1, padding=None):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2 if padding is None else padding, **fk)


class Upsample(nn.Module):
    """Nearest 2x, then an optional 3x3 conv."""

    def __init__(self, channels: int, with_conv: bool, fk):
        super().__init__()
        self.conv = _conv(channels, channels, 3, fk) if with_conv else None

    def forward(self, x):
        x = F.interpolate(x, scale_factor=2.0, mode="nearest")
        return self.conv(x) if self.conv is not None else x


class Downsample(nn.Module):
    """Right/bottom pad by one and a stride-2 3x3 conv, or 2x2 average pool."""

    def __init__(self, channels: int, with_conv: bool, fk):
        super().__init__()
        self.conv = _conv(channels, channels, 3, fk, stride=2, padding=0) if with_conv else None

    def forward(self, x):
        if self.conv is None:
            return F.avg_pool2d(x, 2, 2)
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class ResnetBlock(nn.Module):
    """norm-swish-conv twice, with a 1x1 shortcut when the width changes,
    and dropout before the second conv when a generator is given."""

    def __init__(self, cin: int, cout: int, fk, conv_shortcut: bool = False, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.checkpointing = False
        self.norm1 = GroupNorm32(cin, **fk)
        self.conv1 = _conv(cin, cout, 3, fk)
        self.norm2 = GroupNorm32(cout, **fk)
        self.conv2 = _conv(cout, cout, 3, fk)
        if cin != cout:
            if conv_shortcut:
                self.conv_shortcut = _conv(cin, cout, 3, fk)
            else:
                self.nin_shortcut = _conv(cin, cout, 1, fk)

    def _body(self, x, keep):
        h = self.conv1(swish(self.norm1(x)))
        h = swish(self.norm2(h))
        if keep is not None:  # flax nn.Dropout: kept entries scaled by 1 / keep probability
            h = torch.where(keep, h / (1.0 - self.dropout), 0.0)
        h = self.conv2(h)
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        elif hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h

    def forward(self, x, generator=None):
        keep = None
        if generator is not None and self.dropout > 0.0:
            B, _, H, W = x.shape
            shape = (B, self.conv2.in_channels, H, W)
            keep = torch.rand(shape, generator=generator, device=x.device) < 1.0 - self.dropout
        if self.checkpointing and torch.is_grad_enabled():
            return torch.utils.checkpoint.checkpoint(self._body, x, keep, use_reentrant=False)
        return self._body(x, keep)


class AttnBlock(nn.Module):
    """Single-head self-attention over H*W with 1x1-conv projections; fp32
    scores and softmax."""

    def __init__(self, channels: int, fk):
        super().__init__()
        self.norm = GroupNorm32(channels, **fk)
        self.q = _conv(channels, channels, 1, fk)
        self.k = _conv(channels, channels, 1, fk)
        self.v = _conv(channels, channels, 1, fk)
        self.proj_out = _conv(channels, channels, 1, fk)

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.norm(x)
        q = self.q(h).reshape(B, C, H * W)
        k = self.k(h).reshape(B, C, H * W)
        v = self.v(h).reshape(B, C, H * W)
        attn = torch.einsum("bcq,bck->bqk", q.float(), k.float()) * (C ** -0.5)
        attn = attn.softmax(dim=-1).to(v.dtype)
        out = torch.einsum("bqk,bck->bcq", attn, v).reshape(B, C, H, W)
        return x + self.proj_out(out)


class _Level(nn.Module):
    """One resolution level: block.{j}, attn.{j} and the resampler."""

    def __init__(self):
        super().__init__()
        self.block = nn.ModuleList()
        self.attn = nn.ModuleList()


class _Mid(nn.Module):
    def __init__(self, channels: int, fk, dropout: float):
        super().__init__()
        self.block_1 = ResnetBlock(channels, channels, fk, dropout=dropout)
        self.attn_1 = AttnBlock(channels, fk)
        self.block_2 = ResnetBlock(channels, channels, fk, dropout=dropout)

    def forward(self, x, generator=None):
        return self.block_2(self.attn_1(self.block_1(x, generator)), generator)


def set_checkpointing(module: nn.Module, on: bool) -> None:
    """Recompute every ResnetBlock of `module` in the backward pass (or not)."""
    for m in module.modules():
        if isinstance(m, ResnetBlock):
            m.checkpointing = on


class Encoder(nn.Module):
    """Downsampling conv stack. x [B, in_channels, H, W] -> [B, z_out, h, w]
    (z_out = 2 * z_channels with double_z)."""

    def __init__(self, cfg: DDConfig, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.conv_in = _conv(cfg.in_channels, cfg.ch, 3, fk)
        curr_res = cfg.resolution
        in_ch_mult = (1,) + tuple(cfg.ch_mult)
        self.down = nn.ModuleList()
        for i_level, mult in enumerate(cfg.ch_mult):
            level = _Level()
            block_in = cfg.ch * in_ch_mult[i_level]
            block_out = cfg.ch * mult
            for _ in range(cfg.num_res_blocks):
                level.block.append(ResnetBlock(block_in, block_out, fk, dropout=cfg.dropout))
                block_in = block_out
                if curr_res in cfg.attn_resolutions:
                    level.attn.append(AttnBlock(block_in, fk))
            if i_level != len(cfg.ch_mult) - 1:
                level.downsample = Downsample(block_in, cfg.resamp_with_conv, fk)
                curr_res //= 2
            self.down.append(level)
        self.mid = _Mid(block_in, fk, cfg.dropout)
        self.norm_out = GroupNorm32(block_in, **fk)
        out_ch = 2 * cfg.z_channels if cfg.double_z else cfg.z_channels
        self.conv_out = _conv(block_in, out_ch, 3, fk)

    def forward(self, x, generator=None):
        h = self.conv_in(x)
        for level in self.down:
            for j, block in enumerate(level.block):
                h = block(h, generator)
                if len(level.attn) > 0:
                    h = level.attn[j](h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = self.mid(h, generator)
        return self.conv_out(swish(self.norm_out(h)))


class Decoder(nn.Module):
    """Upsampling conv stack. z [B, z_channels, h, w] -> [B, out_ch, H, W],
    or with give_pre_end the activations before norm_out [B, ch, H, W]."""

    def __init__(self, cfg: DDConfig, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        n_levels = len(cfg.ch_mult)
        block_in = cfg.ch * cfg.ch_mult[-1]
        curr_res = cfg.resolution // 2 ** (n_levels - 1)
        self.conv_in = _conv(cfg.z_channels, block_in, 3, fk)
        self.mid = _Mid(block_in, fk, cfg.dropout)
        levels = [None] * n_levels
        for i_level in reversed(range(n_levels)):
            level = _Level()
            block_out = cfg.ch * cfg.ch_mult[i_level]
            for _ in range(cfg.num_res_blocks + 1):
                level.block.append(ResnetBlock(block_in, block_out, fk, dropout=cfg.dropout))
                block_in = block_out
                if curr_res in cfg.attn_resolutions:
                    level.attn.append(AttnBlock(block_in, fk))
            if i_level != 0:
                level.upsample = Upsample(block_in, cfg.resamp_with_conv, fk)
                curr_res *= 2
            levels[i_level] = level
        self.up = nn.ModuleList(levels)
        self.norm_out = GroupNorm32(block_in, **fk)
        self.conv_out = _conv(block_in, cfg.out_ch, 3, fk)

    def forward(self, z, generator=None, give_pre_end: bool = False):
        h = self.mid(self.conv_in(z), generator)
        for i_level in reversed(range(len(self.up))):
            level = self.up[i_level]
            for j, block in enumerate(level.block):
                h = block(h, generator)
                if len(level.attn) > 0:
                    h = level.attn[j](h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        if give_pre_end:
            return h
        return self.conv_out(swish(self.norm_out(h)))

    def tail(self, h):
        """decoder_tail on this decoder's own norm_out and conv_out."""
        return decoder_tail(h, self.norm_out.weight, self.norm_out.bias, self.conv_out.weight, self.conv_out.bias)


def decoder_tail(h, norm_weight, norm_bias, conv_weight, conv_bias):
    """norm_out -> swish -> conv_out on h [B, C, H, W] (give_pre_end's
    output) with the given weights, as JAX's decoder_tail: GroupNorm with
    fp32 statistics and an fp32 affine, swish in fp32, then the conv in
    h's dtype (weights cast to it)."""
    x = F.group_norm(h.float(), min(32, h.shape[1]), norm_weight.float(), norm_bias.float(), 1e-6)
    x = swish(x).to(h.dtype)
    return F.conv2d(x, conv_weight.to(h.dtype), conv_bias.to(h.dtype), padding=conv_weight.shape[-1] // 2)


@torch.no_grad()
def init_conv_stack(module: nn.Module, generator: torch.Generator) -> None:
    """Random weights from `generator`: convs N(0, 1/fan_in) (the scale of
    flax's lecun_normal default), zero biases, unit GroupNorm scales."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
            w = torch.randn(m.weight.shape, generator=generator, device=m.weight.device)
            m.weight.copy_(w / math.sqrt(fan_in))
            m.bias.zero_()
        elif isinstance(m, nn.GroupNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
