"""VQGAN-style conv encoder/decoder in PyTorch (NCHW inside).

Port of rqvae_tpu/models/rqvae/modules.py. Module names follow the
reference state_dict layout (conv_in, mid.block_1, up.{i}.block.{j},
up.{i}.attn.{j}, up.{i}.upsample.conv, norm_out, conv_out; down.* for the
encoder), so reference checkpoints and the JAX export load with
strict=True. Convolution weights are OIHW: the JAX HWIO kernels transpose
as in rqvae_tpu/checkpoint/torch_export.py:27-29.

The Encoder and Decoder both run at inference (dropout is skipped): the
Encoder maps pixels [B, in_channels, res, res] to [B, z, res / 2^(L-1), ...].
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
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
    """norm-swish-conv twice, with a 1x1 shortcut when the width changes."""

    def __init__(self, cin: int, cout: int, fk, conv_shortcut: bool = False):
        super().__init__()
        self.norm1 = GroupNorm32(cin, **fk)
        self.conv1 = _conv(cin, cout, 3, fk)
        self.norm2 = GroupNorm32(cout, **fk)
        self.conv2 = _conv(cout, cout, 3, fk)
        if cin != cout:
            if conv_shortcut:
                self.conv_shortcut = _conv(cin, cout, 3, fk)
            else:
                self.nin_shortcut = _conv(cin, cout, 1, fk)

    def forward(self, x):
        h = self.conv1(swish(self.norm1(x)))
        h = self.conv2(swish(self.norm2(h)))  # dropout: inference only
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        elif hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


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
    def __init__(self, channels: int, fk):
        super().__init__()
        self.block_1 = ResnetBlock(channels, channels, fk)
        self.attn_1 = AttnBlock(channels, fk)
        self.block_2 = ResnetBlock(channels, channels, fk)

    def forward(self, x):
        return self.block_2(self.attn_1(self.block_1(x)))


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
                level.block.append(ResnetBlock(block_in, block_out, fk))
                block_in = block_out
                if curr_res in cfg.attn_resolutions:
                    level.attn.append(AttnBlock(block_in, fk))
            if i_level != len(cfg.ch_mult) - 1:
                level.downsample = Downsample(block_in, cfg.resamp_with_conv, fk)
                curr_res //= 2
            self.down.append(level)
        self.mid = _Mid(block_in, fk)
        self.norm_out = GroupNorm32(block_in, **fk)
        out_ch = 2 * cfg.z_channels if cfg.double_z else cfg.z_channels
        self.conv_out = _conv(block_in, out_ch, 3, fk)

    def forward(self, x):
        h = self.conv_in(x)
        for level in self.down:
            for j, block in enumerate(level.block):
                h = block(h)
                if len(level.attn) > 0:
                    h = level.attn[j](h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = self.mid(h)
        return self.conv_out(swish(self.norm_out(h)))


class Decoder(nn.Module):
    """Upsampling conv stack. z [B, z_channels, h, w] -> [B, out_ch, H, W]."""

    def __init__(self, cfg: DDConfig, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        n_levels = len(cfg.ch_mult)
        block_in = cfg.ch * cfg.ch_mult[-1]
        curr_res = cfg.resolution // 2 ** (n_levels - 1)
        self.conv_in = _conv(cfg.z_channels, block_in, 3, fk)
        self.mid = _Mid(block_in, fk)
        levels = [None] * n_levels
        for i_level in reversed(range(n_levels)):
            level = _Level()
            block_out = cfg.ch * cfg.ch_mult[i_level]
            for _ in range(cfg.num_res_blocks + 1):
                level.block.append(ResnetBlock(block_in, block_out, fk))
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

    def forward(self, z):
        h = self.mid(self.conv_in(z))
        for i_level in reversed(range(len(self.up))):
            level = self.up[i_level]
            for j, block in enumerate(level.block):
                h = block(h)
                if len(level.attn) > 0:
                    h = level.attn[j](h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return self.conv_out(swish(self.norm_out(h)))


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
