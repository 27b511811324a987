"""LPIPS perceptual loss: VGG16 features and learned channel weights, NCHW.

Port of rqvae_tpu/losses/lpips.py (the reference's vqgan/lpips.py). The
state_dict holds the torchvision and taming layouts: net.features.{idx}
are torchvision's vgg16().features[:30] (convs at 0, 2, 5, 7, 10, 12, 14,
17, 19, 21, 24, 26, 28; ReLUs and max pools between them), lin{k}.model.1
the taming vgg_lpips 1x1 weights [1, C, 1, 1]. The weights are frozen
(requires_grad False).

The VGG16 and linear weights are not in the repository and no download
runs: load_lpips_params loads them from local files when given (or named
by RQVAE_TPU_LPIPS_VGG / RQVAE_TPU_LPIPS_LIN, as the JAX package reads
them) and otherwise leaves the seeded synthetic weights, returning
pretrained=False.

A compute `dtype` (bf16 in training, JAX's lpips_bf16) runs the tower and
the feature differences in that dtype with the weights cast from fp32;
the channel norms sum in fp32 and the returned loss is fp32.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from rqvae_tpu_torch import resolve_device

# torchvision vgg16.features: (index, in, out) of each conv, the max pools
# before slices 2-5, and the ReLU taps relu1_2, 2_2, 3_3, 4_3, 5_3
VGG_CONVS = ((0, 3, 64), (2, 64, 64), (5, 64, 128), (7, 128, 128), (10, 128, 256), (12, 256, 256),
             (14, 256, 256), (17, 256, 512), (19, 512, 512), (21, 512, 512), (24, 512, 512), (26, 512, 512),
             (28, 512, 512))
VGG_POOLS = (4, 9, 16, 23)
VGG_TAPS = (3, 8, 15, 22, 29)
CHNS = (64, 128, 256, 512, 512)
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)


class VGG16Features(nn.Module):
    """torchvision's vgg16().features up to relu5_3, returning the five
    ReLU taps."""

    def __init__(self, device=None):
        super().__init__()
        layers: list[nn.Module] = [nn.ReLU() for _ in range(VGG_TAPS[-1] + 1)]
        for idx, cin, cout in VGG_CONVS:
            layers[idx] = nn.Conv2d(cin, cout, 3, padding=1, device=device)
        for idx in VGG_POOLS:
            layers[idx] = nn.MaxPool2d(2, 2)
        self.features = nn.Sequential(*layers)

    def forward(self, x, dtype: Optional[torch.dtype] = None):
        taps = []
        for i, layer in enumerate(self.features):
            if isinstance(layer, nn.Conv2d):
                cd = dtype or x.dtype
                x = F.conv2d(x.to(cd), layer.weight.to(cd), layer.bias.to(cd), padding=1)
            else:
                x = layer(x)
            if i in VGG_TAPS:
                taps.append(x)
        return taps


class NetLinLayer(nn.Module):
    """taming's NetLinLayer: dropout (inactive here) and a bias-free 1x1
    conv to one channel; only model.1 holds a weight."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.model = nn.Sequential(nn.Dropout(), nn.Conv2d(channels, 1, 1, bias=False, device=device))


def _unit_normalize(x, eps: float = 1e-10):
    """x over its channel norm, the sum of squares accumulated in fp32."""
    norm = x.square().sum(dim=1, keepdim=True, dtype=torch.float32).sqrt()
    return x / (norm + eps).to(x.dtype)


class LPIPS(nn.Module):
    """(input, target) NCHW in [-1, 1] -> the perceptual distance, fp32,
    built on `device` (CUDA when None)."""

    def __init__(self, device=None):
        super().__init__()
        device = resolve_device(device)
        self.net = VGG16Features(device)
        for k, c in enumerate(CHNS):
            setattr(self, f"lin{k}", NetLinLayer(c, device))
        self.requires_grad_(False)

    def _scale_in(self, x, dtype):
        shift = torch.tensor(SHIFT, dtype=torch.float32, device=x.device).reshape(1, 3, 1, 1)
        scale = torch.tensor(SCALE, dtype=torch.float32, device=x.device).reshape(1, 3, 1, 1)
        x = (x.float() - shift) / scale
        return x.to(dtype) if dtype is not None else x

    def forward(self, input, target, reduction: str = "mean", dtype: Optional[torch.dtype] = None):
        """`dtype`: the compute dtype (None: fp32 inputs stay fp32).
        reduction "none" gives [B, 1, 1, 1], "mean" / "sum" a scalar."""
        f0 = self.net(self._scale_in(input, dtype), dtype)
        f1 = self.net(self._scale_in(target, dtype), dtype)
        val = 0.0
        for k in range(len(CHNS)):
            diff = (_unit_normalize(f0[k]) - _unit_normalize(f1[k])).square()
            lin = getattr(self, f"lin{k}").model[1].weight.float()
            val = val + F.conv2d(diff.float(), lin).mean(dim=(2, 3), keepdim=True)
        if reduction == "none":
            return val
        return val.mean() if reduction == "mean" else val.sum()

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Synthetic weights from `generator` (the scales of JAX's init):
        VGG convs N(0, 1 / fan_in), zero biases, channel weights N(0, 0.1)."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
                std = 0.1 if m.bias is None else 1.0 / math.sqrt(fan_in)
                m.weight.copy_(std * torch.randn(m.weight.shape, generator=generator, device=m.weight.device))
                if m.bias is not None:
                    m.bias.zero_()


def convert_lpips(vgg_sd: dict, lin_sd: Optional[dict] = None) -> dict:
    """torchvision vgg16 (features.{idx}.weight / .bias) and taming
    vgg_lpips (lin{k}.model.1.weight) state_dicts -> the part of LPIPS's
    state_dict they give (the lin weights only when lin_sd is given)."""
    sd = {}
    for idx, _, _ in VGG_CONVS:
        for name in ("weight", "bias"):
            sd[f"net.features.{idx}.{name}"] = torch.as_tensor(vgg_sd[f"features.{idx}.{name}"]).float()
    if lin_sd is not None:
        for k in range(len(CHNS)):
            sd[f"lin{k}.model.1.weight"] = torch.as_tensor(lin_sd[f"lin{k}.model.1.weight"]).float()
    return sd


def load_lpips_params(vgg_path: Optional[str] = None, lin_path: Optional[str] = None, device=None,
                      generator: Optional[torch.Generator] = None) -> tuple[LPIPS, bool]:
    """(LPIPS, pretrained): synthetic weights from `generator` (seed 0 when
    None), then the VGG16 weights of `vgg_path` (or $RQVAE_TPU_LPIPS_VGG)
    and the linear weights of `lin_path` (or $RQVAE_TPU_LPIPS_LIN) where
    those files exist; pretrained is True when the VGG weights loaded."""
    lpips = LPIPS(device=device)
    dev = lpips.lin0.model[1].weight.device
    lpips.init_weights(generator if generator is not None else torch.Generator(device=dev).manual_seed(0))
    vgg_path = vgg_path or os.environ.get("RQVAE_TPU_LPIPS_VGG")
    lin_path = lin_path or os.environ.get("RQVAE_TPU_LPIPS_LIN")
    if not (vgg_path and os.path.exists(vgg_path)):
        return lpips, False
    vgg_sd = torch.load(vgg_path, map_location="cpu", weights_only=False)
    if hasattr(vgg_sd, "state_dict"):
        vgg_sd = vgg_sd.state_dict()
    lin_sd = None
    if lin_path and os.path.exists(lin_path):
        lin_sd = torch.load(lin_path, map_location="cpu", weights_only=False)
    lpips.load_state_dict(convert_lpips(vgg_sd, lin_sd), strict=False)
    return lpips, True
