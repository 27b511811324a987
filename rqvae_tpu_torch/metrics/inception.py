"""InceptionV3 (the FID variant) in PyTorch, NCHW.

Port of rqvae_tpu/metrics/inception.py: torchvision's inception_v3 topology
with 1008 classes and the FID pooling patches (InceptionA/C/E_1 average
pooling that leaves the padding out of the count, InceptionE_2 (Mixed_7c)
max pooling). Inputs are [B, 3, H, W] in [0, 1]: resized to 299 x 299 as
jax.image.resize(..., "bilinear") does (half-pixel centres, edge taps
renormalised, antialiased where it shrinks), then scaled to [-1, 1].
Outputs are the 2048-d pool features and the 1008 logits. BatchNorm always
uses its running statistics (inference), whatever the module's mode.

The state_dict keys are those of the pytorch-fid checkpoint
(pt_inception-2015-12-05-6726825d.pth), so it loads with strict=True.
`load_fid_inception` reads it from RQVAE_TPU_FID_WEIGHTS; without it the
net has random weights from a seeded generator, and FID / IS numbers are
not comparable to published ones.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from rqvae_tpu_torch import resolve_device

BN_EPS = 1e-3
INPUT_SIZE = 299


def avg_pool_nopad_count(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 average pool, padding 1, the padding left out of the count."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


def max_pool_3_1(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, stride=1, padding=1)


def resize_input(x: torch.Tensor, size: int = INPUT_SIZE) -> torch.Tensor:
    """[B, C, H, W] -> [B, C, size, size] as jax.image.resize's "bilinear":
    the triangle filter on half-pixel centres with the taps outside the
    image dropped and the rest renormalised, widened by the scale where a
    side shrinks (antialias)."""
    shrink = x.shape[-2] > size or x.shape[-1] > size
    return F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False, antialias=shrink)


class _InferenceBatchNorm(nn.BatchNorm2d):
    """BatchNorm2d on its running statistics in either mode."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, self.eps)


class BasicConv(nn.Module):
    """Conv without bias, inference BatchNorm (eps 1e-3), ReLU."""

    def __init__(self, cin: int, cout: int, kernel, stride: int = 1, padding=0, fk=None):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=False, **fk)
        self.bn = _InferenceBatchNorm(cout, eps=BN_EPS, **fk)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int, fk):
        super().__init__()
        self.branch1x1 = BasicConv(cin, 64, 1, fk=fk)
        self.branch5x5_1 = BasicConv(cin, 48, 1, fk=fk)
        self.branch5x5_2 = BasicConv(48, 64, 5, padding=2, fk=fk)
        self.branch3x3dbl_1 = BasicConv(cin, 64, 1, fk=fk)
        self.branch3x3dbl_2 = BasicConv(64, 96, 3, padding=1, fk=fk)
        self.branch3x3dbl_3 = BasicConv(96, 96, 3, padding=1, fk=fk)
        self.branch_pool = BasicConv(cin, pool_features, 1, fk=fk)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(avg_pool_nopad_count(x))
        return torch.cat([b1, b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin: int, fk):
        super().__init__()
        self.branch3x3 = BasicConv(cin, 384, 3, stride=2, fk=fk)
        self.branch3x3dbl_1 = BasicConv(cin, 64, 1, fk=fk)
        self.branch3x3dbl_2 = BasicConv(64, 96, 3, padding=1, fk=fk)
        self.branch3x3dbl_3 = BasicConv(96, 96, 3, stride=2, fk=fk)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, F.max_pool2d(x, 3, stride=2)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int, fk):
        super().__init__()
        self.branch1x1 = BasicConv(cin, 192, 1, fk=fk)
        self.branch7x7_1 = BasicConv(cin, c7, 1, fk=fk)
        self.branch7x7_2 = BasicConv(c7, c7, (1, 7), padding=(0, 3), fk=fk)
        self.branch7x7_3 = BasicConv(c7, 192, (7, 1), padding=(3, 0), fk=fk)
        self.branch7x7dbl_1 = BasicConv(cin, c7, 1, fk=fk)
        self.branch7x7dbl_2 = BasicConv(c7, c7, (7, 1), padding=(3, 0), fk=fk)
        self.branch7x7dbl_3 = BasicConv(c7, c7, (1, 7), padding=(0, 3), fk=fk)
        self.branch7x7dbl_4 = BasicConv(c7, c7, (7, 1), padding=(3, 0), fk=fk)
        self.branch7x7dbl_5 = BasicConv(c7, 192, (1, 7), padding=(0, 3), fk=fk)
        self.branch_pool = BasicConv(cin, 192, 1, fk=fk)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for m in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4, self.branch7x7dbl_5):
            bd = m(bd)
        bp = self.branch_pool(avg_pool_nopad_count(x))
        return torch.cat([b1, b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, cin: int, fk):
        super().__init__()
        self.branch3x3_1 = BasicConv(cin, 192, 1, fk=fk)
        self.branch3x3_2 = BasicConv(192, 320, 3, stride=2, fk=fk)
        self.branch7x7x3_1 = BasicConv(cin, 192, 1, fk=fk)
        self.branch7x7x3_2 = BasicConv(192, 192, (1, 7), padding=(0, 3), fk=fk)
        self.branch7x7x3_3 = BasicConv(192, 192, (7, 1), padding=(3, 0), fk=fk)
        self.branch7x7x3_4 = BasicConv(192, 192, 3, stride=2, fk=fk)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for m in (self.branch7x7x3_2, self.branch7x7x3_3, self.branch7x7x3_4):
            b7 = m(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, stride=2)], dim=1)


class InceptionE(nn.Module):
    def __init__(self, cin: int, use_max_pool: bool, fk):
        super().__init__()
        self.use_max_pool = use_max_pool  # the FID net's Mixed_7c
        self.branch1x1 = BasicConv(cin, 320, 1, fk=fk)
        self.branch3x3_1 = BasicConv(cin, 384, 1, fk=fk)
        self.branch3x3_2a = BasicConv(384, 384, (1, 3), padding=(0, 1), fk=fk)
        self.branch3x3_2b = BasicConv(384, 384, (3, 1), padding=(1, 0), fk=fk)
        self.branch3x3dbl_1 = BasicConv(cin, 448, 1, fk=fk)
        self.branch3x3dbl_2 = BasicConv(448, 384, 3, padding=1, fk=fk)
        self.branch3x3dbl_3a = BasicConv(384, 384, (1, 3), padding=(0, 1), fk=fk)
        self.branch3x3dbl_3b = BasicConv(384, 384, (3, 1), padding=(1, 0), fk=fk)
        self.branch_pool = BasicConv(cin, 192, 1, fk=fk)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        bp = self.branch_pool(max_pool_3_1(x) if self.use_max_pool else avg_pool_nopad_count(x))
        return torch.cat([b1, b3, bd, bp], dim=1)


class FIDInceptionV3(nn.Module):
    """Built on `device`, or on CUDA when it is None (resolve_device)."""

    def __init__(self, resize_input: bool = True, normalize_input: bool = True, device=None, dtype=None):
        super().__init__()
        fk = dict(device=resolve_device(device), dtype=dtype)
        self.resize_input = resize_input
        self.normalize_input = normalize_input  # [0, 1] -> [-1, 1]
        self.Conv2d_1a_3x3 = BasicConv(3, 32, 3, stride=2, fk=fk)
        self.Conv2d_2a_3x3 = BasicConv(32, 32, 3, fk=fk)
        self.Conv2d_2b_3x3 = BasicConv(32, 64, 3, padding=1, fk=fk)
        self.Conv2d_3b_1x1 = BasicConv(64, 80, 1, fk=fk)
        self.Conv2d_4a_3x3 = BasicConv(80, 192, 3, fk=fk)
        self.Mixed_5b = InceptionA(192, 32, fk)
        self.Mixed_5c = InceptionA(256, 64, fk)
        self.Mixed_5d = InceptionA(288, 64, fk)
        self.Mixed_6a = InceptionB(288, fk)
        self.Mixed_6b = InceptionC(768, 128, fk)
        self.Mixed_6c = InceptionC(768, 160, fk)
        self.Mixed_6d = InceptionC(768, 160, fk)
        self.Mixed_6e = InceptionC(768, 192, fk)
        self.Mixed_7a = InceptionD(768, fk)
        self.Mixed_7b = InceptionE(1280, False, fk)
        self.Mixed_7c = InceptionE(2048, True, fk)
        self.fc = nn.Linear(2048, 1008, **fk)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """x [B, 3, H, W] in [0, 1] -> (pool features [B, 2048], logits [B, 1008])."""
        if self.resize_input:
            x = resize_input(x)
        if self.normalize_input:
            x = 2.0 * x - 1.0
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, stride=2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, stride=2)
        for m in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a, self.Mixed_6b, self.Mixed_6c,
                  self.Mixed_6d, self.Mixed_6e, self.Mixed_7a, self.Mixed_7b, self.Mixed_7c):
            x = m(x)
        pool = x.mean(dim=(2, 3))
        return pool, self.fc(pool)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Random weights drawn from `generator`: convs N(0, 2 / fan_in) (He:
        the activations keep their scale through the ReLUs), fc N(0, 1 /
        fan_in), fc bias 0, BatchNorm at the identity."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                gain = 2.0 if isinstance(m, nn.Conv2d) else 1.0
                m.weight.normal_(0.0, (gain / m.weight[0].numel()) ** 0.5, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()


def load_fid_inception(weights_path: Optional[str] = None, device=None) -> tuple[FIDInceptionV3, bool]:
    """(net in eval mode, pretrained?): the pytorch-fid checkpoint from
    `weights_path` or RQVAE_TPU_FID_WEIGHTS, loaded strictly, else random
    weights from a generator seeded with 0."""
    weights_path = weights_path or os.environ.get("RQVAE_TPU_FID_WEIGHTS")
    model = FIDInceptionV3(device=device)
    pretrained = bool(weights_path and os.path.exists(weights_path))
    if pretrained:
        sd = torch.load(weights_path, map_location="cpu", weights_only=False)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        model.load_state_dict(sd, strict=True)
    else:
        model.init_weights(torch.Generator(device=model.fc.weight.device).manual_seed(0))
        logging.warning("FID inception running with RANDOM weights (set RQVAE_TPU_FID_WEIGHTS); numbers not comparable")
    return model.eval(), pretrained
