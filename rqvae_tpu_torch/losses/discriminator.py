"""PatchGAN discriminator (pix2pix NLayerDiscriminator), NCHW.

Port of rqvae_tpu/losses/discriminator.py in the reference's state_dict
layout (nn.Sequential `main`): main.0 the first conv, then for n = 1 ..
n_layers the conv main.{3n - 1} and its norm main.{3n}, and the 1-channel
output conv main.{3 n_layers + 2}; the LeakyReLU(0.2) modules between them
hold no weights. 4x4 convs, stride 2 but for the last two, padding 1;
widths ndf * min(2^n, 8); biases only with ActNorm.

BatchNorm keeps flax's semantics, not torch's BatchNorm2d's: the batch
statistics are the mean and the biased variance E[x^2] - E[x]^2 (clipped
at 0) in fp32, and the running averages move with momentum 0.9 towards
the batch mean and that same biased variance. `train=True` normalizes
with the batch statistics; `update_stats=False` leaves the running
averages as they are (the generator's pass in the stage-1 step), True
writes them (the discriminator's own step, once per forward). The
buffers keep BatchNorm2d's names (running_mean, running_var,
num_batches_tracked).

ActNorm (use_actnorm) is scale * (x + loc) with loc / scale [1, C, 1, 1];
initialize_actnorm sets them from a batch as the reference's lazy first
forward does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from rqvae_tpu_torch import resolve_device


class BatchNorm(nn.Module):
    """flax nn.BatchNorm(momentum 0.9, epsilon 1e-5) over NCHW channels."""

    def __init__(self, channels: int, momentum: float = 0.9, eps: float = 1e-5, device=None):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("running_mean", torch.zeros(channels, device=device))
        self.register_buffer("running_var", torch.ones(channels, device=device))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.long, device=device))

    def forward(self, x, train: bool = True, update_stats: bool = True):
        shape = (1, -1, 1, 1)
        if train:
            x32 = x.float()
            mean = x32.mean(dim=(0, 2, 3))
            var = (x32.square().mean(dim=(0, 2, 3)) - mean.square()).clamp_min(0.0)
            if update_stats:
                with torch.no_grad():
                    self.running_mean.mul_(self.momentum).add_(mean.detach(), alpha=1.0 - self.momentum)
                    self.running_var.mul_(self.momentum).add_(var.detach(), alpha=1.0 - self.momentum)
                    self.num_batches_tracked += 1
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean.reshape(shape)) * mul.reshape(shape) + self.bias.reshape(shape)).to(x.dtype)


class ActNorm(nn.Module):
    """scale * (x + loc), the reference's ActNorm without its lazy init
    (initialize_actnorm does it); `initialized` as in its state_dict."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.loc = nn.Parameter(torch.zeros(1, channels, 1, 1, device=device))
        self.scale = nn.Parameter(torch.ones(1, channels, 1, 1, device=device))
        self.register_buffer("initialized", torch.tensor(0, dtype=torch.uint8, device=device))

    def forward(self, x, train: bool = True, update_stats: bool = True):
        return self.scale * (x + self.loc)


def _conv4(cin: int, cout: int, stride: int, bias: bool, device) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 4, stride=stride, padding=1, bias=bias, device=device)


class NLayerDiscriminator(nn.Module):
    """x [B, input_nc, H, W] -> patch logits [B, 1, H', W'], built on
    `device` (CUDA when None)."""

    def __init__(self, input_nc: int = 3, ndf: int = 64, n_layers: int = 3, use_actnorm: bool = False,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.n_layers, self.use_actnorm = n_layers, use_actnorm
        layers = [_conv4(input_nc, ndf, 2, True, device), nn.LeakyReLU(0.2)]
        width = ndf
        for n in range(1, n_layers + 1):
            out = ndf * min(2 ** n, 8)
            layers.append(_conv4(width, out, 2 if n < n_layers else 1, use_actnorm, device))
            layers.append(ActNorm(out, device) if use_actnorm else BatchNorm(out, device=device))
            layers.append(nn.LeakyReLU(0.2))
            width = out
        layers.append(_conv4(width, 1, 1, True, device))
        self.main = nn.Sequential(*layers)

    def forward(self, x, train: bool = True, update_stats: bool = True):
        for layer in self.main:
            x = layer(x, train, update_stats) if isinstance(layer, (BatchNorm, ActNorm)) else layer(x)
        return x

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The reference's weights_init, drawn from `generator`: conv weights
        N(0, 0.02), conv biases 0, BatchNorm scales N(1, 0.02), shifts 0."""
        for m in self.main:
            if isinstance(m, nn.Conv2d):
                m.weight.copy_(0.02 * torch.randn(m.weight.shape, generator=generator, device=m.weight.device))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, BatchNorm):
                m.weight.copy_(1.0 + 0.02 * torch.randn(m.weight.shape, generator=generator, device=m.weight.device))
                m.bias.zero_()


@torch.no_grad()
def initialize_actnorm(disc: NLayerDiscriminator, x: torch.Tensor) -> None:
    """The reference's data-dependent ActNorm init from the batch x [B, C,
    H, W] (JAX initialize_actnorm), in place: each norm in network order
    (each sees the norms before it initialised) gets loc = -mean and scale
    = 1 / (std + 1e-6) of its input per channel, std Bessel-corrected."""
    if not disc.use_actnorm:
        raise ValueError("initialize_actnorm needs use_actnorm=True")
    h = x
    for layer in disc.main:
        if isinstance(layer, ActNorm):
            flat = h.float().transpose(0, 1).reshape(h.shape[1], -1)
            layer.loc.copy_((-flat.mean(dim=1)).reshape(1, -1, 1, 1))
            layer.scale.copy_((1.0 / (flat.std(dim=1) + 1e-6)).reshape(1, -1, 1, 1))
            layer.initialized.fill_(1)
            h = layer(h)
        else:
            h = layer(h)
