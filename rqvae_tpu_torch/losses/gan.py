"""GAN losses of the stage-1 trainer.

Port of rqvae_tpu/losses/gan.py (the reference's vqgan/gan_loss.py): the
hinge and vanilla discriminator losses and the vanilla generator loss, on
logits of any shape, as fp32-or-wider means.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def hinge_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    loss_real = F.relu(1.0 - logits_real).mean()
    loss_fake = F.relu(1.0 + logits_fake).mean()
    return 0.5 * (loss_real + loss_fake)


def vanilla_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (F.softplus(-logits_real).mean() + F.softplus(logits_fake).mean())


def vanilla_g_loss(logits_fake: torch.Tensor) -> torch.Tensor:
    return -logits_fake.mean()


D_LOSSES = {"hinge": hinge_d_loss, "vanilla": vanilla_d_loss}
G_LOSSES = {"vanilla": vanilla_g_loss}
