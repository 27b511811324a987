"""PyTorch/CUDA port of rqvae_tpu for NVIDIA Hopper (H100).

Imports torch only; the JAX package rqvae_tpu stays the reference the port
is checked against (tests/test_torch_*.py).
"""

import torch


def resolve_device(device=None) -> torch.device:
    """The device a module is built on: `device` when given, else the first
    CUDA device. Without CUDA it raises rather than fall back to the CPU;
    pass device="cpu" to build there on purpose."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "rqvae_tpu_torch builds on CUDA by default and torch.cuda.is_available() is False; "
            "pass device='cpu' to build on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())
