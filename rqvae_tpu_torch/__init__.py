"""PyTorch/CUDA port of rqvae_tpu for NVIDIA Hopper (H100).

Imports torch only; the JAX package rqvae_tpu stays the reference the port
is checked against (tests/test_torch_*.py).
"""
