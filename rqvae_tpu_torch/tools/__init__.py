"""Ports of the kernel experiments in tools/: each runs as `python -m
rqvae_tpu_torch.tools.<name>` with its JAX experiment's arguments and lines,
on the first CUDA device unless given device=cpu."""
