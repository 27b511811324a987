"""Data-parallel training over torch.distributed (parallel/dist.py)."""
