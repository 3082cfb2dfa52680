"""Sharded rendering and training on torch.distributed (parallel/mesh.py)."""
