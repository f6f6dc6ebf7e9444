"""Meshes of ranks on torch.distributed (parallel/mesh.py)."""
