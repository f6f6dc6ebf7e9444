"""Per-pixel stages of the window program, as PyTorch functions and kernels."""
