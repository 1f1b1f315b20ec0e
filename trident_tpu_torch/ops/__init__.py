"""Per-frame tensor stages and the CUDA kernel wrappers."""
