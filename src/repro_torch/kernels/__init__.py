"""The LSM's hot spots: CUDA kernel wrappers with their plain PyTorch versions."""
