"""Hand-written CUDA kernels, their build, and their plain PyTorch versions."""
