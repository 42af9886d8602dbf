"""The codec kernels: CUDA sources, their plain PyTorch versions and wrappers."""
