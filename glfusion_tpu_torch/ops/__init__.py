"""Tensor ops of the port: plain PyTorch, and the wrappers of its kernels."""
