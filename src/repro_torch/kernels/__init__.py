"""Kernels of the port: plain PyTorch versions and CUDA sources (csrc/)."""
