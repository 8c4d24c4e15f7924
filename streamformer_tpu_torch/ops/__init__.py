"""Attention kernels of the port (CUDA C++ for Hopper) and their plain PyTorch versions."""
