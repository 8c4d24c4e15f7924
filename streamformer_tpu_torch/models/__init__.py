"""The StreamFormer encoder on PyTorch."""
