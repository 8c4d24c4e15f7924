"""StreamFormer on PyTorch and CUDA for NVIDIA Hopper.

A port of the JAX package ``streamformer_tpu``, which stays the reference:
the causal divided space-time encoder with its streaming temporal KV cache,
its attention kernels written by hand in CUDA C++ for ``sm_90a``. Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``, where the
kernels' plain PyTorch versions run instead.
"""

from streamformer_tpu_torch.config import StreamformerConfig

__all__ = ["StreamformerConfig"]
