"""Model configuration for the PyTorch port of StreamFormer.

The port's own copy of ``StreamformerConfig``: the same fields, defaults and
HF-style ``config.json`` interop as the JAX package's, so one checkpoint
directory serves both packages. A frozen dataclass rather than an HF
``PretrainedConfig``; unknown keys in a ``config.json`` are ignored.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Optional


@dataclasses.dataclass(frozen=True)
class StreamformerConfig:
    """Architecture hyperparameters (defaults mirror the reference defaults)."""

    image_size: int = 224
    patch_size: int = 16
    num_channels: int = 3
    num_frames: int = 16
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.0
    attention_probs_dropout_prob: float = 0.0
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-6
    qkv_bias: bool = True
    attention_type: str = "divided_space_time"
    drop_path_rate: float = 0.0
    enable_causal_temporal: bool = True
    add_lora_spatial: bool = False
    lora_rank: int = 32

    # Streaming-inference fields read from a checkpoint's config.json by the
    # reference VideoQA tower.
    streaming_mode: bool = False
    context_length: int = 16

    # Fixed capacity (in frames) of the temporal KV cache used for streaming.
    cache_capacity: int = 64
    # "linear": the stream must fit in the capacity; "ring": writes wrap at
    # slot (position mod capacity) and attention becomes a sliding window
    # over the last cache_capacity frames.
    cache_mode: str = "linear"
    # KV-cache storage dtype; None follows ``dtype``.
    cache_dtype: Optional[str] = None
    # KV-cache layout: "pos_major" stores (C, B*N, D) per layer.
    cache_layout: str = "pos_major"
    # Compute dtype ("bfloat16" for serving, "float32" for parity runs).
    dtype: str = "bfloat16"
    # Gradient checkpointing in training: "none", or "layer" to keep only
    # each layer's input for the backward and recompute the layer there.
    remat: str = "none"
    # Fields below are read by the JAX package only; kept so that one
    # config.json round-trips through both packages.
    use_pallas: bool = True
    use_pallas_streaming: bool = True
    use_pallas_spatial: bool = True
    matmul_precision: Optional[str] = None
    shard_patches: bool = False

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def patches_per_side(self) -> int:
        return self.image_size // self.patch_size

    def replace(self, **kw: Any) -> "StreamformerConfig":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["model_type"] = "timesformer"
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "StreamformerConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    @classmethod
    def from_pretrained(cls, path: str) -> "StreamformerConfig":
        """Load from a directory containing an HF-style config.json."""
        cfg_path = os.path.join(path, "config.json") if os.path.isdir(path) else path
        with open(cfg_path) as f:
            return cls.from_dict(json.load(f))

    def save_pretrained(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(self.to_dict(), f, indent=2)
