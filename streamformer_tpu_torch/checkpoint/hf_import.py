"""Load a StreamFormer checkpoint directory into ``StreamformerEncoder``.

Reads a local HF-style directory: ``config.json`` plus the weights as
``model.safetensors``, ``pytorch_model.bin``, ``model.pth`` or a sharded
``model.safetensors.index.json``. Never downloads anything. The state-dict
names are the reference checkpoint's; a leading ``timesformer.`` (the
multitask wrapper), ``model.timesformer.`` or ``backbone.`` prefix is
detected and stripped, and keys the encoder does not own (task heads) are
ignored. A ``.safetensors`` file is read without the ``safetensors`` package
(``hf_export.read_safetensors``).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import torch

from streamformer_tpu_torch.checkpoint.hf_export import read_safetensors
from streamformer_tpu_torch.config import StreamformerConfig
from streamformer_tpu_torch.models.encoder import StreamformerEncoder

_WEIGHT_FILES = ("model.safetensors", "pytorch_model.bin", "model.pth")
_PREFIXES = ("timesformer.", "model.timesformer.", "backbone.")


def load_checkpoint_file(path: str) -> Dict[str, torch.Tensor]:
    """One .safetensors / .bin / .pth file -> state dict of CPU tensors."""
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and isinstance(obj.get("model"), dict):
        obj = obj["model"]  # the reference trainer's checkpoints
    return {k: v for k, v in obj.items() if isinstance(v, torch.Tensor)}


def read_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The backbone state dict of a checkpoint directory, prefix stripped."""
    sd: Dict[str, torch.Tensor] = {}
    index = os.path.join(path, "model.safetensors.index.json")
    if os.path.exists(index):
        with open(index) as f:
            shards = sorted(set(json.load(f)["weight_map"].values()))
        for shard in shards:
            sd.update(load_checkpoint_file(os.path.join(path, shard)))
    else:
        for name in _WEIGHT_FILES:
            file = os.path.join(path, name)
            if os.path.exists(file):
                sd = load_checkpoint_file(file)
                break
    if not sd:
        raise FileNotFoundError(f"no model weights found under {path}")
    if not any(k.startswith("embeddings.") for k in sd):
        for prefix in _PREFIXES:
            if any(k.startswith(prefix + "embeddings.") for k in sd):
                sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
                break
    return sd


def from_pretrained(
    path: str, cfg: Optional[StreamformerConfig] = None, *, device=None
) -> StreamformerEncoder:
    """Build the encoder from a checkpoint directory, on ``cuda`` unless
    ``device`` names another. ``cfg`` defaults to the directory's
    config.json. Raises KeyError if a parameter is missing."""
    if cfg is None:
        cfg = StreamformerConfig.from_pretrained(path)
    sd = read_state_dict(path)
    model = StreamformerEncoder(cfg, device=device)
    missing = sorted(set(model.state_dict()) - set(sd))
    if missing:
        raise KeyError(f"checkpoint under {path} lacks {len(missing)} parameters: {missing[:5]}")
    model.load_state_dict({k: sd[k] for k in model.state_dict()})
    return model
