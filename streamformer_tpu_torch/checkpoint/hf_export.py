"""Write an encoder back as a reference (HF-style) checkpoint directory.

The inverse of ``hf_import``: ``config.json`` and ``model.safetensors`` under
the reference's parameter names (models/modeling_timesformer_siglip.py),
so that weights trained by the port load into the reference
(``TimesformerMultiTaskingModelSigLIP.from_pretrained``), into the JAX
package (``checkpoint.hf_import``) and into HF tooling. The port's module
tree already carries those names: the fused ``attention.attention.qkv`` and
``temporal_attention.attention.qkv`` in the reference's (out, in) layout,
the OIHW patch projection, the LoRA factors ``<name>_lora_a`` /
``<name>_lora_b`` and the MAP head.

``model.safetensors`` is written here, not by the ``safetensors`` package
(which a serving machine need not have): an 8-byte little-endian header
length, a JSON header of each tensor's dtype, shape and byte offsets, then
the raw little-endian bytes. ``read_safetensors`` reads such a file back.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict

import torch

from streamformer_tpu_torch.config import StreamformerConfig

_ST_DTYPES = {torch.float32: "F32", torch.bfloat16: "BF16", torch.float16: "F16",
              torch.int64: "I64", torch.int32: "I32", torch.int8: "I8", torch.uint8: "U8",
              torch.bool: "BOOL"}
_TORCH_DTYPES = {v: k for k, v in _ST_DTYPES.items()}


def backbone_to_state_dict(encoder: torch.nn.Module, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The encoder's parameters under the reference's names (``prefix``
    prepended), as contiguous fp32 CPU tensors: safetensors writes a
    tensor's buffer as it lies, so a strided view would be written wrong.
    The JAX package's ``backbone_to_state_dict`` gives the same dict."""
    out = {}
    for name, p in encoder.state_dict().items():
        if p.dtype == torch.int8:
            raise ValueError(f"{name} holds int8 codes: write the float weights, not a "
                             "quantized serving copy")
        out[prefix + name] = p.detach().to("cpu", torch.float32).contiguous()
    return out


def write_safetensors(path: str, tensors: Dict[str, torch.Tensor]) -> int:
    """Write ``tensors`` as a safetensors file; returns the bytes written."""
    header, offset, blobs = {}, 0, []
    for name, t in tensors.items():
        if t.dtype not in _ST_DTYPES:
            raise TypeError(f"{name}: dtype {t.dtype} has no safetensors code here")
        t = t.detach().cpu().contiguous()
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b""
        header[name] = {"dtype": _ST_DTYPES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        offset += len(raw)
        blobs.append(raw)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)  # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in blobs:
            f.write(raw)
    return 8 + len(head) + offset


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A safetensors file -> state dict of CPU tensors (``__metadata__``
    skipped)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(f.read())  # writable: the tensors are views of it
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        start, end = info["data_offsets"]
        dt = _TORCH_DTYPES[info["dtype"]]
        count = (end - start) // torch.empty((), dtype=dt).element_size()
        flat = (torch.frombuffer(data, dtype=dt, count=count, offset=start) if count
                else torch.empty(0, dtype=dt))
        out[name] = flat.reshape(info["shape"])
    return out


def save_pretrained(path: str, encoder: torch.nn.Module, cfg: StreamformerConfig,
                    prefix: str = "") -> int:
    """Write ``config.json`` and ``model.safetensors`` under ``path`` in the
    reference's layout (its ckpt_to_pretrained.py); returns the weight
    file's bytes."""
    os.makedirs(path, exist_ok=True)
    cfg.save_pretrained(path)
    return write_safetensors(os.path.join(path, "model.safetensors"),
                             backbone_to_state_dict(encoder, prefix=prefix))
