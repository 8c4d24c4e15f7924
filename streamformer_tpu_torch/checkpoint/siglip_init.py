"""Initialize the StreamFormer encoder from a SigLIP checkpoint (weight
surgery): the port of the JAX package's ``checkpoint/siglip_init.py``.

The SigLIP vision tower becomes the spatial half of the divided space-time
encoder and the text tower is copied; the temporal half starts fresh:

* spatial attention qkv <- the rows of q_proj, k_proj and v_proj stacked;
* layer_norm1 -> layernorm_before, layer_norm2 -> layernorm_after, the MLP,
  post_layernorm and the MAP head copied;
* the text tower copied under the HF names ``SiglipTextEncoder`` holds, and
  the logit scale and bias;
* the temporal qkv, output and dense kernels and the time embeddings drawn
  normal(0, 0.02) from an explicit generator; every temporal gate stays 0,
  so the encoder starts exactly at SigLIP per frame.

It reads a local HF SigLIP state dict and writes the same Loaded /
Not-loaded audit JSON as the JAX package; nothing is downloaded. The
results are state dicts under the port's names: ``StreamformerEncoder``'s
(fp32) and ``SiglipTextEncoder``'s.
"""

from __future__ import annotations

import json
import re
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from streamformer_tpu_torch.config import StreamformerConfig
from streamformer_tpu_torch.models.encoder import StreamformerEncoder
from streamformer_tpu_torch.models.text_encoder import SiglipTextConfig


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v).detach().to("cpu", torch.float32).clone()


def _infer_text_config(sd: Mapping[str, Any]) -> SiglipTextConfig:
    n_layers = 1 + max(int(m.group(1)) for k in sd
                       if (m := re.match(r"text_model\.encoder\.layers\.(\d+)\.", k)))
    tok = sd["text_model.embeddings.token_embedding.weight"]
    pos = sd["text_model.embeddings.position_embedding.weight"]
    fc1 = sd["text_model.encoder.layers.0.mlp.fc1.weight"]
    return SiglipTextConfig(vocab_size=tok.shape[0], hidden_size=tok.shape[1],
                            num_hidden_layers=n_layers, intermediate_size=fc1.shape[0],
                            max_position_embeddings=pos.shape[0])


def _text_names(cfg: SiglipTextConfig):
    """The state-dict names of ``SiglipTextEncoder`` (the HF names)."""
    tm = "text_model."
    names = [tm + "embeddings.token_embedding.weight", tm + "embeddings.position_embedding.weight"]
    for i in range(cfg.num_hidden_layers):
        for m in ("layer_norm1", "self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
                  "self_attn.out_proj", "layer_norm2", "mlp.fc1", "mlp.fc2"):
            names += [f"{tm}encoder.layers.{i}.{m}.weight", f"{tm}encoder.layers.{i}.{m}.bias"]
    for m in ("final_layer_norm", "head"):
        names += [f"{tm}{m}.weight", f"{tm}{m}.bias"]
    return names


def init_from_siglip(
    sd: Mapping[str, Any],
    cfg: StreamformerConfig,
    text_cfg: Optional[SiglipTextConfig] = None,
    generator: Optional[torch.Generator] = None,
    vision_prefix: str = "vision_model.",
    audit_path: Optional[str] = None,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """``sd``: a full SigLIP model state dict (tensors or numpy arrays).
    Returns (encoder state dict, text state dict, extras) on the CPU, fp32;
    extras holds ``logit_scale`` and ``logit_bias`` when ``sd`` has them.
    The fresh temporal weights are drawn from ``generator`` (a CPU
    generator; a fresh default one otherwise), after the encoder's own
    initialisation of the leaves the surgery does not touch."""
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    out = StreamformerEncoder(cfg, device="cpu", generator=gen, trainable=True).state_dict()
    out = {k: v.detach().clone() for k, v in out.items()}
    p = vision_prefix
    d = cfg.hidden_size
    loaded = []

    out["embeddings.patch_embeddings.projection.weight"] = _f32(sd[p + "embeddings.patch_embedding.weight"])
    out["embeddings.patch_embeddings.projection.bias"] = _f32(sd[p + "embeddings.patch_embedding.bias"])
    out["embeddings.position_embeddings"] = _f32(sd[p + "embeddings.position_embedding.weight"])[None]
    loaded += ["embeddings.patch_proj", "embeddings.position_embeddings"]

    def normal(shape):
        return 0.02 * torch.randn(shape, generator=gen)

    out["embeddings.time_embeddings"] = normal(out["embeddings.time_embeddings"].shape)
    for i in range(cfg.num_hidden_layers):
        e, lp = f"{p}encoder.layers.{i}.", f"encoder.layer.{i}."
        qkv = [f"{e}self_attn.{n}_proj" for n in "qkv"]
        out[lp + "attention.attention.qkv.weight"] = torch.cat([_f32(sd[n + ".weight"]) for n in qkv])
        out[lp + "attention.attention.qkv.bias"] = torch.cat([_f32(sd[n + ".bias"]) for n in qkv])
        for src, dst in (("self_attn.out_proj", "attention.output.dense"),
                         ("layer_norm1", "layernorm_before"), ("layer_norm2", "layernorm_after"),
                         ("mlp.fc1", "intermediate.dense"), ("mlp.fc2", "output.dense")):
            out[lp + dst + ".weight"] = _f32(sd[e + src + ".weight"])
            out[lp + dst + ".bias"] = _f32(sd[e + src + ".bias"])
        loaded.append(f"layers.{i}.spatial")
        # the temporal half: fresh kernels, the encoder's zero biases, gate 0
        out[lp + "temporal_attention.attention.qkv.weight"] = normal((3 * d, d))
        out[lp + "temporal_attention.output.dense.weight"] = normal((d, d))
        out[lp + "temporal_dense.weight"] = normal((d, d))
        out[lp + "temporal_attention_gating"] = torch.zeros(())

    out["post_layernorm.weight"] = _f32(sd[p + "post_layernorm.weight"])
    out["post_layernorm.bias"] = _f32(sd[p + "post_layernorm.bias"])
    loaded.append("post_layernorm")
    out["head.probe"] = _f32(sd[p + "head.probe"]).reshape(1, 1, d)
    for name in ("attention.in_proj_weight", "attention.in_proj_bias"):
        out["head." + name] = _f32(sd[p + "head." + name])
    for name in ("attention.out_proj", "layernorm", "mlp.fc1", "mlp.fc2"):
        out[f"head.{name}.weight"] = _f32(sd[f"{p}head.{name}.weight"])
        out[f"head.{name}.bias"] = _f32(sd[f"{p}head.{name}.bias"])
    loaded.append("map_head")

    text = {k: _f32(sd[k]) for k in _text_names(text_cfg or _infer_text_config(sd))}
    loaded.append("text")

    extras = {}
    if "logit_scale" in sd:
        extras["logit_scale"] = _f32(sd["logit_scale"]).reshape(())
        extras["logit_bias"] = _f32(sd["logit_bias"]).reshape(())
        loaded.append("logit_scale_bias")

    if audit_path:
        # the weight-surgery audit trail, as the reference writes it
        fresh = ([f"layers.{i}.temporal" for i in range(cfg.num_hidden_layers)]
                 + ["embeddings.time_embeddings", "temporal_attention_gating"])
        with open(audit_path, "w") as f:
            json.dump({"loaded": sorted(loaded), "fresh_init": fresh}, f, indent=2)
    return out, text, extras


def init_from_siglip_dir(path: str, cfg: StreamformerConfig, **kw):
    """``init_from_siglip`` on a local HF SigLIP checkpoint directory
    (``model.safetensors``, ``pytorch_model.bin``, ``model.pth`` or a
    sharded index)."""
    from streamformer_tpu_torch.checkpoint.hf_import import read_state_dict

    return init_from_siglip(read_state_dict(path), cfg, **kw)
