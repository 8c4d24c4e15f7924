"""SigLIP text encoder: the frozen text tower of every task head.

Port of the JAX package's ``models/text_encoder.py``: token + position
embeddings -> pre-LN transformer -> final LN -> last-token pooling -> head
projection (the HF ``SiglipTextModel`` contract, ``pooler_output =
head(last_hidden_state[:, -1])``). The attention is un-masked over the
padded length, with an fp32 softmax, as HF SigLIP and the JAX package do it;
it is plain PyTorch here because it is no Pallas kernel there.

``SiglipTextEncoder`` holds fp32 parameters under the HF state-dict names
(``text_model.embeddings.token_embedding.weight``,
``text_model.encoder.layers.{i}.self_attn.q_proj.weight``, ...,
``text_model.head.weight``), so ``load_state_dict`` takes a
``SiglipTextModel`` state dict as it is. The tower is frozen: no parameter
requires grad. Tokenization stays on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from streamformer_tpu_torch.models.encoder import resolve_device


@dataclasses.dataclass(frozen=True)
class SiglipTextConfig:
    vocab_size: int = 32000
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 64
    layer_norm_eps: float = 1e-6
    # HF siglip uses gelu_pytorch_tanh
    hidden_act: str = "gelu_pytorch_tanh"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


class _TextLayer(nn.Module):
    def __init__(self, cfg: SiglipTextConfig):
        super().__init__()
        d, m, eps = cfg.hidden_size, cfg.intermediate_size, cfg.layer_norm_eps
        self.layer_norm1 = nn.LayerNorm(d, eps=eps)
        self.self_attn = nn.Module()
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self.self_attn, name, nn.Linear(d, d))
        self.layer_norm2 = nn.LayerNorm(d, eps=eps)
        self.mlp = nn.Module()
        self.mlp.fc1 = nn.Linear(d, m)
        self.mlp.fc2 = nn.Linear(m, d)


class SiglipTextEncoder(nn.Module):
    """The text tower's parameters. Lives on ``cuda`` unless ``device`` names
    another device; weights are drawn as the JAX package's ``init_params``
    does (normal 0.02, zero biases, unit LayerNorms) from ``generator``."""

    def __init__(self, cfg: SiglipTextConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        d = cfg.hidden_size
        tm = nn.Module()
        tm.embeddings = nn.Module()
        tm.embeddings.token_embedding = nn.Embedding(cfg.vocab_size, d)
        tm.embeddings.position_embedding = nn.Embedding(cfg.max_position_embeddings, d)
        tm.encoder = nn.Module()
        tm.encoder.layers = nn.ModuleList(_TextLayer(cfg) for _ in range(cfg.num_hidden_layers))
        tm.final_layer_norm = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        tm.head = nn.Linear(d, d)
        self.text_model = tm
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith("bias"):
                    p.zero_()
                elif "layer_norm" in name:
                    p.fill_(1.0)
                else:
                    p.copy_(0.02 * torch.randn(p.shape, generator=generator))
        self.requires_grad_(False)
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.text_model.head.weight.device

    def forward(self, input_ids: torch.Tensor) -> Dict[str, torch.Tensor]:
        return forward(self, input_ids)


def _act(cfg: SiglipTextConfig, x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh" if cfg.hidden_act == "gelu_pytorch_tanh" else "none")


def forward(model: SiglipTextEncoder, input_ids: torch.Tensor) -> Dict[str, torch.Tensor]:
    """input_ids: (B, L) integer ids, padded to the tokenizer's max length,
    moved to the model's device. Returns ``last_hidden_state`` (B, L, D) and
    ``pooler_output`` (B, D), fp32. The attention is un-masked over the full
    padded length (the model attends to padding, as HF SigLIP does)."""
    cfg = model.cfg
    tm = model.text_model
    ids = torch.as_tensor(input_ids).to(device=model.device, dtype=torch.long)
    b, l = ids.shape
    h, dh, eps = cfg.num_attention_heads, cfg.head_dim, cfg.layer_norm_eps
    x = tm.embeddings.token_embedding.weight[ids] + tm.embeddings.position_embedding.weight[None, :l]
    for layer in tm.encoder.layers:
        y = F.layer_norm(x, x.shape[-1:], layer.layer_norm1.weight, layer.layer_norm1.bias, eps)
        attn = layer.self_attn
        q = attn.q_proj(y).view(b, l, h, dh).transpose(1, 2)
        k = attn.k_proj(y).view(b, l, h, dh).transpose(1, 2)
        v = attn.v_proj(y).view(b, l, h, dh).transpose(1, 2)
        probs = torch.softmax(torch.matmul(q, k.transpose(-1, -2)).float() * dh**-0.5, dim=-1)
        ctx = torch.matmul(probs.to(x.dtype), v).transpose(1, 2).reshape(b, l, h * dh)
        x = x + attn.out_proj(ctx)
        y = F.layer_norm(x, x.shape[-1:], layer.layer_norm2.weight, layer.layer_norm2.bias, eps)
        x = x + layer.mlp.fc2(_act(cfg, layer.mlp.fc1(y)))
    x = F.layer_norm(x, x.shape[-1:], tm.final_layer_norm.weight, tm.final_layer_norm.bias, eps)
    return {"last_hidden_state": x, "pooler_output": tm.head(x[:, -1])}
