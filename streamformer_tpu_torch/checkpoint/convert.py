"""Carry weights from the JAX package's parameter tree to the port.

``params_from_jax`` maps the JAX encoder's parameter tree (nested dicts and
lists of numpy arrays, e.g. ``jax.tree.map(np.asarray, params)``) to the
reference checkpoint's state-dict names, which are also the names of
``StreamformerEncoder``'s parameters. It is the port's own numpy copy of
the mapping the JAX package writes checkpoints with: dense kernels (in, out)
are transposed to torch's (out, in), the patch projection goes HWIO -> OIHW,
and the MAP head's q/k/v are concatenated into ``in_proj_weight``.

A quantized tree (``quantize_encoder_params``: ``kernel_q`` int8 and
``kernel_scale`` leaves) maps to the state of ``ops.quant.Int8Linear``:
``weight`` int8 (out, in) and ``weight_scale``; the MAP head's q/k/v codes
and scales are concatenated along the output rows. Load it into a model
quantized at the same threshold (``quant.quantize_encoder``).

``text_params_from_jax`` maps the JAX text tower's tree to the HF
``SiglipTextModel`` names that ``models.text_encoder.SiglipTextEncoder``
holds, and ``multitask_from_jax`` the whole ``MultitaskModel`` tree
(``backbone``, ``text``, ``logit_scale``, ``logit_bias``) to the state dict
of the port's ``MultitaskModel``, so both packages train from the same
weights. ``lm_params_from_jax`` maps the JAX language model's tree (float,
or int8 from ``quantize_encoder_params``: ``kernel_q`` leaves and the
untied head's ``lm_head_q`` / ``lm_head_scale``) to the HF names of
``models.language_model.LanguageModel``, and ``projector_params_from_jax``
the VideoQA projector to ``downstream.videoqa.MMProjector``;
``classifier_params_from_jax`` the action-recognition head to
``downstream.ar.ClassifierHead``. ``lstr_params_from_jax``,
``adapter_params_from_jax`` and ``segmentor_params_from_jax`` map the OAD
detector's, the ViT-Adapter's and the Mask2Former segmentor's trees, whose
port modules keep the JAX keys as names: dense kernels (in, out) become
``nn.Linear`` weights (out, in), HWIO conv kernels (a depthwise (kh, kw, 1,
C) one too) OIHW, the adapter's transposed-conv kernel torch's (in, out,
kh, kw) flipped in space (``jax.lax.conv_transpose`` does not flip its
kernel, ``F.conv_transpose2d`` does), norms' ``scale`` ``weight``. The maps are linear (transposes, reshapes, concatenations and
renames), so they carry a JAX gradient tree to the port's names as well.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from streamformer_tpu_torch.config import StreamformerConfig


def _a(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, np.float32))


def _t(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, np.float32).T)


def _q(p) -> np.ndarray:
    """int8 (in, out) kernel codes -> (out, in)."""
    return np.ascontiguousarray(np.asarray(p["kernel_q"], np.int8).T)


def params_from_jax(params: Mapping[str, Any], cfg: StreamformerConfig) -> Dict[str, torch.Tensor]:
    """JAX encoder parameter tree (numpy leaves) -> fp32 state dict (int8
    codes with fp32 scales for the dense layers of a quantized tree)."""
    sd: Dict[str, np.ndarray] = {}
    emb = params["embeddings"]
    sd["embeddings.patch_embeddings.projection.weight"] = np.ascontiguousarray(
        np.transpose(_a(emb["patch_proj"]["kernel"]), (3, 2, 0, 1))
    )
    sd["embeddings.patch_embeddings.projection.bias"] = _a(emb["patch_proj"]["bias"])
    sd["embeddings.position_embeddings"] = _a(emb["position_embeddings"])[None]
    if "time_embeddings" in emb:
        sd["embeddings.time_embeddings"] = _a(emb["time_embeddings"])[None]

    def dense(name, p, lora_name=None):
        if "kernel_q" in p:
            sd[name + ".weight"] = _q(p)
            sd[name + ".weight_scale"] = _a(p["kernel_scale"])
        else:
            sd[name + ".weight"] = _t(p["kernel"])
        if "bias" in p:
            sd[name + ".bias"] = _a(p["bias"])
        if lora_name and "lora_a" in p:
            sd[lora_name + "_lora_a.weight"] = _t(p["lora_a"])
            sd[lora_name + "_lora_b.weight"] = _t(p["lora_b"])

    def ln(name, p):
        sd[name + ".weight"] = _a(p["scale"])
        sd[name + ".bias"] = _a(p["bias"])

    for i, layer in enumerate(params["layers"]):
        lp = f"encoder.layer.{i}."
        ln(lp + "layernorm_before", layer["layernorm_before"])
        ln(lp + "layernorm_after", layer["layernorm_after"])
        dense(lp + "attention.attention.qkv", layer["attention"]["qkv"],
              lp + "attention.attention.qkv")
        dense(lp + "attention.output.dense", layer["attention"]["out"],
              lp + "attention.output.dense")
        dense(lp + "intermediate.dense", layer["mlp"]["fc1"])
        dense(lp + "output.dense", layer["mlp"]["fc2"])
        if "temporal_attention" in layer:
            ln(lp + "temporal_layernorm", layer["temporal_layernorm"])
            dense(lp + "temporal_attention.attention.qkv", layer["temporal_attention"]["qkv"])
            dense(lp + "temporal_attention.output.dense", layer["temporal_attention"]["out"])
            dense(lp + "temporal_dense", layer["temporal_dense"])
            sd[lp + "temporal_attention_gating"] = _a(layer["temporal_attention_gating"]).reshape(())

    ln("post_layernorm", params["post_layernorm"])
    mh = params["map_head"]
    d = cfg.hidden_size
    sd["head.probe"] = _a(mh["probe"]).reshape(1, 1, d)
    if "kernel_q" in mh["q"]:
        sd["head.attention.in_proj_weight"] = np.concatenate([_q(mh[key]) for key in "qkv"], 0)
        sd["head.attention.in_proj_weight_scale"] = np.concatenate(
            [_a(mh[key]["kernel_scale"]) for key in "qkv"])
    else:
        sd["head.attention.in_proj_weight"] = np.concatenate([_t(mh[key]["kernel"]) for key in "qkv"], 0)
    sd["head.attention.in_proj_bias"] = np.concatenate([_a(mh[key]["bias"]) for key in "qkv"])
    dense("head.attention.out_proj", mh["out"])
    ln("head.layernorm", mh["layernorm"])
    dense("head.mlp.fc1", mh["mlp"]["fc1"])
    dense("head.mlp.fc2", mh["mlp"]["fc2"])
    return {k: torch.tensor(v) for k, v in sd.items()}


def text_params_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX text-tower parameter tree (numpy leaves) -> fp32 state dict under
    the HF ``SiglipTextModel`` names (``text_model.`` prefix)."""
    sd: Dict[str, np.ndarray] = {}

    def dense(name, p):
        sd[name + ".weight"] = _t(p["kernel"])
        sd[name + ".bias"] = _a(p["bias"])

    def ln(name, p):
        sd[name + ".weight"] = _a(p["scale"])
        sd[name + ".bias"] = _a(p["bias"])

    sd["text_model.embeddings.token_embedding.weight"] = _a(params["token_embedding"])
    sd["text_model.embeddings.position_embedding.weight"] = _a(params["position_embedding"])
    for i, layer in enumerate(params["layers"]):
        lp = f"text_model.encoder.layers.{i}."
        ln(lp + "layer_norm1", layer["layer_norm1"])
        for key in ("q", "k", "v", "out"):
            dense(lp + f"self_attn.{key}_proj", layer["attn"][key])
        ln(lp + "layer_norm2", layer["layer_norm2"])
        dense(lp + "mlp.fc1", layer["mlp"]["fc1"])
        dense(lp + "mlp.fc2", layer["mlp"]["fc2"])
    ln("text_model.final_layer_norm", params["final_layer_norm"])
    dense("text_model.head", params["head"])
    return {k: torch.tensor(v) for k, v in sd.items()}


def multitask_from_jax(params: Mapping[str, Any], cfg: StreamformerConfig) -> Dict[str, torch.Tensor]:
    """The JAX ``MultitaskModel.params`` tree (numpy leaves), or a gradient
    tree of the same structure, -> the state dict of the port's
    ``MultitaskModel``. A tree without ``text`` (a gradient taken with
    respect to the trainable leaves only) maps without it."""
    sd = {"backbone." + k: v for k, v in params_from_jax(params["backbone"], cfg).items()}
    if "text" in params:
        sd.update({"text." + k: v for k, v in text_params_from_jax(params["text"]).items()})
    sd["logit_scale"] = torch.tensor(_a(params["logit_scale"]).reshape(()))
    sd["logit_bias"] = torch.tensor(_a(params["logit_bias"]).reshape(()))
    return sd


def lm_params_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX language-model parameter tree (numpy leaves) -> the state dict of
    ``LanguageModel`` (fp32, or int8 codes with fp32 scales for the dense
    layers and head of a quantized tree; load that into a model quantized at
    the same threshold, ``quant.quantize_lm``)."""
    sd: Dict[str, np.ndarray] = {}

    def dense(name, p):
        if "kernel_q" in p:
            sd[name + ".weight"] = _q(p)
            sd[name + ".weight_scale"] = _a(p["kernel_scale"])
        else:
            sd[name + ".weight"] = _t(p["kernel"])
        if "bias" in p:
            sd[name + ".bias"] = _a(p["bias"])

    sd["model.embed_tokens.weight"] = _a(params["embed_tokens"])
    for i, layer in enumerate(params["layers"]):
        lp = f"model.layers.{i}."
        sd[lp + "input_layernorm.weight"] = _a(layer["input_layernorm"])
        sd[lp + "post_attention_layernorm.weight"] = _a(layer["post_attention_layernorm"])
        for key in "qkvo":
            dense(lp + f"self_attn.{key}_proj", layer["attn"][key])
        for key in ("gate", "up", "down"):
            dense(lp + f"mlp.{key}_proj", layer["mlp"][key])
    sd["model.norm.weight"] = _a(params["norm"])
    if "lm_head_q" in params:
        sd["lm_head.weight"] = _q({"kernel_q": params["lm_head_q"]})
        sd["lm_head.weight_scale"] = _a(params["lm_head_scale"])
    elif "lm_head" in params:
        sd["lm_head.weight"] = _t(params["lm_head"])
    return {k: torch.tensor(v) for k, v in sd.items()}


def projector_params_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``mlp2x_gelu`` projector tree -> ``MMProjector``'s state dict."""
    return {f"{fc}.{leaf}": torch.tensor(_t(params[fc]["kernel"]) if leaf == "weight"
                                         else _a(params[fc]["bias"]))
            for fc in ("fc1", "fc2") for leaf in ("weight", "bias")}


def classifier_params_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX action-recognition head ``{fc_norm, classifier}`` (kernel (D,
    C)) -> ``downstream.ar.ClassifierHead``'s state dict."""
    return {"fc_norm.weight": torch.tensor(_a(params["fc_norm"]["scale"])),
            "fc_norm.bias": torch.tensor(_a(params["fc_norm"]["bias"])),
            "classifier.weight": torch.tensor(_t(params["classifier"]["kernel"])),
            "classifier.bias": torch.tensor(_a(params["classifier"]["bias"]))}


def _tree_sd(tree: Any, prefix: str = "", rename: Optional[Mapping[str, str]] = None
             ) -> Dict[str, np.ndarray]:
    """A JAX tree of dicts and lists -> dotted port names: a dense or 1x1
    conv ``{kernel, bias}`` -> ``.weight`` / ``.bias`` (transposed), a norm
    ``{scale, bias}`` -> ``.weight`` / ``.bias``, a bare HWIO kernel ->
    ``.weight`` OIHW, any other leaf as it is. ``rename`` maps JAX keys to
    port names."""
    sd: Dict[str, np.ndarray] = {}
    if isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            sd.update(_tree_sd(v, f"{prefix}{i}.", rename))
    elif isinstance(tree, Mapping) and "kernel" in tree:
        k = np.asarray(tree["kernel"], np.float32)
        sd[prefix + "weight"] = _t(k) if k.ndim == 2 else np.ascontiguousarray(k.transpose(3, 2, 0, 1))
        if "bias" in tree:
            sd[prefix + "bias"] = _a(tree["bias"])
    elif isinstance(tree, Mapping) and "scale" in tree:
        sd[prefix + "weight"] = _a(tree["scale"])
        sd[prefix + "bias"] = _a(tree["bias"])
    elif isinstance(tree, Mapping):
        for k, v in tree.items():
            sd.update(_tree_sd(v, f"{prefix}{(rename or {}).get(k, k)}.", rename))
    else:
        leaf = np.asarray(tree, np.float32)
        name = prefix[:-1]
        if leaf.ndim == 4:
            sd[name + ".weight"] = np.ascontiguousarray(leaf.transpose(3, 2, 0, 1))
        else:
            sd[name] = _a(leaf)
    return sd


def lstr_params_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX LSTR/MAT tree (``oad_lstr.init_params``), or a gradient tree
    of it, -> the state dict of ``downstream.oad_lstr.LSTR``."""
    return {k: torch.tensor(v) for k, v in _tree_sd(params).items()}


def adapter_params_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX ViT-Adapter tree (``adapter.init_adapter_params``), or a
    gradient tree of it, -> the state dict of ``models.adapter.Adapter``."""
    sd = _tree_sd({k: v for k, v in params.items() if k != "up"})
    up = np.asarray(params["up"]["kernel"], np.float32)  # (kh, kw, in, out), unflipped
    sd["up.weight"] = np.ascontiguousarray(up.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1])
    sd["up.bias"] = _a(params["up"]["bias"])
    return {k: torch.tensor(v) for k, v in sd.items()}


def segmentor_params_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX segmentor tree (``segmentor.init_segmentor``), or a gradient
    tree of it, -> the state dict of ``downstream.segmentor.Segmentor``."""
    sd = _tree_sd(params, rename={"self": "self_attn", "cross": "cross_attn"})
    return {k: torch.tensor(v) for k, v in sd.items()}
