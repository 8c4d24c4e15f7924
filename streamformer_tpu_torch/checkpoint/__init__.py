"""Checkpoint loading for the port: HF-style directories and JAX parameter trees."""

from streamformer_tpu_torch.checkpoint.convert import (
    adapter_params_from_jax,
    classifier_params_from_jax,
    lm_params_from_jax,
    lstr_params_from_jax,
    multitask_from_jax,
    params_from_jax,
    projector_params_from_jax,
    segmentor_params_from_jax,
    text_params_from_jax,
)
from streamformer_tpu_torch.checkpoint.hf_export import save_pretrained
from streamformer_tpu_torch.checkpoint.hf_import import from_pretrained

__all__ = ["adapter_params_from_jax", "classifier_params_from_jax", "from_pretrained",
           "lm_params_from_jax", "lstr_params_from_jax", "multitask_from_jax", "params_from_jax",
           "projector_params_from_jax", "save_pretrained", "segmentor_params_from_jax",
           "text_params_from_jax"]
