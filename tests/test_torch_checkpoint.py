"""Weights into the PyTorch port: ``convert.params_from_jax`` against the JAX
package's ``hf_export`` mapping, and ``from_pretrained`` on directories the
JAX package writes, in each format it reads."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from streamformer_tpu.config import StreamformerConfig as JaxConfig
from streamformer_tpu.checkpoint import hf_export
from streamformer_tpu.models import encoder as jax_encoder
from streamformer_tpu_torch.checkpoint import from_pretrained, params_from_jax
from streamformer_tpu_torch.config import StreamformerConfig
from streamformer_tpu_torch.models import encoder

KW = dict(
    image_size=48,
    patch_size=16,
    num_frames=4,
    hidden_size=96,
    num_hidden_layers=2,
    num_attention_heads=4,
    intermediate_size=192,
    dtype="float32",
)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these tensors are tiny, and the 6-worker run
    oversubscribes the cores with each worker's default thread pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _params(cfg, lora=False):
    params = jax.tree.map(np.asarray, jax_encoder.init_params(jax.random.PRNGKey(2), cfg))
    rng = np.random.default_rng(0)
    for lp in params["layers"]:
        lp["temporal_attention_gating"] = np.asarray(0.4, np.float32)
        if lora:
            for name, width in (("qkv", 3 * cfg.hidden_size), ("out", cfg.hidden_size)):
                lp["attention"][name]["lora_a"] = rng.standard_normal((cfg.hidden_size, 8)).astype(np.float32)
                lp["attention"][name]["lora_b"] = rng.standard_normal((8, width)).astype(np.float32)
    return params


@pytest.mark.parametrize("lora", [False, True])
def test_params_from_jax_matches_hf_export(lora):
    cfg = JaxConfig(**KW)
    params = _params(cfg, lora)
    ref = hf_export.backbone_to_state_dict(params, cfg)
    got = params_from_jax(params, StreamformerConfig(**KW))
    assert sorted(got) == sorted(ref)
    for key, value in ref.items():
        assert got[key].dtype == torch.float32
        np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)
    # the keys are exactly the module's parameters
    model = encoder.StreamformerEncoder(
        StreamformerConfig(**KW, add_lora_spatial=lora, lora_rank=8), device="cpu"
    )
    assert sorted(model.state_dict()) == sorted(got)


def _write(tmp_path, params, cfg, fmt):
    """A checkpoint directory in one of the layouts from_pretrained reads."""
    path = str(tmp_path / fmt)
    if fmt == "safetensors":
        hf_export.save_pretrained(path, params, cfg)
        return path
    cfg.save_pretrained(path)
    sd = hf_export.backbone_to_state_dict(params, cfg, prefix="timesformer.")
    sd["task_heads.cls.weight"] = np.zeros((3, 3), np.float32)  # not the encoder's
    if fmt == "bin":
        torch.save({k: torch.tensor(v) for k, v in sd.items()},
                   os.path.join(path, "pytorch_model.bin"))
    else:  # two safetensors shards behind an index
        from safetensors.numpy import save_file

        keys = sorted(sd)
        shards = {"model-00001-of-00002.safetensors": keys[::2],
                  "model-00002-of-00002.safetensors": keys[1::2]}
        for name, part in shards.items():
            save_file({k: sd[k] for k in part}, os.path.join(path, name))
        weight_map = {k: name for name, part in shards.items() for k in part}
        with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
            json.dump({"weight_map": weight_map}, f)
    return path


@pytest.mark.parametrize("fmt", ["safetensors", "bin", "sharded"])
def test_from_pretrained_reads_what_jax_writes(tmp_path, fmt):
    cfg = JaxConfig(use_pallas=False, **KW)
    params = _params(cfg)
    model = from_pretrained(_write(tmp_path, params, cfg, fmt), device="cpu")
    assert model.cfg == StreamformerConfig(**KW, use_pallas=False)
    px = np.random.default_rng(4).standard_normal((1, 4, 3, 48, 48)).astype(np.float32)
    ref = jax_encoder.model_forward(jax.tree.map(jnp.asarray, params), jnp.asarray(px), cfg)
    got = encoder.model_forward(model, torch.from_numpy(px))
    for key in ("last_hidden_state", "pooler_output"):
        assert np.max(np.abs(got[key].numpy() - np.asarray(ref[key]))) <= 1e-3


def test_from_pretrained_fails_loudly(tmp_path):
    cfg = JaxConfig(**KW)
    with pytest.raises(FileNotFoundError):
        cfg.save_pretrained(str(tmp_path / "empty"))
        from_pretrained(str(tmp_path / "empty"), device="cpu")
    sd = hf_export.backbone_to_state_dict(_params(cfg), cfg)
    del sd["head.probe"]
    from safetensors.numpy import save_file

    cfg.save_pretrained(str(tmp_path / "partial"))
    save_file(sd, str(tmp_path / "partial" / "model.safetensors"))
    with pytest.raises(KeyError, match="head.probe"):
        from_pretrained(str(tmp_path / "partial"), device="cpu")


def test_one_config_json_serves_both_packages(tmp_path):
    jcfg = JaxConfig(cache_mode="ring", cache_capacity=8, **KW)
    jcfg.save_pretrained(str(tmp_path))
    cfg = StreamformerConfig.from_pretrained(str(tmp_path))
    assert cfg.to_dict() == jcfg.to_dict()
    cfg.replace(num_frames=8).save_pretrained(str(tmp_path))
    assert JaxConfig.from_pretrained(str(tmp_path)) == jcfg.replace(num_frames=8)
