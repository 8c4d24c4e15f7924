"""The port's HF checkpoint writer (``checkpoint/hf_export.py``) against the
JAX package's: the same state dict bit for bit (LoRA included), a
directory the JAX package's ``hf_import`` loads, a round trip through the
port's ``from_pretrained`` bit for bit, and a ``model.safetensors``, written
without the ``safetensors`` package, that the package reads."""

import json
import os

import numpy as np
import pytest
import torch
from safetensors.numpy import load_file

import jax
import jax.numpy as jnp

from streamformer_tpu.checkpoint import hf_export as jax_hf_export
from streamformer_tpu.checkpoint import hf_import as jax_hf_import
from streamformer_tpu.config import StreamformerConfig as JaxConfig
from streamformer_tpu.models import encoder as jax_encoder
from streamformer_tpu_torch.checkpoint import from_pretrained, params_from_jax, save_pretrained
from streamformer_tpu_torch.checkpoint import hf_export
from streamformer_tpu_torch.config import StreamformerConfig
from streamformer_tpu_torch.models import encoder

KW = dict(image_size=32, patch_size=16, num_frames=4, hidden_size=64, num_hidden_layers=2,
          num_attention_heads=4, intermediate_size=128, dtype="float32")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these tensors are tiny, and the 6-worker run
    oversubscribes the cores with each worker's default thread pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(lora):
    """A JAX tree with every leaf open (gates, biases, LoRA factors), and the
    port's encoder on the same weights."""
    kw = dict(KW, add_lora_spatial=lora, lora_rank=4)
    jcfg = JaxConfig(use_pallas=False, **kw)
    params = jax.tree.map(np.asarray, jax_encoder.init_params(jax.random.PRNGKey(3), jcfg))
    rng = np.random.default_rng(4)
    d = KW["hidden_size"]
    for key in ("position_embeddings", "time_embeddings"):
        shape = params["embeddings"][key].shape
        params["embeddings"][key] = 0.1 * rng.standard_normal(shape).astype(np.float32)
    for lp in params["layers"]:
        lp["temporal_attention_gating"] = np.asarray(rng.uniform(0.2, 0.8), np.float32)
        for name, width in (("qkv", 3 * d), ("out", d)):
            lp["attention"][name]["bias"] = 0.02 * rng.standard_normal(width).astype(np.float32)
            if lora:
                draw = rng.standard_normal
                lp["attention"][name]["lora_a"] = 0.05 * draw((d, 4)).astype(np.float32)
                lp["attention"][name]["lora_b"] = 0.05 * draw((4, width)).astype(np.float32)
    cfg = StreamformerConfig(**kw)
    model = encoder.StreamformerEncoder(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params, cfg))
    return jcfg, params, cfg, model


@pytest.mark.parametrize("lora", [False, True], ids=["plain", "lora"])
def test_state_dict_equals_the_jax_writers(lora):
    jcfg, params, _, model = _pair(lora)
    want = jax_hf_export.backbone_to_state_dict(params, jcfg, prefix="timesformer.")
    got = hf_export.backbone_to_state_dict(model, prefix="timesformer.")
    assert sorted(got) == sorted(want)
    assert any("_lora_a.weight" in k for k in got) == lora
    for k, ref in want.items():
        x = got[k]
        assert x.dtype == torch.float32 and x.is_contiguous(), k
        assert tuple(x.shape) == ref.shape, k
        np.testing.assert_array_equal(x.numpy(), ref, err_msg=k)


def test_directory_loads_in_the_jax_package_and_round_trips(tmp_path):
    """``save_pretrained`` writes config.json and model.safetensors; the
    safetensors package reads the file as written; JAX ``hf_import`` loads
    the directory and its ``model_forward`` sits within 1e-5 of the port's;
    the port's ``from_pretrained`` gives back every parameter bit for bit,
    at fp32 and (the serving encoder) bf16."""
    jcfg, params, cfg, model = _pair(lora=True)
    path = str(tmp_path / "ckpt")
    nbytes = save_pretrained(path, model, cfg)
    assert nbytes == os.path.getsize(os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "config.json")) as f:
        assert json.load(f)["add_lora_spatial"] is True

    read = load_file(os.path.join(path, "model.safetensors"))
    sd = model.state_dict()
    assert sorted(read) == sorted(sd)
    for k, v in sd.items():
        assert read[k].dtype == np.float32
        np.testing.assert_array_equal(read[k], v.numpy(), err_msg=k)

    jcfg2, jparams = jax_hf_import.from_pretrained(path)
    assert jcfg2.add_lora_spatial and jcfg2.hidden_size == KW["hidden_size"]
    px = np.random.default_rng(5).standard_normal((2, 4, 3, 32, 32)).astype(np.float32)
    want = jax_encoder.model_forward(jparams, jnp.asarray(px), jcfg.replace(use_pallas=False))
    got = encoder.model_forward(model, torch.from_numpy(px))
    for key in ("pooler_output", "last_hidden_state"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-5, rtol=0)

    back = from_pretrained(path, device="cpu")
    for k, v in back.state_dict().items():
        assert torch.equal(v, sd[k]), k
    served = encoder.StreamformerEncoder(cfg.replace(dtype="bfloat16"), device="cpu")
    served.load_state_dict(sd)
    save_pretrained(str(tmp_path / "bf16"), served, served.cfg)
    again = from_pretrained(str(tmp_path / "bf16"), device="cpu")
    for k, v in again.state_dict().items():
        assert v.dtype == served.state_dict()[k].dtype and torch.equal(v, served.state_dict()[k]), k


def test_safetensors_codec_round_trips_every_dtype(tmp_path):
    """``write_safetensors`` / ``read_safetensors`` on the dtypes a
    checkpoint holds, an empty tensor and a strided view (written as its
    values, not its buffer); the package reads the same values."""
    g = torch.Generator().manual_seed(6)
    base = torch.randn(3, 4, generator=g)
    tensors = {"f32": base, "t": base.t(), "bf16": base.to(torch.bfloat16),
               "i64": torch.arange(5), "i8": torch.arange(-3, 3, dtype=torch.int8),
               "flag": torch.tensor([True, False]), "empty": torch.zeros(0, 2)}
    path = str(tmp_path / "x.safetensors")
    hf_export.write_safetensors(path, tensors)
    back = hf_export.read_safetensors(path)
    assert sorted(back) == sorted(tensors)
    for k, v in tensors.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k
    read = load_file(path)
    np.testing.assert_array_equal(read["t"], base.t().numpy())
    np.testing.assert_array_equal(read["i64"], np.arange(5))
