"""The port's SigLIP text tower against the JAX package's, on the CPU in
fp32, weights carried across by ``checkpoint.convert.text_params_from_jax``.

Tolerance 1e-5 max-abs: one fp32 function, two orders of summation.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from streamformer_tpu.models import text_encoder as jax_text
from streamformer_tpu_torch.checkpoint import text_params_from_jax
from streamformer_tpu_torch.models import text_encoder

KW = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
          intermediate_size=64, max_position_embeddings=8)
ATOL = 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these tensors are tiny, and the 6-worker run
    oversubscribes the cores with each worker's default thread pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(seed=0, **overrides):
    kw = dict(KW, **overrides)
    jcfg = jax_text.SiglipTextConfig(**kw)
    params = jax.tree.map(np.asarray, jax_text.init_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    for layer in params["layers"]:  # biases matter
        for key in ("q", "k", "v", "out"):
            layer["attn"][key]["bias"] = 0.05 * rng.standard_normal(kw["hidden_size"]).astype(np.float32)
    model = text_encoder.SiglipTextEncoder(text_encoder.SiglipTextConfig(**kw), device="cpu")
    model.load_state_dict(text_params_from_jax(params))
    return jcfg, params, model


def _ids(b, l, seed=1):
    return np.random.default_rng(seed).integers(0, KW["vocab_size"], (b, l)).astype(np.int32)


def test_forward_matches_jax():
    jcfg, params, model = _pair()
    ids = _ids(3, 8)
    ref = jax_text.forward(jax.tree.map(jnp.asarray, params), jnp.asarray(ids), jcfg)
    got = model(torch.from_numpy(ids))
    assert got["last_hidden_state"].shape == (3, 8, 32) and got["pooler_output"].shape == (3, 32)
    for key in ref:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), atol=ATOL, rtol=0,
                                   err_msg=key)


def test_forward_matches_jax_shorter_than_the_position_table_exact_gelu():
    jcfg, params, model = _pair(seed=2, hidden_act="gelu")
    ids = _ids(2, 5, seed=3)
    ref = jax_text.forward(jax.tree.map(jnp.asarray, params), jnp.asarray(ids), jcfg)
    got = text_encoder.forward(model, ids)  # numpy ids are taken as they are
    np.testing.assert_allclose(got["pooler_output"].numpy(), np.asarray(ref["pooler_output"]),
                               atol=ATOL, rtol=0)


def test_state_dict_carries_the_hf_names_the_jax_converter_reads():
    """The port's state dict, read by the JAX package's own HF converter,
    gives back the tree the weights came from."""
    jcfg, params, model = _pair(seed=4)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    assert "text_model.encoder.layers.1.self_attn.q_proj.weight" in sd
    back = jax_text.convert_torch_state_dict(sd, jcfg)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_the_tower_is_frozen_and_fp32():
    _, _, model = _pair()
    assert all(not p.requires_grad and p.dtype == torch.float32 for p in model.parameters())
    out = model(torch.from_numpy(_ids(1, 8)))
    assert not out["pooler_output"].requires_grad


def test_init_follows_the_jax_package():
    cfg = text_encoder.SiglipTextConfig(**KW)
    model = text_encoder.SiglipTextEncoder(cfg, device="cpu",
                                           generator=torch.Generator().manual_seed(0))
    again = text_encoder.SiglipTextEncoder(cfg, device="cpu",
                                           generator=torch.Generator().manual_seed(0))
    sd, sd2 = model.state_dict(), again.state_dict()
    assert all(torch.equal(sd[k], sd2[k]) for k in sd)
    assert float(sd["text_model.head.bias"].abs().max()) == 0.0
    assert float((sd["text_model.final_layer_norm.weight"] - 1).abs().max()) == 0.0
    std = float(sd["text_model.embeddings.token_embedding.weight"].std())
    assert 0.015 < std < 0.025
