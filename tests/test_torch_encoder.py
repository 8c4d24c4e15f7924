"""The PyTorch port's encoder against the JAX package, on the CPU in fp32.

Same weights (the JAX parameter tree carried over by
``convert.params_from_jax``) and the same numpy inputs go through both. The
bar is the repo's own: 1e-3 max-abs (test_encoder_parity.py). On the CPU the
port's attention runs the kernels' plain versions.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from streamformer_tpu.config import StreamformerConfig as JaxConfig
from streamformer_tpu.models import encoder as jax_encoder
from streamformer_tpu_torch.checkpoint import params_from_jax
from streamformer_tpu_torch.config import StreamformerConfig
from streamformer_tpu_torch.models import encoder

# tests/test_encoder_parity.py's small-but-faithful config
SMALL = dict(
    image_size=48,
    patch_size=16,
    num_frames=4,
    hidden_size=96,
    num_hidden_layers=3,
    num_attention_heads=4,
    intermediate_size=192,
    enable_causal_temporal=True,
    dtype="float32",
)
ATOL = 1e-3


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these tensors are tiny, and the 6-worker run
    oversubscribes the cores with each worker's default thread pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _max_err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))))


def _jax_params(cfg, seed=0, lora=False):
    """JAX init_params with the zero-initialised parts opened up, so the
    temporal path, the embeddings and the biases all matter."""
    params = jax.tree.map(np.asarray, jax_encoder.init_params(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed + 1)
    emb = params["embeddings"]
    for key in ("position_embeddings", "time_embeddings"):
        emb[key] = 0.1 * rng.standard_normal(emb[key].shape).astype(np.float32)
    for lp in params["layers"]:
        lp["temporal_attention_gating"] = np.asarray(0.7, np.float32)
        lp["attention"]["qkv"]["bias"] = 0.02 * rng.standard_normal(
            lp["attention"]["qkv"]["bias"].shape).astype(np.float32)
        if lora:
            d, r = cfg.hidden_size, cfg.lora_rank
            for name, width in (("qkv", 3 * d), ("out", d)):
                lp["attention"][name]["lora_a"] = 0.02 * rng.standard_normal((d, r)).astype(np.float32)
                lp["attention"][name]["lora_b"] = 0.02 * rng.standard_normal((r, width)).astype(np.float32)
    return params


def _pair(lora=False, **overrides):
    kw = dict(SMALL, **overrides)
    if lora:
        kw.update(add_lora_spatial=True, lora_rank=8)
    jcfg = JaxConfig(use_pallas=False, **kw)
    params = _jax_params(jcfg, lora=lora)
    cfg = StreamformerConfig(**kw)
    model = encoder.StreamformerEncoder(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params, cfg))
    return jcfg, params, cfg, model


def _jax_forward(jcfg):
    return jax.jit(lambda p, x: jax_encoder.model_forward(p, x, jcfg))


def _video(b, t, seed=3):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, t, 3, 48, 48)).astype(np.float32)


@pytest.mark.parametrize("t", [2, 4, 6])
def test_model_forward_matches_jax(t):
    """t=2 truncates the time table, t=4 is the trained length, t=6
    nearest-interpolates it."""
    jcfg, params, cfg, model = _pair()
    px = _video(2, t)
    ref = _jax_forward(jcfg)(jax.tree.map(jnp.asarray, params), jnp.asarray(px))
    got = encoder.model_forward(model, torch.from_numpy(px))
    assert got["last_hidden_state"].shape == (2, t, 9, 96)
    assert got["pooler_output"].shape == (2, t, 96)
    assert _max_err(got["last_hidden_state"], ref["last_hidden_state"]) <= ATOL
    assert _max_err(got["pooler_output"], ref["pooler_output"]) <= ATOL


def test_model_forward_with_lora_matches_jax():
    jcfg, params, cfg, model = _pair(lora=True)
    px = _video(1, 4)
    ref = _jax_forward(jcfg)(jax.tree.map(jnp.asarray, params), jnp.asarray(px))
    got = model(torch.from_numpy(px))
    assert "encoder.layer.0.attention.attention.qkv_lora_a.weight" in model.state_dict()
    assert _max_err(got["last_hidden_state"], ref["last_hidden_state"]) <= ATOL
    assert _max_err(got["pooler_output"], ref["pooler_output"]) <= ATOL


def _stream_both(mode, capacity, frames, b=2):
    jcfg, params, cfg, model = _pair(cache_mode=mode, cache_capacity=capacity)
    px = _video(b, frames, seed=5)
    jparams = jax.tree.map(jnp.asarray, params)
    jcache = jax_encoder.init_cache(jcfg, batch=b)
    step = jax.jit(lambda p, f, c: jax_encoder.streaming_forward(p, f, c, jcfg))
    cache = encoder.init_cache(cfg, b, device="cpu")
    for i in range(frames):
        ref, jcache = step(jparams, jnp.asarray(px[:, i:i + 1]), jcache)
        got, cache = encoder.streaming_forward(model, torch.from_numpy(px[:, i:i + 1]), cache)
        assert _max_err(got["last_hidden_state"], ref["last_hidden_state"]) <= ATOL, i
        assert _max_err(got["pooler_output"], ref["pooler_output"]) <= ATOL, i
    return jcache, cache


def test_streaming_linear_matches_jax():
    jcache, cache = _stream_both("linear", capacity=8, frames=6)
    assert int(cache["len"]) == int(jcache["len"]) == 6
    for mine, ref in zip(cache["layers"], jcache["layers"]):
        for key in ("k", "v"):
            assert mine[key].shape == ref[key].shape
            assert _max_err(mine[key][:6], ref[key][:6]) <= ATOL


def test_streaming_ring_matches_jax():
    """Ring over 2C frames: the kernel's slot-exclusion window == the JAX
    package's einsum ring."""
    jcache, cache = _stream_both("ring", capacity=4, frames=8)
    assert int(cache["len"]) == 8
    for mine, ref in zip(cache["layers"], jcache["layers"]):
        assert _max_err(mine["k"], ref["k"]) <= ATOL


def test_streaming_equals_full_clip():
    """The streaming contract inside the port: frame i's outputs equal
    frame i of a full-clip forward."""
    _, _, cfg, model = _pair(cache_capacity=4)
    px = torch.from_numpy(_video(2, 4, seed=7))
    full = model(px)
    cache = model.init_cache(2)
    for i in range(4):
        out, cache = model.stream(px[:, i:i + 1], cache)
        assert _max_err(out["last_hidden_state"], full["last_hidden_state"][:, i:i + 1]) <= 1e-4
        assert _max_err(out["pooler_output"], full["pooler_output"][:, i:i + 1]) <= 1e-4


@pytest.mark.parametrize("start,t_new,total", [(0, 4, 4), (1, 2, 4), (3, 1, 4), (6, 1, 4), (2, 3, 10)])
def test_time_embeddings_match_jax(start, t_new, total):
    """Direct index, clamp past the table, and nearest interpolation."""
    table = np.random.default_rng(0).standard_normal((4, 8)).astype(np.float32)
    ref = jax_encoder.time_embeddings_for_positions(jnp.asarray(table), jnp.asarray(start), t_new, total)
    got = encoder.time_embeddings_for_positions(
        torch.from_numpy(table), torch.tensor(start, dtype=torch.int32), t_new, total
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_gelu_follows_the_dtype():
    x = np.linspace(-4, 4, 101).astype(np.float32)
    exact = np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=False))
    tanh = np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=True))
    np.testing.assert_allclose(encoder.gelu(torch.from_numpy(x)).numpy(), exact, atol=1e-6)
    got_bf16 = encoder.gelu(torch.from_numpy(x).bfloat16()).float().numpy()
    assert np.max(np.abs(got_bf16 - tanh)) <= 0.04  # bf16 rounding at |x| <= 4
    np.testing.assert_allclose(encoder.act_fn(torch.from_numpy(x), "gelu_pytorch_tanh").numpy(),
                               tanh, atol=1e-6)


def test_out_of_slice_features_raise():
    """What the port refuses as the JAX package does (a ragged ring of
    several frames a call, a ragged row-major cache), and what earlier
    slices refused and now matches the JAX package: 33 frames in one call
    (kernel E past its whole-table plan, the time table stretched to 33),
    a float cache in another dtype than the compute dtype."""
    jcfg, params, cfg, model = _pair()
    jparams = jax.tree.map(jnp.asarray, params)
    px = _video(1, 33)
    jstep = jax.jit(lambda p, f, c: jax_encoder.streaming_forward(p, f, c, jcfg))
    jcache = jax_encoder.init_cache(jcfg.replace(cache_capacity=40), batch=1)
    cache = model.init_cache(1, capacity=40)
    for lo, hi in ((0, 33),):  # 33 frames in one call
        ref, jcache = jstep(jparams, jnp.asarray(px[:, lo:hi]), jcache)
        got, cache = model.stream(torch.from_numpy(px[:, lo:hi]), cache)
        for key in ("last_hidden_state", "pooler_output"):
            assert _max_err(got[key], ref[key]) <= ATOL, (lo, key)
    ring = encoder.StreamformerEncoder(cfg.replace(cache_mode="ring"), device="cpu")
    with pytest.raises(NotImplementedError):  # a ragged ring takes one frame per call
        ring.stream(torch.zeros(1, 2, 3, 48, 48), ring.init_cache(1, capacity=8,
                                                                  per_stream_len=True))
    mcfg, jmcfg = cfg.replace(cache_dtype="bfloat16"), jcfg.replace(cache_dtype="bfloat16")
    mixed = encoder.StreamformerEncoder(mcfg, device="cpu")
    mixed.load_state_dict(model.state_dict())
    jmstep = jax.jit(lambda p, f, c: jax_encoder.streaming_forward(p, f, c, jmcfg))
    jcache, cache = jax_encoder.init_cache(jmcfg, batch=1), mixed.init_cache(1)
    assert cache["layers"][0]["v"].dtype == torch.bfloat16
    for lo, hi in ((0, 3),):  # a float cache of another dtype
        ref, jcache = jmstep(jparams, jnp.asarray(px[:, lo:hi]), jcache)
        got, cache = mixed.stream(torch.from_numpy(px[:, lo:hi]), cache)
        for key in ("last_hidden_state", "pooler_output"):
            assert _max_err(got[key], ref[key]) <= ATOL, (lo, key)
    with pytest.raises(NotImplementedError):  # the row-major layout is lockstep only
        encoder.init_cache(cfg.replace(cache_layout="row_major"), 1, per_stream_len=True,
                           device="cpu")
    # another resolution than the trained one no longer raises: the position
    # table is resized as the JAX package resizes it (item 3a)
    px = np.random.default_rng(5).standard_normal((1, 2, 3, 64, 64)).astype(np.float32)
    got = model(torch.from_numpy(px))["last_hidden_state"]
    want = jax_encoder.model_forward(params, jnp.asarray(px), jcfg)["last_hidden_state"]
    assert got.shape == want.shape == (1, 2, 16, cfg.hidden_size)
    assert _max_err(got, want) <= ATOL
    # non-causal temporal attention, refused by the first slices: the full
    # clip matches the JAX package's
    ncfg, ncparams, _, nc_model = _pair(enable_causal_temporal=False)
    px = _video(1, 3)
    got = nc_model(torch.from_numpy(px))["last_hidden_state"]
    want = _jax_forward(ncfg)(jax.tree.map(jnp.asarray, ncparams),
                              jnp.asarray(px))["last_hidden_state"]
    assert _max_err(got, want) <= ATOL


def test_asking_for_the_card_without_one_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = StreamformerConfig(**SMALL)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        encoder.StreamformerEncoder(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        encoder.init_cache(cfg, 1)
