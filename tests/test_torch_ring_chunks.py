"""Lockstep multi-frame appends to the port's pos-major ring, on the CPU.

The port runs a chunk of t frames on the ring as one t=1 decode per frame
inside each layer (kernel A, or F on an int8 cache), frame ti at position
len + ti. That is the function of the JAX package's
``_ring_attend_pos_major`` einsum: query p sees positions (p - C, p], and of
t > C frames only the last C stay. Held against the JAX package in fp32
within the repo's 1e-3, and against the port's own t=1 steps.
"""

import pytest
import torch

import jax
import jax.numpy as jnp

from streamformer_tpu.models import encoder as jax_encoder
from streamformer_tpu_torch.models import encoder

from test_torch_encoder import ATOL, _max_err, _pair, _video

CAP = 4


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these tensors are tiny, and the 6-worker run
    oversubscribes the cores with each worker's default thread pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("chunks", [[2, 2, 2, 2], [CAP + 3, 3], [1, 2, CAP + 3]],
                         ids=["t2", "t_past_C", "mixed"])
def test_ring_chunks_match_jax(chunks):
    """Chunks of 2 and of C + 3 frames: outputs and the ring's planes. A
    chunk longer than ``num_frames`` (4) stretches the time table in both
    packages alike (``streaming_forward`` interpolates to max(hint, t))."""
    jcfg, params, cfg, model = _pair(cache_mode="ring", cache_capacity=CAP)
    b = 2
    px = _video(b, sum(chunks), seed=5)
    jparams = jax.tree.map(jnp.asarray, params)
    step = jax.jit(lambda p, f, c: jax_encoder.streaming_forward(p, f, c, jcfg))
    jcache = jax_encoder.init_cache(jcfg, batch=b)
    cache = encoder.init_cache(cfg, b, device="cpu")
    lo = 0
    for t in chunks:
        ref, jcache = step(jparams, jnp.asarray(px[:, lo:lo + t]), jcache)
        got, cache = encoder.streaming_forward(model, torch.from_numpy(px[:, lo:lo + t]), cache)
        for key in ("last_hidden_state", "pooler_output"):
            assert got[key].shape == ref[key].shape
            assert _max_err(got[key], ref[key]) <= ATOL, (key, lo, t)
        lo += t
    assert int(cache["len"]) == int(jcache["len"]) == lo
    for mine, theirs in zip(cache["layers"], jcache["layers"]):
        for key in ("k", "v"):
            assert _max_err(mine[key], theirs[key]) <= ATOL


def _steps_and_chunks(chunks, **overrides):
    """The port's outputs for one clip fed as t=1 steps and as ``chunks``,
    both with the time table of the longest chunk."""
    _, _, cfg, model = _pair(cache_mode="ring", cache_capacity=CAP, **overrides)
    px = torch.from_numpy(_video(2, sum(chunks), seed=7))
    hint = max(cfg.num_frames, *chunks)
    steps = model.init_cache(2)
    ones = [encoder.streaming_forward(model, px[:, i:i + 1], steps, total_frames_hint=hint)[0]
            for i in range(px.shape[1])]
    chunked, lo, outs = model.init_cache(2), 0, []
    for t in chunks:
        outs.append(encoder.streaming_forward(model, px[:, lo:lo + t], chunked,
                                              total_frames_hint=hint)[0])
        lo += t
    single = {k: torch.cat([o[k] for o in ones], dim=1) for k in ones[0]}
    multi = {k: torch.cat([o[k] for o in outs], dim=1) for k in outs[0]}
    return single, multi, steps, chunked


def test_ring_chunks_equal_t1_steps():
    """Float ring: a chunk is t t=1 decodes per layer, so it equals t=1
    steps up to the rounding of products of another row count."""
    single, multi, steps, chunked = _steps_and_chunks([CAP + 3, 2, 1])
    for key in single:
        assert _max_err(single[key], multi[key]) <= 1e-5, key
    for a, b in zip(steps["layers"], chunked["layers"]):
        assert _max_err(a["k"], b["k"]) <= 1e-5


def test_int8_ring_chunks_equal_t1_steps_exactly():
    """Int8 ring (kernel F's plain version once per frame): chunks equal the
    port's t=1 steps exactly, hidden states, codes and scales; the pooled
    output to fp32 rounding (the MAP head's products over another number of
    frames)."""
    single, multi, steps, chunked = _steps_and_chunks([2, CAP + 3, 1], cache_dtype="int8")
    assert torch.equal(single["last_hidden_state"], multi["last_hidden_state"])
    assert _max_err(single["pooler_output"], multi["pooler_output"]) <= 1e-6
    for a, b in zip(steps["layers"], chunked["layers"]):
        for key in ("k", "v", "k_scale", "v_scale"):
            assert torch.equal(a[key], b[key]), key


def test_int8_ring_chunks_match_jax():
    """The int8 ring in chunks against the JAX package's einsum ring, which
    attends its new frames unquantized where the port's kernel F attends
    them dequantized (ROADMAP section 3): within the repo's 1e-3."""
    jcfg, params, cfg, model = _pair(cache_mode="ring", cache_capacity=CAP, cache_dtype="int8")
    px = _video(2, 9, seed=3)
    jparams = jax.tree.map(jnp.asarray, params)
    step = jax.jit(lambda p, f, c: jax_encoder.streaming_forward(p, f, c, jcfg))
    jcache = jax_encoder.init_cache(jcfg, batch=2)
    cache = model.init_cache(2)
    lo = 0
    for t in (3, CAP + 2):
        ref, jcache = step(jparams, jnp.asarray(px[:, lo:lo + t]), jcache)
        got, cache = model.stream(torch.from_numpy(px[:, lo:lo + t]), cache)
        assert _max_err(got["pooler_output"], ref["pooler_output"]) <= ATOL, lo
        lo += t


def test_ring_chunk_refusals():
    """Multi-frame appends to a ragged ring, and partial appends to any
    ring, raise (the JAX package refuses both)."""
    _, _, cfg, model = _pair(cache_mode="ring", cache_capacity=CAP)
    x = torch.zeros(2, 2, 3, 48, 48)
    with pytest.raises(NotImplementedError, match="lockstep-only"):
        model.stream(x, model.init_cache(2, per_stream_len=True))
    with pytest.raises(ValueError, match="ring"):
        model.stream(x, model.init_cache(2, per_stream_len=True),
                     new_valid=torch.tensor([1, 2], dtype=torch.int32))
