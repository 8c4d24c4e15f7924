"""The port's ragged (per-stream length) cache against the JAX package, on
the CPU in fp32: ``init_cache(per_stream_len=True)``, ``reset_streams``,
per-stream time embeddings and ``new_valid`` partial appends through
``streaming_forward``.

Same weights and numpy inputs go through both; the bar is the repo's 1e-3
max-abs (tests/test_encoder_parity.py), on the output columns a stream
really appended. On the CPU the port runs kernels D and E's plain versions.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from streamformer_tpu.models import encoder as jax_encoder
from streamformer_tpu_torch.models import encoder

from test_torch_encoder import ATOL, _max_err, _pair, _video


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these tensors are tiny, and the 6-worker run
    oversubscribes the cores with each worker's default thread pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jit_step(jcfg):
    return jax.jit(lambda p, f, c, nv: jax_encoder.streaming_forward(p, f, c, jcfg, new_valid=nv))


def _same_cache(cache, jcache, upto):
    """len equal; K/V equal within ATOL at each stream's slots < upto[b]. The
    JAX cache pads each stream's rows to a multiple of 8; the port's does
    not, so stream b's rows start at b * n in the one and b * n_pad in the
    other."""
    assert cache["len"].tolist() == np.asarray(jcache["len"]).tolist()
    n = cache["layers"][0]["k"].shape[1] // len(upto)
    n_pad = jcache["layers"][0]["k"].shape[1] // len(upto)
    for mine, ref in zip(cache["layers"], jcache["layers"]):
        for key in ("k", "v"):
            for b, u in enumerate(upto):
                assert _max_err(mine[key][:u, b * n:(b + 1) * n],
                                np.asarray(ref[key])[:u, b * n_pad:b * n_pad + n]) <= ATOL, (key, b)


def test_ragged_t1_at_mixed_lengths_matches_jax():
    """Streams joining at steps 0, 2 and 3 through ``reset_streams``: every
    t=1 step (kernel D's plain version) equals the JAX ragged step."""
    jcfg, params, cfg, model = _pair(cache_capacity=8)
    b, steps, join = 3, 6, [0, 2, 3]
    px = _video(b, steps, seed=11)
    jparams = jax.tree.map(jnp.asarray, params)
    step = jax.jit(lambda p, f, c: jax_encoder.streaming_forward(p, f, c, jcfg))
    jcache = jax_encoder.init_cache(jcfg, batch=b, per_stream_len=True)
    cache = encoder.init_cache(cfg, b, per_stream_len=True, device="cpu")
    assert cache["len"].shape == (b,) and cache["layers"][0]["k"].shape == (8, b * 9, 96)
    for s in range(steps):
        done = np.asarray([j == s for j in join])
        jcache = jax_encoder.reset_streams(jcache, jnp.asarray(done))
        assert encoder.reset_streams(cache, torch.from_numpy(done)) is cache
        ref, jcache = step(jparams, jnp.asarray(px[:, s:s + 1]), jcache)
        got, cache = encoder.streaming_forward(model, torch.from_numpy(px[:, s:s + 1]), cache)
        assert _max_err(got["last_hidden_state"], ref["last_hidden_state"]) <= ATOL, s
        assert _max_err(got["pooler_output"], ref["pooler_output"]) <= ATOL, s
    assert cache["len"].tolist() == [steps - j for j in join]
    _same_cache(cache, jcache, [steps - j for j in join])


def test_ragged_partial_append_matches_jax():
    """t=3 with ``new_valid = [3, 1, 0]`` at lens [2, 0, 4] (kernel E's plain
    version; tests/test_ragged_streaming.py's pattern): valid output
    columns, the advanced lens and the appended slots."""
    jcfg, params, cfg, model = _pair(cache_capacity=8)
    b, t = 3, 3
    valid, lens0 = [3, 1, 0], [2, 0, 4]
    px = _video(b, 7, seed=12)
    jparams = jax.tree.map(jnp.asarray, params)
    jstep = jax.jit(lambda p, f, c: jax_encoder.streaming_forward(p, f, c, jcfg))
    jcache = jax_encoder.init_cache(jcfg, batch=b, per_stream_len=True)
    cache = model.init_cache(b, per_stream_len=True)
    for s in range(max(lens0)):  # fill slots both runs share, then pin mixed lens
        _, jcache = jstep(jparams, jnp.asarray(px[:, s:s + 1]), jcache)
        model.stream(torch.from_numpy(px[:, s:s + 1]), cache)
    jcache = {**jcache, "len": jnp.asarray(lens0, jnp.int32)}
    cache["len"].copy_(torch.tensor(lens0, dtype=torch.int32))

    new = px[:, 4:4 + t]
    ref, jcache = _jit_step(jcfg)(jparams, jnp.asarray(new), jcache, jnp.asarray(valid, jnp.int32))
    got, cache = model.stream(torch.from_numpy(new), cache,
                              new_valid=torch.tensor(valid, dtype=torch.int32))
    for bq, v in enumerate(valid):
        if v:
            for key in ("last_hidden_state", "pooler_output"):
                assert _max_err(got[key][bq, :v], np.asarray(ref[key])[bq, :v]) <= ATOL, (key, bq)
    assert cache["len"].tolist() == [l + v for l, v in zip(lens0, valid)]
    _same_cache(cache, jcache, [l + v for l, v in zip(lens0, valid)])


def test_lockstep_multi_frame_append_matches_jax():
    """Lockstep t=3 on a linear cache (kernel E with one length for all
    rows), after two t=1 frames: the JAX package's einsum append."""
    jcfg, params, cfg, model = _pair(cache_capacity=8)
    px = _video(2, 5, seed=13)
    jparams = jax.tree.map(jnp.asarray, params)
    jstep = jax.jit(lambda p, f, c: jax_encoder.streaming_forward(p, f, c, jcfg))
    jcache = jax_encoder.init_cache(jcfg, batch=2)
    cache = encoder.init_cache(cfg, 2, device="cpu")
    for lo, hi in ((0, 1), (1, 2), (2, 5)):
        ref, jcache = jstep(jparams, jnp.asarray(px[:, lo:hi]), jcache)
        got, cache = encoder.streaming_forward(model, torch.from_numpy(px[:, lo:hi]), cache)
        assert _max_err(got["last_hidden_state"], ref["last_hidden_state"]) <= ATOL, lo
        assert _max_err(got["pooler_output"], ref["pooler_output"]) <= ATOL, lo
    assert int(cache["len"]) == int(jcache["len"]) == 5
    for mine, ref in zip(cache["layers"], jcache["layers"]):
        assert _max_err(mine["k"][:5], np.asarray(ref["k"])[:5]) <= ATOL
        assert _max_err(mine["v"][:5], np.asarray(ref["v"])[:5]) <= ATOL


def test_ragged_ring_rows_match_lone_jax_ring_streams():
    """The ragged ring, which the JAX CPU path cannot run: each port row at
    its own position past the capacity equals a JAX lockstep ring stream of
    B=1 fed the same frames (kernel D's plain version; slot len % C
    excluded and overwritten per stream)."""
    jcfg, params, cfg, model = _pair(cache_mode="ring", cache_capacity=4)
    b, steps, join = 3, 9, [0, 1, 3]
    px = _video(b, steps, seed=14)
    cache = model.init_cache(b, per_stream_len=True)
    got = []
    for s in range(steps):
        encoder.reset_streams(cache, torch.tensor([j == s for j in join]))
        out, cache = model.stream(torch.from_numpy(px[:, s:s + 1]), cache)
        got.append(out["pooler_output"][:, 0].numpy())
    assert cache["len"].tolist() == [steps - j for j in join]  # all past C = 4

    jparams = jax.tree.map(jnp.asarray, params)
    jstep = jax.jit(lambda p, f, c: jax_encoder.streaming_forward(p, f, c, jcfg))
    for row, j in enumerate(join):
        jcache = jax_encoder.init_cache(jcfg, batch=1)
        for s in range(j, steps):
            ref, jcache = jstep(jparams, jnp.asarray(px[row:row + 1, s:s + 1]), jcache)
            assert _max_err(got[s][row], ref["pooler_output"][0, 0]) <= ATOL, (row, s)


@pytest.mark.parametrize("start", [[0, 2, 5], [3, 7, 1]])
def test_per_stream_time_embeddings_match_jax(start):
    """(B,) starts give (B, t, D), clamped past the table and interpolated
    past the trained length, as the JAX package's."""
    table = np.random.default_rng(2).standard_normal((4, 8)).astype(np.float32)
    for t_new, total in ((1, 4), (3, 4), (2, 10)):
        ref = jax_encoder.time_embeddings_for_positions(
            jnp.asarray(table), jnp.asarray(start, jnp.int32), t_new, total)
        got = encoder.time_embeddings_for_positions(
            torch.from_numpy(table), torch.tensor(start, dtype=torch.int32), t_new, total)
        assert got.shape == (3, t_new, 8)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_ragged_contract_checks():
    """What the ragged path refuses: ``new_valid`` on a lockstep cache,
    ``reset_streams`` on one, and multi-frame appends to the ring."""
    _, _, cfg, model = _pair(cache_capacity=8)
    x = torch.zeros(2, 2, 3, 48, 48)
    with pytest.raises(ValueError, match="per_stream_len"):
        model.stream(x, model.init_cache(2), new_valid=torch.tensor([1, 2], dtype=torch.int32))
    with pytest.raises(ValueError, match="per_stream_len"):
        encoder.reset_streams(model.init_cache(2), torch.tensor([True, False]))
    ring = encoder.StreamformerEncoder(cfg.replace(cache_mode="ring"), device="cpu")
    with pytest.raises(NotImplementedError, match="ring"):
        ring.stream(x, ring.init_cache(2, per_stream_len=True))
    assert encoder.auto_cache_mode(cfg) == "ring"
    assert encoder.auto_cache_mode(cfg.replace(cache_layout="row_major")) == "linear"
