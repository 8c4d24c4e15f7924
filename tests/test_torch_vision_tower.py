"""The port's streaming vision tower against the JAX package's, on the CPU in
fp32, within the repo's 1e-3.

Same weights (``params_from_jax``) and frames. The JAX tower chunks a
linear call at its kernel's ``APPEND_T_MAX``, the port at
``min(append_frame_cap(C), num_frames)`` (``num_frames`` at every capacity
these tests take): both are contract-equal to one append of the call's
frames.
Both interpolate the time table to max(num_frames, capacity).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from streamformer_tpu.downstream.vision_tower import TimesformerVisionTower as JaxTower
from streamformer_tpu_torch.downstream.vision_tower import TimesformerVisionTower
from streamformer_tpu_torch.models import encoder
from streamformer_tpu_torch.ops import attention as ops

from test_torch_encoder import ATOL, _max_err, _pair, _video


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these tensors are tiny, and the 6-worker run
    oversubscribes the cores with each worker's default thread pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _towers(context_length=16, **overrides):
    jcfg, params, cfg, model = _pair(streaming_mode=True, **overrides)
    jax_tower = JaxTower(jcfg, jax.tree.map(jnp.asarray, params), context_length=context_length)
    return jax_tower, TimesformerVisionTower(model, context_length=context_length)


def _feed(towers, calls, seed=4, b=2):
    """Feed both towers the same calls of frames; every returned context
    within 1e-3. Returns the port's last context."""
    jax_tower, tower = towers
    px = _video(b, sum(calls), seed=seed)
    lo = 0
    for t in calls:
        ref = jax_tower(jnp.asarray(px[:, lo:lo + t]))
        got = tower(torch.from_numpy(px[:, lo:lo + t]))
        assert got.shape == ref.shape, (lo, t)
        assert _max_err(got, ref) <= ATOL, (lo, t)
        lo += t
    return got


@pytest.mark.parametrize("calls", [[3, 2, 1, 2], [1] * 5, [8]], ids=["mixed", "t1", "whole"])
def test_linear_tower_matches_jax(calls):
    """Linear cache at capacity 8 (> num_frames 4: the time table is
    interpolated to 8 in both); the port appends in chunks of 4."""
    towers = _towers(cache_capacity=8)
    assert towers[1]._chunk() == 4
    _feed(towers, calls)


def test_linear_tower_at_a_large_capacity_appends_one_frame_a_call():
    """Capacity 32, which once filled kernel E's keys (the port then took
    one frame a call): kernel E's plan takes any capacity that fits a
    block, so the port appends in chunks of ``num_frames`` (4), the JAX
    tower in chunks of 8; the same function."""
    towers = _towers(cache_capacity=32)
    assert towers[1]._chunk() == 4
    _feed(towers, [3, 5, 1])


def test_linear_tower_at_capacity_64_chunks_equal_single_frames(monkeypatch):
    """Capacity 64 (past the 32 keys kernel E once held) appends calls of 3,
    4 and 9 frames in chunks of ``num_frames`` through kernel E (its plain
    version here); the same frames one a call (kernel D) give every context
    within 1e-5 (fp32, two orders of summation)."""
    _, chunked = _towers(cache_capacity=64)
    _, single = _towers(cache_capacity=64)
    assert chunked._chunk() == 4
    appends = []
    orig = ops.temporal_append_pm_qkv
    monkeypatch.setattr(ops, "temporal_append_pm_qkv",
                        lambda *a: appends.append(a[0].shape[1]) or orig(*a))
    px = torch.from_numpy(_video(2, 16, seed=5))
    lo = 0
    for t in (3, 4, 9):
        got = chunked(px[:, lo:lo + t])
        for i in range(lo, lo + t):
            want = single(px[:, i:i + 1])
        assert got.shape == want.shape
        assert (got - want).abs().max().item() <= 1e-5, (lo, t)
        lo += t
    layers = chunked.cfg.num_hidden_layers
    assert appends == [3] * layers + [4] * layers + [4] * (2 * layers)  # the 1-frame rest: D


@pytest.mark.parametrize("calls", [[3, 3, 2], [6, 1], [1] * 6], ids=["mixed", "t_past_C", "t1"])
def test_ring_tower_matches_jax(calls):
    """The ring at capacity 4 on the lockstep cache: a call of t frames is
    t decodes a layer (the port's multi-frame ring append), unbounded."""
    _feed(_towers(cache_capacity=4, cache_mode="ring"), calls)


def test_context_length_and_forward_none():
    """The LLM sees the last ``context_length`` frames; ``forward(None)``
    returns the held context without consuming frames."""
    towers = _towers(context_length=3, cache_capacity=8)
    got = _feed(towers, [2, 3])
    assert got.shape == (2, 3, 9, 96)
    again = towers[1](None)
    assert again is got
    np.testing.assert_allclose(again.numpy(), np.asarray(towers[0](None)), atol=ATOL)


def test_clear_cache_restarts_the_stream():
    jax_tower, tower = _towers(cache_capacity=8)
    px = torch.from_numpy(_video(2, 5, seed=6))
    first = tower(px[:, :2]).clone()
    tower(px[:, 2:5])
    tower.clear_cache()
    with pytest.raises(ValueError, match="no frames"):
        tower(None)
    assert torch.equal(tower(px[:, :2]), first)
    jax_tower(jnp.asarray(px[:, :2].numpy()))
    jax_tower.clear_cache()
    assert _max_err(first, jax_tower(jnp.asarray(px[:, :2].numpy()))) <= ATOL


def test_linear_tower_refuses_to_overflow():
    _, tower = _towers(cache_capacity=4)
    tower(torch.from_numpy(_video(1, 3, seed=1)))
    with pytest.raises(ValueError, match="exceeds cache_capacity"):
        tower(torch.from_numpy(_video(1, 2, seed=2)))


def test_non_streaming_tower_is_the_full_clip():
    jcfg, params, cfg, model = _pair()
    px = _video(2, 4, seed=8)
    ref = JaxTower(jcfg, jax.tree.map(jnp.asarray, params), streaming_mode=False)(jnp.asarray(px))
    tower = TimesformerVisionTower(model, streaming_mode=False)
    got = tower(torch.from_numpy(px))
    assert _max_err(got, ref) <= ATOL
    with pytest.raises(ValueError, match="not in streaming mode"):
        tower(None)


def test_preprocess_matches_jax():
    jcfg, params, cfg, model = _pair()
    x = np.random.default_rng(3).integers(0, 256, (2, 60, 80, 3), dtype=np.uint8)
    ref = JaxTower(jcfg, jax.tree.map(jnp.asarray, params)).preprocess(x)
    got = TimesformerVisionTower(model).preprocess(x)
    assert got.shape == (2, 3, 48, 48)
    assert _max_err(got, ref) <= 1e-5


def test_tower_takes_the_kernels_paths():
    """On the CPU the wrappers run their plain versions and count nothing;
    what the tower sends them is the kernels' contract: the linear cache is
    the ragged cache, the ring the lockstep one."""
    _, linear = _towers(cache_capacity=8)
    _, ring = _towers(cache_capacity=4, cache_mode="ring")
    px = torch.from_numpy(_video(1, 2, seed=9))
    ops.reset_launches()
    linear(px)
    ring(px)
    assert not any(ops.LAUNCHES.values())
    assert linear._cache["len"].shape == (1,) and linear._cache["len"].tolist() == [2]
    assert ring._cache["len"].shape == () and int(ring._cache["len"]) == 2
    assert encoder.auto_cache_mode(linear.cfg) == "ring"
