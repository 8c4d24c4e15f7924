"""The port's ``StreamingEngine`` against the JAX package's, on the CPU in
fp32, and against lone streams of the port.

Same weights (carried over by ``convert.params_from_jax``) and the same
numpy frames go through both engines on the same schedules. Both run the
linear cache (the JAX package resolves "auto" to it on the CPU, the port to
the ring, so the mode is named). The bar is 1e-4 max-abs: the two compute
the same fp32 function in another order. Against the port's own lone B=1
streams the bar is 1e-5, as in tests/test_serving.py.
"""

import numpy as np
import pytest
import torch

import jax

from streamformer_tpu.config import StreamformerConfig as JaxConfig
from streamformer_tpu.serving import StreamingEngine as JaxEngine
from streamformer_tpu_torch.checkpoint import params_from_jax
from streamformer_tpu_torch.config import StreamformerConfig
from streamformer_tpu_torch.models import encoder
from streamformer_tpu_torch.serving import StreamingEngine

from test_torch_encoder import _jax_params

# tests/test_serving.py's CFG
SMALL = dict(image_size=32, patch_size=16, num_frames=8, hidden_size=64, num_hidden_layers=2,
             num_attention_heads=4, intermediate_size=128, dtype="float32", cache_capacity=16)
VS_JAX, VS_LONE = 1e-4, 1e-5
MEAN, STD = (0.481, 0.457, 0.408), (0.268, 0.261, 0.275)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these tensors are tiny, and the 6-worker run
    oversubscribes the cores with each worker's default thread pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pair():
    jcfg = JaxConfig(use_pallas=False, **SMALL)
    params = _jax_params(jcfg, seed=3)  # gates open, embeddings drawn
    cfg = StreamformerConfig(**SMALL)
    model = encoder.StreamformerEncoder(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params, cfg))
    return jcfg, jax.tree.map(np.asarray, params), model


def _clips(seed, lens, u8=False):
    rng = np.random.default_rng(seed)
    if u8:
        return [rng.integers(0, 256, (n, 3, 32, 32), dtype=np.uint8) for n in lens]
    return [rng.standard_normal((n, 3, 32, 32)).astype(np.float32) for n in lens]


def lone_stream(model, clip):
    """One frame at a time through a lone B=1 lockstep cache of the port."""
    cache = model.init_cache(1)
    out = []
    for i in range(len(clip)):
        o, cache = model.stream(torch.from_numpy(clip[None, i:i + 1]), cache)
        out.append(o["pooler_output"][0, 0].numpy())
    return np.stack(out)


def _serve(eng, clips, frames=1):
    sids = []
    for clip in clips:
        sid = eng.open()
        eng.feed(sid, clip)
        eng.close(sid)
        sids.append(sid)
    eng.run_until_idle(frames=frames)
    out = []
    for sid in sids:
        feats, done = eng.poll(sid)
        assert done
        out.append(feats)
    return out


def _held(eng, slow, fast):
    """A starved slot holds for three ticks, then resumes."""
    s_slow, s_fast = eng.open(), eng.open()
    eng.feed(s_fast, fast)
    eng.close(s_fast)
    eng.feed(s_slow, slow[:2])
    for _ in range(5):
        eng.tick()
    eng.feed(s_slow, slow[2:])
    eng.close(s_slow)
    eng.run_until_idle()
    return [eng.poll(s_slow)[0], eng.poll(s_fast)[0]]


@pytest.mark.parametrize("case", ["four_streams_two_slots", "holds", "frames4", "uint8"])
def test_engine_matches_jax_engine(pair, case):
    """The same schedule through both engines: FIFO admission into recycled
    slots, holds that pause and resume, the multi-frame tick (kernel E's
    plain version here, the JAX einsum append there), and uint8 staging
    with on-device normalize."""
    jcfg, params, model = pair
    kw = {}
    if case == "holds":
        slow, fast = _clips(1, [4, 8])
        run = lambda eng: _held(eng, slow, fast)
        ref_clips = [slow, fast]
    else:
        u8 = case == "uint8"
        clips = _clips(2, [3, 9, 2, 7], u8=u8)
        frames = 4 if case == "frames4" else 1
        if u8:
            kw = dict(stage_dtype="uint8", normalize=(MEAN, STD))
        run = lambda eng: _serve(eng, clips, frames)
        ref_clips = clips
    ref = run(JaxEngine(params, jcfg, slots=2, mode="linear", **kw))
    got = run(StreamingEngine(model, slots=2, mode="linear", **kw))
    for g, r, clip in zip(got, ref, ref_clips):
        assert g.shape == r.shape == (len(clip), 64)
        assert np.abs(g - r).max() <= VS_JAX


@pytest.mark.parametrize("mode,frames", [("linear", 1), ("linear", 4), ("linear", 12),
                                         ("ring", 1), ("ring", 4)])
def test_engine_matches_lone_streams(pair, mode, frames):
    """5 streams over 2 slots in both cache modes and tick modes. A 12-frame
    tick takes one chunk of 8 frames (``num_frames``) and one of 4."""
    _, _, model = pair
    clips = _clips(3, [3, 9, 2, 7, 5])
    eng = StreamingEngine(model, slots=2, mode=mode)
    for got, clip in zip(_serve(eng, clips, frames), clips):
        assert np.abs(got - lone_stream(model, clip)).max() <= VS_LONE


def test_throughput_ticks_at_capacity_64_equal_latency_ticks(pair, monkeypatch):
    """A linear engine of capacity 64 (past the 32 keys kernel E once held)
    runs throughput ticks on kernel E (its plain version here) in chunks of
    ``num_frames``: tick(frames=8) equals tick() within 1e-5."""
    from streamformer_tpu_torch.ops import attention as ops

    _, _, model = pair
    clips = _clips(5, [9, 20, 3])
    one = _serve(StreamingEngine(model, slots=2, capacity=64, mode="linear"), clips, 1)
    eng = StreamingEngine(model, slots=2, capacity=64, mode="linear")
    assert eng._chunk() == 8
    appends = []
    orig = ops.temporal_append_pm_qkv
    monkeypatch.setattr(ops, "temporal_append_pm_qkv",
                        lambda *a: appends.append(a[0].shape[1]) or orig(*a))
    eight = _serve(eng, clips, 8)
    assert appends and max(appends) == 8
    for a, b in zip(one, eight):
        assert a.shape == b.shape and np.abs(a - b).max() <= VS_LONE


def test_throughput_chunks_keep_the_trained_time_table():
    """A chunk longer than ``num_frames`` would stretch the time-embedding
    table over the chunk: the engine chunks at ``num_frames``, so
    tick(frames=8) at num_frames=4 equals tick(frames=1)."""
    cfg = StreamformerConfig(**dict(SMALL, num_frames=4))
    model = encoder.StreamformerEncoder(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.embeddings.time_embeddings.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(1))
        for layer in model.encoder.layer:
            layer.temporal_attention_gating.fill_(0.7)
    clips = _clips(4, [8, 5])
    one = _serve(StreamingEngine(model, slots=2, mode="linear"), clips, 1)
    eight = _serve(StreamingEngine(model, slots=2, mode="linear"), clips, 8)
    for a, b in zip(one, eight):
        assert np.abs(a - b).max() <= VS_LONE


def test_engine_linear_overflow_and_reclaim(pair):
    """feed() past the linear capacity raises; a finished stream's
    bookkeeping is reclaimed on the poll that sees it done, and it keeps
    answering (empty, True); the slot serves a later stream."""
    _, _, model = pair
    clip = _clips(5, [2])[0]
    eng = StreamingEngine(model, slots=1, mode="linear")
    sid = eng.open()
    eng.feed(sid, clip)
    with pytest.raises(ValueError, match="exceed"):
        eng.feed(sid, np.zeros((16, 3, 32, 32), np.float32))
    eng.close(sid)
    eng.run_until_idle()
    feats, done = eng.poll(sid)
    assert done and feats.shape == (2, 64)
    assert sid not in eng._results and sid not in eng._queues
    again, done = eng.poll(sid)
    assert done and again.shape == (0, 64)
    (second,) = _serve(eng, [clip])
    assert np.abs(second - lone_stream(model, clip)).max() <= VS_LONE


def test_engine_close_unadmitted_then_poll(pair):
    """A stream opened, closed with nothing fed and polled before it was
    ever admitted answers (empty, True) and leaves the queue clean."""
    _, _, model = pair
    eng = StreamingEngine(model, slots=1, mode="linear")
    busy = eng.open()
    eng.feed(busy, _clips(6, [2])[0])
    eng.tick()
    ghost = eng.open()
    eng.close(ghost)
    feats, done = eng.poll(ghost)
    assert done and feats.shape == (0, 64)
    eng.close(busy)
    eng.run_until_idle()
    feats, done = eng.poll(busy)
    assert done and feats.shape == (2, 64)
    with pytest.raises(ValueError, match="unknown stream"):
        eng.poll(999)


def test_engine_refusals(pair):
    """A starved open ring stream is an error (the ring cannot hold); a float
    feed into uint8 staging and a mesh are refused. A float cache in another
    dtype than the compute dtype, refused before, now serves, through
    kernel E's chunks as a cache of the compute dtype does: its streams
    equal lone streams on the same cache."""
    _, _, model = pair
    eng = StreamingEngine(model, slots=1, mode="ring")
    sid = eng.open()
    eng.feed(sid, _clips(7, [1])[0])
    eng.tick()
    with pytest.raises(RuntimeError, match="starved a ring-mode slot"):
        eng.tick()
    u8 = StreamingEngine(model, slots=1, stage_dtype="uint8")
    with pytest.raises(TypeError, match="uint8"):
        u8.feed(u8.open(), np.zeros((1, 3, 32, 32), np.float32))
    lin = StreamingEngine(model, slots=1, mode="linear")
    sid = lin.open()
    for bad in (np.zeros((2, 3, 32, 16), np.float32), np.zeros((3, 32, 32), np.float32)):
        with pytest.raises(ValueError, match="expected"):  # nothing queued or counted
            lin.feed(sid, bad)
    assert lin._fed[sid] == 0 and not lin._queues[sid] and not lin.has_work()
    with pytest.raises(ValueError, match="no axis 'data'"):
        StreamingEngine(model, slots=2, mesh=_StubMesh(("model",), 2))
    with pytest.raises(ValueError, match="must divide over mesh axis 'data'=3"):
        StreamingEngine(model, slots=2, mesh=_StubMesh(("data",), 3))
    cut = encoder.StreamformerEncoder(model.cfg, device="cpu")
    cut.parallel = object()  # as shard_encoder leaves it
    with pytest.raises(ValueError, match="replicated over the mesh"):
        StreamingEngine(cut, slots=2, mesh=_StubMesh(("data",), 2))
    mixed = encoder.StreamformerEncoder(model.cfg.replace(cache_dtype="bfloat16"), device="cpu")
    mixed.load_state_dict(model.state_dict())
    eng = StreamingEngine(mixed, slots=2, mode="linear")
    assert eng._cache["layers"][0]["k"].dtype == torch.bfloat16
    clips = _clips(9, [3, 2])
    got = _serve(eng, clips, frames=2)
    assert eng.forwards == 2  # E chunks of up to 2 frames, one a tick
    for feats, clip in zip(got, clips):
        np.testing.assert_allclose(feats, lone_stream(mixed, clip), atol=VS_LONE, rtol=0)


class _StubMesh:
    """A mesh's names and sizes, for the refusals made before any group is
    asked for (the multi-rank engine runs in ``test_torch_dist_serve.py``)."""

    def __init__(self, names, size):
        self.mesh_dim_names = names
        self._size = size

    def size(self, dim):
        return self._size


def test_engine_staging_wraps_and_overflows(pair):
    """A stream fed more frames than its staging ring holds waits in the host
    queue and is staged tick by tick, the writes wrapping around a ring
    whose depth is not a power of two (uint8 path)."""
    _, _, model = pair
    raw = _clips(8, [10], u8=True)[0]
    eng = StreamingEngine(model, slots=1, mode="linear", stage_depth=3, stage_dtype="uint8")
    sid = eng.open()
    eng.feed(sid, raw)
    assert eng._wr[0] == 3 and len(eng._queues[sid]) == 7
    eng.close(sid)
    eng.run_until_idle()
    feats, done = eng.poll(sid)
    assert done
    ref = lone_stream(model, raw.astype(np.float32) / 255.0)
    assert np.abs(feats - ref).max() <= VS_LONE


@pytest.mark.parametrize("seed", [0, 1])
def test_engine_fuzzed_schedules(pair, seed):
    """Random interleavings of open, feed, close, tick (1 or 3 frames) and
    poll over 2 slots: every stream equals its lone stream."""
    _, _, model = pair
    rng = np.random.default_rng(100 + seed)
    eng = StreamingEngine(model, slots=2, mode="linear")
    clips, next_frame, closed, acc, opened = {}, {}, set(), {}, []
    for _ in range(80):
        act = rng.choice(["open", "feed", "close", "tick", "poll"])
        live = [s for s in opened if s not in closed]
        if act == "open" and len(opened) < 6:
            sid = eng.open()
            opened.append(sid)
            clips[sid] = _clips(int(rng.integers(0, 1 << 20)), [int(rng.integers(1, 6))])[0]
            next_frame[sid], acc[sid] = 0, []
        elif act == "feed" and live:
            sid = int(rng.choice(live))
            pos = next_frame[sid]
            if pos < len(clips[sid]):
                k = int(rng.integers(1, len(clips[sid]) - pos + 1))
                eng.feed(sid, clips[sid][pos:pos + k])
                next_frame[sid] = pos + k
        elif act == "close" and live:
            sid = int(rng.choice(live))
            if next_frame[sid] == len(clips[sid]):
                eng.close(sid)
                closed.add(sid)
        elif act == "tick":
            eng.tick(frames=int(rng.choice([1, 3])))
        elif act == "poll" and opened:
            sid = int(rng.choice(opened))
            acc[sid].append(eng.poll(sid)[0])
    for sid in opened:
        if next_frame[sid] < len(clips[sid]):
            eng.feed(sid, clips[sid][next_frame[sid]:])
        if sid not in closed:
            eng.close(sid)
    eng.run_until_idle()
    for sid in opened:
        feats, done = eng.poll(sid)
        assert done, sid
        got = np.concatenate(acc[sid] + [feats])
        assert np.abs(got - lone_stream(model, clips[sid])).max() <= VS_LONE, (seed, sid)


def test_has_work_and_active_streams(pair):
    _, _, model = pair
    eng = StreamingEngine(model, slots=1, mode="linear")
    assert not eng.has_work() and not eng.tick()
    a, b = eng.open(), eng.open()
    assert not eng.has_work() and eng.active_streams() == 2
    eng.feed(b, _clips(9, [2])[0])  # b waits behind a, which has nothing
    assert not eng.has_work()
    eng.feed(a, _clips(10, [1])[0])
    assert eng.has_work()
