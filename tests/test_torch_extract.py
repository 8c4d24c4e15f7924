"""The port's transforms and OAD feature extractor against the JAX package,
on the CPU in fp32.

Same weights (``params_from_jax``), same seeded uint8 frames. The
transforms agree within 1e-5; the extractor's three modes within the repo's
1e-3. The JAX extractor's engine runs the linear cache off its TPU kernels,
the port's the ring on the pos-major layout, which equals the linear cache
while a clip fits its capacity. The file-level functions read videos the test writes with
``cv2``.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from streamformer_tpu.data import transforms as jax_T
from streamformer_tpu.extract import oad as jax_oad
from streamformer_tpu_torch.data import transforms as T
from streamformer_tpu_torch.data import video_io
from streamformer_tpu_torch.extract import oad
from streamformer_tpu_torch.models import encoder
from streamformer_tpu_torch.serving import StreamingEngine

from test_torch_encoder import ATOL, _max_err, _pair

PIX_TOL = 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these tensors are tiny, and the 6-worker run
    oversubscribes the cores with each worker's default thread pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _frames(t, h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (t, h, w, 3), dtype=np.uint8)


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("src,dst", [((240, 320), (224, 299)), ((36, 40), (48, 53)),
                                     ((60, 45), (20, 15)), ((17, 17), (17, 17))],
                         ids=["shrink_224", "grow", "shrink_3x", "same"])
def test_resize_matches_jax(src, dst):
    """Shrinking antialiases as ``jax.image.resize`` does (the triangle kernel
    widened by the scale); growing is plain bilinear."""
    x = _frames(2, *src, seed=1)
    ref = jax_T.resize(jnp.asarray(x), dst)
    got = T.resize(torch.from_numpy(x), dst)
    assert got.shape == (2, *dst, 3) and got.dtype == torch.float32
    assert _max_err(got, ref) <= PIX_TOL


def _resize_weights_before_the_move(n_in, n_out):
    """The weights the training heads built before ``data.transforms`` took
    their helper over: each sample position rounded twice in fp32."""
    scale = n_out / n_in
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) / scale - 0.5
    taps = torch.arange(n_in, dtype=torch.float32)
    w = (1.0 - (sample[:, None] - taps[None, :]).abs() / max(1.0 / scale, 1.0)).clamp_min(0.0)
    return w / w.sum(dim=1, keepdim=True)


@pytest.mark.parametrize("n_in,n_out", [(14, 224), (3, 48), (16, 256), (14, 56), (3, 8),
                                        (5, 7), (16, 224), (4, 2)])
def test_resize_weights_keep_the_heads_and_move_nearer_jax(n_in, n_out):
    """``models.heads`` resizes its logits with ``linear_resize_weights``,
    which rounds each sample position once, as XLA's fused multiply-add
    does. Where the scale is a power of two (a patch grid grown to its mask
    at 16-pixel patches) the weights are the earlier ones bit for bit;
    elsewhere they are no farther from ``jax.image.resize``'s matrix."""
    ref = np.asarray(jax.image.resize(jnp.eye(n_in, dtype=jnp.float32), (n_out, n_in), "linear"))
    now = T.linear_resize_weights(n_in, n_out, torch.device("cpu")).numpy()
    before = _resize_weights_before_the_move(n_in, n_out).numpy()
    if math.log2(n_out / n_in).is_integer():
        np.testing.assert_array_equal(now, before)
    assert np.abs(now - ref).max() <= np.abs(before - ref).max()
    assert np.abs(now - ref).max() <= 3e-7


def test_crop_normalize_and_layout_match_jax():
    x = _frames(3, 240, 320, seed=2)
    ref = jax_T.center_crop(jax_T.resize_short_side(jnp.asarray(x), 224), (224, 224))
    got = T.center_crop(T.resize_short_side(torch.from_numpy(x), 224), (224, 224))
    assert got.shape == (3, 224, 224, 3)
    assert _max_err(got, ref) <= PIX_TOL
    np.testing.assert_allclose(T.normalize(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_T.normalize(jnp.asarray(x))), atol=PIX_TOL)
    np.testing.assert_array_equal(T.to_float(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax_T.to_float(jnp.asarray(x))))
    assert T.to_model_input(got).shape == (3, 3, 224, 224)


@pytest.mark.parametrize("size", [48, 224])
def test_preprocess_frames_matches_jax(size):
    x = _frames(2, 240, 320, seed=3)
    ref = jax_oad.preprocess_frames(x, size)
    got = oad.preprocess_frames(x, size, device="cpu")
    assert got.shape == (2, 3, size, size)
    assert _max_err(got, ref) <= PIX_TOL


def test_resample_to_fps_matches_jax():
    from streamformer_tpu.data import video_io as jax_io

    for args in ((0, 30.0), (10, 30.0, 24.0), (48, 24.0, 24.0), (7, 60.0, 24.0)):
        np.testing.assert_array_equal(video_io.resample_to_fps(*args),
                                      jax_io.resample_to_fps(*args))


# ---------------------------------------------------------------------------
# the extractor
# ---------------------------------------------------------------------------


def _setup(**overrides):
    jcfg, params, cfg, model = _pair(**overrides)
    return jcfg, jax.tree.map(jnp.asarray, params), model


def _clip(t, seed):
    """Preprocessed frames of a seeded 60x80 uint8 video at the SMALL size."""
    return oad.preprocess_frames(_frames(t, 60, 80, seed), 48, device="cpu")


@pytest.mark.parametrize("length,chunk", [(10, 6), (8, 4), (3, 4)])
def test_streaming_mode_matches_jax(length, chunk):
    """The ring at capacity 4 in chunks (a chunk of 6 stretches the time
    table past num_frames 4 in both packages alike); the padded tail is
    dropped."""
    jcfg, jparams, model = _setup(cache_capacity=4)
    px = _clip(length, seed=length)
    ref = jax_oad.extract_features_streaming(jparams, jcfg, jnp.asarray(px.numpy()), chunk=chunk)
    got = oad.extract_features_streaming(model, px, chunk=chunk)
    assert got.shape == (length, 96) and got.dtype == np.float32
    assert _max_err(got, ref) <= ATOL


@pytest.mark.parametrize("length", [10, 9, 3])
def test_windowed_mode_matches_jax(length):
    """Windows of 6 every 4 frames; an overhanging window slides back onto
    real frames, and a clip shorter than the window is one window."""
    jcfg, jparams, model = _setup()
    px = _clip(length, seed=20 + length)
    ref = jax_oad.extract_features_windowed(jparams, jcfg, jnp.asarray(px.numpy()))
    got = oad.extract_features_windowed(model, px)
    assert got.shape == ref.shape
    assert _max_err(got, ref) <= ATOL


@pytest.mark.parametrize("slots", [2, 3])
def test_batched_mode_matches_jax(slots):
    """Five clips (one empty) over two or three slots. The JAX package's
    engine runs its linear cache here, the port's its ring, which is the
    same context while the clips fit the capacity; ticks of 4 frames, so
    that neither package stretches the time table (a tick of more than
    num_frames would, ROADMAP section 3)."""
    jcfg, jparams, model = _setup(cache_capacity=8)
    clips = [_clip(n, seed=30 + n) for n in (5, 0, 8, 3, 7)]
    ref = jax_oad.extract_features_batched(jparams, jcfg, [jnp.asarray(c.numpy()) for c in clips],
                                           slots=slots, frames_per_tick=4)
    got = oad.extract_features_batched(model, clips, slots=slots, frames_per_tick=4)
    assert [g.shape for g in got] == [(5, 96), (0, 96), (8, 96), (3, 96), (7, 96)]
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        if len(g):
            assert _max_err(g, r) <= ATOL


def test_batched_mode_equals_streaming_mode_past_the_capacity():
    """The ring engine holds each clip to its streaming-mode features, also
    past the capacity; one frame a tick, so that the time tables agree."""
    _, _, model = _setup(cache_capacity=4)
    clips = [_clip(n, seed=40 + n) for n in (9, 4, 6)]
    got = oad.extract_features_batched(model, clips, slots=2, frames_per_tick=1)
    for g, c in zip(got, clips):
        assert _max_err(g, oad.extract_features_streaming(model, c, chunk=1)) <= 1e-5


def test_linear_batched_mode_refuses_a_clip_past_the_capacity():
    """On the row-major layout the engine's mode is the linear cache (as in
    the JAX package): a clip past its capacity is refused before any work."""
    _, _, model = _setup(cache_capacity=4, cache_layout="row_major")
    assert encoder.auto_cache_mode(model.cfg) == "linear"
    with pytest.raises(ValueError, match="exceeds the cache capacity"):
        oad.extract_features_batched(model, [_clip(3, 1), _clip(5, 2)])


def test_a_call_that_raised_midway_leaves_nothing_behind(monkeypatch):
    """The JAX extractor memoizes its engines, so a call that raises with
    streams in its slots hands the next call a dirty engine. The port builds
    one per call: after a call that raises midway, a clean call gives the
    features of a fresh run."""
    _, _, model = _setup(cache_capacity=8)
    clips = [_clip(n, seed=50 + n) for n in (6, 4, 7)]
    want = oad.extract_features_batched(model, clips, slots=2)
    ticks = {"n": 0}
    real_tick = StreamingEngine.tick

    def failing_tick(self, frames=1):
        ticks["n"] += 1
        if ticks["n"] == 3:
            raise RuntimeError("interrupted")
        return real_tick(self, frames)

    monkeypatch.setattr(StreamingEngine, "tick", failing_tick)
    with pytest.raises(RuntimeError, match="interrupted"):
        oad.extract_features_batched(model, clips, slots=2)
    monkeypatch.setattr(StreamingEngine, "tick", real_tick)
    got = oad.extract_features_batched(model, clips, slots=2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _write_videos(tmp_path, lens, seed=5):
    import cv2

    rng = np.random.default_rng(seed)
    paths = []
    for i, n in enumerate(lens):
        p = str(tmp_path / f"v{i}.avi")
        vw = cv2.VideoWriter(p, cv2.VideoWriter_fourcc(*"MJPG"), 24.0, (40, 36))
        for _ in range(n):
            vw.write(rng.integers(0, 255, (36, 40, 3), np.uint8))
        vw.release()
        paths.append(p)
    return paths


def test_video_files_match_jax(tmp_path):
    """The file-level functions: videos written with cv2, decoded, resampled to 24
    fps, preprocessed, extracted in all three modes and saved as .npy; each
    against the JAX package's functions on the same files."""
    jcfg, jparams, model = _setup(cache_capacity=8)
    paths = _write_videos(tmp_path, [4, 6, 3])
    frames, fps = video_io.read_video_full(paths[1])
    assert frames.shape == (6, 36, 40, 3) and frames.dtype == np.uint8 and fps == 24.0
    for mode in ("streaming", "windowed"):
        out = str(tmp_path / mode / "v1.npy")
        got = oad.extract_video(model, paths[1], out_path=out, mode=mode)
        ref = jax_oad.extract_video(jparams, jcfg, paths[1], mode=mode)
        assert _max_err(got, ref) <= ATOL, mode
        np.testing.assert_array_equal(np.load(out), got)
    out_dir = str(tmp_path / "feats")
    got = oad.extract_videos_batched(model, paths, out_dir=out_dir, slots=2, group=2,
                                     frames_per_tick=4)
    ref = jax_oad.extract_videos_batched(jparams, jcfg, paths, slots=2, group=2,
                                         frames_per_tick=4)
    assert [g.shape for g in got] == [(4, 96), (6, 96), (3, 96)]
    for i, (g, r) in enumerate(zip(got, ref)):
        assert _max_err(g, r) <= ATOL
        np.testing.assert_array_equal(np.load(str(tmp_path / "feats" / f"v{i}.npy")), g)


def test_a_video_that_fails_to_decode_raises(tmp_path):
    bad = tmp_path / "bad.avi"
    bad.write_bytes(b"not a video")
    _, _, model = _setup()
    with pytest.raises((IOError, RuntimeError)):
        oad.extract_videos_batched(model, _write_videos(tmp_path, [3]) + [str(bad)], group=1)
    with pytest.raises(ValueError, match="mode"):
        oad.extract_video(model, _write_videos(tmp_path, [2])[0], mode="frames")
