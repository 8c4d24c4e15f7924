"""The port's data path against the JAX package: the transforms and
RandAugment ops, RandomErasing, the samplers, frame sampling and decoding,
the datasets, ``build_multi_task_dataset``, the loader and the checker.

Inputs are seeded numpy arrays and videos written with cv2, 2-4 frames of
32-64 px. Tolerances, on the 0-255 scale: every deterministic transform and
RandAugment op within 1e-3, given the JAX op's own parameters, and exactly
where the JAX op is integer-exact (posterize, solarize, invert, equalize);
``scale_and_translate`` crops within 1e-4 (on the [0, 1] scale the loader
crops on); samplers, sample indices, decoded frames and dataset items
equal; eval-mode loader batches within 1e-6.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from streamformer_tpu.data import checker as jax_checker
from streamformer_tpu.data import collate as jax_collate
from streamformer_tpu.data import datasets as jax_D
from streamformer_tpu.data import rand_augment as jax_RA
from streamformer_tpu.data import random_erasing as jax_RE
from streamformer_tpu.data import samplers as jax_S
from streamformer_tpu.data import seg_datasets as jax_seg
from streamformer_tpu.data import transforms as jax_T
from streamformer_tpu.data import video_io as jax_vio
from streamformer_tpu.data.build import build_multi_task_dataset as jax_build
from streamformer_tpu_torch.data import checker, collate, samplers, seg_datasets, video_io
from streamformer_tpu_torch.data import datasets as D
from streamformer_tpu_torch.data import rand_augment as RA
from streamformer_tpu_torch.data import random_erasing as RE
from streamformer_tpu_torch.data import transforms as T
from streamformer_tpu_torch.data.build import build_multi_task_dataset

TOL = 1e-3  # 0-255 scale
EXACT = {"Posterize", "Solarize", "Invert", "Equalize"}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these tensors are tiny, and the 6-worker run
    oversubscribes the cores with each worker's default thread pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _clip(seed=0, t=2, h=40, w=56):
    return np.random.default_rng(seed).integers(0, 256, (t, h, w, 3)).astype(np.float32)


def _np(x):
    return np.asarray(x, np.float32)


def _port(fn, clip, *args):
    """A batched port op on one clip (batch of 1) -> numpy (T, H, W, C)."""
    return fn(torch.from_numpy(clip)[None], *args)[0].numpy()


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------


OPS = {
    "adjust_brightness": (lambda x: jax_T.adjust_brightness(x, 1.3),
                          lambda x: T.adjust_brightness(x, [1.3])),
    "adjust_contrast": (lambda x: jax_T.adjust_contrast(x, 0.6),
                        lambda x: T.adjust_contrast(x, [0.6])),
    "adjust_saturation": (lambda x: jax_T.adjust_saturation(x, 1.7),
                          lambda x: T.adjust_saturation(x, [1.7])),
    "adjust_sharpness": (lambda x: jax_T.adjust_sharpness(x, 1.6),
                         lambda x: T.adjust_sharpness(x, [1.6])),
    "invert": (jax_T.invert, T.invert),
    "posterize": (lambda x: jax_T.posterize(x, 3), lambda x: T.posterize(x, [3])),
    "solarize": (lambda x: jax_T.solarize(x, 100.0), lambda x: T.solarize(x, [100.0])),
    "solarize_add": (lambda x: jax_T.solarize_add(x, 40.0), lambda x: T.solarize_add(x, [40.0])),
    "autocontrast": (jax_T.autocontrast, T.autocontrast),
    "equalize": (jax_T.equalize, T.equalize),
    "horizontal_flip": (jax_T.horizontal_flip, T.horizontal_flip),
    "shear_x": (lambda x: jax_T.shear_x(x, jnp.float32(0.21)), lambda x: T.shear_x(x, [0.21])),
    "shear_y": (lambda x: jax_T.shear_y(x, jnp.float32(-0.17)), lambda x: T.shear_y(x, [-0.17])),
    "translate_x": (lambda x: jax_T.translate_x(x, jnp.float32(-7.3)),
                    lambda x: T.translate_x(x, [-7.3])),
    "translate_y": (lambda x: jax_T.translate_y(x, jnp.float32(5.6)),
                    lambda x: T.translate_y(x, [5.6])),
    "rotate": (lambda x: jax_T.rotate(x, jnp.float32(17.3)), lambda x: T.rotate(x, [17.3])),
    "affine_warp": (lambda x: jax_T._affine_warp(x, (0.9, 0.2, 3.5, -0.1, 1.1, -2.25)),
                    lambda x: T._affine_warp(x, torch.tensor([[0.9, 0.2, 3.5, -0.1, 1.1, -2.25]]))),
    "resample_rows": (lambda x: jax_T._resample_rows(x, jnp.asarray(_src(40, 56, 1)), 128.0),
                      lambda x: T._resample_rows(x, torch.from_numpy(_src(40, 56, 1))[None], 128.0)),
    "resample_cols": (lambda x: jax_T._resample_cols(x, jnp.asarray(_src(56, 40, 2)), 128.0),
                      lambda x: T._resample_cols(x, torch.from_numpy(_src(56, 40, 2))[None], 128.0)),
}


def _src(rows, n, seed):
    """Fractional source positions on an axis of n, some off its ends."""
    return np.random.default_rng(seed).uniform(-3.0, n + 2.0, (rows, n)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(OPS))
def test_transform_matches_jax(name):
    jax_fn, port_fn = OPS[name]
    clip = _clip()
    want = _np(jax_fn(jnp.asarray(clip)))
    got = _port(port_fn, clip)
    assert got.shape == want.shape
    if name in ("posterize", "solarize", "invert", "equalize", "horizontal_flip"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("method", ["bilinear", "bicubic", "nearest"])
@pytest.mark.parametrize("size", [(24, 30), (56, 80), (40, 33)])
def test_resize_methods_match_jax(method, size):
    clip = _clip(1).astype(np.uint8)
    want = _np(jax_T.resize(jnp.asarray(clip), size, method))
    got = T.resize(torch.from_numpy(clip), size, method).numpy()
    np.testing.assert_allclose(got * 255, want * 255, atol=TOL, rtol=0)
    short = T.resize_short_side(torch.from_numpy(clip), 32, method).numpy()
    np.testing.assert_allclose(short * 255, _np(jax_T.resize_short_side(jnp.asarray(clip), 32,
                                                                          method)) * 255,
                               atol=TOL, rtol=0)


def test_scale_jitter_matches_jax():
    clip = _clip(2).astype(np.uint8)
    want = _np(jax_T.random_short_side_scale_jitter(jax.random.PRNGKey(0), jnp.asarray(clip),
                                                    24, 36))
    got = T.random_short_side_scale_jitter(torch.from_numpy(clip), 24, 36).numpy()
    np.testing.assert_allclose(got * 255, want * 255, atol=TOL, rtol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_crop_and_flip_match_jax_with_its_draws(seed):
    clip = _clip(seed)
    key = jax.random.PRNGKey(seed)
    want = _np(jax_T.random_crop(key, jnp.asarray(clip), (24, 32)))
    ri, rj = jax.random.split(key)
    i = int(jax.random.randint(ri, (), 0, 40 - 24 + 1))
    j = int(jax.random.randint(rj, (), 0, 56 - 32 + 1))
    np.testing.assert_array_equal(_port(lambda x: T.crop_at(x, [i], [j], (24, 32)), clip), want)
    want = _np(jax_T.random_horizontal_flip(key, jnp.asarray(clip)))
    flip = bool(jax.random.bernoulli(key, 0.5))
    np.testing.assert_array_equal(_port(lambda x: T.flip_where(x, [flip]), clip), want)
    # the port's draws land inside the frame
    g = torch.Generator().manual_seed(seed)
    out = T.random_crop([g, g], torch.from_numpy(np.stack([clip, clip])), (24, 32))
    assert out.shape == (2, 2, 24, 32, 3)


def _jax_box(key, h, w, scale=(0.08, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0)):
    """JAX random_resized_crop's box from its key, in its fp32 arithmetic."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    target = h * w * jax.random.uniform(k1, (), minval=scale[0], maxval=scale[1])
    aspect = jnp.exp(jax.random.uniform(k2, (), minval=jnp.log(ratio[0]),
                                        maxval=jnp.log(ratio[1])))
    cw = jnp.clip(jnp.sqrt(target * aspect), 8.0, float(w))
    ch = jnp.clip(jnp.sqrt(target / aspect), 8.0, float(h))
    i = jax.random.uniform(k3, (), minval=0.0, maxval=1.0) * (h - ch)
    j = jax.random.uniform(k4, (), minval=0.0, maxval=1.0) * (w - cw)
    return tuple(float(v) for v in (i, j, ch, cw))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_resized_crop_matches_jax_with_its_box(seed):
    clip = _clip(seed, h=48, w=64) / 255.0
    key = jax.random.PRNGKey(seed)
    want = _np(jax_T.random_resized_crop(key, jnp.asarray(clip), (32, 32)))
    box = _jax_box(key, 48, 64)
    got = T.resized_crop(torch.from_numpy(clip)[None], [box], (32, 32))[0].numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("box", [(0.0, 0.0, 48.0, 64.0), (3.25, 7.5, 20.0, 26.5),
                                 (10.0, 2.0, 8.0, 9.0), (1.7, 40.1, 45.0, 23.9)])
@pytest.mark.parametrize("size", [(32, 32), (56, 40)])
def test_resized_crop_is_scale_and_translate(box, size):
    """Down- and up-sampling boxes against ``jax.image.scale_and_translate``
    itself (antialiased, its edge handling), two samples in one batch."""
    clips = np.stack([_clip(5, h=48, w=64), _clip(6, h=48, w=64)]) / 255.0
    i, j, ch, cw = (np.float32(v) for v in box)
    sy, sx = np.float32(size[0]) / ch, np.float32(size[1]) / cw
    want = [_np(jax.vmap(lambda f: jax.image.scale_and_translate(
        f, (size[0], size[1], 3), (0, 1), jnp.stack([sy, sx]), jnp.stack([-i * sy, -j * sx]),
        method="linear"))(jnp.asarray(c))) for c in clips]
    got = T.resized_crop(torch.from_numpy(clips), [box, box], size).numpy()
    np.testing.assert_allclose(got, np.stack(want), atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# RandAugment and RandomErasing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("level", [0, 5, 10])
@pytest.mark.parametrize("name", jax_RA.RAND_TRANSFORMS)
def test_rand_augment_op_matches_jax(name, level):
    clip = _clip(7, h=32, w=48)
    key = jax.random.PRNGKey(level)
    want = _np(jax_RA._apply_op(name, jnp.asarray(clip), jnp.float32(level), key, {"inc": True}))
    negate = bool(jax.random.bernoulli(key, 0.5))
    got = _port(lambda x: RA._apply_op(name, x, [float(level)], [negate], {"inc": True}), clip)
    if name in EXACT:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("name", ["Posterize", "Solarize"])
def test_rand_augment_decreasing_ops_match_jax(name):
    clip = _clip(8, h=32, w=48)
    for level in (0.0, 3.7, 10.0):
        want = _np(jax_RA._apply_op(name, jnp.asarray(clip), jnp.float32(level),
                                    jax.random.PRNGKey(0), {"inc": False}))
        got = _port(lambda x: RA._apply_op(name, x, [level], [False], {"inc": False}), clip)
        np.testing.assert_array_equal(got, want)


def test_rand_augment_layers_match_jax_with_its_draws():
    """Four layers of ``rand-m7-n4-mstd0.5-inc1`` on two clips, each with
    the JAX package's own draws (op, jittered level, apply, sign)."""
    config = "rand-m7-n4-mstd0.5-inc1"
    cfg = jax_RA.parse_config(config)
    assert RA.parse_config(config) == cfg
    clips = [_clip(9, h=32, w=48), _clip(10, h=32, w=48)]
    op_indices = jnp.asarray([3, 1, 11, 8], jnp.int32)  # Rotate, Equalize, ShearX, Contrast
    layers, want = [], []
    for b, clip in enumerate(clips):
        rng = jax.random.PRNGKey(20 + b)
        want.append(_np(jax_RA.rand_augment(rng, jnp.asarray(clip), config,
                                            op_indices=op_indices)))
        draws = []
        for _ in range(cfg["num_layers"]):
            rng, sub = jax.random.split(rng)
            _, k_mag, k_apply, k_neg = jax.random.split(sub, 4)
            level = jnp.clip(cfg["magnitude"] + cfg["mstd"] * jax.random.normal(k_mag), 0.0, 10.0)
            draws.append({"level": float(level),
                          "apply": bool(jax.random.bernoulli(k_apply, cfg["p"])),
                          "negate": bool(jax.random.bernoulli(k_neg, 0.5))})
        layers.append(draws)
    assert any(d["apply"] for ds in layers for d in ds)
    got = RA.rand_augment(torch.from_numpy(np.stack(clips)), [int(i) for i in op_indices],
                          layers, config).numpy()
    # the JAX layers run compiled under lax.switch, where XLA contracts
    # multiply-adds into FMAs: on these noise clips its compiled Rotate
    # alone sits 1.9e-3 from its own eager one, and Contrast scales what
    # came before by up to 1.63
    np.testing.assert_allclose(got, np.stack(want), atol=4 * TOL, rtol=0)


@pytest.mark.parametrize("seed", range(6))
def test_random_erasing_matches_jax_with_its_draws(seed):
    clip = np.random.default_rng(seed).standard_normal((2, 24, 32, 3)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    want = _np(jax_RE.random_erasing(key, jnp.asarray(clip), probability=0.5))
    k_p, k_area, k_asp, k_i, k_j, k_noise = jax.random.split(key, 6)
    u = [float(jax.random.uniform(k_area, (), minval=0.02, maxval=1 / 3) - 0.02) / (1 / 3 - 0.02),
         float((jax.random.uniform(k_asp, (), minval=np.log(0.3), maxval=np.log(1 / 0.3))
                - np.log(0.3)) / (np.log(1 / 0.3) - np.log(0.3)))]
    ij = (int(jax.random.randint(k_i, (), 0, 24)), int(jax.random.randint(k_j, (), 0, 32)))
    box = RE.erasing_box(u, ij, 24, 32) if bool(jax.random.bernoulli(k_p, 0.5)) else None
    noise = torch.tensor(_np(jax.random.normal(k_noise, clip.shape)))[None]
    got = RE.apply_erasing(torch.from_numpy(clip)[None], [box], noise)[0].numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_random_ops_are_their_draws_then_their_applies():
    """``random_resized_crop``, ``random_horizontal_flip`` and
    ``random_erasing`` draw from each sample's generator, then apply: the
    same as the draws and applies called one by one."""
    x = torch.from_numpy(np.stack([_clip(11, h=40, w=56), _clip(12, h=40, w=56)]) / 255.0)

    def gens(seed):
        return [torch.Generator().manual_seed(seed + b) for b in range(2)]

    boxes = [T.draw_resized_crop(g, 40, 56) for g in gens(0)]
    assert torch.equal(T.random_resized_crop(gens(0), x, (24, 24)),
                       T.resized_crop(x, boxes, (24, 24)))
    flips = [T.draw_bernoulli(g, 0.5) for g in gens(5)]
    assert torch.equal(T.random_horizontal_flip(gens(5), x), T.flip_where(x, flips))
    erase = [RE.draw_erasing(g, 40, 56, 0.9) for g in gens(9)]
    want = RE.apply_erasing(x, erase, RE.erasing_fill(x, erase, [3, 4]))
    assert torch.equal(RE.random_erasing(gens(9), x, [3, 4], probability=0.9), want)
    assert any(b is not None for b in erase)


def test_erased_region_stays_inside_its_bounds():
    """Many draws: each box inside the frame with its area and aspect in
    range, and the erasing touches that box and nothing else."""
    h, w = 24, 32
    boxes = [RE.draw_erasing(torch.Generator().manual_seed(s), h, w, probability=1.0)
             for s in range(200)]
    for i, j, eh, ew in boxes:
        assert 0 <= i and i + eh <= h and 0 <= j and j + ew <= w and eh >= 1 and ew >= 1
        assert eh * ew <= round(h * w / 3 * 1.3) + h + w
    x = torch.zeros(len(boxes), 2, h, w, 3)
    out = RE.apply_erasing(x, boxes, torch.ones_like(x))
    for b, (i, j, eh, ew) in enumerate(boxes):
        want = torch.zeros(2, h, w, 3)
        want[:, i:i + eh, j:j + ew] = 1.0
        assert torch.equal(out[b], want)
    none = RE.draw_erasing(torch.Generator().manual_seed(0), h, w, probability=0.0)
    assert none is None


# ---------------------------------------------------------------------------
# samplers, frame indices, decoding
# ---------------------------------------------------------------------------


SPECS = [("Kinetics", 23), ("CharadesSTA", 17), ("THUMOS14", 5), ("SSV2", 40)]
SAMPLERS = ["DistributedBatchTaskUniqueSampler", "DistributedBatchTaskSequentialSampler",
            "DistributedBatchTaskBalancedSampler"]


@pytest.mark.parametrize("rank,replicas", [(0, 1), (0, 2), (1, 2)])
@pytest.mark.parametrize("name", SAMPLERS)
def test_samplers_match_jax(name, rank, replicas):
    names, lens = zip(*SPECS)
    for seed in range(3):
        for epoch in (0, 3):
            a = getattr(jax_S, name)(jax_S.task_specs_from_lengths(names, lens), 4,
                                     num_replicas=replicas, rank=rank, seed=seed)
            b = getattr(samplers, name)(samplers.task_specs_from_lengths(names, lens), 4,
                                        num_replicas=replicas, rank=rank, seed=seed)
            a.set_epoch(epoch)
            b.set_epoch(epoch)
            assert list(b) == list(a) and len(b) == len(a)
            if name == "DistributedBatchTaskBalancedSampler":
                assert b.accum_steps == a.accum_steps
    single_a = jax_S.BatchTaskUniqueSampler(jax_S.task_specs_from_lengths(names, lens), 4)
    single_b = samplers.BatchTaskUniqueSampler(samplers.task_specs_from_lengths(names, lens), 4)
    single_a.set_epoch(2)
    single_b.set_epoch(2)
    assert list(single_b) == list(single_a) and len(single_b) == len(single_a)
    assert samplers.PAD_INDEX == jax_S.PAD_INDEX


def test_sample_indices_match_jax():
    for total in (1, 7, 40, 301):
        for mode in ("train", "validation", "test"):
            for chunk in (0, 1):
                kw = dict(mode=mode, test_chunk=chunk, test_num_segment=2)
                a = jax_vio.sparse_sample_indices(total, 8, rng=np.random.default_rng(total), **kw)
                b = video_io.sparse_sample_indices(total, 8, rng=np.random.default_rng(total), **kw)
                np.testing.assert_array_equal(b, a)
                a = jax_vio.dense_sample_indices(total, 4, 3, rng=np.random.default_rng(1), **kw)
                b = video_io.dense_sample_indices(total, 4, 3, rng=np.random.default_rng(1), **kw)
                np.testing.assert_array_equal(b, a)
        for sample in ("rand", "middle"):
            a = jax_vio.retrieval_sample_indices(total, 6, sample, rng=np.random.default_rng(2))
            b = video_io.retrieval_sample_indices(total, 6, sample, rng=np.random.default_rng(2))
            np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(video_io.resample_to_fps(total, 30.0),
                                      jax_vio.resample_to_fps(total, 30.0))
    assert video_io.test_views(3, 2) == jax_vio.test_views(3, 2)
    with pytest.raises(ValueError):
        video_io.sparse_sample_indices(10, 4, mode="val")


def _write_video(path, n=12, h=48, w=64, seed=0):
    import cv2

    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10, (w, h))
    rng = np.random.default_rng(seed)
    for _ in range(n):
        vw.write(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    vw.release()


def test_video_reader_frames_match_jax(tmp_path):
    path = str(tmp_path / "v.avi")
    _write_video(path, n=9)
    a, b = jax_vio.VideoReader(path), video_io.VideoReader(path)
    assert len(a) == len(b) == 9 and a.fps == b.fps
    for idx in ([0, 1, 2], [8, 3, 3, 0], [5, 20]):  # sorted, unsorted, past the end
        np.testing.assert_array_equal(b.get_batch(idx), a.get_batch(idx))
    a.close()
    b.close()
    np.testing.assert_array_equal(video_io.read_video_full(path)[0], jax_vio.read_video_full(path)[0])


# ---------------------------------------------------------------------------
# datasets and the metadata builder
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    import cv2

    root = tmp_path_factory.mktemp("torch_data")
    vids = []
    for i in range(6):
        p = str(root / f"v{i}.avi")
        _write_video(p, seed=i)
        vids.append(p)
    paths = {"vids": vids, "root": str(root)}
    paths["cls"] = str(root / "cls.csv")
    with open(paths["cls"], "w") as f:
        for i, v in enumerate(vids[:4]):
            f.write(f"{v} {3 + 4 * (i % 2)}\n")  # non-contiguous labels
    paths["grd"] = str(root / "grd.json")
    with open(paths["grd"], "w") as f:
        json.dump([{"video": v, "start": 0.2, "end": 0.8, "duration": 1.2,
                    "sentence": f"clip {i}", "label": ["run", "jump"][i % 2]}
                   for i, v in enumerate(vids[2:])], f)
    paths["ret"] = str(root / "ret.csv")
    with open(paths["ret"], "w") as f:
        f.write("dataset,video,caption\n")
        for i, v in enumerate(vids[:3]):
            f.write(f"MSRVTT,{os.path.basename(v)},a person does thing {i}\n")
    paths["tal"] = str(root / "tal.jsonl")
    with open(paths["tal"], "w") as f:
        for v in vids[:2]:
            f.write(json.dumps({"video": v, "segments": [[0.1, 0.5], [0.75, 0.78]],
                                "labels": ["run", "jump"]}) + "\n")
    # raw frames: img_00001.jpg ... in a directory per video
    rows = []
    for k in range(2):
        d = root / f"raw{k}"
        d.mkdir()
        for n in range(6):
            cv2.imwrite(str(d / f"img_{n + 1:05}.jpg"),
                        np.random.default_rng(n + 10 * k).integers(0, 256, (40, 50, 3),
                                                                   dtype=np.uint8))
        rows.append(f"raw{k} 6 {k}")
    paths["raw"] = str(root / "raw.csv")
    with open(paths["raw"], "w") as f:
        f.write("\n".join(rows) + "\n")
    # VIS and ReferVOS: frames as jpgs, polygons and mask pngs
    names = []
    (root / "seg").mkdir()
    for n in range(5):
        p = f"seg/{n:05d}.jpg"
        cv2.imwrite(str(root / p), np.random.default_rng(50 + n).integers(0, 256, (48, 64, 3),
                                                                           dtype=np.uint8))
        m = np.zeros((48, 64), np.uint8)
        m[8 + n:30, 12:40 - n] = 255
        cv2.imwrite(str(root / f"seg/m{n:05d}.png"), m)
        names.append(p)
    paths["vis"] = str(root / "vis.json")
    with open(paths["vis"], "w") as f:
        json.dump({"videos": [{"id": 1, "file_names": names, "height": 48, "width": 64},
                              {"id": 2, "file_names": names[::-1], "height": 48, "width": 64}],
                   "annotations": [
                       {"video_id": 1, "category_id": 2,
                        "segmentations": [[[10, 10, 30, 10, 30, 30, 10, 30]]] * 5},
                       {"video_id": 2, "category_id": 1,
                        "segmentations": [{"counts": [100, 300, 2672], "size": [48, 64]}] * 5}],
                   "categories": [{"id": i, "name": f"c{i}"} for i in range(1, 8)]}, f)
    paths["refer"] = str(root / "refer.json")
    with open(paths["refer"], "w") as f:
        json.dump([{"frames": names[::step], "masks": [f"seg/m{n:05d}.png" for n in range(5)][::step],
                    "expression": f"the box on the left {step}"} for step in (1, -1)], f)
    return paths


def _equal_items(a, b):
    """Two dataset items equal byte for byte (numpy arrays by dtype and
    bytes, nested dicts and tuples by value)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys()
        for k in a:
            _equal_items(a[k], b[k])
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal_items(x, y)
    else:
        assert a == b and type(a) is type(b)


def _dataset_pairs(p):
    l2i = {"run": 0, "jump": 1}
    return {
        "sparse_train": lambda m: m.VideoClsSparseDataset(p["cls"], clip_len=4, short_side_size=32),
        "sparse_test": lambda m: m.VideoClsSparseDataset(p["cls"], mode="test", clip_len=4,
                                                         short_side_size=32, test_num_segment=2,
                                                         test_num_crop=3,
                                                         label2id={"3": 0, "7": 1}),
        "dense": lambda m: m.VideoClsDenseDataset(p["cls"], mode="validation", clip_len=4,
                                                  short_side_size=40, sampling_rate=2),
        "tal": lambda m: m.TALWindowedDataset(p["tal"], window_size=8, clip_len=4,
                                              short_side_size=32, label2id=l2i),
        "retrieval": lambda m: m.RetrievalDataset(p["ret"], clip_len=4, short_side_size=32,
                                                  data_dict={"root_dir": {"MSRVTT": p["root"]}}),
        "grounding": lambda m: m.GroundingDataset(p["grd"], mode="validation", clip_len=4,
                                                  short_side_size=32),
        "grounding_fixfps": lambda m: m.GroundingDataset(p["grd"], clip_len=4, short_side_size=32,
                                                         sampler="fixfps", fps=5.0),
        "localization": lambda m: m.LocalizationDataset(p["grd"], clip_len=4, short_side_size=32,
                                                        label2id=l2i),
        "raw_frames": lambda m: m.RawFrameClsDataset(p["raw"], prefix=p["root"], clip_len=4,
                                                     short_side_size=32),
    }


@pytest.mark.parametrize("name", sorted(_dataset_pairs({k: "" for k in
                                                        ("cls", "tal", "ret", "grd", "raw",
                                                         "root")})))
def test_dataset_items_match_jax(data_root, name):
    make = _dataset_pairs(data_root)[name]
    a, b = make(jax_D), make(D)
    assert len(a) == len(b)
    for epoch in (0, 1):
        a.set_epoch(epoch)
        b.set_epoch(epoch)
        for i in range(len(a)):
            _equal_items(b.get_item(i), a.get_item(i))


def test_seg_dataset_items_match_jax(data_root):
    root = data_root["root"]
    for kw in (dict(max_classes=100), dict(max_classes=4)):  # identity, negative sampling
        a = jax_seg.VISDataset(data_root["vis"], prefix=root, num_frames=4, crop_size=32,
                               mask_size=(16, 16), **kw)
        b = seg_datasets.VISDataset(data_root["vis"], prefix=root, num_frames=4, crop_size=32,
                                    mask_size=(16, 16), **kw)
        for epoch in (0, 3):
            a.set_epoch(epoch)
            b.set_epoch(epoch)
            for i in range(len(a)):
                _equal_items(b.get_item(i), a.get_item(i))
    a = jax_seg.ReferVOSDataset(data_root["refer"], prefix=root, num_frames=3, crop_size=32,
                                mask_size=(16, 16))
    b = seg_datasets.ReferVOSDataset(data_root["refer"], prefix=root, num_frames=3, crop_size=32,
                                     mask_size=(16, 16))
    for i in range(len(a)):
        _equal_items(b.get_item(i), a.get_item(i))
    img = np.random.default_rng(0).integers(0, 255, (32, 40, 3), dtype=np.uint8)
    import random

    fa, _ = jax_seg.random_rotation_clip(img, 3, rng=random.Random(1))
    fb, _ = seg_datasets.random_rotation_clip(img, 3, rng=random.Random(1))
    np.testing.assert_array_equal(fb, fa)


def test_build_multi_task_dataset_matches_jax(data_root, tmp_path):
    l2i = str(tmp_path / "l2i.json")
    with open(l2i, "w") as f:
        json.dump({"run": 0, "jump": 1}, f)
    meta = {"datasets": {
        "Kinetics": {"train": {"data_path": data_root["cls"], "num_frames": 4,
                               "short_side_size": 32},
                     "validation": {"data_path": data_root["cls"], "num_frames": 4,
                                    "short_side_size": 32}},
        "TaskGrounding": {"train": {"data_path": data_root["grd"], "num_frames": 4,
                                    "short_side_size": 32}},
        "TaskRetrieval": {"train": {"anno_path": data_root["ret"], "num_frames": 4,
                                    "short_side_size": 32,
                                    "data_dict": {"root_dir": {"MSRVTT": data_root["root"]}}}},
        "TaskLocalization": {"train": {"data_path": data_root["grd"], "label2id_path": l2i,
                                       "num_frames": 4, "short_side_size": 32}},
        "THUMOS14": {"train": {"data_path": data_root["tal"], "label2id_path": l2i,
                               "window_size": 8, "num_frames": 4, "short_side_size": 32}},
    }}
    path = str(tmp_path / "meta.yaml")
    with open(path, "w") as f:
        json.dump(meta, f)  # JSON is YAML
    for balance in (False, True):
        ta, ea, ma = jax_build(path, balance=balance)
        tb, eb, mb = build_multi_task_dataset(path, balance=balance)
        assert tb.lengths == ta.lengths and eb.lengths == ea.lengths and mb == ma
        assert [(s.name, s.length, s.offset) for s in tb.task_specs()] == \
            [(s.name, s.length, s.offset) for s in ta.task_specs()]
        for i in (0, len(ta) - 1, len(ta) // 2):
            _equal_items(tb[i], ta[i])


# ---------------------------------------------------------------------------
# the loader
# ---------------------------------------------------------------------------


class _StubModel:
    """What the loader reads of a model: label tables, the tokenizer, the
    clip length and (the port) the device."""

    def __init__(self, tables, to_table, num_frames=4):
        self.label_embeddings = {k: ({d: to_table(t) for d, t in v.items()}
                                     if isinstance(v, dict) else to_table(v))
                                 for k, v in tables.items()}
        self.cfg = type("cfg", (), {"num_frames": num_frames})()
        self.device = torch.device("cpu")

    def tokenize(self, texts, max_length=8):
        return np.asarray([[(len(w) * 7 + i) % 50 for i, w in enumerate((t + " x " * 8).split()[:8])]
                           for t in texts], np.int32)


def _loader_datasets(p):
    l2i = {"run": 0, "jump": 1}

    def build(m, seg):
        return [
            m.VideoClsSparseDataset(p["cls"], task_name="Kinetics", mode="validation",
                                    clip_len=4, short_side_size=32, label2id={"3": 0, "7": 1}),
            m.RetrievalDataset(p["ret"], task_name="TaskRetrieval", mode="validation",
                               clip_len=4, short_side_size=32,
                               data_dict={"root_dir": {"MSRVTT": p["root"]}}),
            m.GroundingDataset(p["grd"], task_name="TaskGrounding", mode="validation",
                               clip_len=4, short_side_size=32),
            m.LocalizationDataset(p["grd"], task_name="TaskLocalization", mode="validation",
                                  clip_len=4, short_side_size=32, label2id=l2i,
                                  dataset_name="dsA"),
            m.TALWindowedDataset(p["tal"], task_name="THUMOS14", mode="validation",
                                 window_size=8, clip_len=4, short_side_size=32, label2id=l2i),
            seg.VISDataset(p["vis"], task_name="TaskVIS", dataset_name="ytvis", prefix=p["root"],
                           num_frames=4, crop_size=32, mask_size=(16, 16), max_classes=9),
            seg.ReferVOSDataset(p["refer"], task_name="TaskReferVOS", prefix=p["root"],
                                num_frames=4, crop_size=32, mask_size=(16, 16)),
        ]

    return build


def _tables():
    rng = np.random.default_rng(3)
    return {"Kinetics": rng.standard_normal((2, 8)).astype(np.float32),
            "TaskLocalization": {"dsA": rng.standard_normal((2, 8)).astype(np.float32),
                                 "dsB": rng.standard_normal((3, 8)).astype(np.float32)},
            "THUMOS14": rng.standard_normal((2, 8)).astype(np.float32),
            "TaskVIS": {"ytvis": rng.standard_normal((8, 8)).astype(np.float32)}}  # ids 0-7


def test_eval_loader_batches_match_jax(data_root):
    """Every task kind: pixel values and task inputs of an eval-mode loader
    within 1e-6 of the JAX loader's, batch by batch."""
    build = _loader_datasets(data_root)
    ja = jax_D.MultiTaskDataset(build(jax_D, jax_seg))
    pa = D.MultiTaskDataset(build(D, seg_datasets))
    ja_s = jax_S.DistributedBatchTaskSequentialSampler(ja.task_specs(), 2, shuffle=False)
    pa_s = samplers.DistributedBatchTaskSequentialSampler(pa.task_specs(), 2, shuffle=False)
    jl = jax_collate.MultitaskLoader(ja, ja_s, _StubModel(_tables(), jnp.asarray), crop_size=24,
                                     train=False, num_workers=2)
    pl = collate.MultitaskLoader(pa, pa_s, _StubModel(_tables(), torch.from_numpy), crop_size=24,
                                 train=False, num_workers=2)
    kinds = set()
    n = 0
    for (ta, ba), (tb, bb) in zip(jl, pl):
        assert ta == tb
        kinds.add(tb)
        np.testing.assert_allclose(bb["pixel_values"].numpy(), _np(ba["pixel_values"]),
                                   atol=1e-6, rtol=0)
        assert bb["task_input"].keys() == ba["task_input"].keys()
        for k, v in ba["task_input"].items():
            got, want = np.asarray(bb["task_input"][k]), np.asarray(v)
            assert got.shape == want.shape, (tb, k)
            np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64),
                                       atol=1e-6, rtol=0, err_msg=f"{tb} {k}")
        n += 1
    assert n == len(pl) and kinds == {"Kinetics", "TaskRetrieval", "TaskGrounding",
                                      "TaskLocalization", "THUMOS14", "TaskVIS", "TaskReferVOS"}


class _Clips:
    """An in-memory classification dataset of seeded uint8 clips."""

    task_name = "Kinetics"

    def __init__(self, n, t=2, h=36, w=44):
        self.clips = np.random.default_rng(0).integers(0, 256, (n, t, h, w, 3), dtype=np.uint8)

    def __len__(self):
        return len(self.clips)

    def __getitem__(self, i):
        return {"task_name": self.task_name,
                "task_input": {"frames": self.clips[i], "label": np.int64(i % 2)}}


def test_train_loader_is_world_size_invariant():
    """Train mode: a sample's augmented pixels depend on (aug_seed, step,
    dataset index) alone, so the whole batch on one process equals its
    rank-strided halves on two."""
    ds = D.MultiTaskDataset([_Clips(8)])
    model = _StubModel({"Kinetics": np.eye(2, 8, dtype=np.float32)}, torch.from_numpy)

    def run(rank, replicas):
        sampler = samplers.DistributedBatchTaskUniqueSampler(ds.task_specs(), 4 // replicas,
                                                             num_replicas=replicas, rank=rank)
        loader = collate.MultitaskLoader(ds, sampler, model, crop_size=24, aug_seed=5,
                                         num_workers=2)
        loader.set_epoch(1)
        out = {}
        for step, (indices, (_, batch)) in enumerate(zip(sampler, loader)):
            for k, i in enumerate(indices):
                out[(step, i)] = batch["pixel_values"][k]
        return out

    whole = run(0, 1)
    halves = {**run(0, 2), **run(1, 2)}
    assert whole.keys() == halves.keys() and len(whole) == 8
    for key, px in whole.items():
        assert px.shape == (2, 3, 24, 24)
        assert torch.equal(px, halves[key]), key
    # the draws differ between samples and steps
    assert not torch.equal(whole[(0, list(whole)[0][1])], whole[list(whole)[-1]])


def test_loader_resumes_mid_epoch_without_decoding():
    """``set_epoch(epoch, start_step)`` skips leading batches without
    fetching them, and the batches after equal an uninterrupted epoch's."""
    fetched = []

    class Counted(_Clips):
        def __getitem__(self, i):
            fetched.append(i)
            return super().__getitem__(i)

    ds = D.MultiTaskDataset([Counted(12)])
    model = _StubModel({"Kinetics": np.eye(2, 8, dtype=np.float32)}, torch.from_numpy)
    sampler = samplers.DistributedBatchTaskUniqueSampler(ds.task_specs(), 2)
    full = collate.MultitaskLoader(ds, sampler, model, crop_size=24, aug_seed=1)
    full.set_epoch(2)
    want = [b["pixel_values"] for _, b in full]
    fetched.clear()
    resumed = collate.MultitaskLoader(ds, sampler, model, crop_size=24, aug_seed=1, prefetch=0)
    resumed.set_epoch(2, start_step=4)
    got = [b["pixel_values"] for _, b in resumed]
    assert len(got) == len(want) - 4 and len(fetched) == 2 * len(got)
    for a, b in zip(got, want[4:]):
        assert torch.equal(a, b)


def test_loader_reraises_the_workers_error():
    class Broken(_Clips):
        def __getitem__(self, i):
            if i == 5:
                raise OSError("unreadable sample 5")
            return super().__getitem__(i)

    ds = D.MultiTaskDataset([Broken(8)])
    model = _StubModel({"Kinetics": np.eye(2, 8, dtype=np.float32)}, torch.from_numpy)
    sampler = samplers.DistributedBatchTaskSequentialSampler(ds.task_specs(), 2, shuffle=False)
    loader = collate.MultitaskLoader(ds, sampler, model, crop_size=24, num_workers=1)
    with pytest.raises(OSError, match="unreadable sample 5"):
        for _ in loader:
            pass


# ---------------------------------------------------------------------------
# the checker
# ---------------------------------------------------------------------------


def test_checker_matches_jax(data_root, tmp_path, capsys):
    """The same report and exit code as the JAX package's checker, on a
    metadata file with a missing video and a data list with a broken row."""
    cls = str(tmp_path / "cls.csv")
    with open(cls, "w") as f:
        f.write(f"{data_root['vids'][0]} 0\n{tmp_path / 'missing.avi'} 1\n")
    meta = str(tmp_path / "meta.yaml")
    with open(meta, "w") as f:
        json.dump({"datasets": {"Kinetics": {"train": {"data_path": cls, "num_frames": 4,
                                                       "short_side_size": 32}}}}, f)
    rows = [{"video": os.path.basename(data_root["vids"][1]), "data_source": "k710/split1",
             "conversations": [{"from": "human", "value": "<video> what?"},
                               {"from": "gpt", "value": "a"}]},
            {"video": "gone.mp4", "conversations": [{"from": "gpt", "value": "<video>"}]},
            {"id": "text", "conversations": [{"from": "human", "value": "hi"},
                                             {"from": "gpt", "value": "<image>"}]}]
    data = str(tmp_path / "list.json")
    with open(data, "w") as f:
        json.dump(rows, f)
    for argv in (["--metadata", meta, "--probe", "2"],
                 ["--data", data, "--video_root", data_root["root"], "--op", "stat"],
                 ["--data", data, "--video_root", data_root["root"], "--op", "filter", "--out",
                  str(tmp_path / "kept.json")],
                 ["--data", data, "--video_root", data_root["root"]]):
        rc_a = jax_checker.main(argv)
        out_a = capsys.readouterr().out
        rc_b = checker.main(argv)
        out_b = capsys.readouterr().out
        assert (rc_b, out_b) == (rc_a, out_a)
        assert rc_b == 1
