"""The port's encoder at the shapes and attention types past its first
slices, against the JAX package on the CPU in fp32: more than 256 patches a
frame, more than 32 frames a clip, non-causal temporal attention, and the
``space_only`` and ``joint_space_time`` attention types, forward, streaming
and gradients.

Same weights (the JAX parameter tree carried over by
``convert.params_from_jax``) and the same numpy inputs go through both. The
bars are the repo's: 1e-3 max-abs on the outputs (test_torch_encoder.py),
1e-4 on the gradients (the trainer tests). On the CPU the port's attention
runs the kernels' plain versions, the JAX package its einsum paths.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from streamformer_tpu.config import StreamformerConfig as JaxConfig
from streamformer_tpu.models import encoder as jax_encoder
from streamformer_tpu_torch.checkpoint import from_pretrained, params_from_jax
from streamformer_tpu_torch.checkpoint.hf_export import save_pretrained
from streamformer_tpu_torch.config import StreamformerConfig
from streamformer_tpu_torch.models import encoder

TINY = dict(
    image_size=32,
    patch_size=16,
    num_frames=4,
    hidden_size=64,
    num_hidden_layers=1,
    num_attention_heads=2,
    intermediate_size=128,
    dtype="float32",
)
ATOL = 1e-3
GRAD_ATOL = 1e-4


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these tensors are tiny, and the 6-worker run
    oversubscribes the cores with each worker's default thread pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _max_err(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
    return float(np.max(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))))


def _jax_params(cfg, seed=0):
    """JAX init_params with the zero-initialised parts opened up, so the
    temporal path, the embeddings and the biases all matter."""
    params = jax.tree.map(np.asarray, jax_encoder.init_params(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed + 1)
    emb = params["embeddings"]
    for key in ("position_embeddings", "time_embeddings"):
        emb[key] = 0.1 * rng.standard_normal(emb[key].shape).astype(np.float32)
    for lp in params["layers"]:
        if "temporal_attention_gating" in lp:
            lp["temporal_attention_gating"] = np.asarray(0.7, np.float32)
        lp["attention"]["qkv"]["bias"] = 0.02 * rng.standard_normal(
            lp["attention"]["qkv"]["bias"].shape).astype(np.float32)
    return params


def _pair(trainable=False, **overrides):
    kw = dict(TINY, **overrides)
    jcfg = JaxConfig(use_pallas=False, **kw)
    params = _jax_params(jcfg)
    cfg = StreamformerConfig(**kw)
    model = encoder.StreamformerEncoder(cfg, device="cpu", trainable=trainable)
    model.load_state_dict(params_from_jax(params, cfg))  # strict
    return jcfg, params, cfg, model


def _video(b, t, size, seed=3):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, t, 3, size, size)).astype(np.float32)


def _forward_both(jcfg, params, model, px):
    ref = jax.jit(lambda p, x: jax_encoder.model_forward(p, x, jcfg))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(px))
    got = encoder.model_forward(model, torch.from_numpy(px))
    for key in ("last_hidden_state", "pooler_output"):
        assert got[key].shape == ref[key].shape, key
        assert _max_err(got[key], ref[key]) <= ATOL, key
    return got


@pytest.mark.parametrize("size,t", [(288, 2), (32, 48)], ids=["324_patches", "48_frames"])
def test_model_forward_past_the_first_slices_caps_matches_jax(size, t):
    """N = 324 (past 256 patches a frame) and T = 48 (past 32 frames)."""
    jcfg, params, cfg, model = _pair(image_size=size, num_frames=min(t, 16))
    got = _forward_both(jcfg, params, model, _video(1, t, size))
    assert got["last_hidden_state"].shape == (1, t, (size // 16) ** 2, 64)


@pytest.mark.parametrize("attention_type", ["space_only", "joint_space_time"])
def test_attention_types_forward_matches_jax(attention_type):
    jcfg, params, cfg, model = _pair(attention_type=attention_type, num_hidden_layers=2)
    layer = model.encoder.layer[0]
    assert not hasattr(layer, "temporal_attention") and not hasattr(layer, "temporal_dense")
    _forward_both(jcfg, params, model, _video(2, 6, 32))


def test_non_causal_full_clip_matches_jax():
    jcfg, params, cfg, model = _pair(enable_causal_temporal=False)
    _forward_both(jcfg, params, model, _video(2, 5, 32))


def _stream_both(jcfg, params, cfg, model, px, step_frames, mode="linear"):
    """Stream px through both packages, step_frames a call; every call's
    outputs are held to the JAX package's."""
    b, frames = px.shape[:2]
    jcfg = jcfg.replace(cache_mode=mode, cache_capacity=8)
    cfg = cfg.replace(cache_mode=mode, cache_capacity=8)
    jparams = jax.tree.map(jnp.asarray, params)
    jcache = jax_encoder.init_cache(jcfg, batch=b)
    step = jax.jit(lambda p, f, c: jax_encoder.streaming_forward(p, f, c, jcfg))
    cache = encoder.init_cache(cfg, b, device="cpu")
    layers = jcache["layers"]
    for i in range(0, frames, step_frames):
        chunk = px[:, i:i + step_frames]
        ref, jcache = step(jparams, jnp.asarray(chunk), jcache)
        if cfg.attention_type != "divided_space_time":
            # the JAX package hands back None for a layer without a temporal
            # block, which its next call reads as "no cache": keep the planes
            jcache = {"layers": layers, "len": jcache["len"]}
        got, cache = encoder.streaming_forward(model, torch.from_numpy(chunk), cache, cfg=cfg)
        for key in ("last_hidden_state", "pooler_output"):
            assert got[key].shape == ref[key].shape, (key, i)
            assert _max_err(got[key], ref[key]) <= ATOL, (key, i)
    assert int(cache["len"]) == int(jcache["len"]) == frames


@pytest.mark.parametrize("mode", ["linear", "ring"])
def test_non_causal_streaming_one_frame_a_call_matches_jax(mode):
    """One new frame sees the cache and itself, causal or not: t = 1 runs
    the decode kernels (their plain versions here), past the capacity too
    on the ring."""
    jcfg, params, cfg, model = _pair(enable_causal_temporal=False)
    frames = 10 if mode == "ring" else 8  # the linear cache holds 8
    _stream_both(jcfg, params, cfg, model, _video(2, frames, 32, seed=5), 1, mode)


def test_non_causal_streaming_of_several_frames_raises():
    """Refused before (item 3b); now kernel E without the mask (its plain
    version here): three frames a call on the linear cache, each seeing the
    cache and all three, as the JAX package's einsum path."""
    jcfg, params, cfg, model = _pair(enable_causal_temporal=False)
    _stream_both(jcfg, params, cfg, model, _video(2, 6, 32, seed=6), 3)


@pytest.mark.parametrize("step_frames", [1, 3])
@pytest.mark.parametrize("attention_type", ["space_only", "joint_space_time"])
def test_attention_types_stream_as_jax(attention_type, step_frames):
    """Frames independent (space_only) or joint over each call's new frames
    (joint_space_time), the time table at the stream's positions."""
    jcfg, params, cfg, model = _pair(attention_type=attention_type)
    _stream_both(jcfg, params, cfg, model, _video(2, 6, 32, seed=7), step_frames)


def _grads_both(jcfg, params, cfg, model, px):
    """Gradients of a weighted sum of the pooled output in both packages;
    the JAX tree's carried over by ``params_from_jax`` (a linear map)."""
    w = np.random.default_rng(11).standard_normal(
        (px.shape[0], px.shape[1], cfg.hidden_size)).astype(np.float32)

    def loss(p):
        out = jax_encoder.model_forward(p, jnp.asarray(px), jcfg)["pooler_output"]
        return jnp.sum(out * w)

    jgrads = params_from_jax(jax.tree.map(np.asarray, jax.jit(jax.grad(loss))(
        jax.tree.map(jnp.asarray, params))), cfg)
    out = encoder.model_forward(model, torch.from_numpy(px))["pooler_output"]
    (out * torch.from_numpy(w)).sum().backward()
    grads = {name: p.grad for name, p in model.named_parameters()}
    assert set(grads) == set(jgrads)
    for name, ref in jgrads.items():
        assert _max_err(grads[name], ref) <= GRAD_ATOL, name


@pytest.mark.parametrize("size,t", [(288, 2), (32, 48)], ids=["324_patches", "48_frames"])
def test_gradients_past_the_first_slices_caps_match_jax(size, t):
    """The backward of B and C (kernels I and H on the card, their plain
    versions here) at N = 324 and T = 48."""
    jcfg, params, cfg, model = _pair(trainable=True, image_size=size, num_frames=min(t, 16))
    _grads_both(jcfg, params, cfg, model, _video(1, t, size, seed=9))


def test_from_pretrained_builds_the_attention_type_of_its_config(tmp_path):
    jcfg, params, cfg, model = _pair(attention_type="space_only")
    save_pretrained(str(tmp_path), model, cfg)
    loaded = from_pretrained(str(tmp_path), device="cpu")
    assert loaded.cfg.attention_type == "space_only"
    assert loaded.cfg.enable_causal_temporal == cfg.enable_causal_temporal
    assert set(loaded.state_dict()) == set(model.state_dict())
    assert not any("temporal" in name for name in loaded.state_dict())
    _forward_both(jcfg, params, loaded, _video(1, 3, 32))


@pytest.mark.parametrize("size,t", [(384, 2), (32, 64)], ids=["576_patches", "64_frames"])
def test_training_micro_step_runs_past_the_first_slices_caps(size, t):
    """The multitask trainer's micro-step at 384x384 (576 patches, SigLIP's
    384 checkpoint) and at 64 frames: a finite loss, and an update that
    moves the spatial and the temporal projections (their gradients come
    through kernels I and H on the card, their plain versions here)."""
    from streamformer_tpu_torch.models.multitask import MultitaskModel
    from streamformer_tpu_torch.models.text_encoder import SiglipTextConfig
    from streamformer_tpu_torch.train import optim
    from streamformer_tpu_torch.train.trainer import MultitaskTrainer, TrainState

    cfg = StreamformerConfig(**dict(TINY, image_size=size, num_frames=min(t, 16),
                                    hidden_size=32, intermediate_size=64))
    text = SiglipTextConfig(vocab_size=64, hidden_size=32, num_hidden_layers=1,
                            num_attention_heads=2, intermediate_size=64, max_position_embeddings=8)
    model = MultitaskModel(cfg, {"Kinetics": {"label2id": {"a": 0, "b": 1}}}, text, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    tx = optim.create_optimizer(model, optim.cosine_lr_schedule(1e-3, 1e-5, 1, 4),
                                weight_decay=0.01, clip_grad=1.0)
    trainer = MultitaskTrainer(model, tx, update_freq=1)
    state = TrainState.create(model, tx)
    rng = np.random.default_rng(13)
    lab = rng.standard_normal((2, 32)).astype(np.float32)
    batch = {"label_embeddings": lab / np.linalg.norm(lab, axis=-1, keepdims=True),
             "label": np.array([0, 1])}
    names = ("backbone.encoder.layer.0.attention.attention.qkv.weight",
             "backbone.encoder.layer.0.temporal_attention.attention.qkv.weight")
    params = dict(model.named_parameters())
    before = {n: params[n].detach().clone() for n in names}
    state, out = trainer.step_fn("Kinetics", True)(
        state, rng.standard_normal((2, t, 3, size, size)).astype(np.float32), batch)
    assert np.isfinite(out["loss"].item())
    for n in names:
        assert not torch.equal(params[n].detach(), before[n]), n


@pytest.mark.parametrize("size,t", [(384, 2), (32, 48)], ids=["384", "48_frames"])
def test_ar_run_trains_past_the_first_slices_caps(size, t, tmp_path):
    """``ar_run.train`` end to end at ``--input_size 384`` and at
    ``--num_frames 48``, on in-memory uint8 clips, at a tiny width."""
    from streamformer_tpu_torch.downstream import ar_run

    rng = np.random.default_rng(17)
    clips = [rng.integers(0, 256, (t, size + 32, size + 48, 3), dtype=np.uint8) for _ in range(2)]

    class Clips:
        def __len__(self):
            return 2

        def __getitem__(self, i):
            return {"task_input": {"frames": clips[i], "label": i}}

    args = ar_run.get_args([
        "--anno_train", "in-memory", "--num_classes", "2", "--epochs", "1", "--batch_size", "2",
        "--input_size", str(size), "--num_frames", str(t), "--num_workers", "0",
        "--output_dir", str(tmp_path), "--device", "cpu", "--hidden_size", "32",
        "--num_layers", "1", "--num_heads", "2", "--intermediate_size", "64"])
    res = ar_run.train(args, Clips())
    assert len(res["history"]) == 1 and np.isfinite(res["history"][0]["loss"])
