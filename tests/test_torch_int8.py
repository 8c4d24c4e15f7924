"""Int8 serving in the port against the JAX package, on the CPU in fp32.

Same weights (``convert.params_from_jax``) and the same numpy inputs go
through both. On the CPU the port runs kernels F and G's plain versions.

* int8 KV cache with float weights: outputs within 1e-4 max-abs of the JAX
  package's ``streaming_forward`` with ``cache_dtype="int8"`` (its einsum
  path, which quantizes the new frame first and attends the dequantized
  view, the function of kernels F and G). An fp32 perturbation of 1e-6 of
  the pixels moves these outputs by about 4e-7, so 1e-4 tells a right port
  from a wrong one.
* int8 weights: the dynamic activation quantizer turns fp32 noise into
  whole code steps, and a code that sits on a rounding edge in one framework
  and not the other moves the pooled output by about as much as int8 moves
  it from float (1e-3). So the port is held three ways: its activation codes
  in every int8 product of every layer against the JAX package's, both fed
  the same layer input; its pooled output within a bound measured over
  seeds; and its distance from its own float output against the JAX
  package's distance from its float output.
* Streaming equals the full clip inside the quantized port; int8 weights on
  an int8 ring stay close to the float full clip.
* ``StreamingEngine`` and ``StreamingServer`` on an int8 cache.
"""

import base64

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from streamformer_tpu.config import StreamformerConfig as JaxConfig
from streamformer_tpu.models import encoder as jax_encoder
from streamformer_tpu.ops import quant as jq
from streamformer_tpu.serving import StreamingEngine as JaxEngine
from streamformer_tpu_torch.checkpoint import params_from_jax
from streamformer_tpu_torch.config import StreamformerConfig
from streamformer_tpu_torch.models import encoder
from streamformer_tpu_torch.ops import quant
from streamformer_tpu_torch.serving import StreamingEngine

from test_torch_encoder import SMALL, _jax_params, _max_err, _pair, _video
from test_torch_serving import SMALL as ENGINE_SMALL
from test_torch_serving import _clips, _held, _serve

VS_JAX = 1e-4  # int8 cache, float weights (measured sensitivity 3.8e-7)
CODE_SHARE = 0.999  # int8 weights: share of activation codes equal to the JAX package's
# int8 weights, whole model, pooled port vs JAX: measured 1.09e-3, 1.25e-3,
# 1.11e-3 and 5.9e-6 at video seeds 3, 5, 7 and 9 (one code on a rounding
# edge flips in the first three); twice the largest
INT8_WEIGHTS_POOLED = 2.5e-3


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these tensors are tiny, and the 6-worker run
    oversubscribes the cores with each worker's default thread pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _int8_pair(**overrides):
    return _pair(cache_dtype="int8", **overrides)


def _codes_close(mine, ref):
    """int8 planes: at most one code step apart, almost all equal (the new
    frame's K/V differ by fp32 rounding, which can move a code on an edge)."""
    diff = np.abs(np.asarray(mine, np.int32) - np.asarray(ref, np.int32))
    assert diff.max() <= 1 and (diff == 0).mean() >= CODE_SHARE


# ---------------------------------------------------------------------------
# int8 KV cache, float weights
# ---------------------------------------------------------------------------


def test_int8_cache_linear_matches_jax():
    """Six t=1 frames on the lockstep linear cache (kernel F's plain version):
    outputs, lengths, codes and scales of the valid slots. The JAX package
    pads the int8 cache's rows to 32."""
    jcfg, params, cfg, model = _int8_pair(cache_capacity=8)
    b, frames, r = 2, 6, 2 * 9
    px = _video(b, frames, seed=5)
    jparams = jax.tree.map(jnp.asarray, params)
    step = jax.jit(lambda p, f, c: jax_encoder.streaming_forward(p, f, c, jcfg))
    jcache = jax_encoder.init_cache(jcfg, batch=b)
    cache = encoder.init_cache(cfg, b, device="cpu")
    layer = cache["layers"][0]
    assert layer["k"].dtype == torch.int8 and layer["k"].shape == (8, r, 96)
    assert layer["k_scale"].dtype == torch.float32 and layer["k_scale"].shape == (8, r)
    for i in range(frames):
        ref, jcache = step(jparams, jnp.asarray(px[:, i:i + 1]), jcache)
        got, cache = encoder.streaming_forward(model, torch.from_numpy(px[:, i:i + 1]), cache)
        assert _max_err(got["last_hidden_state"], ref["last_hidden_state"]) <= VS_JAX, i
        assert _max_err(got["pooler_output"], ref["pooler_output"]) <= VS_JAX, i
    assert int(cache["len"]) == int(jcache["len"]) == frames
    for mine, theirs in zip(cache["layers"], jcache["layers"]):
        for key in ("k", "v"):
            _codes_close(mine[key][:frames], np.asarray(theirs[key])[:frames, :r])
            np.testing.assert_allclose(mine[f"{key}_scale"][:frames].numpy(),
                                       np.asarray(theirs[f"{key}_scale"])[:r, :frames].T,
                                       rtol=1e-5, atol=0)


def test_int8_cache_multi_frame_append_matches_jax():
    """Lockstep t=4 on the int8 linear cache after two t=1 frames: kernel F
    once per new frame, frame ti at len + ti, against the JAX package's
    einsum append."""
    jcfg, params, cfg, model = _int8_pair(cache_capacity=8)
    px = _video(2, 6, seed=13)
    jparams = jax.tree.map(jnp.asarray, params)
    jstep = jax.jit(lambda p, f, c: jax_encoder.streaming_forward(p, f, c, jcfg))
    jcache = jax_encoder.init_cache(jcfg, batch=2)
    cache = encoder.init_cache(cfg, 2, device="cpu")
    for lo, hi in ((0, 1), (1, 2), (2, 6)):
        ref, jcache = jstep(jparams, jnp.asarray(px[:, lo:hi]), jcache)
        got, cache = encoder.streaming_forward(model, torch.from_numpy(px[:, lo:hi]), cache)
        assert _max_err(got["last_hidden_state"], ref["last_hidden_state"]) <= VS_JAX, lo
        assert _max_err(got["pooler_output"], ref["pooler_output"]) <= VS_JAX, lo
    assert int(cache["len"]) == 6
    for mine, theirs in zip(cache["layers"], jcache["layers"]):
        _codes_close(mine["v"][:6], np.asarray(theirs["v"])[:6, :18])


def test_int8_cache_ragged_matches_jax():
    """Streams joining at steps 0, 2 and 3 (``reset_streams``), t=1 steps on
    the per-stream int8 cache (kernel G's plain version). The JAX package
    pads each stream's rows to 32; compare per stream."""
    jcfg, params, cfg, model = _int8_pair(cache_capacity=8)
    b, steps, join, n = 3, 6, [0, 2, 3], 9
    px = _video(b, steps, seed=11)
    jparams = jax.tree.map(jnp.asarray, params)
    step = jax.jit(lambda p, f, c: jax_encoder.streaming_forward(p, f, c, jcfg))
    jcache = jax_encoder.init_cache(jcfg, batch=b, per_stream_len=True)
    cache = encoder.init_cache(cfg, b, per_stream_len=True, device="cpu")
    assert cache["layers"][0]["k_scale"].shape == (8, b * n)
    for s in range(steps):
        done = np.asarray([j == s for j in join])
        jcache = jax_encoder.reset_streams(jcache, jnp.asarray(done))
        encoder.reset_streams(cache, torch.from_numpy(done))
        ref, jcache = step(jparams, jnp.asarray(px[:, s:s + 1]), jcache)
        got, cache = encoder.streaming_forward(model, torch.from_numpy(px[:, s:s + 1]), cache)
        assert _max_err(got["last_hidden_state"], ref["last_hidden_state"]) <= VS_JAX, s
        assert _max_err(got["pooler_output"], ref["pooler_output"]) <= VS_JAX, s
    lens = [steps - j for j in join]
    assert cache["len"].tolist() == np.asarray(jcache["len"]).tolist() == lens
    n_pad = jcache["layers"][0]["k"].shape[1] // b
    for mine, theirs in zip(cache["layers"], jcache["layers"]):
        for bi, u in enumerate(lens):
            _codes_close(mine["k"][:u, bi * n:(bi + 1) * n],
                         np.asarray(theirs["k"])[:u, bi * n_pad:bi * n_pad + n])


# The JAX package's int8 ring attends the new frame unquantized
# (models/encoder.py _ring_attend_pos_major) where its kernel and its linear
# int8 cache attend it dequantized; the port follows the kernel. Measured on
# this test's input at frame 0: JAX ring vs JAX linear 4.5e-6 pooled.
JAX_RING_FAULT_POOLED = 1e-6


def test_int8_ring_matches_jax_linear_before_it_wraps():
    """The port's int8 ring (kernel F's plain version, slot len % C excluded
    and overwritten) over 2C frames. Before it wraps it equals the JAX
    package's int8 LINEAR cache within 1e-4; the JAX int8 ring differs from
    both by its fault (above), which the test pins. Past C it stays within
    the repo's 1e-3 bar of the JAX ring."""
    cap, frames = 4, 8
    jcfg, params, cfg, model = _int8_pair(cache_mode="ring", cache_capacity=cap)
    px = _video(2, frames, seed=5)
    jparams = jax.tree.map(jnp.asarray, params)
    jring = jax.jit(lambda p, f, c: jax_encoder.streaming_forward(p, f, c, jcfg))
    lin_cfg = jcfg.replace(cache_mode="linear")
    jlin = jax.jit(lambda p, f, c: jax_encoder.streaming_forward(p, f, c, lin_cfg))
    ring_cache = jax_encoder.init_cache(jcfg, batch=2)
    lin_cache = jax_encoder.init_cache(lin_cfg, batch=2)
    cache = model.init_cache(2)
    for i in range(frames):
        frame = px[:, i:i + 1]
        got, cache = model.stream(torch.from_numpy(frame), cache)
        ring, ring_cache = jring(jparams, jnp.asarray(frame), ring_cache)
        if i < cap:
            lin, lin_cache = jlin(jparams, jnp.asarray(frame), lin_cache)
            for key in ("last_hidden_state", "pooler_output"):
                assert _max_err(got[key], lin[key]) <= VS_JAX, (key, i)
            if i == 0:
                assert _max_err(ring["pooler_output"], lin["pooler_output"]) > JAX_RING_FAULT_POOLED
        assert _max_err(got["pooler_output"], ring["pooler_output"]) <= 1e-3, i
    assert int(cache["len"]) == frames


# ---------------------------------------------------------------------------
# int8 weights
# ---------------------------------------------------------------------------


def _quantized_pair(**overrides):
    """The JAX tree quantized at threshold 0 and the port loaded from it."""
    jcfg, params, cfg, model = _pair(**overrides)
    float_model = encoder.StreamformerEncoder(cfg, device="cpu")
    float_model.load_state_dict(model.state_dict())
    qtree = jax.tree.map(np.asarray, jq.quantize_encoder_params(params, min_elements=0))
    quant.quantize_encoder(model, min_elements=0).load_state_dict(params_from_jax(qtree, cfg))
    return jcfg, params, qtree, float_model, model


class _Codes:
    """Records the activation codes of every ``quantize_rows`` call of both
    packages (a wrapper set from the test; no JAX file is changed)."""

    def __init__(self, monkeypatch):
        self.jax, self.port = [], []
        orig_j, orig_p = jq.quantize_rows, quant.quantize_rows

        def wrap_j(x):
            out = orig_j(x)
            self.jax.append(np.asarray(out[0]))
            return out

        def wrap_p(x):
            out = orig_p(x)
            self.port.append(out[0].numpy())
            return out

        monkeypatch.setattr(jq, "quantize_rows", wrap_j)
        monkeypatch.setattr(quant, "quantize_rows", wrap_p)

    def check(self, what):
        assert len(self.jax) == len(self.port) > 0, what
        for i, (a, b) in enumerate(zip(self.jax, self.port)):
            diff = np.abs(a.astype(np.int32) - b.reshape(a.shape).astype(np.int32))
            assert diff.max() <= 1 and (diff == 0).mean() >= CODE_SHARE, (what, i)
        self.jax.clear()
        self.port.clear()


@pytest.mark.parametrize("seed", [3, 7])
def test_int8_weight_activation_codes_match_jax(monkeypatch, seed):
    """Every int8 product of every block (7 a block) and of the MAP head,
    each block fed the JAX package's own input to it: at least 99.9 % of the
    activation codes equal, none more than one step apart (measured: all
    equal). The head's k and v share one product in the port; the JAX
    package's v codes, equal to its k codes, are left out."""
    jcfg, params, qtree, _, model = _quantized_pair()
    qp = jax.tree.map(jnp.asarray, qtree)
    codes = _Codes(monkeypatch)
    with jax.default_matmul_precision("highest"), torch.no_grad():
        x = jax_encoder.embed(qp, jnp.asarray(_video(2, 4, seed=seed)), jcfg)
        for i, layer in enumerate(model.encoder.layer):
            y = jax_encoder.layer_forward(qp["layers"][i], x, jcfg)
            encoder.layer_forward(layer, torch.from_numpy(np.array(x)), model.cfg)
            assert len(codes.port) == 7
            codes.check(f"layer {i}")
            x = y
        x = jax_encoder.layer_norm(x, qp["post_layernorm"], jcfg.layer_norm_eps)
        jax_encoder.map_pool(x, qp["map_head"], jcfg)
        encoder.map_pool(torch.from_numpy(np.array(x)), model.head, model.cfg)
        del codes.jax[2]  # v: the same codes as k
        codes.check("map head")


@pytest.mark.parametrize("seed", [3, 7])
def test_int8_weight_model_matches_jax(seed):
    """Whole model, int8 weights: pooled within the measured bound of the
    JAX package's, and the port's int8-vs-float distance at least half the
    JAX package's (a port that skipped quantization would sit near 0;
    measured ratio 0.95-1.05)."""
    jcfg, params, qtree, float_model, model = _quantized_pair()
    px = _video(2, 4, seed=seed)
    fwd = jax.jit(lambda p, x: jax_encoder.model_forward(p, x, jcfg))
    ref = fwd(jax.tree.map(jnp.asarray, qtree), jnp.asarray(px))["pooler_output"]
    ref_float = fwd(jax.tree.map(jnp.asarray, params), jnp.asarray(px))["pooler_output"]
    got = encoder.model_forward(model, torch.from_numpy(px))["pooler_output"]
    got_float = encoder.model_forward(float_model, torch.from_numpy(px))["pooler_output"]
    assert _max_err(got, ref) <= INT8_WEIGHTS_POOLED
    assert _max_err(got, got_float) >= 0.5 * _max_err(ref, ref_float) > 0


# tests/test_quant.py's CFG
QUANT = dict(image_size=48, patch_size=16, num_frames=8, hidden_size=128, num_hidden_layers=2,
             num_attention_heads=4, intermediate_size=256, dtype="float32", cache_capacity=16)


def _quant_model(seed, **overrides):
    cfg = StreamformerConfig(**dict(QUANT, **overrides))
    model = encoder.StreamformerEncoder(cfg, device="cpu",
                                        generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for layer in model.encoder.layer:
            layer.temporal_attention_gating.fill_(0.7)
    return model


def test_quantized_streaming_equals_quantized_full_clip():
    """tests/test_quant.py's contract inside the port: int8 weights (default
    threshold), a float linear cache fed 5 then 3 frames (kernel E's plain
    version), pooled within 2e-4 of the quantized full clip."""
    model = quant.quantize_encoder(_quant_model(0))
    assert isinstance(model.encoder.layer[0].attention.attention.qkv, quant.Int8Linear)
    px = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 8, 3, 48, 48))
                          .astype(np.float32))
    full = model(px)["pooler_output"]
    cache = model.init_cache(2)
    o1, cache = model.stream(px[:, :5], cache)
    o2, cache = model.stream(px[:, 5:], cache)
    stream = torch.cat([o1["pooler_output"], o2["pooler_output"]], dim=1)
    assert _max_err(stream, full) <= 2e-4


def _cos(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


def test_int8_weights_with_int8_ring_cache():
    """The whole int8 serving stack, past the ring's capacity: int8 weights,
    an int8 ring of 6 slots, 10 frames. Finite, and within cosine 0.98 of the
    float full clip over the first 6 frames (tests/test_quant.py's gate)."""
    float_model = _quant_model(0, cache_mode="ring", cache_dtype="int8", cache_capacity=6)
    model = _quant_model(0, cache_mode="ring", cache_dtype="int8", cache_capacity=6)
    quant.quantize_encoder(model)
    px = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 10, 3, 48, 48))
                          .astype(np.float32))
    cache = model.init_cache(2)
    assert cache["layers"][0]["k"].dtype == torch.int8
    outs = []
    for t in range(10):
        o, cache = model.stream(px[:, t:t + 1], cache)
        outs.append(o["pooler_output"])
    got = torch.cat(outs, dim=1)
    assert torch.isfinite(got).all()
    assert _cos(got[:, :6], float_model(px[:, :6])["pooler_output"]) > 0.98


def test_int8_refusals():
    """What an int8 cache still refuses: multi-frame appends to a ragged
    ring, as the JAX package does. Partial appends (``new_valid``, item 9b)
    on the ragged int8 cache, refused before, now match the JAX package:
    the valid frames' outputs, the lengths, the codes and scales below len +
    valid. A float cache in another dtype than the compute dtype (item 9a),
    refused before, streams as the JAX package's does."""
    jcfg, params, cfg, model = _int8_pair(cache_capacity=8)
    jparams = jax.tree.map(jnp.asarray, params)
    px = _video(2, 5, seed=17)
    jstep = jax.jit(lambda p, f, c, v: jax_encoder.streaming_forward(p, f, c, jcfg, new_valid=v))
    jcache = jax_encoder.init_cache(jcfg, batch=2, per_stream_len=True)
    cache = model.init_cache(2, per_stream_len=True)
    for lo, hi, valid in ((0, 3, [2, 1]), (2, 5, [1, 3])):
        ref, jcache = jstep(jparams, jnp.asarray(px[:, lo:hi]), jcache,
                            jnp.asarray(valid, jnp.int32))
        got, cache = model.stream(torch.from_numpy(px[:, lo:hi]), cache,
                                  new_valid=torch.tensor(valid, dtype=torch.int32))
        for bi, v in enumerate(valid):
            for key in ("last_hidden_state", "pooler_output"):
                assert _max_err(got[key][bi, :v], ref[key][bi, :v]) <= VS_JAX, (lo, bi, key)
    lens = [3, 4]
    assert cache["len"].tolist() == np.asarray(jcache["len"]).tolist() == lens
    n, n_pad = 9, jcache["layers"][0]["k"].shape[1] // 2
    for mine, theirs in zip(cache["layers"], jcache["layers"]):
        for bi, u in enumerate(lens):
            for key in ("k", "v"):
                _codes_close(mine[key][:u, bi * n:(bi + 1) * n],
                             np.asarray(theirs[key])[:u, bi * n_pad:bi * n_pad + n])
                np.testing.assert_allclose(
                    mine[f"{key}_scale"][:u, bi * n:(bi + 1) * n].numpy(),
                    np.asarray(theirs[f"{key}_scale"])[bi * n_pad:bi * n_pad + n, :u].T,
                    rtol=1e-5, atol=0)
    ring = encoder.StreamformerEncoder(cfg.replace(cache_mode="ring"), device="cpu")
    with pytest.raises(NotImplementedError, match="ring"):
        ring.stream(torch.zeros(2, 2, 3, 48, 48), ring.init_cache(2, per_stream_len=True))
    mcfg, jmcfg = cfg.replace(cache_dtype="bfloat16"), jcfg.replace(cache_dtype="bfloat16")
    mixed = encoder.StreamformerEncoder(mcfg, device="cpu")
    mixed.load_state_dict(model.state_dict())
    jmstep = jax.jit(lambda p, f, c: jax_encoder.streaming_forward(p, f, c, jmcfg))
    jcache, cache = jax_encoder.init_cache(jmcfg, batch=2), mixed.init_cache(2)
    assert cache["layers"][0]["k"].dtype == torch.bfloat16
    for lo, hi in ((0, 1), (1, 4)):
        ref, jcache = jmstep(jparams, jnp.asarray(px[:, lo:hi]), jcache)
        got, cache = mixed.stream(torch.from_numpy(px[:, lo:hi]), cache)
        for key in ("last_hidden_state", "pooler_output"):
            assert _max_err(got[key], ref[key]) <= 1e-3, (lo, key)


# ---------------------------------------------------------------------------
# Serving engine and HTTP server on the int8 cache
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def int8_engine_pair():
    jcfg = JaxConfig(use_pallas=False, cache_dtype="int8", **ENGINE_SMALL)
    params = jax.tree.map(np.asarray, _jax_params(jcfg, seed=3))
    cfg = StreamformerConfig(cache_dtype="int8", **ENGINE_SMALL)
    model = encoder.StreamformerEncoder(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params, cfg))
    return jcfg, params, model


@pytest.mark.parametrize("case", ["four_streams_two_slots", "holds", "frames4"])
def test_int8_engine_matches_jax_engine(int8_engine_pair, case):
    """The same schedules through both engines on an int8 linear cache:
    admission into recycled slots, holds, and the multi-frame tick, which on
    an int8 cache is a scan of t=1 steps in both."""
    jcfg, params, model = int8_engine_pair
    if case == "holds":
        slow, fast = _clips(1, [4, 8])
        run = lambda eng: _held(eng, slow, fast)
        ref_clips = [slow, fast]
    else:
        ref_clips = _clips(2, [3, 9, 2, 7])
        run = lambda eng: _serve(eng, ref_clips, 4 if case == "frames4" else 1)
    ref = run(JaxEngine(params, jcfg, slots=2, mode="linear"))
    got = run(StreamingEngine(model, slots=2, mode="linear"))
    for g, r, clip in zip(got, ref, ref_clips):
        assert g.shape == r.shape == (len(clip), 64)
        assert np.abs(g - r).max() <= VS_JAX


def _bursty(eng, clips, frames):
    """Half of each stream up front, two ticks (short streams starve and
    hold, later ones wait for a slot), then the rest: uneven lengths, holds
    and admission mid-run."""
    sids = [eng.open() for _ in clips]
    for sid, clip in zip(sids, clips):
        eng.feed(sid, clip[:len(clip) // 2])
    for _ in range(2):
        eng.tick(frames=frames)
    for sid, clip in zip(sids, clips):
        eng.feed(sid, clip[len(clip) // 2:])
        eng.close(sid)
    eng.run_until_idle(frames=frames)
    out = []
    for sid in sids:
        feats, done = eng.poll(sid)
        assert done
        out.append(feats)
    return out


@pytest.mark.parametrize("mode", ["linear", "ring"])
def test_int8_engine_multi_frame_tick_equals_single(int8_engine_pair, mode):
    """``tick(frames=4)`` equals ``tick()`` exactly on an int8 cache: each
    of its t=1 steps holds the slots that have no frame for it, so no stream
    sees another schedule (tests/test_serving.py's int8 case, exact here).
    The ring cannot hold, so its streams are fed whole."""
    _, _, model = int8_engine_pair
    clips = _clips(29, [3, 9, 5, 2, 7])
    if mode == "linear":
        one, four = (_bursty(StreamingEngine(model, slots=2, mode=mode), clips, k) for k in (1, 4))
    else:
        one, four = (_serve(StreamingEngine(model, slots=2, mode=mode), clips, k) for k in (1, 4))
    for a, b, clip in zip(one, four, clips):
        assert a.shape == (len(clip), 64)
        np.testing.assert_array_equal(a, b)


def test_int8_throughput_tick_runs_only_the_steps_it_has_frames_for(int8_engine_pair):
    """``tick(frames=8)`` on an int8 cache runs one t=1 step per frame of
    its fullest slot, not 8: a step in which every slot holds would cost a
    whole model forward for nothing. The features equal ``tick()``'s."""
    _, _, model = int8_engine_pair
    clips = _clips(31, [3, 5])
    eng = StreamingEngine(model, slots=2, mode="linear")
    sids = [eng.open() for _ in clips]
    for sid, clip in zip(sids, clips):
        eng.feed(sid, clip)
        eng.close(sid)
    assert eng.tick(frames=8)
    assert eng.forwards == 5
    assert not eng.tick(frames=8)
    ref = _serve(StreamingEngine(model, slots=2, mode="linear"), clips)
    for sid, r in zip(sids, ref):
        feats, done = eng.poll(sid)
        assert done
        np.testing.assert_array_equal(feats, r)


def test_int8_http_server_matches_the_engine(int8_engine_pair):
    """Two clients over a socket get the int8 engine's features exactly."""
    import json
    import time
    import urllib.request

    from streamformer_tpu_torch.server import StreamingServer

    _, _, model = int8_engine_pair
    clips = _clips(30, [4, 6], u8=True)
    srv = StreamingServer(model, slots=2, port=0, stage_dtype="uint8").start()

    def req(method, path, payload=None):
        data = None if payload is None else json.dumps(payload).encode()
        r = urllib.request.Request(f"http://127.0.0.1:{srv.port}{path}", data=data,
                                   method=method, headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(r, timeout=30) as resp:
            return json.loads(resp.read())

    try:
        sids = []
        for clip in clips:
            sid = req("POST", "/streams")["sid"]
            req("POST", f"/streams/{sid}/frames",
                {"frames_b64": base64.b64encode(clip.tobytes()).decode(),
                 "shape": list(clip.shape), "dtype": "uint8"})
            req("POST", f"/streams/{sid}/close")
            sids.append(sid)
        got, acc, deadline = {}, {sid: [] for sid in sids}, time.time() + 60
        while len(got) < len(sids) and time.time() < deadline:
            for sid in sids:
                if sid not in got:
                    r = req("GET", f"/streams/{sid}/features")
                    acc[sid].append(np.asarray(r["features"], np.float32).reshape(-1, 64))
                    if r["done"]:
                        got[sid] = np.concatenate(acc[sid])
            time.sleep(0.02)
    finally:
        srv.stop()
    ref = _serve(StreamingEngine(model, slots=2, mode="linear", stage_dtype="uint8"), clips)
    for sid, r in zip(sids, ref):
        assert sid in got, f"stream {sid} never finished"
        np.testing.assert_array_equal(got[sid], r)
