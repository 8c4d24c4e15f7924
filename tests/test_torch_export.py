"""Deployment artifacts (``streamformer_tpu_torch/export.py``) on the CPU.

Contract: an artifact loaded with ``load_exported`` alone, from its bytes
and from a file, reproduces the live port call exactly (fp32, the kernels'
plain versions on the CPU) and sits within 1e-3 of the JAX package's live
call on the same weights (``checkpoint.params_from_jax``), threading the
cache through several steps: the streaming step at t=1 (linear and ring),
the multi-frame append, the ragged cache, int8 weights and the int8 cache
(lockstep and ragged), and the row-major cache. The full clip, the LM
decode step, the refusals, the traced graph and the CLI are in
``test_torch_export_clip_lm.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from streamformer_tpu.config import StreamformerConfig as JaxConfig
from streamformer_tpu.models import encoder as jax_encoder
from streamformer_tpu.ops import quant as jax_quant
from streamformer_tpu_torch import export as EX
from streamformer_tpu_torch.checkpoint import params_from_jax
from streamformer_tpu_torch.config import StreamformerConfig
from streamformer_tpu_torch.models import encoder
from streamformer_tpu_torch.ops import quant

KW = dict(image_size=32, patch_size=16, num_frames=8, hidden_size=64, num_hidden_layers=1,
          num_attention_heads=4, intermediate_size=256, dtype="float32", cache_capacity=8)
JAX_TOL = 1e-3
B = 2


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these tensors are tiny, and the 6-worker run
    oversubscribes the cores with each worker's default thread pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def draw_weights():
    """A JAX encoder tree drawn with numpy over ``jax.eval_shape`` (the JAX
    initialisers run eagerly for seconds): 0.02-normal leaves, unit layer
    norms, gates at 0.5."""
    shapes = jax.eval_shape(lambda: jax_encoder.init_params(
        jax.random.PRNGKey(0), JaxConfig(use_pallas=False, **KW)))
    rng = np.random.default_rng(1)
    params = jax.tree.map(lambda s: 0.02 * rng.standard_normal(s.shape).astype(np.float32), shapes)
    for lp in params["layers"]:
        lp["temporal_attention_gating"] = np.asarray(0.5, np.float32)
        for ln in ("layernorm_before", "layernorm_after", "temporal_layernorm"):
            lp[ln]["scale"] = lp[ln]["scale"] + np.float32(1.0)
    params["post_layernorm"]["scale"] = params["post_layernorm"]["scale"] + np.float32(1.0)
    head_ln = params["map_head"]["layernorm"]
    head_ln["scale"] = head_ln["scale"] + np.float32(1.0)
    return params


@pytest.fixture(scope="module")
def weights():
    return draw_weights()


def _clip(seed, t):
    return np.random.default_rng(seed).standard_normal((B, t, 3, 32, 32)).astype(np.float32)


def _port(cfg, params, quantized=False):
    model = encoder.StreamformerEncoder(cfg, device="cpu")
    if quantized:
        quant.quantize_encoder(model)
    model.load_state_dict(params_from_jax(params, cfg))
    return model


def _programs(blob, tmp_path, from_file=True):
    """The artifact loaded from its bytes and (``from_file``) from a file."""
    programs = [EX.load_exported(blob, device="cpu")]
    if from_file:
        path = tmp_path / "artifact.pt2"
        path.write_bytes(blob)
        programs.append(EX.load_exported(str(path), device="cpu"))
    return programs


def _close_to_jax(got, want, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=JAX_TOL, rtol=0, err_msg=what)


# name: (config fields, export options, frames a call, calls)
STREAMS = {
    "linear": ({}, {}, 1, 4),
    "ring": ({"cache_mode": "ring", "cache_capacity": 4}, {}, 1, 6),
    "append": ({}, {}, 2, 3),
    "ragged": ({}, {"per_stream_len": True}, 1, 4),
    "int8_weights": ({}, {"quantized_weights": True}, 1, 3),
    "int8_cache": ({"cache_dtype": "int8"}, {}, 1, 4),
    "int8_ragged": ({"cache_dtype": "int8"}, {"per_stream_len": True}, 1, 4),
    "row_major": ({"cache_layout": "row_major"}, {}, 1, 4),
}


@pytest.mark.parametrize("case", list(STREAMS))
def test_streaming_artifact_threads_the_cache(weights, tmp_path, case):
    """The exported step, threading its cache, equals the live
    ``streaming_forward`` exactly at every call and the JAX package's
    within 1e-3; a ragged cache re-admits stream 1 halfway through. The
    linear step is also loaded from a file (the bytes are the same)."""
    fields, opts, t, calls = STREAMS[case]
    cfg = StreamformerConfig(**KW).replace(**fields)
    jcfg = JaxConfig(use_pallas=False, **{**KW, **fields})
    jparams = weights
    if opts.get("quantized_weights"):
        jparams = jax.tree.map(np.asarray, jax_quant.quantize_encoder_params(weights))
    model = _port(cfg, jparams, opts.get("quantized_weights", False))
    ragged = opts.get("per_stream_len", False)
    blob = EX.export_streaming_step(cfg, B, t, device="cpu", **opts)
    programs = _programs(blob, tmp_path, from_file=case == "linear")
    caches = [encoder.init_cache(cfg, B, per_stream_len=ragged, device="cpu")
              for _ in range(1 + len(programs))]
    jcache = jax_encoder.init_cache(jcfg, B, per_stream_len=ragged)
    jstep = jax.jit(lambda p, x, c: jax_encoder.streaming_forward(p, x, c, jcfg))
    params = model.state_dict()
    clip = _clip(3, t * calls)
    for i in range(calls):
        if ragged and i == calls // 2:
            done = [False, True]
            caches = [encoder.reset_streams(c, torch.tensor(done)) for c in caches]
            jcache = jax_encoder.reset_streams(jcache, jnp.asarray(done))
        x = clip[:, i * t:(i + 1) * t]
        live, caches[0] = encoder.streaming_forward(model, torch.from_numpy(x), caches[0])
        want, jcache = jstep(jparams, jnp.asarray(x), jcache)
        for j, call in enumerate(programs, start=1):
            got, caches[j] = call(params, torch.from_numpy(x), caches[j])
            for key in ("pooler_output", "last_hidden_state"):
                assert torch.equal(got[key], live[key]), (case, i, key)
                _close_to_jax(got[key], want[key], f"{case} call {i} {key}")
    for c in caches[1:]:
        assert torch.equal(c["len"], caches[0]["len"])
        for la, lb in zip(c["layers"], caches[0]["layers"]):
            assert all(torch.equal(la[k], lb[k]) for k in la)
    np.testing.assert_array_equal(caches[0]["len"].numpy(), np.asarray(jcache["len"]))
