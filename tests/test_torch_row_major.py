"""The row-major cache layout of the port against the JAX package, on the CPU.

Kernels J (``ops.temporal_decode_rm``) and K
(``ops.temporal_decode_rm_readonly``) run their plain versions here; they
are held against the JAX package's Pallas kernels
``fused_temporal_decode_inplace`` and ``fused_temporal_decode`` run in
interpret mode, as ``tests/test_pallas_attention.py`` runs them (2e-5, and
the whole cache after J's write equal). The encoder on
``cache_layout="row_major"`` is held against the JAX package's
``streaming_forward`` in fp32 within the repo's 1e-3 (its einsum branches:
off the TPU the JAX package runs no kernel there), and its int8 cache
within 1e-4, as ``tests/test_torch_int8.py`` holds the pos-major one.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from streamformer_tpu.models import encoder as jax_encoder
from streamformer_tpu.ops import attention as A
from streamformer_tpu_torch.models import encoder
from streamformer_tpu_torch.ops import attention as ops

from test_torch_encoder import ATOL, _max_err, _pair, _video

KERNEL_TOL = 2e-5
VS_JAX_INT8 = 1e-4


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these tensors are tiny, and the 6-worker run
    oversubscribes the cores with each worker's default thread pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def interpret(monkeypatch):
    """Run the JAX package's Pallas kernels in interpret mode on the CPU."""
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def patched(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    monkeypatch.setattr(A.pl, "pallas_call", patched)


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


# ---------------------------------------------------------------------------
# J and K against the Pallas kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("clen", [0, 5, 7, 8, 31])
def test_temporal_decode_rm_matches_the_pallas_kernel(interpret, clen):
    """J: output, and the whole cache after the in-place write."""
    r, c, h, dh = 56, 32, 4, 16
    d = h * dh
    q, kn, vn, kc, vc = _arrays(clen, (r, d), (r, d), (r, d), (r, c, d), (r, c, d))
    ref, k_ref, v_ref = A.fused_temporal_decode_inplace(
        *map(jnp.asarray, (q, kn, vn, kc, vc)), jnp.asarray(clen, jnp.int32), num_heads=h)
    k_cache, v_cache = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    got = ops.temporal_decode_rm(torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn),
                                 k_cache, v_cache, torch.tensor(clen, dtype=torch.int32), h)
    assert _max_err(got, ref) <= KERNEL_TOL
    np.testing.assert_array_equal(k_cache.numpy(), np.asarray(k_ref))
    np.testing.assert_array_equal(v_cache.numpy(), np.asarray(v_ref))


@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("clen", [0, 5, 7, 8, 31])
def test_temporal_decode_rm_readonly_matches_the_pallas_kernel(interpret, clen, quantized):
    """K: float cache (the JAX package's oracle mode) and int8 codes with
    per-(row, position, head) scales from ``quantize_kv``; nothing written."""
    r, c, h, dh = 56, 32, 4, 16
    d = h * dh
    q, k, v = _arrays(100 + clen, (r, d), (r, c, d), (r, c, d))
    length = torch.tensor(clen, dtype=torch.int32)
    if quantized:
        (kq, ks), (vq, vs) = (jax_encoder.quantize_kv(jnp.asarray(a).reshape(r, c, h, dh))
                              for a in (k, v))
        jax_args = (kq.reshape(r, c, d), vq.reshape(r, c, d), ks, vs)
        port_args = [torch.from_numpy(np.array(a)) for a in jax_args]
    else:
        jax_args = (jnp.asarray(k), jnp.asarray(v), None, None)
        port_args = [torch.from_numpy(k), torch.from_numpy(v), None, None]
    before = [None if a is None else a.clone() for a in port_args]
    ref = A.fused_temporal_decode(jnp.asarray(q), *jax_args, jnp.asarray(clen, jnp.int32),
                                  num_heads=h)
    got = ops.temporal_decode_rm_readonly(torch.from_numpy(q), *port_args, length, h)
    assert _max_err(got, ref) <= KERNEL_TOL
    assert all(a is None or torch.equal(a, b) for a, b in zip(port_args, before))


def test_row_major_kernels_check_their_operands():
    q = torch.zeros(6, 32)
    k = torch.zeros(6, 4, 32)
    one = torch.tensor(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="(R, C, D)"):
        ops.temporal_decode_rm(q, q, q, k.transpose(0, 1).contiguous(), k, one, 4)
    with pytest.raises(TypeError, match="int32"):
        ops.temporal_decode_rm(q, q, q, k, k.clone(), one.long(), 4)
    with pytest.raises(TypeError, match="not torch.int8"):
        ops.temporal_decode_rm_readonly(q, k, k, torch.ones(6, 4, 4), torch.ones(6, 4, 4), one, 4)
    with pytest.raises(TypeError, match="k_scale"):
        ops.temporal_decode_rm_readonly(q, k.to(torch.int8), k.to(torch.int8), torch.ones(6, 4, 2),
                                        torch.ones(6, 4, 2), one, 4)
    with pytest.raises(ValueError, match="both scales"):
        ops.temporal_decode_rm_readonly(q, k, k, torch.ones(6, 4, 4), None, one, 4)


def test_quantize_kv_heads_equals_jax():
    """The row-major int8 cache's per-head quantizer: codes and scales equal
    to the JAX package's ``quantize_kv`` over (..., H, dh), ties included."""
    (x,) = _arrays(7, (3, 5, 64))
    x[0, 0, :16] = np.arange(16) * 0.5  # a head whose codes sit on .5 ties
    ref_q, ref_s = jax_encoder.quantize_kv(jnp.asarray(x).reshape(3, 5, 4, 16))
    got_q, got_s = encoder.quantize_kv_heads(torch.from_numpy(x), 4)
    assert got_q.shape == (3, 5, 64) and got_s.shape == (3, 5, 4)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(ref_q).reshape(3, 5, 64))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(ref_s))


# ---------------------------------------------------------------------------
# The encoder on the row-major cache against the JAX package
# ---------------------------------------------------------------------------


def _stream(chunks, b=2, seed=5, tol=ATOL, **overrides):
    """Feed ``chunks`` (frame counts) through both packages' row-major
    streaming_forward; every output within ``tol``. Returns both caches."""
    jcfg, params, cfg, model = _pair(cache_layout="row_major", **overrides)
    px = _video(b, sum(chunks), seed=seed)
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
            assert _max_err(got[key], ref[key]) <= tol, (key, lo, t)
        lo += t
    assert int(cache["len"]) == int(jcache["len"]) == lo
    return jcache, cache


@pytest.mark.parametrize("chunks", [[1] * 6, [2, 2, 2], [1, 2, 3]],
                         ids=["t1", "t2", "mixed"])
def test_row_major_linear_matches_jax(chunks):
    """t=1 (kernel J's plain version) and t >= 2 (write, then plain
    attention); the cache rows written equal the JAX package's."""
    jcache, cache = _stream(chunks, cache_capacity=8)
    n = sum(chunks)
    for mine, ref in zip(cache["layers"], jcache["layers"]):
        for key in ("k", "v"):
            assert mine[key].shape == ref[key].shape == (2, 9, 8, 96)
            assert _max_err(mine[key][:, :, :n], np.asarray(ref[key])[:, :, :n]) <= ATOL


def test_row_major_capacity_not_a_multiple_of_8():
    """Capacity 20 (the JAX package's case of an odd capacity, where its
    in-place kernel does not apply): kernel J serves any capacity."""
    _stream([1] * 4, cache_capacity=20)


@pytest.mark.parametrize("chunks", [[1] * 8, [6, 3], [2, 5, 1]], ids=["t1", "t_past_C", "mixed"])
def test_row_major_ring_matches_jax(chunks):
    """The ring at capacity 4: t=1 steps past the wrap, and chunks longer
    than the capacity (only their last C frames stay)."""
    jcache, cache = _stream(chunks, cache_capacity=4, cache_mode="ring")
    for mine, ref in zip(cache["layers"], jcache["layers"]):
        assert _max_err(mine["k"], ref["k"]) <= ATOL
        assert _max_err(mine["v"], ref["v"]) <= ATOL


@pytest.mark.parametrize("mode,chunks", [("linear", [1] * 6), ("linear", [1, 3, 1]),
                                         ("ring", [1] * 7), ("ring", [3, 5])],
                         ids=["linear_t1", "linear_chunks", "ring_t1", "ring_chunks"])
def test_row_major_int8_matches_jax(mode, chunks):
    """The int8 cache, scales per (row, position, head): t=1 on the linear
    cache is kernel K's plain version after the quantized write; the ring
    attends the new frames unquantized, as the JAX einsum does. Outputs
    within 1e-4; the codes of the first layer equal the JAX package's, and
    every layer's within one step (the K/V of later layers differ by fp32
    rounding, which can move a code on an edge); scales within 1e-5."""
    jcache, cache = _stream(chunks, tol=VS_JAX_INT8, cache_capacity=4 if mode == "ring" else 8,
                            cache_mode=mode, cache_dtype="int8")
    n = min(sum(chunks), 4) if mode == "ring" else sum(chunks)
    first = cache["layers"][0]
    assert first["k"].dtype == torch.int8 and first["k_scale"].shape[-1] == 4
    for i, (mine, ref) in enumerate(zip(cache["layers"], jcache["layers"])):
        for key in ("k", "v"):
            a = mine[key][:, :, :n].numpy().astype(np.int32)
            b = np.asarray(ref[key])[:, :, :n].astype(np.int32)
            if i == 0:
                np.testing.assert_array_equal(a, b)
            assert np.abs(a - b).max() <= 1
            np.testing.assert_allclose(mine[f"{key}_scale"][:, :, :n].numpy(),
                                       np.asarray(ref[f"{key}_scale"])[:, :, :n], rtol=1e-5)


def test_row_major_stream_equals_pos_major_stream():
    """The same frames through both layouts of the port give the same
    outputs (kernel J is kernel A on row-major strides; on the CPU both run
    one plain version)."""
    _, _, cfg, model = _pair(cache_capacity=8)
    rm_cfg = cfg.replace(cache_layout="row_major")
    px = torch.from_numpy(_video(2, 6, seed=9))
    pm = encoder.init_cache(cfg, 2, device="cpu")
    rm = encoder.init_cache(rm_cfg, 2, device="cpu")
    for i in range(6):
        a, pm = encoder.streaming_forward(model, px[:, i:i + 1], pm)
        b, rm = encoder.streaming_forward(model, px[:, i:i + 1], rm, cfg=rm_cfg)
        for key in a:
            assert _max_err(a[key], b[key]) <= 1e-6, (key, i)
    for x, y in zip(pm["layers"], rm["layers"]):
        assert torch.equal(x["k"][:6].transpose(0, 1), y["k"].view(18, 8, 96)[:, :6])


def test_attend_capacity_leaves_the_result_unchanged():
    """``attend_capacity`` (the JAX package's capacity buckets) bounds the
    keys the einsum paths read; any bucket >= len + t gives the same
    outputs as none."""
    _, _, cfg, model = _pair(cache_capacity=8, cache_layout="row_major")
    px = torch.from_numpy(_video(1, 6, seed=2))
    caches = [encoder.init_cache(cfg, 1, device="cpu") for _ in range(2)]
    for lo, hi in ((0, 2), (2, 3), (3, 6)):
        a, _ = encoder.streaming_forward(model, px[:, lo:hi], caches[0])
        b, _ = encoder.streaming_forward(model, px[:, lo:hi], caches[1], attend_capacity=hi)
        assert torch.equal(a["pooler_output"], b["pooler_output"]), lo


def test_row_major_refusals():
    """What the row-major layout refuses, with the JAX package's words:
    per-stream lengths and partial appends."""
    _, _, cfg, model = _pair(cache_capacity=8, cache_layout="row_major")
    with pytest.raises(NotImplementedError, match="pos_major"):
        encoder.init_cache(cfg, 2, per_stream_len=True, device="cpu")
    pm = encoder.init_cache(cfg.replace(cache_layout="pos_major"), 2, per_stream_len=True,
                            device="cpu")
    ragged = {"layers": [{"k": torch.zeros(2, 9, 8, 96), "v": torch.zeros(2, 9, 8, 96)}] * 3,
              "len": pm["len"]}
    with pytest.raises(NotImplementedError, match="lockstep-only"):
        encoder.streaming_forward(model, torch.zeros(2, 1, 3, 48, 48), ragged)
    with pytest.raises(ValueError, match="pos_major"):
        encoder.temporal_attention(torch.zeros(2, 1, 9, 96),
                                   model.encoder.layer[0].temporal_attention, cfg,
                                   cache_kv=ragged["layers"][0], cache_len=torch.tensor(0),
                                   new_valid=torch.ones(2, dtype=torch.int32))
