"""The t=1 decode kernels F, G, J and K at a cache of 4,096 slots, past the
capacity whose scores a block of the card's decode body holds in shared
memory (about 3,800 at this width), on the CPU.

The port's plain versions against the JAX package's Pallas kernels, run in
interpret mode (as tests/test_pallas_attention.py runs them) with cache
blocks of 1,024 slots, so that a call takes four grid steps: 12 heads of 64
and 32 rows a stream. Outputs within 2e-5 max-abs in fp32 (the two compute
the same fp32 function and differ only in summation order); the caches
after the in-place write equal (F and G: the codes, and the scale columns
the JAX package's callers write).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from streamformer_tpu.models import encoder as jax_encoder
from streamformer_tpu.ops import attention as A
from streamformer_tpu_torch.models import encoder
from streamformer_tpu_torch.ops import attention as ops

TOL = 2e-5
CAP, HEADS, DH, ROWS = 4096, 12, 64, 32
BLOCK = 1024  # cache positions a grid step of the Pallas kernels


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread, as in every port test file: the 6-worker run
    oversubscribes the cores with each worker's default thread pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def patched(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    monkeypatch.setattr(A.pl, "pallas_call", patched)


def _max_err(got: torch.Tensor, ref) -> float:
    return float(np.abs(got.float().numpy() - np.asarray(ref, np.float32)).max())


def _normal(rng, shape):
    return rng.standard_normal(shape, dtype=np.float32)


def _uniform(rng, shape):
    """Values in [-2, 2): the caches, hundreds of millions of them, drawn
    faster than normals."""
    return rng.random(shape, dtype=np.float32) * 4 - 2


def _int8_case(rows, lens, per_stream, seed):
    """F (per_stream None) or G on a random int8 cache: the port's output and
    its cache after the write, and the JAX kernel's, the scale columns
    written at each row's slot as the JAX package's callers write them."""
    rng = np.random.default_rng(seed)
    d = HEADS * DH
    q, kn, vn = (_normal(rng, (rows, d)) for _ in range(3))
    codes = np.frombuffer(rng.bytes(2 * CAP * rows * d), np.int8).reshape(2, CAP, rows, d).copy()
    scales = rng.uniform(0.005, 0.03, (2, CAP, rows)).astype(np.float32)
    knq, kns = jax_encoder.quantize_kv(jnp.asarray(kn))
    vnq, vns = jax_encoder.quantize_kv(jnp.asarray(vn))
    args = (jnp.asarray(q), knq, vnq, kns[:, None], vns[:, None], jnp.asarray(codes[0]),
            jnp.asarray(codes[1]), jnp.asarray(scales[0].T), jnp.asarray(scales[1].T))
    lens_j = jnp.asarray(lens, jnp.int32)
    if per_stream is None:
        ref, k_ref, v_ref = A.fused_temporal_decode_pm_int8(*args, lens_j, num_heads=HEADS,
                                                            cache_block=BLOCK)
    else:
        ref, k_ref, v_ref = A.fused_temporal_decode_pm_int8_ragged(
            *args, lens_j, per_stream, num_heads=HEADS, cache_block=BLOCK)
    slot = np.repeat(np.atleast_1d(lens), per_stream or rows) % CAP
    want_scales = scales.copy()
    want_scales[0, slot, np.arange(rows)] = np.asarray(kns)
    want_scales[1, slot, np.arange(rows)] = np.asarray(vns)

    cache = [torch.from_numpy(codes[0]), torch.from_numpy(codes[1]),
             torch.from_numpy(scales[0]), torch.from_numpy(scales[1])]
    knq_t, kns_t = encoder.quantize_kv(torch.from_numpy(kn))
    vnq_t, vns_t = encoder.quantize_kv(torch.from_numpy(vn))
    lens_t = torch.tensor(lens, dtype=torch.int32)
    if per_stream is None:
        got = ops.temporal_decode_pm_int8(torch.from_numpy(q), knq_t, vnq_t, kns_t, vns_t,
                                          *cache, lens_t, HEADS)
    else:
        got = ops.temporal_decode_pm_int8_ragged(torch.from_numpy(q), knq_t, vnq_t, kns_t, vns_t,
                                                 *cache, lens_t, per_stream, HEADS)
    assert _max_err(got, ref) <= TOL
    np.testing.assert_array_equal(cache[0].numpy(), np.asarray(k_ref))
    np.testing.assert_array_equal(cache[1].numpy(), np.asarray(v_ref))
    np.testing.assert_array_equal(cache[2].numpy(), want_scales[0])
    np.testing.assert_array_equal(cache[3].numpy(), want_scales[1])


@pytest.mark.parametrize("length", [CAP - 1, CAP + 37], ids=["linear", "ring"])
def test_int8_decode_at_4096_slots_matches_jax(length):
    """F: one stream of 32 rows, on the linear cache's last slot and on the
    ring past C."""
    _int8_case(ROWS, length, None, 11)


def test_int8_ragged_decode_at_4096_slots_matches_jax():
    """G: two streams of 32 rows, one on the linear cache's last slot, one
    on the ring past C."""
    _int8_case(2 * ROWS, [CAP - 1, CAP + 1000], ROWS, 12)


def test_row_major_decode_at_4096_slots_matches_jax():
    """J: fp32, on the linear cache's last slot; the whole cache after the
    in-place write equals the JAX kernel's."""
    rng = np.random.default_rng(13)
    d = HEADS * DH
    q, kn, vn = (_normal(rng, (ROWS, d)) for _ in range(3))
    kc, vc = (_uniform(rng, (ROWS, CAP, d)) for _ in range(2))
    length = CAP - 1
    ref, k_ref, v_ref = A.fused_temporal_decode_inplace(
        *map(jnp.asarray, (q, kn, vn, kc, vc)), jnp.asarray(length, jnp.int32), num_heads=HEADS,
        row_block=ROWS, cache_block=BLOCK)
    k_cache, v_cache = torch.from_numpy(kc), torch.from_numpy(vc)
    got = ops.temporal_decode_rm(torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn),
                                 k_cache, v_cache, torch.tensor(length, dtype=torch.int32), HEADS)
    assert _max_err(got, ref) <= TOL
    np.testing.assert_array_equal(k_cache.numpy(), np.asarray(k_ref))
    np.testing.assert_array_equal(v_cache.numpy(), np.asarray(v_ref))


def test_row_major_readonly_int8_decode_at_4096_slots_matches_jax():
    """K on the int8 row-major cache (per-(row, position, head) scales from
    ``quantize_kv``), every position valid; nothing is written."""
    rng = np.random.default_rng(14)
    d = HEADS * DH
    q = _normal(rng, (ROWS, d))
    (kq, ks), (vq, vs) = (
        jax_encoder.quantize_kv(jnp.asarray(_uniform(rng, (ROWS, CAP, d))).reshape(
            ROWS, CAP, HEADS, DH)) for _ in range(2))
    jax_args = (kq.reshape(ROWS, CAP, d), vq.reshape(ROWS, CAP, d), ks, vs)
    length = CAP - 1
    ref = A.fused_temporal_decode(jnp.asarray(q), *jax_args, jnp.asarray(length, jnp.int32),
                                  num_heads=HEADS, row_block=ROWS, cache_block=BLOCK)
    port = [torch.from_numpy(np.array(a)) for a in jax_args]
    before = [a.clone() for a in port]
    got = ops.temporal_decode_rm_readonly(torch.from_numpy(q), *port,
                                          torch.tensor(length, dtype=torch.int32), HEADS)
    assert _max_err(got, ref) <= TOL
    assert all(torch.equal(a, b) for a, b in zip(port, before))
