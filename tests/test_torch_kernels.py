"""The plain versions of the port's kernels against the JAX package's Pallas
kernels, run in interpret mode on the CPU (as tests/test_pallas_attention.py
runs them), and the wrappers' input checks.

Tolerance 1e-5 max-abs in fp32: the two compute the same fp32 function and
differ only in summation order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from streamformer_tpu.ops import attention as A
from streamformer_tpu_torch.ops import attention as ops

ATOL = 1e-5


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def patched(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    monkeypatch.setattr(pl, "pallas_call", patched)
    monkeypatch.setattr(A.pl, "pallas_call", patched)


def _randn(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("length", [0, 3, 7, 8, 13, 19])
def test_temporal_decode_pm_matches_pallas(length):
    """Linear cache at len 0, mid and C-1; ring (len >= C) at C, C+5 and
    2C+3, where the new plane wraps to slot len % C."""
    r, c, h, dh = 24, 8, 4, 24
    d = h * dh
    q, kn, vn = (_randn((r, d), s) for s in (1, 2, 3))
    kc, vc = _randn((c, r, d), 4), _randn((c, r, d), 5)
    ref, k_ref, v_ref = A.fused_temporal_decode_pm(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(length, jnp.int32), num_heads=h,
    )
    k_got, v_got = _t(kc), _t(vc)
    got = ops.temporal_decode_pm(
        _t(q), _t(kn), _t(vn), k_got, v_got, torch.tensor(length, dtype=torch.int32), h
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(k_got.numpy(), np.asarray(k_ref))
    np.testing.assert_array_equal(v_got.numpy(), np.asarray(v_ref))


def test_spatial_flat_matches_pallas():
    r, n, h, dh = 3, 9, 4, 24
    d = h * dh
    q, k, v = (_randn((r, n, d), s) for s in (6, 7, 8))
    ref = A.fused_spatial_flat(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h)
    got = ops.spatial_flat(_t(q), _t(k), _t(v), h)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("t", [1, 4, 16])
def test_temporal_fullclip_matches_pallas(t):
    r, h, dh = 18, 4, 24
    d = h * dh
    q, k, v = (_randn((r, t, d), s) for s in (9, 10, 11))
    ref = A.fused_temporal_fullclip(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h)
    got = ops.temporal_fullclip(_t(q), _t(k), _t(v), h)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize(
    "lens",
    [[0, 3, 7], [7, 0, 3], [8, 13, 19]],  # linear at 0, mid and C-1; ring past C
)
def test_temporal_decode_pm_ragged_matches_pallas(lens):
    """Per-stream lengths, 8 rows per stream (a multiple of 8, so the JAX
    kernel needs no row padding)."""
    per_stream, c, h, dh = 8, 8, 4, 24
    r, d = per_stream * len(lens), h * dh
    q, kn, vn = (_randn((r, d), s) for s in (21, 22, 23))
    kc, vc = _randn((c, r, d), 24), _randn((c, r, d), 25)
    ref, k_ref, v_ref = A.fused_temporal_decode_pm_ragged(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(lens, jnp.int32), per_stream, num_heads=h,
    )
    k_got, v_got = _t(kc), _t(vc)
    lens_t = torch.tensor(lens, dtype=torch.int32)
    got = ops.temporal_decode_pm_ragged(_t(q), _t(kn), _t(vn), k_got, v_got, lens_t, per_stream, h)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(k_got.numpy(), np.asarray(k_ref))
    np.testing.assert_array_equal(v_got.numpy(), np.asarray(v_ref))
    assert lens_t.tolist() == lens


@pytest.mark.parametrize(
    "t,lens,valid",
    [(1, [0, 3, 7], [1, 0, 1]), (3, [2, 0, 5], [3, 1, 0]), (3, [0, 4, 1], [0, 3, 3])],
)
def test_temporal_append_pm_ragged_matches_pallas(t, lens, valid):
    """Outputs where ti < valid[b] (the rest are unspecified) and cache slots
    below lens + valid (the Pallas kernel copies stale blocks through past
    them), with lens + valid <= C."""
    per_stream, c, h, dh = 8, 8, 4, 24
    r, d = per_stream * len(lens), h * dh
    q, kn, vn = (_randn((t, r, d), s) for s in (31, 32, 33))
    kc, vc = _randn((c, r, d), 34), _randn((c, r, d), 35)
    ref, k_ref, v_ref = A.fused_temporal_append_pm_ragged(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(lens, jnp.int32), jnp.asarray(valid, jnp.int32), per_stream, num_heads=h,
    )
    k_got, v_got = _t(kc), _t(vc)
    got = ops.temporal_append_pm_ragged(
        _t(q), _t(kn), _t(vn), k_got, v_got, torch.tensor(lens, dtype=torch.int32),
        torch.tensor(valid, dtype=torch.int32), per_stream, h,
    )
    for b, (length, n) in enumerate(zip(lens, valid)):
        sl = slice(b * per_stream, (b + 1) * per_stream)
        np.testing.assert_allclose(got[:n, sl].numpy(), np.asarray(ref)[:n, sl], atol=ATOL, rtol=0)
        for mine, theirs in ((k_got, k_ref), (v_got, v_ref)):
            np.testing.assert_array_equal(mine[:length + n, sl].numpy(),
                                          np.asarray(theirs)[:length + n, sl])


def test_append_frame_cap():
    """Kernel E holds capacity + new frames <= 32 keys per warp: 16 frames
    at the flagship capacity 16, none past capacity 31."""
    assert ops.append_frame_cap(16) == 16
    assert ops.append_frame_cap(31) == 1
    assert ops.append_frame_cap(32) == 0 and ops.append_frame_cap(64) == 0


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """A missing compiler is an error at first use, never a fallback."""
    from streamformer_tpu_torch.ops import build

    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build(("spatial_flat",))
    assert build.library_path("spatial_flat").parent == tmp_path / "build"


def test_plain_versions_launch_nothing():
    before = dict(ops.LAUNCHES)
    x = torch.randn(2, 5, 32)
    ops.spatial_flat(x, x, x, 2)
    ops.temporal_fullclip(x, x, x, 2)
    ops.temporal_decode_pm(x[0], x[0], x[0], x.clone(), x.clone(), torch.tensor(1, dtype=torch.int32), 2)
    lens = torch.tensor([1, 0, 3, 2, 0], dtype=torch.int32)
    ops.temporal_decode_pm_ragged(x[0], x[0], x[0], x.clone(), x.clone(), lens, 1, 2)
    ops.temporal_append_pm_ragged(x[:1], x[:1], x[:1], x.clone(), x.clone(), lens, lens.clamp(max=1),
                                  1, 2)
    assert ops.LAUNCHES == before


@pytest.mark.parametrize(
    "call,error",
    [
        (lambda x: ops.spatial_flat(x, x, x.double(), 2), TypeError),
        (lambda x: ops.spatial_flat(x, x, x.half(), 2), TypeError),
        (lambda x: ops.spatial_flat(x.transpose(1, 2), x.transpose(1, 2), x.transpose(1, 2), 2),
         ValueError),
        (lambda x: ops.spatial_flat(x, x, x, 3), ValueError),  # D % H
        (lambda x: ops.spatial_flat(x, x, x, 8), ValueError),  # dh = 4
        (lambda x: ops.spatial_flat(x, x, x[:, :4], 2), ValueError),
        (lambda x: ops.temporal_fullclip(x.repeat(1, 7, 1), x.repeat(1, 7, 1), x.repeat(1, 7, 1), 2),
         NotImplementedError),  # T = 35 > 32
        (lambda x: ops.spatial_flat(x.repeat(1, 52, 1), x.repeat(1, 52, 1), x.repeat(1, 52, 1), 2),
         NotImplementedError),  # N = 260 > 256
        (lambda x: ops.temporal_decode_pm(x[0], x[0], x[0], x, x, torch.tensor(1), 2), TypeError),
        (lambda x: ops.temporal_decode_pm(x[0], x[0], x[0], x[:, :4], x[:, :4],
                                          torch.tensor(1, dtype=torch.int32), 2), ValueError),
        # D and E: lens and valid are (B,) int32, B * rows_per_stream == R
        (lambda x: ops.temporal_decode_pm_ragged(x[0], x[0], x[0], x, x, torch.zeros(5), 1, 2),
         TypeError),  # float lens
        (lambda x: ops.temporal_decode_pm_ragged(x[0], x[0], x[0], x, x,
                                                 torch.zeros(5, dtype=torch.int64), 1, 2),
         TypeError),  # int64 lens
        (lambda x: ops.temporal_decode_pm_ragged(x[0], x[0], x[0], x, x,
                                                 torch.zeros(4, dtype=torch.int32), 1, 2),
         TypeError),  # 4 lengths for 5 streams
        (lambda x: ops.temporal_decode_pm_ragged(x[0], x[0], x[0], x, x,
                                                 torch.zeros(2, dtype=torch.int32), 2, 2),
         ValueError),  # 5 rows are not streams of 2
        (lambda x: ops.temporal_append_pm_ragged(x[:1], x[:1], x[:1], x, x,
                                                 torch.zeros(5, dtype=torch.int32),
                                                 torch.zeros((5, 1), dtype=torch.int32), 1, 2),
         TypeError),  # valid of the wrong shape
        (lambda x: ops.temporal_append_pm_ragged(
            x[:1].expand(31, 5, 32).contiguous(), x[:1].expand(31, 5, 32).contiguous(),
            x[:1].expand(31, 5, 32).contiguous(), x, x, torch.zeros(5, dtype=torch.int32),
            torch.zeros(5, dtype=torch.int32), 1, 2),
         NotImplementedError),  # capacity 2 + 31 frames > 32 keys
        (lambda x: ops.temporal_append_pm_ragged(
            x[:1], x[:1], x[:1], x.repeat(16, 1, 1), x.repeat(16, 1, 1),
            torch.zeros(5, dtype=torch.int32), torch.zeros(5, dtype=torch.int32), 1, 2),
         NotImplementedError),  # capacity 32 + 1 frame > 32 keys
    ],
)
def test_wrappers_reject_what_the_kernels_do_not_take(call, error):
    with pytest.raises(error):
        call(torch.randn(2, 5, 32))
