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
    ],
)
def test_wrappers_reject_what_the_kernels_do_not_take(call, error):
    with pytest.raises(error):
        call(torch.randn(2, 5, 32))
