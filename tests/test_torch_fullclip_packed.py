"""The packed full-clip entry (kernels C and H on the (B, T, N, 3D) output
of the qkv projection) against the JAX package, and its input checks.

On the CPU the entry runs its plain version. It is held to the JAX
package's ``fused_temporal_fullclip`` on the same numpy inputs, sliced and
transposed as the JAX encoder does (``streamformer_tpu/models/encoder.py``,
the fused full-clip branch), with ``pallas_call`` in interpret mode as in
tests/test_torch_kernels.py; its (B, T, N, 3D) gradient is held to
``jax.vjp`` of that function. Tolerances: fp32 1e-5 max-abs (one fp32
function, two orders of summation); bf16 2e-2 (both round the fp32 result
to bf16, about two bf16 ulps at the outputs' magnitude).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from streamformer_tpu.ops import attention as A
from streamformer_tpu_torch.ops import attention as ops

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# (T, heads, dh) at B=2, N=3
SHAPES = [(1, 2, 16), (5, 3, 8), (16, 2, 16), (16, 3, 8)]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these tensors are tiny, and the 6-worker run
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

    monkeypatch.setattr(pl, "pallas_call", patched)
    monkeypatch.setattr(A.pl, "pallas_call", patched)


def _randn(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _jax_fullclip(qkv, h):
    """The JAX encoder's full-clip branch around the Pallas kernel."""
    b, t, n, d3 = qkv.shape
    d = d3 // 3

    def rows(a):
        return a.transpose(0, 2, 1, 3).reshape(b * n, t, d)

    ctx = A.fused_temporal_fullclip(rows(qkv[..., :d]), rows(qkv[..., d:2 * d]),
                                    rows(qkv[..., 2 * d:]), h)
    return ctx.reshape(b, n, t, d).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,h,dh", SHAPES)
def test_packed_entry_matches_pallas(dtype, t, h, dh):
    qkv = _randn((2, t, 3, 3 * h * dh), 1)
    ref = _jax_fullclip(jnp.asarray(qkv, dtype), h)
    got = ops.temporal_fullclip_qkv(torch.from_numpy(qkv).to(getattr(torch, dtype)), h)
    assert got.dtype == getattr(torch, dtype) and got.is_contiguous()
    assert got.shape == (2, t, 3, h * dh)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               atol=TOL[dtype], rtol=0)


@pytest.mark.parametrize("t,h,dh", SHAPES)
def test_packed_gradient_matches_jax_vjp(t, h, dh):
    qkv = _randn((2, t, 3, 3 * h * dh), 2)
    g = _randn((2, t, 3, h * dh), 3)
    _, vjp = jax.vjp(lambda x: _jax_fullclip(x, h), jnp.asarray(qkv))
    (ref,) = vjp(jnp.asarray(g))
    x = torch.from_numpy(qkv).requires_grad_()
    out = ops.temporal_fullclip_qkv(x, h)
    assert out.grad_fn is not None
    (got,) = torch.autograd.grad(out, x, torch.from_numpy(g))
    assert got.shape == qkv.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    direct = ops.temporal_fullclip_qkv_bwd(torch.from_numpy(qkv), torch.from_numpy(g), h)
    assert torch.equal(direct, got)


def test_packed_entry_equals_the_row_entry():
    """The packed entry is the (R, T, D) entry on the transposed slices, its
    gradient the three row gradients side by side."""
    b, t, n, h, dh = 2, 6, 3, 2, 8
    d = h * dh
    qkv = torch.from_numpy(_randn((b, t, n, 3 * d), 4))
    g = torch.from_numpy(_randn((b, t, n, d), 5))

    def rows(x):
        return x.transpose(1, 2).reshape(b * n, t, x.shape[-1])

    q, k, v = (rows(qkv[..., i * d:(i + 1) * d]) for i in range(3))
    ctx = ops.temporal_fullclip(q, k, v, h)
    assert torch.equal(ops.temporal_fullclip_qkv(qkv, h), ctx.reshape(b, n, t, d).transpose(1, 2))
    grads = ops.temporal_fullclip_bwd(q, k, v, rows(g), h)
    packed = ops.temporal_fullclip_qkv_bwd(qkv, g, h)
    for i, want in enumerate(grads):
        assert torch.equal(rows(packed[..., i * d:(i + 1) * d]), want), i


def test_aligned_strided_layouts_are_taken_as_they_are():
    """A qkv whose rows are padded (strides 16-byte aligned, not contiguous)
    is read in place, and gives the contiguous copy's result."""
    b, t, n, h, dh = 2, 4, 3, 2, 8
    d = h * dh
    buf = torch.from_numpy(_randn((b, t, n, 3 * d + 8), 6))
    qkv = buf[..., :3 * d]
    assert not qkv.is_contiguous()
    g = torch.from_numpy(_randn((b, t, n, d + 4), 7))[..., :d]
    assert torch.equal(ops.temporal_fullclip_qkv(qkv, h),
                       ops.temporal_fullclip_qkv(qkv.contiguous(), h))
    assert torch.equal(ops.temporal_fullclip_qkv_bwd(qkv, g, h),
                       ops.temporal_fullclip_qkv_bwd(qkv.contiguous(), g.contiguous(), h))


def _offset(shape, elements, dtype=torch.float32):
    """A tensor of ``shape`` starting ``elements`` elements into a buffer."""
    n = int(np.prod(shape))
    return torch.zeros(n + elements, dtype=dtype)[elements:].view(shape)


@pytest.mark.parametrize(
    "call,error",
    [
        (lambda: ops.temporal_fullclip_qkv(torch.zeros(2, 4, 3, 47), 2), ValueError),  # 3D
        (lambda: ops.temporal_fullclip_qkv(torch.zeros(8, 4, 96), 2), ValueError),  # not 4-D
        # T = 33, past the first slices' 32 frames: runs, as the row entry
        (lambda: _packed_vs_rows(33), None),
        (lambda: ops.temporal_fullclip_qkv(torch.zeros(2, 4, 3, 96), 3), ValueError),  # D % H
        (lambda: ops.temporal_fullclip_qkv(torch.zeros(2, 4, 3, 96), 8), ValueError),  # dh = 4
        (lambda: ops.temporal_fullclip_qkv(torch.zeros(2, 4, 3, 96).double(), 2), TypeError),
        # a row stride of 98 fp32 elements: 392 bytes, not a multiple of 16
        (lambda: ops.temporal_fullclip_qkv(torch.zeros(2, 4, 3, 98)[..., :96], 2), ValueError),
        # a row stride of 100 bf16 elements: 200 bytes
        (lambda: ops.temporal_fullclip_qkv(
            torch.zeros(2, 4, 3, 100, dtype=torch.bfloat16)[..., :96], 2), ValueError),
        (lambda: ops.temporal_fullclip_qkv(_offset((2, 4, 3, 96), 1), 2), ValueError),  # data
        (lambda: ops.temporal_fullclip_qkv(_offset((2, 4, 3, 96), 2), 2), ValueError),  # 8 bytes
        # the D axis not contiguous
        (lambda: ops.temporal_fullclip_qkv(torch.zeros(2, 4, 96, 3).transpose(-1, -2), 2),
         ValueError),
        # the backward: g of the wrong shape, dtype, layout or alignment
        (lambda: ops.temporal_fullclip_qkv_bwd(torch.zeros(2, 4, 3, 96), torch.zeros(2, 4, 3, 96),
                                               2), ValueError),
        (lambda: ops.temporal_fullclip_qkv_bwd(torch.zeros(2, 4, 3, 96),
                                               torch.zeros(2, 4, 3, 32, dtype=torch.bfloat16), 2),
         TypeError),
        (lambda: ops.temporal_fullclip_qkv_bwd(torch.zeros(2, 4, 3, 96),
                                               torch.zeros(()).expand(2, 4, 3, 32), 2),
         ValueError),  # an expanded gradient: stride 0
        (lambda: ops.temporal_fullclip_qkv_bwd(torch.zeros(2, 4, 3, 96),
                                               torch.zeros(2, 4, 3, 34)[..., :32], 2),
         ValueError),  # a row stride of 34 fp32 elements
        (lambda: ops.temporal_fullclip_qkv_bwd(torch.zeros(2, 4, 3, 96), _offset((2, 4, 3, 32), 3),
                                               2), ValueError),
    ],
)
def test_packed_entries_reject_what_the_kernels_do_not_take(call, error):
    if error is None:  # a shape an earlier slice refused
        got, want = call()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL["float32"], rtol=0)
        return
    with pytest.raises(error):
        call()


def _packed_vs_rows(t, h=2, dh=16):
    """The packed entry and the JAX package's einsum reference on the
    encoder's transposed slices of a (2, t, 3, 3D) qkv."""
    qkv = _randn((2, t, 3, 3 * h * dh), 4)
    d = h * dh

    def rows(a):
        return jnp.asarray(a.transpose(0, 2, 1, 3).reshape(6, t, d))

    ref = A.fullclip_temporal_reference(rows(qkv[..., :d]), rows(qkv[..., d:2 * d]),
                                        rows(qkv[..., 2 * d:]), h)
    want = np.asarray(ref).reshape(2, 3, t, d).transpose(0, 2, 1, 3)
    return ops.temporal_fullclip_qkv(torch.from_numpy(qkv), h), want


def test_packed_entry_launches_nothing_on_the_cpu_and_builds_no_graph_without_grad():
    before = dict(ops.LAUNCHES)
    qkv = torch.from_numpy(_randn((2, 4, 3, 48), 8))
    out = ops.temporal_fullclip_qkv(qkv, 2)
    ops.temporal_fullclip_qkv_bwd(qkv, out, 2)
    assert ops.LAUNCHES == before
    assert out.grad_fn is None
    with torch.no_grad():
        assert ops.temporal_fullclip_qkv(qkv.requires_grad_(), 2).grad_fn is None
