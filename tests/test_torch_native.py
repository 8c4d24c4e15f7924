"""The port's MSDeformAttn CPU oracle (``streamformer_tpu_torch.native``,
its own ``msdeform.cpp`` built with g++) against the JAX package's core
(``streamformer_tpu.ops.msdeform_attn.ms_deform_attn_core`` and ``jax.grad``
over it) and against the port's plain version; and the port's entry point
``ms_deform_attn_core`` on CPU tensors, which is the plain version bit for
bit (kernel M runs only on the card: ``tests/test_torch_cuda.py``).

Inputs come from ``np.random.default_rng`` seeds. Tolerances are the JAX
package's own native test's (``tests/test_native_msdeform.py``): 1e-5 the
forward, 1e-4 the value and weight gradients, 1e-3 the location gradients
(they are scaled by the map's width and height).
"""

import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from streamformer_tpu.ops import msdeform_attn as jax_msda
from streamformer_tpu_torch import native
from streamformer_tpu_torch.ops import attention as ops
from streamformer_tpu_torch.ops import build
from streamformer_tpu_torch.ops import msdeform_attn

# (batch, queries, heads, channels, points, levels, location range)
CASES = {
    # the JAX package's native test: 2 levels, locations in [-0.1, 1.1]
    "jax_test": (2, 6, 4, 8, 3, [(5, 7), (3, 4)], (-0.1, 1.1)),
    # the pixel decoder's layout, narrow: 3 levels, 8 heads of 32, a query a position
    "pixel_decoder": (1, 84, 8, 32, 4, [(8, 8), (4, 4), (2, 2)], (-0.1, 1.1)),
    # one level (the adapter's extractor), an odd channel count, far outside the map
    "one_level_odd_d": (2, 7, 3, 5, 4, [(6, 5)], (-0.6, 1.6)),
}
TOL = {"out": 1e-5, "value": 1e-4, "loc": 1e-3, "weight": 1e-4}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these tensors are tiny, and the 6-worker run
    oversubscribes the cores with each worker's default thread pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def oracle():
    if shutil.which("g++") is None:
        pytest.skip("no C++ toolchain (g++)")
    native.build()
    return native


def _inputs(case, seed=0):
    b, q, m, d, p, shapes, (lo, hi) = CASES[case]
    rng = np.random.default_rng(seed)
    s = sum(h * w for h, w in shapes)
    value = rng.standard_normal((b, s, m, d)).astype(np.float32)
    loc = rng.uniform(lo, hi, (b, q, m, len(shapes), p, 2)).astype(np.float32)
    weight = rng.random((b, q, m, len(shapes), p)).astype(np.float32)
    weight /= weight.reshape(b, q, m, -1).sum(-1).reshape(b, q, m, 1, 1)
    grad_out = rng.standard_normal((b, q, m * d)).astype(np.float32)
    return value, shapes, loc, weight, grad_out


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("case", list(CASES))
def test_native_matches_the_jax_core_and_its_gradients(oracle, case):
    value, shapes, loc, weight, grad_out = _inputs(case)

    def out_and_grads(v, l_, w):
        out, vjp = jax.vjp(lambda *a: jax_msda.ms_deform_attn_core(a[0], shapes, a[1], a[2]),
                           v, l_, w)
        return out, vjp(jnp.asarray(grad_out))

    want, want_grads = jax.jit(out_and_grads)(jnp.asarray(value), jnp.asarray(loc),
                                              jnp.asarray(weight))
    _close(oracle.ms_deform_attn_forward_np(value, np.asarray(shapes), loc, weight), want,
           TOL["out"])
    got = oracle.ms_deform_attn_backward_np(value, np.asarray(shapes), loc, weight, grad_out)
    for key, g, w in zip(("value", "loc", "weight"), got, want_grads):
        _close(g, w, TOL[key])


@pytest.mark.parametrize("case", list(CASES))
def test_native_matches_the_plain_version(oracle, case):
    value, shapes, loc, weight, grad_out = _inputs(case, seed=1)
    v, l_, w, g = (torch.from_numpy(x) for x in (value, loc, weight, grad_out))
    _close(oracle.ms_deform_attn_forward_np(value, shapes, loc, weight),
           msdeform_attn.ms_deform_attn_core_plain(v, shapes, l_, w), TOL["out"])
    want = msdeform_attn.ms_deform_attn_core_backward_plain(v, shapes, l_, w, g)
    got = oracle.ms_deform_attn_backward_np(value, shapes, loc, weight, grad_out)
    for key, a, b in zip(("value", "loc", "weight"), got, want):
        assert a.shape == tuple(b.shape)
        _close(a, b, TOL[key])


def test_native_builds_into_build_by_digest_and_checks_its_inputs(oracle):
    """The library sits in the checkout's ``build/`` under a digest of its
    source and flags; inputs whose shapes disagree raise before the C code
    can read past them."""
    path = native.library_path()
    assert path.parent == build.BUILD_DIR and path.name.startswith("libmsdeform-")
    assert path.exists() and native.build() == str(path)
    value, shapes, loc, weight, grad_out = _inputs("jax_test")
    with pytest.raises(ValueError, match="positions"):
        native.ms_deform_attn_forward_np(value[:, 1:], shapes, loc, weight)
    with pytest.raises(ValueError, match="weight"):
        native.ms_deform_attn_forward_np(value, shapes, loc, weight[..., 1:])
    with pytest.raises(ValueError, match="grad_out"):
        native.ms_deform_attn_backward_np(value, shapes, loc, weight, grad_out[:, 1:])


@pytest.mark.parametrize("case", list(CASES))
def test_core_on_the_cpu_is_the_plain_version_bit_for_bit(case):
    """On CPU tensors the entry point and its backward are the plain version
    (no autograd Function, no launch), output and gradients bit for bit."""
    value, shapes, loc, weight, grad_out = _inputs(case, seed=2)
    before = dict(ops.LAUNCHES)
    runs = []
    for core in (msdeform_attn.ms_deform_attn_core, msdeform_attn.ms_deform_attn_core_plain):
        args = [torch.from_numpy(x).requires_grad_() for x in (value, loc, weight)]
        out = core(args[0], shapes, args[1], args[2])
        assert "MSDeformAttnCore" not in type(out.grad_fn).__name__
        out.backward(torch.from_numpy(grad_out))
        runs.append([out.detach()] + [a.grad for a in args])
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    v, l_, w, g = (torch.from_numpy(x) for x in (value, loc, weight, grad_out))
    grads = msdeform_attn.ms_deform_attn_core_backward(v, shapes, l_, w, g)
    for a, b in zip(grads, runs[1][1:]):
        assert torch.equal(a, b)
    assert ops.LAUNCHES == before
