"""Kernel L (``ops.spatial_attention``, head-split spatial attention) on the
CPU against the JAX package's ``fused_spatial_attention``, run in interpret
mode as ``tests/test_pallas_attention.py`` runs it.

On the CPU the wrapper runs its plain version; its gradient is autograd of
the plain version, as the JAX package's is the VJP of its einsum
reference. Bars: the forward 2e-5 and the gradient 1e-4 max-abs in fp32,
the JAX package's own for this kernel.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from streamformer_tpu.ops import attention as A
from streamformer_tpu_torch.ops import attention as ops

FWD_TOL, GRAD_TOL = 2e-5, 1e-4


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

    monkeypatch.setattr(A.pl, "pallas_call", patched)


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)).max())


@pytest.mark.parametrize("shape", [(3, 4, 196, 32), (2, 2, 60, 16), (1, 3, 9, 8), (2, 1, 256, 128)])
def test_spatial_attention_matches_the_pallas_kernel(shape):
    q, k, v = _qkv(shape, 0)
    ref = A.fused_spatial_attention(*map(jnp.asarray, (q, k, v)))
    before = ops.LAUNCHES["spatial_attention"]
    got = ops.spatial_attention(*map(torch.from_numpy, (q, k, v)))
    assert got.shape == shape and got.dtype == torch.float32
    assert _err(got, ref) <= FWD_TOL
    assert ops.LAUNCHES["spatial_attention"] == before  # the plain version counts nothing


@pytest.mark.parametrize("shape", [(2, 2, 60, 16), (1, 4, 49, 24)])
def test_spatial_attention_gradient_matches_jax(shape):
    """The gradient of sum(out ** 2) in q, k and v against ``jax.grad`` of
    the fused kernel (its einsum VJP)."""
    q, k, v = _qkv(shape, 1)
    ref = jax.grad(lambda *a: jnp.sum(A.fused_spatial_attention(*a) ** 2), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    (ops.spatial_attention(*leaves) ** 2).sum().backward()
    for leaf, want in zip(leaves, ref):
        assert _err(leaf.grad, want) <= GRAD_TOL


def test_spatial_attention_rounds_probabilities_to_the_input_dtype():
    """bf16: the probabilities are rounded to bf16 before PV, as the TPU
    kernel rounds them; the plain version equals that arithmetic written out."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv((2, 3, 20, 16), 2))
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * 16**-0.5
    want = torch.matmul(torch.softmax(s, -1).to(torch.bfloat16).float(), v.float())
    got = ops.spatial_attention(q, k, v)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.to(torch.bfloat16))


def test_spatial_attention_checks_its_operands():
    x = torch.zeros(2, 3, 20, 16)
    with pytest.raises(ValueError, match="(R, H, N, dh)"):
        ops.spatial_attention(x, x, x[:1])
    with pytest.raises(ValueError, match="multiple of 8"):
        ops.spatial_attention(*(torch.zeros(2, 3, 20, 12),) * 3)
    # 260 patches, past the first slices' 256: runs, and matches the Pallas kernel
    q, k, v = _qkv((1, 1, 260, 8), 5)
    ref = A.fused_spatial_attention(*map(jnp.asarray, (q, k, v)))
    assert _err(ops.spatial_attention(*map(torch.from_numpy, (q, k, v))), ref) <= FWD_TOL
