"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Skips without a CUDA device. On a machine with one:
``python -m pytest --noconftest tests/test_torch_cuda.py -q`` (the repo's
conftest imports JAX, which the port's GPU machine need not have).

Tolerances: fp32 2e-5 max-abs (the two differ only in summation order);
bf16 2e-2 max-abs, about two bf16 ulps at the outputs' magnitude (both
round the same fp32 result to bf16, and the kernel sums in another order).
"""

import numpy as np
import pytest
import torch

from streamformer_tpu_torch.ops import attention as ops

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture(autouse=True)
def _card():
    """Skip without a card (decided here, not at import, so every test
    worker collects the same tests); fp32 matmuls without TF32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _randn(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to("cuda", dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize(
    "rows,cap,heads,dh,length",
    [
        (56, 8, 4, 24, 0),
        (56, 8, 4, 24, 5),
        (56, 8, 4, 24, 7),
        (56, 8, 4, 24, 19),  # ring: len past capacity
        (1568, 16, 12, 64, 15),  # flagship streaming step, linear
        (1568, 16, 12, 64, 37),  # flagship, ring
        (40, 5, 2, 128, 3),
        (40, 5, 1, 8, 9),
    ],
)
def test_temporal_decode_pm_matches_plain(dtype, rows, cap, heads, dh, length):
    d = heads * dh
    q, kn, vn = (_randn((rows, d), dtype, s) for s in (1, 2, 3))
    kc, vc = _randn((cap, rows, d), dtype, 4), _randn((cap, rows, d), dtype, 5)
    cache_len = torch.tensor(length, dtype=torch.int32, device="cuda")
    k_ref, v_ref = kc.clone(), vc.clone()
    ref = ops.temporal_decode_pm_plain(q, kn, vn, k_ref, v_ref, cache_len, heads)
    before = ops.LAUNCHES["temporal_decode_pm"]
    got = ops.temporal_decode_pm(q, kn, vn, kc, vc, cache_len, heads)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["temporal_decode_pm"] == before + 1
    assert (got.float() - ref.float()).abs().max().item() <= TOL[dtype]
    assert torch.equal(kc, k_ref) and torch.equal(vc, v_ref)
    assert int(cache_len) == length


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize(
    "rows,n,heads,dh",
    [(3, 9, 4, 24), (5, 60, 2, 16), (8, 196, 12, 64), (128, 196, 12, 64), (2, 256, 2, 64),
     (2, 196, 1, 128), (4, 33, 3, 40)],
)
def test_spatial_flat_matches_plain(dtype, rows, n, heads, dh):
    d = heads * dh
    q, k, v = (_randn((rows, n, d), dtype, s) for s in (6, 7, 8))
    ref = ops.spatial_flat_plain(q, k, v, heads)
    before = ops.LAUNCHES["spatial_flat"]
    got = ops.spatial_flat(q, k, v, heads)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["spatial_flat"] == before + 1
    assert (got.float() - ref.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize(
    "rows,t,heads,dh",
    [(7, 1, 4, 24), (9, 4, 4, 24), (1568, 16, 12, 64), (10, 32, 2, 128), (6, 13, 3, 8)],
)
def test_temporal_fullclip_matches_plain(dtype, rows, t, heads, dh):
    d = heads * dh
    q, k, v = (_randn((rows, t, d), dtype, s) for s in (9, 10, 11))
    ref = ops.temporal_fullclip_plain(q, k, v, heads)
    before = ops.LAUNCHES["temporal_fullclip"]
    got = ops.temporal_fullclip(q, k, v, heads)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["temporal_fullclip"] == before + 1
    assert (got.float() - ref.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,t,heads,dh", [(1568, 16, 12, 64), (10, 32, 2, 128), (6, 5, 3, 8)])
def test_streamed_frames_equal_the_full_clip_bitwise(dtype, rows, t, heads, dh):
    """Kernel A on a linear cache holding frames 0..i-1 gives, bit for bit,
    kernel C's output for frame i: the two share one order of arithmetic."""
    d = heads * dh
    q, k, v = (_randn((rows, t, d), dtype, s) for s in (12, 13, 14))
    full = ops.temporal_fullclip(q, k, v, heads)
    k_cache = torch.zeros(t, rows, d, dtype=dtype, device="cuda")
    v_cache = torch.zeros_like(k_cache)
    for i in range(t):
        cache_len = torch.tensor(i, dtype=torch.int32, device="cuda")
        got = ops.temporal_decode_pm(q[:, i].contiguous(), k[:, i].contiguous(),
                                     v[:, i].contiguous(), k_cache, v_cache, cache_len, heads)
        assert torch.equal(got, full[:, i]), i


def test_wrappers_raise_instead_of_falling_back():
    q = _randn((8, 16, 64), torch.bfloat16, 0)
    with pytest.raises(ValueError):
        ops.spatial_flat(q.transpose(0, 1), q.transpose(0, 1), q.transpose(0, 1), 4)
    with pytest.raises(TypeError):
        ops.temporal_fullclip(q, q.float(), q, 4)
    with pytest.raises(ValueError):
        ops.temporal_fullclip(q, q, q, 3)  # D not a multiple of the heads
    with pytest.raises(ValueError):
        ops.spatial_flat(q, q, q.cpu(), 4)
