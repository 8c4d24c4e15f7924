"""The port's int8 functions and kernels F and G against the JAX package, on
the CPU in fp32.

* ``ops/quant.py``: codes and scales of ``quantize_rows``, the weight
  quantization (``Int8Linear`` against ``quantize_linear``), the encoder's
  ``quantize_kv`` and the int4 packing are EQUAL to the JAX package's on the
  same inputs; ``int8_dense`` with and without LoRA within 1e-6 max-abs (the
  same exact int32 product, then a few fp32 roundings in another order);
  ``quantize_encoder`` quantizes exactly the layers ``quantize_encoder_params``
  does, to the same codes.
* Kernels F and G: their plain versions against the Pallas kernels
  ``fused_temporal_decode_pm_int8(_ragged)`` in interpret mode (the fixture of
  tests/test_torch_kernels.py), output within 1e-5 max-abs (one fp32
  function, two summation orders), cache planes and scale columns equal.
  The Pallas kernels need rows a multiple of 32 and C % 8 == 0.
"""

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp

from streamformer_tpu.models import encoder as jax_encoder
from streamformer_tpu.ops import attention as A
from streamformer_tpu.ops import quant as jq
from streamformer_tpu_torch.checkpoint import params_from_jax
from streamformer_tpu_torch.models import encoder
from streamformer_tpu_torch.ops import attention as ops
from streamformer_tpu_torch.ops import quant

from test_torch_encoder import _pair
from test_torch_kernels import _interpret  # noqa: F401  (autouse: Pallas in interpret mode)

KERNEL_ATOL = 1e-5
DENSE_ATOL = 1e-6


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these tensors are tiny, and the 6-worker run
    oversubscribes the cores with each worker's default thread pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _randn(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _edges():
    """Rows whose codes sit on rounding edges: absmax 127 gives scale 1, so
    0.5, 1.5, 2.5, -0.5 round half to even; and an all-zero row."""
    x = _randn((6, 16), 40)
    x[0, :5] = [127.0, 0.5, 1.5, 2.5, -0.5]
    x[1] = 0.0
    return x


def test_quantize_rows_equals_jax():
    x = np.concatenate([_randn((37, 16), 41, 3.0), _edges()])
    ref_q, ref_s = jq.quantize_rows(jnp.asarray(x))
    got_q, got_s = quant.quantize_rows(torch.from_numpy(x))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(ref_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(ref_s))
    assert got_q[37, :5].tolist() == [127, 0, 2, 2, 0]  # the first edge row


def test_quantize_kv_equals_jax():
    """Per row over the whole trailing D, any leading shape."""
    x = _randn((2, 5, 9, 96), 42, 2.0)
    ref_q, ref_s = jax_encoder.quantize_kv(jnp.asarray(x))
    got_q, got_s = encoder.quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(ref_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(ref_s))
    np.testing.assert_array_equal(
        encoder.dequantize_kv(got_q, got_s, torch.float32).numpy(),
        np.asarray(jax_encoder.dequantize_kv(ref_q, ref_s, jnp.float32)))


def test_int8_linear_equals_quantize_linear():
    kernel = _randn((96, 40), 43, 0.05)  # JAX (in, out)
    kernel[:, 3] = 0.0  # an all-zero output channel
    ref = jq.quantize_linear({"kernel": jnp.asarray(kernel), "bias": jnp.zeros(40)})
    lin = nn.Linear(96, 40)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(kernel.T))
    got = quant.Int8Linear.from_linear(lin)
    assert got.weight.dtype == torch.int8 and got.weight.shape == (40, 96)
    np.testing.assert_array_equal(got.weight.numpy(), np.asarray(ref["kernel_q"]).T)
    np.testing.assert_array_equal(got.weight_scale.numpy(), np.asarray(ref["kernel_scale"]))
    torch.testing.assert_close(got.bias.detach(), lin.bias.detach(), rtol=0, atol=0)


@pytest.mark.parametrize("lora", [False, True])
def test_int8_dense_matches_jax(lora):
    rng = np.random.default_rng(44)
    x = np.concatenate([rng.standard_normal((32, 64)).astype(np.float32),
                        np.zeros((1, 64), np.float32)])
    p = {"kernel": jnp.asarray(_randn((64, 48), 45, 0.05)),  # outputs below 1: ulps below 1e-7
         "bias": jnp.asarray(_randn((48,), 46, 0.01))}
    if lora:
        p["lora_a"] = jnp.asarray(_randn((64, 4), 47, 0.02))
        p["lora_b"] = jnp.asarray(_randn((4, 48), 48, 0.1))
    qp = jq.quantize_linear(p)
    ref = jq.int8_dense(jnp.asarray(x), qp)
    lin = quant.Int8Linear(64, 48)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(np.asarray(qp["kernel_q"]).T))
        lin.weight_scale.copy_(torch.from_numpy(np.asarray(qp["kernel_scale"])))
        lin.bias.copy_(torch.from_numpy(np.asarray(p["bias"])))
    pair = None
    if lora:
        a, b = nn.Linear(64, 4, bias=False), nn.Linear(4, 48, bias=False)
        with torch.no_grad():
            a.weight.copy_(torch.from_numpy(np.asarray(p["lora_a"]).T))
            b.weight.copy_(torch.from_numpy(np.asarray(p["lora_b"]).T))
        pair = (a, b)
    with torch.no_grad():
        got = encoder.dense(torch.from_numpy(x).reshape(3, 11, 64), lin, pair).reshape(33, 48)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=DENSE_ATOL)


def test_int8_matmul_is_exact():
    """The s8 x s8 -> s32 product equals an int64 reference at the extremes
    (every code +-127)."""
    rng = np.random.default_rng(49)
    a = rng.choice([-127, 127], (19, 3072)).astype(np.int8)
    w = rng.choice([-127, 127], (24, 3072)).astype(np.int8)
    got = quant.int8_matmul(torch.from_numpy(a), torch.from_numpy(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ w.astype(np.int64).T)


def test_int4_kv_equals_jax():
    x = np.concatenate([_randn((2, 5, 3, 8), 50).reshape(30, 8),
                        np.tile(np.arange(-7, 1, dtype=np.float32), (2, 1)),
                        np.tile(np.arange(0, 8, dtype=np.float32) * -1.0, (2, 1))])
    ref_p, ref_s = jq.quantize_kv4(jnp.asarray(x))
    got_p, got_s = quant.quantize_kv4(torch.from_numpy(x))
    assert got_p.shape == (34, 4) and got_p.dtype == torch.int8
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(ref_p))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(ref_s))
    ref = jq.dequantize_kv4(ref_p, ref_s, jnp.float32)
    got = quant.dequantize_kv4(got_p, got_s, torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    with pytest.raises(ValueError, match="even"):
        quant.quantize_kv4(torch.zeros(2, 7))


@pytest.mark.parametrize("min_elements,lora", [(None, False), (0, False), (0, True)])
def test_quantize_encoder_matches_quantize_encoder_params(min_elements, lora):
    """The same layers are quantized, to the same codes and scales, whether
    the port quantizes its fp32 model or takes the JAX package's quantized
    tree. At the SMALL width (D=96) the default threshold quantizes the qkv,
    fc1 and fc2 layers; the attention outputs, ``temporal_dense`` and the
    MAP head's (D, D) leaves stay float."""
    jcfg, params, cfg, model = _pair(lora=lora)
    qtree = jax.tree.map(np.asarray, jq.quantize_encoder_params(params, min_elements))
    want = params_from_jax(qtree, cfg)
    got = quant.quantize_encoder(model, min_elements).state_dict()
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0, msg=key)
    scaled = sorted(k[:-len("_scale")] for k in want if k.endswith("weight_scale"))
    if min_elements is None:  # 96 x 288 and 96 x 192 weights, not 96 x 96
        assert scaled == sorted(
            [f"encoder.layer.{i}.{name}.weight" for i in range(3)
             for name in ("attention.attention.qkv", "intermediate.dense", "output.dense",
                          "temporal_attention.attention.qkv")]
            + ["head.mlp.fc1.weight", "head.mlp.fc2.weight"])
    else:  # 7 layers a block, the head's output, MLP and fused q/k/v
        assert len(scaled) == 3 * 7 + 4 and "head.attention.in_proj_weight" in scaled
        assert got["head.attention.in_proj_weight"].shape == (3 * 96, 96)
    if lora:
        assert got["encoder.layer.0.attention.attention.qkv_lora_a.weight"].dtype == torch.float32


def _int8_cache(c, r, d, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(-127, 128, (2, c, r, d)).astype(np.int8)
    scales = rng.uniform(0.005, 0.03, (2, c, r)).astype(np.float32)
    return codes, scales


def _jax_int8_decode(q, kn, vn, codes, scales, lens, per_stream, h=4):
    """The Pallas kernel on the same inputs: new frame quantized by the JAX
    package's quantize_kv, the scales transposed to its (R, C) layout."""
    knq, kns = jax_encoder.quantize_kv(jnp.asarray(kn))
    vnq, vns = jax_encoder.quantize_kv(jnp.asarray(vn))
    args = (jnp.asarray(q), knq, vnq, kns[:, None], vns[:, None], jnp.asarray(codes[0]),
            jnp.asarray(codes[1]), jnp.asarray(scales[0].T), jnp.asarray(scales[1].T))
    if per_stream is None:
        out = A.fused_temporal_decode_pm_int8(*args, jnp.asarray(lens, jnp.int32), num_heads=h)
    else:
        out = A.fused_temporal_decode_pm_int8_ragged(*args, jnp.asarray(lens, jnp.int32),
                                                     per_stream, num_heads=h)
    return out, (knq, vnq, kns, vns)


def _port_int8_decode(q, kn, vn, codes, scales, lens, per_stream, h=4):
    knq, kns = encoder.quantize_kv(torch.from_numpy(kn))
    vnq, vns = encoder.quantize_kv(torch.from_numpy(vn))
    cache = [torch.from_numpy(codes[0].copy()), torch.from_numpy(codes[1].copy()),
             torch.from_numpy(scales[0].copy()), torch.from_numpy(scales[1].copy())]
    lens_t = torch.tensor(lens, dtype=torch.int32)
    if per_stream is None:
        out = ops.temporal_decode_pm_int8(torch.from_numpy(q), knq, vnq, kns, vns, *cache, lens_t, h)
    else:
        out = ops.temporal_decode_pm_int8_ragged(torch.from_numpy(q), knq, vnq, kns, vns, *cache,
                                                 lens_t, per_stream, h)
    return out, cache


# F (one length) and G (32 rows per stream) at 64 rows, C=16, four heads of
# dh 24: lens 0, mid and C-1, and ring lens past C, where the new plane wraps
# to slot len % C. Then the card tests' head widths, one head of dh 8 and
# two of dh 128 (tests/test_torch_cuda.py), at rows and a capacity the
# Pallas kernel's tiling takes (a 32-row divisor, C % 8 == 0; it refuses
# the card tests' 40 and 56 rows and C=5), linear and ring.
INT8_DECODE_CASES = [
    pytest.param(lens, per_stream, 4, 24, id=tag)
    for lens, per_stream, tag in (
        (0, None, "0-None"), (7, None, "7-None"), (15, None, "15-None"), (16, None, "16-None"),
        (21, None, "21-None"), (37, None, "37-None"), ([0, 7], 32, "lens6-32"),
        ([15, 3], 32, "lens7-32"), ([16, 21, 37], 32, "lens8-32"), ([40, 0, 9], 32, "lens9-32"))
] + [
    pytest.param(9, None, 1, 8, id="h1-dh8-9-None"),
    pytest.param(37, None, 1, 8, id="h1-dh8-37-None"),
    pytest.param(5, None, 2, 128, id="h2-dh128-5-None"),
    pytest.param(21, None, 2, 128, id="h2-dh128-21-None"),
]


@pytest.mark.parametrize("lens,per_stream,h,dh", INT8_DECODE_CASES)
def test_int8_decode_matches_pallas(lens, per_stream, h, dh):
    """The plain versions of F and G (which the card holds them to) against
    the Pallas kernels: output, codes and the scale columns."""
    c = 16
    r = 64 if per_stream is None else per_stream * len(lens)
    d = h * dh
    q, kn, vn = (_randn((r, d), s) for s in (51, 52, 53))
    codes, scales = _int8_cache(c, r, d, 54)
    (ref, k_ref, v_ref), (knq, vnq, kns, vns) = _jax_int8_decode(q, kn, vn, codes, scales, lens,
                                                                per_stream, h)
    got, (k_got, v_got, ks_got, vs_got) = _port_int8_decode(q, kn, vn, codes, scales, lens,
                                                            per_stream, h)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=KERNEL_ATOL)
    np.testing.assert_array_equal(k_got.numpy(), np.asarray(k_ref))
    np.testing.assert_array_equal(v_got.numpy(), np.asarray(v_ref))
    # the scale columns: the new frame's quantize_kv scales at slot len % C
    # (the JAX caller writes them; here the kernel does), the rest unchanged
    rows_len = np.repeat(np.atleast_1d(lens), r // np.atleast_1d(lens).size)
    want_k, want_v = scales[0].copy(), scales[1].copy()
    want_k[rows_len % c, np.arange(r)] = np.asarray(kns)
    want_v[rows_len % c, np.arange(r)] = np.asarray(vns)
    np.testing.assert_array_equal(ks_got.numpy(), want_k)
    np.testing.assert_array_equal(vs_got.numpy(), want_v)


def test_int8_wrappers_check_their_operands():
    r, c, d, h = 8, 4, 32, 2
    q = torch.randn(r, d)
    codes = torch.zeros(r, d, dtype=torch.int8)
    s = torch.ones(r)
    cache = [torch.zeros(c, r, d, dtype=torch.int8), torch.zeros(c, r, d, dtype=torch.int8),
             torch.ones(c, r), torch.ones(c, r)]
    one = torch.tensor(1, dtype=torch.int32)
    before = dict(ops.LAUNCHES)
    ops.temporal_decode_pm_int8(q, codes, codes, s, s, *cache, one, h)
    ops.temporal_decode_pm_int8_ragged(q, codes, codes, s, s, *cache,
                                       torch.tensor([1, 3], dtype=torch.int32), 4, h)
    assert ops.LAUNCHES == before  # plain versions count nothing
    with pytest.raises(TypeError):  # float codes
        ops.temporal_decode_pm_int8(q, q, codes, s, s, *cache, one, h)
    with pytest.raises(TypeError):  # float64 scales
        ops.temporal_decode_pm_int8(q, codes, codes, s.double(), s, *cache, one, h)
    with pytest.raises(ValueError):  # row-major (R, C) scales
        ops.temporal_decode_pm_int8(q, codes, codes, s, s, *cache[:2], cache[2].t().contiguous(),
                                    cache[3], one, h)
    with pytest.raises(TypeError):  # int64 length
        ops.temporal_decode_pm_int8(q, codes, codes, s, s, *cache, one.long(), h)
    with pytest.raises(TypeError):  # 3 lengths for 2 streams
        ops.temporal_decode_pm_int8_ragged(q, codes, codes, s, s, *cache,
                                           torch.zeros(3, dtype=torch.int32), 4, h)
    with pytest.raises(ValueError):  # head dim 32 / 8 = 4
        ops.temporal_decode_pm_int8(q, codes, codes, s, s, *cache, one, 8)
