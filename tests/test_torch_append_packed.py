"""The packed multi-frame append entry (kernel E on the (B, t, N, 3D) output
of the qkv projection) against the JAX package, and its input checks.

On the CPU the entry runs its plain version. It is held to the JAX
package's ``fused_temporal_append_pm_ragged`` on the same numpy inputs,
sliced and transposed as the JAX encoder does (its linear multi-frame
branch: frames-major (t, B*N, D) rows), with ``pallas_call`` in interpret
mode as in tests/test_torch_kernels.py, on ragged and lockstep streams; the
appended cache planes are held to the JAX kernel's bit for bit below lens +
valid (past them the Pallas kernel copies stale blocks through). Outputs
for new frames past valid[b] are unspecified and not compared. Tolerances:
fp32 1e-5 max-abs (one fp32 function, two orders of summation); bf16 2e-2
(both round the fp32 result to bf16, about two bf16 ulps at the outputs'
magnitude).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from streamformer_tpu.ops import attention as A
from streamformer_tpu_torch.ops import attention as ops

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
B, N = 2, 8  # the JAX kernel pads each stream's rows to a multiple of 8
# (t, capacity, heads, dh, lens, valid): two lens are ragged streams of N
# rows, one is a lockstep stream of all B*N rows; lens + valid <= C. Each
# case in the dtypes it runs (the interpreted Pallas kernel takes seconds a
# call at t = 8, so the file stays near half a minute on one worker).
CASES = {
    "t1_C4": (1, 4, 2, 16, [0, 3], [1, 1]),
    "t3_C16": (3, 16, 3, 8, [2, 13], [3, 1]),
    "t8_C16": (8, 16, 2, 16, [0, 8], [8, 5]),
    "t8_C40": (8, 40, 3, 16, [5, 32], [8, 8]),  # past the 32 keys a warp held once
    "t8_C4_partial": (8, 4, 2, 8, [0, 1], [4, 0]),
    "lockstep_t3_C4": (3, 4, 2, 8, [1], [3]),
    "lockstep_t8_C40": (8, 40, 2, 16, [17], [8]),
    "lockstep_t1_C16": (1, 16, 3, 16, [15], [1]),
}
RUNS = [(dt, case) for case in CASES
        for dt in {"t8_C40": ("float32", "bfloat16"), "lockstep_t3_C4": ("float32", "bfloat16"),
                   "t8_C16": ("bfloat16",), "lockstep_t8_C40": ("bfloat16",)}
        .get(case, ("float32",))]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these tensors are tiny, and the 6-worker run
    oversubscribes the cores with each worker's default thread pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _randn(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def patched(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    monkeypatch.setattr(pl, "pallas_call", patched)
    monkeypatch.setattr(A.pl, "pallas_call", patched)


def _jax_append(qkv, kc, vc, lens, valid, rows_per_stream, h):
    """The JAX encoder's linear multi-frame branch around the Pallas kernel:
    (B, t, N, 3D) -> (t, B*N, D) rows of q, k, v; ctx back to (B, t, N, D)."""
    b, t, n, d3 = qkv.shape
    d = d3 // 3

    def rows(a):
        return a.transpose(1, 0, 2, 3).reshape(t, b * n, d)

    ctx, k_out, v_out = A.fused_temporal_append_pm_ragged(
        rows(qkv[..., :d]), rows(qkv[..., d:2 * d]), rows(qkv[..., 2 * d:]), kc, vc,
        jnp.asarray(lens, jnp.int32), jnp.asarray(valid, jnp.int32), rows_per_stream,
        num_heads=h)
    return ctx.reshape(t, b, n, d).transpose(1, 0, 2, 3), k_out, v_out


@pytest.mark.parametrize("dtype,case", RUNS)
def test_packed_entry_matches_pallas(dtype, case):
    t, c, h, dh, lens, valid = CASES[case]
    d = h * dh
    per_stream = N if len(lens) == B else B * N
    qkv = _randn((B, t, N, 3 * d), 1)
    kc, vc = _randn((c, B * N, d), 2), _randn((c, B * N, d), 3)
    tdt = getattr(torch, dtype)
    ref, k_ref, v_ref = _jax_append(jnp.asarray(qkv, dtype), jnp.asarray(kc, dtype),
                                    jnp.asarray(vc, dtype), lens, valid, per_stream, h)
    k_got, v_got = (torch.from_numpy(x).to(tdt) for x in (kc, vc))
    lens_t, valid_t = (torch.tensor(x, dtype=torch.int32) for x in (lens, valid))
    got = ops.temporal_append_pm_qkv(torch.from_numpy(qkv).to(tdt), k_got, v_got, lens_t, valid_t,
                                     per_stream, h)
    assert got.dtype == tdt and got.is_contiguous() and got.shape == (B, t, N, d)
    assert lens_t.tolist() == lens and valid_t.tolist() == valid
    ref, k_ref, v_ref = (np.asarray(x, np.float32) for x in (ref, k_ref, v_ref))
    for s, (length, nv) in enumerate(zip(lens, valid)):
        rows = slice(s * per_stream, (s + 1) * per_stream)  # cache rows b * N + n
        bs = slice(rows.start // N, rows.stop // N)  # the stream's clips
        if nv:  # outputs past valid are unspecified
            np.testing.assert_allclose(got[bs, :nv].float().numpy(), ref[bs, :nv],
                                       atol=TOL[dtype], rtol=0)
        for mine, theirs in ((k_got, k_ref), (v_got, v_ref)):
            np.testing.assert_array_equal(mine[:length + nv, rows].float().numpy(),
                                          theirs[:length + nv, rows])


def test_packed_entry_equals_the_row_entry():
    """The packed entry is the (t, R, D) entry on the transposed slices, and
    appends the same rows."""
    t, c, h, dh = 5, 12, 2, 8
    d = h * dh
    qkv = torch.from_numpy(_randn((B, t, N, 3 * d), 4))
    caches = [torch.from_numpy(_randn((c, B * N, d), s)) for s in (5, 6)]
    lens, valid = torch.tensor([3, 7], dtype=torch.int32), torch.tensor([5, 2], dtype=torch.int32)
    k1, v1 = (x.clone() for x in caches)
    k2, v2 = (x.clone() for x in caches)
    q, k, v = (x.transpose(0, 1).reshape(t, B * N, d) for x in ops._thirds(qkv))
    rows = ops.temporal_append_pm_ragged(q, k, v, k1, v1, lens, valid, N, h)
    packed = ops.temporal_append_pm_qkv(qkv, k2, v2, lens, valid, N, h)
    assert torch.equal(packed, rows.reshape(t, B, N, d).transpose(0, 1))
    assert torch.equal(k1, k2) and torch.equal(v1, v2)


def test_aligned_strided_rows_are_taken_as_they_are():
    """(t, R, D) new frames whose rows are padded (strides 16-byte aligned,
    not contiguous) are read in place and give the contiguous copy's result."""
    t, c, h, dh = 3, 8, 2, 8
    d = h * dh
    new = [torch.from_numpy(_randn((t, B * N, d + 4), s))[..., :d] for s in (7, 8, 9)]
    assert not new[0].is_contiguous()
    caches = [torch.from_numpy(_randn((c, B * N, d), s)) for s in (10, 11)]
    lens, valid = torch.tensor([2, 4], dtype=torch.int32), torch.tensor([3, 3], dtype=torch.int32)
    k1, v1 = (x.clone() for x in caches)
    k2, v2 = (x.clone() for x in caches)
    a = ops.temporal_append_pm_ragged(*new, k1, v1, lens, valid, N, h)
    b = ops.temporal_append_pm_ragged(*(x.contiguous() for x in new), k2, v2, lens, valid, N, h)
    assert torch.equal(a, b) and torch.equal(k1, k2) and torch.equal(v1, v2)


def test_the_frame_cap_is_what_the_plan_takes():
    """At a capacity where the plan's scores bound the frames, a call of
    ``append_frame_cap`` frames fits the whole-table plan and one more does
    not (``_append_min_smem``): that call runs too (the tiled body on the
    card), and both equal the same frames appended one call a frame."""
    c, h, dh = 2000, 1, 128  # fp32 heads of 128: the widest plan
    t = ops.append_frame_cap(c)
    assert 0 < t < ops.APPEND_MAX_FRAMES
    assert ops._append_min_smem(t, c, dh, 4) <= ops._MAX_SMEM < ops._append_min_smem(t + 1, c,
                                                                                     dh, 4)
    qkv = torch.from_numpy(_randn((B, t + 1, N, 3 * h * dh), 12))
    lens = torch.tensor([5, 0], dtype=torch.int32)
    for frames in (t, t + 1):
        caches = [torch.zeros(c, B * N, h * dh) for _ in range(2)]
        caches[0][:5], caches[1][:5] = (torch.from_numpy(_randn((5, B * N, h * dh), s))
                                        for s in (13, 14))
        steps = [x.clone() for x in caches]
        valid = torch.full((B,), frames, dtype=torch.int32)
        got = ops.temporal_append_pm_qkv(qkv[:, :frames], *caches, lens, valid, N, h)
        one = torch.ones(B, dtype=torch.int32)
        want = torch.cat([ops.temporal_append_pm_qkv(qkv[:, i:i + 1], *steps, lens + i, one, N, h)
                          for i in range(frames)], dim=1)
        assert got.shape == (B, frames, N, h * dh)
        assert (got - want).abs().max().item() <= TOL["float32"], frames
        assert torch.equal(caches[0], steps[0]) and torch.equal(caches[1], steps[1])


def _offset(shape, elements, dtype=torch.float32):
    """A tensor of ``shape`` starting ``elements`` elements into a buffer."""
    n = int(np.prod(shape))
    return torch.zeros(n + elements, dtype=dtype)[elements:].view(shape)


def _caches(c=8, d=32, **kw):
    return torch.zeros(c, B * N, d, **kw), torch.zeros(c, B * N, d, **kw)


_LENS = torch.zeros(B, dtype=torch.int32)


@pytest.mark.parametrize(
    "call,error",
    [
        # the qkv layout: a row stride of 98 fp32 elements (392 bytes, not a
        # multiple of 16), of 100 bf16 elements (200 bytes), the data 4 or 8
        # bytes off, the D axis not contiguous
        (lambda: ops.temporal_append_pm_qkv(torch.zeros(B, 3, N, 98)[..., :96], *_caches(),
                                            _LENS, _LENS, N, 2), ValueError),
        (lambda: ops.temporal_append_pm_qkv(
            torch.zeros(B, 3, N, 100, dtype=torch.bfloat16)[..., :96],
            *_caches(dtype=torch.bfloat16), _LENS, _LENS, N, 2), ValueError),
        (lambda: ops.temporal_append_pm_qkv(_offset((B, 3, N, 96), 1), *_caches(), _LENS, _LENS,
                                            N, 2), ValueError),
        (lambda: ops.temporal_append_pm_qkv(_offset((B, 3, N, 96), 2), *_caches(), _LENS, _LENS,
                                            N, 2), ValueError),
        (lambda: ops.temporal_append_pm_qkv(torch.zeros(B, 3, 96, N).transpose(-1, -2),
                                            *_caches(), _LENS, _LENS, N, 2), ValueError),
        # the (t, R, D) entry: rows 392 bytes apart
        (lambda: ops.temporal_append_pm_ragged(*(torch.zeros(3, B * N, 34)[..., :32],) * 3,
                                               *_caches(), _LENS, _LENS, N, 2), ValueError),
        # shapes and frames: not (B, t, N, 3D); 33 new frames; caches of
        # another width, dtype or layout
        (lambda: ops.temporal_append_pm_qkv(torch.zeros(B * 3, N, 96), *_caches(), _LENS, _LENS,
                                            N, 2), ValueError),
        (lambda: _packed_vs_jax(33), None),  # 33 new frames: past E's whole table, matches JAX
        (lambda: ops.temporal_append_pm_qkv(torch.zeros(B, 3, N, 96), *_caches(d=16), _LENS,
                                            _LENS, N, 2), ValueError),
        (lambda: ops.temporal_append_pm_qkv(torch.zeros(B, 3, N, 96),
                                            *_caches(dtype=torch.bfloat16), _LENS, _LENS, N, 2),
         ValueError),
        (lambda: ops.temporal_append_pm_qkv(
            torch.zeros(B, 3, N, 96), *(x.transpose(0, 1).contiguous().transpose(0, 1)
                                        for x in _caches()), _LENS, _LENS, N, 2), ValueError),
        # lens and valid: int32, one per stream
        (lambda: ops.temporal_append_pm_qkv(torch.zeros(B, 3, N, 96), *_caches(), _LENS.long(),
                                            _LENS, N, 2), TypeError),
        (lambda: ops.temporal_append_pm_qkv(torch.zeros(B, 3, N, 96), *_caches(), _LENS,
                                            _LENS[:1], N, 2), TypeError),
        # a whole-table plan that does not fit: capacity 4000 at t = 32 (the
        # scores alone take 4 * 32 * 4033 bytes): the tiled body on the card,
        # matches JAX
        (lambda: _packed_vs_jax(32, capacity=4000), None),
    ],
)
def test_packed_entry_rejects_what_the_kernel_does_not_take(call, error):
    if error is None:  # a shape an earlier slice refused
        got, want = call()
        np.testing.assert_allclose(got.numpy(), want, atol=TOL["float32"], rtol=0)
        return
    with pytest.raises(error):
        call()


def _packed_vs_jax(t, capacity=0):
    """The packed entry on t new frames of two ragged streams at lens 3 and
    0 (capacity t + 3 by default, every frame valid), against the JAX package's einsum
    full clip over each stream's cached prefix and new frames, its last t
    outputs: what the append computes (the Pallas kernel in interpret mode
    takes half a minute at t = 33)."""
    h, d = 2, 16
    qkv = torch.from_numpy(_randn((B, t, N, 3 * d), 21))
    caches = [torch.from_numpy(_randn((capacity or t + 3, B * N, d), s)) for s in (22, 23)]
    prefix = [c.clone() for c in caches]
    lens = [3, 0]
    got = ops.temporal_append_pm_qkv(qkv, *caches, torch.tensor(lens, dtype=torch.int32),
                                     torch.tensor([t, t], dtype=torch.int32), N, h)
    want = []
    for b, length in enumerate(lens):
        rows = slice(b * N, (b + 1) * N)

        def seq(i, cache):  # the clip's (N, length + t, d) key sequence of slice i
            new = qkv[b, :, :, i * d:(i + 1) * d]  # (t, N, d)
            return jnp.asarray(torch.cat([cache[:length, rows], new]).transpose(0, 1).numpy())

        out = A.fullclip_temporal_reference(seq(0, prefix[0]), seq(1, prefix[0]),
                                            seq(2, prefix[1]), h)
        want.append(np.asarray(out)[:, length:].transpose(1, 0, 2))  # (t, N, d)
    return got, np.stack(want)
