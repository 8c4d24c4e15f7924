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


def _t(a):
    return torch.from_numpy(np.array(a))


# (rows, C, heads, dh, len): the first six at 24 rows, C=8, linear at len 0,
# mid and C-1, ring (len >= C) at C, C+5 and 2C+3, where the new plane wraps
# to slot len % C; then the card tests' decode shapes
# (tests/test_torch_cuda.py): 56 rows (mid and ring), 40 rows at C=5 with
# dh 128 and with one head of dh 8 (ring)
DECODE_SHAPES = [pytest.param(24, 8, 4, 24, n, id=str(n)) for n in (0, 3, 7, 8, 13, 19)] + [
    pytest.param(56, 8, 4, 24, 5, id="r56-c8-h4-dh24-len5"),
    pytest.param(56, 8, 4, 24, 19, id="r56-c8-h4-dh24-len19"),
    pytest.param(40, 5, 2, 128, 3, id="r40-c5-h2-dh128-len3"),
    pytest.param(40, 5, 1, 8, 9, id="r40-c5-h1-dh8-len9"),
]


@pytest.mark.parametrize("r,c,h,dh,length", DECODE_SHAPES)
def test_temporal_decode_pm_matches_pallas(r, c, h, dh, length):
    """The plain version of kernel A (which the card holds A to) against the
    Pallas kernel, output and both caches after the in-place write."""
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


# (rows, N, heads, dh): the card tests' small shapes (tests/test_torch_cuda.py),
# so that the plain version the card holds the kernel to is itself held to
# the Pallas kernel there; N of 9, 33, 49, 256 and 324 (a 288x288 frame, past
# the 256 keys of one staging), dh of 16, 24, 32, 40 and 64
SPATIAL_SHAPES = [(3, 9, 4, 24), (4, 33, 3, 40), (5, 49, 2, 16), (2, 256, 2, 64),
                  (1, 324, 2, 32)]


@pytest.mark.parametrize("r,n,h,dh", SPATIAL_SHAPES)
def test_spatial_flat_matches_pallas(r, n, h, dh):
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


def test_tiled_plan():
    """csrc/tiled.cuh's forward body by shape (``ops._tiled_plan``): items of
    at most 4 queries, or whose 16 queries' scores pass a block's shared
    memory beside the key stages, take the split body, whose scratch holds
    for each query of each (row, head) its scores (keys rounded up to 4) and
    one partial max a chunk of 256 keys; else the resident body, at the most
    of 64, 32 and 16 queries a block whose scores fit, 64 only past 32
    queries and 32 only past 16."""
    assert ops._tiled_plan(1, 60001, 64, 2) == (0, 60004 + 235)  # E at t=1 past A's plan
    assert ops._tiled_plan(4, 24, 64, 2) == (0, 24 + 1)
    assert ops._tiled_plan(5, 24, 64, 2) == (16, 0) and ops._tiled_plan(16, 1000, 64, 2) == (16, 0)
    assert ops._tiled_plan(16, 4112, 64, 2) == (0, 4112 + 17)  # past shared memory
    assert ops._tiled_plan(300, 300, 64, 2) == (64, 0)  # C at T=300
    assert ops._tiled_plan(576, 576, 64, 4) == (64, 0)  # fp32 B at N=576
    assert ops._tiled_plan(32, 288, 64, 2) == (32, 0) and ops._tiled_plan(17, 17, 8, 4) == (32, 0)
    assert ops._tiled_plan(1000, 1000, 64, 2) == (32, 0)  # 64 queries' scores do not fit
    assert ops._tiled_plan(1600, 1600, 64, 2) == (32, 0)
    # 32 queries' scores do not fit, 16 do: C at T=1700, fp32 or bf16
    assert ops._tiled_plan(1700, 1700, 64, 4) == (16, 0)
    assert ops._tiled_plan(1700, 1700, 64, 2) == (16, 0)
    assert ops._tiled_plan(40, 3000, 64, 2) == (16, 0)  # E at 40 frames on 2960 slots
    assert ops._tiled_plan(3400, 3400, 64, 2) == (0, 3400 + 14)  # not even 16 queries'
    assert ops._tiled_plan(3100, 3100, 64, 4) == (0, 3100 + 13)
    for t, keys, dh, elt in ((300, 300, 64, 2), (576, 576, 64, 4), (1000, 1000, 64, 2),
                             (1600, 1600, 64, 2), (40, 104, 128, 4), (16, 1000, 64, 2),
                             (1700, 1700, 64, 4), (3000, 3000, 64, 4), (3000, 3100, 64, 2)):
        qt, scratch = ops._tiled_plan(t, keys, dh, elt)
        assert scratch == 0 and ops._tiled_resident_smem(qt, keys, dh, elt) <= ops._MAX_SMEM
    assert ops._tiled_resident_smem(64, 1000, 64, 2) > ops._MAX_SMEM
    assert ops._tiled_resident_smem(32, 1700, 64, 2) > ops._MAX_SMEM
    assert ops._tiled_resident_smem(16, 3400, 64, 2) > ops._MAX_SMEM
    # the resident block: two stages of 64 key rows (64 bf16 + 16 bytes), 64
    # fp32 query rows of 68, 64 rows of 301 fp32 scores, four barriers
    assert ops._tiled_resident_smem(64, 300, 64, 2) == 2 * 64 * 144 + 64 * 68 * 4 + 77056 + 32


def test_tiled_bwd_plan(monkeypatch):
    """The launch of csrc/tiled.cuh's backward by plan
    (``ops._tiled_bwd_launch``; the plan itself comes from the C plan on the
    card): ``tiled`` = 1 + the plan, and a scratch only for the stored p and
    ds, 2 x T x (T rounded up to 4) fp32 an item, for every item at once
    while that fits ``_TILED_SCRATCH``, else for as many as fit, at least
    one."""
    for plan in (0, ops._BWD_SWEEPS):
        monkeypatch.setattr(ops, "_tiled_bwd_plan", lambda *a, p=plan: p)
        assert ops._tiled_bwd_launch(24, 196, 64, 2, "cpu") == (1 + plan, None)
    for plan in (ops._BWD_STORED, ops._BWD_STORED | ops._BWD_SWEEPS):
        monkeypatch.setattr(ops, "_tiled_bwd_plan", lambda *a, p=plan: p)
        monkeypatch.setattr(ops, "_TILED_SCRATCH", 1 << 30)
        tiled, scratch = ops._tiled_bwd_launch(24, 299, 64, 2, "cpu")
        assert tiled == 1 + plan and scratch.numel() == 24 * 2 * 299 * 300
        monkeypatch.setattr(ops, "_TILED_SCRATCH", 4 * 7 * 2 * 299 * 300 + 4)
        assert ops._tiled_bwd_launch(24, 299, 64, 2, "cpu")[1].numel() == 7 * 2 * 299 * 300
        monkeypatch.setattr(ops, "_TILED_SCRATCH", 4)
        assert ops._tiled_bwd_launch(24, 299, 64, 2, "cpu")[1].numel() == 2 * 299 * 300
    assert ops._tiled_stored_floats(1) == 2 * 4 and ops._tiled_stored_floats(1700) == 2 * 1700 ** 2


def test_tiled_scratch(monkeypatch):
    """The split body's scratch (``ops._tiled_scratch``) holds every item's
    queries while they fit 1 GiB (E at 16 frames on 4096 slots, R=196 x 12
    heads: 0.62 GB), else as many whole items as fit (C at T=3400 on the
    flagship clip: 23 of its 2352 items a launch, where all of them would
    take 109 GB), else 16 queries at a time, or more in multiples of 16; a
    smaller budget cuts the same way."""
    budget = (1 << 30) // 4
    per_q = 4112 + 17
    assert ops._tiled_scratch(196 * 12, 16, per_q) == 196 * 12 * 16 * per_q
    per_q = ops._tiled_plan(3400, 3400, 64, 2)[1]
    assert ops._tiled_scratch(196 * 12, 3400, per_q) == 23 * 3400 * per_q <= budget
    assert 24 * 3400 * per_q > budget
    per_q = ops._tiled_plan(20000, 20000, 64, 2)[1]
    assert ops._tiled_scratch(1, 20000, per_q) == 13360 * per_q <= budget
    assert ops._tiled_scratch(4, 2, 10) == 80  # a few items: all of them
    monkeypatch.setattr(ops, "_TILED_SCRATCH", 4 * 1000)
    assert ops._tiled_scratch(20, 4, 20) == 12 * 80  # whole items: 12 of 80 values
    assert ops._tiled_scratch(3, 100, 20) == 48 * 20  # 48 of an item's 100 queries
    assert ops._tiled_scratch(3, 100, 70) == 16 * 70  # at least 16 queries, past the budget
    assert ops._tiled_scratch(3, 10, 700) == 10 * 700  # or all of an item's, fewer than 16


def test_append_frame_cap():
    """Kernel E's whole-table body takes up to 32 new frames (C's kMaxT) on
    any capacity whose plan fits a block's shared memory: 32 at the
    capacities the engine and the tower run (16, 64, 256), fewer where only
    the plan's scores bound it, none where not even one frame's fits. The
    answer holds at every width (the plan of heads of 128 in fp32). Past it
    a call runs the tiled body: at capacity 60000, where the whole table
    takes no frame, a call of one frame runs and matches the Pallas kernel
    (the plain version here; the card tests hold the tiled body to it)."""
    assert ops.append_frame_cap(16) == 32
    assert ops.append_frame_cap(31) == 32 and ops.append_frame_cap(32) == 32
    assert ops.append_frame_cap(64) == 32 and ops.append_frame_cap(256) == 32
    assert 0 < ops.append_frame_cap(2000) < 32
    assert ops.append_frame_cap(60000) == 0
    for c in (16, 64, 2000):  # the answer is the most frames whose smallest plan fits
        t = ops.append_frame_cap(c)
        assert ops._append_min_smem(t, c, 128, 4) <= ops._MAX_SMEM
        assert t == 32 or ops._append_min_smem(t + 1, c, 128, 4) > ops._MAX_SMEM
    c, r, d = 60000, 8, 16
    q, kn, vn = (_randn((1, r, d), s) for s in (51, 52, 53))
    kc = np.zeros((c, r, d), np.float32)
    kc[:5] = _randn((5, r, d), 54)
    vc = np.zeros((c, r, d), np.float32)
    vc[:5] = _randn((5, r, d), 55)
    lens, valid = np.asarray([5], np.int32), np.asarray([1], np.int32)
    ref, k_ref, v_ref = A.fused_temporal_append_pm_ragged(
        *(jnp.asarray(a) for a in (q, kn, vn, kc[:8], vc[:8], lens, valid)), 8, num_heads=2)
    k_got, v_got = _t(kc), _t(vc)
    got = ops.temporal_append_pm_ragged(_t(q), _t(kn), _t(vn), k_got, v_got, _t(lens),
                                        _t(valid), r, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(k_got[:8].numpy(), np.asarray(k_ref))
    np.testing.assert_array_equal(v_got[:8].numpy(), np.asarray(v_ref))


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
        # past the caps of the first slices these run, and match the JAX package
        (lambda x: _vs_jax(ops.temporal_fullclip, A.fullclip_temporal_reference,
                           x.repeat(1, 7, 1), 2), None),  # T = 35 > 32
        (lambda x: _vs_jax(ops.spatial_flat, A.fused_spatial_flat, x.repeat(1, 52, 1), 2),
         None),  # N = 260 > 256
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
        (lambda x: _append_vs_jax(x, 33), None),  # 33 new frames, past the 32 E's whole table takes
        (lambda x: ops.temporal_append_pm_ragged(
            x[:0], x[:0], x[:0], x.repeat(16, 1, 1), x.repeat(16, 1, 1),
            torch.zeros(5, dtype=torch.int32), torch.zeros(5, dtype=torch.int32), 1, 2),
         NotImplementedError),  # no new frame
    ],
)
def test_wrappers_reject_what_the_kernels_do_not_take(call, error):
    x = torch.randn(2, 5, 32)
    if error is None:  # a shape an earlier slice refused
        got, want = call(x)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
        return
    with pytest.raises(error):
        call(x)


def _append_vs_jax(x, t):
    """E's (t, R, D) entry on t new frames of two streams of 8 rows at lens
    3 and 0, every frame valid, on a cache of t + 3 slots, against the JAX
    package's einsum full clip over each stream's cached prefix and new
    frames (its last t outputs: what the causal append computes; the Pallas
    kernel in interpret mode takes half a minute at t = 33)."""
    q = x.reshape(-1, 32).repeat(-(-t * 16 // 10), 1)[:t * 16].reshape(t, 16, 32)
    k, v = q.roll(1, 0), q.flip(0)
    lens = [3, 0]
    caches = [torch.from_numpy(_randn((t + 3, 16, 32), s)) for s in (41, 42)]
    prefix = [c.clone() for c in caches]
    got = ops.temporal_append_pm_ragged(q, k, v, *caches, torch.tensor(lens, dtype=torch.int32),
                                        torch.tensor([t, t], dtype=torch.int32), 8, 2)
    want = []
    for s_, length in enumerate(lens):
        rows = slice(8 * s_, 8 * s_ + 8)

        def seq(new, cache):  # the stream's (8, length + t, 32) key sequence
            return jnp.asarray(torch.cat([cache[:length, rows], new[:, rows]]).transpose(0, 1)
                               .numpy())

        out = A.fullclip_temporal_reference(seq(q, prefix[0]), seq(k, prefix[0]),
                                            seq(v, prefix[1]), 2)
        want.append(np.asarray(out)[:, length:].transpose(1, 0, 2))
    return got, np.concatenate(want, axis=1)


def _vs_jax(port, jax_fn, x, num_heads):
    """The port's and the JAX package's attention on the same operands."""
    q, k, v = x, x.roll(1, 1), x.flip(1)
    return port(q, k, v, num_heads), jax_fn(*(jnp.asarray(a.numpy()) for a in (q, k, v)),
                                            num_heads)


# ---------------------------------------------------------------------------
# The backward kernels H and I: their plain versions against the JAX
# package's Pallas backward kernels in interpret mode, against jax.vjp of the
# einsum references, and against autograd through the port's plain forwards.
# fp32: 1e-4 max-abs against the Pallas kernels and the vjp (their own test's
# bound, tests/test_pallas_attention.py), 1e-5 against autograd through the
# plain forward (one function, two orders of summation). bf16: 2e-2.
# ---------------------------------------------------------------------------

_BWD = {
    "spatial": (A._spatial_flat_bwd_pallas, A.spatial_flat_reference, ops.spatial_flat_plain,
                ops.spatial_flat_bwd_plain, ops.spatial_flat, (4, 60, 4, 16)),
    "temporal": (A._fullclip_temporal_bwd_pallas, A.fullclip_temporal_reference,
                 ops.temporal_fullclip_plain, ops.temporal_fullclip_bwd_plain,
                 ops.temporal_fullclip, (56, 8, 4, 16)),
}
# the spatial backward also at the card tests' small shapes
_BWD.update({f"spatial-n{n}-dh{dh}": _BWD["spatial"][:-1] + ((r, n, h, dh),)
             for r, n, h, dh in SPATIAL_SHAPES})
_PALLAS_KINDS = ["spatial", "temporal"] + [k for k in _BWD if k.startswith("spatial-")]


def _bwd_inputs(kind, seed=40):
    rows, length, h, dh = _BWD[kind][-1]
    return [_randn((rows, length, h * dh), seed + i) for i in range(4)], h


@pytest.mark.parametrize("kind", _PALLAS_KINDS)
def test_bwd_plain_matches_pallas_backward_fp32(kind):
    pallas, _, _, plain, _, _ = _BWD[kind]
    (q, k, v, g), h = _bwd_inputs(kind)
    ref = pallas(*(jnp.asarray(a) for a in (q, k, v, g)), h, interpret=True)
    got = plain(_t(q), _t(k), _t(v), _t(g), h)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=0, err_msg=name)


@pytest.mark.parametrize("kind", _PALLAS_KINDS)
def test_bwd_plain_matches_pallas_backward_bf16(kind):
    pallas, _, _, plain, _, _ = _BWD[kind]
    (q, k, v, g), h = _bwd_inputs(kind)
    ref = pallas(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, g)), h, interpret=True)
    got = plain(*(_t(a).bfloat16() for a in (q, k, v, g)), h)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32), atol=2e-2,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("kind", ["spatial", "temporal"])
def test_bwd_plain_matches_jax_vjp_of_the_reference(kind):
    _, reference, _, plain, _, _ = _BWD[kind]
    (q, k, v, g), h = _bwd_inputs(kind, seed=50)
    _, vjp = jax.vjp(lambda a, b, c: reference(a, b, c, h), *(jnp.asarray(a) for a in (q, k, v)))
    got = plain(_t(q), _t(k), _t(v), _t(g), h)
    for name, a, b in zip(("dq", "dk", "dv"), got, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=0, err_msg=name)


@pytest.mark.parametrize("kind", ["spatial", "temporal"])
@pytest.mark.parametrize("through", ["plain_bwd", "function"])
def test_bwd_matches_autograd_through_the_plain_forward(kind, through):
    """``through="function"``: the gradient taken through the wrapper's
    ``autograd.Function`` (on the CPU: plain forward, plain backward), with a
    transposed, non-contiguous output gradient."""
    _, _, forward, plain, wrapper, _ = _BWD[kind]
    (q, k, v, g), h = _bwd_inputs(kind, seed=60)
    qt, kt, vt = (_t(a).requires_grad_() for a in (q, k, v))
    ref = torch.autograd.grad(forward(qt, kt, vt, h), (qt, kt, vt), _t(g))
    if through == "plain_bwd":
        got = plain(qt.detach(), kt.detach(), vt.detach(), _t(g), h)
    else:
        out = wrapper(qt, kt, vt, h)
        assert type(out.grad_fn).__name__ in ("SpatialFlatBackward", "TemporalFullclipBackward")
        g_view = _t(g).transpose(0, 1).contiguous().transpose(0, 1)
        assert not g_view.is_contiguous()
        got = torch.autograd.grad(out, (qt, kt, vt), g_view)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0, err_msg=name)


@pytest.mark.parametrize("kind", ["spatial", "temporal"])
def test_functions_pass_a_finite_difference_check(kind):
    """Central differences of sum(out * w) in fp32 (eps 1e-2, so the check's
    own truncation and rounding stay near 1e-3) against the Functions'
    gradients, along a random direction per input."""
    wrapper = _BWD[kind][4]
    rng = np.random.default_rng(70)
    shape, h = (3, 5, 16), 2
    q, k, v, w = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                  for _ in range(4))
    inputs = [a.clone().requires_grad_() for a in (q, k, v)]
    grads = torch.autograd.grad((wrapper(*inputs, h) * w).sum(), inputs)
    eps = 1e-2
    for i, grad in enumerate(grads):
        direction = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        plus, minus = [q, k, v], [q, k, v]
        plus[i] = plus[i] + eps * direction
        minus[i] = minus[i] - eps * direction
        with torch.no_grad():
            numeric = ((wrapper(*plus, h) * w).sum() - (wrapper(*minus, h) * w).sum()) / (2 * eps)
        np.testing.assert_allclose((grad * direction).sum().item(), numeric.item(), atol=5e-3,
                                   rtol=5e-3)


def test_wrappers_without_grad_build_no_graph():
    (q, k, v, _), h = _bwd_inputs("spatial")
    out = ops.spatial_flat(_t(q), _t(k), _t(v), h)
    assert out.grad_fn is None and not out.requires_grad
    (q, k, v, _), h = _bwd_inputs("temporal")
    with torch.no_grad():
        out = ops.temporal_fullclip(_t(q).requires_grad_(), _t(k), _t(v), h)
    assert out.grad_fn is None


@pytest.mark.parametrize(
    "call,error",
    [
        (lambda: ops.spatial_flat_bwd(torch.zeros(2, 9, 32), torch.zeros(2, 9, 32),
                                      torch.zeros(2, 9, 32), torch.zeros(2, 8, 32), 4), ValueError),
        # past the first slices' 32 frames this runs, and matches jax.vjp
        (lambda: _bwd_vs_jax_vjp(35), None),  # T = 35
        (lambda: ops.spatial_flat_bwd(torch.zeros(2, 9, 32), torch.zeros(2, 9, 32),
                                      torch.zeros(2, 9, 32),
                                      torch.zeros(2, 9, 32, dtype=torch.bfloat16), 4), TypeError),
        (lambda: ops.temporal_fullclip_bwd(torch.zeros(2, 4, 32), torch.zeros(2, 4, 32),
                                           torch.zeros(2, 4, 32),
                                           torch.zeros(4, 2, 32).transpose(0, 1), 4), ValueError),
    ],
)
def test_backward_wrappers_check_their_inputs(call, error):
    if error is None:  # a shape an earlier slice refused
        got, want = call()
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=0, err_msg=name)
        return
    with pytest.raises(error):
        call()


def _bwd_vs_jax_vjp(t, h=4, dh=8):
    """The port's temporal backward and jax.vjp of the JAX einsum reference
    on (2, t, h * dh) operands."""
    q, k, v, g = (_randn((2, t, h * dh), 60 + i) for i in range(4))
    _, vjp = jax.vjp(lambda a, b, c: A.fullclip_temporal_reference(a, b, c, h),
                     *(jnp.asarray(a) for a in (q, k, v)))
    return ops.temporal_fullclip_bwd(_t(q), _t(k), _t(v), _t(g), h), vjp(jnp.asarray(g))
