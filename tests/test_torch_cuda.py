"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Skips without a CUDA device. On a machine with one:
``python -m pytest --noconftest tests/test_torch_cuda.py -q`` (the repo's
conftest imports JAX, which the port's GPU machine need not have).

Tolerances: fp32 2e-5 max-abs (the two differ only in summation order);
bf16 2e-2 max-abs, about two bf16 ulps at the outputs' magnitude (both
round the same fp32 result to bf16, and the kernel sums in another order).
"""

import os

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
@pytest.mark.parametrize("rows,n,heads,dh", [(128, 196, 12, 64), (16, 33, 3, 40),
                                             (16, 324, 2, 64)])
def test_spatial_flat_is_batch_invariant(dtype, rows, n, heads, dh, monkeypatch):
    """A query's output bits depend on its (row, head) operands only: B on
    all rows equals B on each 8-row slice, and B under every query-chunk
    count the wrapper can pick (the streaming-vs-full-clip and engine gates
    compare B at one R against B at another)."""
    d = heads * dh
    q, k, v = (_randn((rows, n, d), dtype, s) for s in (81, 82, 83))
    full = ops.spatial_flat(q, k, v, heads)
    for i in range(0, rows, 8):
        part = ops.spatial_flat(q[i:i + 8], k[i:i + 8], v[i:i + 8], heads)
        assert torch.equal(part, full[i:i + 8]), i
    for chunks in range(1, -(-n // 16) + 1):
        monkeypatch.setattr(ops, "_spatial_chunks", lambda *a, c=chunks: -(-n // c))
        assert torch.equal(ops.spatial_flat(q, k, v, heads), full), chunks


def _nan_tail(shape, dtype, seed):
    """A tensor of ``shape`` that is the leading rows of a buffer whose next
    row is NaN, and a clean copy of it."""
    buf = _randn((shape[0] + 1, *shape[1:]), dtype, seed)
    buf[shape[0]] = float("nan")
    view = buf[:shape[0]]
    assert view.is_contiguous()
    return view, view.clone()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,n,heads,dh", [(3, 9, 4, 24), (4, 33, 3, 40), (8, 196, 12, 64)])
def test_spatial_kernels_read_nothing_past_their_rows(dtype, rows, n, heads, dh):
    """B, I and L on operands that are the leading rows of buffers whose next
    row is NaN: the outputs are finite and equal to the run on clean copies."""
    d = heads * dh
    (q, qc), (k, kc), (v, vc), (g, gc) = (_nan_tail((rows, n, d), dtype, s)
                                          for s in (91, 92, 93, 94))
    out = ops.spatial_flat(q, k, v, heads)
    assert torch.isfinite(out).all()
    assert torch.equal(out, ops.spatial_flat(qc, kc, vc, heads))
    grads = ops.spatial_flat_bwd(q, k, v, g, heads)
    assert all(torch.isfinite(x).all() for x in grads)
    clean = ops.spatial_flat_bwd(qc, kc, vc, gc, heads)
    assert all(torch.equal(a, b) for a, b in zip(grads, clean))
    (q, qc), (k, kc), (v, vc) = (_nan_tail((rows, heads, n, dh), dtype, s) for s in (95, 96, 97))
    out = ops.spatial_attention(q, k, v)
    assert torch.isfinite(out).all()
    assert torch.equal(out, ops.spatial_attention(qc, kc, vc))


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
@pytest.mark.parametrize("rows,t,heads,dh", [(1568, 16, 12, 64), (10, 32, 2, 128), (6, 5, 3, 8),
                                             (56, 48, 4, 64)])
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


# ---------------------------------------------------------------------------
# Past the first slices' shapes: B, L and I past 256 patches (and fp32 heads
# of 128 past a block's shared memory), C and H past 32 frames and without
# the causal mask
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,dh", [(257, 64), (324, 64), (576, 64), (1568, 64), (257, 128),
                                  (324, 128), (576, 128), (1568, 128), (196, 128)])
def test_spatial_kernels_at_any_n_match_plain(dtype, n, dh):
    """B, L and I against their plain versions; L equals B bit for bit, and
    I repeats bit for bit (no atomics), with keys staged or tiled."""
    rows, heads = 2, 2
    d = heads * dh
    q, k, v, g = (_randn((rows, n, d), dtype, s) for s in (41, 42, 43, 44))
    before = dict(ops.LAUNCHES)
    out = ops.spatial_flat(q, k, v, heads)
    split = [x.view(rows, n, heads, dh).transpose(1, 2).contiguous() for x in (q, k, v)]
    out_l = ops.spatial_attention(*split)
    grads = ops.spatial_flat_bwd(q, k, v, g, heads)
    again = ops.spatial_flat_bwd(q, k, v, g, heads)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["spatial_flat"] == before["spatial_flat"] + 1
    assert ops.LAUNCHES["spatial_attention"] == before["spatial_attention"] + 1
    assert ops.LAUNCHES["spatial_flat_bwd"] == before["spatial_flat_bwd"] + 2
    ref = ops.spatial_flat_plain(q, k, v, heads)
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]
    assert torch.equal(out_l.transpose(1, 2).reshape(rows, n, d), out)
    _grad_close(grads, ops.spatial_flat_bwd_plain(q, k, v, g, heads), dtype)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("t", [33, 48, 64, 128, 300])
def test_fullclip_kernels_at_any_t_match_plain(dtype, causal, t, monkeypatch):
    """C and H against their plain versions, causal or not; H repeats bit for
    bit; and the tiled body (csrc/tiled.cuh, which runs past the whole-row
    plan) equals the whole-row pipeline bit for bit where both run."""
    rows, heads, dh = 6, 2, 64
    d = heads * dh
    q, k, v, g = (_randn((rows, t, d), dtype, s) for s in (51, 52, 53, 54))
    before = dict(ops.LAUNCHES)
    out = ops.temporal_fullclip(q, k, v, heads, causal)
    grads = ops.temporal_fullclip_bwd(q, k, v, g, heads, causal)
    again = ops.temporal_fullclip_bwd(q, k, v, g, heads, causal)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["temporal_fullclip"] == before["temporal_fullclip"] + 1
    assert ops.LAUNCHES["temporal_fullclip_bwd"] == before["temporal_fullclip_bwd"] + 2
    ref = ops.temporal_fullclip_plain(q, k, v, heads, causal)
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]
    _grad_close(grads, ops.temporal_fullclip_bwd_plain(q, k, v, g, heads, causal), dtype)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    monkeypatch.setattr(ops, "_body_smem", lambda *a: 0)  # the tiled body at every T
    assert torch.equal(ops.temporal_fullclip(q, k, v, heads, causal), out)
    tiled = ops.temporal_fullclip_bwd(q, k, v, g, heads, causal)
    assert all(torch.equal(a, b) for a, b in zip(tiled, grads))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("t", [3, 12, 20, 64, 96])
@pytest.mark.parametrize("body", ["plan", "split"])
def test_tiled_fullclip_at_the_flagship_heads_equals_the_whole_row(dtype, causal, t, body,
                                                                   monkeypatch):
    """C's tiled forward at the flagship's heads (12 of 64), forced where the
    whole-row pipeline also runs, gives its bits. By its plan: the split
    body (T = 3), the resident body at 16 queries a block (T = 12), at 32
    (T = 20) and at 64 (T = 64, 96: one and two tiles). With ``_TILED_FEW``
    raised, the split body at every T: its scores 16 queries at once, two
    queries' PV chains a warp, one to six query groups."""
    rows, heads, dh = 3, 12, 64
    q, k, v = (_randn((rows, t, heads * dh), dtype, s) for s in (55, 56, 57))
    if not ops._body_smem("temporal_fullclip", "sf_temporal_fullclip", t, heads * dh, heads,
                          ops._DTYPE_CODES[dtype], int(causal)):
        pytest.fail("the whole-row pipeline does not take this T")
    whole = ops.temporal_fullclip(q, k, v, heads, causal)
    monkeypatch.setattr(ops, "_body_smem", lambda *a: 0)
    want = {3: 0, 12: 16, 20: 32}.get(t, 64)
    if body == "split":
        monkeypatch.setattr(ops, "_TILED_FEW", 128)
        want = 0
    assert ops._tiled_plan(t, t, dh, q.element_size())[0] == want
    tiled = ops.temporal_fullclip(q, k, v, heads, causal)
    assert torch.equal(tiled, whole)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_tiled_split_past_shared_memory_matches_plain_and_repeats(dtype, causal, monkeypatch):
    """Past shared memory (a tile of 16 queries' scores against T = 3400
    keys, or a cache of 20000 slots under 20 new frames) tiled.cuh splits the
    keys over blocks with more than 16 queries an item; no whole-row body
    takes those shapes, so they are held to the plain versions and to a
    second run of themselves (the same bits), also where a smaller scratch
    makes the body launch over chunks of items and of one item's queries; a
    scratch that holds less than one query's scores is refused."""
    rows, heads, dh, t = 2, 2, 64, 3400
    assert ops._tiled_plan(t, t, dh, torch.finfo(dtype).bits // 8)[0] == 0
    q, k, v = (_randn((rows, t, heads * dh), dtype, s) for s in (58, 59, 60))
    out = ops.temporal_fullclip(q, k, v, heads, causal)
    again = ops.temporal_fullclip(q, k, v, heads, causal)
    torch.cuda.synchronize()
    ref = ops.temporal_fullclip_plain(q, k, v, heads, causal)
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]
    assert torch.equal(out, again)
    per_item = t * ops._tiled_plan(t, t, dh, torch.finfo(dtype).bits // 8)[1]
    for budget in (4 * 2 * per_item, 4 * per_item // 3):  # two items a launch; 1120 queries
        monkeypatch.setattr(ops, "_TILED_SCRATCH", budget)
        assert torch.equal(ops.temporal_fullclip(q, k, v, heads, causal), out)
    monkeypatch.setattr(ops, "_tiled_scratch", lambda items, t, per_query: per_query - 1)
    with pytest.raises(RuntimeError, match="launch failed"):  # less than one query's scores
        ops.temporal_fullclip(q, k, v, heads, causal)
    monkeypatch.undo()
    kw = dict(t=20, per_stream=4, lens=[19000, 7], valid=[20, 20], cap=20000, heads=2, dh=64,
              seed=242, causal=causal)
    assert ops._tiled_plan(20, 20020, 64, torch.finfo(dtype).bits // 8)[0] == 0
    first = _append_call(dtype, dtype, **kw)
    second = _append_call(dtype, dtype, **kw)
    assert torch.equal(first[0], second[0])
    monkeypatch.setattr(ops, "_TILED_SCRATCH", 4 * 16 * (20020 + 79))  # 16 queries a launch
    chunked = _append_call(dtype, dtype, **kw)
    assert torch.equal(first[0], chunked[0])
    for a, b in zip(first[1], chunked[1]):
        assert torch.equal(a, b)


BWD_PLANS = {"resident": 0, "stored": ops._BWD_STORED, "sweeps": ops._BWD_SWEEPS,
             "sweeps_stored": ops._BWD_SWEEPS | ops._BWD_STORED}


def _force_bwd_plan(monkeypatch, plan, t, chunk_items):
    """csrc/tiled.cuh's backward forced onto ``plan`` (``ops._tiled_bwd_plan``
    patched) with ``_TILED_SCRATCH`` shrunk so that a stored key side
    launches over chunks of ``chunk_items`` items."""
    monkeypatch.setattr(ops, "_tiled_bwd_plan", lambda *a: plan)
    monkeypatch.setattr(ops, "_TILED_SCRATCH", 4 * chunk_items * ops._tiled_stored_floats(t))


@pytest.mark.parametrize("plan", list(BWD_PLANS))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("t", [20, 64, 75])  # the whole-row H takes T <= 79 at fp32 heads of 64
def test_tiled_backward_plans_equal_the_whole_row(t, causal, dtype, plan, monkeypatch):
    """H's tiled backward at the flagship's heads (12 of 64), forced where the
    whole-row pipeline also runs, gives its bits on every plan of its query
    and key sides (``ops._tiled_bwd_plan`` patched), a stored key side
    launched over chunks of five items (``_TILED_SCRATCH`` shrunk)."""
    rows, heads, dh = 3, 12, 64
    q, k, v, g = (_randn((rows, t, heads * dh), dtype, s) for s in (71, 72, 73, 74))
    assert ops._body_smem("temporal_fullclip_bwd", "sf_temporal_fullclip_bwd", t, heads * dh,
                          heads, ops._DTYPE_CODES[dtype], int(causal))
    whole = ops.temporal_fullclip_bwd(q, k, v, g, heads, causal)
    monkeypatch.setattr(ops, "_body_smem", lambda *a: 0)
    _force_bwd_plan(monkeypatch, BWD_PLANS[plan], t, 5)
    tiled = ops.temporal_fullclip_bwd(q, k, v, g, heads, causal)
    assert all(torch.equal(a, b) for a, b in zip(tiled, whole))


@pytest.mark.parametrize("n", [196, 300])
def test_tiled_spatial_backward_plans_agree(n, monkeypatch):
    """fp32 I on csrc/tiled.cuh (forced at N = 196, where the whole-head body
    also runs; its own at N = 300) at the flagship's heads: every plan of
    its backward gives one set of bits, within tolerance of the plain
    version."""
    rows, heads, dh = 4, 12, 64
    q, k, v, g = (_randn((rows, n, heads * dh), torch.float32, s) for s in (75, 76, 77, 78))
    monkeypatch.setattr(ops, "_body_smem", lambda *a: 0)
    got = []
    for plan in BWD_PLANS.values():
        _force_bwd_plan(monkeypatch, plan, n, 7)
        got.append(ops.spatial_flat_bwd(q, k, v, g, heads))
    _grad_close(got[0], ops.spatial_flat_bwd_plain(q, k, v, g, heads), torch.float32)
    for other in got[1:]:
        assert all(torch.equal(a, b) for a, b in zip(other, got[0]))


@pytest.mark.parametrize("case", ["H T=1700 bf16", "I N=1568 fp32"])
def test_tiled_backward_past_shared_memory_matches_plain_and_repeats(case, monkeypatch):
    """Past the query side's shared memory (32 queries' scores and dp against
    1700 or 1568 keys) the query side sweeps: H causal at T = 1700 in bf16
    and fp32 I at N = 1568, at the flagship's heads, on its own plan (the
    stored key side) against their plain versions; a second run gives the
    same bits, and so does the recomputing key side."""
    heads, dh = 12, 64
    if case.startswith("H"):
        dtype, t = torch.bfloat16, 1700
        q, k, v, g = (_randn((2, t, heads * dh), dtype, s) for s in (81, 82, 83, 84))
        fn, plain = ops.temporal_fullclip_bwd, ops.temporal_fullclip_bwd_plain
    else:
        dtype, t = torch.float32, 1568
        q, k, v, g = (_randn((2, t, heads * dh), dtype, s) for s in (85, 86, 87, 88))
        fn, plain = ops.spatial_flat_bwd, ops.spatial_flat_bwd_plain
    assert ops._tiled_bwd_plan(t, dh, q.element_size()) == BWD_PLANS["sweeps_stored"]
    grads = fn(q, k, v, g, heads)
    again = fn(q, k, v, g, heads)
    monkeypatch.setattr(ops, "_tiled_bwd_plan", lambda *a: BWD_PLANS["sweeps"])
    theirs = fn(q, k, v, g, heads)
    torch.cuda.synchronize()
    _grad_close(grads, plain(q, k, v, g, heads), dtype)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    assert all(torch.equal(a, b) for a, b in zip(grads, theirs))


def test_tiled_plans_match_the_c_plans():
    """The wrapper's copy of csrc/tiled.cuh's resident forward plan
    (``ops._tiled_resident_smem``, which the CPU tests hold) equals the C
    one (``sf_tiled_plan``) over a grid of shapes: a drift would make a
    launch raise. The backward's plan comes from the C one: the query side's
    32 queries' scores and dp stay in shared memory up to 701 keys at fp32
    heads of 64, 797 in bf16 (fp32 I forced at N = 196, H at T = 300 and
    fp32 I at N = 576 among them), and sweep past them; the key side reads
    the stored p and ds while an item's fit ``_TILED_SCRATCH`` (T up to
    11,584)."""
    for dh in (8, 24, 40, 64, 128):
        for elt in (2, 4):
            for keys in (1, 17, 64, 300, 576, 1568, 3400, 60001):
                for qt in (16, 32, 64):
                    assert ops._tiled_c_plan(0, qt, keys, dh, elt) == ops._tiled_resident_smem(
                        qt, keys, dh, elt), (qt, keys, dh, elt)
    for t, elt in ((196, 4), (300, 2), (576, 4), (701, 4), (797, 2)):
        assert ops._tiled_bwd_plan(t, 64, elt) == ops._BWD_STORED, (t, elt)
    for t, elt in ((702, 4), (798, 2), (1568, 4), (1700, 2), (11584, 2)):
        assert ops._tiled_bwd_plan(t, 64, elt) == ops._BWD_SWEEPS | ops._BWD_STORED, (t, elt)
    assert ops._tiled_bwd_plan(11588, 64, 2) == ops._BWD_SWEEPS


@pytest.mark.parametrize("case", ["T=1700 batch 3", "T=3400"])
def test_long_clips_run_within_a_bounded_scratch(case):
    """C on long clips at the flagship's heads, bf16: the packed qkv of
    three 1700-frame clips runs the resident body at 16 queries a block
    (no scratch); 16 rows of 3400 frames run the split body, whose scratch
    stays within ``ops._TILED_SCRATCH`` (all of it at once would take 8.9
    GB). Both are held to the plain version on a few of their rows."""
    heads, dh, dtype = 12, 64, torch.bfloat16
    gen = torch.Generator("cuda").manual_seed(61)  # drawn on the card: 2.3e9 values for the qkv
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    if case == "T=3400":
        q, k, v = (torch.randn(16, 3400, heads * dh, generator=gen, device="cuda").to(dtype)
                   for _ in range(3))
        base = torch.cuda.memory_allocated()
        out = ops.temporal_fullclip(q, k, v, heads)
        torch.cuda.synchronize()
        grew = torch.cuda.max_memory_allocated() - base
        assert grew <= out.numel() * out.element_size() + ops._TILED_SCRATCH + (16 << 20)
        got, ref = out[:2], ops.temporal_fullclip_plain(q[:2], k[:2], v[:2], heads)
    else:
        assert ops._tiled_plan(1700, 1700, dh, 2)[0] == 16
        qkv = torch.randn(3, 1700, 196, 3 * heads * dh, generator=gen, device="cuda").to(dtype)
        out = ops.temporal_fullclip_qkv(qkv, heads)
        torch.cuda.synchronize()
        got, ref = out[:, :, :2], ops.temporal_fullclip_qkv_plain(qkv[:, :, :2], heads)
    assert torch.isfinite(out.float()).all()
    assert (got.float() - ref.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_packed_fullclip_without_the_mask_equals_the_row_entry(dtype):
    """The encoder's packed entry at 64 frames, not causal: C and H in place
    on the (B, T, N, 3D) qkv equal the (R, T, D) entry bit for bit."""
    b, t, n, heads, dh = 2, 64, 5, 4, 32
    d = heads * dh
    qkv = _randn((b, t, n, 3 * d), dtype, 61)
    g = _randn((b, t, n, d), dtype, 62)
    rows = [x.transpose(1, 2).reshape(b * n, t, d).contiguous()
            for x in (qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:], g)]
    out = ops.temporal_fullclip_qkv(qkv, heads, False)
    ref = ops.temporal_fullclip(*rows[:3], heads, False)
    assert torch.equal(out, ref.reshape(b, n, t, d).transpose(1, 2))
    grad = ops.temporal_fullclip_qkv_bwd(qkv, g, heads, False)
    for i, x in enumerate(ops.temporal_fullclip_bwd(*rows, heads, False)):
        assert torch.equal(grad[..., i * d:(i + 1) * d], x.reshape(b, n, t, d).transpose(1, 2))


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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize(
    "per_stream,lens,cap,heads,dh",
    [
        (7, [0, 3, 7, 2], 8, 4, 24),
        (7, [8, 11, 19, 30], 8, 4, 24),  # ring: every length past capacity
        (196, [0, 1, 5, 9, 14, 15, 15, 15], 16, 12, 64),  # flagship engine tick, linear
        (196, [16, 17, 23, 31, 40, 41, 50, 63], 16, 12, 64),  # flagship, ring
        (5, [4, 0, 2], 5, 2, 128),
        (7, [0, 1000, 3, 77], 16, 12, 64),  # length 0 and far past C in one call
    ],
)
def test_temporal_decode_pm_ragged_matches_plain(dtype, per_stream, lens, cap, heads, dh):
    d = heads * dh
    rows = per_stream * len(lens)
    q, kn, vn = (_randn((rows, d), dtype, s) for s in (1, 2, 3))
    kc, vc = _randn((cap, rows, d), dtype, 4), _randn((cap, rows, d), dtype, 5)
    lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    k_ref, v_ref = kc.clone(), vc.clone()
    ref = ops.temporal_decode_pm_ragged_plain(q, kn, vn, k_ref, v_ref, lens_t, per_stream, heads)
    before = ops.LAUNCHES["temporal_decode_pm_ragged"]
    got = ops.temporal_decode_pm_ragged(q, kn, vn, kc, vc, lens_t, per_stream, heads)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["temporal_decode_pm_ragged"] == before + 1
    assert (got.float() - ref.float()).abs().max().item() <= TOL[dtype]
    assert torch.equal(kc, k_ref) and torch.equal(vc, v_ref)
    assert lens_t.tolist() == lens


@pytest.mark.parametrize("dtype", DTYPES)
def test_ragged_rows_equal_lone_streams_bitwise(dtype):
    """Kernels A and D share one source: a ragged row's output equals, bit
    for bit, A's for a lone stream at the same position."""
    per_stream, lens, cap, heads, dh = 196, [0, 3, 15, 21], 16, 12, 64
    d = heads * dh
    rows = per_stream * len(lens)
    q, kn, vn = (_randn((rows, d), dtype, s) for s in (1, 2, 3))
    kc, vc = _randn((cap, rows, d), dtype, 4), _randn((cap, rows, d), dtype, 5)
    k_all, v_all = kc.clone(), vc.clone()
    got = ops.temporal_decode_pm_ragged(
        q, kn, vn, k_all, v_all, torch.tensor(lens, dtype=torch.int32, device="cuda"),
        per_stream, heads)
    for b, length in enumerate(lens):
        sl = slice(b * per_stream, (b + 1) * per_stream)
        k1, v1 = kc[:, sl].contiguous(), vc[:, sl].contiguous()
        lone = ops.temporal_decode_pm(
            q[sl].contiguous(), kn[sl].contiguous(), vn[sl].contiguous(), k1, v1,
            torch.tensor(length, dtype=torch.int32, device="cuda"), heads)
        assert torch.equal(got[sl], lone), b
        assert torch.equal(k_all[:, sl], k1) and torch.equal(v_all[:, sl], v1), b


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize(
    "per_stream,lens,valid,t,cap,heads,dh",
    [
        (7, [0, 2, 4], [3, 1, 0], 3, 8, 4, 24),
        (196, [0, 1, 5, 8, 8, 12, 15, 16], [8, 0, 8, 8, 3, 4, 1, 0], 8, 16, 12, 64),  # flagship
        (196, [0, 0], [16, 16], 16, 16, 12, 64),  # a whole clip in one call
        (5, [3, 1], [1, 2], 2, 30, 2, 128),
        (9, [2, 0, 1], [1, 1, 0], 1, 4, 3, 8),
        # capacities past the 32 keys a warp held once, t = 1, 8 and 32
        (196, [0, 5, 31, 20], [1, 1, 1, 0], 1, 32, 12, 64),
        (196, [0, 24, 9, 16], [8, 8, 3, 5], 8, 32, 12, 64),
        (98, [0, 32, 0, 10], [32, 32, 16, 20], 32, 64, 12, 64),
        (196, [0, 40, 56, 63], [8, 8, 8, 1], 8, 64, 12, 64),
        (50, [0, 100, 200, 255], [1, 1, 1, 1], 1, 256, 12, 64),
        (50, [0, 100, 224, 248], [32, 32, 32, 8], 32, 256, 12, 64),
        (20, [0, 130, 240], [8, 8, 8], 8, 256, 4, 32),
    ],
)
def test_temporal_append_pm_ragged_matches_plain(dtype, per_stream, lens, valid, t, cap, heads,
                                                 dh):
    d = heads * dh
    rows = per_stream * len(lens)
    q, kn, vn = (_randn((t, rows, d), dtype, s) for s in (6, 7, 8))
    kc, vc = _randn((cap, rows, d), dtype, 9), _randn((cap, rows, d), dtype, 10)
    lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    valid_t = torch.tensor(valid, dtype=torch.int32, device="cuda")
    k_ref, v_ref = kc.clone(), vc.clone()
    ref = ops.temporal_append_pm_ragged_plain(q, kn, vn, k_ref, v_ref, lens_t, valid_t,
                                              per_stream, heads)
    before = ops.LAUNCHES["temporal_append_pm_ragged"]
    got = ops.temporal_append_pm_ragged(q, kn, vn, kc, vc, lens_t, valid_t, per_stream, heads)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["temporal_append_pm_ragged"] == before + 1
    assert torch.equal(kc, k_ref) and torch.equal(vc, v_ref)
    for b, n in enumerate(valid):  # outputs past valid[b] are unspecified
        sl = slice(b * per_stream, (b + 1) * per_stream)
        if n:
            assert (got[:n, sl].float() - ref[:n, sl].float()).abs().max().item() <= TOL[dtype], b


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("chunks", [[16], [8, 8], [3, 5, 1, 7], [1] * 16])
def test_chunked_appends_equal_the_full_clip_bitwise(dtype, chunks):
    """Kernel E fed a clip in chunks gives, bit for bit, kernel C's output
    for every frame: the three kernels share one order of arithmetic."""
    rows, heads, dh = 1568, 12, 64
    t = sum(chunks)
    d = heads * dh
    q, k, v = (_randn((rows, t, d), dtype, s) for s in (12, 13, 14))
    full = ops.temporal_fullclip(q, k, v, heads)
    k_cache = torch.zeros(t, rows, d, dtype=dtype, device="cuda")
    v_cache = torch.zeros_like(k_cache)
    start = 0
    for n in chunks:
        def new(a):
            return a[:, start:start + n].transpose(0, 1).contiguous()

        lens = torch.tensor([start], dtype=torch.int32, device="cuda")
        valid = torch.tensor([n], dtype=torch.int32, device="cuda")
        got = ops.temporal_append_pm_ragged(new(q), new(k), new(v), k_cache, v_cache, lens, valid,
                                            rows, heads)
        assert torch.equal(got, full[:, start:start + n].transpose(0, 1)), start
        start += n


def test_ragged_engine_streams_equal_lone_streams():
    """The serving engine on the card, fp32 small config: every stream's
    features equal a lone B=1 stream's, in both tick modes, within the fp32
    kernel tolerance (the matmuls run at another batch size)."""
    from streamformer_tpu_torch.config import StreamformerConfig
    from streamformer_tpu_torch.models import encoder
    from streamformer_tpu_torch.serving import StreamingEngine

    cfg = StreamformerConfig(image_size=32, num_frames=8, hidden_size=64, num_hidden_layers=2,
                             num_attention_heads=4, intermediate_size=128, dtype="float32",
                             cache_capacity=16)
    model = encoder.StreamformerEncoder(cfg, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for layer in model.encoder.layer:
            layer.temporal_attention_gating.fill_(0.5)
    rng = np.random.default_rng(0)
    clips = [rng.standard_normal((n, 3, 32, 32)).astype(np.float32) for n in (3, 9, 2, 7, 5)]

    def lone(clip):
        cache = model.init_cache(1)
        feats = []
        for i in range(len(clip)):
            out, cache = model.stream(torch.from_numpy(clip[None, i:i + 1]), cache)
            feats.append(out["pooler_output"][0, 0].cpu().numpy())
        return np.stack(feats)

    for frames in (1, 4):
        eng = StreamingEngine(model, slots=2, mode="linear")
        sids = []
        for clip in clips:
            sid = eng.open()
            eng.feed(sid, clip)
            eng.close(sid)
            sids.append(sid)
        eng.run_until_idle(frames=frames)
        for sid, clip in zip(sids, clips):
            feats, done = eng.poll(sid)
            assert done
            assert np.abs(feats - lone(clip)).max() <= TOL[torch.float32], (frames, sid)


def _int8_operands(rows, cap, d, seed, device="cuda"):
    """New-frame codes and scales from ``quantize_kv`` of a random frame, and
    an int8 cache of random codes with positive per-(slot, row) scales."""
    from streamformer_tpu_torch.models import encoder

    rng = np.random.default_rng(seed)
    kn, vn = (torch.from_numpy(rng.standard_normal((rows, d)).astype(np.float32)).to(device)
              for _ in range(2))
    kq, ks = encoder.quantize_kv(kn)
    vq, vs = encoder.quantize_kv(vn)
    codes = torch.from_numpy(rng.integers(-127, 128, (2, cap, rows, d)).astype(np.int8)).to(device)
    scales = torch.from_numpy(rng.uniform(0.005, 0.03, (2, cap, rows)).astype(np.float32)).to(device)
    return (kq, vq, ks, vs), [x.clone() for x in (*codes, *scales)]  # 16-byte aligned


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize(
    "rows,cap,heads,dh,length",
    [
        (56, 8, 4, 24, 0),
        (56, 8, 4, 24, 5),
        (56, 8, 4, 24, 7),
        (56, 8, 4, 24, 19),  # ring
        (1568, 16, 12, 64, 15),  # flagship int8 streaming step, linear
        (1568, 16, 12, 64, 37),  # flagship, ring
        (40, 5, 2, 128, 3),
        (40, 5, 1, 8, 9),
    ],
)
def test_temporal_decode_pm_int8_matches_plain(dtype, rows, cap, heads, dh, length):
    d = heads * dh
    q = _randn((rows, d), dtype, 1)
    new, cache = _int8_operands(rows, cap, d, 2)
    ref_cache = [c.clone() for c in cache]
    cache_len = torch.tensor(length, dtype=torch.int32, device="cuda")
    ref = ops.temporal_decode_pm_int8_plain(q, *new, *ref_cache, cache_len, heads)
    before = ops.LAUNCHES["temporal_decode_pm_int8"]
    got = ops.temporal_decode_pm_int8(q, *new, *cache, cache_len, heads)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["temporal_decode_pm_int8"] == before + 1
    assert (got.float() - ref.float()).abs().max().item() <= TOL[dtype]
    for mine, theirs in zip(cache, ref_cache):  # codes and scale columns
        assert torch.equal(mine, theirs)
    assert int(cache_len) == length


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize(
    "per_stream,lens,cap,heads,dh",
    [
        (7, [0, 3, 7, 2], 8, 4, 24),
        (7, [8, 11, 19, 30], 8, 4, 24),  # ring
        (196, [0, 1, 5, 9, 14, 15, 15, 15], 16, 12, 64),  # flagship engine tick, linear
        (196, [16, 17, 23, 31, 40, 41, 50, 63], 16, 12, 64),  # flagship, ring
        (5, [4, 0, 2], 5, 2, 128),
        (7, [0, 1000, 3, 77], 16, 12, 64),  # length 0 and far past C in one call
    ],
)
def test_temporal_decode_pm_int8_ragged_matches_plain(dtype, per_stream, lens, cap, heads, dh):
    d = heads * dh
    rows = per_stream * len(lens)
    q = _randn((rows, d), dtype, 3)
    new, cache = _int8_operands(rows, cap, d, 4)
    ref_cache = [c.clone() for c in cache]
    lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    ref = ops.temporal_decode_pm_int8_ragged_plain(q, *new, *ref_cache, lens_t, per_stream, heads)
    before = ops.LAUNCHES["temporal_decode_pm_int8_ragged"]
    got = ops.temporal_decode_pm_int8_ragged(q, *new, *cache, lens_t, per_stream, heads)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["temporal_decode_pm_int8_ragged"] == before + 1
    assert (got.float() - ref.float()).abs().max().item() <= TOL[dtype]
    for mine, theirs in zip(cache, ref_cache):
        assert torch.equal(mine, theirs)
    assert lens_t.tolist() == lens


@pytest.mark.parametrize("dtype", DTYPES)
def test_int8_ragged_rows_equal_lone_streams_bitwise(dtype):
    """Kernels F and G share one source: a ragged row's output equals, bit
    for bit, F's for a lone stream at the same position."""
    per_stream, lens, cap, heads, dh = 196, [0, 3, 15, 21], 16, 12, 64
    d = heads * dh
    rows = per_stream * len(lens)
    q = _randn((rows, d), dtype, 5)
    new, cache = _int8_operands(rows, cap, d, 6)
    whole = [c.clone() for c in cache]
    got = ops.temporal_decode_pm_int8_ragged(
        q, *new, *whole, torch.tensor(lens, dtype=torch.int32, device="cuda"), per_stream, heads)
    for b, length in enumerate(lens):
        sl = slice(b * per_stream, (b + 1) * per_stream)
        lone_cache = [c[:, sl].contiguous() for c in cache]
        lone = ops.temporal_decode_pm_int8(
            q[sl].contiguous(), *(x[sl].contiguous() for x in new), *lone_cache,
            torch.tensor(length, dtype=torch.int32, device="cuda"), heads)
        assert torch.equal(got[sl], lone), b
        for mine, theirs in zip(whole, lone_cache):
            assert torch.equal(mine[:, sl], theirs), b


@pytest.mark.parametrize("rows", [1, 8, 196, 1568])
def test_int8_codes_and_products_on_the_card_equal_the_cpu(rows):
    """Activation codes and scales (a true division on the card, as on the
    CPU) and the exact s8 x s8 -> s32 product, at the row counts the
    encoder gives them: the MAP head's probe (1), a pooled batch (8, padded
    for cuBLASLt), a lone stream's frame (196), the flagship step (1568)."""
    from streamformer_tpu_torch.ops import quant

    rng = np.random.default_rng(rows)
    x = torch.from_numpy((3 * rng.standard_normal((rows, 768))).astype(np.float32))
    w = torch.from_numpy(rng.integers(-127, 128, (2304, 768)).astype(np.int8))
    for dtype in DTYPES:
        xq, xs = quant.quantize_rows(x.to(dtype))
        xq_c, xs_c = quant.quantize_rows(x.to("cuda", dtype))
        assert torch.equal(xq_c.cpu(), xq) and torch.equal(xs_c.cpu(), xs), dtype
    got = quant.int8_matmul(xq.cuda(), w.cuda())
    assert got.shape == (rows, 2304) and torch.equal(got.cpu(), quant.int8_matmul(xq, w))


# ---------------------------------------------------------------------------
# The backward kernels H and I. Their tolerance is the forward's, scaled to
# the gradient's largest magnitude where that exceeds 1 (dk and dv sum over
# the queries, so a bf16 ulp there is larger than at the forward's outputs).
# ---------------------------------------------------------------------------


def _grad_close(got, ref, dtype):
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.shape == b.shape and a.dtype == dtype
        bound = TOL[dtype] * max(1.0, b.float().abs().max().item())
        err = (a.float() - b.float()).abs().max().item()
        assert err <= bound, (name, err, bound)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize(
    "rows,t,heads,dh",
    [(7, 1, 4, 24), (9, 5, 4, 24), (1568, 16, 12, 64), (10, 32, 2, 128), (6, 13, 3, 8),
     (64, 16, 4, 64)],
)
def test_temporal_fullclip_bwd_matches_plain_and_repeats(dtype, rows, t, heads, dh):
    d = heads * dh
    q, k, v, g = (_randn((rows, t, d), dtype, s) for s in (21, 22, 23, 24))
    ref = ops.temporal_fullclip_bwd_plain(q, k, v, g, heads)
    before = ops.LAUNCHES["temporal_fullclip_bwd"]
    got = ops.temporal_fullclip_bwd(q, k, v, g, heads)
    again = ops.temporal_fullclip_bwd(q, k, v, g, heads)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["temporal_fullclip_bwd"] == before + 2
    _grad_close(got, ref, dtype)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # no atomics


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize(
    "rows,n,heads,dh",
    [(3, 9, 4, 24), (5, 49, 2, 16), (8, 196, 12, 64), (128, 196, 12, 64), (2, 256, 2, 64),
     (2, 176, 1, 128), (4, 33, 3, 40)],  # N=176 at dh=128: fp32 fills a block's shared memory
)
def test_spatial_flat_bwd_matches_plain_and_repeats(dtype, rows, n, heads, dh):
    d = heads * dh
    q, k, v, g = (_randn((rows, n, d), dtype, s) for s in (25, 26, 27, 28))
    ref = ops.spatial_flat_bwd_plain(q, k, v, g, heads)
    before = ops.LAUNCHES["spatial_flat_bwd"]
    got = ops.spatial_flat_bwd(q, k, v, g, heads)
    again = ops.spatial_flat_bwd(q, k, v, g, heads)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["spatial_flat_bwd"] == before + 2
    _grad_close(got, ref, dtype)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # no atomics


@pytest.mark.parametrize("dtype", DTYPES)
def test_autograd_functions_launch_the_backward_kernels(dtype):
    """``loss.backward()`` through both wrappers runs kernels I and H (on the
    autograd engine's thread, on the forward's stream), with a transposed,
    non-contiguous output gradient, and matches the plain backward."""
    heads, dh = 4, 32
    d = heads * dh
    for name, fn, plain, shape in (
        ("spatial_flat", ops.spatial_flat, ops.spatial_flat_bwd_plain, (6, 49, d)),
        ("temporal_fullclip", ops.temporal_fullclip, ops.temporal_fullclip_bwd_plain, (49, 6, d)),
    ):
        q, k, v = (_randn(shape, dtype, s).requires_grad_() for s in (31, 32, 33))
        w = _randn((shape[1], shape[0], d), dtype, 34)
        before = dict(ops.LAUNCHES)
        out = fn(q, k, v, heads)
        (out.transpose(0, 1).float() * w.float()).sum().backward()
        torch.cuda.synchronize()
        assert ops.LAUNCHES[name] == before[name] + 1
        assert ops.LAUNCHES[name + "_bwd"] == before[name + "_bwd"] + 1
        g = w.transpose(0, 1).contiguous()
        ref = plain(q.detach(), k.detach(), v.detach(), g, heads)
        _grad_close((q.grad, k.grad, v.grad), ref, dtype)


def test_streaming_kernels_refuse_a_gradient():
    r, d, cap = 8, 64, 4
    q = _randn((r, d), torch.float32, 1).requires_grad_()
    kn, vn = _randn((r, d), torch.float32, 2), _randn((r, d), torch.float32, 3)
    kc, vc = torch.zeros(cap, r, d, device="cuda"), torch.zeros(cap, r, d, device="cuda")
    with pytest.raises(NotImplementedError, match="no backward"):
        ops.temporal_decode_pm(q, kn, vn, kc, vc,
                               torch.tensor(0, dtype=torch.int32, device="cuda"), 4)


# ---------------------------------------------------------------------------
# J, K and L: the row-major cache and head-split spatial attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize(
    "rows,cap,heads,dh,length",
    [
        (56, 8, 4, 24, 0),
        (56, 8, 4, 24, 7),
        (56, 20, 4, 16, 13),  # a capacity that is not a multiple of 8
        (1568, 16, 12, 64, 15),  # flagship streaming step
        (1568, 16, 12, 64, 7),
        (40, 5, 2, 128, 3),
        (56, 8, 4, 24, 19),  # ring: len past capacity
        (1568, 8, 12, 64, 21),  # flagship ring step, C=8
    ],
)
def test_temporal_decode_rm_matches_plain_and_pos_major(dtype, rows, cap, heads, dh, length):
    """Kernel J against its plain version, the row-major cache after the
    write equal; and bit for bit equal to kernel A on the same cache held
    pos-major (one body, two strides), on the linear cache and the ring."""
    d = heads * dh
    q, kn, vn = (_randn((rows, d), dtype, s) for s in (41, 42, 43))
    kc, vc = _randn((rows, cap, d), dtype, 44), _randn((rows, cap, d), dtype, 45)
    k_pm, v_pm = kc.transpose(0, 1).contiguous(), vc.transpose(0, 1).contiguous()
    cache_len = torch.tensor(length, dtype=torch.int32, device="cuda")
    k_ref, v_ref = kc.clone(), vc.clone()
    ref = ops.temporal_decode_rm_plain(q, kn, vn, k_ref, v_ref, cache_len, heads)
    before = ops.LAUNCHES["temporal_decode_rm"]
    got = ops.temporal_decode_rm(q, kn, vn, kc, vc, cache_len, heads)
    pm = ops.temporal_decode_pm(q, kn, vn, k_pm, v_pm, cache_len, heads)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["temporal_decode_rm"] == before + 1
    assert (got.float() - ref.float()).abs().max().item() <= TOL[dtype]
    assert torch.equal(kc, k_ref) and torch.equal(vc, v_ref)
    assert torch.equal(got, pm)
    assert torch.equal(kc.transpose(0, 1), k_pm) and torch.equal(vc.transpose(0, 1), v_pm)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize(
    "rows,cap,heads,dh,length",
    [(56, 8, 4, 24, 0), (56, 8, 4, 24, 7), (56, 20, 4, 16, 13), (1568, 16, 12, 64, 15),
     (1568, 16, 12, 64, 0), (40, 5, 2, 128, 3),
     # past one stage of the decode body (C = 64, 256), heads not a multiple
     # of four (the int8 scales by the lanes), int8 rows of 8 bytes (no bulk copy)
     (1568, 64, 12, 64, 63), (200, 256, 12, 64, 255), (200, 256, 12, 64, 100),
     (56, 64, 3, 24, 40), (40, 20, 1, 8, 13)],
)
def test_temporal_decode_rm_readonly_matches_plain(dtype, quantized, rows, cap, heads, dh, length):
    """Kernel K, float cache and int8 codes with per-(row, position, head)
    scales from ``quantize_kv_heads``; nothing is written."""
    from streamformer_tpu_torch.models import encoder

    d = heads * dh
    q = _randn((rows, d), dtype, 51)
    k, v = _randn((rows, cap, d), torch.float32, 52), _randn((rows, cap, d), torch.float32, 53)
    if quantized:
        (kq, ks), (vq, vs) = encoder.quantize_kv_heads(k, heads), encoder.quantize_kv_heads(v, heads)
        args = [kq, vq, ks, vs]
    else:
        args = [k.to(dtype), v.to(dtype), None, None]
    before_args = [None if a is None else a.clone() for a in args]
    cache_len = torch.tensor(length, dtype=torch.int32, device="cuda")
    ref = ops.temporal_decode_rm_readonly_plain(q, *args, cache_len, heads)
    before = ops.LAUNCHES["temporal_decode_rm_readonly"]
    got = ops.temporal_decode_rm_readonly(q, *args, cache_len, heads)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["temporal_decode_rm_readonly"] == before + 1
    assert (got.float() - ref.float()).abs().max().item() <= TOL[dtype]
    assert all(a is None or torch.equal(a, b) for a, b in zip(args, before_args))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize(
    "rows,heads,n,dh",
    [(3, 4, 9, 24), (8, 12, 196, 64), (128, 12, 196, 64), (2, 2, 256, 64), (2, 1, 196, 128),
     (4, 3, 33, 40)],
)
def test_spatial_attention_matches_plain_and_spatial_flat(dtype, rows, heads, n, dh):
    """Kernel L against its plain version, and bit for bit equal to kernel B
    on the same operands laid out flat (one body, head-split strides)."""
    q, k, v = (_randn((rows, heads, n, dh), dtype, s) for s in (61, 62, 63))
    ref = ops.spatial_attention_plain(q, k, v)
    before = ops.LAUNCHES["spatial_attention"]
    got = ops.spatial_attention(q, k, v)

    def flat(a):
        return a.transpose(1, 2).reshape(rows, n, heads * dh).contiguous()

    b = ops.spatial_flat(flat(q), flat(k), flat(v), heads)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["spatial_attention"] == before + 1
    assert (got.float() - ref.float()).abs().max().item() <= TOL[dtype]
    assert torch.equal(flat(got), b)


@pytest.mark.parametrize("dtype", DTYPES)
def test_spatial_attention_gradient_is_the_plain_versions(dtype):
    """L's backward is autograd of its plain version (the JAX package's
    einsum VJP): the forward launches kernel L once, the gradients equal
    autograd through the plain version."""
    shape = (4, 3, 49, 32)
    leaves = [_randn(shape, dtype, s).requires_grad_() for s in (71, 72, 73)]
    w = _randn(shape, dtype, 74)
    before = ops.LAUNCHES["spatial_attention"]
    (ops.spatial_attention(*leaves).float() * w.float()).sum().backward()
    torch.cuda.synchronize()
    assert ops.LAUNCHES["spatial_attention"] == before + 1
    plain = [x.detach().clone().requires_grad_() for x in leaves]
    (ops.spatial_attention_plain(*plain).float() * w.float()).sum().backward()
    for a, b in zip(leaves, plain):
        assert torch.equal(a.grad, b.grad)


# ---------------------------------------------------------------------------
# The decode bodies A, D, J and F, G (one source, decode_row.cuh): what they
# read, and capacities past one shared-memory stage
# ---------------------------------------------------------------------------


def _unread(lens, per_stream, cap):
    """(C, R) mask of the slots a decode does not read: slots >= len on the
    linear cache, slot len % C on the ring, per row of each stream."""
    mask = torch.zeros(cap, per_stream * len(lens), dtype=torch.bool)
    for b, length in enumerate(lens):
        rows = slice(b * per_stream, (b + 1) * per_stream)
        if length < cap:
            mask[length:, rows] = True
        else:
            mask[length % cap, rows] = True
    return mask.cuda()


def _decode_case(kernel, dtype, rows_or_streams, cap, heads, dh, lens, seed):
    """Operands of one decode kernel call: (run, plain, caches) where
    run(fn, caches) calls the kernel ("kernel") or its plain version ("plain")
    on the given caches and returns the output. caches are pos-major
    (C, R, ...) for every kernel; J's are transposed to (R, C, D) for the
    call and back, K's (float, in q's dtype) and K8's (int8 codes and
    (C, R, H) scales) to (R, C, ...) for the call (K writes nothing)."""
    d = heads * dh
    ragged = kernel in ("D", "G")
    per_stream = rows_or_streams if ragged else None
    rows = per_stream * len(lens) if ragged else rows_or_streams
    q = _randn((rows, d), dtype, seed)
    lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    if kernel in ("F", "G"):
        new, caches = _int8_operands(rows, cap, d, seed + 1)
    elif kernel == "K8":  # row-major codes and per-(row, position, head) scales, pos-major here
        new, codes = [], _int8_operands(rows, cap, d, seed + 1)[1][:2]
        rng = np.random.default_rng(seed + 2)
        caches = codes + [torch.from_numpy(rng.uniform(0.005, 0.03, (cap, rows, heads)).astype(
            np.float32)).cuda() for _ in range(2)]
    elif kernel == "K":  # read-only: no new frame, caches in q's dtype
        new, caches = [], [_randn((cap, rows, d), dtype, seed + s) for s in (3, 4)]
    else:
        new = [_randn((rows, d), dtype, seed + s) for s in (1, 2)]
        caches = [_randn((cap, rows, d), dtype, seed + s) for s in (3, 4)]

    def run(which, cs):
        if kernel == "A":
            fn = ops.temporal_decode_pm if which == "kernel" else ops.temporal_decode_pm_plain
            return fn(q, *new, *cs, lens_t.reshape(()), heads)
        if kernel == "D":
            fn = (ops.temporal_decode_pm_ragged if which == "kernel"
                  else ops.temporal_decode_pm_ragged_plain)
            return fn(q, *new, *cs, lens_t, per_stream, heads)
        if kernel == "J":
            fn = ops.temporal_decode_rm if which == "kernel" else ops.temporal_decode_rm_plain
            rm = [c.transpose(0, 1).contiguous() for c in cs]
            out = fn(q, *new, *rm, lens_t.reshape(()), heads)
            for c, r in zip(cs, rm):
                c.copy_(r.transpose(0, 1))
            return out
        if kernel == "F":
            fn = (ops.temporal_decode_pm_int8 if which == "kernel"
                  else ops.temporal_decode_pm_int8_plain)
            return fn(q, *new, *cs, lens_t.reshape(()), heads)
        if kernel in ("K", "K8"):
            fn = (ops.temporal_decode_rm_readonly if which == "kernel"
                  else ops.temporal_decode_rm_readonly_plain)
            rm = [c.transpose(0, 1).contiguous() for c in cs]
            return fn(q, rm[0], rm[1], *(rm[2:] or (None, None)), lens_t.reshape(()), heads)
        fn = (ops.temporal_decode_pm_int8_ragged if which == "kernel"
              else ops.temporal_decode_pm_int8_ragged_plain)
        return fn(q, *new, *cs, lens_t, per_stream, heads)

    return run, caches, (per_stream if ragged else rows)


DECODE_KERNELS = ["A", "D", "J", "F", "G"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", ["linear", "ring"])
@pytest.mark.parametrize("kernel", DECODE_KERNELS)
def test_decode_kernels_read_nothing_past_the_valid_prefix(kernel, mode, dtype):
    """Every cache slot a decode must not read is NaN (slots >= len on the
    linear cache, slot len % C on the ring; F and G: their scales too): the
    outputs are finite and bit-equal to the run on clean caches, and the
    slots the new frame takes are equal."""
    cap, heads, dh = 16, 12, 64
    if kernel in ("D", "G"):
        lens = [0, 5, 15, 9] if mode == "linear" else [16, 23, 40, 63]
        size = 13
    else:
        lens = [9] if mode == "linear" else [37]
        size = 40
    run, clean, per_stream = _decode_case(kernel, dtype, size, cap, heads, dh, lens, 101)
    mask = _unread(lens, per_stream, cap)
    poisoned = [c.clone() for c in clean]
    for c in poisoned:
        if c.dtype == torch.int8:
            continue  # codes cannot be NaN: their scales are
        c[mask] = float("nan")
    got = run("kernel", poisoned)
    ref = run("kernel", clean)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(got, ref)
    written = torch.zeros_like(mask)
    rows = torch.arange(mask.shape[1], device="cuda")
    written[torch.tensor(lens, device="cuda").repeat_interleave(per_stream) % cap, rows] = True
    for a, b in zip(poisoned, clean):
        assert torch.equal(a[written], b[written])
        assert torch.equal(a[~mask], b[~mask])


def _decode_smem(kernel, dtype, cap, heads, dh):
    """Shared memory of the decode body's whole-row plan for this kernel."""
    code, d = ops._DTYPE_CODES[dtype], heads * dh
    if kernel in ("F", "G"):
        return ops._body_smem("temporal_decode_pm_int8", "sf_temporal_decode_pm_int8", d, heads,
                              cap, code)
    if kernel in ("K", "K8"):
        return ops._body_smem("temporal_decode_rm", "sf_temporal_decode_rm_readonly", d, heads,
                              cap, code, int(kernel == "K8"))
    return ops._body_smem("temporal_decode_pm", "sf_temporal_decode_pm", d, heads, cap, code, code)


# K (float) and K8 (int8) read the linear cache only
CAPACITY_KERNELS = [(k, m) for k in DECODE_KERNELS + ["K", "K8"] for m in ("linear", "ring")
                    if not (k.startswith("K") and m == "ring")]


@pytest.mark.parametrize(
    "dtype,cap", [(torch.bfloat16, 64), (torch.float32, 64), (torch.float32, 256),
                  (torch.bfloat16, 4608), (torch.float32, 4608)],
    ids=["bf16-C64", "fp32-C64", "fp32-C256", "bf16-C4608", "fp32-C4608"],
)
@pytest.mark.parametrize("kernel,mode", CAPACITY_KERNELS)
def test_decode_kernels_at_large_capacities(kernel, mode, dtype, cap):
    """Capacities past one shared-memory stage (the config's default 64, and
    256 in fp32, where a stage holds 6 slots), and past the (heads, C)
    scores a block holds (C = 4608: the scratch mode), at the flagship width
    on an odd row count: each kernel against its plain version, the
    appended planes (and scale columns) equal."""
    heads, dh = 12, 64
    assert (_decode_smem(kernel, dtype, cap, heads, dh) > ops._MAX_SMEM) == (cap > 4000)
    if kernel in ("D", "G"):
        lens = [0, cap // 2, cap - 1] if mode == "linear" else [cap, 2 * cap + 3, 5 * cap + 1]
        size = 13
    else:
        lens = [cap - 1] if mode == "linear" else [3 * cap + 5]
        size = 37
    run, caches, _ = _decode_case(kernel, dtype, size, cap, heads, dh, lens, 111)
    ref_caches = [c.clone() for c in caches]
    ref = run("plain", ref_caches)
    before = dict(ops.LAUNCHES)
    got = run("kernel", caches)
    torch.cuda.synchronize()
    assert sum(ops.LAUNCHES.values()) == sum(before.values()) + 1
    assert (got.float() - ref.float()).abs().max().item() <= TOL[dtype]
    for mine, theirs in zip(caches, ref_caches):
        assert torch.equal(mine, theirs)


@pytest.mark.parametrize("kernel", ["A", "F", "K", "K8"])
def test_decode_scratch_holds_one_slice_a_block_of_the_grid(kernel):
    """The decode body's scratch (``ops._decode_scratch``) holds one slice of
    heads x score_stride(C) fp32 for each block of its kernel's persistent
    grid in the scratch mode, the C plan's (``_decode_blocks``): at the
    flagship tick (R = 1568, C = 8192), at least one block an SM and at
    most one a row; a few rows take one block each."""
    heads, d, cap = 12, 768, 8192
    code = ops._DTYPE_CODES[torch.bfloat16]
    library, symbol, shape = {
        "A": ("temporal_decode_pm", "sf_temporal_decode_pm", (d, heads, cap, code, code)),
        "F": ("temporal_decode_pm_int8", "sf_temporal_decode_pm_int8", (d, heads, cap, code)),
        "K": ("temporal_decode_rm", "sf_temporal_decode_rm_readonly", (d, heads, cap, code, 0)),
        "K8": ("temporal_decode_rm", "sf_temporal_decode_rm_readonly", (d, heads, cap, code, 1)),
    }[kernel]
    device = torch.device("cuda", torch.cuda.current_device())
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    per_block = heads * ((cap + 4) // 4 * 4)
    for rows in (1568, 5):
        blocks = ops._decode_blocks(library, symbol, device.index, *shape, rows)
        assert (sms <= blocks <= rows) if rows > sms else blocks == rows
        scratch = ops._decode_scratch(library, symbol, shape, rows, device)
        assert scratch.numel() == blocks * per_block


@pytest.mark.parametrize("grid", ["full", "one_block"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel,mode", CAPACITY_KERNELS)
def test_decode_scratch_mode_equals_the_whole_row_body(kernel, mode, dtype, grid, monkeypatch):
    """Where both run (C = 256) the decode body's scratch mode (the scores in
    the wrapper's fp32 scratch, forced by ``ops._body_smem`` patched past
    ``_MAX_SMEM``) gives the whole-row body's bits: outputs and the appended
    planes and scale columns. ``one_block``: a scratch of one slice, so one
    block walks every row and reuses it."""
    cap, heads, dh = 256, 12, 64
    if kernel in ("D", "G"):
        lens = [0, 100, cap - 1] if mode == "linear" else [cap, 2 * cap + 3, 5 * cap + 1]
        size = 13
    else:
        lens = [cap - 1] if mode == "linear" else [3 * cap + 5]
        size = 37
    run, caches, _ = _decode_case(kernel, dtype, size, cap, heads, dh, lens, 131)
    whole_caches = [c.clone() for c in caches]
    whole = run("kernel", whole_caches)
    monkeypatch.setattr(ops, "_body_smem", lambda *a: ops._MAX_SMEM + 1)
    if grid == "one_block":
        monkeypatch.setattr(ops, "_TILED_SCRATCH", 4 * heads * (cap + 4))
    scratch = run("kernel", caches)
    torch.cuda.synchronize()
    assert torch.equal(scratch, whole)
    for a, b in zip(caches, whole_caches):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["linear", "ring"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_scratch_mode_ragged_int8_equals_lone_streams(dtype, mode, monkeypatch):
    """G = lone F in the scratch mode (forced at C = 256): each stream's rows
    of a ragged call equal, bit for bit, F on those rows alone at the
    stream's length, outputs and written planes and scales."""
    cap, heads, dh, per_stream = 256, 12, 64, 13
    lens = [0, 100, cap - 1] if mode == "linear" else [cap, 2 * cap + 3, 5 * cap + 1]
    monkeypatch.setattr(ops, "_body_smem", lambda *a: ops._MAX_SMEM + 1)
    run, caches, _ = _decode_case("G", dtype, per_stream, cap, heads, dh, lens, 141)
    q = _randn((per_stream * len(lens), heads * dh), dtype, 141)  # _decode_case's q
    new, _ = _int8_operands(per_stream * len(lens), cap, heads * dh, 142)
    lone_caches = [c.clone() for c in caches]
    ragged = run("kernel", caches)
    for b, length in enumerate(lens):
        rows = slice(b * per_stream, (b + 1) * per_stream)
        part = [c[:, rows].contiguous() for c in lone_caches]
        out = ops.temporal_decode_pm_int8(q[rows], *(x[rows].clone() for x in new), *part,
                                          torch.tensor(length, dtype=torch.int32, device="cuda"),
                                          heads)
        assert torch.equal(out, ragged[rows])
        for a, c in zip(part, caches):
            assert torch.equal(a, c[:, rows])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel", DECODE_KERNELS)
def test_decode_kernels_walk_many_rows_a_block(kernel, dtype):
    """More rows than 64 times the persistent grid, at a narrow width (two
    heads of 8, C=4): each block walks past 64 rows, so its producer warp
    reloads its lanes' row lengths (32 rows at a time) twice. D and G give
    every row a stream of its own, at lengths drawn from 0 to 3C (linear and
    ring in one call). Each kernel against its plain version, the appended
    planes (and scale columns) equal."""
    cap, heads, dh = 4, 2, 8
    # a block is 288 threads, so at most 2048 // 288 = 7 fit an SM
    grid = 7 * torch.cuda.get_device_properties(0).multi_processor_count
    rows = 70 * grid + 5
    if kernel in ("D", "G"):
        lens = np.random.default_rng(7).integers(0, 3 * cap, rows).tolist()
        size = 1
    else:
        lens = [cap + 1]
        size = rows
    run, caches, _ = _decode_case(kernel, dtype, size, cap, heads, dh, lens, 121)
    ref_caches = [c.clone() for c in caches]
    ref = run("plain", ref_caches)
    before = dict(ops.LAUNCHES)
    got = run("kernel", caches)
    torch.cuda.synchronize()
    assert sum(ops.LAUNCHES.values()) == sum(before.values()) + 1
    assert (got.float() - ref.float()).abs().max().item() <= TOL[dtype]
    for mine, theirs in zip(caches, ref_caches):
        assert torch.equal(mine, theirs)


# ---------------------------------------------------------------------------
# C and H on the bulk-copy pipeline (csrc/fullclip.cuh): the (R, T, D) entries
# and the packed entry, which reads the (B, T, N, 3D) output of the qkv
# projection in place and writes one (B, T, N, 3D) gradient
# ---------------------------------------------------------------------------

FULLCLIP_SHAPES = [  # (rows, T, heads, dh): T of 1 to 32, dh of 8 to 128, 1 to 12 heads
    (5, 1, 12, 8), (9, 5, 1, 8), (13, 16, 3, 128), (11, 32, 12, 64), (33, 32, 1, 128),
    (7, 16, 12, 64), (3, 5, 2, 64), (21, 32, 4, 8),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,t,heads,dh", FULLCLIP_SHAPES)
def test_fullclip_kernels_match_plain(dtype, rows, t, heads, dh):
    """C and H against their plain versions, H twice bit for bit."""
    d = heads * dh
    q, k, v, g = (_randn((rows, t, d), dtype, s) for s in (101, 102, 103, 104))
    before = dict(ops.LAUNCHES)
    out = ops.temporal_fullclip(q, k, v, heads)
    got = ops.temporal_fullclip_bwd(q, k, v, g, heads)
    again = ops.temporal_fullclip_bwd(q, k, v, g, heads)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["temporal_fullclip"] == before["temporal_fullclip"] + 1
    assert ops.LAUNCHES["temporal_fullclip_bwd"] == before["temporal_fullclip_bwd"] + 2
    ref = ops.temporal_fullclip_plain(q, k, v, heads)
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]
    _grad_close(got, ops.temporal_fullclip_bwd_plain(q, k, v, g, heads), dtype)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _packed_case(dtype, b, t, n, heads, dh, seed):
    d = heads * dh
    qkv, g = _randn((b, t, n, 3 * d), dtype, seed), _randn((b, t, n, d), dtype, seed + 1)

    def rows(x):  # (B, T, N, D') slice -> contiguous (B*N, T, D')
        return x.transpose(1, 2).reshape(b * n, t, x.shape[-1]).contiguous()

    return qkv, g, rows, d


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,t,n,heads,dh", [(8, 16, 196, 12, 64), (3, 5, 7, 3, 8),
                                            (2, 32, 9, 2, 128), (1, 1, 5, 12, 64)])
def test_packed_entry_equals_the_row_entry_bitwise(dtype, b, t, n, heads, dh):
    """The packed entry (C and H reading qkv in place) gives, bit for bit,
    the (R, T, D) entry's output on the transposed, contiguous slices, and
    its gradient (through autograd, with the launches counted under C's and
    H's names) the three row gradients side by side."""
    qkv, g, rows, d = _packed_case(dtype, b, t, n, heads, dh, 111)
    q, k, v = (rows(qkv[..., i * d:(i + 1) * d]) for i in range(3))
    want = ops.temporal_fullclip(q, k, v, heads)
    grads = ops.temporal_fullclip_bwd(q, k, v, rows(g), heads)
    x = qkv.clone().requires_grad_()
    before = dict(ops.LAUNCHES)
    out = ops.temporal_fullclip_qkv(x, heads)
    (grad,) = torch.autograd.grad(out, x, g)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["temporal_fullclip"] == before["temporal_fullclip"] + 1
    assert ops.LAUNCHES["temporal_fullclip_bwd"] == before["temporal_fullclip_bwd"] + 1
    assert sum(ops.LAUNCHES.values()) == sum(before.values()) + 2
    assert out.shape == (b, t, n, d) and out.is_contiguous()
    assert torch.equal(rows(out), want)
    assert grad.shape == qkv.shape
    for i, dx in enumerate(grads):
        assert torch.equal(rows(grad[..., i * d:(i + 1) * d]), dx), i
    assert torch.equal(ops.temporal_fullclip_qkv_bwd(qkv, g, heads), grad)


@pytest.mark.parametrize("dtype", DTYPES)
def test_packed_entry_reads_aligned_strided_layouts(dtype):
    """qkv and g as views into wider rows (strides 16-byte aligned, not
    contiguous) are read in place: the results equal those of contiguous
    copies, and nothing past the views (NaN) is read."""
    b, t, n, heads, dh = 2, 6, 5, 3, 16
    d = heads * dh
    buf = _randn((b, t, n, 3 * d + 16), dtype, 121)
    buf[..., 3 * d:] = float("nan")
    gbuf = _randn((b, t, n, d + 8), dtype, 122)
    gbuf[..., d:] = float("nan")
    qkv, g = buf[..., :3 * d], gbuf[..., :d]
    out = ops.temporal_fullclip_qkv(qkv, heads)
    grad = ops.temporal_fullclip_qkv_bwd(qkv, g, heads)
    assert torch.isfinite(out).all() and torch.isfinite(grad).all()
    assert torch.equal(out, ops.temporal_fullclip_qkv(qkv.contiguous(), heads))
    assert torch.equal(grad, ops.temporal_fullclip_qkv_bwd(qkv.contiguous(), g.contiguous(), heads))
    with pytest.raises(ValueError):
        ops.temporal_fullclip_qkv(_randn((b, t, n, 3 * d + 2), dtype, 123)[..., :3 * d], heads)
    with pytest.raises(ValueError):
        ops.temporal_fullclip_qkv_bwd(qkv, gbuf[..., 2:d + 2], heads)  # data 4 or 8 bytes in


@pytest.mark.parametrize("dtype", DTYPES)
def test_fullclip_kernels_walk_many_items_a_block(dtype):
    """More rows than 64 times the persistent grid, at a narrow width (two
    heads of 8, T=5): each block of C and H walks past 64 items, and its
    two stages turn over many times. Both entries against the plain
    versions, H twice bit for bit."""
    heads, dh, t, n = 2, 8, 5, 7
    d = heads * dh
    # a block is 288 threads, so at most 2048 // 288 = 7 fit an SM
    grid = 7 * torch.cuda.get_device_properties(0).multi_processor_count
    b = -(-(70 * grid + 5) // n)
    qkv, g, rows, _ = _packed_case(dtype, b, t, n, heads, dh, 131)
    out = ops.temporal_fullclip_qkv(qkv, heads)
    grad = ops.temporal_fullclip_qkv_bwd(qkv, g, heads)
    again = ops.temporal_fullclip_qkv_bwd(qkv, g, heads)
    torch.cuda.synchronize()
    assert (out.float() - ops.temporal_fullclip_qkv_plain(qkv, heads).float()).abs().max() \
        <= TOL[dtype]
    ref = ops.temporal_fullclip_qkv_bwd_plain(qkv, g, heads)
    _grad_close((grad,), (ref,), dtype)
    assert torch.equal(grad, again)
    q, k, v = (rows(qkv[..., i * d:(i + 1) * d]) for i in range(3))
    assert torch.equal(ops.temporal_fullclip(q, k, v, heads), rows(out))


# ---------------------------------------------------------------------------
# E on the bulk-copy pipeline (csrc/temporal_append_pm.cu): the packed entry,
# its plan, and blocks that walk many items
# ---------------------------------------------------------------------------


def _append_case(dtype, b, t, n, heads, dh, cap, lens, valid, seed):
    """A (B, t, N, 3D) qkv and (C, B*N, D) caches on the card, with the (t,
    R, D) rows of its slices; lens and valid one per clip."""
    d = heads * dh
    qkv = _randn((b, t, n, 3 * d), dtype, seed)
    caches = [_randn((cap, b * n, d), dtype, seed + s) for s in (1, 2)]
    lens_t, valid_t = (torch.tensor(x, dtype=torch.int32, device="cuda") for x in (lens, valid))
    rows = [qkv[..., i * d:(i + 1) * d].transpose(0, 1).reshape(t, b * n, d).contiguous()
            for i in range(3)]
    return qkv, caches, lens_t, valid_t, rows


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,t,n,heads,dh,cap,lens,valid", [
    (8, 8, 196, 12, 64, 16, [0, 1, 5, 8, 8, 12, 15, 16], [8, 0, 8, 8, 3, 4, 1, 0]),
    (4, 3, 196, 12, 64, 64, [0, 20, 61, 40], [3, 3, 3, 1]),
    (3, 32, 20, 12, 64, 256, [0, 100, 224], [32, 32, 32]),
    (2, 5, 7, 3, 8, 9, [4, 0], [5, 2]),
])
def test_append_packed_entry_equals_the_row_entry_bitwise(dtype, b, t, n, heads, dh, cap, lens,
                                                          valid):
    """The packed entry (E reading q, k, v in place from qkv and writing a
    contiguous (B, t, N, D)) gives, bit for bit, the (t, R, D) entry's
    output on the transposed, contiguous slices, appends the same rows, and
    counts under the (t, R, D) entry's name."""
    qkv, caches, lens_t, valid_t, rows = _append_case(dtype, b, t, n, heads, dh, cap, lens,
                                                      valid, 131)
    row_caches = [c.clone() for c in caches]
    want = ops.temporal_append_pm_ragged(*rows, *row_caches, lens_t, valid_t, n, heads)
    before = dict(ops.LAUNCHES)
    got = ops.temporal_append_pm_qkv(qkv, *caches, lens_t, valid_t, n, heads)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["temporal_append_pm_ragged"] == before["temporal_append_pm_ragged"] + 1
    assert sum(ops.LAUNCHES.values()) == sum(before.values()) + 1
    assert got.shape == (b, t, n, heads * dh) and got.is_contiguous()
    assert torch.equal(got.transpose(0, 1).reshape(want.shape), want)
    for mine, theirs in zip(caches, row_caches):
        assert torch.equal(mine, theirs)


@pytest.mark.parametrize("dtype", DTYPES)
def test_append_reads_nothing_past_its_keys(dtype):
    """Cache slots at or past each stream's len are NaN, and so are the
    columns past qkv's view: the outputs of the valid frames are finite and
    equal to those on clean operands, and the appended rows are the new
    frames'."""
    b, t, n, heads, dh, cap = 3, 4, 11, 3, 16, 24
    d = heads * dh
    lens, valid = [0, 9, 20], [4, 2, 4]
    buf = _randn((b, t, n, 3 * d + 16), dtype, 141)
    buf[..., 3 * d:] = float("nan")
    qkv = buf[..., :3 * d]
    clean = [_randn((cap, b * n, d), dtype, s) for s in (142, 143)]
    poisoned = [c.clone() for c in clean]
    for c in poisoned:
        for i, length in enumerate(lens):
            c[length:, i * n:(i + 1) * n] = float("nan")
    lens_t, valid_t = (torch.tensor(x, dtype=torch.int32, device="cuda") for x in (lens, valid))
    got = ops.temporal_append_pm_qkv(qkv, *poisoned, lens_t, valid_t, n, heads)
    ref = ops.temporal_append_pm_qkv(qkv.contiguous(), *clean, lens_t, valid_t, n, heads)
    torch.cuda.synchronize()
    for i, nv in enumerate(valid):
        assert torch.isfinite(got[i, :nv]).all()
        assert torch.equal(got[i, :nv], ref[i, :nv])
    for a, c in zip(poisoned, clean):
        for i, (length, nv) in enumerate(zip(lens, valid)):
            rows = slice(i * n, (i + 1) * n)
            assert torch.equal(a[:length + nv, rows], c[:length + nv, rows])


def test_append_plan_agrees_with_the_wrapper():
    """The kernel's plan (csrc/temporal_append_pm.cu) fits a block where, and
    only where, the wrapper's smallest plan does (``_append_min_smem``),
    within a block's shared memory, and at the flagship takes whole items:
    every key of an item in one stage."""
    import ctypes

    from streamformer_tpu_torch.ops import build

    fn = build.function("temporal_append_pm", "sf_temporal_append_pm_plan",
                        (ctypes.c_int,) * 5 + (ctypes.c_void_p,) * 2)
    hg, chunk = ctypes.c_int(), ctypes.c_int()
    for dtype in DTYPES:
        elt = torch.tensor([], dtype=dtype).element_size()
        code = ops._DTYPE_CODES[dtype]
        for t, cap, heads, dh in [(8, 16, 12, 64), (32, 256, 12, 64), (1, 4, 2, 8),
                                  (32, 1500, 2, 8), (32, 1800, 2, 8), (32, 4000, 12, 128),
                                  (8, 64, 12, 64), (31, 1800, 1, 8)]:
            total = fn(t, cap, heads * dh, heads, code, ctypes.byref(hg), ctypes.byref(chunk))
            fits = ops._append_min_smem(t, cap, dh, elt) <= ops._MAX_SMEM
            assert (total > 0) == fits, (dtype, t, cap, heads, dh)
            if total:
                assert total <= ops._MAX_SMEM and heads % hg.value == 0 and chunk.value >= 1
        fn(8, 16, 768, 12, code, ctypes.byref(hg), ctypes.byref(chunk))
        assert chunk.value == 16 + 8, dtype


@pytest.mark.parametrize("dtype", DTYPES)
def test_append_walks_many_items_a_block(dtype):
    """More items than 64 times the persistent grid, at a narrow width (one
    head of 16, C=6, t=3): each block walks past 64 items, so its producer
    warp reloads its lanes' lens and valid (32 items at a time) twice. Streams
    of 8 rows at lens and valid drawn so that lens + valid <= C. Against the
    plain version, the appended planes equal."""
    cap, t, heads, dh, per_stream = 6, 3, 1, 16, 8
    grid = 7 * torch.cuda.get_device_properties(0).multi_processor_count
    streams = (70 * grid + 5 + per_stream - 1) // per_stream
    rng = np.random.default_rng(151)
    lens = rng.integers(0, cap + 1, streams)
    valid = np.minimum(rng.integers(0, t + 1, streams), cap - lens)
    rows, d = streams * per_stream, heads * dh
    q, kn, vn = (_randn((t, rows, d), dtype, s) for s in (152, 153, 154))
    caches = [_randn((cap, rows, d), dtype, s) for s in (155, 156)]
    lens_t, valid_t = (torch.tensor(x, dtype=torch.int32, device="cuda") for x in (lens, valid))
    ref_caches = [c.clone() for c in caches]
    ref = ops.temporal_append_pm_ragged_plain(q, kn, vn, *ref_caches, lens_t, valid_t,
                                              per_stream, heads)
    got = ops.temporal_append_pm_ragged(q, kn, vn, *caches, lens_t, valid_t, per_stream, heads)
    torch.cuda.synchronize()
    for mine, theirs in zip(caches, ref_caches):
        assert torch.equal(mine, theirs)
    keep = (torch.arange(t, device="cuda")[:, None]
            < valid_t.long().repeat_interleave(per_stream)[None])  # (t, R)
    assert (got.float() - ref.float()).abs()[keep].max().item() <= TOL[dtype]


# ---------------------------------------------------------------------------
# the streaming remainders: E without the mask, at any t and capacity, its
# ring mode; A, D, J and E on a cache of the other float type
# ---------------------------------------------------------------------------

MIXED_PAIRS = [(torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)]
MIXED_IDS = ["fp32q-bf16kv", "bf16q-fp32kv"]


def _append_inputs(dtype, kv_dtype, t, rows, d, cap, seed):
    """E's operands: q (t, R, D) of dtype, k_new, v_new and the two caches
    (C, R, D) of kv_dtype."""
    q = _randn((t, rows, d), dtype, seed)
    kn, vn = (_randn((t, rows, d), kv_dtype, seed + s) for s in (1, 2))
    gen = torch.Generator("cuda").manual_seed(seed)  # capacities up to 60000: drawn on the card
    caches = [torch.randn(cap, rows, d, generator=gen, device="cuda").to(kv_dtype)
              for _ in range(2)]
    return q, kn, vn, caches


def _append_call(dtype, kv_dtype, t, per_stream, lens, valid, cap, heads, dh, seed, causal=True,
                 ring=False):
    """E's (t, R, D) entry against its plain version on the same operands
    (q of dtype, new frames and caches of kv_dtype): the outputs where
    valid (all of them on the ring), and the appended planes equal; returns
    the kernel's output and planes."""
    rows = per_stream * len(lens)
    q, kn, vn, caches = _append_inputs(dtype, kv_dtype, t, rows, heads * dh, cap, seed)
    lens_t, valid_t = (torch.tensor(x, dtype=torch.int32, device="cuda") for x in (lens, valid))
    ref_caches = [c.clone() for c in caches]
    ref = ops.temporal_append_pm_ragged_plain(q, kn, vn, *ref_caches, lens_t, valid_t,
                                              per_stream, heads, causal, ring)
    before = ops.LAUNCHES["temporal_append_pm_ragged"]
    got = ops.temporal_append_pm_ragged(q, kn, vn, *caches, lens_t, valid_t, per_stream, heads,
                                        causal, ring)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["temporal_append_pm_ragged"] == before + 1
    for mine, theirs in zip(caches, ref_caches):
        assert torch.equal(mine, theirs)
    for b, n in enumerate(valid):
        sl = slice(b * per_stream, (b + 1) * per_stream)
        n = t if ring else n
        if n:
            assert (got[:n, sl].float() - ref[:n, sl].float()).abs().max().item() <= TOL[dtype]
    return got, caches


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("per_stream,lens,valid,t,cap,heads,dh", [
    (196, [0, 1, 5, 8, 8, 12, 15, 16], [8, 0, 8, 8, 3, 4, 1, 0], 8, 16, 12, 64),  # flagship
    (1568, [0], [16], 16, 16, 12, 64),
    (7, [0, 2, 4], [3, 3, 3], 3, 8, 4, 24),
    (9, [30, 0], [2, 2], 2, 32, 3, 128),
])
def test_append_without_the_mask_matches_plain(dtype, per_stream, lens, valid, t, cap, heads,
                                               dh):
    _append_call(dtype, dtype, t, per_stream, lens, valid, cap, heads, dh, 201, causal=False)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("per_stream,lens,t,cap", [
    (1568, [5], 4, 8), (1568, [37], 12, 8), (50, [0, 3, 8, 21], 4, 8), (50, [2, 9], 12, 8),
    (13, [70, 64], 64, 64), (13, [0, 1], 1, 8), (13, [9, 30], 1, 8),
])
def test_append_ring_matches_plain(dtype, per_stream, lens, t, cap):
    """The ring mode: every query sees the window of the C positions ending
    at the call's last frame; the last min(t, C) frames written."""
    _append_call(dtype, dtype, t, per_stream, lens, [0] * len(lens), cap, 12, 64, 211,
                 causal=t == 1, ring=True)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("per_stream,lens,valid,t,cap,heads,dh", [
    (20, [0, 9], [33, 20], 33, 48, 12, 64),
    (20, [0], [64], 64, 64, 12, 64),
    (49, [4080], [16], 16, 4096, 12, 64),
    (8, [59000], [1], 1, 60000, 2, 64),
    (6, [100, 0], [40, 40], 40, 160, 2, 128),
])
def test_append_at_any_t_and_capacity_matches_plain(dtype, per_stream, lens, valid, t, cap,
                                                    heads, dh, causal):
    """Past 32 frames or the whole-table plan: the tiled body."""
    if ops._body_smem("temporal_append_pm", "sf_temporal_append_pm", t, cap, heads * dh, heads,
                      ops._DTYPE_CODES[dtype], ops._DTYPE_CODES[dtype]):
        pytest.fail("this shape would take the whole-table body")
    _append_call(dtype, dtype, t, per_stream, lens, valid, cap, heads, dh, 221, causal=causal)


@pytest.mark.parametrize("pair", MIXED_PAIRS, ids=MIXED_IDS)
@pytest.mark.parametrize("case", ["causal", "full", "ring", "tiled"])
def test_append_takes_mixed_caches(pair, case):
    dtype, kv = pair
    if case == "ring":
        _append_call(dtype, kv, 4, 196, [13], [0], 8, 12, 64, 231, causal=False, ring=True)
    elif case == "tiled":
        _append_call(dtype, kv, 40, 20, [0, 9], [40, 30], 64, 12, 64, 231)
    else:
        _append_call(dtype, kv, 8, 196, [0, 1, 5, 8], [8, 0, 8, 3], 16, 12, 64, 231,
                     causal=case == "causal")


@pytest.mark.parametrize("pair", MIXED_PAIRS + [(d, d) for d in DTYPES],
                         ids=MIXED_IDS + ["fp32", "bf16"])
@pytest.mark.parametrize("case", ["causal", "full", "ring", "ring_t1", "mixed_lens", "linear_t1",
                                  "linear_t1_ragged", "linear_t3", "causal_split", "full_split",
                                  "t16_split", "mixed_lens_split", "mixed_lens_items",
                                  "mixed_lens_queries"])
def test_tiled_append_equals_the_whole_table_bitwise(pair, case, monkeypatch):
    """Where both bodies take a shape they give the same bits (outputs and
    planes): ``ops._body_smem`` patched to 0 forces the tiled one (its
    resident body past 4 frames, its split body up to 4). ``_split`` cases
    raise ``ops._TILED_FEW`` so that the split body takes 8, 16 or 32 frames
    (its scores 16 queries at once, two queries' PV chains a warp, two query
    groups); ``_items`` and ``_queries`` also shrink its scratch, so that it
    launches over chunks of items or of one item's 16 queries. A linear t=1
    step (the split body, as past A's plan) also equals kernel A (lockstep)
    or D (ragged lens) on the same operands."""
    dtype, kv = pair
    base = case.replace("_split", "").replace("_items", "").replace("_queries", "")
    kw = {"causal": dict(t=8, per_stream=196, lens=[0, 5, 12, 16], valid=[8, 8, 4, 0], cap=24),
          "full": dict(t=8, per_stream=196, lens=[0, 5, 12, 16], valid=[8, 8, 4, 0], cap=24,
                       causal=False),
          "ring": dict(t=12, per_stream=196, lens=[37], valid=[0], cap=8, causal=False,
                       ring=True),
          "ring_t1": dict(t=1, per_stream=196, lens=[3, 40], valid=[0, 0], cap=16, ring=True),
          "mixed_lens": dict(t=32, per_stream=20, lens=[0, 100, 223], valid=[32, 32, 1],
                             cap=256),
          "linear_t1": dict(t=1, per_stream=1568, lens=[11], valid=[1], cap=16),
          "linear_t1_ragged": dict(t=1, per_stream=196, lens=[0, 3, 9, 15, 15, 1, 7, 12],
                                   valid=[1] * 8, cap=16),
          "linear_t3": dict(t=3, per_stream=196, lens=[0, 5, 12, 13], valid=[3, 2, 3, 3],
                            cap=16),
          "t16": dict(t=16, per_stream=196, lens=[0, 5, 12, 16], valid=[16, 9, 4, 0], cap=32)}[base]
    whole = _append_call(dtype, kv, heads=12, dh=64, seed=241, **kw)
    monkeypatch.setattr(ops, "_body_smem", lambda *a: 0)
    if case != base:
        monkeypatch.setattr(ops, "_TILED_FEW", 32)
        per_query = ops._tiled_plan(kw["t"], kw["cap"] + kw["t"], 64, 4)[1]
        if case.endswith("_items"):  # 100 of the 720 items a launch
            monkeypatch.setattr(ops, "_TILED_SCRATCH", 4 * 100 * kw["t"] * per_query)
        elif case.endswith("_queries"):  # 16 of an item's queries a launch
            monkeypatch.setattr(ops, "_TILED_SCRATCH", 4 * 16 * per_query)
    tiled = _append_call(dtype, kv, heads=12, dh=64, seed=241, **kw)
    assert torch.equal(whole[0], tiled[0])
    for a, b in zip(whole[1], tiled[1]):
        assert torch.equal(a, b)
    if case.startswith("linear_t1"):
        monkeypatch.undo()
        rows = kw["per_stream"] * len(kw["lens"])
        q, kn, vn, caches = _append_inputs(dtype, kv, 1, rows, 768, kw["cap"], 241)
        lens_t = torch.tensor(kw["lens"], dtype=torch.int32, device="cuda")
        if case == "linear_t1":
            step = ops.temporal_decode_pm(q[0], kn[0], vn[0], *caches, lens_t.reshape(()), 12)
        else:
            step = ops.temporal_decode_pm_ragged(q[0], kn[0], vn[0], *caches, lens_t,
                                                 kw["per_stream"], 12)
        assert torch.equal(step, tiled[0][0])
        for a, b in zip(caches, tiled[1]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("kernel", ["A", "D", "J"])
@pytest.mark.parametrize("pair", MIXED_PAIRS, ids=MIXED_IDS)
@pytest.mark.parametrize("mode", ["linear", "ring"])
def test_decode_kernels_take_mixed_caches(kernel, pair, mode):
    """A, D and J with queries of one float type and caches of the other:
    against their plain versions, the appended planes equal; the fp32 cache
    under bf16 queries (holding bf16 values) bit-equal to the bf16 cache."""
    dtype, kv = pair
    rows, cap, heads, dh = 1568, 16, 12, 64
    d = heads * dh
    lens = [15] if mode == "linear" else [37]
    if kernel == "D":
        lens = [0, 1, 5, 9, 14, 15, 15, 15] if mode == "linear" else [16, 17, 23, 31, 40, 41,
                                                                          50, 63]
    per_stream = rows // len(lens)
    q = _randn((rows, d), dtype, 251)
    kn, vn = (_randn((rows, d), torch.bfloat16, s).to(kv) for s in (252, 253))
    caches = [_randn((cap, rows, d), torch.bfloat16, s).to(kv) for s in (254, 255)]
    lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")

    def run(fn, cs, new):
        if kernel == "A":
            return fn(q, *new, *cs, lens_t.reshape(()), heads)
        if kernel == "D":
            return fn(q, *new, *cs, lens_t, per_stream, heads)
        rm = [c.transpose(0, 1).contiguous() for c in cs]
        out = fn(q, *new, *rm, lens_t.reshape(()), heads)
        for c, r in zip(cs, rm):
            c.copy_(r.transpose(0, 1))
        return out

    kern, plain = {"A": (ops.temporal_decode_pm, ops.temporal_decode_pm_plain),
                   "D": (ops.temporal_decode_pm_ragged, ops.temporal_decode_pm_ragged_plain),
                   "J": (ops.temporal_decode_rm, ops.temporal_decode_rm_plain)}[kernel]
    ref_caches = [c.clone() for c in caches]
    ref = run(plain, ref_caches, (kn, vn))
    got = run(kern, caches, (kn, vn))
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert (got.float() - ref.float()).abs().max().item() <= TOL[dtype]
    for mine, theirs in zip(caches, ref_caches):
        assert torch.equal(mine, theirs)
    if kv == torch.float32:  # bf16 values in an fp32 cache: the bf16 cache's bits
        same = [_randn((cap, rows, d), torch.bfloat16, s) for s in (254, 255)]
        assert torch.equal(run(kern, same, (kn.bfloat16(), vn.bfloat16())), got)


@pytest.mark.parametrize("pair", MIXED_PAIRS, ids=MIXED_IDS)
@pytest.mark.parametrize("chunks", [[16], [8, 8], [3, 5, 1, 7]])
def test_mixed_t1_stream_equals_chunked_appends_bitwise(pair, chunks):
    """On a cache of the other float type A = C no longer holds (the full
    clip attends unrounded keys); a t=1 stream through A equals, bit for
    bit, E fed the same frames in chunks on the same mixed cache."""
    dtype, kv = pair
    rows, heads, dh = 1568, 12, 64
    t = sum(chunks)
    d = heads * dh
    q = _randn((t, rows, d), dtype, 261)
    kn, vn = (_randn((t, rows, d), kv, s) for s in (262, 263))
    planes = [torch.zeros(t, rows, d, dtype=kv, device="cuda") for _ in range(4)]
    steps = [ops.temporal_decode_pm(q[i], kn[i], vn[i], *planes[:2],
                                    torch.tensor(i, dtype=torch.int32, device="cuda"), heads)
             for i in range(t)]
    start = 0
    for n in chunks:
        lens = torch.tensor([start], dtype=torch.int32, device="cuda")
        valid = torch.tensor([n], dtype=torch.int32, device="cuda")
        got = ops.temporal_append_pm_ragged(q[start:start + n], kn[start:start + n],
                                            vn[start:start + n], *planes[2:], lens, valid, rows,
                                            heads)
        assert torch.equal(got, torch.stack(steps[start:start + n])), start
        start += n
    assert torch.equal(planes[0], planes[2]) and torch.equal(planes[1], planes[3])


@pytest.mark.parametrize("dtype", DTYPES)
def test_non_causal_chunk_equals_the_non_causal_full_clip_bitwise(dtype):
    """A non-causal 16-frame append into an empty cache is the non-causal
    full clip of those frames: E = C bit for bit without the mask too."""
    rows, t, heads, dh = 1568, 16, 12, 64
    d = heads * dh
    q, k, v = (_randn((rows, t, d), dtype, s) for s in (271, 272, 273))
    full = ops.temporal_fullclip(q, k, v, heads, False)
    caches = [torch.zeros(t, rows, d, dtype=dtype, device="cuda") for _ in range(2)]
    zero = torch.zeros(1, dtype=torch.int32, device="cuda")
    got = ops.temporal_append_pm_ragged(*(x.transpose(0, 1).contiguous() for x in (q, k, v)),
                                        *caches, zero, zero + t, rows, heads, False)
    assert torch.equal(got, full.transpose(0, 1))


def _small_encoder(dtype, **kw):
    from streamformer_tpu_torch.config import StreamformerConfig
    from streamformer_tpu_torch.models import encoder

    cfg = StreamformerConfig(image_size=32, num_frames=8, hidden_size=96, num_hidden_layers=2,
                             num_attention_heads=4, intermediate_size=192, dtype=dtype, **kw)
    model = encoder.StreamformerEncoder(cfg, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for layer in model.encoder.layer:
            layer.temporal_attention_gating.fill_(0.5)
        emb = model.embeddings.time_embeddings
        emb.copy_(0.02 * torch.randn(emb.shape, generator=torch.Generator().manual_seed(1)))
    return model


def _frames(b, t, seed, dtype):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((b, t, 3, 32, 32)).astype(np.float32)).to(
        "cuda", dtype)


def test_streaming_remainders_launch_the_kernels():
    """The encoder's new streaming paths on the card launch E, A, D, J, F
    or G and never a plain version: non-causal chunks (linear, ring; on the
    int8 cache F or G a query), 40 frames a call, a mixed cache (t=1 and
    chunks), int8 partial appends; each against the same call on the CPU
    (the plain versions)."""
    from streamformer_tpu_torch.models import encoder

    cases = [
        ("non-causal linear", dict(enable_causal_temporal=False), {}, [3, 3], None,
         {"temporal_append_pm_ragged": 2}),
        ("non-causal ring", dict(enable_causal_temporal=False, cache_mode="ring",
                                 cache_capacity=4), {}, [3, 3, 6], None,
         {"temporal_append_pm_ragged": 3}),
        ("40 frames", dict(cache_capacity=48), {}, [1, 40], None,
         {"temporal_decode_pm": 1, "temporal_append_pm_ragged": 1}),
        ("mixed", dict(cache_dtype="bfloat16"), {}, [1, 3], None,
         {"temporal_decode_pm": 1, "temporal_append_pm_ragged": 1}),
        ("int8 new_valid", dict(cache_dtype="int8", cache_capacity=8), dict(per_stream_len=True),
         [3, 3], [[1, 3], [3, 2]], {"temporal_decode_pm_int8_ragged": 6}),
        ("non-causal int8 linear", dict(enable_causal_temporal=False, cache_dtype="int8",
                                        cache_capacity=8), {}, [3, 3], None,
         {"temporal_decode_pm_int8": 6}),
        ("non-causal int8 ragged", dict(enable_causal_temporal=False, cache_dtype="int8",
                                        cache_capacity=8), dict(per_stream_len=True), [3, 3], None,
         {"temporal_decode_pm_int8_ragged": 6}),
        ("non-causal int8 ring", dict(enable_causal_temporal=False, cache_dtype="int8",
                                      cache_mode="ring", cache_capacity=4), {}, [3, 6], None,
         {"temporal_decode_pm_int8": 9}),
    ]
    for name, kw, cache_kw, calls, valid, want in cases:
        model = _small_encoder("float32", **kw)
        cpu = encoder.StreamformerEncoder(model.cfg, device="cpu")
        cpu.load_state_dict(model.state_dict())
        px = _frames(2, sum(calls), 281, torch.float32)
        cache = model.init_cache(2, **cache_kw)
        cache_cpu = cpu.init_cache(2, **cache_kw)
        ops.reset_launches()
        lo = 0
        for i, t in enumerate(calls):
            nv = None if valid is None else torch.tensor(valid[i], dtype=torch.int32)
            got, cache = model.stream(px[:, lo:lo + t], cache,
                                      None if nv is None else nv.cuda())
            ref, cache_cpu = cpu.stream(px[:, lo:lo + t].cpu(), cache_cpu, nv)
            for b in range(2):
                v = t if nv is None else int(nv[b])
                err = (got["pooler_output"][b, :v].cpu() - ref["pooler_output"][b, :v]).abs()
                assert err.max().item() <= 1e-4, (name, i, b)
            lo += t
        torch.cuda.synchronize()
        launches = {k: v for k, v in ops.LAUNCHES.items() if v}
        layers = model.cfg.num_hidden_layers
        assert launches.pop("spatial_flat") == layers * len(calls), name
        assert launches == {k: v * layers for k, v in want.items()}, (name, launches)


# ---------------------------------------------------------------------------
# the data path on the card: the augmentations' applies and the loader
# ---------------------------------------------------------------------------

from streamformer_tpu_torch.data import collate  # noqa: E402
from streamformer_tpu_torch.data import rand_augment as RA  # noqa: E402
from streamformer_tpu_torch.data import random_erasing as RE  # noqa: E402
from streamformer_tpu_torch.data import transforms as T  # noqa: E402

AUG_SHAPE = (3, 4, 64, 96, 3)  # (B, T, H, W, C) uint8 clips
AUG_TOL = 1e-5  # card vs CPU, on the [0, 1] scale: summation order and 1-ulp cos/sin


def _clips(seed=0, shape=AUG_SHAPE):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8))


def _card_and_cpu(fn, *tensors, scale=255.0):
    """fn on the CPU and twice on the card: the card within AUG_TOL (on the
    [0, 1] scale) of the CPU, and its second run bit-equal to its first."""
    cpu = fn(*tensors)
    card = fn(*(t.cuda() for t in tensors))
    again = fn(*(t.cuda() for t in tensors))
    torch.cuda.synchronize()
    assert card.device.type == "cuda" and card.shape == cpu.shape and card.dtype == cpu.dtype
    assert torch.equal(card, again)
    err = ((card.cpu().double() - cpu.double()).abs().max() / scale).item()
    assert err <= AUG_TOL, err


AUG_APPLIES = {
    "adjust_brightness": lambda x: T.adjust_brightness(x, [0.4, 1.0, 1.6]),
    "adjust_contrast": lambda x: T.adjust_contrast(x, [0.4, 1.0, 1.6]),
    "adjust_saturation": lambda x: T.adjust_saturation(x, [0.4, 1.0, 1.6]),
    "adjust_sharpness": lambda x: T.adjust_sharpness(x, [0.4, 1.0, 1.6]),
    "invert": T.invert,
    "posterize": lambda x: T.posterize(x, [4, 6, 8]),
    "solarize": lambda x: T.solarize(x, [60.0, 128.0, 256.0]),
    "solarize_add": lambda x: T.solarize_add(x, [10.0, 40.0, 110.0]),
    "autocontrast": T.autocontrast,
    "equalize": T.equalize,
    "flip_where": lambda x: T.flip_where(x, [True, False, True]),
    "shear_x": lambda x: T.shear_x(x, [0.21, -0.3, 0.0]),
    "shear_y": lambda x: T.shear_y(x, [-0.17, 0.3, 0.05]),
    "translate_x": lambda x: T.translate_x(x, [-7.3, 20.0, 0.5]),
    "translate_y": lambda x: T.translate_y(x, [5.6, -12.0, 0.0]),
    "rotate": lambda x: T.rotate(x, [17.3, -30.0, 4.0]),
    "crop_at": lambda x: T.crop_at(x, [0, 5, 17], [3, 0, 40], (32, 48)),
    "resize_bilinear": lambda x: T.resize(x, (40, 52)),
    "resize_bicubic": lambda x: T.resize(x, (80, 120), "bicubic"),
    "resize_nearest": lambda x: T.resize(x, (33, 50), "nearest"),
}


@pytest.mark.parametrize("name", sorted(AUG_APPLIES))
def test_augmentation_applies_on_the_card_match_the_cpu(name):
    _card_and_cpu(lambda x: AUG_APPLIES[name](x.float()), _clips(1))


@pytest.mark.parametrize("name", RA.RAND_TRANSFORMS)
def test_rand_augment_ops_on_the_card_match_the_cpu(name):
    _card_and_cpu(lambda x: RA._apply_op(name, x.float(), [0.0, 5.3, 10.0], [True, False, True],
                                         {"inc": True}), _clips(2))


def test_resized_crop_and_erasing_on_the_card_match_the_cpu():
    boxes = [(0.0, 0.0, 64.0, 96.0), (3.25, 7.5, 20.0, 26.5), (10.0, 2.0, 50.0, 90.0)]
    _card_and_cpu(lambda x: T.resized_crop(x.float() / 255.0, boxes, (56, 56)), _clips(3),
                  scale=1.0)
    erase = [(1, 2, 10, 20), None, (30, 40, 30, 50)]
    noise = torch.from_numpy(np.random.default_rng(4).standard_normal((3, 4, 64, 96, 3))
                             .astype(np.float32))
    _card_and_cpu(lambda x, n: RE.apply_erasing(x.float(), erase, n), _clips(4), noise, scale=1.0)


def test_train_augment_on_the_card_matches_the_cpu():
    """The whole train augmentation (RandAugment m7 n4, resized crop to 56,
    flip, normalize, erasing) with one batch's draws, the erasing noise the
    CPU's, on the card and on the CPU."""
    aug = collate.make_train_augment(56, reprob=1.0)
    clips = _clips(5)
    draws = aug.draw(3, 11, [4, 9, 2], clips.shape[2], clips.shape[3])
    assert all(d["erase"] is not None for d in draws["samples"])
    fill = {}

    def fill_like(x, boxes, seeds, mode="pixel"):  # the CPU's noise on either device
        key = tuple(seeds)
        if key not in fill:
            fill[key] = real_fill(x.cpu(), boxes, seeds, mode)
        return fill[key].to(x.device)

    real_fill = RE.erasing_fill
    RE.erasing_fill = fill_like
    try:
        _card_and_cpu(lambda x: aug.apply(x, draws), clips, scale=1.0)
    finally:
        RE.erasing_fill = real_fill


def test_loader_feeds_the_trainer_on_the_card_from_pinned_memory():
    """A train-mode ``MultitaskLoader`` stages each uint8 batch in pinned
    memory, augments it on the card, and the trainer's micro-steps run the
    four training kernels on it."""
    import os

    os.environ.setdefault("STREAMFORMER_ALLOW_HASH_TOKENIZER", "1")
    from streamformer_tpu_torch.config import StreamformerConfig
    from streamformer_tpu_torch.data import datasets, samplers
    from streamformer_tpu_torch.models.multitask import MultitaskModel
    from streamformer_tpu_torch.models.text_encoder import SiglipTextConfig
    from streamformer_tpu_torch.train import optim
    from streamformer_tpu_torch.train.trainer import MultitaskTrainer, TrainState

    class Clips:
        task_name = "Kinetics"

        def __init__(self):
            self.frames = np.random.default_rng(6).integers(0, 256, (8, 4, 60, 80, 3),
                                                            dtype=np.uint8)

        def __len__(self):
            return len(self.frames)

        def __getitem__(self, i):
            return {"task_name": "Kinetics",
                    "task_input": {"frames": self.frames[i], "label": np.int64(i % 3)}}

    cfg = StreamformerConfig(image_size=48, num_frames=4, hidden_size=96, num_hidden_layers=2,
                             num_attention_heads=4, intermediate_size=192, dtype="bfloat16")
    text = SiglipTextConfig(vocab_size=100, hidden_size=96, num_hidden_layers=1,
                            num_attention_heads=4, intermediate_size=192,
                            max_position_embeddings=8)
    model = MultitaskModel(cfg, {"Kinetics": {"label2id": {"a": 0, "b": 1, "c": 2}}}, text,
                           generator=torch.Generator().manual_seed(0))
    model.prepare_for_multi_tasks()
    ds = datasets.MultiTaskDataset([Clips()])
    sampler = samplers.DistributedBatchTaskUniqueSampler(ds.task_specs(), 2)
    loader = collate.MultitaskLoader(ds, sampler, model, crop_size=48, num_workers=2)
    loader.set_epoch(0)
    _, host, _, _ = loader._collate_host([ds[0], ds[1]], [0, 1])
    assert host.is_pinned() and host.dtype == torch.uint8
    tx = optim.create_optimizer(model, optim.cosine_lr_schedule(1e-4, 1e-6, 1, 2),
                                trainable_mask=optim.trainable_mask_frozen_text(model))
    trainer = MultitaskTrainer(model, tx, update_freq=2)
    ops.reset_launches()
    state, stats = trainer.train_one_epoch(TrainState.create(model, tx), iter(loader), 0,
                                           torch.Generator(device="cuda").manual_seed(1))
    torch.cuda.synchronize()
    assert state.step == 2 and np.isfinite(stats["loss"])
    for name in ("spatial_flat", "temporal_fullclip", "spatial_flat_bwd", "temporal_fullclip_bwd"):
        assert ops.LAUNCHES[name] == 4 * cfg.num_hidden_layers, (name, dict(ops.LAUNCHES))


# ---- the language model and its engine (VideoQA's serving path): the card
# against the CPU at a small fp32 config. Tolerances: 1e-4 (fp32, summation
# order only); greedy tokens exactly.

from streamformer_tpu_torch.lm_serving import DecodeEngine  # noqa: E402
from streamformer_tpu_torch.models import language_model as LM  # noqa: E402
from streamformer_tpu_torch.ops import quant  # noqa: E402

LM_SMALL = LM.LMConfig(vocab_size=96, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                       num_attention_heads=8, num_key_value_heads=2, rope_theta=10000.0,
                       tie_word_embeddings=False, dtype="float32")


def _lm_pair(quantize=False):
    cpu = LM.LanguageModel(LM_SMALL, device="cpu", generator=torch.Generator().manual_seed(0))
    if quantize:
        quant.quantize_lm(cpu, min_elements=0)
    card = LM.LanguageModel(LM_SMALL, device="cuda")
    if quantize:
        quant.quantize_lm(card, min_elements=0)
    card.load_state_dict(cpu.state_dict())
    return cpu, card


@pytest.mark.parametrize("case", ["lockstep", "ragged", "int8_kv", "int4_kv", "int8_weights"])
def test_lm_forward_on_the_card_matches_the_cpu(case):
    """A prefill of 7 then a ragged step at depths 7, 3 and 0 (the last an
    append clamped at the capacity edge: length 16 of 16)."""
    cpu, card = _lm_pair(quantize=case == "int8_weights")
    cd = {"int8_kv": "int8", "int4_kv": "int4"}.get(case)
    emb = _randn((3, 7, 64), torch.float32, 1).cpu()
    step = _randn((3, 1, 64), torch.float32, 2).cpu()
    outs = []
    for m in (cpu, card):
        dev = m.device
        c = LM.init_cache(LM_SMALL, 3, 16, per_stream_len=case != "lockstep", cache_dtype=cd,
                          device=dev)
        o1, c = LM.forward(m, emb.to(dev), cache=c)
        if case != "lockstep":
            c["len"] = torch.tensor([7, 3, 16], device=dev)
        o2, c = LM.forward(m, step.to(dev), cache=c)
        outs.append((o1["logits"].cpu(), o2["logits"].cpu(), c["layers"][1]["v"].float().cpu()))
    for a, b in zip(*outs):
        assert (a - b).abs().max().item() <= 1e-4


def test_lm_scores_keep_fp32_accumulators_on_the_card():
    """A bf16 cache's scores come out of the product in fp32 (``out_dtype``),
    equal to the fp32 product of the bf16 values within fp32 summation
    order, not rounded to bf16."""
    q = _randn((4, 7, 128), torch.bfloat16, 3)
    k = _randn((4, 64, 128), torch.bfloat16, 4)
    s = LM._scores(q, k.transpose(1, 2))
    ref = torch.bmm(q.float(), k.float().transpose(1, 2))
    assert s.dtype == torch.float32 and (s - ref).abs().max().item() <= 1e-4
    assert (s - s.bfloat16().float()).abs().max().item() > 0


def test_bmm_out_dtype_has_no_backward_of_its_own():
    """Why ``_Scores`` exists: the card's ``torch.bmm(..., out_dtype=float32)``
    on bf16 inputs records no derivative. When this fails, torch has gained
    one and ``_Scores`` can go."""
    q = _randn((2, 3, 64), torch.bfloat16, 8).requires_grad_(True)
    k_t = _randn((2, 64, 5), torch.bfloat16, 9).requires_grad_(True)
    with pytest.raises(RuntimeError, match="not implemented"):
        torch.bmm(q, k_t, out_dtype=torch.float32).sum().backward()


def test_lm_scores_backward_on_the_card():
    """The card's fp32-out bf16 score product has no backward of its own;
    ``_Scores`` gives it one: q's and k's gradients equal the fp32 product's
    gradients of the same bf16 values, each rounded once to bf16."""
    q = _randn((4, 7, 64), torch.bfloat16, 5).requires_grad_(True)
    k_t = _randn((4, 64, 33), torch.bfloat16, 6).requires_grad_(True)
    g = _randn((4, 7, 33), torch.float32, 7)
    LM._scores(q, k_t).backward(g)
    qf, kf = (x.detach().float().requires_grad_(True) for x in (q, k_t))
    torch.bmm(qf, kf).backward(g)
    for got, ref in ((q.grad, qf.grad), (k_t.grad, kf.grad)):
        # one rounding to bf16: within half an ulp, 2**-8 relative
        assert got.dtype == torch.bfloat16
        assert ((got.float() - ref).abs() <= ref.abs() * 2.0**-8 + 1e-30).all()


@pytest.mark.parametrize("kw", [dict(), dict(decode_steps_per_tick=4),
                                dict(cache_dtype="int8"), dict(temperature=0.8, top_p=0.9)],
                         ids=["greedy", "k4", "int8_kv", "sampled"])
def test_decode_engine_on_the_card_matches_the_cpu(kw):
    """6 requests of 3-20 tokens over 3 slots, chunked prefill (buckets 4 and
    8), slot recycling: the same tokens on both devices (sampled too: the
    draws are a hash of (seed, sid, n), and fp32 logits agree far inside
    the Gumbel gaps at this size)."""
    cpu, card = _lm_pair()
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 96, (n,)) for n in (3, 11, 20, 5, 8, 2)]
    outs = []
    for m in (cpu, card):
        eng = DecodeEngine(m, slots=3, capacity=32, max_new_tokens=6, prefill_buckets=(4, 8),
                           seed=3, **kw)
        sids = [eng.open_tokens(p) for p in prompts]
        eng.run_until_idle()
        outs.append([eng.poll(s) for s in sids])
    assert outs[0] == outs[1]
    assert all(done and len(t) == 6 for t, done in outs[1])


# --------------------------------------------------------------------------
# The forward entries as torch.library ops (streamformer::<name>) on the card
# --------------------------------------------------------------------------


def _op_cases():
    from test_torch_library_ops import ENTRIES

    return sorted(ENTRIES)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", _op_cases())
def test_op_equals_the_launcher_bit_for_bit(name, dtype):
    """The op's CUDA implementation launches the same kernel as the entry
    called directly: equal outputs and cache writes, one launch each."""
    from test_torch_library_ops import ENTRIES, op_inputs

    direct, via_op = op_inputs(name, "cuda", dtype), op_inputs(name, "cuda", dtype)
    counted = {"temporal_append_pm_qkv": "temporal_append_pm_ragged",
               "temporal_fullclip_qkv": "temporal_fullclip"}.get(name, name)
    before = ops.LAUNCHES[counted]
    want = getattr(ops, ENTRIES[name])(*direct)
    got = ops.OPS[name](*via_op)
    torch.cuda.synchronize()
    assert ops.LAUNCHES[counted] == before + 2
    assert torch.equal(got, want)
    for a, b in zip(direct, via_op):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)


@pytest.mark.parametrize("name", _op_cases())
def test_opcheck_on_the_card(name):
    from test_torch_library_ops import op_inputs

    result = torch.library.opcheck(ops.OPS[name], op_inputs(name, "cuda", torch.bfloat16))
    assert set(result.values()) == {"SUCCESS"}, result


# ---------------------------------------------------------------------------
# The rank shape of model parallelism 2: half the heads of the flagship
# ---------------------------------------------------------------------------

MP2 = dict(rows=1568, per_stream=196, cap=16, heads=6, dh=64)
MP2_LENS = [0, 1, 5, 9, 14, 15, 15, 15]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel", ["A", "D", "E", "F", "G", "J", "K"])
def test_decode_kernels_at_the_mp2_rank_shape(kernel, dtype):
    """A, D, E, F, G, J and K on one rank's cache of the flagship cut over
    two ranks (6 heads of 64, R=1568, C=16): within the tolerance of their
    plain versions, the cache writes equal, one launch each."""
    from streamformer_tpu_torch.models import encoder

    rows, ps, cap, heads, dh = (MP2[k] for k in ("rows", "per_stream", "cap", "heads", "dh"))
    d = heads * dh
    length = torch.tensor(cap - 1, dtype=torch.int32, device="cuda")
    lens = torch.tensor(MP2_LENS, dtype=torch.int32, device="cuda")
    q, kn, vn = (_randn((rows, d), dtype, s) for s in (61, 62, 63))
    kc, vc = _randn((cap, rows, d), dtype, 64), _randn((cap, rows, d), dtype, 65)
    if kernel in ("F", "G"):
        new, cache = _int8_operands(rows, cap, d, 66)
        args = (q, *new, *cache)
    elif kernel in ("J", "K"):
        kc, vc = kc.transpose(0, 1).contiguous(), vc.transpose(0, 1).contiguous()
    if kernel == "K":
        (kq, ks), (vq, vs) = (encoder.quantize_kv_heads(x.float(), heads) for x in (kc, vc))
        cache = [kq, vq, ks, vs]
        args = (q, *cache)
    name, plain, extra = {
        "A": ("temporal_decode_pm", None, (length, heads)),
        "D": ("temporal_decode_pm_ragged", None, (lens, ps, heads)),
        "F": ("temporal_decode_pm_int8", None, (length, heads)),
        "G": ("temporal_decode_pm_int8_ragged", None, (lens, ps, heads)),
        "J": ("temporal_decode_rm", None, (length, heads)),
        "K": ("temporal_decode_rm_readonly", None, (length, heads)),
        "E": ("temporal_append_pm_ragged", None, None),
    }[kernel]
    if kernel == "E":
        t, valid = 8, torch.tensor([8, 0, 8, 8, 3, 4, 1, 0], dtype=torch.int32, device="cuda")
        lens = torch.tensor([0, 1, 5, 8, 8, 12, 15, 16], dtype=torch.int32, device="cuda")
        q, kn, vn = (_randn((t, rows, d), dtype, s) for s in (67, 68, 69))
        args, extra = (q, kn, vn, kc, vc), (lens, valid, ps, heads)
        cache = [kc, vc]
    elif kernel in ("A", "D", "J"):
        args, cache = (q, kn, vn, kc, vc), [kc, vc]
    ref_args = [a.clone() for a in args]
    ref = getattr(ops, name + "_plain")(*ref_args, *extra)
    before = ops.LAUNCHES[name]
    got = getattr(ops, name)(*args, *extra)
    torch.cuda.synchronize()
    assert ops.LAUNCHES[name] == before + 1
    if kernel == "E":
        for b, n in enumerate(valid.tolist()):
            sl = slice(b * ps, (b + 1) * ps)
            if n:
                assert (got[:n, sl].float() - ref[:n, sl].float()).abs().max().item() \
                    <= TOL[dtype], b
    else:
        assert (got.float() - ref.float()).abs().max().item() <= TOL[dtype]
    n_cache = len(cache)
    for mine, theirs in zip(args[-n_cache:], ref_args[-n_cache:]):
        assert torch.equal(mine, theirs)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pair", ["D=A", "G=F"])
def test_ragged_rows_equal_lone_streams_at_the_mp2_rank_shape(pair, dtype):
    """D = lone A and G = lone F, bit for bit, at 6 heads of 64 (one body
    each, and a launch plan first tuned at 12 heads)."""
    rows, ps, cap, heads, dh = (MP2[k] for k in ("rows", "per_stream", "cap", "heads", "dh"))
    d = heads * dh
    q = _randn((rows, d), dtype, 71)
    if pair == "D=A":
        kn, vn = _randn((rows, d), dtype, 72), _randn((rows, d), dtype, 73)
        new = (kn, vn)
        cache = [_randn((cap, rows, d), dtype, 74), _randn((cap, rows, d), dtype, 75)]
        ragged, lone = ops.temporal_decode_pm_ragged, ops.temporal_decode_pm
    else:
        new, cache = _int8_operands(rows, cap, d, 76)
        ragged, lone = ops.temporal_decode_pm_int8_ragged, ops.temporal_decode_pm_int8
    whole = [c.clone() for c in cache]
    got = ragged(q, *new, *whole, torch.tensor(MP2_LENS, dtype=torch.int32, device="cuda"), ps,
                 heads)
    for b, length in enumerate(MP2_LENS):
        sl = slice(b * ps, (b + 1) * ps)
        mine = [c[:, sl].contiguous() for c in cache]
        want = lone(q[sl].contiguous(), *(x[sl].contiguous() for x in new), *mine,
                    torch.tensor(length, dtype=torch.int32, device="cuda"), heads)
        assert torch.equal(got[sl], want), b
        for w, m in zip(whole, mine):
            assert torch.equal(w[:, sl], m), b


def test_tp_ring_stream_on_two_ranks_of_one_card(tmp_path):
    """The tensor-parallel ring stream (``tools.tp_stream``: two gloo ranks
    on the one card, mp = 2) against the same stream in one process, fp32:
    each rank's pooled output within 1e-4 on a float cache and on an int8
    cache (there also at cosine above 0.999, chip_smoke.py's gate), A or F
    L times a frame on each. The same ranks first serve uint8 streams over
    a (2, 1) mesh (two slots a rank, polls broadcast from the owner) and run
    the full clip exported over (1, 2), each within 1e-4 of one process."""
    from streamformer_tpu_torch.config import StreamformerConfig
    from streamformer_tpu_torch.models import encoder
    from streamformer_tpu_torch.serving import StreamingEngine
    from streamformer_tpu_torch.tools import tp_stream

    cfg = StreamformerConfig(image_size=64, num_frames=8, hidden_size=256, num_hidden_layers=2,
                             num_attention_heads=4, intermediate_size=512, dtype="float32")
    model = encoder.StreamformerEncoder(cfg, device="cuda",
                                        generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for layer in model.encoder.layer:
            layer.temporal_attention_gating.fill_(0.5)
    ckpt = str(tmp_path / "ckpt")
    cfg.save_pretrained(ckpt)
    torch.save({k: v.cpu() for k, v in model.state_dict().items()},
               os.path.join(ckpt, "pytorch_model.bin"))
    video = _randn((2, 10, 3, 64, 64), torch.float32, 81)
    torch.save(video.cpu(), str(tmp_path / "video.pt"))
    rng = np.random.default_rng(35)
    clips = [rng.integers(0, 256, (int(n), 3, 64, 64), dtype=np.uint8)
             for n in rng.integers(2, 9, 6)]
    torch.save({"clips": clips, "slots": 4, "tick_frames": (1, 3), "burst_ticks": 2,
                "export_layers": 1}, str(tmp_path / "serve.pt"))
    ranks = tp_stream.launch(2, ckpt, str(tmp_path / "video.pt"), str(tmp_path), capacity=4,
                             cache_dtypes=("float", "int8"), serve=str(tmp_path / "serve.pt"))
    # the engine over (2, 1), two slots a rank, against the one-process engine; the
    # program exported over (1, 2) against the one-process clip and the rank's live one
    cut = encoder.StreamformerEncoder(cfg.replace(num_hidden_layers=1), device="cuda")
    cut.load_state_dict({k: v for k, v in model.state_dict().items() if k in cut.state_dict()})
    clip = encoder.model_forward(cut, video)
    for frames in (1, 3):
        eng = StreamingEngine(model, slots=4, mode="linear", stage_dtype="uint8")
        feats, ticks = tp_stream.engine_run(eng, clips, frames, 2)
        for rank in ranks:
            got = rank["serve"]["engine"][frames]
            assert got["ticks"] == ticks and got["local_slots"] == 2
            assert got["launches"]["temporal_decode_pm_ragged" if frames == 1 else
                                   "temporal_append_pm_ragged"] > 0
            assert max(float(np.abs(a - b).max()) for a, b in zip(got["feats"], feats)) <= 1e-4
    for rank in ranks:
        got = rank.pop("serve")["export"]
        assert got["mesh"] == {"data": 1, "model": 2}
        assert got["launches"]["spatial_flat"] == 1 and got["launches"]["temporal_fullclip"] == 1
        for key in ("last_hidden_state", "pooler_output"):
            assert (got[key] - clip[key].cpu()).abs().max().item() <= 1e-4
            assert got["vs_live"][key] <= 1e-4
    ones = tp_stream.reference(model, video, 4, ("float", "int8"))
    for name in ("float", "int8"):
        want = ones[name][0]
        kernel = "temporal_decode_pm" if name == "float" else "temporal_decode_pm_int8"
        for rank in ranks:
            res = rank[name]
            assert res["width"] == 128
            assert res["launches"][kernel] == 2 * 10 and res["launches"]["spatial_flat"] == 2 * 10
            # the int8 ranks at the float gate too: their codes and row scales are
            # the one-process cache's (the row absmax MAX-reduced over the group)
            assert (res["pooled"] - want).abs().max().item() <= 1e-4
            if name == "int8":
                cos = torch.nn.functional.cosine_similarity(res["pooled"].flatten(),
                                                            want.flatten(), dim=0)
                assert cos.item() > 0.999


# ---------------------------------------------------------------------------
# Kernel M: MSDeformAttn's forward and backward (ops/msdeform_attn.py), against
# the plain version on the card and the native CPU oracle on CPU copies
# ---------------------------------------------------------------------------

from streamformer_tpu_torch import native  # noqa: E402
from streamformer_tpu_torch.ops import msdeform_attn as MSDA  # noqa: E402

# (batch, queries, heads, channels, points, levels, location range)
M_CASES = {
    # the OVIS step's at 2 frames of 224^2: an adapter extractor (the backbone's
    # 14^2 tokens) and a pixel decoder layer (7^2, 14^2, 28^2, a query a position)
    "adapter": (2, 1029, 12, 64, 4, [(14, 14)], (-0.1, 1.1)),
    "pixel_decoder": (2, 1029, 8, 32, 4, [(7, 7), (14, 14), (28, 28)], (-0.1, 1.1)),
    "outside": (2, 96, 4, 32, 4, [(9, 11), (5, 6)], (-0.8, 1.8)),
    "five_levels": (1, 50, 2, 32, 3, [(8, 8), (6, 7), (4, 4), (2, 3), (1, 1)], (-0.1, 1.1)),
    "d24": (2, 40, 3, 24, 4, [(6, 6), (3, 3)], (-0.1, 1.1)),
    # past the 16 levels of M's argument struct: the level table on the device
    "eighteen_levels": (1, 30, 2, 32, 2, [(3, 2 + i % 3) for i in range(18)], (-0.1, 1.1)),
    "no_queries": (2, 0, 4, 32, 4, [(6, 6), (3, 3)], (-0.1, 1.1)),
}


def _m_inputs(case, dtype, seed):
    b, q, m, d, p, shapes, (lo, hi) = M_CASES[case]
    rng = np.random.default_rng(seed)
    s = sum(h * w for h, w in shapes)
    weight = rng.random((b, q, m, len(shapes) * p)).astype(np.float32)
    weight /= np.maximum(weight.sum(-1, keepdims=True), 1e-6)
    arrays = (rng.standard_normal((b, s, m, d)), rng.uniform(lo, hi, (b, q, m, len(shapes), p, 2)),
              weight.reshape(b, q, m, len(shapes), p), rng.standard_normal((b, q, m * d)))
    return shapes, [torch.from_numpy(np.asarray(x, np.float32)).to("cuda", dtype) for x in arrays]


def _off_kinks(loc, shapes):
    """Where a location's pixel coordinate lies at least 1e-4 from an
    integer: at an integer the bilinear sample's derivative in that
    coordinate jumps (another cell's corners), so two right implementations
    whose coordinates differ in the last bit may give either one-sided
    derivative there."""
    size = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float64, device=loc.device)
    pos = loc.double() * size[:, None, :] - 0.5
    return (pos - pos.round()).abs() >= 1e-4


def _m_errors(got, want, loc, shapes):
    """Max-abs error of the output; the gradients' against max(1, the
    gradient's largest) (the weights' is a sum over D, the locations' carries
    the map's width), the locations' off the kinks."""
    keep = _off_kinks(loc, shapes).cpu()
    got, want = [x.float().cpu() for x in got], [x.float().cpu() for x in want]
    errs = [(got[0] - want[0]).abs().max().item()]
    for i, (a, b) in enumerate(zip(got[1:], want[1:])):
        diff = (a - b).abs()
        if i == 1:
            diff = torch.where(keep, diff, torch.zeros_like(diff))
        errs.append(diff.max().item() / max(1.0, b.abs().max().item()))
    return errs, int((~keep).sum())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(M_CASES))
def test_ms_deform_attn_matches_plain_and_the_native_oracle(dtype, case):
    """M's output and its three gradients through ``ms_deform_attn_core`` (the
    ``autograd.Function``) against the plain version in fp32 on the same
    inputs (bf16 inputs upcast: ``grid_sample`` in bf16 rounds the grid
    itself) and against the native CPU oracle on CPU copies."""
    shapes, (value, loc, weight, grad_out) = _m_inputs(case, dtype, 91)
    before = dict(ops.LAUNCHES)
    args = [x.clone().requires_grad_() for x in (value, loc, weight)]
    out = MSDA.ms_deform_attn_core(args[0], shapes, args[1], args[2])
    assert type(out.grad_fn).__name__ == "MSDeformAttnCoreBackward"
    out.backward(grad_out)
    torch.cuda.synchronize()
    got = [out.detach()] + [a.grad for a in args]
    for x, like in zip(got, (grad_out, value, loc, weight)):
        assert x.shape == like.shape and x.dtype == dtype
    launched = int(loc.shape[1] > 0)
    assert ops.LAUNCHES["ms_deform_attn"] == before["ms_deform_attn"] + launched
    assert ops.LAUNCHES["ms_deform_attn_bwd"] == before["ms_deform_attn_bwd"] + launched
    if not launched:
        assert not got[1].any()
        return
    v, l_, w, g = (x.float() for x in (value, loc, weight, grad_out))
    plain = [MSDA.ms_deform_attn_core_plain(v, shapes, l_, w),
             *MSDA.ms_deform_attn_core_backward_plain(v, shapes, l_, w, g)]
    arrays = [x.float().cpu().numpy() for x in (value, loc, weight, grad_out)]
    oracle = [torch.from_numpy(native.ms_deform_attn_forward_np(arrays[0], shapes, *arrays[1:3])),
              *map(torch.from_numpy, native.ms_deform_attn_backward_np(arrays[0], shapes,
                                                                       *arrays[1:]))]
    for want in (plain, oracle):
        errs, kinks = _m_errors(got, want, l_, shapes)
        assert max(errs) <= TOL[dtype], (errs, kinks)


def test_ms_deform_attn_backward_entry_matches_the_function():
    """The backward's own entry (chip_smoke's backward row) equals the
    ``autograd.Function``'s gradients bit for bit when the sums run in one
    order (fp32, no two samples of a value element in one call: one query)."""
    shapes = [(5, 6)]
    rng = np.random.default_rng(92)
    value, loc, weight, grad_out = (
        torch.from_numpy(x.astype(np.float32)).cuda() for x in
        (rng.standard_normal((1, 30, 2, 32)), rng.uniform(0, 1, (1, 1, 2, 1, 1, 2)),
         rng.random((1, 1, 2, 1, 1)), rng.standard_normal((1, 1, 64))))
    args = [x.clone().requires_grad_() for x in (value, loc, weight)]
    MSDA.ms_deform_attn_core(args[0], shapes, args[1], args[2]).backward(grad_out)
    for a, b in zip(MSDA.ms_deform_attn_core_backward(value, shapes, loc, weight, grad_out), args):
        assert torch.equal(a, b.grad)


@pytest.mark.parametrize("bad", ["float64", "mixed", "half"])
def test_ms_deform_attn_refuses_other_types(bad):
    shapes, (value, loc, weight, _) = _m_inputs("d24", torch.float32, 93)
    if bad == "float64":
        value, loc, weight = value.double(), loc.double(), weight.double()
    elif bad == "mixed":
        value = value.bfloat16()
    else:
        value, loc, weight = value.half(), loc.half(), weight.half()
    with pytest.raises(TypeError, match="torch.float64|torch.bfloat16|torch.float16"):
        MSDA.ms_deform_attn_core(value, shapes, loc, weight)
