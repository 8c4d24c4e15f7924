"""Times of the t=1 decode kernels (A, D, J, F, G, and the read-only K), of
the full-clip kernels C and H, of the multi-frame append E, of the spatial
kernels B, L and I, and of the lockstep streaming step, on the card.

Run from the root of a checkout on a machine with a CUDA card:

    python -m streamformer_tpu_torch.tools.decode_timing --label change

To time another checkout's kernels on the same inputs, run this file by its
path with that checkout first on ``PYTHONPATH`` (the wrappers it calls keep
one signature across the port's slices); each checkout builds its own
kernels under its own ``build/``. Two checkouts timed in one call, in the
order a, b, b, a, compare on one card. ``--kernels C,H --no-streaming``
times the full-clip kernels alone, ``--kernels E,Eqkv,K,Kf`` the append and
the read-only decode, ``--kernels B,L,I`` the spatial kernels.

It prints one JSON object a line, each tagged with ``--label``:

- a kernel row for each kernel, dtype (bf16 and fp32) and capacity (16 and
  64) at the flagship shape (1568 rows, 12 heads of 64; A, J, F at length
  C-1, D and G at eight streams of 196 rows; C and H on (1568, 16, 768)
  rows, and, where the checkout has it, the packed entry on the (8, 16,
  196, 2304) qkv as ``Cqkv`` and ``Hqkv``): ``device_ms``, the kernel's own
  time a call (``torch.profiler`` over 15 calls, L2 flushed before each);
  ``call_ms``, the median of CUDA events around the wrapper over the same 15
  calls (host work included); ``host_us``, the host's time a call over 200
  calls queued back to back (the launch path alone: 200 calls do not fill
  the launch queue, so the host never waits for the card). C, H, E and K
  rows also carry ``plain_ms`` (the plain version) and ``sdpa_ms`` (one
  ``scaled_dot_product_attention`` call on the same function, or its
  backward; K's on the dequantized cache), by CUDA events in the same way,
  and ``bound_ms``, the bytes moved once at 3.35 TB/s. E is one throughput
  tick's call (t=8, eight streams of 196 rows at lens 0-16, or 0-64 at
  capacity 64, some valid partially) on (t, R, D) rows, and ``Eqkv`` the
  packed entry on the same frames as an (8, 8, 196, 2304) qkv, where the
  checkout has it; K reads an int8 cache with (R, C, H) scales, ``Kf`` a
  float one, at length C-1. B, L and I run on the full clip's (128, 196,
  768) rows (L head-split) and carry the same extra keys (SDPA, or its
  backward for I). A checkout whose E refuses capacity 64 prints
  ``"refused"`` for that row;
- a streaming row: the flagship encoder (bf16, seeded random weights, batch
  8, ring cache C=16) over 32 steady steps, three times: frames/s and
  ms/step by the host's clock.

Every kernel row also carries ``device_launches``, ``device_ms_min`` and
``device_ms_max``: the launches the profile recorded and the shortest and
longest of them. ``--mixed`` times A, D and J on the mixed pairs instead
(fp32 queries on a bf16 cache and bf16 queries on an fp32 cache; the row's
``cache_dtype`` says which) with their ``bound_ms``: the bytes each
function moves (queries, new rows and outputs once, the cached rows below
each length once, the appended rows once) at 3.35 TB/s. ``--repeat N``
prints each kernel row N times. ``--engine`` adds engine rows: the serving
engine on the flagship encoder (bf16, 8 slots, linear cache C=16, a bf16
and an fp32 cache), each slot fed 16 frames, drained by ticks of 1 frame
(t=1 steps) and of 8 frames (kernel E's chunks), three times each:
frames/s by the host's clock.

``--long`` prints, in place of the rows above, the decode kernels past
their body's shared-memory plan (the scores of a row in a scratch): F, G
(one stream), J and K (int8 codes) and ``Kf`` (bf16) at R=196 and C=8192,
length C-1, bf16 queries, drawn on the card, each with ``plain_ms``,
``sdpa_ms`` (on the dequantized cache) and ``bound_ms`` as above; a
checkout that refuses the capacity prints ``"refused"``.

``--tiled`` prints, in place of the rows above, one row for each shape
PERF.md keeps for csrc/tiled.cuh's kernels: C's forward and H's backward on
the packed qkv of one 300-frame clip (past the whole-row plan), E past its
whole-table plan (R=8 at capacity 60000 and t=1; R=196 at capacity 4096 and
t=16) and at 64 frames (R=392, causal and not), E forced onto tiled.cuh at
the flagship throughput tick, and fp32 B, L and I at R=64 N=576 and forced
at R=128 N=196 ("forced": ``ops._body_smem`` patched to 0); all bf16 but B,
L and I. Each row has ``device_ms`` and ``call_ms`` as above, over every
kernel whose symbol holds ``tiled`` (every launch of these calls), and
``kernels``, each kernel's own device ms a call (its mean launch times its
launches a call).

``--bwd-plans`` prints, in place of the rows above, csrc/tiled.cuh's
backward on each of its plans (``ops._tiled_bwd_plan`` patched: the query
side keeping its scores and dp in shared memory or sweeping, the key side
recomputing s and dp or reading the stored p and ds) for H at T=300 and
fp32 I at R=64 N=576 and forced at R=128 N=196, and on the sweeping plans
past shared memory for H on the packed qkv (1, 1700, 16, 2304) and fp32 I
at R=8 N=1568; each row as ``--tiled``'s, with ``plan``.
"""

import argparse
import json
import statistics
import time
from typing import List, Optional

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from streamformer_tpu_torch.config import StreamformerConfig
from streamformer_tpu_torch.models import encoder
from streamformer_tpu_torch.ops import attention as ops

DEVICE = "cuda"
ROWS, HEADS, DH, PER_STREAM = 1568, 12, 64, 196
D_LENS = {16: [0, 1, 5, 9, 14, 15, 15, 15], 64: [0, 4, 20, 36, 56, 63, 63, 63]}
SYMBOLS = {"A": "temporal_decode_pm_kernel", "D": "temporal_decode_pm_kernel",
           "J": "temporal_decode_pm_kernel", "F": "temporal_decode_pm_int8_kernel",
           "G": "temporal_decode_pm_int8_kernel", "C": "temporal_fullclip_kernel",
           "H": "temporal_fullclip_bwd_kernel", "Cqkv": "temporal_fullclip_kernel",
           "Hqkv": "temporal_fullclip_bwd_kernel", "E": "temporal_append_pm_kernel",
           "Eqkv": "temporal_append_pm_kernel", "K": "temporal_decode_rm_kernel",
           "Kf": "temporal_decode_rm_kernel", "B": "spatial_flat",
           "L": "spatial_flat", "I": "spatial_flat_bwd"}
FULLCLIP = ("C", "H", "Cqkv", "Hqkv")
SPATIAL = ("B", "L", "I")
WITH_YARDSTICKS = FULLCLIP + SPATIAL + ("E", "Eqkv", "K", "Kf")
CLIP_ROWS, PATCHES = 128, 196  # B, L, I: the full clip's 8 x 16 rows of 196 patches
# E: a throughput tick's lens by capacity, and valid (chip_smoke.py's E_LENS, E_VALID)
E_LENS = {16: [0, 1, 5, 8, 8, 12, 15, 16], 64: [0, 9, 20, 33, 40, 51, 60, 64]}
E_VALID, E_T = [8, 0, 8, 8, 3, 4, 1, 0], 8
BATCH, FRAMES = 8, 16  # the full clip: 1568 rows are 8 clips of 196 patches
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet


def fullclip_operands(kernel: str, dtype: torch.dtype, seed: int):
    """C or H (or their packed entry) on seeded operands: the wrapper's call,
    its plain version's, and one causal scaled_dot_product_attention call's
    (its backward for H; None for the packed entry), each without
    arguments; and the bytes moved once."""
    rng = np.random.default_rng(seed)
    d = HEADS * DH

    def card(shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(DEVICE, dtype)

    q, k, v, g = (card((ROWS, FRAMES, d)) for _ in range(4))
    nbytes = (4 if kernel.startswith("C") else 7) * ROWS * FRAMES * d * q.element_size()
    heads = [x.view(ROWS, FRAMES, HEADS, DH).transpose(1, 2) for x in (q, k, v, g)]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if kernel == "C":
        return (lambda: ops.temporal_fullclip(q, k, v, HEADS),
                lambda: ops.temporal_fullclip_plain(q, k, v, HEADS),
                lambda: sdpa(*heads[:3], is_causal=True), nbytes)
    if kernel == "H":
        sdpa_in = [x.detach().requires_grad_() for x in heads[:3]]
        sdpa_out = sdpa(*sdpa_in, is_causal=True)
        return (lambda: ops.temporal_fullclip_bwd(q, k, v, g, HEADS),
                lambda: ops.temporal_fullclip_bwd_plain(q, k, v, g, HEADS),
                lambda: torch.autograd.grad(sdpa_out, sdpa_in, heads[3], retain_graph=True),
                nbytes)

    def packed(x):  # (B*N, T, D) rows -> (B, T, N, D)
        return x.view(BATCH, PER_STREAM, FRAMES, -1).transpose(1, 2)

    qkv = torch.cat([packed(x) for x in (q, k, v)], -1)
    gp = packed(g).contiguous()
    if kernel == "Cqkv":
        return (lambda: ops.temporal_fullclip_qkv(qkv, HEADS),
                lambda: ops.temporal_fullclip_qkv_plain(qkv, HEADS), None, nbytes)
    return (lambda: ops.temporal_fullclip_qkv_bwd(qkv, gp, HEADS),
            lambda: ops.temporal_fullclip_qkv_bwd_plain(qkv, gp, HEADS), None, nbytes)


def spatial_operands(kernel: str, dtype: torch.dtype, seed: int):
    """B, L (head-split) or I on the full clip's (128, 196, 768) rows: the
    wrapper's call, its plain version's, one scaled_dot_product_attention
    call's (its backward for I), and the bytes moved once."""
    rng = np.random.default_rng(seed)
    d = HEADS * DH

    def card(shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(DEVICE, dtype)

    q, k, v, g = (card((CLIP_ROWS, PATCHES, d)) for _ in range(4))
    nbytes = (7 if kernel == "I" else 4) * CLIP_ROWS * PATCHES * d * q.element_size()
    heads = [x.view(CLIP_ROWS, PATCHES, HEADS, DH).transpose(1, 2) for x in (q, k, v, g)]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if kernel == "B":
        return (lambda: ops.spatial_flat(q, k, v, HEADS),
                lambda: ops.spatial_flat_plain(q, k, v, HEADS), lambda: sdpa(*heads[:3]), nbytes)
    if kernel == "L":
        split = [x.contiguous() for x in heads[:3]]
        return (lambda: ops.spatial_attention(*split),
                lambda: ops.spatial_attention_plain(*split), lambda: sdpa(*split), nbytes)
    sdpa_in = [x.detach().requires_grad_() for x in heads[:3]]
    sdpa_out = sdpa(*sdpa_in)
    return (lambda: ops.spatial_flat_bwd(q, k, v, g, HEADS),
            lambda: ops.spatial_flat_bwd_plain(q, k, v, g, HEADS),
            lambda: torch.autograd.grad(sdpa_out, sdpa_in, heads[3], retain_graph=True), nbytes)


def append_operands(kernel: str, dtype: torch.dtype, cap: int, seed: int):
    """E (or its packed entry) on seeded operands: the wrapper's call, its
    plain version's, one masked scaled_dot_product_attention call's, and
    the bytes moved once."""
    rng = np.random.default_rng(seed)
    d = HEADS * DH

    def card(shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(DEVICE, dtype)

    q, kn, vn = (card((E_T, ROWS, d)) for _ in range(3))
    kc, vc = card((cap, ROWS, d)), card((cap, ROWS, d))
    lens = torch.tensor(E_LENS[cap], dtype=torch.int32, device=DEVICE)
    valid = torch.tensor(E_VALID, dtype=torch.int32, device=DEVICE)
    n_old = sum(min(x, cap) for x in E_LENS[cap])
    nbytes = q.element_size() * PER_STREAM * d * (2 * n_old + 4 * E_T * BATCH + 2 * sum(E_VALID))
    ti = torch.arange(E_T, device=DEVICE)
    old = torch.arange(cap, device=DEVICE)[None, None] < lens.long().repeat_interleave(
        PER_STREAM)[:, None, None]
    mask = torch.cat([old.expand(ROWS, E_T, cap),
                      (ti[None] <= ti[:, None]).expand(ROWS, E_T, E_T)], -1)[:, None]
    q4 = q.view(E_T, ROWS, HEADS, DH).permute(1, 2, 0, 3)
    k4, v4 = (torch.cat([c, n]).view(cap + E_T, ROWS, HEADS, DH).permute(1, 2, 0, 3)
              for c, n in ((kc, kn), (vc, vn)))
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask)
    if kernel == "E":
        return (lambda: ops.temporal_append_pm_ragged(q, kn, vn, kc, vc, lens, valid, PER_STREAM,
                                                      HEADS),
                lambda: ops.temporal_append_pm_ragged_plain(q, kn, vn, kc, vc, lens, valid,
                                                            PER_STREAM, HEADS), sdpa, nbytes)
    qkv = torch.cat([q, kn, vn], -1).view(E_T, BATCH, PER_STREAM, 3 * d).transpose(0, 1)
    qkv = qkv.contiguous()
    return (lambda: ops.temporal_append_pm_qkv(qkv, kc, vc, lens, valid, PER_STREAM, HEADS),
            lambda: ops.temporal_append_pm_qkv_plain(qkv, kc, vc, lens, valid, PER_STREAM, HEADS),
            sdpa, nbytes)


def readonly_operands(kernel: str, dtype: torch.dtype, cap: int, seed: int):
    """K at length C-1 on an int8 cache with (R, C, H) scales ("K") or a
    float cache in q's dtype ("Kf"): the wrapper's call, its plain
    version's, one scaled_dot_product_attention call's on the (dequantized)
    cache, and the bytes moved once."""
    rng = np.random.default_rng(seed)
    d = HEADS * DH
    q = torch.from_numpy(rng.standard_normal((ROWS, d), np.float32)).to(DEVICE, dtype)
    length = cap - 1
    if kernel == "K":
        codes = [torch.from_numpy(rng.integers(-127, 128, (ROWS, cap, d), np.int8)).to(DEVICE)
                 for _ in range(2)]
        scales = [torch.from_numpy(rng.uniform(0.005, 0.03, (ROWS, cap, HEADS)).astype(
            np.float32)).to(DEVICE) for _ in range(2)]
        args = (*codes, *scales)
        dense = [(c.view(ROWS, cap, HEADS, DH).float() * s[..., None]).to(dtype)
                 for c, s in zip(codes, scales)]
        nbytes = q.element_size() * ROWS * d * 2 + 2 * ROWS * (length + 1) * (d + 4 * HEADS)
    else:
        dense = [torch.from_numpy(rng.standard_normal((ROWS, cap, d), np.float32)).to(DEVICE, dtype)
                 for _ in range(2)]
        args = (*dense, None, None)
        nbytes = q.element_size() * ROWS * d * (2 + 2 * (length + 1))
    ln = torch.tensor(length, dtype=torch.int32, device=DEVICE)
    q4 = q.view(ROWS, HEADS, 1, DH)
    k4, v4 = (x.view(ROWS, cap, HEADS, DH).transpose(1, 2) for x in dense)
    window = (torch.arange(cap, device=DEVICE) <= length).view(1, cap)
    return (lambda: ops.temporal_decode_rm_readonly(q, *args, ln, HEADS),
            lambda: ops.temporal_decode_rm_readonly_plain(q, *args, ln, HEADS),
            lambda: torch.nn.functional.scaled_dot_product_attention(q4, k4, v4,
                                                                     attn_mask=window),
            nbytes)


def events_ms(fn, flush: torch.Tensor) -> float:
    """Median of CUDA events around 15 calls, L2 flushed before each."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(15):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def operands(kernel: str, dtype: torch.dtype, cap: int, seed: int,
             kv_dtype: Optional[torch.dtype] = None):
    """A no-argument call of the kernel's wrapper on seeded operands; A, D
    and J's new rows and cache in ``kv_dtype`` (default ``dtype``)."""
    rng = np.random.default_rng(seed)
    d = HEADS * DH
    kv_dtype = kv_dtype or dtype

    def card(x, dt):
        return torch.from_numpy(np.ascontiguousarray(x)).to(DEVICE, dt)

    q = card(rng.standard_normal((ROWS, d), np.float32), dtype)
    ragged = kernel in ("D", "G")
    lens = card(np.array(D_LENS[cap] if ragged else cap - 1, np.int32), torch.int32)
    if kernel in ("F", "G"):
        new = [card(rng.integers(-127, 128, (ROWS, d)), torch.int8) for _ in range(2)]
        new_scales = [card(rng.uniform(0.005, 0.03, ROWS), torch.float32) for _ in range(2)]
        codes = [card(rng.integers(-127, 128, (cap, ROWS, d)), torch.int8) for _ in range(2)]
        scales = [card(rng.uniform(0.005, 0.03, (cap, ROWS)), torch.float32) for _ in range(2)]
        args = (q, *new, *new_scales, *codes, *scales, lens)
        if ragged:
            return lambda: ops.temporal_decode_pm_int8_ragged(*args, PER_STREAM, HEADS)
        return lambda: ops.temporal_decode_pm_int8(*args, HEADS)
    new = [card(rng.standard_normal((ROWS, d), np.float32), kv_dtype) for _ in range(2)]
    shape = (ROWS, cap, d) if kernel == "J" else (cap, ROWS, d)
    caches = [card(rng.standard_normal(shape, np.float32), kv_dtype) for _ in range(2)]
    if kernel == "J":
        return lambda: ops.temporal_decode_rm(q, *new, *caches, lens, HEADS)
    if ragged:
        return lambda: ops.temporal_decode_pm_ragged(q, *new, *caches, lens, PER_STREAM, HEADS)
    return lambda: ops.temporal_decode_pm(q, *new, *caches, lens, HEADS)


def decode_bytes(kernel: str, dtype: torch.dtype, kv_dtype: torch.dtype, cap: int) -> int:
    """Bytes A, D or J moves: the queries and outputs, the new K/V rows read
    and appended, and the cached rows below each length (A and J at C-1, D
    at ``D_LENS``)."""
    eq, ekv = torch.finfo(dtype).bits // 8, torch.finfo(kv_dtype).bits // 8
    d = HEADS * DH
    lens = D_LENS[cap] if kernel == "D" else [cap - 1]
    read = sum(min(x, cap - 1) for x in lens) * (ROWS // len(lens))
    return ROWS * d * (2 * eq + 4 * ekv) + 2 * ekv * d * read


def profile_calls(fn, flush: torch.Tensor, symbol: str):
    """15 calls of fn under ``torch.profiler``, L2 flushed before each: the
    profile's device rows whose kernel name holds ``symbol``, the device ms
    of each such launch, and the median of CUDA events around the calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a profile late in a run may come back without the kernel's rows
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            calls = []
            for _ in range(15):
                flush.zero_()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                calls.append((start, end))
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
                and symbol in e.key and e.device_time_total > 0]
        if rows:
            break
    else:
        raise SystemExit(f"decode_timing: no device time for {symbol}")
    launches = [e.device_time_total / 1e3 for e in prof.events()
                if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
                and symbol in e.name]
    return rows, launches, statistics.median(s.elapsed_time(e) for s, e in calls)


def per_call_ms(rows, calls: int = 15) -> float:
    """Device ms a call from a profile of ``calls`` calls: each kernel's mean
    launch times its launches a call (a kernel may launch more than once a
    call, as tiled.cuh's backward over chunks of its scratch)."""
    return sum(e.device_time_total / e.count * max(1, round(e.count / calls))
               for e in rows) / 1e3


def kernel_row(kernel: str, dtype: torch.dtype, cap: int, flush: torch.Tensor,
               kv_dtype: Optional[torch.dtype] = None) -> dict:
    extra = {}
    if kv_dtype is not None:
        extra = {"cache_dtype": str(kv_dtype).split(".")[-1],
                 "bound_ms": decode_bytes(kernel, dtype, kv_dtype, cap) / HBM_BYTES_PER_S * 1e3}
    if kernel in WITH_YARDSTICKS:
        if kernel in FULLCLIP:
            fn, plain, sdpa, nbytes = fullclip_operands(kernel, dtype, seed=FRAMES)
        elif kernel in SPATIAL:
            fn, plain, sdpa, nbytes = spatial_operands(kernel, dtype, seed=PATCHES)
        elif kernel.startswith("E"):
            fn, plain, sdpa, nbytes = append_operands(kernel, dtype, cap, seed=cap)
        else:
            fn, plain, sdpa, nbytes = readonly_operands(kernel, dtype, cap, seed=cap)
        try:
            fn()
        except NotImplementedError:  # an earlier E: capacity + t past its 32 keys
            return {"kernel": kernel, "dtype": str(dtype).split(".")[-1], "capacity": cap,
                    "refused": True}
        extra = {"plain_ms": events_ms(plain, flush),
                 "sdpa_ms": None if sdpa is None else events_ms(sdpa, flush),
                 "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
    else:
        fn = operands(kernel, dtype, cap, seed=cap, kv_dtype=kv_dtype)
    rows, launches, call_ms = profile_calls(fn, flush, SYMBOLS[kernel])
    device_ms = per_call_ms(rows)
    n = 200
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return {"kernel": kernel, "dtype": str(dtype).split(".")[-1], "capacity": cap,
            "device_ms": device_ms, "call_ms": call_ms, "host_us": host_us,
            "device_launches": len(launches), "device_ms_min": min(launches, default=None),
            "device_ms_max": max(launches, default=None), **extra}


LONG_ROWS, LONG_CAP = 196, 8192  # --long: batch 1 at the flagship width, past the decode plan


def long_operands(kernel: str, gen: torch.Generator):
    """``--long``'s F, G, J, K or Kf at length C-1 on operands drawn on the
    card: the wrapper's call, its plain version's, one masked
    scaled_dot_product_attention call's on the (dequantized) cache, and the
    bytes the function moves (every input read once, the output and the
    appended rows written once)."""
    r, c, d, dt = LONG_ROWS, LONG_CAP, HEADS * DH, torch.bfloat16
    length = c - 1

    def draw(*shape):
        return torch.randn(*shape, device=DEVICE, generator=gen).to(dt)

    def codes(*shape):
        return torch.randint(-127, 128, shape, device=DEVICE, generator=gen, dtype=torch.int8)

    def scales(*shape):
        return torch.rand(*shape, device=DEVICE, generator=gen) * 0.025 + 0.005

    q = draw(r, d)
    ln = torch.tensor(length, dtype=torch.int32, device=DEVICE)
    window = (torch.arange(c, device=DEVICE) <= length).view(1, c)
    q4 = q.view(r, HEADS, 1, DH)
    if kernel in ("F", "G"):
        new, new_s = [codes(r, d) for _ in range(2)], [scales(r) for _ in range(2)]
        planes, plane_s = [codes(c, r, d) for _ in range(2)], [scales(c, r) for _ in range(2)]
        args = (q, *new, *new_s, *planes, *plane_s, ln.reshape(1) if kernel == "G" else ln)
        dense = [torch.cat([(p[:length].float() * s[:length, :, None]),
                            (n.float() * ns[:, None])[None]]).to(dt).view(c, r, HEADS, DH)
                 .permute(1, 2, 0, 3) for p, s, n, ns in zip(planes, plane_s, new, new_s)]
        nbytes = 2 * r * d * 2 + 2 * (length * r * (d + 4)) + 2 * 2 * r * (d + 4)
        if kernel == "G":
            return (lambda: ops.temporal_decode_pm_int8_ragged(*args, r, HEADS),
                    lambda: ops.temporal_decode_pm_int8_ragged_plain(*args, r, HEADS),
                    lambda: torch.nn.functional.scaled_dot_product_attention(q4, *dense),
                    nbytes)
        return (lambda: ops.temporal_decode_pm_int8(*args, HEADS),
                lambda: ops.temporal_decode_pm_int8_plain(*args, HEADS),
                lambda: torch.nn.functional.scaled_dot_product_attention(q4, *dense), nbytes)
    if kernel == "J":
        new, caches = [draw(r, d) for _ in range(2)], [draw(r, c, d) for _ in range(2)]
        dense = [torch.cat([x[:, :length], n[:, None]], 1).view(r, c, HEADS, DH).transpose(1, 2)
                 for x, n in zip(caches, new)]
        nbytes = 2 * (6 * r * d + 2 * r * length * d)
        return (lambda: ops.temporal_decode_rm(q, *new, *caches, ln, HEADS),
                lambda: ops.temporal_decode_rm_plain(q, *new, *caches, ln, HEADS),
                lambda: torch.nn.functional.scaled_dot_product_attention(q4, *dense), nbytes)
    if kernel == "K":
        cs, ss = [codes(r, c, d) for _ in range(2)], [scales(r, c, HEADS) for _ in range(2)]
        args = (*cs, *ss)
        dense = [(x.view(r, c, HEADS, DH).float() * y[..., None]).to(dt).transpose(1, 2)
                 for x, y in zip(cs, ss)]
        nbytes = 2 * r * d * 2 + 2 * r * (length + 1) * (d + 4 * HEADS)
    else:
        dense_rm = [draw(r, c, d) for _ in range(2)]
        args = (*dense_rm, None, None)
        dense = [x.view(r, c, HEADS, DH).transpose(1, 2) for x in dense_rm]
        nbytes = 2 * r * d * (2 + 2 * (length + 1))
    return (lambda: ops.temporal_decode_rm_readonly(q, *args, ln, HEADS),
            lambda: ops.temporal_decode_rm_readonly_plain(q, *args, ln, HEADS),
            lambda: torch.nn.functional.scaled_dot_product_attention(q4, *dense,
                                                                     attn_mask=window),
            nbytes)


def long_rows(flush: torch.Tensor) -> List[dict]:
    """``--long``'s rows (see the module's docstring)."""
    out = []
    gen = torch.Generator(device=DEVICE).manual_seed(21)
    with torch.no_grad():
        for kernel in ("F", "G", "J", "K", "Kf"):
            fn, plain, sdpa, nbytes = long_operands(kernel, gen)
            row = {"kernel": kernel, "dtype": "bfloat16", "rows": LONG_ROWS,
                   "capacity": LONG_CAP}
            try:
                fn()
            except ValueError:  # a checkout whose decode body refuses the capacity
                out.append({**row, "refused": True})
                continue
            rows, launches, call_ms = profile_calls(fn, flush, SYMBOLS[kernel])
            out.append({**row, "device_ms": per_call_ms(rows),
                        "call_ms": call_ms, "device_launches": len(launches),
                        "plain_ms": events_ms(plain, flush), "sdpa_ms": events_ms(sdpa, flush),
                        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3})
            del fn, plain, sdpa
            torch.cuda.empty_cache()
    return out


def tiled_calls(gen):
    """(name, call, forced onto tiled.cuh) for each of ``--tiled``'s rows."""
    heads, d = HEADS, HEADS * DH

    def draw(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, device=DEVICE, generator=gen).to(dtype)

    def append_call(t, per_stream, lens, valid, cap, causal=True):
        rows = per_stream * len(lens)
        q, kn, vn = (draw(t, rows, d) for _ in range(3))
        kc, vc = (draw(cap, rows, d) for _ in range(2))
        lens_t, valid_t = (torch.tensor(x, dtype=torch.int32, device=DEVICE)
                           for x in (lens, valid))
        return lambda: ops.temporal_append_pm_ragged(q, kn, vn, kc, vc, lens_t, valid_t,
                                                     per_stream, heads, causal)

    qkv, g = draw(1, 300, PATCHES, 3 * d), draw(1, 300, PATCHES, d)
    yield "C qkv (1, 300, 196, 2304) T=300", lambda: ops.temporal_fullclip_qkv(qkv, heads), False
    yield ("H qkv (1, 300, 196, 2304) T=300",
           lambda: ops.temporal_fullclip_qkv_bwd(qkv, g, heads), False)
    yield "E R=8 C=60000 len 59999 t=1", append_call(1, 8, [59999], [1], 60000), False
    yield "E R=196 C=4096 len 4080 t=16", append_call(16, PATCHES, [4080], [16], 4096), False
    for causal in (True, False):
        yield (f"E R=392 C=64 t=64 {'causal' if causal else 'non-causal'}",
               append_call(64, PATCHES, [0, 0], [64, 64], 64, causal), False)
    yield "E R=1568 C=16 t=8 forced", append_call(E_T, PER_STREAM, E_LENS[16], E_VALID, 16), True
    for r, n, forced in ((64, 576, False), (128, 196, True)):
        q, k, v, go = (draw(r, n, d, dtype=torch.float32) for _ in range(4))
        split = [x.view(r, n, heads, DH).transpose(1, 2).contiguous() for x in (q, k, v)]
        tag = f"R={r} N={n} fp32" + (" forced" if forced else "")
        yield f"B {tag}", lambda q=q, k=k, v=v: ops.spatial_flat(q, k, v, heads), forced
        yield f"L {tag}", lambda s=split: ops.spatial_attention(*s), forced
        yield (f"I {tag}", lambda q=q, k=k, v=v, go=go: ops.spatial_flat_bwd(q, k, v, go, heads),
               forced)


def tiled_rows(flush: torch.Tensor) -> List[dict]:
    """``--tiled``'s rows (see the module's docstring)."""
    body_smem, out = ops._body_smem, []
    with torch.no_grad():
        for name, fn, forced in tiled_calls(torch.Generator(device=DEVICE).manual_seed(20)):
            if forced:
                ops._body_smem = lambda *a: 0
            try:
                rows, _, call_ms = profile_calls(fn, flush, "tiled")
            finally:
                ops._body_smem = body_smem
            kernels = {e.key.replace("(anonymous namespace)::", "").split("(")[0].replace(
                "void ", ""): per_call_ms([e]) for e in rows}
            out.append({"row": name, "device_ms": sum(kernels.values()), "call_ms": call_ms,
                        "kernels": kernels})
            torch.cuda.empty_cache()
    return out


def bwd_plan_rows(flush: torch.Tensor) -> List[dict]:
    """``--bwd-plans``' rows (see the module's docstring)."""
    gen = torch.Generator(device=DEVICE).manual_seed(21)
    heads, d = HEADS, HEADS * DH

    def draw(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, device=DEVICE, generator=gen).to(dtype)

    past = {"sweeps": ops._BWD_SWEEPS, "sweeps+stored": ops._BWD_SWEEPS | ops._BWD_STORED}
    near = {"resident": 0, "stored": ops._BWD_STORED, **past}
    cases = []
    for t, n, plans in ((300, PATCHES, near), (1700, 16, past)):
        qkv, g = draw(1, t, n, 3 * d), draw(1, t, n, d)
        cases.append((f"H qkv (1, {t}, {n}, 2304) T={t}", plans, False,
                      lambda qkv=qkv, g=g: ops.temporal_fullclip_qkv_bwd(qkv, g, heads)))
    for r, n, forced, plans in ((64, 576, False, near), (128, 196, True, near),
                                (8, 1568, False, past)):
        q, k, v, go = (draw(r, n, d, dtype=torch.float32) for _ in range(4))
        cases.append((f"I R={r} N={n} fp32" + (" forced" if forced else ""), plans, forced,
                      lambda q=q, k=k, v=v, go=go: ops.spatial_flat_bwd(q, k, v, go, heads)))
    body_smem, bwd_plan, out = ops._body_smem, ops._tiled_bwd_plan, []
    with torch.no_grad():
        for name, plans, forced, fn in cases:
            for label, plan in plans.items():
                if forced:
                    ops._body_smem = lambda *a: 0
                ops._tiled_bwd_plan = lambda *a, p=plan: p
                try:
                    rows, _, call_ms = profile_calls(fn, flush, "tiled")
                finally:
                    ops._body_smem, ops._tiled_bwd_plan = body_smem, bwd_plan
                kernels = {e.key.replace("(anonymous namespace)::", "").split("(")[0].replace(
                    "void ", ""): per_call_ms([e]) for e in rows}
                out.append({"row": name, "plan": label, "device_ms": sum(kernels.values()),
                            "call_ms": call_ms, "kernels": kernels})
                torch.cuda.empty_cache()
    return out


def streaming_row() -> dict:
    cfg = StreamformerConfig(dtype="bfloat16", cache_capacity=16)
    model = encoder.StreamformerEncoder(cfg, device="cpu",
                                        generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for layer in model.encoder.layer:
            layer.temporal_attention_gating.fill_(0.5)
    model = model.to("cuda")
    batch = 8
    video = torch.randn(batch, 16, 3, 224, 224, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(0))
    cache = encoder.init_cache(cfg, batch)
    for i in range(16):
        encoder.streaming_forward(model, video[:, i:i + 1], cache)
    torch.cuda.synchronize()
    steps, rates = 32, []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(steps):
            encoder.streaming_forward(model, video[:, :1], cache)
        torch.cuda.synchronize()
        rates.append(batch * steps / (time.perf_counter() - t0))
    return {"streaming_frames_per_s": rates, "ms_per_step": [batch * 1e3 / r for r in rates]}


def engine_rows() -> List[dict]:
    """The serving engine on the flagship encoder, a bf16 and an fp32 cache,
    drained by ticks of 1 and of 8 frames (see the module's docstring)."""
    from streamformer_tpu_torch.serving import StreamingEngine

    base = StreamformerConfig(dtype="bfloat16", cache_capacity=16, cache_mode="linear")
    weights = encoder.StreamformerEncoder(base, device="cpu",
                                          generator=torch.Generator().manual_seed(0)).state_dict()
    slots, frames = 8, 16
    clips = np.random.default_rng(0).standard_normal(
        (slots, frames, 3, base.image_size, base.image_size)).astype(np.float32)
    rows = []
    for cache_dtype in (None, "float32"):
        model = encoder.StreamformerEncoder(base.replace(cache_dtype=cache_dtype), device="cuda")
        model.load_state_dict(weights)
        eng = StreamingEngine(model, slots=slots, mode="linear")
        rates = {1: [], 8: []}
        for _ in range(4):  # the first round warms up and is dropped
            for tick in (1, 8):
                for clip in clips:
                    sid = eng.open()
                    eng.feed(sid, clip)
                    eng.close(sid)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                eng.run_until_idle(frames=tick)
                torch.cuda.synchronize()
                rates[tick].append(slots * frames / (time.perf_counter() - t0))
        rows.append({"engine_cache_dtype": cache_dtype or "bfloat16",
                     "tick1_frames_per_s": rates[1][1:], "tick8_frames_per_s": rates[8][1:]})
        del eng, model
        torch.cuda.empty_cache()
    return rows


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--label", default="this checkout")
    parser.add_argument("--no-streaming", action="store_true", help="kernel rows only")
    parser.add_argument("--kernels", default="A,D,J,F,G,C,H,Cqkv,Hqkv",
                        help="comma-separated, of " + ", ".join(SYMBOLS))
    parser.add_argument("--mixed", action="store_true",
                        help="A, D and J on the mixed pairs (fp32 q, bf16 cache; bf16 q, fp32 "
                             "cache)")
    parser.add_argument("--repeat", type=int, default=1, help="times to print each kernel row")
    parser.add_argument("--engine", action="store_true", help="add the engine's tick rows")
    parser.add_argument("--tiled", action="store_true",
                        help="only the rows of csrc/tiled.cuh's kernels")
    parser.add_argument("--long", action="store_true",
                        help="only the decode kernels past their body's shared-memory plan")
    parser.add_argument("--bwd-plans", action="store_true",
                        help="only csrc/tiled.cuh's backward, on each of its plans")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("decode_timing: needs a CUDA device")
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    if args.tiled or args.long or args.bwd_plans:
        rows = tiled_rows if args.tiled else long_rows if args.long else bwd_plan_rows
        for row in rows(flush):
            print(json.dumps({"label": args.label, **row}), flush=True)
        return
    pairs = ([(torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)] if args.mixed
             else [(torch.bfloat16, None), (torch.float32, None)])
    for kernel in args.kernels.split(","):
        entry = {"Cqkv": "temporal_fullclip_qkv", "Hqkv": "temporal_fullclip_qkv",
                 "Eqkv": "temporal_append_pm_qkv"}.get(kernel)
        if entry and not hasattr(ops, entry):
            continue  # a checkout from before the packed entry
        if args.mixed and kernel not in ("A", "D", "J"):
            raise SystemExit(f"decode_timing: --mixed times A, D and J, not {kernel}")
        for dtype, kv_dtype in pairs:
            for cap in ((FRAMES,) if kernel in FULLCLIP + SPATIAL else (16, 64)):
                for _ in range(args.repeat):
                    row = kernel_row(kernel, dtype, cap, flush, kv_dtype)
                    print(json.dumps({"label": args.label, **row}), flush=True)
    if args.engine:
        for row in engine_rows():
            print(json.dumps({"label": args.label, **row}), flush=True)
    if not args.no_streaming:
        print(json.dumps({"label": args.label, **streaming_row()}), flush=True)


if __name__ == "__main__":
    main()
