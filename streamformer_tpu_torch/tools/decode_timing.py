"""Times of the t=1 decode kernels (A, D, J, F, G), of the full-clip kernels
C and H, and of the lockstep streaming step, on the card.

Run from the root of a checkout on a machine with a CUDA card:

    python -m streamformer_tpu_torch.tools.decode_timing --label change

To time another checkout's kernels on the same inputs, run this file by its
path with that checkout first on ``PYTHONPATH`` (the wrappers it calls keep
one signature across the port's slices); each checkout builds its own
kernels under its own ``build/``. Two checkouts timed in one call, in the
order a, b, b, a, compare on one card. ``--kernels C,H --no-streaming``
times the full-clip kernels alone.

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
  the launch queue, so the host never waits for the card). C and H rows
  also carry ``plain_ms`` (the plain version) and ``sdpa_ms`` (one causal
  ``scaled_dot_product_attention`` call, or its backward), by CUDA events
  in the same way, and ``bound_ms``, the bytes moved once at 3.35 TB/s;
- a streaming row: the flagship encoder (bf16, seeded random weights, batch
  8, ring cache C=16) over 32 steady steps, three times: frames/s and
  ms/step by the host's clock.
"""

import argparse
import json
import statistics
import time

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
           "Hqkv": "temporal_fullclip_bwd_kernel"}
FULLCLIP = ("C", "H", "Cqkv", "Hqkv")
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


def operands(kernel: str, dtype: torch.dtype, cap: int, seed: int):
    """A no-argument call of the kernel's wrapper on seeded operands."""
    rng = np.random.default_rng(seed)
    d = HEADS * DH

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
    new = [card(rng.standard_normal((ROWS, d), np.float32), dtype) for _ in range(2)]
    shape = (ROWS, cap, d) if kernel == "J" else (cap, ROWS, d)
    caches = [card(rng.standard_normal(shape, np.float32), dtype) for _ in range(2)]
    if kernel == "J":
        return lambda: ops.temporal_decode_rm(q, *new, *caches, lens, HEADS)
    if ragged:
        return lambda: ops.temporal_decode_pm_ragged(q, *new, *caches, lens, PER_STREAM, HEADS)
    return lambda: ops.temporal_decode_pm(q, *new, *caches, lens, HEADS)


def kernel_row(kernel: str, dtype: torch.dtype, cap: int, flush: torch.Tensor) -> dict:
    extra = {}
    if kernel in FULLCLIP:
        fn, plain, sdpa, nbytes = fullclip_operands(kernel, dtype, seed=FRAMES)
        extra = {"plain_ms": events_ms(plain, flush),
                 "sdpa_ms": None if sdpa is None else events_ms(sdpa, flush),
                 "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
    else:
        fn = operands(kernel, dtype, cap, seed=cap)
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
                and SYMBOLS[kernel] in e.key and e.device_time_total > 0]
        if rows:
            break
    else:
        raise SystemExit(f"decode_timing: no device time for {SYMBOLS[kernel]}")
    device_ms = sum(e.device_time_total / e.count for e in rows) / 1e3
    call_ms = statistics.median(s.elapsed_time(e) for s, e in calls)
    n = 200
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return {"kernel": kernel, "dtype": str(dtype).split(".")[-1], "capacity": cap,
            "device_ms": device_ms, "call_ms": call_ms, "host_us": host_us, **extra}


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


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--label", default="this checkout")
    parser.add_argument("--no-streaming", action="store_true", help="kernel rows only")
    parser.add_argument("--kernels", default="A,D,J,F,G,C,H,Cqkv,Hqkv",
                        help="comma-separated, of " + ", ".join(SYMBOLS))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("decode_timing: needs a CUDA device")
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    for kernel in args.kernels.split(","):
        if kernel.endswith("qkv") and not hasattr(ops, "temporal_fullclip_qkv"):
            continue  # a checkout from before the packed entry
        for dtype in (torch.bfloat16, torch.float32):
            for cap in ((FRAMES,) if kernel in FULLCLIP else (16, 64)):
                row = kernel_row(kernel, dtype, cap, flush)
                print(json.dumps({"label": args.label, **row}), flush=True)
    if not args.no_streaming:
        print(json.dumps({"label": args.label, **streaming_row()}), flush=True)


if __name__ == "__main__":
    main()
