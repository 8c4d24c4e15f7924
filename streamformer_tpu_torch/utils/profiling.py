"""Tracing, timing and FLOP accounting.

The port of the JAX package's ``utils/profiling.py``:

* ``trace(logdir)``: a ``torch.profiler`` window over everything inside the
  context, the card's kernels included, written as a Chrome trace
  (``logdir/trace.json``);
* ``timed(fn, ...)``: seconds a call of ``fn`` by CUDA events after a
  synchronize on the card (the median of ``reps`` timed runs of ``iters``
  calls).

Both measure the card unless the caller names the CPU, and raise when no
card is present: nothing falls back to the host clock on its own.
* ``encoder_flops``, ``streaming_step_flops``: the JAX package's analytic
  FLOP counts, unchanged; ``mfu`` divides by the H100's dense bf16 peak
  (989 TFLOP/s) unless told another.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time
from typing import Callable

import torch

H100_BF16_TFLOPS = 989.0  # H100 SXM, dense bf16 on the tensor cores (NVIDIA data sheet)


def _on_card(device) -> bool:
    """True for a CUDA ``device``; raises when it names a card and none is
    present."""
    cuda = torch.device(device).type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available to measure; pass device='cpu' to "
                           "profile or time on the host")
    return cuda


@contextlib.contextmanager
def trace(logdir: str, device="cuda"):
    """Profile everything inside the context: the CPU's ops and the card's
    kernels, or the CPU's ops only when ``device`` is the CPU. The Chrome
    trace goes to ``logdir/trace.json``. Yields the profiler, whose
    ``key_averages()`` tables the same window."""
    from torch.profiler import ProfilerActivity, profile

    cuda = _on_card(device)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def timed(fn: Callable[[], object], iters: int = 10, warmup: int = 2, reps: int = 3,
          device="cuda") -> float:
    """Seconds a call of ``fn``: ``warmup`` calls, then the median over
    ``reps`` runs of ``iters`` calls each. On the card each run is timed by
    CUDA events recorded after a synchronize, so it covers the device work
    of its calls and nothing queued before; by the host clock only when
    ``device`` is the CPU."""
    cuda = _on_card(device)
    for _ in range(warmup):
        fn()
    runs = []
    for _ in range(reps):
        if cuda:
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            runs.append(start.elapsed_time(end) / 1e3 / iters)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            runs.append((time.perf_counter() - t0) / iters)
    return statistics.median(runs)


def encoder_flops(cfg, batch: int, frames: int) -> float:
    """Analytic forward FLOPs of the divided space-time encoder."""
    d, m = cfg.hidden_size, cfg.intermediate_size
    n = cfg.num_patches
    tokens = batch * frames * n
    per_token_layer = 2 * d * (3 * d + d) * 2 + 2 * d * d + 2 * 2 * d * m
    proj = tokens * per_token_layer * cfg.num_hidden_layers
    spatial_attn = 4 * batch * frames * n * n * d * cfg.num_hidden_layers
    temporal_attn = 4 * batch * n * frames * frames * d * cfg.num_hidden_layers
    patchify = 2 * tokens * (cfg.patch_size**2 * cfg.num_channels) * d
    return float(proj + spatial_attn + temporal_attn + patchify)


def mfu(cfg, batch: int, frames: int, seconds: float,
        peak_tflops: float = H100_BF16_TFLOPS) -> float:
    """Model FLOPs utilization of a full-clip forward of ``seconds`` against
    the card's peak (the H100's dense bf16 by default)."""
    return encoder_flops(cfg, batch, frames) / seconds / (peak_tflops * 1e12)


def streaming_step_flops(cfg, batch: int, context: int, t_new: int = 1) -> float:
    """Analytic FLOPs of one streaming encode step (t_new frames appended,
    temporal attention over ``context`` cached and new positions): patchify,
    each layer's projections (temporal and spatial qkv and out,
    ``temporal_dense``, the MLP), the two attention products, and the MAP
    pooling head."""
    d, m, n, layers = (cfg.hidden_size, cfg.intermediate_size, cfg.num_patches,
                       cfg.num_hidden_layers)
    tokens = batch * t_new * n
    per_token_layer = 2 * d * (3 * d + d) * 2 + 2 * d * d + 2 * 2 * d * m
    proj = tokens * per_token_layer * layers
    spatial_attn = 4 * batch * t_new * n * n * d * layers
    temporal_attn = 4 * batch * n * t_new * context * d * layers
    patchify = 2 * tokens * (cfg.patch_size**2 * cfg.num_channels) * d
    map_head = batch * t_new * (2 * 2 * n * d * d + 2 * d * d + 4 * d * m + 4 * n * d)
    return float(proj + spatial_attn + temporal_attn + patchify + map_head)
