#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and hold each of its
kernels against its plain PyTorch version.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases, each fatal on failure:

1. the card's name and power limit (nvidia-smi), and the build of the three
   kernels from ``streamformer_tpu_torch/csrc`` (one nvcc each, in parallel);
2. each kernel against its plain version at the flagship shapes, bf16 and
   fp32 (kernel A linear and ring), with its time, the plain version's
   time, one ``scaled_dot_product_attention`` call's time (a yardstick the
   port never calls) and the bound (the card's least time for the bytes
   and operations);
3. the whole encoder on the card against the same encoder on the CPU (the
   plain versions) at a small fp32 config: full clip, a linear stream and a
   ring stream of 2C frames;
4. ``from_pretrained`` on a checkpoint written from seeded random weights at
   the flagship width (768 hidden, 12 layers, 12 heads, 224x224, T=16,
   bf16), then ``model_forward`` at batch 8;
5. 16 frames through ``streaming_forward`` on a linear cache of capacity
   16, each frame held to the full clip within the bf16 envelope the JAX
   package accepts on its chip (0.078 hidden, 0.008 pooled);
6. a ring stream of 2C frames (C=8), kernel A held against its plain
   version on the ring's cache;
7. streaming frames/s at batch 8 at steady state (ring, capacity 16), and
   the device time by kernel over a profiled window.

The launch counters are zeroed just before phase 4's forward and read after
phase 5: every kernel must have run on the main path. The last two lines are
the ``{"kernels": [...]}`` summary and ``{"ok": true, "device": {...}}``.
Without a CUDA device, or outside a checkout, it exits non-zero and prints
neither.
"""

import json
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor core; fp32 CUDA cores
TOL = {"bfloat16": 2e-2, "float32": 2e-5}  # kernel vs plain, max-abs (tests/test_torch_cuda.py)
STREAM_TOL_HIDDEN, STREAM_TOL_POOLED = 0.078, 0.008
CARD_VS_CPU_TOL = 1e-4  # fp32 encoder, card vs CPU: summation order only
SOURCES = {
    "temporal_decode_pm": ("streamformer_tpu_torch/csrc/temporal_decode_pm.cu",
                           "streamformer_tpu/ops/attention.py:662"),
    "spatial_flat": ("streamformer_tpu_torch/csrc/spatial_flat.cu",
                     "streamformer_tpu/ops/attention.py:1531"),
    "temporal_fullclip": ("streamformer_tpu_torch/csrc/temporal_fullclip.cu",
                          "streamformer_tpu/ops/attention.py:1335"),
}
# flagship: batch, frames, patches (224/16 squared), hidden, heads, cache capacity
FLAGSHIP = dict(batch=8, frames=16, patches=196, hidden=768, heads=12, capacity=16)
FLAGSHIP_CONFIG = dict(dtype="bfloat16")  # the config's defaults are the flagship widths
SMALL_CONFIG = dict(image_size=48, num_frames=4, hidden_size=96, num_hidden_layers=3,
                    num_attention_heads=4, intermediate_size=192, dtype="float32")
RING_CAPACITY = 8
DEVICE = "cuda"


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import torch.nn.functional as F
    from streamformer_tpu_torch.checkpoint import from_pretrained
    from streamformer_tpu_torch.config import StreamformerConfig
    from streamformer_tpu_torch.models import encoder
    from streamformer_tpu_torch.ops import attention as ops
    from streamformer_tpu_torch.ops import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)  # > the 50 MB L2

    # ---- 1. card and build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(smi)
    t0 = time.perf_counter()
    build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc, sm_90a, 3 sources in parallel)")

    def time_ms(fn, iters=15):
        """Median device time of one call, L2 flushed before each."""
        for _ in range(3):
            fn()
        times = []
        for _ in range(iters):
            flush.zero_()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        torch.cuda.synchronize()
        return statistics.median(times)

    def bound(nbytes, flops, dtype_name):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype_name]
        return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"

    def randn(*shape, dtype):
        return torch.randn(*shape, device=dev, generator=gen).to(dtype)

    def max_err(a, b):
        return (a.float().cpu() - b.float().cpu()).abs().max().item()

    def finite(out):
        return all(torch.isfinite(x).all().item() for x in out.values())

    # ---- 2. kernels against their plain versions at flagship shapes
    b_, t_, n_, d_, h_, cap = (FLAGSHIP[k] for k in
                               ("batch", "frames", "patches", "hidden", "heads", "capacity"))
    dh = d_ // h_
    results = {}

    def record(name, shape_tag, dtype_name, err, fn, plain, library, nbytes, flops):
        tol = TOL[dtype_name]
        if not err <= tol:
            fail(f"{name} {shape_tag} {dtype_name}: max-abs error {err} > {tol}")
        ms, plain_ms, lib_ms = time_ms(fn), time_ms(plain), time_ms(library)
        bound_ms, bound_by = bound(nbytes, flops, dtype_name)
        row = dict(name=name, shape=shape_tag, dtype=dtype_name, max_abs_err=err, tol=tol, ms=ms,
                   plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by)
        print("kernel " + json.dumps(row))
        results[(name, shape_tag, dtype_name)] = row

    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        elt = torch.finfo(dtype).bits // 8
        # A: one streaming step, linear (len C-1) and ring (len past C)
        r = b_ * n_
        for mode, length in (("linear", cap - 1), ("ring", 2 * cap + 5)):
            q, kn, vn = randn(r, d_, dtype=dtype), randn(r, d_, dtype=dtype), randn(r, d_, dtype=dtype)
            kc, vc = randn(cap, r, d_, dtype=dtype), randn(cap, r, d_, dtype=dtype)
            ln = torch.tensor(length, dtype=torch.int32, device=dev)
            k_ref, v_ref = kc.clone(), vc.clone()
            ref = ops.temporal_decode_pm_plain(q, kn, vn, k_ref, v_ref, ln, h_)
            got = ops.temporal_decode_pm(q, kn, vn, kc, vc, ln, h_)
            torch.cuda.synchronize()
            if not (torch.equal(kc, k_ref) and torch.equal(vc, v_ref)):
                fail(f"temporal_decode_pm {mode} {dn}: appended cache planes differ")
            n_read = min(length, cap) - (1 if length >= cap else 0)  # old slots attended
            # yardstick: the new frame against the updated cache's valid slots
            window = (torch.arange(cap, device=dev) <= length).view(1, cap)
            q4 = q.view(r, h_, 1, dh)
            k4 = kc.view(cap, r, h_, dh).permute(1, 2, 0, 3)
            v4 = vc.view(cap, r, h_, dh).permute(1, 2, 0, 3)
            record("temporal_decode_pm", f"{mode} R={r} C={cap} len={length}", dn, max_err(got, ref),
                   lambda: ops.temporal_decode_pm(q, kn, vn, kc, vc, ln, h_),
                   lambda: ops.temporal_decode_pm_plain(q, kn, vn, kc, vc, ln, h_),
                   lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=window),
                   elt * r * d_ * (3 + 1 + 2 * n_read + 2), 4 * r * d_ * (n_read + 1))
        # B: the streaming step (R = B) and the full clip (R = B*T)
        for r in (b_, b_ * t_):
            q, k, v = (randn(r, n_, d_, dtype=dtype) for _ in range(3))
            err = max_err(ops.spatial_flat(q, k, v, h_), ops.spatial_flat_plain(q, k, v, h_))
            qh, kh, vh = (x.view(r, n_, h_, dh).transpose(1, 2) for x in (q, k, v))
            record("spatial_flat", f"R={r} N={n_}", dn, err,
                   lambda: ops.spatial_flat(q, k, v, h_),
                   lambda: ops.spatial_flat_plain(q, k, v, h_),
                   lambda: F.scaled_dot_product_attention(qh, kh, vh),
                   4 * elt * r * n_ * d_, 4 * r * n_ * n_ * d_)
        # C: the full clip's temporal attention (R = B*N rows of T frames)
        r = b_ * n_
        q, k, v = (randn(r, t_, d_, dtype=dtype) for _ in range(3))
        err = max_err(ops.temporal_fullclip(q, k, v, h_), ops.temporal_fullclip_plain(q, k, v, h_))
        qh, kh, vh = (x.view(r, t_, h_, dh).transpose(1, 2) for x in (q, k, v))
        record("temporal_fullclip", f"R={r} T={t_}", dn, err,
               lambda: ops.temporal_fullclip(q, k, v, h_),
               lambda: ops.temporal_fullclip_plain(q, k, v, h_),
               lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True),
               4 * elt * r * t_ * d_, 2 * t_ * (t_ + 1) * r * d_)
        del q, k, v, qh, kh, vh
    torch.cuda.synchronize()

    def open_gates(model, seed):
        """Open the zero-initialised gates and embedding tables, so that the
        temporal path and the positions matter."""
        g = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for layer in model.encoder.layer:
                layer.temporal_attention_gating.fill_(0.5)
            for p in (model.embeddings.time_embeddings, model.embeddings.position_embeddings):
                p.copy_(0.02 * torch.randn(p.shape, generator=g))

    # ---- 3. the encoder on the card against the encoder on the CPU, small fp32 config
    small = StreamformerConfig(**SMALL_CONFIG)
    on_cpu = encoder.StreamformerEncoder(small, device="cpu", generator=torch.Generator().manual_seed(1))
    open_gates(on_cpu, 1)
    on_card = encoder.StreamformerEncoder(small)
    on_card.load_state_dict(on_cpu.state_dict())
    clip = torch.randn(2, small.num_frames, 3, small.image_size, small.image_size,
                       generator=torch.Generator().manual_seed(2))
    worst = 0.0
    for key, ref in encoder.model_forward(on_cpu, clip).items():
        worst = max(worst, max_err(encoder.model_forward(on_card, clip)[key], ref))
    for capacity, frames in ((small.num_frames, small.num_frames), (2, 4)):  # linear; ring 2C
        cache_cpu = encoder.init_cache(small, 2, capacity=capacity, device="cpu")
        cache_card = encoder.init_cache(small, 2, capacity=capacity)
        for i in range(frames):
            ref, cache_cpu = encoder.streaming_forward(on_cpu, clip[:, i:i + 1], cache_cpu)
            got, cache_card = encoder.streaming_forward(on_card, clip[:, i:i + 1], cache_card)
            worst = max(worst, *(max_err(got[k], ref[k]) for k in ref))
    if not worst <= CARD_VS_CPU_TOL:
        fail(f"encoder on the card vs the CPU: max-abs {worst} > {CARD_VS_CPU_TOL}")
    print(f"small fp32 encoder, card vs CPU (full clip, linear and ring streams): "
          f"max-abs {worst} (<= {CARD_VS_CPU_TOL})")
    del on_cpu, on_card

    # ---- 4. from_pretrained, then the full clip at flagship width
    cfg = StreamformerConfig(cache_capacity=cap, **FLAGSHIP_CONFIG)
    ckpt = os.path.join(root, "build", "chip_smoke_checkpoint")
    seeded = encoder.StreamformerEncoder(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    open_gates(seeded, 0)
    cfg.save_pretrained(ckpt)
    torch.save(seeded.state_dict(), os.path.join(ckpt, "pytorch_model.bin"))
    del seeded
    model = from_pretrained(ckpt)
    if model.device.type != dev.type:
        fail(f"from_pretrained put the model on {model.device}")
    video = torch.randn(b_, t_, 3, cfg.image_size, cfg.image_size, device=dev, generator=gen)
    L = cfg.num_hidden_layers
    ops.reset_launches()
    full = encoder.model_forward(model, video)
    torch.cuda.synchronize()
    after_full = dict(ops.LAUNCHES)
    hidden, pooled = full["last_hidden_state"], full["pooler_output"]
    if hidden.shape != (b_, t_, n_, d_) or pooled.shape != (b_, t_, d_):
        fail(f"full clip shapes {tuple(hidden.shape)}, {tuple(pooled.shape)}")
    if not finite(full):
        fail("full clip outputs are not finite")
    if after_full != {"temporal_decode_pm": 0, "spatial_flat": L, "temporal_fullclip": L}:
        fail(f"full-clip launches {after_full}")
    print(f"full clip B={b_} T={t_} bf16: finite, launches {after_full}")

    # ---- 5. linear stream of T frames == the full clip
    cache = encoder.init_cache(cfg, b_)
    worst_h = worst_p = 0.0
    for i in range(t_):
        out, cache = encoder.streaming_forward(model, video[:, i:i + 1], cache)
        eh = max_err(out["last_hidden_state"], hidden[:, i:i + 1])
        ep = max_err(out["pooler_output"], pooled[:, i:i + 1])
        worst_h, worst_p = max(worst_h, eh), max(worst_p, ep)
        if not (eh <= STREAM_TOL_HIDDEN and ep <= STREAM_TOL_POOLED):
            fail(f"stream frame {i}: hidden err {eh} (<= {STREAM_TOL_HIDDEN}), "
                 f"pooled err {ep} (<= {STREAM_TOL_POOLED})")
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    stream_launches = {k: launches[k] - after_full[k] for k in launches}
    if stream_launches != {"temporal_decode_pm": L * t_, "spatial_flat": L * t_, "temporal_fullclip": 0}:
        fail(f"streaming launches {stream_launches}")
    if int(cache["len"]) != t_:
        fail(f"cache len {int(cache['len'])} after {t_} frames")
    print(f"linear stream {t_} frames == full clip: max err hidden {worst_h} (<= {STREAM_TOL_HIDDEN}), "
          f"pooled {worst_p} (<= {STREAM_TOL_POOLED}); launches {stream_launches}")
    del cache

    # ---- 6. ring stream of 2C frames, kernel A against its plain version on it
    ring = encoder.init_cache(cfg, b_, capacity=RING_CAPACITY)
    for i in range(2 * RING_CAPACITY):
        out, ring = encoder.streaming_forward(model, video[:, i % t_:i % t_ + 1], ring)
        if not finite(out):
            fail(f"ring frame {i}: outputs not finite")
    r = b_ * n_
    q, kn, vn = (randn(r, d_, dtype=torch.bfloat16) for _ in range(3))
    kc, vc = ring["layers"][0]["k"], ring["layers"][0]["v"]
    k_ref, v_ref = kc.clone(), vc.clone()
    ref = ops.temporal_decode_pm_plain(q, kn, vn, k_ref, v_ref, ring["len"], h_)
    got = ops.temporal_decode_pm(q, kn, vn, kc, vc, ring["len"], h_)
    ring_err = max_err(got, ref)
    if not (ring_err <= TOL["bfloat16"] and torch.equal(kc, k_ref) and torch.equal(vc, v_ref)):
        fail(f"ring decode vs plain: max-abs {ring_err}")
    print(f"ring stream {2 * RING_CAPACITY} frames at C={RING_CAPACITY}: finite; kernel A vs plain "
          f"on the ring cache (len={int(ring['len'])}): max-abs {ring_err}")
    del ring

    # ---- 7. streaming frames/s at steady state (ring, capacity 16, batch 8)
    cache = encoder.init_cache(cfg, b_)
    frame = video[:, :1]
    for i in range(t_):
        encoder.streaming_forward(model, video[:, i:i + 1], cache)
    torch.cuda.synchronize()
    steps = 32
    t0 = time.perf_counter()
    for _ in range(steps):
        encoder.streaming_forward(model, frame, cache)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    print(f"streaming encode ({smi}): {b_ / step_s:.1f} frames/s at batch {b_}, "
          f"{step_s * 1e3:.3f} ms/step (ring cache C={cap}, steady state, bf16)")
    from torch.profiler import ProfilerActivity, profile

    window = 8
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(window):
            encoder.streaming_forward(model, frame, cache)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / window
    rows = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
            and getattr(e, "device_time_total", 0) > 0]
    busy = sum(e.device_time_total for e in rows) / window / 1e3
    print(f"profile, {window} steady steps: device busy {busy:.3f} ms/step of {wall_ms:.3f} "
          f"(profiled wall clock)")
    for e in sorted(rows, key=lambda e: -e.device_time_total)[:12]:
        print(f"  {e.device_time_total / window / 1e3:8.4f} ms/step  x{e.count // window:<3d} "
              f"{e.key[:90]}")

    # ---- 8. summary
    main_shape = {"temporal_decode_pm": f"linear R={b_ * n_} C={cap} len={cap - 1}",
                  "spatial_flat": f"R={b_} N={n_}", "temporal_fullclip": f"R={b_ * n_} T={t_}"}
    kernels = []
    for name, (source, replaces) in SOURCES.items():
        row = results[(name, main_shape[name], "bfloat16")]
        kernels.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                            launches=launches[name], max_abs_err=row["max_abs_err"], ms=row["ms"],
                            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                            bound_by=row["bound_by"], library_ms=row["library_ms"]))
        if launches[name] == 0:
            fail(f"{name} never launched on the main path")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
