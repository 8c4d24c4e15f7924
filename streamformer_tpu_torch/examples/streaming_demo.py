"""Streaming-encode demo (the reference's test_kvcache.py usage pattern).

Encodes a video three ways and checks the KV-cache contract:
  #1 first half, fresh cache
  #2 full clip, fresh cache
  #3 second half, with the cache of #1 -> must equal the tail of #2
then streams 48 frames through an 8-frame ring (#4) and serves int8
weights on an int8 cache (#5, cosine to the float full clip).

Run: python -m streamformer_tpu_torch.examples.streaming_demo [video.mp4] [--device cpu]
(without a video, random frames; a video needs cv2). On the card by default.
STREAMFORMER_DEMO_SMOKE=1 shrinks to a toy config so the demo finishes in
seconds on a CPU.
"""

import argparse
import copy
import os

import numpy as np
import torch

from streamformer_tpu_torch.config import StreamformerConfig
from streamformer_tpu_torch.models import encoder
from streamformer_tpu_torch.ops import quant

TOL = 1e-4  # fp32: the cached second half against the full clip's tail


def main(argv=None):
    p = argparse.ArgumentParser(description="streaming-encode demo")
    p.add_argument("video", nargs="?", default=None)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = encoder.resolve_device(args.device)
    if os.environ.get("STREAMFORMER_DEMO_SMOKE") == "1":
        cfg = StreamformerConfig(image_size=48, num_frames=8, hidden_size=96, num_hidden_layers=3,
                                 num_attention_heads=4, intermediate_size=192, dtype="float32",
                                 cache_capacity=32)
    else:
        cfg = StreamformerConfig(dtype="float32", cache_capacity=32)
    model = encoder.StreamformerEncoder(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for layer in model.encoder.layer:
            layer.temporal_attention_gating.fill_(0.5)

    if args.video:
        from streamformer_tpu_torch.data.video_io import read_video_full
        from streamformer_tpu_torch.extract.oad import preprocess_frames

        frames, _ = read_video_full(args.video)
        px = preprocess_frames(frames[:16], cfg.image_size, device=dev)[None]
    else:
        rng = np.random.default_rng(0)
        px = torch.from_numpy(rng.standard_normal((1, 16, 3, cfg.image_size, cfg.image_size),
                                                  dtype=np.float32)).to(dev)

    # 1: first 8 frames
    cache = encoder.init_cache(cfg, 1, device=dev)
    out1, cache = encoder.streaming_forward(model, px[:, :8], cache)
    print("#1 first-half pooled[0, -1, :4] =", out1["pooler_output"][0, -1, :4].tolist())

    # 2: full 16 frames, fresh
    with torch.no_grad():
        full = encoder.model_forward(model, px)
    print("#2 full-clip  pooled[0, -1, :4] =", full["pooler_output"][0, -1, :4].tolist())

    # 3: second 8 frames continuing #1's cache
    out3, cache = encoder.streaming_forward(model, px[:, 8:], cache)
    print("#3 cached-2nd pooled[0, -1, :4] =", out3["pooler_output"][0, -1, :4].tolist())
    err = (out3["pooler_output"] - full["pooler_output"][:, 8:]).abs().max().item()
    print(f"#3 vs #2 tail max abs err: {err:.2e}  ({'OK' if err < TOL else 'MISMATCH'})")
    if not err < TOL:
        raise SystemExit(f"streaming contract violated: {err} >= {TOL}")

    # 4: unbounded stream: the ring keeps a sliding window of cache_capacity
    # frames in fixed memory, so the stream can run forever
    cfg_ring = cfg.replace(cache_mode="ring", cache_capacity=8)
    rcache = encoder.init_cache(cfg_ring, 1, device=dev)
    for t in range(px.shape[1] * 3):  # 3x longer than capacity: wraps twice
        out4, rcache = encoder.streaming_forward(model, px[:, t % px.shape[1]][:, None], rcache,
                                                 cfg=cfg_ring)
    finite = bool(torch.isfinite(out4["pooler_output"]).all())
    print("#4 ring stream (48 frames through an 8-frame window) pooled[0,-1,:4] =",
          out4["pooler_output"][0, -1, :4].tolist(), "| finite:", finite)

    # 5: int8 serving: int8 dense products and an int8 KV cache
    qmodel = quant.quantize_encoder(copy.deepcopy(model))
    cfg_q = cfg.replace(cache_dtype="int8")
    qcache = encoder.init_cache(cfg_q, 1, device=dev)
    o5a, qcache = encoder.streaming_forward(qmodel, px[:, :8], qcache, cfg=cfg_q)
    o5b, qcache = encoder.streaming_forward(qmodel, px[:, 8:], qcache, cfg=cfg_q)
    got = torch.cat([o5a["pooler_output"], o5b["pooler_output"]], 1).float().flatten()
    ref = full["pooler_output"].float().flatten()
    cos = float(got @ ref / (got.norm() * ref.norm()))
    print(f"#5 int8 weights + int8 KV vs float full-clip cosine: {cos:.5f}")
    return {"tail_err": err, "ring_finite": finite, "int8_cosine": cos}


if __name__ == "__main__":
    main()
