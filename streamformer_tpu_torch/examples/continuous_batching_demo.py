"""Continuous-batching serving demo: ragged per-stream cache lengths.

A serving fleet rarely sees streams start and stop in lockstep. With
``init_cache(per_stream_len=True)`` every batch row advances at its own
position (``cache["len"]`` is (B,)): one step serves a batch of
mixed-position streams, and ``reset_streams`` re-admits a finished slot
for a new stream without touching its neighbours.

The demo runs a 4-slot server for 8 "requests" of different lengths:
requests are admitted into free slots as they arrive, stepped together in
one call per tick, and their pooled features are checked against
independently encoded lone streams (the correctness contract).

Run: python -m streamformer_tpu_torch.examples.continuous_batching_demo [--device cpu]
STREAMFORMER_DEMO_SMOKE=1 shrinks to a toy config so the demo finishes in
seconds on a CPU.
"""

import argparse
import os

import numpy as np
import torch

from streamformer_tpu_torch.config import StreamformerConfig
from streamformer_tpu_torch.models import encoder

SLOTS = 4
TOL = 1e-4  # fp32: a ragged row against a lone stream


def main(argv=None):
    p = argparse.ArgumentParser(description="continuous-batching demo")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = encoder.resolve_device(args.device)
    if os.environ.get("STREAMFORMER_DEMO_SMOKE") == "1":
        cfg = StreamformerConfig(image_size=48, num_frames=8, hidden_size=96, num_hidden_layers=3,
                                 num_attention_heads=4, intermediate_size=192, dtype="float32",
                                 cache_capacity=16)
    else:
        cfg = StreamformerConfig(dtype="float32", cache_capacity=16)
    model = encoder.StreamformerEncoder(cfg, device=dev, generator=torch.Generator().manual_seed(0))

    rng = np.random.default_rng(0)
    # 8 requests, 2-6 frames each
    requests = [rng.standard_normal((n, 3, cfg.image_size, cfg.image_size)).astype(np.float32)
                for n in rng.integers(2, 7, size=8)]

    cache = encoder.init_cache(cfg, SLOTS, per_stream_len=True, device=dev)
    slot_req = [None] * SLOTS  # which request occupies each slot
    slot_done = [0] * SLOTS  # frames served so far per slot
    pending = list(range(len(requests)))
    results = {i: [] for i in range(len(requests))}

    tick = 0
    while pending or any(r is not None for r in slot_req):
        # admit: fill every free slot, resetting its length to 0
        free = torch.tensor([slot_req[s] is None for s in range(SLOTS)], device=dev)
        cache = encoder.reset_streams(cache, free)
        for s in range(SLOTS):
            if slot_req[s] is None and pending:
                slot_req[s] = pending.pop(0)
                slot_done[s] = 0
                print(f"tick {tick}: request {slot_req[s]} -> slot {s}")

        # one frame per occupied slot (idle slots get zeros, output unused)
        frame = np.zeros((SLOTS, 1, 3, cfg.image_size, cfg.image_size), np.float32)
        for s in range(SLOTS):
            if slot_req[s] is not None:
                frame[s, 0] = requests[slot_req[s]][slot_done[s]]
        out, cache = encoder.streaming_forward(model, torch.from_numpy(frame).to(dev), cache)

        # collect outputs; retire finished requests
        pooled = out["pooler_output"][:, 0].cpu()
        for s in range(SLOTS):
            r = slot_req[s]
            if r is None:
                continue
            results[r].append(pooled[s])
            slot_done[s] += 1
            if slot_done[s] == len(requests[r]):
                print(f"tick {tick}: request {r} finished ({slot_done[s]} frames), slot {s} free")
                slot_req[s] = None
        tick += 1

    # contract: every request's outputs equal a lone stream's
    worst = 0.0
    for r, clip in enumerate(requests):
        solo = encoder.init_cache(cfg, 1, device=dev)
        for t in range(len(clip)):
            frame = torch.from_numpy(clip[None, t:t + 1]).to(dev)
            o, solo = encoder.streaming_forward(model, frame, solo)
            worst = max(worst, (results[r][t] - o["pooler_output"][0, 0].cpu()).abs().max().item())
    print(f"\nserved {len(requests)} requests on {SLOTS} slots in {tick} ticks; worst deviation "
          f"vs lone streams: {worst:.2e}")
    if not worst < TOL:
        raise SystemExit(f"continuous-batching contract violated: {worst} >= {TOL}")
    print("contract holds: ragged rows == independent streams")
    return {"ticks": tick, "worst": worst}


if __name__ == "__main__":
    main()
