"""Per-frame feature extraction for online action detection (OAD).

Port of the JAX package's ``extract/oad.py`` (the reference): decode ->
resize the short side to 224, center crop, normalize(0.5) -> resample to 24
fps -> one pooled 768-d feature per frame (or per window) -> ``.npy`` of
(L, D), the OAD detector's input. The functions take the encoder module
where the JAX package takes its parameters and config.

Modes:

* ``streaming`` (default): one causal pass with the ring cache, fed in
  chunks of 16 frames (lockstep multi-frame ring appends: kernel A, or F on
  an int8 cache, once per frame); every frame attends the last
  ``capacity`` frames. L rows.
* ``windowed``: the reference's sliding window, each window a full clip
  through ``model_forward``, the last frame's pooled feature kept. About
  L / stride rows.
* ``batched``: many clips through one ``serving.StreamingEngine``, each
  clip's features those of the streaming mode.

The two temporal rates differ: a feature store takes one mode. Every
function runs on the model's device, all device work on the caller's thread.
"""

from __future__ import annotations

import os
import threading
from typing import List, Optional, Sequence

import numpy as np
import torch

from streamformer_tpu_torch.data import transforms as T
from streamformer_tpu_torch.data import video_io
from streamformer_tpu_torch.models import encoder


def preprocess_frames(frames_u8: np.ndarray, size: int = 224, device=None) -> torch.Tensor:
    """(T, H, W, C) uint8 -> (T, C, size, size) float32 on ``device``
    (``cuda`` unless named): resize the short side, center crop, normalize
    to [-1, 1], as the reference's transform stack does."""
    x = torch.as_tensor(np.asarray(frames_u8), device=encoder.resolve_device(device))
    x = T.resize_short_side(x, size)
    x = T.center_crop(x, (size, size))
    x = T.normalize(x)
    return T.to_model_input(x)


@torch.no_grad()
def extract_features_streaming(
    model: encoder.StreamformerEncoder,
    pixel_values: torch.Tensor,
    chunk: int = 16,
    capacity: Optional[int] = None,
) -> np.ndarray:
    """One causal pass over the video (L, C, H, W); returns (L, D) float32
    features, one per frame.

    Lockstep ring cache of ``capacity`` slots (default
    ``cfg.cache_capacity``): every frame attends the last ``capacity``
    frames, with no restart. Frames go in chunks of ``chunk``; the last
    chunk is padded with zero frames, whose features are dropped, so that
    every chunk takes the same time-embedding table (``streaming_forward``
    interpolates it to max(``num_frames``, chunk))."""
    cfg = model.cfg
    capacity = capacity or cfg.cache_capacity
    cfg = cfg.replace(cache_mode="ring", cache_capacity=capacity)
    px = torch.as_tensor(pixel_values).to(model.device, encoder.compute_dtype(cfg))
    length = px.shape[0]
    pad = (-length) % chunk
    if pad:
        px = torch.cat([px, px.new_zeros((pad,) + tuple(px.shape[1:]))])
    cache = encoder.init_cache(cfg, 1, capacity=capacity, device=model.device)
    feats = []
    for i in range(0, px.shape[0], chunk):
        out, cache = encoder.streaming_forward(model, px[None, i:i + chunk], cache, cfg=cfg)
        feats.append(out["pooler_output"][0])
    return torch.cat(feats).float().cpu().numpy()[:length]


@torch.no_grad()
def extract_features_windowed(
    model: encoder.StreamformerEncoder,
    pixel_values: torch.Tensor,
    window_size: int = 6,
    stride: int = 4,
) -> np.ndarray:
    """The reference's sliding-window extraction: each window of
    ``window_size`` frames, every ``stride`` frames, is one full clip
    through ``model_forward``; its last frame's pooled feature is kept.
    Windows that overhang the end slide back onto real frames (the
    reference never pads), so a video shorter than the window is one window
    of all its frames. Returns (W, D) float32."""
    px = torch.as_tensor(pixel_values).to(model.device, encoder.compute_dtype(model.cfg))
    length = px.shape[0]
    w = min(window_size, length)
    starts = list(range(0, max(length - window_size, 0) + 1, stride)) or [0]
    batch = torch.stack([px[min(s, length - w):min(s, length - w) + w] for s in starts])
    feats = encoder.model_forward(model, batch)["pooler_output"]  # (W, w, D)
    return feats[:, -1].float().cpu().numpy()


@torch.no_grad()
def extract_features_batched(
    model: encoder.StreamformerEncoder,
    clips: Sequence,
    slots: int = 8,
    capacity: Optional[int] = None,
    frames_per_tick: int = 8,
) -> List[np.ndarray]:
    """Continuous-batching extraction: many clips, each (L_i, C, H, W)
    preprocessed, through one ``serving.StreamingEngine`` of ``slots``
    slots; returns each clip's (L_i, D) float32 features, in input order.

    Each frame attends the last ``capacity`` frames of its clip, the
    context of ``extract_features_streaming``. The engine takes the cache
    mode ``encoder.auto_cache_mode`` gives, as the JAX package's extractor
    does: the ring on the pos-major layout (the port's t=1 decode serves
    its sliding window), where a tick of ``frames_per_tick`` frames is that
    many t=1 steps. Where that mode is the linear cache, ``capacity`` must
    cover the longest clip, which is checked before any work. A zero-length
    clip is opened and closed with no frames: it never takes a slot and
    yields (0, D).

    The engine is built for this call and dropped after it: an engine that
    a call left behind with streams in its slots (an exception midway) is
    never reused. The function is not reentrant: its device work runs on
    the caller's thread, and two calls from two threads at once are not
    supported."""
    from streamformer_tpu_torch.serving import StreamingEngine

    capacity = capacity or model.cfg.cache_capacity
    mode = encoder.auto_cache_mode(model.cfg)
    lens = [int(c.shape[0]) for c in clips]
    if mode == "linear" and lens and max(lens) > capacity:
        raise ValueError(
            f"longest clip ({max(lens)} frames) exceeds the cache capacity {capacity} of the "
            "linear cache: raise `capacity` to cover the clip"
        )
    eng = StreamingEngine(model, slots=slots, capacity=capacity, mode=mode, collect="pooled")
    sids = []
    for clip in clips:
        sid = eng.open()
        if len(clip):
            eng.feed(sid, np.asarray(torch.as_tensor(clip).float().cpu(), np.float32))
        eng.close(sid)
        sids.append(sid)
    eng.run_until_idle(frames=max(1, int(frames_per_tick)))
    return [eng.poll(sid)[0] for sid in sids]


def extract_videos_batched(
    model: encoder.StreamformerEncoder,
    video_paths: Sequence[str],
    out_dir: Optional[str] = None,
    slots: int = 8,
    group: Optional[int] = None,
    target_fps: float = 24.0,
    **kw,
) -> List[np.ndarray]:
    """Decode and batch-extract a list of videos; with ``out_dir``, save
    ``<name>.npy`` for each.

    Videos go in groups of ``group`` (default ``4 * slots``), so that the
    host holds one group of decoded clips at a time; the next group decodes
    on a host thread while the card serves the current one. That thread
    decodes and resamples only: it touches no tensor, and all device work
    stays on the caller's thread."""
    group = group or 4 * slots
    size = model.cfg.image_size

    def load_group(paths):
        """Host only (the prefetch thread): decode and resample to uint8."""
        raw = []
        for p in paths:
            frames, fps = video_io.read_video_full(p)
            raw.append(frames[video_io.resample_to_fps(len(frames), fps, target_fps)])
        return raw

    groups = [list(video_paths[i:i + group]) for i in range(0, len(video_paths), group)]
    feats_all: List[np.ndarray] = []
    nxt = {"clips": load_group(groups[0])} if groups else {}
    for gi, paths in enumerate(groups):
        if "error" in nxt:  # the prefetch thread failed: raise its cause here
            raise RuntimeError(f"decoding group {gi} (videos {nxt['paths']}) failed") \
                from nxt["error"]
        clips = [preprocess_frames(f, size, model.device) for f in nxt["clips"]]
        th = None
        if gi + 1 < len(groups):
            nxt = {}

            def prefetch(paths_next=groups[gi + 1], out=nxt):
                try:
                    out["clips"] = load_group(paths_next)
                except Exception as e:  # raised again on the caller's thread
                    out["error"] = e
                    out["paths"] = paths_next

            th = threading.Thread(target=prefetch)
            th.start()
        try:
            feats = extract_features_batched(model, clips, slots=slots, **kw)
        finally:
            if th is not None:
                th.join()
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            for p, f in zip(paths, feats):
                name = os.path.splitext(os.path.basename(p))[0]
                np.save(os.path.join(out_dir, name + ".npy"), f)
        feats_all.extend(feats)
    return feats_all


def extract_video(
    model: encoder.StreamformerEncoder,
    video_path: str,
    out_path: Optional[str] = None,
    target_fps: float = 24.0,
    mode: str = "streaming",
    **kw,
) -> np.ndarray:
    """Decode one video, resample it to ``target_fps``, extract its
    features in ``mode`` ("streaming" or "windowed"); with ``out_path``,
    save them as ``.npy``."""
    frames, fps = video_io.read_video_full(video_path)
    frames = frames[video_io.resample_to_fps(len(frames), fps, target_fps)]
    px = preprocess_frames(frames, model.cfg.image_size, model.device)
    if mode == "streaming":
        feats = extract_features_streaming(model, px, **kw)
    elif mode == "windowed":
        feats = extract_features_windowed(model, px, **kw)
    else:
        raise ValueError(f"mode {mode!r}: 'streaming' or 'windowed'")
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        np.save(out_path, feats)
    return feats
