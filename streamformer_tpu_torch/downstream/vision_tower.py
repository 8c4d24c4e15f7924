"""The streaming vision tower for VideoQA (LLaVA-style).

Port of the JAX package's ``downstream/vision_tower.py`` (the reference,
itself a rebuild of the reference VideoQA ``TimesformerVisionTower``): it
holds the temporal KV cache across calls, concatenates the new frames'
patch features along time, shows the LLM only the last
``context_length`` frames, and restarts on ``clear_cache()``. The image
processor (resize, rescale, normalize(0.5)) runs on the model's device.
The cache has a fixed capacity; the reference's grows.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from streamformer_tpu_torch.config import StreamformerConfig
from streamformer_tpu_torch.data import transforms as T
from streamformer_tpu_torch.models import encoder
from streamformer_tpu_torch.ops import attention as ops


class TimesformerVisionTower:
    """Stateful streaming tower over a ``StreamformerEncoder``: ``forward``
    takes (B, T_new, C, H, W) pixel values and returns the patch features of
    the frames in context for the LLM.

    ``cfg`` defaults to ``model.cfg``; a caller may pass another cache mode
    or capacity over the same weights, as ``streaming_forward`` takes one.
    ``streaming_mode`` and ``context_length`` default to its fields (a
    checkpoint's ``config.json``). With ``cfg.cache_mode ==
    "linear"`` the stream is bounded by ``cfg.cache_capacity`` and runs on
    the ragged cache (one stream per batch row, all at one length); with
    "ring" it is unbounded, a sliding window over the last capacity frames,
    on the lockstep cache."""

    def __init__(self, model: encoder.StreamformerEncoder,
                 streaming_mode: Optional[bool] = None,
                 context_length: Optional[int] = None,
                 select_feature: str = "patch",
                 cfg: Optional[StreamformerConfig] = None):
        cfg = model.cfg if cfg is None else cfg
        self.model = model
        self.cfg = cfg
        self.streaming_mode = cfg.streaming_mode if streaming_mode is None else streaming_mode
        self.context_length = cfg.context_length if context_length is None else context_length
        self.select_feature = select_feature
        self._cache = None
        self._frames = 0  # frames streamed so far, a host mirror of the cache's length
        self._history: Optional[torch.Tensor] = None  # (B, t, N, D)
        # one time-embedding table for the whole stream, interpolated to the
        # capacity when that exceeds the trained frames (the reference
        # interpolates to the running total at every step, which gives the
        # cached K/V another table than later queries)
        self._total_hint = max(cfg.num_frames, cfg.cache_capacity)

    @property
    def hidden_size(self) -> int:
        return self.cfg.hidden_size

    @property
    def num_patches(self) -> int:
        return self.cfg.num_patches

    def clear_cache(self) -> None:
        """Restart the stream."""
        self._cache = None
        self._frames = 0
        self._history = None

    def preprocess(self, images_u8: np.ndarray) -> torch.Tensor:
        """(T, H, W, C) uint8 -> (T, C, size, size) normalized to [-1, 1] on
        the model's device (resize, rescale 1/255, normalize 0.5)."""
        x = torch.as_tensor(np.asarray(images_u8), device=self.model.device)
        x = T.resize(x, (self.cfg.image_size, self.cfg.image_size))
        return T.to_model_input(T.normalize(x))

    def _chunk(self) -> int:
        """Frames per call on the linear cache: what kernel E's whole-table
        body takes at this capacity, and at most ``num_frames``; ``num_frames``
        (E's tiled body) where not one frame of that plan fits (capacities in
        the tens of thousands), as the serving engine chunks."""
        fast = ops.append_frame_cap(self.cfg.cache_capacity)
        return min(fast or self.cfg.num_frames, self.cfg.num_frames)

    @torch.no_grad()
    def forward(self, pixel_values) -> torch.Tensor:
        """(B, T_new, C, H, W) -> (B, t_ctx, N, D) patch features, t_ctx =
        min(frames so far, ``context_length``). ``None`` returns the held
        streaming context without consuming frames.

        Streaming on the linear cache appends the call's frames in chunks of
        ``_chunk()`` frames, chunk i + 1 attending chunk i through the cache:
        contract-equal to one append of all of them, as the JAX package's
        chunks of its own kernel's size are. A linear stream past the
        capacity raises. Outside streaming mode every call is a full clip."""
        if pixel_values is None:
            if not self.streaming_mode or self._history is None:
                raise ValueError(
                    "pixel_values=None reuses the streaming context, but "
                    + ("the tower is not in streaming mode" if not self.streaming_mode
                       else "no frames have been streamed yet")
                )
            return self._history
        px = torch.as_tensor(pixel_values).to(self.model.device,
                                              encoder.compute_dtype(self.cfg))
        if not self.streaming_mode:
            return encoder.model_forward(self.model, px)["last_hidden_state"]
        b, t = px.shape[:2]
        ring = self.cfg.cache_mode == "ring"
        if self._cache is None:
            self._cache = encoder.init_cache(self.cfg, b, per_stream_len=not ring,
                                             device=self.model.device)
        if not ring and self._frames + t > self.cfg.cache_capacity:
            raise ValueError(
                f"stream length {self._frames + t} exceeds cache_capacity "
                f"{self.cfg.cache_capacity} in linear cache mode; use cache_mode='ring' for "
                "unbounded streams (a sliding window in fixed memory) or clear_cache() to restart"
            )
        step = self._chunk() if not ring else t
        outs = []
        for lo in range(0, t, step):
            out, self._cache = encoder.streaming_forward(
                self.model, px[:, lo:lo + step], self._cache, total_frames_hint=self._total_hint,
                cfg=self.cfg)
            outs.append(out["last_hidden_state"])
        self._frames += t
        new = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
        self._history = new if self._history is None else torch.cat([self._history, new], dim=1)
        # the LLM sees a sliding window; the encoder's cache keeps the longer history
        self._history = self._history[:, -self.context_length:]
        return self._history

    __call__ = forward
