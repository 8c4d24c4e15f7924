"""Host-side video decoding, the port's own copy of what its extractor uses
from the JAX package's ``data/video_io.py``.

``cv2`` is imported where a video is decoded, never when the module is
imported: the card's machine need not have it, and nothing on the GPU path
decodes a file.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def read_video_full(path: str) -> Tuple[np.ndarray, float]:
    """Decode every frame -> ((T, H, W, 3) RGB uint8, fps)."""
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"cannot open video {path}")
    fps = float(cap.get(cv2.CAP_PROP_FPS)) or 30.0
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(f, cv2.COLOR_BGR2RGB))
    cap.release()
    if not frames:
        raise IOError(f"no frames decoded from {path}")
    return np.stack(frames), fps


def resample_to_fps(num_frames_total: int, native_fps: float, target_fps: float = 24.0
                    ) -> np.ndarray:
    """Frame indices that resample a video to ``target_fps``."""
    if num_frames_total <= 0:  # an empty or corrupt video: no indices
        return np.zeros((0,), np.int64)
    duration = num_frames_total / max(native_fps, 1e-6)
    n_out = max(int(round(duration * target_fps)), 1)
    return np.linspace(0, num_frames_total - 1, n_out).astype(np.int64)
