"""Host-side video decoding and frame-index sampling: the port's own copy
of the JAX package's ``data/video_io.py``.

The reader is cv2-backed with a decord-like surface (``len``,
``get_batch``). The samplers reproduce the reference's index math: TSN
sparse sampling (a random frame per segment in train, the middle in
validation, a per-chunk offset in test), dense clip_len x sample_rate
windows, the retrieval rand/middle sampling, the multi-view test grid and
the 24-fps resample of OAD dumps.

``cv2`` is imported where a video is decoded, never when the module is
imported: the card's machine need not have it, and nothing on the GPU path
decodes a file.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


class VideoReader:
    """cv2-backed frame reader; frames come back RGB uint8 (H, W, C)."""

    def __init__(self, path: str, num_threads: int = 1):
        import cv2

        self._cap = cv2.VideoCapture(path)
        if not self._cap.isOpened():
            raise IOError(f"cannot open video {path}")
        self._len = int(self._cap.get(cv2.CAP_PROP_FRAME_COUNT))
        self.fps = float(self._cap.get(cv2.CAP_PROP_FPS)) or 30.0
        # actual frame shape, so the salvage fallback in get_batch stacks
        # cleanly with real frames of any resolution
        self._h = int(self._cap.get(cv2.CAP_PROP_FRAME_HEIGHT)) or 224
        self._w = int(self._cap.get(cv2.CAP_PROP_FRAME_WIDTH)) or 224
        self._pos = 0

    def __len__(self):
        return self._len

    def get_batch(self, indices: Sequence[int]) -> np.ndarray:
        """Fetch frames by index, (N, H, W, 3) RGB uint8. Sorted-access
        optimized: sequential reads with seeks only on gaps."""
        import cv2

        order = np.argsort(indices)
        out: dict = {}
        last = None  # most recent successfully decoded frame (sorted order)
        for k in order:
            idx = int(indices[k])
            if idx != self._pos:
                self._cap.set(cv2.CAP_PROP_POS_FRAMES, idx)
                self._pos = idx
            ok, frame = self._cap.read()
            if not ok:
                # salvage: reuse the last decoded frame if any, else zeros
                # sized to the video's real resolution (a hardcoded shape
                # would crash np.stack on non-224 videos whose first sorted
                # frame fails)
                out[k] = last if last is not None else np.zeros(
                    (self._h, self._w, 3), np.uint8
                )
                continue
            self._pos = idx + 1
            last = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            out[k] = last
        return np.stack([out[k] for k in range(len(indices))])

    def close(self):
        self._cap.release()


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


# ---------------------------------------------------------------------------
# frame-index samplers
# ---------------------------------------------------------------------------


def sparse_sample_indices(
    num_frames_total: int,
    num_segments: int,
    mode: str = "train",
    test_chunk: int = 0,
    test_num_segment: int = 1,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """TSN sparse sampling (reference _get_seq_frames,
    kinetics_sparse.py:379-400): split into ``num_segments`` equal segments;
    train picks a random frame per segment, val the middle, test a
    deterministic per-chunk offset."""
    seg_size = float(num_frames_total - 1) / num_segments
    out = []
    if mode == "train":
        rng = rng or np.random.default_rng()
        for i in range(num_segments):
            start, end = int(np.round(seg_size * i)), int(np.round(seg_size * (i + 1)))
            out.append(min(rng.integers(start, end + 1), num_frames_total - 1))
    elif mode == "validation":
        for i in range(num_segments):
            start, end = int(np.round(seg_size * i)), int(np.round(seg_size * (i + 1)))
            out.append(min((start + end) // 2, num_frames_total - 1))
    elif mode == "test":  # chunk_nb = deterministic offset within segments
        for i in range(num_segments):
            start = int(np.round(seg_size * i))
            frac = (test_chunk + 0.5) / test_num_segment
            out.append(
                min(start + int(np.round(seg_size * frac)), num_frames_total - 1)
            )
    else:
        # strict: a typo like "val" silently sampling the test protocol
        # is an off-by-frames eval bug, not a fallback
        raise ValueError(
            f"mode must be train|validation|test, got {mode!r}"
        )
    return np.asarray(out, np.int64)


def dense_sample_indices(
    num_frames_total: int,
    clip_len: int,
    sample_rate: int,
    mode: str = "train",
    test_chunk: int = 0,
    test_num_segment: int = 1,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Dense (strided) sampling: a clip_len x sample_rate window."""
    span = clip_len * sample_rate
    if num_frames_total <= span:
        idx = np.arange(0, span, sample_rate)
        return np.minimum(idx, num_frames_total - 1)
    if mode == "train":
        rng = rng or np.random.default_rng()
        start = int(rng.integers(0, num_frames_total - span + 1))
    elif mode == "validation":
        start = (num_frames_total - span) // 2
    else:
        starts = np.linspace(
            0, num_frames_total - span, max(test_num_segment, 1)
        ).astype(np.int64)
        start = int(starts[min(test_chunk, len(starts) - 1)])
    return start + np.arange(0, span, sample_rate)


def retrieval_sample_indices(
    num_frames_total: int,
    num_frames: int,
    sample: str = "rand",
    max_num_frames: int = -1,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """rand/middle frame sampling (reference get_frame_indices,
    utils_ret.py:149-191): split range into num_frames intervals, pick
    random (train) or middle (eval) per interval."""
    if max_num_frames > 0:
        num_frames = min(num_frames, max_num_frames)
    intervals = np.linspace(0, num_frames_total, num_frames + 1).astype(np.int64)
    ranges = list(zip(intervals[:-1], intervals[1:]))
    if sample == "rand":
        rng = rng or np.random.default_rng()
        idx = [int(rng.integers(lo, max(hi, lo + 1))) for lo, hi in ranges]
    else:
        idx = [(lo + hi) // 2 for lo, hi in ranges]
    return np.minimum(np.asarray(idx, np.int64), num_frames_total - 1)


def resample_to_fps(num_frames_total: int, native_fps: float, target_fps: float = 24.0
                    ) -> np.ndarray:
    """Frame indices that resample a video to ``target_fps``."""
    if num_frames_total <= 0:  # an empty or corrupt video: no indices
        return np.zeros((0,), np.int64)
    duration = num_frames_total / max(native_fps, 1e-6)
    n_out = max(int(round(duration * target_fps)), 1)
    return np.linspace(0, num_frames_total - 1, n_out).astype(np.int64)


def test_views(test_num_segment: int, test_num_crop: int) -> List[Tuple[int, int]]:
    """(chunk_nb, split_nb) multi-view grid (kinetics_sparse.py:151-160)."""
    return [
        (c, s) for c in range(test_num_segment) for s in range(test_num_crop)
    ]
