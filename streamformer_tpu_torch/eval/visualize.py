"""Track-mask overlay rendering (numpy, host-side): the port's own copy of the JAX
package's ``eval/visualize.py``, which imports no JAX.

Track-mask overlay rendering (reference: downstream/OVIS/demo/visualizer.py
``TrackVisualizer`` + demo/demo.py — a detectron2-Visualizer GUI stack there;
rebuilt here as pure-numpy compositing so it runs anywhere the framework
runs, with the same contract: one stable color per track id across frames,
alpha-blended mask fill, a solid contour, and a ``[tid] class score`` label).

Consumes the same per-frame dict schema as ``eval.ytvis.collect_video_result``
({"track_ids", "category_ids", "scores", "masks"}), so the submission path
and the visualization path are fed by one tracker output.
"""

from __future__ import annotations

import colorsys
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

_GOLDEN = 0.61803398875


def track_color(track_id: int) -> np.ndarray:
    """Deterministic, frame-stable RGB uint8 color for a track id.

    A golden-ratio walk around the hue wheel keeps consecutive ids far
    apart (the reference jitters a fixed per-id table for the same goal,
    visualizer.py ``_jitter``/``_ID_JITTERS``)."""
    h = (track_id * _GOLDEN) % 1.0
    s = 0.65 + 0.35 * (((track_id // 7) * _GOLDEN) % 1.0)
    v = 0.85
    rgb = colorsys.hsv_to_rgb(h, s, v)
    return np.array([int(255 * c) for c in rgb], np.uint8)


def _contour(mask: np.ndarray) -> np.ndarray:
    """Boundary pixels of a bool mask: mask minus its 4-neighbour erosion."""
    m = np.asarray(mask, bool)
    er = m.copy()
    er[1:, :] &= m[:-1, :]
    er[:-1, :] &= m[1:, :]
    er[:, 1:] &= m[:, :-1]
    er[:, :-1] &= m[:, 1:]
    return m & ~er


def overlay_masks(
    frame: np.ndarray,
    masks: np.ndarray,
    track_ids: Sequence[int],
    scores: Optional[Sequence[float]] = None,
    category_ids: Optional[Sequence[int]] = None,
    class_names: Optional[Dict[int, str]] = None,
    alpha: float = 0.45,
) -> np.ndarray:
    """Blend instance masks into an (H, W, 3) uint8 RGB frame.

    masks: (N, H, W) bool/0-1. Later instances paint over earlier ones
    (the reference sorts by area; callers can pre-sort). Returns a new
    uint8 frame; the input is not modified."""
    out = np.asarray(frame, np.float32).copy()
    if out.ndim != 3 or out.shape[-1] != 3:
        raise ValueError(f"frame must be (H, W, 3), got {frame.shape}")
    for i, tid in enumerate(track_ids):
        m = np.asarray(masks[i], bool)
        if not m.any():
            continue
        color = track_color(int(tid)).astype(np.float32)
        out[m] = (1.0 - alpha) * out[m] + alpha * color
        out[_contour(m)] = color
        label = f"[{int(tid)}]"
        if category_ids is not None and class_names:
            label += f" {class_names.get(int(category_ids[i]), category_ids[i])}"
        if scores is not None:
            label += f" {float(scores[i]):.2f}"
        ys, xs = np.nonzero(m)
        _draw_label(out, label, int(ys.min()), int(xs.min()), color)
    return np.clip(out, 0, 255).astype(np.uint8)


# 5x3 bitmap glyphs for the label charset — enough for "[12] name 0.97"
_GLYPHS = {
    "0": "111101101101111", "1": "010110010010111", "2": "111001111100111",
    "3": "111001111001111", "4": "101101111001001", "5": "111100111001111",
    "6": "111100111101111", "7": "111001010010010", "8": "111101111101111",
    "9": "111101111001111", ".": "000000000000010", "[": "110100100100110",
    "]": "011001001001011", " ": "000000000000000", "-": "000000111000000",
}


def _draw_label(img: np.ndarray, text: str, y: int, x: int,
                color: np.ndarray) -> None:
    """Tiny bitmap label above (y, x); letters outside the glyph table are
    skipped (class names render as spacing — ids/scores stay readable)."""
    h, w = img.shape[:2]
    y = max(0, y - 6)
    for ch in text:
        g = _GLYPHS.get(ch)
        if g is not None:
            for k, bit in enumerate(g):
                if bit == "1":
                    yy, xx = y + k // 3, x + k % 3
                    if 0 <= yy < h and 0 <= xx < w:
                        img[yy, xx] = color
        x += 4
        if x >= w:
            break


def render_video_tracks(
    frames: Sequence[np.ndarray],
    frame_outputs: List[Dict],
    class_names: Optional[Dict[int, str]] = None,
    score_threshold: float = 0.0,
    alpha: float = 0.45,
) -> List[np.ndarray]:
    """Overlay tracker outputs onto a whole video.

    frames: list of (H, W, 3) uint8 RGB. frame_outputs: the per-frame dicts
    fed to ``ytvis.collect_video_result`` (track_ids / category_ids /
    scores / masks). Returns the rendered frames."""
    if len(frames) != len(frame_outputs):
        raise ValueError(
            f"{len(frames)} frames vs {len(frame_outputs)} outputs")
    rendered = []
    for frame, fo in zip(frames, frame_outputs):
        keep = [i for i, s in enumerate(fo["scores"])
                if float(s) >= score_threshold]
        rendered.append(overlay_masks(
            frame,
            np.asarray(fo["masks"])[keep] if keep else
            np.zeros((0,) + frame.shape[:2], bool),
            [fo["track_ids"][i] for i in keep],
            scores=[fo["scores"][i] for i in keep],
            category_ids=[fo["category_ids"][i] for i in keep],
            class_names=class_names,
            alpha=alpha,
        ))
    return rendered


def save_rendered(frames: Sequence[np.ndarray], out: str,
                  fps: float = 10.0) -> str:
    """Write rendered frames to ``out``: a directory of PNGs, or an .mp4 /
    .avi via cv2 when the path has a video extension. Returns the path."""
    ext = os.path.splitext(out)[1].lower()
    if ext in (".mp4", ".avi"):
        if not len(frames):
            raise ValueError(
                "save_rendered: no frames to write — a zero-frame video "
                "has no dimensions for the cv2 writer"
            )
        import cv2
        h, w = frames[0].shape[:2]
        fourcc = cv2.VideoWriter_fourcc(*("mp4v" if ext == ".mp4" else "XVID"))
        vw = cv2.VideoWriter(out, fourcc, fps, (w, h))
        try:
            for f in frames:
                vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
        finally:
            vw.release()
        return out
    os.makedirs(out, exist_ok=True)
    import cv2
    for i, f in enumerate(frames):
        cv2.imwrite(os.path.join(out, f"{i:05d}.png"),
                    cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    return out
