"""Spatial-task datasets, VIS (YTVIS/LVVIS/COCO-pseudo) and ReferVOS: the
port's own copy of the JAX package's ``data/seg_datasets.py``.

Rebuild of datasets/task_vis.py (587 LoC) and datasets/task_refervos.py
(603 LoC):

* YTVIS-style JSON: videos with per-frame file names + per-instance polygon
  or RLE segmentations -> class-id mask rasterization
  (process_youtube_vis :298, polygons_to_mask :556);
* COCO-pseudo-video: one still image jittered/rotated into a T-frame clip
  (process_coco_pseudo_vis :245, _random_rotation :512);
* ReferVOS: video + referring expression + binary mask;
* video+mask synchronized geometric transforms (the Pair* ops,
  video_transforms.py:1261-1350) — applied host-side with cv2 here since
  masks need nearest-neighbor semantics;
* the <=100-class negative sampling + label remapping for the VIS head
  (modeling_timesformer_siglip.py:1844-1882) — host-side, returning the
  selected class indices + remapped targets the head consumes.
"""

from __future__ import annotations

import json
import os
import random
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from streamformer_tpu_torch.data.datasets import _RetryDataset, _host_resize_short


def polygons_to_mask(polygons: Sequence[Sequence[float]], h: int, w: int) -> np.ndarray:
    """Rasterize COCO-style polygon lists into a binary mask (reference
    polygons_to_mask, task_vis.py:556)."""
    import cv2

    mask = np.zeros((h, w), np.uint8)
    for poly in polygons:
        pts = np.asarray(poly, np.float64).reshape(-1, 2)
        cv2.fillPoly(mask, [pts.round().astype(np.int32)], 1)
    return mask.astype(bool)


def rle_to_mask(rle: Dict, h: int, w: int) -> np.ndarray:
    """Uncompressed COCO RLE {counts: [..], size: [h, w]} -> bool mask."""
    counts = rle["counts"]
    flat = np.zeros(h * w, bool)
    pos = 0
    val = False
    for c in counts:
        if val:
            flat[pos : pos + c] = True
        pos += c
        val = not val
    return flat.reshape(w, h).T if rle.get("order", "F") == "F" else flat.reshape(h, w)


def random_rotation_clip(
    image: np.ndarray, num_frames: int, max_angle: float = 10.0,
    rng: Optional[random.Random] = None,
) -> Tuple[np.ndarray, List[np.ndarray]]:
    """COCO pseudo-video: rotate/jitter one still image into a clip
    (reference _random_rotation, task_vis.py:512). Returns frames and the
    per-frame affine matrices (for synchronized mask warping)."""
    import cv2

    rng = rng or random
    h, w = image.shape[:2]
    frames, mats = [], []
    for _ in range(num_frames):
        angle = rng.uniform(-max_angle, max_angle)
        m = cv2.getRotationMatrix2D((w / 2, h / 2), angle, 1.0)
        frames.append(cv2.warpAffine(image, m, (w, h), flags=cv2.INTER_LINEAR))
        mats.append(m)
    return np.stack(frames), mats


def _resize_mask(mask: np.ndarray, h: int, w: int) -> np.ndarray:
    import cv2

    # uint16, not uint8: mask values are CATEGORY IDS and open-vocabulary
    # datasets (LVVIS: 1196 classes) exceed 255
    return cv2.resize(
        mask.astype(np.uint16), (w, h), interpolation=cv2.INTER_NEAREST
    )


def _masks_like_frames(masks, fh: int, fw: int, i0: int, j0: int,
                       crop: int, mh: int, mw: int) -> np.ndarray:
    """Run masks through the EXACT frame geometry — short-side resize
    (nearest) to the frames' post-resize shape, the same center crop, then
    the head's mask_size. Resizing the original full frame straight to
    mask_size squashes the aspect ratio and keeps the cropped-away margins,
    so every pixel's mask label came from a different image location than
    its RGB (silent spatial misalignment on all non-square videos)."""
    out = []
    for m in masks:
        m = _resize_mask(m, fh, fw)[i0: i0 + crop, j0: j0 + crop]
        out.append(_resize_mask(m, mh, mw))
    return np.stack(out).astype(np.int64)


def sample_negatives_and_remap(
    mask_target: np.ndarray,  # (T, H, W) int class ids, 0 = background
    num_classes: int,
    max_classes: int = 100,
    rng: Optional[random.Random] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """<=max_classes-class negative sampling + label remapping (reference
    modeling_timesformer_siglip.py:1844-1882). Returns (selected_class_ids
    (max_classes,), remapped_target (T, H, W) with -1 ignore)."""
    rng = rng if rng is not None else random.Random(0)
    if num_classes <= max_classes:
        sel = np.arange(num_classes)
        remapped = mask_target.astype(np.int64).copy()
        remapped[remapped == 0] = -1  # background ignored (:1935-1938)
        pad = np.full(max_classes - num_classes, -1, np.int64)
        return np.concatenate([sel, pad]), remapped
    uniq = np.unique(mask_target)
    uniq = uniq[uniq > 0]
    num_neg = min(max_classes - len(uniq), num_classes - len(uniq))
    negatives = list(set(range(num_classes)) - set(uniq.tolist()))
    sel_neg = rng.sample(negatives, num_neg)
    selected = np.concatenate([uniq, np.asarray(sel_neg, np.int64)])
    mapping = {int(old): new for new, old in enumerate(selected)}
    remapped = np.full(mask_target.shape, -1, np.int64)
    for old, new in mapping.items():
        remapped[mask_target == old] = new
    pad = np.full(max_classes - len(selected), -1, np.int64)
    return np.concatenate([selected, pad]), remapped


class VISDataset(_RetryDataset):
    """Open-vocabulary VIS training samples (reference TaskVISDataset,
    task_vis.py:46-587). YTVIS-style JSON annotation:

    {"videos": [{id, file_names, height, width}],
     "annotations": [{video_id, category_id, segmentations: [poly|rle|None]}],
     "categories": [{id, name}]}

    COCO-pseudo entries carry {"image": path, "segmentation": ..} rows and
    are rotated into clips.
    """

    def __init__(
        self,
        anno_path: str,
        task_name: str = "TaskVIS",
        dataset_name: str = "YoutubeVIS",
        prefix: str = "",
        num_frames: int = 8,
        crop_size: int = 224,
        mask_size: Tuple[int, int] = (224, 224),
        pseudo_video: bool = False,
        max_classes: int = 100,
    ):
        self.task_name = task_name
        self.dataset_name = dataset_name
        self.prefix = prefix
        self.num_frames = num_frames
        self.crop_size = crop_size
        self.mask_size = mask_size
        self.pseudo_video = pseudo_video
        self.max_classes = max_classes
        with open(anno_path) as f:
            data = json.load(f)
        self.videos = {v["id"]: v for v in data["videos"]}
        self.annos: Dict[int, List[Dict]] = {}
        for a in data.get("annotations", []):
            self.annos.setdefault(a["video_id"], []).append(a)
        self.ids = sorted(self.videos)
        self.categories = {c["id"]: c["name"] for c in data.get("categories", [])}
        self.num_classes = (max(self.categories) + 1) if self.categories else 1
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Re-seed per-sample negative draws: (epoch, index)-keyed, so the
        head sees VARIED negatives across epochs (the reference redraws
        every step, modeling_timesformer_siglip.py:1844-1882) while any
        (epoch, index) pair replays identically on resume. A fixed
        Random(0) per call contrasted each video against one frozen
        negative subset forever (regression r4)."""
        self._epoch = epoch

    def __len__(self):
        return len(self.ids)

    def _load_frames(self, video) -> Tuple[np.ndarray, List[int]]:
        import cv2

        names = video["file_names"]
        total = len(names)
        idx = np.linspace(0, total - 1, self.num_frames).astype(int).tolist()
        frames = []
        for i in idx:
            img = cv2.imread(os.path.join(self.prefix, names[i]))
            if img is None:
                raise IOError(names[i])
            frames.append(cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
        return np.stack(frames), idx

    def _rasterize(self, video, annos, frame_idx) -> np.ndarray:
        h, w = video["height"], video["width"]
        mask = np.zeros((len(frame_idx), h, w), np.int64)
        for a in annos:
            cid = a["category_id"]
            for out_t, src_t in enumerate(frame_idx):
                seg = a["segmentations"][src_t]
                if seg is None:
                    continue
                if isinstance(seg, dict):
                    m = rle_to_mask(seg, h, w)
                else:
                    m = polygons_to_mask(seg, h, w)
                mask[out_t][m] = cid
        return mask

    def get_item(self, index):
        vid = self.ids[index]
        video = self.videos[vid]
        annos = self.annos.get(vid, [])
        frames, idx = self._load_frames(video)
        mask = self._rasterize(video, annos, idx)

        # synchronized resize (PairResize semantics): short side then resize
        # masks with nearest
        frames = _host_resize_short(frames, self.crop_size)
        t, fh, fw = frames.shape[:3]
        # center crop both to crop_size
        i0 = max((fh - self.crop_size) // 2, 0)
        j0 = max((fw - self.crop_size) // 2, 0)
        frames = frames[:, i0 : i0 + self.crop_size, j0 : j0 + self.crop_size]
        mh, mw = self.mask_size
        mask = _masks_like_frames(mask, fh, fw, i0, j0, self.crop_size,
                                  mh, mw)

        selected, remapped = sample_negatives_and_remap(
            mask, self.num_classes, self.max_classes,
            rng=random.Random((self._epoch << 32) | (index & 0xFFFFFFFF)),
        )
        return {
            "task_name": self.task_name,
            "task_input": {
                "frames": frames,
                "mask_target": remapped,
                "selected_classes": selected,
                "dataset": self.dataset_name,
            },
        }


class ReferVOSDataset(_RetryDataset):
    """Referring VOS samples (reference TaskReferVOSDataset,
    task_refervos.py): JSON rows {"video": dir-or-file, "frames": [...],
    "expression": str, "masks": [png paths] or polygons}."""

    def __init__(
        self,
        anno_path: str,
        task_name: str = "TaskReferVOS",
        prefix: str = "",
        num_frames: int = 8,
        crop_size: int = 224,
        mask_size: Tuple[int, int] = (224, 224),
    ):
        self.task_name = task_name
        self.prefix = prefix
        self.num_frames = num_frames
        self.crop_size = crop_size
        self.mask_size = mask_size
        with open(anno_path) as f:
            self.rows = json.load(f)

    def __len__(self):
        return len(self.rows)

    def get_item(self, index):
        import cv2

        row = self.rows[index]
        names = row["frames"]
        idx = np.linspace(0, len(names) - 1, self.num_frames).astype(int)
        frames, masks = [], []
        for i in idx:
            img = cv2.imread(os.path.join(self.prefix, names[i]))
            if img is None:
                raise IOError(names[i])
            frames.append(cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
            mp = row["masks"][i]
            m = cv2.imread(os.path.join(self.prefix, mp), cv2.IMREAD_GRAYSCALE)
            if m is None:
                raise IOError(mp)
            masks.append((m > 127).astype(np.int64))
        frames = np.stack(frames)
        masks = np.stack(masks)
        frames = _host_resize_short(frames, self.crop_size)
        t, fh, fw = frames.shape[:3]
        i0 = max((fh - self.crop_size) // 2, 0)
        j0 = max((fw - self.crop_size) // 2, 0)
        frames = frames[:, i0 : i0 + self.crop_size, j0 : j0 + self.crop_size]
        mh, mw = self.mask_size
        masks = _masks_like_frames(masks, fh, fw, i0, j0, self.crop_size,
                                   mh, mw)
        return {
            "task_name": self.task_name,
            "task_input": {
                "frames": frames,
                "mask_target": masks,  # {0 bg, 1 fg}; bg stays ignore in head
                "caption": str(row["expression"]),
            },
        }
