"""Task dataset classes: the port's own copy of the JAX package's
``data/datasets.py`` (host side: decode, sample, a light resize; the
augmentation runs on the device, ``data.collate``).

Contract parity with the reference: every ``__getitem__`` returns
``{"task_name": str, "task_input": {...}}`` (e.g. kinetics_sparse.py:202-210)
and any decode error resamples a random index
(kinetics_sparse.py:313-315, task_grounding.py:249-251 — data-level fault
tolerance, SURVEY §5.3).

Annotation formats match the reference:
* classification: header-less CSV ``path<delim>label``
  (kinetics_sparse.py:92-95);
* retrieval: pandas CSV with dataset/video/caption columns
  (task_retrieval.py:29-49);
* grounding/localization: JSON rows with (video, start, end, sentence /
  label, duration) (task_grounding.py:52-, task_localization.py:259-).
"""

from __future__ import annotations

import json
import os
import random
from typing import Any, Dict, List, Optional

import numpy as np

from streamformer_tpu_torch.data import video_io


class _RetryDataset:
    """Shared error-resilient __getitem__ (random reindex on failure)."""

    _max_retries = 10

    def set_epoch(self, epoch: int) -> None:
        """Key per-sample draws (temporal frame sampling) by
        (epoch, index): draws vary across epochs but any (epoch, index)
        pair replays identically — so a resumed run, and the same run at a
        different world size (rank-strided sampler shards), see the SAME
        frames for the same sample. The reference's unseeded per-worker
        torch RNG has neither property (sampler.py:87 seeds only the
        schedule, not the per-sample draws)."""
        self._epoch = epoch

    def _sample_rng(self, index: int) -> np.random.Generator:
        return np.random.default_rng((getattr(self, "_epoch", 0), index))

    def __getitem__(self, index):
        for _ in range(self._max_retries):
            try:
                return self.get_item(index)
            except Exception as e:  # noqa: BLE001 — reference catches all
                index = random.randint(0, len(self) - 1)
                last = e
        raise RuntimeError(f"{type(self).__name__}: retries exhausted: {last}")


def _host_resize_short(frames: np.ndarray, short: int) -> np.ndarray:
    """Cheap host resize (short side) to bound H2D transfer; device transforms
    do the precise crops."""
    import cv2

    t, h, w, c = frames.shape
    if min(h, w) == short:
        return frames
    if h < w:
        nh, nw = short, max(1, round(w * short / h))
    else:
        nh, nw = max(1, round(h * short / w)), short
    return np.stack(
        [cv2.resize(f, (nw, nh), interpolation=cv2.INTER_LINEAR) for f in frames]
    )


def _test_spatial_crop(frames: np.ndarray, split_nb: int,
                       num_crop: int) -> np.ndarray:
    """(T, H, W, C) -> (T, S, S, C): square test-view crop at view
    ``split_nb`` along the LONGER axis (the reference's multi-crop test
    protocol, kinetics_sparse.py:151-160: spatial_step =
    (long - short) / (num_crop - 1)). num_crop == 1 degrades to the center
    crop. Host-side so every test view is a uniform square (mixed aspect
    ratios stack into one batch) and the crops are actually DIFFERENT —
    a device center-crop downstream would make all views identical."""
    t, h, w, c = frames.shape
    s = min(h, w)
    if num_crop <= 1:
        oy, ox = (h - s) // 2, (w - s) // 2
    else:
        step = (max(h, w) - s) / (num_crop - 1)
        off = int(round(split_nb * step))
        oy, ox = (off, 0) if h >= w else (0, off)
    return frames[:, oy : oy + s, ox : ox + s]


def _map_label(label2id: Optional[Dict], raw) -> np.int64:
    """Remap an annotation label through label2id like the reference
    (`label_list = [self.label2id[label] ...]`, kinetics_sparse.py:194-195).
    Without the remap, non-contiguous raw labels (e.g. {3, 7, 42}) index
    past the head's class table and the head's one-hot silently drops
    them — all-negative targets, no error."""
    if not label2id:
        return np.int64(raw)
    key = str(raw)
    return np.int64(label2id[key] if key in label2id else label2id[raw])


class VideoClsSparseDataset(_RetryDataset):
    """TSN sparse-sampled classification (reference VideoClsDataset_sparse,
    kinetics_sparse.py:39-535). task_name: Kinetics / SSV2."""

    def __init__(
        self,
        anno_path: str,
        task_name: str = "Kinetics",
        prefix: str = "",
        split: str = " ",
        mode: str = "train",
        clip_len: int = 16,
        short_side_size: int = 256,
        test_num_segment: int = 1,
        test_num_crop: int = 1,
        label2id: Optional[Dict[str, int]] = None,
    ):
        import pandas as pd

        self.task_name = task_name
        self.prefix = prefix
        self.mode = mode
        self.clip_len = clip_len
        self.short_side_size = short_side_size
        self.test_num_segment = test_num_segment
        self.test_num_crop = test_num_crop
        cleaned = pd.read_csv(anno_path, header=None, delimiter=split)
        self.samples = list(cleaned.values[:, 0])
        self.labels = list(cleaned.values[:, 1])
        self.label2id = label2id
        if mode == "test":
            self.views = video_io.test_views(test_num_segment, test_num_crop)

    def __len__(self):
        n = len(self.samples)
        return n * len(self.views) if self.mode == "test" else n

    def get_item(self, index):
        if self.mode == "test":
            vid_idx, view_idx = divmod(index, len(self.views))
            chunk_nb, split_nb = self.views[view_idx]
        else:
            vid_idx, chunk_nb, split_nb = index, 0, 0
        path = os.path.join(self.prefix, str(self.samples[vid_idx]))
        vr = video_io.VideoReader(path)
        idx = video_io.sparse_sample_indices(
            len(vr),
            self.clip_len,
            mode={"train": "train", "validation": "validation"}.get(
                self.mode, "test"
            ),
            test_chunk=chunk_nb,
            test_num_segment=self.test_num_segment,
            rng=self._sample_rng(index),
        )
        frames = vr.get_batch(idx)
        vr.close()
        frames = _host_resize_short(frames, self.short_side_size)
        if self.mode == "test":
            frames = _test_spatial_crop(frames, split_nb, self.test_num_crop)
        out = {
            "task_name": self.task_name,
            "task_input": {
                "frames": frames,  # (T, H, W, C) uint8
                "label": _map_label(getattr(self, "label2id", None),
                                    self.labels[vid_idx]),
            },
        }
        if self.mode == "test":
            out["task_input"].update(
                {"chunk_nb": chunk_nb, "split_nb": split_nb, "sample_idx": vid_idx}
            )
        return out


class VideoClsDenseDataset(VideoClsSparseDataset):
    """Dense (strided clip_len x sampling_rate) classification — the
    reference ``VideoClsDataset`` (kinetics.py:36-) and the SSV2 video
    variant (``SSVideoClsDataset``, ssv2.py:417-) share this sampling;
    differs from the sparse TSN loader only in the frame-index scheme."""

    def __init__(self, *args, sampling_rate: int = 4, **kw):
        super().__init__(*args, **kw)
        self.sampling_rate = sampling_rate

    def get_item(self, index):
        if self.mode == "test":
            vid_idx, view_idx = divmod(index, len(self.views))
            chunk_nb, split_nb = self.views[view_idx]
        else:
            vid_idx, chunk_nb, split_nb = index, 0, 0
        path = os.path.join(self.prefix, str(self.samples[vid_idx]))
        vr = video_io.VideoReader(path)
        idx = video_io.dense_sample_indices(
            len(vr),
            self.clip_len,
            self.sampling_rate,
            mode={"train": "train", "validation": "validation"}.get(
                self.mode, "test"
            ),
            test_chunk=chunk_nb,
            test_num_segment=self.test_num_segment,
            rng=self._sample_rng(index),
        )
        frames = vr.get_batch(idx)
        vr.close()
        frames = _host_resize_short(frames, self.short_side_size)
        if self.mode == "test":
            frames = _test_spatial_crop(frames, split_nb, self.test_num_crop)
        out = {
            "task_name": self.task_name,
            "task_input": {
                "frames": frames,
                "label": _map_label(getattr(self, "label2id", None),
                                    self.labels[vid_idx]),
            },
        }
        if self.mode == "test":
            out["task_input"].update(
                {"chunk_nb": chunk_nb, "split_nb": split_nb, "sample_idx": vid_idx}
            )
        return out


class TALWindowedDataset(_RetryDataset):
    """Full-video windowed temporal-action-localization (THUMOS14-style).

    The reference ships the consuming pieces — the fake-batch sampler path
    (sampler.py:393-443), the no-collate gt fields
    (utils.py:1150-1197) and TimesformerNaiveLocalizationHead's
    [B*W, T, D] -> [B, W*T, D] reshape with python-rasterized ±1/0 targets
    (modeling_timesformer_siglip.py:2120-2177) — while its TAL dataset
    classes are commented out of datasets/build.py. This implements the
    producer: one sample = ONE whole video resampled to ``window_size``
    frames (segment-random in train / linspace otherwise, the
    task_localization.py:393-405 scheme), with gt segments converted to
    window-frame units for host-side rasterization in the collate layer.

    Annotation rows: {"video", "duration"?, "segments": [[s, e], ...] sec,
    "labels": [name-or-id, ...]}.
    """

    def __init__(
        self,
        anno_path: str,
        task_name: str = "THUMOS14",
        prefix: str = "",
        mode: str = "train",
        window_size: int = 384,
        clip_len: int = 16,
        short_side_size: int = 256,
        label2id: Optional[Dict[str, int]] = None,
    ):
        assert window_size % clip_len == 0, (window_size, clip_len)
        self.task_name = task_name
        self.prefix = prefix
        self.mode = mode
        self.window_size = window_size
        self.clip_len = clip_len
        self.short_side_size = short_side_size
        self.label2id = label2id or {}
        with open(anno_path) as f:
            first = f.read(1)
            f.seek(0)
            self.rows = (
                json.load(f) if first == "[" else
                [json.loads(l) for l in f if l.strip()]
            )

    def __len__(self):
        return len(self.rows)

    def get_item(self, index):
        row = self.rows[index]
        path = os.path.join(self.prefix, row["video"])
        vr = video_io.VideoReader(path)
        total = len(vr)
        fps = max(vr.fps, 1e-6)
        duration = float(row.get("duration", total / fps))

        w = self.window_size
        if self.mode == "train":
            # one random frame per uniform segment (loadvideo_decord train)
            seg = max(0.0, float(total - 1) / w)
            rng = self._sample_rng(index)
            lo = np.round(seg * np.arange(w)).astype(np.int64)
            hi = np.round(seg * (np.arange(w) + 1)).astype(np.int64)
            idx = np.minimum(
                rng.integers(lo, np.maximum(hi, lo) + 1), total - 1
            )
        else:
            idx = np.linspace(0, total - 1, w).astype(np.int64)
        times = idx / fps
        frames = vr.get_batch(idx)
        vr.close()
        frames = _host_resize_short(frames, self.short_side_size)

        # gt segments in window-frame units: frame j covers times[j]; a
        # segment [s, e] seconds maps to the covered index range
        gt_segments, gt_labels = [], []
        for (s, e), lab in zip(row.get("segments", []), row.get("labels", [])):
            s_f, e_f = float(s), float(e)
            covered = np.where((times >= s_f) & (times <= e_f))[0]
            if len(covered) == 0:
                # an action shorter than the sampling stride covers no
                # sampled frame; snap it to the nearest frame — dropping it
                # would rasterize its frames as background and actively
                # train the model that the action is absent
                j = int(np.argmin(np.abs(times - 0.5 * (s_f + e_f))))
                covered = np.asarray([j])
            gt_segments.append([float(covered[0]), float(covered[-1])])
            gt_labels.append(int(self.label2id.get(str(lab), lab)))
        return {
            "task_name": self.task_name,
            "task_input": {
                "frames": frames,  # (window_size, H, W, C) uint8
                "gt_segments": np.asarray(gt_segments, np.float32).reshape(-1, 2),
                "gt_labels": np.asarray(gt_labels, np.int64),
                "frame_mask": np.ones(w, bool),
                "duration": duration,
            },
        }


class RetrievalDataset(_RetryDataset):
    """Video-text retrieval (reference TaskRetrievalDataset,
    task_retrieval.py:29-329)."""

    def __init__(
        self,
        anno_path: str,
        task_name: str = "TaskRetrieval",
        mode: str = "train",
        clip_len: int = 16,
        short_side_size: int = 256,
        data_dict: Optional[Dict] = None,
    ):
        import pandas as pd

        self.task_name = task_name
        self.mode = mode
        self.clip_len = clip_len
        self.short_side_size = short_side_size
        self.samples = pd.read_csv(anno_path)
        self.data_dict = data_dict or {}

    def __len__(self):
        return len(self.samples)

    def get_item(self, index):
        row = self.samples.iloc[index]
        ds = row.get("dataset", "MSRVTT")
        root = self.data_dict.get("root_dir", {}).get(ds, "")
        path = os.path.join(root, str(row["video"]))
        trimmed = self.data_dict.get("trimmed30s", {}).get(ds, False)
        vr = video_io.VideoReader(path)
        total = len(vr)
        if trimmed and vr.fps > 0:
            total = min(total, int(30 * vr.fps))
        idx = video_io.retrieval_sample_indices(
            total, self.clip_len, "rand" if self.mode == "train" else "middle",
            rng=self._sample_rng(index),
        )
        frames = vr.get_batch(idx)
        vr.close()
        frames = _host_resize_short(frames, self.short_side_size)
        return {
            "task_name": self.task_name,
            "task_input": {"frames": frames, "caption": str(row["caption"])},
        }


class GroundingDataset(_RetryDataset):
    """Temporal grounding (reference TaskGroundingDataset,
    task_grounding.py:52-419): rows (video, start, end, sentence, duration);
    per-frame ±1 labels from window membership."""

    def __init__(
        self,
        anno_path: str,
        task_name: str = "TaskGrounding",
        prefix: str = "",
        mode: str = "train",
        clip_len: int = 16,
        short_side_size: int = 256,
        sampler: str = "uniform",  # "uniform" | "fixfps"
        fps: float = 0.5,
    ):
        self.task_name = task_name
        self.prefix = prefix
        self.mode = mode
        self.clip_len = clip_len
        self.short_side_size = short_side_size
        self.sampler = sampler
        self.fps = fps
        rows = []
        with open(anno_path) as f:
            first = f.read(1)
            f.seek(0)
            if first == "[":
                rows = json.load(f)
            else:
                rows = [json.loads(l) for l in f if l.strip()]
        self.rows = rows

    def __len__(self):
        return len(self.rows)

    def get_item(self, index):
        row = self.rows[index]
        path = os.path.join(self.prefix, row["video"])
        vr = video_io.VideoReader(path)
        total = len(vr)
        duration = float(row.get("duration", total / max(vr.fps, 1e-6)))
        start = float(row.get("start", row.get("relevant_windows", [[0, 0]])[0][0]))
        end = float(row.get("end", row.get("relevant_windows", [[0, 0]])[0][1]))

        if self.sampler == "fixfps":
            # window-centred expansion at fixed fps (task_grounding.py:253-)
            stride = max(vr.fps / self.fps, 1.0)
            center = (start + end) / 2 / max(duration, 1e-6) * total
            half = self.clip_len / 2 * stride
            lo = int(np.clip(center - half, 0, max(total - 1, 0)))
            idx = np.clip(
                lo + np.arange(self.clip_len) * stride, 0, total - 1
            ).astype(np.int64)
        else:
            idx = video_io.retrieval_sample_indices(
                total, self.clip_len, "rand" if self.mode == "train" else "middle",
                rng=self._sample_rng(index),
            )
        times = idx / max(vr.fps, 1e-6)
        labels = ((times >= start) & (times <= end)).astype(np.float32)
        frames = vr.get_batch(idx)
        vr.close()
        frames = _host_resize_short(frames, self.short_side_size)
        out = {
            "task_name": self.task_name,
            "task_input": {
                "frames": frames,
                "caption": str(row.get("sentence", row.get("query", ""))),
                "label": labels,
            },
        }
        if self.mode != "train":
            out["task_input"]["meta"] = {
                "duration": duration,
                "times": times,
                "gt": (start, end),
                "qid": row.get("qid", index),
            }
        return out


class LocalizationDataset(GroundingDataset):
    """Temporal localization with class labels (reference
    TaskLocalizationDataset, task_localization.py:259-427): like grounding
    but labels are class ids; in-window=class, out-of-window=-1."""

    def __init__(self, *args, label2id: Optional[Dict[str, int]] = None,
                 dataset_name: str = "TaskLocalization", **kw):
        super().__init__(*args, **kw)
        self.label2id = label2id or {}
        self.dataset_name = dataset_name

    def get_item(self, index):
        out = super().get_item(index)
        row = self.rows[index]
        cls = self.label2id.get(str(row.get("label", "")), 0)
        frame_mask = out["task_input"].pop("label")  # (T,) {0,1}
        labels = np.where(frame_mask > 0, cls, -1).astype(np.int64)
        out["task_input"]["label"] = labels
        out["task_input"]["dataset"] = self.dataset_name
        out["task_input"].pop("caption", None)
        return out


class MultiTaskDataset:
    """Concatenated union with bisect routing + small-dataset balancing
    (reference MultiTaskDataset, datasets/multi_task.py:14-72)."""

    def __init__(self, datasets: List, balance: bool = False, scale: float = 1.0):
        import bisect

        self._bisect = bisect
        if balance and datasets:
            datasets = self._balance(datasets, scale)
        self.datasets = datasets
        self.lengths = [len(d) for d in datasets]
        self.cum = np.cumsum(self.lengths).tolist()

    @property
    def unified_dataset_lengths(self):
        return self.lengths

    @staticmethod
    def _balance(datasets, scale):
        """Replicate small datasets toward the max length
        (reference _balance_sample_num/copy_dataset, multi_task.py:44-58)."""
        target = max(len(d) for d in datasets) * scale

        class _Repeated:
            def __init__(self, ds, reps):
                self.ds, self.reps = ds, reps

            def __len__(self):
                return len(self.ds) * self.reps

            def __getitem__(self, i):
                return self.ds[i % len(self.ds)]

            def __getattr__(self, a):
                return getattr(self.ds, a)

        out = []
        for d in datasets:
            reps = max(1, int(round(target / max(len(d), 1))))
            out.append(_Repeated(d, reps) if reps > 1 else d)
        return out

    def __len__(self):
        return self.cum[-1] if self.cum else 0

    def __getitem__(self, index):
        ds_idx = self._bisect.bisect_right(self.cum, index)
        prev = self.cum[ds_idx - 1] if ds_idx > 0 else 0
        return self.datasets[ds_idx][index - prev]

    def task_specs(self):
        from streamformer_tpu_torch.data.samplers import task_specs_from_lengths

        names = []
        for d in self.datasets:
            names.append(getattr(d, "task_name", type(d).__name__))
        return task_specs_from_lengths(names, self.lengths)


class RawFrameClsDataset(_RetryDataset):
    """Raw-frame classification dataset (reference SSRawFrameClsDataset,
    datasets/ssv2.py:37): videos stored as frame directories with
    ``img_{:05d}.jpg`` files; TSN sparse sampling over the frame count.
    Anno CSV rows: ``dir<delim>total_frames<delim>label``."""

    def __init__(
        self,
        anno_path: str,
        task_name: str = "SSV2",
        prefix: str = "",
        split: str = " ",
        mode: str = "train",
        clip_len: int = 16,
        short_side_size: int = 256,
        filename_tmpl: str = "img_{:05}.jpg",
        test_num_segment: int = 1,
        test_num_crop: int = 1,
    ):
        import pandas as pd

        self.task_name = task_name
        self.prefix = prefix
        self.mode = mode
        self.clip_len = clip_len
        self.short_side_size = short_side_size
        self.filename_tmpl = filename_tmpl
        self.test_num_segment = test_num_segment
        self.test_num_crop = test_num_crop
        cleaned = pd.read_csv(anno_path, header=None, delimiter=split)
        self.samples = list(cleaned.values[:, 0])
        self.total_frames = list(cleaned.values[:, 1])
        self.labels = list(cleaned.values[:, -1])
        if mode == "test":
            self.views = video_io.test_views(test_num_segment, test_num_crop)

    def __len__(self):
        n = len(self.samples)
        return n * len(self.views) if self.mode == "test" else n

    def get_item(self, index):
        import cv2

        if self.mode == "test":
            vid_idx, view_idx = divmod(index, len(self.views))
            chunk_nb, split_nb = self.views[view_idx]
        else:
            vid_idx, chunk_nb, split_nb = index, 0, 0
        total = int(self.total_frames[vid_idx])
        idx = video_io.sparse_sample_indices(
            total,
            self.clip_len,
            mode={"train": "train", "validation": "validation"}.get(
                self.mode, "test"
            ),
            test_chunk=chunk_nb,
            test_num_segment=self.test_num_segment,
            rng=self._sample_rng(index),
        )
        vdir = os.path.join(self.prefix, str(self.samples[vid_idx]))
        frames = []
        for i in idx:
            img = cv2.imread(os.path.join(vdir, self.filename_tmpl.format(i + 1)))
            if img is None:
                raise IOError(vdir)
            frames.append(cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
        frames = _host_resize_short(np.stack(frames), self.short_side_size)
        if self.mode == "test":
            frames = _test_spatial_crop(frames, split_nb, self.test_num_crop)
        out = {
            "task_name": self.task_name,
            "task_input": {
                "frames": frames,
                "label": _map_label(getattr(self, "label2id", None),
                                    self.labels[vid_idx]),
            },
        }
        if self.mode == "test":
            # same multi-view keys as the video datasets — final_test's
            # per-video softmax merge needs sample_idx
            out["task_input"].update(
                {"chunk_nb": chunk_nb, "split_nb": split_nb,
                 "sample_idx": vid_idx}
            )
        return out
