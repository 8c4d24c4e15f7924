"""Per-task collation into the heads' input schemas, the augmentations on
the device, and the multitask loader: the port of the JAX package's
``data/collate.py``.

The loader runs

  sampler batch -> host fetch (thread pool) -> numpy stack -> (pinned)
  uint8 batch -> the card -> augmentation -> task inputs -> (task, batch)

with a prefetch thread that does host work only (decode, the numpy stack,
pinning) and a main thread that moves the batch to the model's device,
augments it there and assembles the task inputs.

Randomness: a batch's op choice draws from a generator seeded with
``(aug_seed, step)``, each sample's draws from one seeded with ``(aug_seed,
step, dataset index)``. A sample is therefore augmented the same whether its
batch reaches the process whole or rank-strided, and a resumed epoch
(``set_epoch(epoch, start_step)``) replays its batches' augmentations
without decoding the batches it skips.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from streamformer_tpu_torch.data import rand_augment as RA
from streamformer_tpu_torch.data import random_erasing as RE
from streamformer_tpu_torch.data import transforms as T
from streamformer_tpu_torch.data.samplers import PAD_INDEX
from streamformer_tpu_torch.models.multitask import head_type_for_task


def seed_of(*keys: int) -> int:
    """A 63-bit generator seed that depends on the non-negative ints
    ``keys`` alone."""
    return int(np.random.SeedSequence(list(keys)).generate_state(1, np.uint64)[0] >> np.uint64(1))


class TrainAugment:
    """The per-clip train augmentation of the reference Kinetics recipe, on
    batches: RandAugment, a random resized crop to ``crop_size``, a
    horizontal flip, normalize and RandomErasing (cube, pixel noise).

    ``draw`` reads the host generators and returns the batch's parameters;
    ``apply`` is deterministic, runs on the clips' device and turns (B, T,
    H, W, C) uint8 into (B, T, C, crop, crop) float32."""

    def __init__(self, crop_size: int = 224, use_rand_augment: bool = True,
                 ra_config: str = "rand-m7-n4-mstd0.5-inc1", reprob: float = 0.25,
                 mean=T.SIGLIP_MEAN, std=T.SIGLIP_STD):
        self.crop_size = crop_size
        self.use_rand_augment = use_rand_augment
        self.ra_config = ra_config
        self.reprob = reprob
        self.mean, self.std = mean, std

    def draw(self, aug_seed: int, step: int, sample_ids: Sequence[int], h: int, w: int
             ) -> Dict[str, Any]:
        """The draws of the batch at ``step`` whose samples are the dataset
        indices ``sample_ids`` on (h, w) frames."""
        s = self.crop_size
        out: Dict[str, Any] = {"ops": RA.draw_ops(torch.Generator().manual_seed(
            seed_of(aug_seed, step)), self.ra_config)}
        per = []
        for i in sample_ids:
            g = torch.Generator().manual_seed(seed_of(aug_seed, step, int(i)))
            per.append({
                "layers": RA.draw_layers(g, self.ra_config) if self.use_rand_augment else [],
                "box": T.draw_resized_crop(g, h, w),
                "flip": T.draw_bernoulli(g, 0.5),
                "erase": RE.draw_erasing(g, s, s, self.reprob) if self.reprob > 0 else None,
                "noise_seed": int(torch.randint(0, 2**62, (), generator=g)),
            })
        out["samples"] = per
        return out

    def apply(self, clips: torch.Tensor, draws: Dict[str, Any]) -> torch.Tensor:
        per = draws["samples"]
        s = self.crop_size
        x = clips.float()
        if self.use_rand_augment:
            x = RA.rand_augment(x, draws["ops"], [d["layers"] for d in per], self.ra_config)
        x = x / T.host_to(255.0, x.device)
        x = T.resized_crop(x, [d["box"] for d in per], (s, s))
        x = T.flip_where(x, [d["flip"] for d in per])
        x = (x - T.host_to(self.mean, x.device)) / T.host_to(self.std, x.device)
        boxes = [d["erase"] for d in per]
        if any(b is not None for b in boxes):
            x = RE.apply_erasing(x, boxes, RE.erasing_fill(x, boxes, [d["noise_seed"] for d in per]))
        return T.to_model_input(x)

    def __call__(self, clips: torch.Tensor, aug_seed: int, step: int,
                 sample_ids: Optional[Sequence[int]] = None) -> torch.Tensor:
        ids = range(clips.shape[0]) if sample_ids is None else sample_ids
        return self.apply(clips, self.draw(aug_seed, step, ids, clips.shape[2], clips.shape[3]))


def make_train_augment(crop_size: int = 224, use_rand_augment: bool = True,
                       ra_config: str = "rand-m7-n4-mstd0.5-inc1", reprob: float = 0.25,
                       mean=T.SIGLIP_MEAN, std=T.SIGLIP_STD) -> TrainAugment:
    return TrainAugment(crop_size, use_rand_augment, ra_config, reprob, mean, std)


def make_eval_augment(crop_size: int = 224, mean=T.SIGLIP_MEAN, std=T.SIGLIP_STD):
    """(B, T, H, W, C) uint8 -> (B, T, C, crop, crop): centre crop and
    normalize."""

    def batch(clips: torch.Tensor) -> torch.Tensor:
        x = T.center_crop(clips, (crop_size, crop_size))
        return T.to_model_input(T.normalize(x, mean, std))

    return batch


class MultitaskLoader:
    """Iterates (task_name, batch) pairs for ``MultitaskTrainer``, each
    batch on the model's device."""

    def __init__(self, dataset, sampler, model, crop_size: int = 224, train: bool = True,
                 num_workers: int = 8, prefetch: int = 2, aug_seed: int = 0):
        self.dataset = dataset  # MultiTaskDataset
        self.sampler = sampler  # DistributedBatchTask*Sampler
        self.model = model  # MultitaskModel: tokenizer, label tables, device
        self.train = train
        self.aug = make_train_augment(crop_size) if train else make_eval_augment(crop_size)
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.aug_seed = aug_seed
        self.device = model.device
        self._epoch = 0
        self._start_step = 0
        # a lazy persistent decode pool (threads: cv2 releases the GIL, and
        # worker processes would reopen every VideoCapture per batch)
        self._pool = None

    def set_epoch(self, epoch: int, start_step: int = 0):
        """``start_step`` skips that many leading batches without fetching
        or decoding them (mid-epoch resume). Batch ``step`` numbering stays
        absolute, so the augmentation draws equal an uninterrupted epoch's."""
        self._epoch = epoch
        self._start_step = start_step
        self.sampler.set_epoch(epoch)
        # datasets with per-sample draws (frame sampling, VIS negatives)
        # re-seed per (epoch, index)
        for ds in getattr(self.dataset, "datasets", []):
            if hasattr(ds, "set_epoch"):
                ds.set_epoch(epoch)

    def __len__(self):
        return len(self.sampler)

    # ------------------------------------------------------------------

    def _fetch(self, indices: List[int]) -> List[Dict]:
        real = [i for i in indices if i != PAD_INDEX]
        if self.num_workers > 1 and len(real) > 1:
            if self._pool is None:
                from concurrent.futures import ThreadPoolExecutor

                self._pool = ThreadPoolExecutor(self.num_workers)
            return list(self._pool.map(self.dataset.__getitem__, real))
        return [self.dataset[i] for i in real]

    def close(self):
        """Release the decode pool (also at garbage collection)."""
        if getattr(self, "_pool", None) is not None:
            self._pool.shutdown(wait=False)
            self._pool = None

    def __del__(self):
        self.close()

    def _collate_host(self, samples: List[Dict], indices: List[int]
                      ) -> Tuple[str, torch.Tensor, List[Dict], List[int]]:
        """Host work only (the prefetch thread): the numpy stack, pinned when
        the batch goes to a CUDA device."""
        task = samples[0]["task_name"]
        tis = [s["task_input"] for s in samples]
        frames = torch.from_numpy(np.stack([ti["frames"] for ti in tis]))  # (B, T, H, W, C) u8
        if self.device.type == "cuda":
            frames = frames.pin_memory()
        return task, frames, tis, indices

    def _finalize(self, task: str, frames: torch.Tensor, tis: List[Dict], step: int,
                  ids: Optional[List[int]] = None):
        """The device half (the main thread): copy, augment, task inputs."""
        dev = self.device
        kind = head_type_for_task(task)
        clips = frames.to(dev, non_blocking=True)
        if self.train:
            pixel_values = self.aug(clips, self.aug_seed, step, ids)
        else:
            pixel_values = self.aug(clips)

        def on_dev(a, dtype=None):
            return T.host_to(np.asarray(a, dtype=dtype), dev)

        task_input: Dict[str, Any] = {}
        if kind == "classification":
            task_input["label"] = on_dev([ti["label"] for ti in tis])
            task_input["label_embeddings"] = self.model.label_embeddings[task]
        elif kind == "retrieval":
            task_input["caption_ids"] = on_dev(self.model.tokenize([ti["caption"] for ti in tis]))
        elif kind == "grounding":
            task_input["caption_ids"] = on_dev(self.model.tokenize([ti["caption"] for ti in tis]))
            task_input["label"] = on_dev(np.stack([ti["label"] for ti in tis]), np.float32)
        elif kind == "naive_localization" and "gt_segments" in tis[0]:
            # full-video windowed TAL: one real video a batch; the gt segments
            # become per-frame +1/-1/0 targets here, and the W-frame video
            # W / T encoder clips
            ti = tis[0]
            w = int(ti["frames"].shape[0])
            tclip = self.model.cfg.num_frames
            table = self.model.label_embeddings[task]  # (L, D)
            target = -np.ones((w, int(table.shape[0])), np.float32)
            target[~np.asarray(ti["frame_mask"], bool)] = 0.0
            for (s, e), lab in zip(np.asarray(ti["gt_segments"]).reshape(-1, 2),
                                   np.asarray(ti["gt_labels"]).reshape(-1)):
                s_idx = int(s) if float(s) == int(s) else int(s) + 1
                target[s_idx:int(e) + 1, int(lab)] = 1.0
            task_input["label_embeddings"] = table
            task_input["target_labels"] = on_dev(target[None])
            pixel_values = pixel_values.reshape(-1, tclip, *pixel_values.shape[2:])
        elif kind in ("universal_localization", "naive_localization"):
            tables = self.model.label_embeddings[task]
            if isinstance(tables, dict):  # per-dataset tables, padded to the longest
                lmax = max(int(t.shape[0]) for t in tables.values())
                d = next(iter(tables.values())).shape[1]
                emb = torch.zeros(len(tis), lmax, d, device=dev)
                mask = torch.zeros(len(tis), lmax, dtype=torch.bool, device=dev)
                for i, ti in enumerate(tis):
                    t = tables[ti["dataset"]]
                    emb[i, :len(t)] = t
                    mask[i, :len(t)] = True
                task_input["label_embeddings"] = emb
                task_input["class_mask"] = mask
            else:
                task_input["label_embeddings"] = tables
            task_input["label"] = on_dev(np.stack([ti["label"] for ti in tis]), np.int64)
            if kind == "universal_localization" and "class_mask" not in task_input:
                b = len(tis)
                table = task_input["label_embeddings"]
                task_input["label_embeddings"] = table[None].expand(b, -1, -1)
                task_input["class_mask"] = torch.ones(b, int(table.shape[0]), dtype=torch.bool,
                                                      device=dev)
        elif kind == "vis":
            # the dataset sampled each clip's classes; gather their rows
            tables = self.model.label_embeddings[task]
            lsel = len(tis[0]["selected_classes"])
            d = next(iter(tables.values())).shape[1]
            emb = torch.zeros(len(tis), lsel, d, device=dev)
            mask = torch.zeros(len(tis), lsel, dtype=torch.bool, device=dev)
            for i, ti in enumerate(tis):  # indices built on the host: no device sync
                sel = np.asarray(ti["selected_classes"])
                rows = np.nonzero(sel >= 0)[0]
                emb[i, T.host_to(rows, dev)] = tables[ti["dataset"]][T.host_to(sel[rows], dev)]
                mask[i] = T.host_to(sel >= 0, dev)
            task_input["label_embeddings"] = emb
            task_input["class_mask"] = mask
            task_input["mask_target"] = on_dev(np.stack([ti["mask_target"] for ti in tis]))
        elif kind == "refervos":
            task_input["caption_ids"] = on_dev(self.model.tokenize([ti["caption"] for ti in tis]))
            task_input["mask_target"] = on_dev(np.stack([ti["mask_target"] for ti in tis]))
        else:
            raise NotImplementedError(kind)
        return task, {"pixel_values": pixel_values, "task_input": task_input}

    def __iter__(self):
        start = self._start_step

        def host_gen():
            yielded = 0
            for step, indices in enumerate(self.sampler):
                # an all-PAD batch never reaches the trainer, so it does not
                # count toward the resume offset either: skip by yielded
                # batches (the trainer's micro-steps), from the indices alone
                if not any(i != PAD_INDEX for i in indices):
                    continue
                if yielded < start:  # resume: no fetch, no decode
                    yielded += 1
                    continue
                yielded += 1
                samples = self._fetch(indices)
                if not samples:
                    continue
                real = [i for i in indices if i != PAD_INDEX]
                yield step, self._collate_host(samples, real)

        if self.prefetch <= 0:
            for step, (task, frames, tis, ids) in host_gen():
                yield self._finalize(task, frames, tis, step, ids)
            return

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        err: list = []
        stop = threading.Event()  # set when the consumer abandons the epoch

        def _put(item) -> bool:
            # a bounded put that watches for the consumer leaving: a plain
            # put would block forever holding decoded batches after an early
            # break (preemption)
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for item in host_gen():
                    if not _put(item):
                        return
            except BaseException as e:  # noqa: BLE001 -- re-raised on the consumer's thread
                # a swallowed error would end the epoch early and cleanly,
                # and the checkpoint after it would hold a partial epoch
                err.append(e)
            finally:
                _put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    if err:
                        raise err[0]
                    break
                step, (task, frames, tis, ids) = item
                yield self._finalize(task, frames, tis, step, ids)
        finally:
            stop.set()
            # drain so that a worker blocked in a put lets its batch go now
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
