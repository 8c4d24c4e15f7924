"""YAML metadata -> multitask datasets: the port of the JAX package's
``data/build.py`` (reference datasets/build.py:50-336), taking the task
sets from the port's ``models.multitask``.

Same YAML schema as the reference (scripts/dataset_metadata/*.yaml):
``datasets.<TaskName>.{train,validation}`` blocks with data_path/prefix/
label2id_path/num_frames/... . Returns (train_union, eval_union,
multi_task_config) where multi_task_config carries label2id per task for
head construction (the ``from_pretrained(multi_task_config=...)`` contract,
run_finetuning_multi_task.py:335-337).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

from streamformer_tpu_torch.data import datasets as D
from streamformer_tpu_torch.models.multitask import (
    CLASSIFICATION_TASKS,
    GROUNDING_TASKS,
    NAIVE_LOCALIZATION_TASKS,
    RETRIEVAL_TASKS,
    UNIVERSAL_LOCALIZATION_TASKS,
)


def _load_label2id(block) -> Optional[Dict[str, int]]:
    p = block.get("label2id_path")
    if p and os.path.exists(p):
        with open(p) as f:
            return json.load(f)
    return None


def _build_one(task: str, block: Dict[str, Any], mode: str,
               label2id: Optional[Dict[str, int]] = None):
    clip_len = int(block.get("num_frames", 16))
    short = int(block.get("short_side_size", 256))
    # an explicit label2id (the TRAIN split's mapping) wins: deriving the
    # mapping independently per split silently remaps every class when the
    # validation anno is missing any label
    label2id = label2id if label2id is not None else _load_label2id(block)
    anno = block.get("anno_path") or block.get("data_path")
    if task in CLASSIFICATION_TASKS:
        ds = D.VideoClsSparseDataset(
            anno_path=anno,
            task_name=task,
            prefix=block.get("prefix", ""),
            split=block.get("split", " "),
            mode=block.get("mode", mode),
            clip_len=clip_len,
            short_side_size=short,
            test_num_segment=int(block.get("num_segments", 1)),
            test_num_crop=int(block.get("num_crops", 1)),
            label2id=label2id,
        )
        if label2id is None:
            # derive from anno labels when no label2id_path is given (the
            # reference requires the path; this keeps small runs self-contained)
            uniq = sorted({int(l) for l in ds.labels})
            label2id = {str(l): i for i, l in enumerate(uniq)}
            ds.label2id = label2id
    elif task in RETRIEVAL_TASKS:
        ds = D.RetrievalDataset(
            anno_path=anno,
            task_name=task,
            mode=block.get("mode", mode),
            clip_len=clip_len,
            short_side_size=short,
            data_dict=block.get("data_dict"),
        )
    elif task in GROUNDING_TASKS:
        ds = D.GroundingDataset(
            anno_path=anno,
            task_name=task,
            prefix=block.get("prefix", ""),
            mode=block.get("mode", mode),
            clip_len=clip_len,
            short_side_size=short,
            sampler=block.get("sampler", "uniform"),
        )
    elif task in NAIVE_LOCALIZATION_TASKS:
        # full-video windowed TAL (THUMOS14-style; fake-batch sampler path)
        ds = D.TALWindowedDataset(
            anno_path=anno,
            task_name=task,
            prefix=block.get("prefix", ""),
            mode=block.get("mode", mode),
            window_size=int(block.get("window_size", 384)),
            clip_len=clip_len,
            short_side_size=short,
            label2id=label2id,
        )
    elif task in UNIVERSAL_LOCALIZATION_TASKS:
        ds = D.LocalizationDataset(
            anno_path=anno,
            task_name=task,
            prefix=block.get("prefix", ""),
            mode=block.get("mode", mode),
            clip_len=clip_len,
            short_side_size=short,
            label2id=label2id,
            dataset_name=task,
        )
    else:
        raise NotImplementedError(f"task {task} (VIS/ReferVOS land in seg builder)")
    return ds, label2id


def build_multi_task_dataset(
    metadata: Dict[str, Any] | str, balance: bool = False
) -> Tuple[D.MultiTaskDataset, Optional[D.MultiTaskDataset], Dict[str, Dict]]:
    if isinstance(metadata, str):
        import yaml

        with open(metadata) as f:
            metadata = yaml.safe_load(f)
    blocks = metadata["datasets"]
    train, evals, mtc = [], [], {}
    for task, modes in blocks.items():
        train_l2i = None
        if "train" in modes:
            ds, train_l2i = _build_one(task, modes["train"], "train")
            train.append(ds)
            mtc[task] = {"label2id": train_l2i}
        if "validation" in modes:
            # validation reuses the train split's label2id so head rows and
            # eval labels agree even when the val anno misses a class
            ds, label2id = _build_one(
                task, modes["validation"], "validation", label2id=train_l2i
            )
            evals.append(ds)
            mtc.setdefault(task, {"label2id": label2id})
    train_union = D.MultiTaskDataset(train, balance=balance)
    eval_union = D.MultiTaskDataset(evals) if evals else None
    return train_union, eval_union, mtc
