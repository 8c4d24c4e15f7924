"""What the loader and a background checkpoint write cost a training
micro-step on the card.

Run from the root of a checkout, on a machine with a CUDA card:

    python -m streamformer_tpu_torch.tools.loader_timing

At the flagship width (bf16 over fp32 masters, the SigLIP-base text tower
shape), batches of 8 uint8 clips of 16x256x340 from three in-memory tasks
(classification, grounding, VIS), ``update_freq=2``, it times by the host
clock around synchronised epochs of 6 micro-steps:

* the augmentation alone, a batch (``TrainAugment``);
* the trainer on pre-built batches (what ``chip_smoke.py`` phase 17 times);
* the trainer fed by ``MultitaskLoader`` (decode-free: the clips are in
  memory), with its prefetch thread and without;
* the trainer on pre-built batches while a checkpoint is written in the
  background, in the port's packed layout (``train.checkpoint``) and as one
  tensor per leaf (a plain ``torch.distributed.checkpoint`` save of the
  same state), in turns: packed, per leaf, per leaf, packed;
* the synchronising CUDA calls of one loader-fed epoch
  (``torch.cuda.set_sync_debug_mode``), by the line that made them.

It prints one JSON line per measurement with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import shutil
import subprocess
import sys
import threading
import time
import warnings

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--label", default="change")
    p.add_argument("--out", default=os.path.join("build", "loader_timing"),
                   help="scratch directory for the checkpoints (removed at the end)")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("loader_timing: no CUDA device", file=sys.stderr)
        return 2
    os.environ.setdefault("STREAMFORMER_ALLOW_HASH_TOKENIZER", "1")
    import torch.distributed.checkpoint as dcp

    from streamformer_tpu_torch.config import StreamformerConfig
    from streamformer_tpu_torch.data import collate, samplers
    from streamformer_tpu_torch.data.datasets import MultiTaskDataset
    from streamformer_tpu_torch.models.multitask import MultitaskModel
    from streamformer_tpu_torch.models.text_encoder import SiglipTextConfig
    from streamformer_tpu_torch.ops import build
    from streamformer_tpu_torch.train import checkpoint as ckpt_lib
    from streamformer_tpu_torch.train import optim
    from streamformer_tpu_torch.train.trainer import MultitaskTrainer, TrainState

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    build.build()
    dev = torch.device("cuda")

    def emit(**row):
        print(json.dumps({"label": args.label, "card": smi, **row}), flush=True)

    cfg = StreamformerConfig(dtype="bfloat16")
    n_clips, nf, batch = 16, cfg.num_frames, 8
    rng = np.random.default_rng(25)
    frames = rng.integers(0, 256, (3 * n_clips, nf, 256, 340, 3), dtype=np.uint8)
    grounding = rng.integers(0, 2, (n_clips, nf)).astype(np.float32)
    masks = rng.integers(-1, 5, (n_clips, nf, 56, 56))

    class InMemory:
        def __init__(self, name, first, task_input):
            self.task_name, self.first, self.task_input = name, first, task_input

        def __len__(self):
            return n_clips

        def __getitem__(self, i):
            return {"task_name": self.task_name,
                    "task_input": {"frames": frames[self.first + i], **self.task_input(i)}}

    ds = MultiTaskDataset([
        InMemory("Kinetics", 0, lambda i: {"label": np.int64(i % 10)}),
        InMemory("CharadesSTA", n_clips, lambda i: {"caption": f"a person does thing {i}",
                                                    "label": grounding[i]}),
        InMemory("YoutubeVIS", 2 * n_clips, lambda i: {"mask_target": masks[i], "dataset": "ytvis",
                                                       "selected_classes": np.arange(5)})])
    mtc = {"Kinetics": {"label2id": {f"action {i}": i for i in range(10)}},
           "CharadesSTA": {"label2id": None},
           "YoutubeVIS": {"label2id": {"ytvis": {f"object {i}": i for i in range(5)}}}}
    model = MultitaskModel(cfg, mtc, SiglipTextConfig(hidden_size=cfg.hidden_size),
                           generator=torch.Generator().manual_seed(0))
    model.prepare_for_multi_tasks()
    tx = optim.create_optimizer(model, optim.cosine_lr_schedule(1e-4, 1e-6, 4, 3), clip_grad=1.0,
                                layer_decay=0.75,
                                trainable_mask=optim.trainable_mask_frozen_text(model))
    trainer = MultitaskTrainer(model, tx, update_freq=2)
    state = TrainState.create(model, tx)
    sampler = samplers.DistributedBatchTaskUniqueSampler(ds.task_specs(), batch)

    def loader(epoch, **kw):
        out = collate.MultitaskLoader(ds, sampler, model, crop_size=cfg.image_size,
                                      aug_seed=epoch, **kw)
        out.set_epoch(epoch)
        return out

    def epoch_ms(batches, epoch=1):
        """ms per micro-step of one synchronised epoch over ``batches``."""
        nonlocal state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = trainer.train_one_epoch(state, iter(batches), epoch,
                                           torch.Generator(device=dev).manual_seed(epoch),
                                           print_freq=1000)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / len(sampler)

    epoch_ms(loader(0), 0)  # warm-up: allocations, cuBLAS handles, the kernels' first launches
    aug = collate.make_train_augment(cfg.image_size)
    clips = torch.from_numpy(frames[:batch]).to(dev)
    aug_ms = []
    for step in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        aug(clips, 0, step, list(range(batch)))
        torch.cuda.synchronize()
        aug_ms.append((time.perf_counter() - t0) * 1e3)
    emit(measure="augmentation, ms a batch to its end", values=aug_ms)
    batches = list(loader(1))
    emit(measure="pre-built batches, ms per micro-step", values=[epoch_ms(batches) for _ in range(3)])
    for prefetch in (2, 0):
        emit(measure=f"loader (prefetch={prefetch}), ms per micro-step",
             values=[epoch_ms(loader(1, prefetch=prefetch)) for _ in range(3)])

    def during_write(start, alive):
        """Epochs on pre-built batches while a write started by ``start``
        runs: (seconds to start, seconds to commit, ms per micro-step)."""
        t_start = time.perf_counter()
        start()
        staged = time.perf_counter() - t_start
        times = []
        while alive():
            times.append(epoch_ms(batches))
        return staged, time.perf_counter() - t_start, times

    out = os.path.abspath(args.out)

    def packed():
        return during_write(lambda: ckpt_lib.save_checkpoint(out, 0, model, tx, block=False),
                            lambda: ckpt_lib._WRITER._thread is not None
                            and ckpt_lib._WRITER._thread.is_alive())

    def per_leaf():
        holder = {}

        def start():
            sd = {"params/" + k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
            names = {id(q): n for n, q in model.named_parameters()}
            for q, st in tx.inner.state.items():
                for field, v in st.items():
                    sd[f"optimizer/{names[id(q)]}/{field}"] = v.detach().cpu().clone()
            shutil.rmtree(out + "_leaf", ignore_errors=True)
            holder["t"] = threading.Thread(target=lambda: dcp.save(
                sd, storage_writer=dcp.FileSystemWriter(out + "_leaf"), no_dist=True))
            holder["t"].start()

        return during_write(start, lambda: holder["t"].is_alive())

    try:
        for name, fn in (("packed", packed), ("per leaf", per_leaf), ("per leaf", per_leaf),
                         ("packed", packed)):
            staged, total, times = fn()
            ckpt_lib.wait_for_checkpoints()
            emit(measure=f"background write, {name}", start_s=staged, commit_s=total,
                 ms_per_micro_step=times)
    finally:
        shutil.rmtree(out, ignore_errors=True)
        shutil.rmtree(out + "_leaf", ignore_errors=True)

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            epoch_ms(loader(2, prefetch=0))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = collections.Counter(f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
                                if "synchroniz" in str(w.message))
    emit(measure="synchronising calls in a loader-fed epoch", total=sum(syncs.values()),
         by_line=dict(syncs.most_common(12)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
