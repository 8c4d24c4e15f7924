"""Action-recognition fine-tuning CLI on PyTorch.

Port of the JAX package's ``downstream/ar_run.py`` (the reference's
``downstream/AR/main_finetuning.py`` with ``exp/k400/*.sh``'s
hyperparameters), with the same flags, plus ``--device`` (``cuda`` unless
named). The datasets are ``data.datasets.VideoClsSparseDataset`` or
``VideoClsDenseDataset`` over ``"path label"`` CSVs; a loader decodes on a
thread pool one batch ahead, and the augmentation (``make_train_augment``:
RandAugment, resized crop, flip, normalize, erasing; ``make_eval_augment``:
centre crop, normalize) runs on the device. The optimizer is
``train.optim.create_optimizer`` (AdamW, clip 5.0, layer decay, the
LoRA-spatial mask) on a cosine schedule with warm-up; an optional EMA of
the weights is validated too; the multi-view final test merges
``--test_num_segment`` x ``--test_num_crop`` views a video.

Usage:
    python -m streamformer_tpu_torch.downstream.ar_run \\
        --anno_train k400/train.csv --anno_val k400/val.csv \\
        --num_classes 400 --model_path /ckpt/streamformer --bf16 \\
        --add_lora_spatial --epochs 30 --lr 2e-4

``train`` takes the datasets, so a caller can hand it clips from memory
(items ``{"task_input": {"frames": (T, H, W, C) uint8, "label": int}}``,
and ``"sample_idx"`` in test mode).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch


def get_args(argv=None):
    p = argparse.ArgumentParser("StreamFormer AR finetune (PyTorch)")
    p.add_argument("--anno_train", required=True, help='"path label" CSV')
    p.add_argument("--anno_val", default=None)
    p.add_argument("--anno_test", default=None)
    p.add_argument("--prefix", default="")
    p.add_argument("--split", default=" ")
    p.add_argument("--output_dir", default="output/ar")
    p.add_argument("--model_path", default=None, help="HF backbone dir")
    p.add_argument("--num_classes", type=int, required=True)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--weight_decay", type=float, default=0.05)
    p.add_argument("--layer_decay", type=float, default=None)
    p.add_argument("--warmup_epochs", type=float, default=2)
    p.add_argument("--num_frames", type=int, default=16)
    p.add_argument("--input_size", type=int, default=224)
    p.add_argument("--sampling", default="sparse", choices=["sparse", "dense"])
    p.add_argument("--sampling_rate", type=int, default=4)
    p.add_argument("--mixup", type=float, default=0.8)
    p.add_argument("--cutmix", type=float, default=1.0)
    p.add_argument("--smoothing", type=float, default=0.1)
    p.add_argument("--add_lora_spatial", action="store_true")
    p.add_argument("--model_ema", action="store_true",
                   help="keep an EMA shadow of the weights and also evaluate it (reference AR "
                   "ModelEma, main_finetuning.py:53-55)")
    p.add_argument("--model_ema_decay", type=float, default=0.9999)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--test_num_segment", type=int, default=4)
    p.add_argument("--test_num_crop", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    # tiny-model overrides for smoke tests
    p.add_argument("--hidden_size", type=int, default=768)
    p.add_argument("--num_layers", type=int, default=12)
    p.add_argument("--num_heads", type=int, default=12)
    p.add_argument("--intermediate_size", type=int, default=3072)
    p.add_argument("--patch_size", type=int, default=16)
    return p.parse_args(argv)


def build_datasets(args):
    """(train, validation or None, test or None) from the CSVs."""
    from streamformer_tpu_torch.data import datasets as D

    cls = D.VideoClsSparseDataset if args.sampling == "sparse" else D.VideoClsDenseDataset
    kw = dict(prefix=args.prefix, split=args.split, clip_len=args.num_frames,
              short_side_size=max(args.input_size, 224) + 32)
    if args.sampling == "dense":
        kw["sampling_rate"] = args.sampling_rate
    train_ds = cls(args.anno_train, mode="train", **kw)
    val_ds = cls(args.anno_val, mode="validation", **kw) if args.anno_val else None
    test_ds = (cls(args.anno_test, mode="test", test_num_segment=args.test_num_segment,
                   test_num_crop=args.test_num_crop, **kw) if args.anno_test else None)
    return train_ds, val_ds, test_ds


def _loader(ds, batch_size, aug, seed, train, num_workers, device):
    """An epoch of (pixel_values on ``device``, labels, video ids or None):
    the samples fetched on a thread pool one batch ahead, stacked, moved to
    the device and augmented there; a train epoch shuffled by ``seed`` and
    its last partial batch dropped, its augmentation keyed by (``seed``,
    the batch's first position, each sample's index)."""
    idx = np.arange(len(ds))
    if train:
        np.random.default_rng(seed).shuffle(idx)
    starts = list(range(0, len(idx) - (batch_size - 1 if train else 0), batch_size))
    with ThreadPoolExecutor(max(num_workers, 1)) as ex:
        def submit(b0):
            return [ex.submit(ds.__getitem__, int(j)) for j in idx[b0:b0 + batch_size]]

        futs = submit(starts[0]) if starts else []
        for i, b0 in enumerate(starts):
            samples = [f.result()["task_input"] for f in futs]
            if i + 1 < len(starts):
                futs = submit(starts[i + 1])
            frames = torch.from_numpy(np.stack([s["frames"] for s in samples]))
            if device.type == "cuda":
                frames = frames.pin_memory()
            frames = frames.to(device, non_blocking=True)
            px = (aug(frames, seed, b0, [int(j) for j in idx[b0:b0 + batch_size]]) if train
                  else aug(frames))
            labels = torch.as_tensor([int(s["label"]) for s in samples], dtype=torch.int64)
            vids = (np.asarray([s["sample_idx"] for s in samples])
                    if "sample_idx" in samples[0] else None)
            yield px, labels, vids


def build_model(args, device=None):
    """The ``ARModel``: the encoder (``--model_path`` or seeded) and the
    classifier head, fp32 masters on ``device`` (``cuda`` unless named)."""
    from streamformer_tpu_torch.checkpoint.hf_import import from_pretrained
    from streamformer_tpu_torch.config import StreamformerConfig
    from streamformer_tpu_torch.downstream import ar
    from streamformer_tpu_torch.models import encoder

    dev = encoder.resolve_device(device if device is not None else args.device)
    cfg = StreamformerConfig(
        num_frames=args.num_frames, image_size=args.input_size, patch_size=args.patch_size,
        hidden_size=args.hidden_size, num_hidden_layers=args.num_layers,
        num_attention_heads=args.num_heads, intermediate_size=args.intermediate_size,
        add_lora_spatial=args.add_lora_spatial, dtype="bfloat16" if args.bf16 else "float32")
    backbone = encoder.StreamformerEncoder(cfg, device=dev, trainable=True,
                                           generator=torch.Generator().manual_seed(args.seed))
    if args.model_path:
        # fp32 weights, so the masters keep every bit of the checkpoint
        loaded = from_pretrained(args.model_path, cfg.replace(dtype="float32"), device=dev)
        backbone.load_state_dict(loaded.state_dict())
        del loaded
    head = ar.init_classifier(cfg, args.num_classes, device=dev,
                              generator=torch.Generator().manual_seed(args.seed + 1))
    return ar.ARModel(backbone, head)


def train(args, train_ds, val_ds=None, test_ds=None, model=None):
    """Fine-tune on ``train_ds`` for ``--epochs``; after each epoch validate
    on ``val_ds`` (and the EMA with ``--model_ema``), write a line of
    ``log.txt`` and ``checkpoint-<epoch>``; at the end the multi-view test
    on ``test_ds``. Returns {"history": the epochs' stats, "final_test":
    the test's top-1/5 or None}."""
    from streamformer_tpu_torch.data.collate import make_eval_augment, make_train_augment, seed_of
    from streamformer_tpu_torch.downstream import ar
    from streamformer_tpu_torch.train import checkpoint as ckpt_lib
    from streamformer_tpu_torch.train import metrics as metrics_lib
    from streamformer_tpu_torch.train import optim

    os.makedirs(args.output_dir, exist_ok=True)
    model = build_model(args) if model is None else model
    dev = model.device
    cfg = model.backbone.cfg
    steps_per_epoch = max(len(train_ds) // args.batch_size, 1)
    lr = optim.cosine_lr_schedule(args.lr, 1e-6, args.epochs, steps_per_epoch,
                                  warmup_epochs=args.warmup_epochs)
    trainable = optim.trainable_mask_lora_spatial(model) if args.add_lora_spatial else None
    opt = optim.create_optimizer(model, lr, weight_decay=args.weight_decay, clip_grad=5.0,
                                 layer_decay=args.layer_decay, num_layers=cfg.num_hidden_layers,
                                 trainable_mask=trainable)
    ema = ar.init_ema(model) if args.model_ema else None
    step = ar.make_train_step(model, opt, args.num_classes, mixup_alpha=args.mixup,
                              cutmix_alpha=args.cutmix, label_smoothing=args.smoothing,
                              use_mixup=args.mixup > 0, ema=ema,
                              ema_decay=args.model_ema_decay if args.model_ema else None)
    aug_t, aug_e = make_train_augment(args.input_size), make_eval_augment(args.input_size)

    def eval_batches(ds):
        return ((px, y) for px, y, _ in _loader(ds, args.batch_size, aug_e, 0, False,
                                                 args.num_workers, dev))

    history = []
    for epoch in range(args.epochs):
        t0 = time.time()
        losses = []
        for it, (px, labels, _) in enumerate(_loader(train_ds, args.batch_size, aug_t,
                                                     args.seed + epoch, True, args.num_workers,
                                                     dev)):
            # a seed a step: each step draws its own mixup and dropout
            losses.append(step(px, labels, seed_of(args.seed, epoch, it)))
        stats = {"epoch": epoch, "loss": float(torch.stack(losses).mean()),
                 "epoch_time": time.time() - t0}
        if val_ds is not None:
            stats.update(ar.validate(model, eval_batches(val_ds)))
            if ema is not None:
                stats.update({f"{k}_ema": v for k, v in ar.validate(ema, eval_batches(val_ds))
                              .items()})
        print(json.dumps(stats))
        metrics_lib.write_log_line(args.output_dir, stats)
        ckpt_lib.save_checkpoint(args.output_dir, epoch, model, opt)
        history.append(stats)

    res = None
    if test_ds is not None:
        res = ar.final_test(ema if ema is not None else model,
                            _loader(test_ds, args.batch_size, aug_e, 0, False, args.num_workers,
                                    dev))
        print("multi-view test:", json.dumps(res))
        metrics_lib.write_log_line(args.output_dir, {"final_test": res})
    return {"history": history, "final_test": res}


def main(argv=None):
    args = get_args(argv)
    train(args, *build_datasets(args))


if __name__ == "__main__":
    main()
