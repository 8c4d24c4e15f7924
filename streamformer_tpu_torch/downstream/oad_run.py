"""Online action detection CLI on PyTorch: LSTR/MAT on extracted per-frame
features.

Port of the JAX package's ``downstream/oad_run.py`` (the reference's OAD
trainer with ``configs/THUMOS/MAT/*.yaml``; the features are
``extract/oad.py`` dumps at 24 fps), with the same flags, plus ``--device``
(``cuda`` unless named). Each epoch writes a line of ``log.txt`` and
``checkpoint-<epoch>``.

Usage:
    python -m streamformer_tpu_torch.downstream.oad_run \\
        --feature_root feats/rgb --target_root feats/target \\
        --train_list train_names.txt --val_list val_names.txt \\
        --num_classes 22 --epochs 25

``train`` takes the datasets, so a caller can hand it
``oad_data.PerFrameDataset``s it built.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch


def get_args(argv=None):
    p = argparse.ArgumentParser("StreamFormer OAD (LSTR/MAT, PyTorch)")
    p.add_argument("--feature_root", required=True)
    p.add_argument("--target_root", required=True)
    p.add_argument("--train_list", required=True, help="one video name/line")
    p.add_argument("--val_list", default=None)
    p.add_argument("--flow_root", default=None)
    p.add_argument("--output_dir", default="output/oad")
    p.add_argument("--num_classes", type=int, required=True)
    p.add_argument("--feature_dim", type=int, default=768)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--epochs", type=int, default=25)
    p.add_argument("--lr", type=float, default=7e-5)
    p.add_argument("--weight_decay", type=float, default=5e-5)
    p.add_argument("--long_memory_num_samples", type=int, default=128)
    p.add_argument("--work_memory_num_samples", type=int, default=32)
    p.add_argument("--long_sample_rate", type=int, default=4)
    p.add_argument("--hidden", type=int, default=1024)
    p.add_argument("--steps_per_epoch", type=int, default=0, help="0 = all")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def _names(path):
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def config_of(args):
    from streamformer_tpu_torch.downstream import oad_lstr as L

    return L.LSTRConfig(num_classes=args.num_classes, visual_size=args.feature_dim,
                        d_model=args.hidden, long_memory_num_samples=args.long_memory_num_samples,
                        work_memory_num_samples=args.work_memory_num_samples)


def build_datasets(args, cfg):
    from streamformer_tpu_torch.downstream import oad_data as D

    train_ds = D.PerFrameDataset(args.feature_root, args.target_root, _names(args.train_list), cfg,
                                 long_sample_rate=args.long_sample_rate, flow_root=args.flow_root)
    val_ds = None
    if args.val_list:
        val_ds = D.PerFrameDataset(args.feature_root, args.target_root, _names(args.val_list), cfg,
                                   long_sample_rate=args.long_sample_rate, mode="val",
                                   flow_root=args.flow_root)
    return train_ds, val_ds


def train(args, train_ds, val_ds=None, model=None):
    """Train on ``train_ds`` for ``--epochs`` (``--steps_per_epoch`` batches
    an epoch at most); after each epoch validate on ``val_ds``, write a line
    of ``log.txt`` and ``checkpoint-<epoch>``. The model is the datasets'
    ``LSTRConfig`` drawn from ``--seed`` unless given. Returns the epochs'
    stats."""
    from streamformer_tpu_torch.downstream import oad_data as D
    from streamformer_tpu_torch.downstream import oad_lstr as L
    from streamformer_tpu_torch.train import checkpoint as ckpt_lib
    from streamformer_tpu_torch.train import metrics as metrics_lib

    os.makedirs(args.output_dir, exist_ok=True)
    if model is None:
        model = L.LSTR(train_ds.cfg, device=args.device,
                       generator=torch.Generator().manual_seed(args.seed))
    opt = D.make_optimizer(model, args.lr, args.weight_decay)
    step = D.make_train_step(model, opt)
    rng = np.random.default_rng(args.seed)
    history = []
    for epoch in range(args.epochs):
        t0 = time.time()
        losses = []
        for i, batch in enumerate(train_ds.batches(args.batch_size, rng)):
            losses.append(step(batch))
            if args.steps_per_epoch and i + 1 >= args.steps_per_epoch:
                break
        stats = {"epoch": epoch, "loss": float(torch.stack(losses).mean()),
                 "epoch_time": time.time() - t0}
        if val_ds is not None:
            stats.update(D.batch_inference(model, val_ds, batch_size=args.batch_size))
        print(json.dumps(stats))
        metrics_lib.write_log_line(args.output_dir, stats)
        ckpt_lib.save_checkpoint(args.output_dir, epoch, model, opt)
        history.append(stats)
    return history


def main(argv=None):
    args = get_args(argv)
    train(args, *build_datasets(args, config_of(args)))


if __name__ == "__main__":
    main()
