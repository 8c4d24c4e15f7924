"""Training entry point: the port of the JAX package's ``train/run.py``
(reference run_finetuning_multi_task.py), one process on one GPU.

Usage:
    python -m streamformer_tpu_torch.train.run --metadata path/to/all.yaml \\
        --output_dir out --batch_size 16 --epochs 20 --lr 2e-5 ...

``--device cpu`` runs it on the CPU (the kernels' plain versions). Flow:
datasets from the YAML metadata (``build_datasets``) -> ``train``: the
model (and ``--model_path`` through ``from_pretrained``), the label tables,
the trainable masks, the optimizer with its schedules, auto-resume, then
the epoch loop with an asynchronous checkpoint after every epoch and a
blocking mid-epoch one on SIGTERM, after which the process exits for a
restart into the same run.

Data or model parallelism (``--dp``/``--mp`` past 1, ``--shard_patches``,
``--distributed``) is ROADMAP item 14 and validation (``--eval_freq``)
item 19: they raise ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import time


def get_args(argv=None):
    p = argparse.ArgumentParser("StreamFormer multitask training (PyTorch)")
    p.add_argument("--metadata", required=True, help="dataset metadata YAML")
    p.add_argument("--output_dir", default="output")
    p.add_argument("--log_dir", default=None)
    p.add_argument("--model_path", default=None, help="HF checkpoint dir")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--update_freq", type=int, default=1)
    p.add_argument("--num_frames", type=int, default=16)
    p.add_argument("--input_size", type=int, default=224)
    p.add_argument("--lr", type=float, default=2e-5)
    p.add_argument("--min_lr", type=float, default=1e-6)
    p.add_argument("--warmup_epochs", type=float, default=1)
    p.add_argument("--warmup_steps", type=int, default=-1)
    p.add_argument("--weight_decay", type=float, default=0.05)
    p.add_argument("--weight_decay_end", type=float, default=None)
    p.add_argument("--layer_decay", type=float, default=None)
    p.add_argument("--clip_grad", type=float, default=None)
    p.add_argument("--opt", default="adamw")
    p.add_argument("--opt_betas", type=float, nargs=2, default=(0.9, 0.999))
    p.add_argument("--opt_eps", type=float, default=1e-8)
    p.add_argument("--num_sample", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--auto_resume", action="store_true", default=True)
    p.add_argument("--save_ckpt_freq", type=int, default=10)
    p.add_argument("--eval_freq", type=int, default=0,
                   help="run validation every N epochs (0 = off)")
    p.add_argument("--hidden_size", type=int, default=768)
    p.add_argument("--num_layers", type=int, default=12)
    p.add_argument("--num_heads", type=int, default=12)
    p.add_argument("--intermediate_size", type=int, default=3072)
    p.add_argument("--text_layers", type=int, default=12)
    p.add_argument("--enable_causal_temporal", action="store_true", default=True)
    p.add_argument("--add_lora_spatial", action="store_true")
    p.add_argument("--frozen_spatial", action="store_true")
    p.add_argument("--frozen_backbone", action="store_true")
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--balance_datasets", action="store_true")
    p.add_argument("--remat", default="none", choices=["none", "layer"])
    p.add_argument("--dp", type=int, default=0, help="data-parallel size (ROADMAP item 14)")
    p.add_argument("--mp", type=int, default=1, help="model-parallel size (ROADMAP item 14)")
    p.add_argument("--shard_patches", action="store_true")
    p.add_argument("--distributed", action="store_true")
    p.add_argument("--coordinator_address", default=None)
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--profile_steps", type=int, default=0,
                   help="trace this many steady-state micro-steps of the first epoch "
                        "(torch.profiler, a Chrome trace under <log_dir>/profile)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def check_supported(args) -> None:
    if args.dp > 1 or args.mp > 1 or args.shard_patches or args.distributed:
        raise NotImplementedError(
            "data or model parallel training (--dp/--mp past 1, --shard_patches, --distributed) "
            "is ROADMAP slice 4, item 14; the trainer runs one process on one GPU")
    if args.eval_freq > 0:
        raise NotImplementedError("validation during training (--eval_freq) comes with "
                                  "eval/validate.py, ROADMAP item 19")


def build_datasets(args):
    """(train union, eval union or None, multi_task_config) from
    ``--metadata``."""
    from streamformer_tpu_torch.data.build import build_multi_task_dataset

    return build_multi_task_dataset(args.metadata, balance=args.balance_datasets)


def _log_writer(args):
    try:
        import tensorboardX  # noqa: F401 -- only asked whether it is there
    except ImportError:
        print("tensorboardX is not installed: no TensorBoard scalars (log.txt still written)")
        return None
    from streamformer_tpu_torch.train import metrics as metrics_lib

    return metrics_lib.TensorboardLogger(args.log_dir or os.path.join(args.output_dir, "tb"))


def train(args, train_ds, eval_ds, mtc):
    """Train on ``train_ds`` (a ``MultiTaskDataset``) with the task config
    ``mtc``; returns the ``TrainState``. On SIGTERM it saves a mid-epoch
    checkpoint at the next update boundary and returns; a later call with
    the same ``output_dir`` resumes from it."""
    check_supported(args)
    import torch

    from streamformer_tpu_torch.checkpoint.hf_import import from_pretrained
    from streamformer_tpu_torch.config import StreamformerConfig
    from streamformer_tpu_torch.data.collate import MultitaskLoader, seed_of
    from streamformer_tpu_torch.data.samplers import DistributedBatchTaskUniqueSampler
    from streamformer_tpu_torch.models.encoder import resolve_device
    from streamformer_tpu_torch.models.multitask import MultitaskModel
    from streamformer_tpu_torch.models.text_encoder import SiglipTextConfig
    from streamformer_tpu_torch.train import checkpoint as ckpt_lib
    from streamformer_tpu_torch.train import metrics as metrics_lib
    from streamformer_tpu_torch.train import optim
    from streamformer_tpu_torch.train.trainer import MultitaskTrainer, TrainState

    dev = resolve_device(args.device)
    os.makedirs(args.output_dir, exist_ok=True)
    with open(os.path.join(args.output_dir, "args.json"), "w") as f:
        json.dump(vars(args), f, indent=2)
    print(f"train samples: {len(train_ds)} tasks: {list(mtc)} device: {dev}")

    cfg = StreamformerConfig(
        num_frames=args.num_frames, image_size=args.input_size, hidden_size=args.hidden_size,
        num_hidden_layers=args.num_layers, num_attention_heads=args.num_heads,
        intermediate_size=args.intermediate_size,
        enable_causal_temporal=args.enable_causal_temporal,
        add_lora_spatial=args.add_lora_spatial, dtype="bfloat16" if args.bf16 else "float32",
        remat=args.remat)
    text_cfg = SiglipTextConfig(hidden_size=args.hidden_size, num_hidden_layers=args.text_layers,
                                num_attention_heads=args.num_heads,
                                intermediate_size=args.intermediate_size)
    model = MultitaskModel(cfg, mtc, text_cfg=text_cfg, device=dev,
                           generator=torch.Generator().manual_seed(args.seed))
    if args.model_path:
        # fp32 weights, so the masters keep every bit of the checkpoint
        backbone = from_pretrained(args.model_path, cfg.replace(dtype="float32"), device=dev)
        model.backbone.load_state_dict(backbone.state_dict())
        del backbone
        print(f"loaded backbone from {args.model_path}")
    model.prepare_for_multi_tasks()

    # the linear lr scaling rule over the total batch (one replica)
    total_bs = args.batch_size * args.update_freq
    lr = optim.scale_lr(args.lr, total_bs, args.num_sample)
    sampler = DistributedBatchTaskUniqueSampler(train_ds.task_specs(), batch_size=args.batch_size,
                                                num_replicas=1, rank=0, seed=args.seed)
    steps_per_epoch = max(len(sampler) // args.update_freq, 1)
    lr_sched = optim.cosine_lr_schedule(lr, args.min_lr, args.epochs, steps_per_epoch,
                                        warmup_epochs=args.warmup_epochs,
                                        warmup_steps=args.warmup_steps)
    wd_sched = optim.cosine_wd_schedule(args.weight_decay, args.weight_decay_end, args.epochs,
                                        steps_per_epoch)

    trainable = optim.trainable_mask_frozen_text(model)
    if args.add_lora_spatial or args.frozen_spatial:
        trainable.update({"backbone." + k: v for k, v in
                          optim.trainable_mask_lora_spatial(model.backbone).items()})
    if args.frozen_backbone:
        trainable.update({k: False for k in trainable if k.startswith("backbone.")})
    tx = optim.create_optimizer(
        model, lr_sched, weight_decay=args.weight_decay,
        wd_schedule=wd_sched if args.weight_decay_end else None, betas=tuple(args.opt_betas),
        eps=args.opt_eps, clip_grad=args.clip_grad, layer_decay=args.layer_decay,
        num_layers=cfg.num_hidden_layers, trainable_mask=trainable, opt_name=args.opt)
    trainer = MultitaskTrainer(model, tx, update_freq=args.update_freq)

    start_epoch, start_micro = 0, 0
    if args.auto_resume:
        meta = ckpt_lib.auto_resume(args.output_dir, model, tx)
        if meta is not None:
            start_micro = meta["micro"]
            if start_micro > 0:  # a mid-epoch (preemption) checkpoint: replay its epoch
                start_epoch = meta["epoch"]
                print(f"resumed mid-epoch {start_epoch} at micro-batch {start_micro}")
            else:
                start_epoch = meta["epoch"] + 1
                print(f"resumed from epoch {start_epoch - 1}")
    state = TrainState.create(model, tx)

    # preemption: on SIGTERM finish the update in flight, save a mid-epoch
    # checkpoint and return, so the scheduler restarts into auto-resume
    stop_requested = {"flag": False}

    def _on_sigterm(signum, frame):
        stop_requested["flag"] = True
        print("SIGTERM: will checkpoint at the next update boundary")

    previous = None
    try:
        previous = signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:
        pass  # not the main thread (embedded use): no handler, still trains

    log_writer = _log_writer(args)
    profile_dir = os.path.join(args.log_dir or os.path.join(args.output_dir, "tb"), "profile")
    try:
        for epoch in range(start_epoch, args.epochs):
            loader = MultitaskLoader(train_ds, sampler, model, crop_size=args.input_size,
                                     num_workers=args.num_workers, aug_seed=args.seed + epoch)
            epoch_micro = start_micro if epoch == start_epoch else 0
            loader.set_epoch(epoch, start_step=epoch_micro)
            # the epoch's dropout generator: a function of (seed, epoch) alone,
            # so a resumed epoch draws what it drew the first time
            gen = torch.Generator(device=dev).manual_seed(seed_of(args.seed, epoch))
            t0 = time.time()
            state, stats = trainer.train_one_epoch(
                state, iter(loader), epoch, gen, log_writer=log_writer, lr_schedule=lr_sched,
                profile_steps=args.profile_steps if epoch == start_epoch else 0,
                profile_dir=profile_dir, should_stop=lambda: stop_requested["flag"],
                start_micro=epoch_micro)
            stats["epoch_time"] = time.time() - t0
            loader.close()
            if "preempted_at_micro" in stats:
                micro_done = int(stats["preempted_at_micro"])
                ckpt_lib.save_checkpoint(args.output_dir, epoch, model, tx, step=state.step,
                                         keep_every=args.save_ckpt_freq, micro=micro_done)
                print(f"preempted: saved epoch {epoch} at micro-batch {micro_done}; "
                      "exiting for restart")
                return state
            metrics_lib.write_log_line(args.output_dir,
                                       {"epoch": epoch, **{k: float(v) for k, v in stats.items()}})
            # asynchronous: the write overlaps the next epoch; the preemption
            # save above blocks (durable before the exit)
            ckpt_lib.save_checkpoint(args.output_dir, epoch, model, tx, step=state.step,
                                     keep_every=args.save_ckpt_freq, block=False)
        ckpt_lib.wait_for_checkpoints()
    finally:
        if previous is not None:
            signal.signal(signal.SIGTERM, previous)
        if log_writer is not None:
            log_writer.flush()
    print("done")
    return state


def main(argv=None):
    args = get_args(argv)
    check_supported(args)
    train_ds, eval_ds, mtc = build_datasets(args)
    train(args, train_ds, eval_ds, mtc)


if __name__ == "__main__":
    main()
