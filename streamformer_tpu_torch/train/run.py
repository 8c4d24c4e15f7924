"""Training entry point: the port of the JAX package's ``train/run.py``
(reference run_finetuning_multi_task.py), one process a GPU.

Usage:
    python -m streamformer_tpu_torch.train.run --metadata path/to/all.yaml \\
        --output_dir out --batch_size 16 --epochs 20 --lr 2e-5 ...
    torchrun --nproc_per_node 8 -m streamformer_tpu_torch.train.run \\
        --distributed --mp 2 --metadata ... (4 data ranks x 2 model ranks)

``--device cpu`` runs it on the CPU (the kernels' plain versions). Flow:
datasets from the YAML metadata (``build_datasets``) -> ``train``: the
model (and ``--model_path`` through ``from_pretrained``), the label tables,
the trainable masks, the optimizer with its schedules, auto-resume, then
the epoch loop with an asynchronous checkpoint after every epoch and a
blocking mid-epoch one on SIGTERM, after which the process exits for a
restart into the same run.

``--distributed`` joins the job's process group (``torchrun``'s
environment, or ``--coordinator_address``, ``--num_processes`` and
``--process_id``; NCCL on the cards, gloo with ``--device cpu``) and trains
on a ``(data, model)`` mesh of ``--dp`` x ``--mp`` ranks (``--dp`` 0: the
world over ``--mp``): ``--batch_size`` is a data rank's, the sampler gives
each data rank its rank-strided rows, the model is sharded over ``--mp``
(``--shard_patches``: sequence parallel too), and rank 0 alone logs and
writes checkpoints.

``--eval_freq N`` validates every N epochs, after the epoch's checkpoint is
started, on the metadata's eval union (``eval.validate.evaluate_multitask``:
classification, retrieval and grounding tasks), printing and logging
``eval_<task>_<metric>`` to ``log.txt``. Under ``--distributed`` with
``--mp`` > 1 every rank runs the eval forward (the sharded model's
collectives need them all); rank 0 alone prints and logs. The eval draws
nothing: the next epoch trains as it would without it, bit for bit.
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
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel mesh dim; 0 = the world size / mp")
    p.add_argument("--mp", type=int, default=1, help="model (tensor) parallel mesh dim")
    p.add_argument("--shard_patches", action="store_true",
                   help="sequence parallel: shard the patch axis over mp")
    p.add_argument("--distributed", action="store_true",
                   help="join the job's process group (torchrun's environment)")
    p.add_argument("--coordinator_address", default=None,
                   help="host:port of process 0 (with --distributed)")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--profile_steps", type=int, default=0,
                   help="trace this many steady-state micro-steps of the first epoch "
                        "(torch.profiler, a Chrome trace under <log_dir>/profile)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


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


def _mesh(args):
    """The (data, model) mesh of the job, or None in one process without
    ``--distributed``; refuses a --dp x --mp that is not the world."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    dp = args.dp if args.dp > 0 else max(world // args.mp, 1)
    if dp * args.mp != world:
        raise ValueError(f"--dp {dp} x --mp {args.mp} needs {dp * args.mp} processes; the job has "
                         f"world size {world} (one process a GPU: launch with torchrun and "
                         "--distributed)")
    if not dist.is_initialized():
        return None
    from streamformer_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(dp, args.mp)


def train(args, train_ds, eval_ds, mtc):
    """Train on ``train_ds`` (a ``MultiTaskDataset``) with the task config
    ``mtc``; returns the ``TrainState``. On SIGTERM it saves a mid-epoch
    checkpoint at the next update boundary and returns; a later call with
    the same ``output_dir`` resumes from it. Inside a process group (see
    ``main``) every process calls it and trains its part of the mesh.
    ``eval_ds`` (a ``MultiTaskDataset`` or None) is what ``--eval_freq``
    validates on."""
    import torch

    from streamformer_tpu_torch.checkpoint.hf_import import from_pretrained
    from streamformer_tpu_torch.config import StreamformerConfig
    from streamformer_tpu_torch.data.collate import MultitaskLoader, seed_of
    from streamformer_tpu_torch.data.samplers import DistributedBatchTaskUniqueSampler
    from streamformer_tpu_torch.eval.validate import evaluate_multitask
    from streamformer_tpu_torch.models.encoder import resolve_device
    from streamformer_tpu_torch.models.multitask import MultitaskModel
    from streamformer_tpu_torch.models.text_encoder import SiglipTextConfig
    from streamformer_tpu_torch.parallel import mesh as mesh_lib
    from streamformer_tpu_torch.parallel.sharding import shard_model
    from streamformer_tpu_torch.train import checkpoint as ckpt_lib
    from streamformer_tpu_torch.train import metrics as metrics_lib
    from streamformer_tpu_torch.train import optim
    from streamformer_tpu_torch.train.trainer import MultitaskTrainer, TrainState

    mesh = _mesh(args)
    dp, data_rank = mesh_lib.dim_size(mesh, "data"), mesh_lib.dim_rank(mesh, "data")
    main_process = mesh_lib.is_main_process()
    say = print if main_process else (lambda *a, **k: None)
    dev = resolve_device(args.device)
    if dev.type == "cuda" and mesh is not None:
        dev = torch.device("cuda", torch.cuda.current_device())  # init_distributed's card
    if main_process:
        os.makedirs(args.output_dir, exist_ok=True)
        with open(os.path.join(args.output_dir, "args.json"), "w") as f:
            json.dump(vars(args), f, indent=2)
    say(f"train samples: {len(train_ds)} tasks: {list(mtc)} device: {dev}"
        + (f" mesh: data={dp} model={args.mp}" if mesh is not None else ""))

    cfg = StreamformerConfig(
        num_frames=args.num_frames, image_size=args.input_size, hidden_size=args.hidden_size,
        num_hidden_layers=args.num_layers, num_attention_heads=args.num_heads,
        intermediate_size=args.intermediate_size,
        enable_causal_temporal=args.enable_causal_temporal,
        add_lora_spatial=args.add_lora_spatial, dtype="bfloat16" if args.bf16 else "float32",
        remat=args.remat, shard_patches=args.shard_patches and args.mp > 1)
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
        say(f"loaded backbone from {args.model_path}")
    model.prepare_for_multi_tasks()
    shard_model(model, mesh)  # before the optimizer, which then holds the shards' moments

    # the linear lr scaling rule over the total batch, every data rank's
    total_bs = args.batch_size * args.update_freq * dp
    lr = optim.scale_lr(args.lr, total_bs, args.num_sample)
    sampler = DistributedBatchTaskUniqueSampler(train_ds.task_specs(), batch_size=args.batch_size,
                                                num_replicas=dp, rank=data_rank, seed=args.seed)
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
    trainer = MultitaskTrainer(model, tx, update_freq=args.update_freq, mesh=mesh)

    start_epoch, start_micro = 0, 0
    if args.auto_resume:
        meta = ckpt_lib.auto_resume(args.output_dir, model, tx)
        if meta is not None:
            start_micro = meta["micro"]
            if start_micro > 0:  # a mid-epoch (preemption) checkpoint: replay its epoch
                start_epoch = meta["epoch"]
                say(f"resumed mid-epoch {start_epoch} at micro-batch {start_micro}")
            else:
                start_epoch = meta["epoch"] + 1
                say(f"resumed from epoch {start_epoch - 1}")
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

    log_writer = _log_writer(args) if main_process else None
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
                profile_steps=args.profile_steps if epoch == start_epoch and main_process else 0,
                profile_dir=profile_dir,
                should_stop=lambda: mesh_lib.any_rank(stop_requested["flag"]),
                start_micro=epoch_micro)
            stats["epoch_time"] = time.time() - t0
            loader.close()
            if "preempted_at_micro" in stats:
                micro_done = int(stats["preempted_at_micro"])
                ckpt_lib.save_checkpoint(args.output_dir, epoch, model, tx, step=state.step,
                                         keep_every=args.save_ckpt_freq, micro=micro_done)
                say(f"preempted: saved epoch {epoch} at micro-batch {micro_done}; "
                    "exiting for restart")
                return state
            metrics_lib.write_log_line(args.output_dir,
                                       {"epoch": epoch, **{k: float(v) for k, v in stats.items()}})
            # asynchronous: the write overlaps the next epoch; the preemption
            # save above blocks (durable before the exit)
            ckpt_lib.save_checkpoint(args.output_dir, epoch, model, tx, step=state.step,
                                     keep_every=args.save_ckpt_freq, block=False)
            # a sharded model's forward is collective: every rank evaluates
            evaluates = mesh is None or args.mp > 1 or main_process
            if args.eval_freq and eval_ds and (epoch + 1) % args.eval_freq == 0 and evaluates:
                ev = evaluate_multitask(model, eval_ds, crop_size=args.input_size)
                flat = {f"eval_{t}_{k}": float(v) for t, m in ev.items() for k, v in m.items()}
                say(f"epoch {epoch} eval:", flat)
                if main_process:
                    metrics_lib.write_log_line(args.output_dir, {"epoch": epoch, **flat})
        ckpt_lib.wait_for_checkpoints()
        mesh_lib.barrier()  # the last save is committed before any process returns
    finally:
        if previous is not None:
            signal.signal(signal.SIGTERM, previous)
        if log_writer is not None:
            log_writer.flush()
    say("done")
    return state


def main(argv=None):
    args = get_args(argv)
    from streamformer_tpu_torch.parallel import mesh as mesh_lib

    if args.distributed:
        mesh_lib.init_distributed(args.coordinator_address, args.num_processes, args.process_id,
                                  device=args.device)
    try:
        train_ds, eval_ds, mtc = build_datasets(args)
        train(args, train_ds, eval_ds, mtc)
    finally:
        if args.distributed:
            mesh_lib.shutdown()


if __name__ == "__main__":
    main()
