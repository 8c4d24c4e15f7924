"""Multitask trainer: per-task train steps, gradient accumulation, the
epoch loop. Port of the JAX package's ``train/trainer.py``: one process a
GPU, one or many processes.

* One task per micro-step; the task's name picks the head.
* Gradient accumulation across micro-steps of different tasks: each
  micro-step adds its gradients, scaled by ``1 / update_freq``, to an fp32
  buffer in ``TrainState``; every ``update_freq`` micro-steps the optimizer
  applies the buffer and the buffer is zeroed.
* bf16 compute over fp32 master parameters (``MultitaskModel``'s backbone is
  the trainable encoder); no loss scaler, bf16 has fp32's exponent range.
* Losses stay on the device between ``print_freq`` flushes; a non-finite
  loss raises ``NonFiniteLossError`` at the flush.
* State is held by reference and updated in place: ``TrainState`` points at
  the model and the optimizer, and the step functions return it for the JAX
  package's calling convention.
* Randomness: micro-step m of an epoch draws its dropout and drop-path
  masks keyed by (a fixed function of the epoch generator's seed and m,
  each row's global sample index) (``encoder.Draws``), so a resumed epoch
  (``start_micro``) replays the same masks without fast-forwarding
  anything, and a data rank draws its rows' masks of the one-process run.

``mesh=`` (``parallel.mesh.make_mesh``: dims ``data`` and ``model``) trains
over many processes, as the JAX trainer over a mesh does:

* data parallelism: each data rank is fed its rank-strided rows of the
  global batch (a loader over a sampler of ``num_replicas = data``, or
  ``shard_batch`` on the global batch), and once per update the fp32
  accumulation buffer, one flat tensor, is averaged over the data group in
  buckets (the sync of DDP under ``no_sync``, on the last micro-step); the
  heads take
  the data group, so the ring and gathered heads keep the global batch's
  meaning, and the logged loss is the data group's mean, the global
  batch's loss;
* tensor and sequence parallelism over ``model``: the model is sharded
  first (``parallel.sharding.shard_model``, then the optimizer is built);
  the partial gradients of replicated leaves are summed over the model
  group, and the clip and the reported ``grad_norm`` count the sharded
  leaves over the group and each replicated leaf once.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch
import torch.distributed as dist

from streamformer_tpu_torch.models.encoder import Draws
from streamformer_tpu_torch.models.multitask import head_type_for_task
from streamformer_tpu_torch.parallel import mesh as mesh_lib
from streamformer_tpu_torch.parallel import sharding
from streamformer_tpu_torch.train import metrics as metrics_lib
from streamformer_tpu_torch.train.optim import ScheduledOptimizer

# the leaves of each head kind's task input that hold one row a sample (the
# rest, label tables, are the batch's)
PER_SAMPLE = {
    "classification": ("label",),
    "retrieval": ("caption_ids",),
    "grounding": ("caption_ids", "label"),
    "universal_localization": ("label_embeddings", "class_mask", "label"),
    "naive_localization": ("target_labels",),
    "vis": ("label_embeddings", "class_mask", "mask_target"),
    "refervos": ("caption_ids", "mask_target"),
}
BUCKET = 1 << 24  # elements of the flat gradient buffer an all-reduce carries (64 MiB)


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module  # MultitaskModel; its parameters are the state
    optimizer: ScheduledOptimizer
    grad_accum: Dict[str, torch.Tensor]  # fp32 gradient buffer, by parameter name
    accum_count: int
    step: int  # optimizer updates applied
    flat: Optional[torch.Tensor] = None  # the one buffer grad_accum's tensors are views of
    n_partial: int = 0  # its leading elements: the gradients summed over the model group

    @classmethod
    def create(cls, model: torch.nn.Module, tx: ScheduledOptimizer) -> "TrainState":
        named = {n: p for n, p in model.named_parameters() if p.requires_grad}
        names = sharding.partial_first(named)
        device = next(iter(named.values())).device if named else None
        flat = torch.zeros(sum(named[n].numel() for n in names), dtype=torch.float32,
                           device=device)
        accum, offset, n_partial = {}, 0, 0
        for n in names:
            p = named[n]
            accum[n] = flat[offset:offset + p.numel()].view(p.shape)
            offset += p.numel()
            if getattr(p, "tp_partial", None) is not None:
                n_partial = offset
        return cls(model=model, optimizer=tx, grad_accum=accum, accum_count=0, step=tx.count,
                   flat=flat, n_partial=n_partial)

    def zero_accum(self) -> None:
        self.flat.zero_()
        self.accum_count = 0


class NonFiniteLossError(RuntimeError):
    pass


def _step_seed(generator: Optional[torch.Generator], micro: int) -> Optional[int]:
    """Seed of micro-step ``micro``'s generator: a fixed mix of the epoch
    generator's seed and the micro-step index."""
    if generator is None:
        return None
    return (generator.initial_seed() * 1000003 + 7919 * (micro + 1)) % (2**63 - 1)


class MultitaskTrainer:
    def __init__(self, model, tx: ScheduledOptimizer, update_freq: int = 1, mesh=None):
        """``mesh``: a ``DeviceMesh`` with a ``data`` dim (and a ``model``
        dim, over which ``model`` must already be sharded), or None for one
        process."""
        names = getattr(mesh, "mesh_dim_names", None)
        if mesh is not None and (not names or "data" not in names
                                 or not set(names) <= {"data", "model"}):
            raise ValueError(f"mesh {mesh!r}: a DeviceMesh of dims ('data', 'model') "
                             "(parallel.mesh.make_mesh)")
        par = model.backbone.parallel
        if mesh_lib.dim_size(mesh, "model") != (1 if par is None else par.size):
            raise ValueError("shard the model over the mesh's model dim "
                             "(parallel.sharding.shard_model) before building its optimizer")
        self.model = model
        self.tx = tx
        self.update_freq = update_freq
        self.mesh = mesh
        self.data_group = mesh_lib.dim_group(mesh, "data")
        self.dp = mesh_lib.dim_size(mesh, "data")
        self.data_rank = mesh_lib.dim_rank(mesh, "data")
        self._step_fns: Dict[Tuple[str, bool], Callable] = {}
        self._step_gen: Optional[torch.Generator] = None
        self.last_profile = None  # the torch.profiler.profile of the last traced window

    # ------------------------------------------------------------------

    @staticmethod
    def _samples(task_name: str, pixel_values: torch.Tensor, task_input):
        """(the per-sample leaves, the samples, the pixel rows a sample)."""
        keys = [k for k in PER_SAMPLE[head_type_for_task(task_name)] if k in task_input]
        samples = len(task_input[keys[0]]) if keys else pixel_values.shape[0]
        return keys, samples, pixel_values.shape[0] // samples

    def shard_batch(self, task_name: str, batch: Dict[str, Any]) -> Dict[str, Any]:
        """This data rank's rows of a global batch ``{"pixel_values",
        "task_input"}``, what its sampler would give it: samples rank, rank +
        dp, ... of the per-sample leaves (``PER_SAMPLE``) and their pixel
        rows (a windowed localization sample owns several consecutive ones),
        as strided views; the batch's own leaves whole."""
        pixel_values, task_input = torch.as_tensor(batch["pixel_values"]), batch["task_input"]
        keys, samples, rows_per = self._samples(task_name, pixel_values, task_input)
        if samples % self.dp:
            raise ValueError(f"a global batch of {samples} samples does not divide over "
                             f"{self.dp} data ranks")
        r, dp, rest = self.data_rank, self.dp, tuple(pixel_values.shape[1:])
        pixels = pixel_values.reshape((samples, rows_per) + rest)[r::dp].reshape((-1,) + rest)
        return {"pixel_values": pixels,
                "task_input": {k: (v[r::dp] if k in keys else v) for k, v in task_input.items()}}

    def _global_rows(self, task_name: str, pixel_values, task_input) -> torch.Tensor:
        """The global indices of this data rank's pixel rows, made on the
        model's device (no copy from the host, so no wait for the card)."""
        _, samples, rows_per = self._samples(task_name, pixel_values, task_input)
        dev = self.model.device
        first = self.data_rank + self.dp * torch.arange(samples, device=dev)
        return (first[:, None] * rows_per + torch.arange(rows_per, device=dev)).reshape(-1)

    def _sync_gradients(self, state: TrainState) -> None:
        """Once per update: the flat buffer averaged over the data group in
        buckets of ``BUCKET`` elements, then the partial gradients summed
        over the model group."""
        if self.mesh is None:
            return
        for bucket in state.flat.split(BUCKET):
            dist.all_reduce(bucket, group=self.data_group)
        if self.dp > 1:
            state.flat.div_(self.dp)
        sharding.sum_partial_grads(state.flat, state.n_partial, self.model.backbone.parallel)

    def _build_step(self, task_name: str, apply_update: bool) -> Callable:
        update_freq = self.update_freq
        model = self.model

        def step_fn(state: TrainState, pixel_values, task_input, generator=None):
            draws = None  # none to key where no rate draws a mask
            cfg = model.cfg
            if generator is not None and (cfg.hidden_dropout_prob or cfg.drop_path_rate):
                draws = Draws(generator.initial_seed(),
                              self._global_rows(task_name, pixel_values, task_input))
            model.zero_grad(set_to_none=True)
            loss, _ = model.loss_fn(task_name, pixel_values, task_input, generator=draws,
                                    deterministic=False, group=self.data_group)
            loss.backward()
            with torch.no_grad():
                loss = loss.detach()
                if self.mesh is not None:  # the global batch's loss
                    dist.all_reduce(loss, group=self.data_group)
                    loss = loss / self.dp
                named = dict(model.named_parameters())
                pairs = [(state.grad_accum[n], named[n].grad) for n in state.grad_accum
                         if named[n].grad is not None]
                accs, grads = [a for a, _ in pairs], [g for _, g in pairs]
                torch._foreach_add_(accs, torch._foreach_div(grads, float(update_freq)))
                state.accum_count += 1
                if apply_update:
                    self._sync_gradients(state)
                    # over every leaf; the optimizer's clip sees the trainable ones
                    grad_norm = sharding.grad_norm([named[n] for n in state.grad_accum],
                                                   state.grad_accum.values())
                    for n, buf in state.grad_accum.items():
                        named[n].grad = buf  # the clip may scale it in place; zeroed below
                    state.optimizer.step()
                    model.zero_grad(set_to_none=True)
                    state.zero_accum()
                    state.step += 1
                else:
                    grad_norm = torch.zeros((), device=loss.device)
            return state, {"loss": loss, "grad_norm": grad_norm}

        return step_fn

    def step_fn(self, task_name: str, apply_update: bool) -> Callable:
        """The micro-step of ``task_name``: ``fn(state, pixel_values,
        task_input, generator) -> (state, {"loss", "grad_norm"})``, both
        scalars left on the device. With ``apply_update`` the optimizer then
        applies the accumulated gradients and ``grad_norm`` is their global
        norm (0 otherwise). ``generator`` keys the micro-step's masks by its
        seed (read, never advanced). With a mesh the batch is this data
        rank's rows of the global batch (``shard_batch``), and the loss is
        the global batch's."""
        key = (task_name, apply_update)
        if key not in self._step_fns:
            self._step_fns[key] = self._build_step(task_name, apply_update)
        return self._step_fns[key]

    # ------------------------------------------------------------------

    def train_one_epoch(
        self,
        state: TrainState,
        batches: Iterable[Tuple[str, Dict[str, Any]]],
        epoch: int,
        generator: Optional[torch.Generator] = None,
        log_writer: Optional[metrics_lib.TensorboardLogger] = None,
        print_freq: int = 10,
        lr_schedule=None,
        profile_steps: int = 0,
        profile_dir: Optional[str] = None,
        should_stop: Optional[Callable[[], bool]] = None,
        start_micro: int = 0,
    ) -> Tuple[TrainState, Dict[str, float]]:
        """batches yields (task_name, {"pixel_values": ..., "task_input": ...}).

        ``generator`` seeds the epoch's dropout and drop-path masks (None:
        none are drawn); it is read, not advanced.

        ``profile_steps > 0`` records a ``torch.profiler`` trace of that many
        steady-state micro-steps (the first two are skipped), written as a
        Chrome trace under ``profile_dir`` and kept as ``self.last_profile``.

        Preemption: ``should_stop`` is polled after every optimizer update;
        when it returns True the loop flushes and returns early with
        ``stats["preempted_at_micro"]`` = micro-steps consumed. Stops land
        only on update boundaries, so the gradient buffer is empty then.
        ``start_micro`` resumes: the caller feeds the SAME epoch's batch
        stream with the first ``start_micro`` batches skipped, and micro-step
        m draws the masks it would have drawn, so a resumed epoch equals an
        uninterrupted one bit for bit.

        Losses stay on the device between ``print_freq`` boundaries (a fetch
        per step would make the host wait for the device each time); a
        non-finite loss raises at the flush, at most ``print_freq`` steps
        late.
        """
        logger = metrics_lib.MetricLogger(quiet=not mesh_lib.is_main_process())
        # discard accumulation left over from an epoch whose batch count was
        # not a multiple of update_freq: an epoch-boundary checkpoint restores
        # with an empty buffer, so this keeps resumed == uninterrupted
        if state.accum_count != 0:
            state.zero_accum()
        micro = start_micro
        preempted = False
        device = next(iter(state.grad_accum.values())).device if state.grad_accum else None
        if generator is not None and self._step_gen is None:
            self._step_gen = torch.Generator(device=device)
        pending: List[Tuple[str, torch.Tensor, Optional[torch.Tensor], int]] = []

        def flush():
            for tname, loss_dev, gnorm_dev, step_i in pending:
                loss = float(loss_dev)
                if not math.isfinite(loss):
                    raise NonFiniteLossError(f"Loss is {loss} on task {tname}, stopping training")
                logger.update(**{f"loss_{tname}": loss, "loss": loss})
                if gnorm_dev is not None:
                    logger.update(grad_norm=float(gnorm_dev))
                if log_writer is not None:
                    log_writer.set_step()
                    log_writer.update(head="loss", **{tname: loss})
                    if lr_schedule is not None:
                        log_writer.update(head="opt", lr=float(lr_schedule(int(step_i))))
            pending.clear()

        # steady-state profiling window [skip, skip + profile_steps), anchored
        # at start_micro so a mid-epoch resume still traces
        profile_skip = start_micro + 2 if profile_steps > 0 else -1
        prof = None

        def stop_trace():
            nonlocal prof
            if prof is not None:
                flush()  # drain pending device work into the trace
                prof.stop()
                out_dir = profile_dir or "profile"
                os.makedirs(out_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(out_dir, f"trace_epoch{epoch}.json"))
                self.last_profile, prof = prof, None

        try:
            for task_name, batch in logger.log_every(batches, print_freq,
                                                     header=f"Epoch [{epoch}]"):
                if micro == profile_skip:
                    flush()  # earlier work does not belong to the trace
                    from torch.profiler import ProfilerActivity, profile

                    acts = [ProfilerActivity.CPU]
                    if device is not None and device.type == "cuda":
                        acts.append(ProfilerActivity.CUDA)
                    prof = profile(activities=acts)
                    prof.start()
                apply_update = (micro + 1) % self.update_freq == 0
                step_gen = None
                if generator is not None:
                    step_gen = self._step_gen.manual_seed(_step_seed(generator, micro))
                fn = self.step_fn(task_name, apply_update)
                # the schedules are read at the count the update is applied
                # with, which is the count before it
                step_applied = state.step
                state, out = fn(state, batch["pixel_values"], batch["task_input"], step_gen)
                pending.append((task_name, out["loss"],
                                out["grad_norm"] if apply_update else None, step_applied))
                micro += 1
                if prof is not None and micro >= profile_skip + profile_steps:
                    stop_trace()
                if micro % print_freq == 0:
                    flush()
                if apply_update and should_stop is not None and should_stop():
                    preempted = True
                    break
        finally:
            stop_trace()
        flush()
        stats = {k: m.global_avg for k, m in logger.meters.items()}
        if preempted:
            stats["preempted_at_micro"] = micro
        return state, stats
