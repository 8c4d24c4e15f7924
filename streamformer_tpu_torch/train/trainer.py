"""Multitask trainer: per-task train steps, gradient accumulation, the
epoch loop. Port of the JAX package's ``train/trainer.py`` for one process
and one GPU.

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
  masks from a generator seeded with a fixed function of the epoch
  generator's seed and m, so a resumed epoch (``start_micro``) replays the
  same masks without fast-forwarding anything.

More than one GPU (a mesh, sharded batches) is ROADMAP item 14: ``mesh=``
raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch

from streamformer_tpu_torch.train import metrics as metrics_lib
from streamformer_tpu_torch.train.optim import ScheduledOptimizer


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module  # MultitaskModel; its parameters are the state
    optimizer: ScheduledOptimizer
    grad_accum: Dict[str, torch.Tensor]  # fp32 gradient buffer, by parameter name
    accum_count: int
    step: int  # optimizer updates applied

    @classmethod
    def create(cls, model: torch.nn.Module, tx: ScheduledOptimizer) -> "TrainState":
        accum = {name: torch.zeros_like(p) for name, p in model.named_parameters()
                 if p.requires_grad}
        return cls(model=model, optimizer=tx, grad_accum=accum, accum_count=0, step=tx.count)

    def zero_accum(self) -> None:
        torch._foreach_zero_(list(self.grad_accum.values()))
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
        if mesh is not None:
            raise NotImplementedError(
                "a device mesh (data or tensor parallel training) is ROADMAP slice 4, "
                "item 14; the trainer runs one process on one GPU"
            )
        self.model = model
        self.tx = tx
        self.update_freq = update_freq
        self._step_fns: Dict[Tuple[str, bool], Callable] = {}
        self._step_gen: Optional[torch.Generator] = None
        self.last_profile = None  # the torch.profiler.profile of the last traced window

    # ------------------------------------------------------------------

    def _build_step(self, task_name: str, apply_update: bool) -> Callable:
        update_freq = self.update_freq
        model = self.model

        def step_fn(state: TrainState, pixel_values, task_input,
                    generator: Optional[torch.Generator] = None):
            model.zero_grad(set_to_none=True)
            loss, _ = model.loss_fn(task_name, pixel_values, task_input, generator=generator,
                                    deterministic=False)
            loss.backward()
            with torch.no_grad():
                named = dict(model.named_parameters())
                pairs = [(state.grad_accum[n], named[n].grad) for n in state.grad_accum
                         if named[n].grad is not None]
                accs, grads = [a for a, _ in pairs], [g for _, g in pairs]
                torch._foreach_add_(accs, torch._foreach_div(grads, float(update_freq)))
                state.accum_count += 1
                if apply_update:
                    bufs = list(state.grad_accum.values())
                    # over every leaf; the optimizer's clip sees the trainable ones
                    grad_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(bufs)))
                    for n, buf in state.grad_accum.items():
                        named[n].grad = buf  # the clip may scale it in place; zeroed below
                    state.optimizer.step()
                    model.zero_grad(set_to_none=True)
                    state.zero_accum()
                    state.step += 1
                else:
                    grad_norm = torch.zeros((), device=loss.device)
            return state, {"loss": loss.detach(), "grad_norm": grad_norm}

        return step_fn

    def step_fn(self, task_name: str, apply_update: bool) -> Callable:
        """The micro-step of ``task_name``: ``fn(state, pixel_values,
        task_input, generator) -> (state, {"loss", "grad_norm"})``, both
        scalars left on the device. With ``apply_update`` the optimizer then
        applies the accumulated gradients and ``grad_norm`` is their global
        norm (0 otherwise)."""
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
        logger = metrics_lib.MetricLogger()
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
