"""Training checkpoints: save, retention, restore and auto-resume. The port
of the JAX package's ``train/checkpoint.py`` (orbax there,
``torch.distributed.checkpoint`` here, written by one process).

A checkpoint is the directory ``<output_dir>/checkpoint-<epoch>`` holding
the model's state dict, the ``ScheduledOptimizer``'s state (the inner
optimizer's per-parameter state, keyed by parameter name, and the update
count the schedules read) and ``meta`` = {epoch, step, micro}; ``micro >
0`` marks a mid-epoch (preemption) checkpoint that many micro-steps into
``epoch``. Every save is written to a temporary directory and renamed on
commit, so retention and ``latest_checkpoint`` see committed checkpoints
only.

``save_checkpoint(..., block=False)`` returns once a CPU copy of the state
is staged and writes it on a background thread (a second save first waits
for the one in flight, so saves commit in order); ``wait_for_checkpoints``
and an ``atexit`` barrier make the last save durable.

Over many processes a checkpoint is always the one-process layout: the
shards of a tensor-parallel model and of its AdamW moments are gathered
whole (every rank of a model group takes part), rank 0 alone writes and
commits, and a blocking save ends in a barrier. Every rank restores the
same checkpoint (``auto_resume`` takes rank 0's choice) and cuts its own
shards from it, so a checkpoint of any topology loads into any other and
into one process.
"""

from __future__ import annotations

import atexit
import json
import os
import re
import shutil
import threading
from typing import Dict, Optional

import torch

from streamformer_tpu_torch.parallel import mesh as mesh_lib
from streamformer_tpu_torch.parallel import sharding

_PARAMS, _STATE, _COUNT, _META, _INDEX = "params/", "optimizer/state/", "optimizer/count", "meta/", "index"


class _BackgroundWriter:
    """One save at a time on a background thread; a failure is raised by the
    next wait."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def submit(self, fn) -> None:
        self.wait()

        def run():
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 -- raised by the next wait()
                self._error = e

        self._thread = threading.Thread(target=run, name="checkpoint-writer", daemon=True)
        self._thread.start()


_WRITER = _BackgroundWriter()
atexit.register(_WRITER.wait)


def wait_for_checkpoints() -> None:
    """Barrier: block until the save in flight, if any, is committed."""
    _WRITER.wait()


def _ckpt_dir(output_dir: str, epoch: int) -> str:
    return os.path.join(os.path.abspath(output_dir), f"checkpoint-{epoch}")


def _committed(output_dir: str):
    return sorted(int(m.group(1)) for d in os.listdir(output_dir)
                  if (m := re.fullmatch(r"checkpoint-(\d+)", d)))


def _prune(output_dir: str, epoch: int, keep_every: int, keep_last: int) -> None:
    """Retention: keep the milestones (epoch % keep_every == 0) and the last
    ``keep_last`` epochs up to ``epoch``."""
    for e in _committed(output_dir):
        if e % keep_every == 0 or e >= epoch - keep_last + 1:
            continue
        shutil.rmtree(_ckpt_dir(output_dir, e), ignore_errors=True)


def _pack(named: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Tensors by name -> one flat CPU buffer per (section, dtype, device)
    and a JSON index of [name, buffer, shape, offset]: a background write of
    a few large buffers holds the interpreter lock a few times, not once per
    tensor (on an H100 host, a write of 1,400 tensors slowed the training
    thread's micro-steps three-fold)."""
    groups: Dict[str, list] = {}
    for name, t in named.items():
        key = f"{name.split('/', 1)[0]}/{str(t.dtype).replace('torch.', '')}/{t.device.type}"
        groups.setdefault(key, []).append((name, t.detach()))
    out, index = {}, []
    for key, items in groups.items():
        offset = 0
        for name, t in items:
            index.append([name, key, list(t.shape), offset])
            offset += t.numel()
        out[key] = torch.cat([t.reshape(-1) for _, t in items]).to("cpu")
    out[_INDEX] = torch.frombuffer(bytearray(json.dumps(index).encode()), dtype=torch.uint8)
    return out


def _unpack(flat: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The inverse of ``_pack`` (views into the flat buffers)."""
    out = {}
    for name, key, shape, offset in json.loads(bytes(flat[_INDEX].tolist()).decode()):
        n = 1
        for size in shape:
            n *= size
        out[name] = flat[key][offset:offset + n].view(shape)
    return out


def _whole(value, p: torch.Tensor) -> torch.Tensor:
    """``value`` (a parameter, or an optimizer tensor of its shape) whole
    when ``p`` is a tensor-parallel shard."""
    value = torch.as_tensor(value)
    info = sharding.shard_info(p)
    return sharding.full_tensor(value, info if value.shape == p.shape else None)


def _flat_state(model: torch.nn.Module, optimizer, epoch: int, step: int, micro: int
                ) -> Optional[Dict[str, torch.Tensor]]:
    """The checkpoint as a flat dict of tensors, staged on the CPU, in the
    one-process layout (None on a process other than rank 0)."""
    params = dict(model.named_parameters())
    named = {_PARAMS + k: _whole(v, params[k]) if k in params else v
             for k, v in model.state_dict().items()}
    if optimizer is not None:
        names = {id(p): n for n, p in model.named_parameters()}
        for p, state in optimizer.inner.state.items():
            for key, value in state.items():
                if value is not None:
                    named[f"{_STATE}{names[id(p)]}/{key}"] = _whole(value, p)
    if not mesh_lib.is_main_process():
        return None  # it took part in the gathers; rank 0 writes
    sd = _pack(named)
    if optimizer is not None:
        sd[_COUNT] = torch.tensor(optimizer.count, dtype=torch.int64)
    for key, value in (("epoch", epoch), ("step", step), ("micro", micro)):
        sd[_META + key] = torch.tensor(value, dtype=torch.int64)
    return sd


def _write(state: Dict[str, torch.Tensor], path: str) -> None:
    """Write to a temporary directory beside ``path``, then rename it in."""
    import torch.distributed.checkpoint as dcp

    tmp = f"{path}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    dcp.save(state, storage_writer=dcp.FileSystemWriter(tmp), no_dist=True)
    if os.path.exists(path):  # an earlier save of this epoch (a mid-epoch one)
        old = f"{path}.old-{os.getpid()}"
        os.rename(path, old)
        os.rename(tmp, path)
        shutil.rmtree(old, ignore_errors=True)
    else:
        os.rename(tmp, path)


def save_checkpoint(output_dir: str, epoch: int, model: torch.nn.Module, optimizer=None,
                    step: int = 0, keep_every: int = 10, keep_last: int = 2, micro: int = 0,
                    block: bool = True) -> str:
    """Save ``model`` and the ``ScheduledOptimizer`` as
    ``checkpoint-<epoch>``; returns its path. ``micro > 0`` marks a
    mid-epoch checkpoint. ``block=False`` returns once the CPU copy is
    staged; the write overlaps what follows. The preemption save, right
    before the process exits, keeps ``block=True``. Over many processes
    every process calls it; rank 0 writes."""
    path = _ckpt_dir(output_dir, epoch)
    state = _flat_state(model, optimizer, epoch, step, micro)
    if mesh_lib.is_main_process():
        os.makedirs(output_dir, exist_ok=True)
        _WRITER.submit(lambda: _write(state, path))
        if block:
            _WRITER.wait()
        _prune(output_dir, epoch, keep_every, keep_last)
    if block:
        mesh_lib.barrier()
    return path


def latest_checkpoint(output_dir: str) -> Optional[int]:
    wait_for_checkpoints()  # a save in flight must be visible
    if not os.path.isdir(output_dir):
        return None
    eps = _committed(output_dir)
    return max(eps) if eps else None


def _load_flat(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a checkpoint, on the CPU, by its name (``params/...``,
    ``optimizer/state/<parameter>/<field>``, ``optimizer/count``,
    ``meta/...``)."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata

    meta = dcp.FileSystemReader(path).read_metadata()
    flat = {}
    for key, md in meta.state_dict_metadata.items():
        if not isinstance(md, TensorStorageMetadata):
            raise ValueError(f"{path}: entry {key} is not a tensor")
        flat[key] = torch.empty(md.size, dtype=md.properties.dtype)
    dcp.load(flat, storage_reader=dcp.FileSystemReader(path), no_dist=True)
    return {**{k: v for k, v in flat.items() if k.startswith(_META) or k == _COUNT},
            **_unpack(flat)}


def _load_optimizer(optimizer, model: torch.nn.Module, flat: Dict[str, torch.Tensor]) -> None:
    names = {id(p): n for n, p in model.named_parameters()}
    index = {}
    for group in optimizer.inner.param_groups:
        for p in group["params"]:
            index[names[id(p)]] = len(index)  # torch's state_dict numbering
    params = dict(model.named_parameters())
    state: Dict[int, Dict[str, torch.Tensor]] = {}
    for key, value in flat.items():
        if key.startswith(_STATE):
            name, field = key[len(_STATE):].rsplit("/", 1)
            info = sharding.shard_info(params[name])
            if info is not None and value.dim() == params[name].dim():  # a moment, not a count
                value = sharding.local_piece(value, info)
            state.setdefault(index[name], {})[field] = value
    groups = optimizer.inner.state_dict()["param_groups"]
    optimizer.inner.load_state_dict({"state": state, "param_groups": groups})
    optimizer.count = int(flat[_COUNT])


def restore_checkpoint(output_dir: str, epoch: int, model: torch.nn.Module, optimizer=None
                       ) -> Dict[str, int]:
    """Load ``checkpoint-<epoch>`` into ``model`` (and ``optimizer``) in
    place; returns its meta {epoch, step, micro}. A tensor-parallel model
    takes its shards of the whole tensors."""
    wait_for_checkpoints()
    flat = _load_flat(_ckpt_dir(output_dir, epoch))
    params = dict(model.named_parameters())
    model.load_state_dict({
        name: sharding.local_piece(v, sharding.shard_info(params[name])) if name in params else v
        for name, v in ((k[len(_PARAMS):], v) for k, v in flat.items() if k.startswith(_PARAMS))})
    if optimizer is not None:
        _load_optimizer(optimizer, model, flat)
    return {key: int(flat[_META + key]) for key in ("epoch", "step", "micro")}


def auto_resume(output_dir: str, model: torch.nn.Module, optimizer=None
                ) -> Optional[Dict[str, int]]:
    """Restore the newest ``checkpoint-*`` if there is one (the reference's
    auto_load_model); returns its meta, or None. Over many processes every
    process restores the one rank 0 finds."""
    e = latest_checkpoint(output_dir)
    e = mesh_lib.broadcast_int(-1 if e is None else e)
    if e < 0:
        return None
    return restore_checkpoint(output_dir, e, model, optimizer)
