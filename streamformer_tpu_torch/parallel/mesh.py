"""Process groups and device meshes.

Port of the JAX package's ``parallel/mesh.py`` and of the bootstrap in its
``train/run.py``. The reference trains under ``torchrun`` into NCCL process
groups; the JAX package's single controller drives a ``jax.sharding.Mesh``.
Here each process drives one GPU (or, with gloo, one CPU), joins the job's
process group with ``init_distributed`` and arranges the world as a
``torch.distributed.device_mesh.DeviceMesh``:

* ``("data", "model")`` (``make_mesh``): data parallelism (gradient
  averaging, the ring SigLIP exchange, the gathered heads) over ``data``;
  tensor and sequence parallelism over ``model``;
* ``("data", "pipe")`` (``make_pipeline_mesh``): GPipe stages over ``pipe``.

The rank of a process is ``data_index * model + model_index``: the ranks of
one model group are consecutive.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None, process_id: Optional[int] = None,
                     device=None) -> torch.device:
    """Join the job's process group; returns this process's device.

    Without arguments the job is ``torchrun``'s (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``); otherwise
    ``coordinator_address`` ("host:port" of process 0), ``num_processes`` and
    ``process_id`` name it, as the JAX package's flags do. ``device`` "cpu"
    runs gloo on the CPU; the default, ``cuda``, runs NCCL, each process on
    ``cuda:LOCAL_RANK`` (the process id modulo the cards without torchrun),
    and raises without a card: nothing falls back to the CPU."""
    dev_type = torch.device("cuda" if device is None else device).type
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator_address needs --num_processes and --process_id")
        init_method, world, rank = f"tcp://{coordinator_address}", num_processes, process_id
        local = int(os.environ.get("LOCAL_RANK", rank))
    else:
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
                   if k not in os.environ]
        if missing:
            raise RuntimeError(f"no process group to join: {', '.join(missing)} unset (run under "
                               "torchrun, or pass --coordinator_address, --num_processes and "
                               "--process_id)")
        init_method, world, rank = "env://", int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        local = int(os.environ.get("LOCAL_RANK", 0))
    if dev_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to train on the "
                               "CPU over gloo")
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        dev, backend = torch.device(dev_type), "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    return dev


def _device_type(device_type: Optional[str]) -> str:
    if device_type is not None:
        return device_type
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(data: Optional[int] = None, model: int = 1, device_type: Optional[str] = None):
    """A ``DeviceMesh`` of dims ``("data", "model")`` over every process of
    the job (``data`` defaults to world / model; data x model must be the
    world size). ``device_type`` defaults to the backend's ("cuda" for
    NCCL, "cpu" for gloo)."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    data = world // model if data is None else data
    if data * model != world:
        raise ValueError(f"a mesh of data={data} x model={model} needs {data * model} processes; "
                         f"the job has {world}")
    return init_device_mesh(_device_type(device_type), (data, model),
                            mesh_dim_names=("data", "model"))


def make_pipeline_mesh(data: Optional[int] = None, pipe: int = 1,
                       device_type: Optional[str] = None):
    """A ``DeviceMesh`` of dims ``("data", "pipe")``: each data slice runs
    its own pipeline of ``pipe`` stages on consecutive ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    data = world // pipe if data is None else data
    if data * pipe != world:
        raise ValueError(f"a mesh of data={data} x pipe={pipe} needs {data * pipe} processes; "
                         f"the job has {world}")
    return init_device_mesh(_device_type(device_type), (data, pipe),
                            mesh_dim_names=("data", "pipe"))


def dim_size(mesh, name: str) -> int:
    """The size of ``mesh``'s dim ``name``; 1 without a mesh or that dim."""
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(name))


def dim_rank(mesh, name: str) -> int:
    """This process's index along ``mesh``'s dim ``name``; 0 without."""
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return 0
    return mesh.get_local_rank(name)


def dim_group(mesh, name: str):
    """The process group of this process's ``name`` dim; None without."""
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return None
    return mesh.get_group(name)


def slot_share(mesh, axis: str, slots: int):
    """``(first, count, group)``: this process's contiguous share of a
    serving engine's ``slots`` over ``mesh``'s dim ``axis`` and that dim's
    group; all of them and no group without a mesh. ``slots`` must divide
    over the dim."""
    if mesh is None:
        return 0, slots, None
    if axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"the mesh has no axis {axis!r}: {mesh.mesh_dim_names}")
    ranks = dim_size(mesh, axis)
    if slots % ranks:
        raise ValueError(f"slots={slots} must divide over mesh axis '{axis}'={ranks}")
    local = slots // ranks
    return dim_rank(mesh, axis) * local, local, dim_group(mesh, axis)


def is_main_process() -> bool:
    """Rank 0 of the job, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def any_rank(flag: bool) -> bool:
    """Whether ``flag`` is set on any process of the job (a collective every
    process calls; ``flag`` itself in one process). It runs on the CPU over
    a gloo group, so a CUDA job does not wait on its card for it."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return flag
    t = torch.tensor([int(flag)])
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_control_group())
    return bool(t.item())


_CONTROL = {}


def _control_group():
    if "group" not in _CONTROL:
        _CONTROL["group"] = dist.new_group(backend="gloo")
    return _CONTROL["group"]


def broadcast_int(value: int) -> int:
    """Rank 0's ``value`` on every process (``value`` in one process)."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return value
    t = torch.tensor([value], dtype=torch.int64)
    dist.broadcast(t, src=0, group=_control_group())
    return int(t.item())


def barrier() -> None:
    """Every process of the job waits for the others; nothing in one."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier(group=_control_group())


def shutdown() -> None:
    """Leave the job's process group (``init_distributed``'s inverse)."""
    _CONTROL.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


def free_port() -> int:
    """A free TCP port on localhost, for a job's coordinator."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_ranks(cmd: Sequence[str], world: int, timeout: float = 600,
              env: Optional[Dict[str, str]] = None, wait: bool = True):
    """Run ``cmd`` (a Python command line taking ``--rank``, ``--world`` and
    ``--port``) as ``world`` processes of one job on this host, the
    package's checkout on their path and ``env`` added to their
    environment; returns each rank's output, or raises ``RuntimeError``
    with the failed ranks' output. With ``wait=False`` it returns at once a
    function that waits for the ranks (within ``timeout`` of their start)
    and returns the same, so the caller can work meanwhile."""
    port = free_port()
    env = dict(os.environ, **(env or {}))
    env["PYTHONPATH"] = _ROOT + os.pathsep + env.get("PYTHONPATH", "")
    deadline = time.monotonic() + timeout
    procs = [subprocess.Popen([sys.executable, *cmd, "--rank", str(r), "--world", str(world),
                               "--port", str(port)], env=env, cwd=_ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]

    def join() -> List[str]:
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1))[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        bad = [r for r, p in enumerate(procs) if p.returncode != 0]
        if bad:
            raise RuntimeError(f"{' '.join(cmd)}: ranks {bad} of {world} failed\n" + "\n".join(
                f"--- rank {r}\n{logs[r][-4000:] if r < len(logs) else ''}" for r in bad))
        return logs

    return join() if wait else join
