"""Build the port's CUDA kernels with nvcc at first use and load them.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface, ``build/lib<name>-<digest>.so`` at the root of the checkout,
loaded with ``ctypes``. The digest covers the source, every header in
``csrc/`` and the flags, so an edited kernel is rebuilt and a stale library
is never loaded. Sources are compiled for ``sm_90a`` (Hopper) only, one
``nvcc`` per source, all started together. A failed build raises; nothing
falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
SOURCES = (
    "temporal_decode_pm", "temporal_decode_rm", "temporal_append_pm", "temporal_decode_pm_int8",
    "spatial_flat", "temporal_fullclip", "spatial_flat_bwd", "temporal_fullclip_bwd",
    "msdeform_attn",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}
_entries: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: ``nvcc`` on PATH, else under CUDA_HOME."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME): the CUDA kernels are built from "
        f"{CSRC} at first use"
    )


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> None:
    """Compile every named source whose library is missing, in parallel.

    The compiler's report (registers, spills) is kept beside each library
    as ``.log``. Raises RuntimeError with the compiler's output if any
    build fails."""
    jobs = []
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs.append((name, lib, tmp, proc))
    failed = []
    for name, lib, tmp, proc in jobs:
        log, _ = proc.communicate()
        lib.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))


def function(name: str, symbol: str, argtypes: Tuple) -> ctypes._CFuncPtr:
    """The C entry ``symbol`` of kernel library ``name``, built if needed,
    with its argument types set and an int (cudaError_t) result. Looked up
    once: every launch goes through here."""
    fn = _entries.get((name, symbol))
    if fn is None:
        if name not in _loaded:
            build((name,))
            _loaded[name] = ctypes.CDLL(str(library_path(name)))
        fn = getattr(_loaded[name], symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _entries[(name, symbol)] = fn
    return fn
