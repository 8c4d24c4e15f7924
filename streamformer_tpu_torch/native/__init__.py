"""MSDeformAttn's CPU oracle: ``msdeform.cpp``, built with g++ at first use
and loaded with ctypes.

Port of the JAX package's ``native/``, the reference's native MSDeformAttn
surface on the host: an OpenMP-parallel C++ forward and backward with
``grid_sample``'s semantics (bilinear, zero padding, ``align_corners=False``),
an independent second oracle beside the plain PyTorch version in
``ops/msdeform_attn.py``. On the card the op runs kernel M
(``csrc/msdeform_attn.cu``) instead.

The library is ``build/libmsdeform-<digest>.so`` at the root of the
checkout; the digest covers the source and the flags, so an edited source is
rebuilt and a stale library never loaded. A failed build raises; nothing
falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

from streamformer_tpu_torch.ops.build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "msdeform.cpp"
FLAGS = ("-O3", "-shared", "-fPIC", "-fopenmp", "-std=c++17")

_lib: Optional[ctypes.CDLL] = None
_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"libmsdeform-{digest.hexdigest()[:16]}.so"


def build() -> str:
    """Compile the library if it is missing; returns its path. Raises
    RuntimeError with the compiler's output when there is no g++ or the
    build fails."""
    lib = library_path()
    if lib.exists():
        return str(lib)
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found on PATH: the CPU oracle is built from {SOURCE}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *FLAGS, str(SOURCE), "-o", str(tmp)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"msdeform.cpp build failed (g++ exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return str(lib)


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        ints = [ctypes.c_int] * 7
        lib.ms_deform_attn_forward.argtypes = [_F32P, _I32P, _F32P, _F32P, _F32P] + ints
        lib.ms_deform_attn_forward.restype = None
        lib.ms_deform_attn_backward.argtypes = [_F32P, _I32P] + [_F32P] * 6 + ints
        lib.ms_deform_attn_backward.restype = None
        _lib = lib
    return _lib


def _inputs(value, shapes, loc, weight):
    """C-contiguous float32 (int32 shapes) copies, their sizes checked
    against each other: the C code trusts them."""
    value = np.ascontiguousarray(value, np.float32)
    shapes = np.ascontiguousarray(shapes, np.int32).reshape(-1, 2)
    loc = np.ascontiguousarray(loc, np.float32)
    weight = np.ascontiguousarray(weight, np.float32)
    if value.ndim != 4 or loc.ndim != 6 or loc.shape[-1] != 2:
        raise ValueError(f"value {value.shape} must be (B, S, M, D), loc {loc.shape} "
                         "(B, Q, M, L, P, 2)")
    b, s, m, _ = value.shape
    if (loc.shape[0], loc.shape[2], loc.shape[3]) != (b, m, len(shapes)):
        raise ValueError(f"loc {loc.shape} does not match value {value.shape} and "
                         f"{len(shapes)} levels")
    if weight.shape != loc.shape[:-1]:
        raise ValueError(f"weight {weight.shape} must be loc's {loc.shape[:-1]}")
    if int(np.prod(shapes, axis=1, dtype=np.int64).sum()) != s:
        raise ValueError(f"the levels {shapes.tolist()} hold {int(np.prod(shapes, 1).sum())} "
                         f"positions, value {s}")
    return value, shapes, loc, weight


def _ptr(a: np.ndarray, ty):
    return a.ctypes.data_as(ty)


def ms_deform_attn_forward_np(value, shapes, loc, weight):
    """(B, Q, M * D) float32: the MSDeformAttn core through the native
    forward. value (B, S, M, D), shapes (L, 2) of (H, W), loc (B, Q, M, L,
    P, 2) normalized (x, y), weight (B, Q, M, L, P)."""
    value, shapes, loc, weight = _inputs(value, shapes, loc, weight)
    b, s, m, d = value.shape
    _, q, _, nl, p, _ = loc.shape
    out = np.empty((b, q, m * d), np.float32)
    load().ms_deform_attn_forward(_ptr(value, _F32P), _ptr(shapes, _I32P), _ptr(loc, _F32P),
                                  _ptr(weight, _F32P), _ptr(out, _F32P), b, s, m, d, q, nl, p)
    return out


def ms_deform_attn_backward_np(value, shapes, loc, weight, grad_out):
    """(grad_value, grad_loc, grad_weight), float32 in the shapes of value,
    loc and weight, for the forward's output gradient grad_out (B, Q, M * D)."""
    value, shapes, loc, weight = _inputs(value, shapes, loc, weight)
    b, s, m, d = value.shape
    _, q, _, nl, p, _ = loc.shape
    grad_out = np.ascontiguousarray(grad_out, np.float32)
    if grad_out.shape != (b, q, m * d):
        raise ValueError(f"grad_out {grad_out.shape} must be {(b, q, m * d)}")
    gv, gl, gw = np.empty_like(value), np.empty_like(loc), np.empty_like(weight)
    load().ms_deform_attn_backward(_ptr(value, _F32P), _ptr(shapes, _I32P), _ptr(loc, _F32P),
                                   _ptr(weight, _F32P), _ptr(grad_out, _F32P), _ptr(gv, _F32P),
                                   _ptr(gl, _F32P), _ptr(gw, _F32P), b, s, m, d, q, nl, p)
    return gv, gl, gw
