"""The attention kernels of the encoder's main path, each with its plain
PyTorch version and a launch count.

==================================  ========================================  ========================================
wrapper                             plain version                             replaces (JAX package)
==================================  ========================================  ========================================
``temporal_decode_pm``              ``temporal_decode_pm_plain``              ``fused_temporal_decode_pm``
``temporal_decode_rm``              ``temporal_decode_rm_plain``              ``fused_temporal_decode_inplace``
``temporal_decode_rm_readonly``     ``temporal_decode_rm_readonly_plain``     ``fused_temporal_decode``
``temporal_decode_pm_ragged``       ``temporal_decode_pm_ragged_plain``       ``fused_temporal_decode_pm_ragged``
``temporal_append_pm_ragged``       ``temporal_append_pm_ragged_plain``       ``fused_temporal_append_pm_ragged``
``temporal_decode_pm_int8``         ``temporal_decode_pm_int8_plain``         ``fused_temporal_decode_pm_int8``
``temporal_decode_pm_int8_ragged``  ``temporal_decode_pm_int8_ragged_plain``  ``fused_temporal_decode_pm_int8_ragged``
``spatial_flat``                    ``spatial_flat_plain``                    ``fused_spatial_flat`` (fwd)
``temporal_fullclip``               ``temporal_fullclip_plain``               ``fused_temporal_fullclip`` (fwd)
``spatial_flat_bwd``                ``spatial_flat_bwd_plain``                ``_spatial_flat_bwd_pallas``
``temporal_fullclip_bwd``           ``temporal_fullclip_bwd_plain``           ``_fullclip_temporal_bwd_pallas``
``temporal_fullclip_qkv``           ``temporal_fullclip_qkv_plain``           ``fused_temporal_fullclip`` (packed)
``temporal_fullclip_qkv_bwd``       ``temporal_fullclip_qkv_bwd_plain``       ``_fullclip_temporal_bwd_pallas`` (packed)
``temporal_append_pm_qkv``          ``temporal_append_pm_qkv_plain``          ``fused_temporal_append_pm_ragged`` (packed)
``spatial_attention``               ``spatial_attention_plain``               ``fused_spatial_attention``
==================================  ========================================  ========================================

A wrapper takes its plain version for tensors on the CPU, and only then. For
CUDA tensors it launches its kernel from ``csrc/`` on the current stream or
raises: there is no fallback. Each launch adds one to ``LAUNCHES[name]``;
nothing else does. Heads are dh-wide slices of the flat D axis
(``spatial_attention`` takes them split, (R, H, N, dh)), dh a multiple of 8
and at most 128; inputs are float32 or bfloat16 and contiguous (the int8
kernels take int8 codes and fp32 scales beside a float or bfloat16 query;
A, D, J and E take a float cache in another dtype than the query's).
C, H and E read their operands in place through strides: the packed entries
``temporal_fullclip_qkv``, ``temporal_fullclip_qkv_bwd`` and
``temporal_append_pm_qkv`` take the (B, T, N, 3D) output of the qkv
projection as it is (the encoder's full clip, and its multi-frame append on
the linear cache), the (R, T, D) and (t, R, D) entries rows; each counts
under its kernel's (R, T, D) or (t, R, D) entry's name.

The two full-clip kernels have a gradient: ``spatial_flat``,
``temporal_fullclip`` and ``temporal_fullclip_qkv`` go through the
``torch.autograd.Function``s ``SpatialFlat``, ``TemporalFullclip`` and
``TemporalFullclipQKV`` whenever an input requires grad, on the CPU as on
the card. The forward saves q, k, v (or qkv) only; the backward
recomputes the probabilities in ``spatial_flat_bwd`` / ``temporal_fullclip_bwd``
(a kernel on the card, the plain backward on the CPU). ``spatial_attention``
goes through ``SpatialAttention``, whose backward is autograd of its plain
version, as the JAX package's is the einsum VJP. The streaming kernels have
no backward, as in the JAX package, and raise when asked for one.

Each forward entry is also a ``torch.library`` op, ``streamformer::<name>``
(``OPS``), so that ``torch.export`` can trace a program through it: the op
has a fake (shape) implementation, names the caches it writes in place in
its schema, and its CPU and CUDA implementation is the entry itself, which
takes the plain version for CPU tensors and launches the kernel for CUDA
ones, counting the launch. An entry calls its op only while it is traced
(``torch.compiler.is_compiling()``, which holds under ``torch.export``);
eager calls go straight to the entry's body, so the streaming step pays no
dispatcher cost. Both paths run the same kernel.
"""

from __future__ import annotations

import ctypes
import functools
import re
from typing import Callable, Dict

import torch

from streamformer_tpu_torch.ops import build

LAUNCHES: Dict[str, int] = {
    "temporal_decode_pm": 0,
    "temporal_decode_rm": 0,
    "temporal_decode_rm_readonly": 0,
    "temporal_decode_pm_ragged": 0,
    "temporal_append_pm_ragged": 0,
    "temporal_decode_pm_int8": 0,
    "temporal_decode_pm_int8_ragged": 0,
    "spatial_flat": 0,
    "temporal_fullclip": 0,
    "spatial_flat_bwd": 0,
    "temporal_fullclip_bwd": 0,
    "spatial_attention": 0,
    # kernel M, MSDeformAttn's forward and backward (ops/msdeform_attn.py)
    "ms_deform_attn": 0,
    "ms_deform_attn_bwd": 0,
}

# New frames kernel E's whole-table body takes at most (C's kMaxT), on any
# capacity whose plan fits a block's shared memory (``append_frame_cap``);
# past either a call runs the tiled body.
APPEND_MAX_FRAMES = 32

# Queries a block of the bf16 spatial kernels (B, L) takes: thirteen warps
# of 16, a whole row of the flagship (N=196), so K and V are staged once per
# (row, head). A query's bits do not depend on it.
_TC_ROWS = 208

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SMEM = 232448  # dynamic shared memory a block may use on sm_90
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(name: str, num_heads: int, d: int, strided: bool = False,
           **tensors: torch.Tensor) -> torch.device:
    """Validate what every kernel requires; returns the common device.
    Inputs are contiguous, or with ``strided`` (C and H, which bulk-copy
    16-byte spans) have a contiguous last axis and 16-byte aligned data and
    strides."""
    first = next(iter(tensors.values()))
    for key, t in tensors.items():
        if t.device != first.device:
            raise ValueError(f"{name}: {key} is on {t.device}, not {first.device}")
        if t.dtype not in _DTYPE_CODES or t.dtype != first.dtype:
            raise TypeError(
                f"{name}: {key} is {t.dtype}; all inputs must share one dtype, "
                "float32 or bfloat16"
            )
        if strided:
            if (t.stride(-1) != 1 or t.data_ptr() % 16
                    or any(s * t.element_size() % 16 for s in t.stride()[:-1])):
                raise ValueError(
                    f"{name}: {key} (strides {t.stride()}) needs a contiguous last axis and "
                    "16-byte aligned data and strides"
                )
        elif not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    if num_heads <= 0 or d % num_heads:
        raise ValueError(f"{name}: D={d} is not a multiple of num_heads={num_heads}")
    dh = d // num_heads
    if dh % 8 or dh > 128:
        raise ValueError(f"{name}: head dim {dh} must be a multiple of 8 and <= 128")
    if first.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {first.device}")
    return first.device


def _check_decode(name: str, num_heads: int, d: int, q, k_new, v_new, k_cache,
                  v_cache) -> torch.device:
    """``_check`` for A, D and J: q in the compute dtype, k_new, v_new and
    the caches in the cache's (float32 or bfloat16 either way)."""
    device = _check(name, num_heads, d, q=q)
    if _check(name, num_heads, d, k_new=k_new, v_new=v_new, k_cache=k_cache,
              v_cache=v_cache) != device:
        raise ValueError(f"{name}: the caches are on {k_cache.device}, not {device}")
    return device


def _cuda_ready(name: str, *tensors: torch.Tensor) -> None:
    """What a launch needs beyond ``_check``: aligned pointers, and no
    autograd graph to record into (the full-clip wrappers reach this under
    their ``autograd.Function``, where grad mode is off)."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensor data must be 16-byte aligned")
        if t.requires_grad and torch.is_grad_enabled():
            raise NotImplementedError(
                f"{name}: the streaming kernels have no backward, as in the JAX "
                "package; train through the full-clip path (model_forward)"
            )


def _wants_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _round16(x: int) -> int:
    return (x + 15) // 16 * 16


def _append_min_smem(t: int, capacity: int, head_dim: int, itemsize: int,
                     q_itemsize: int = 0) -> int:
    """Shared memory of kernel E's smallest whole-table plan
    (csrc/temporal_append_pm.cu, ``plan_for(1, 1, ...)``): one head an item,
    one key a stage, keys of ``itemsize`` bytes, queries of ``q_itemsize``
    (default the same). The whole-table body takes a call when this fits;
    it then takes the largest plan that fits."""
    row = _round16(head_dim * itemsize) + 16  # a staged span, padded
    q_row = _round16(head_dim * (q_itemsize or itemsize)) + 16
    keys = capacity + t
    return (2 * row + 16 + t * q_row + _round16(4 * t * (keys | 1))
            + (_round16(4 * t * head_dim) if keys > 1 else 0) + _round16(4 * t) + 48)


def append_frame_cap(capacity: int) -> int:
    """Most new frames kernel E's whole-table body takes in one call on a
    cache of ``capacity`` slots, at every width the kernels take (the plan
    of the widest, heads of 128 in fp32): at most ``APPEND_MAX_FRAMES``, as
    many as the plan fits in a block's shared memory; 0 when not even one
    does. A call of more frames runs E's tiled bodies (csrc/tiled.cuh),
    which take any t and any capacity at the same bits but cost more a
    frame than the whole-table body where both run (PERF.md's kernel
    table): the serving engine and the vision tower chunk their appends by
    this."""
    for t in range(APPEND_MAX_FRAMES, 0, -1):
        if _append_min_smem(t, capacity, 128, 4) <= _MAX_SMEM:
            return t
    return 0


def _via_op() -> bool:
    """Whether an entry calls its ``torch.library`` op: while a program is
    traced (``torch.export``, ``torch.compile``), whose fake tensors have no
    data for the checks and launches of the entry's body."""
    return torch.compiler.is_compiling()


OPS: Dict[str, object] = {}  # name -> the registered op (torch.library.custom_op)


def _entry(name: str, schema: str, fake: Callable):
    """Register the decorated function as the op ``streamformer::<name>``
    with ``schema`` (its written arguments marked ``Tensor(a!)``) and the
    shape function ``fake``; return the entry that calls the op while
    traced and the function itself otherwise."""

    def wrap(fn):
        mutated = tuple(re.findall(r"Tensor\([a-z]!\) (\w+)", schema))
        op = torch.library.custom_op(f"streamformer::{name}", fn, mutates_args=mutated,
                                     device_types=("cpu", "cuda"), schema=schema)
        op.register_fake(fake)
        OPS[name] = op

        @functools.wraps(fn)
        def entry(*args, **kwargs):
            if _via_op():
                return op(*args, **kwargs)
            return fn(*args, **kwargs)

        return entry

    return wrap


def _like(x: torch.Tensor, *args, **kwargs) -> torch.Tensor:
    """The fake output of an op whose output has its first input's shape."""
    return x.new_empty(x.shape)


def _packed_out(qkv: torch.Tensor, *args, **kwargs) -> torch.Tensor:
    """The fake output of a packed entry: (B, T, N, D) of a (B, T, N, 3D) qkv."""
    b, t, n, d3 = qkv.shape
    return qkv.new_empty(b, t, n, d3 // 3)


def _launch(name: str, symbol: str, argtypes, device: torch.device, *args,
            library: str = "") -> None:
    """Launch C entry ``symbol`` of library ``library`` (default: ``name``)
    on the current stream; count it under ``name``."""
    fn = build.function(library or name, symbol, argtypes)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")
    LAUNCHES[name] += 1


# ---------------------------------------------------------------------------
# A. t=1 streaming decode on the pos-major cache, with in-place append
# ---------------------------------------------------------------------------


def temporal_decode_pm_plain(q, k_new, v_new, k_cache, v_cache, cache_len, num_heads):
    """Plain version of ``temporal_decode_pm``: the same function, same
    in-place cache update."""
    return temporal_decode_pm_ragged_plain(
        q, k_new, v_new, k_cache, v_cache, cache_len.reshape(1), q.shape[0], num_heads
    )


@_entry("temporal_decode_pm",
        "(Tensor q, Tensor k_new, Tensor v_new, Tensor(a!) k_cache, Tensor(b!) v_cache, "
        "Tensor cache_len, int num_heads) -> Tensor", _like)
def temporal_decode_pm(q, k_new, v_new, k_cache, v_cache, cache_len, num_heads):
    """t=1 causal attention of the new frame against the pos-major cache.

    q, k_new, v_new: (R, D), rows are (b, n) pairs. k_cache, v_cache:
    (C, R, D); positions < cache_len hold earlier frames (slot = position
    mod C). cache_len: int32 tensor of one element on the same device, the
    position the new frame takes; it is read on the device and not changed.

    The new frame attends itself and old slots c < min(len, C) except slot
    len % C, which it then overwrites in place (``k_cache[len % C] =
    k_new``, the same for v). With len < C this is the linear cache; past C
    the same call is the ring's sliding window over the last C frames.
    k_new, v_new and the caches share one dtype, float32 or bfloat16, which
    may differ from q's (a mixed cache: the caller rounds the new frame to
    the cache's dtype, as the JAX package does); the arithmetic is fp32.
    Returns the attention output (R, D) in q's dtype. The kernel takes the
    keys in position order with ``temporal_fullclip``'s arithmetic, so on
    the card a linear stream reproduces the full clip bit for bit.
    """
    r, d = q.shape
    if k_cache.ndim != 3 or k_cache.shape[1:] != (r, d) or v_cache.shape != k_cache.shape:
        raise ValueError(
            f"temporal_decode_pm: caches {tuple(k_cache.shape)}, {tuple(v_cache.shape)} "
            f"do not match q {tuple(q.shape)} as (C, R, D)"
        )
    if k_new.shape != q.shape or v_new.shape != q.shape:
        raise ValueError("temporal_decode_pm: k_new and v_new must have q's shape (R, D)")
    if cache_len.numel() != 1 or cache_len.dtype != torch.int32:
        raise TypeError("temporal_decode_pm: cache_len must be one int32 element")
    device = _check_decode("temporal_decode_pm", num_heads, d, q, k_new, v_new, k_cache, v_cache)
    _check_lengths("temporal_decode_pm", device, cache_len=cache_len)
    if device.type == "cpu":
        return temporal_decode_pm_plain(q, k_new, v_new, k_cache, v_cache, cache_len, num_heads)
    scratch = _decode_ready("temporal_decode_pm", q, k_new, v_new, k_cache, v_cache, num_heads,
                            k_cache.shape[0])
    out = torch.empty_like(q)
    _launch(
        "temporal_decode_pm", "sf_temporal_decode_pm",
        (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P, _L, _I, _I, _P), device,
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), cache_len.data_ptr(), out.data_ptr(),
        r, k_cache.shape[0], d, num_heads, (d // num_heads) ** -0.5, *_scratch_args(scratch),
        _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_cache.dtype],
    )
    return out


def _check_lengths(name: str, device: torch.device, **lengths: torch.Tensor) -> None:
    for key, t in lengths.items():
        if t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, not {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def decode_fits(d: int, num_heads: int, capacity: int, dtype: torch.dtype,
                kv_dtype: torch.dtype, device: torch.device) -> bool:
    """Whether A's, D's and J's (heads, C) scores for a cache of
    ``capacity`` slots fit a block's shared memory at this width on
    ``device`` (up to about C = 3,800 at the flagship). The kernels take any
    capacity (past it their scores go to a scratch, ``_decode_scratch``);
    past it the encoder runs A's and D's new frame through kernel E
    (``temporal_append_pm_qkv`` at t = 1) instead, and J stays."""
    if device.type != "cuda":
        return True
    return _body_smem("temporal_decode_pm", "sf_temporal_decode_pm", d, num_heads, capacity,
                      _DTYPE_CODES[dtype], _DTYPE_CODES[kv_dtype]) <= _MAX_SMEM


def _decode_ready(name, q, k_new, v_new, k_cache, v_cache, num_heads, capacity):
    """What a launch of A, D or J needs: aligned pointers; returns the
    scores' scratch for the capacity (``_decode_scratch``), or None."""
    _cuda_ready(name, q, k_new, v_new, k_cache, v_cache)
    return _decode_scratch("temporal_decode_pm", "sf_temporal_decode_pm",
                           (q.shape[-1], num_heads, capacity, _DTYPE_CODES[q.dtype],
                            _DTYPE_CODES[k_cache.dtype]), q.shape[0], q.device)


def _decode_scratch(library: str, symbol: str, shape, rows: int, device):
    """The body of the t=1 decode kernels (A, D, J, F, G, K: csrc/decode_row.cuh)
    keeps a row's (heads, C) fp32 scores in shared memory while its plan
    (``_body_smem`` of ``symbol`` at ``shape``: d, heads, C, then the dtype
    codes) fits a block: then None. Past it, the fp32 scratch of its scratch
    mode (the same bits): a slice of heads x score_stride(C) floats (C + 1
    rounded up to 4) for each block of its persistent grid over ``rows``
    rows (``_decode_blocks``), as many as fit ``_TILED_SCRATCH``; the launch
    cuts its grid to the slices. Patching ``_body_smem`` above ``_MAX_SMEM``
    forces the scratch mode."""
    if _body_smem(library, symbol, *shape) <= _MAX_SMEM:
        return None
    per_block = shape[1] * ((shape[2] + 4) // 4 * 4)
    blocks = min(_decode_blocks(library, symbol, device.index, *shape, rows),
                 _TILED_SCRATCH // 4 // per_block)
    return torch.empty(max(1, blocks) * per_block, dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=None)
def _decode_blocks(library: str, symbol: str, device_index, *shape: int) -> int:
    """Blocks of a decode body's persistent grid in its scratch mode, from
    the C entry ``{symbol}_scratch_blocks`` (the occupancy of its kernel at
    that plan, at most one a row)."""
    with torch.cuda.device(device_index):
        blocks = build.function(library, f"{symbol}_scratch_blocks", (_I,) * len(shape))(*shape)
    if blocks < 1:
        raise RuntimeError(f"{symbol}: no persistent grid for its scratch mode (CUDA error "
                           f"{-blocks})")
    return blocks


def _stream_lengths(name: str, lens: torch.Tensor, rows: int, rows_per_stream: int,
                    **more: torch.Tensor) -> None:
    """``lens`` (and any ``more``) must be (B,) int32 with B * rows_per_stream
    == rows."""
    if rows_per_stream <= 0 or rows % rows_per_stream:
        raise ValueError(f"{name}: {rows} rows are not a multiple of "
                         f"rows_per_stream={rows_per_stream}")
    b = rows // rows_per_stream
    for key, t in dict(lens=lens, **more).items():
        if t.dtype != torch.int32 or t.shape != (b,):
            raise TypeError(f"{name}: {key} must be int32 of shape ({b},), one per stream; "
                            f"got {t.dtype} {tuple(t.shape)}")


# ---------------------------------------------------------------------------
# J and K. t=1 decode on the row-major cache: in place, and read-only
# ---------------------------------------------------------------------------


def temporal_decode_rm_plain(q, k_new, v_new, k_cache, v_cache, cache_len, num_heads):
    """Plain version of ``temporal_decode_rm``: A's plain version on the
    (C, R, D) view of the row-major cache; the same in-place write."""
    return temporal_decode_pm_plain(q, k_new, v_new, k_cache.transpose(0, 1),
                                    v_cache.transpose(0, 1), cache_len, num_heads)


@_entry("temporal_decode_rm",
        "(Tensor q, Tensor k_new, Tensor v_new, Tensor(a!) k_cache, Tensor(b!) v_cache, "
        "Tensor cache_len, int num_heads) -> Tensor", _like)
def temporal_decode_rm(q, k_new, v_new, k_cache, v_cache, cache_len, num_heads):
    """t=1 causal attention of the new frame against the row-major cache,
    with its K/V written in place.

    q, k_new, v_new: (R, D), rows are (b, n) pairs. k_cache, v_cache:
    (R, C, D); positions < cache_len hold earlier frames. cache_len: int32
    tensor of one element on the same device, the position the new frame
    takes; it is read on the device and not changed. As kernel A: on a
    linear cache (cache_len < C) the new frame attends positions
    < cache_len and itself; past C (the ring) it attends the C - 1 newest
    earlier frames and itself; then ``k_cache[:, cache_len % C] = k_new``
    (the same for v). A mixed cache as for A. Returns (R, D) in q's dtype.
    The kernel
    is A's on row-major strides, the same order of arithmetic, so on the
    card a row-major stream equals the pos-major one bit for bit."""
    r, d = q.shape
    if k_cache.ndim != 3 or (k_cache.shape[0], k_cache.shape[2]) != (r, d) \
            or v_cache.shape != k_cache.shape:
        raise ValueError(
            f"temporal_decode_rm: caches {tuple(k_cache.shape)}, {tuple(v_cache.shape)} "
            f"do not match q {tuple(q.shape)} as (R, C, D)"
        )
    if k_new.shape != q.shape or v_new.shape != q.shape:
        raise ValueError("temporal_decode_rm: k_new and v_new must have q's shape (R, D)")
    if cache_len.numel() != 1 or cache_len.dtype != torch.int32:
        raise TypeError("temporal_decode_rm: cache_len must be one int32 element")
    device = _check_decode("temporal_decode_rm", num_heads, d, q, k_new, v_new, k_cache, v_cache)
    _check_lengths("temporal_decode_rm", device, cache_len=cache_len)
    if device.type == "cpu":
        return temporal_decode_rm_plain(q, k_new, v_new, k_cache, v_cache, cache_len, num_heads)
    scratch = _decode_ready("temporal_decode_rm", q, k_new, v_new, k_cache, v_cache, num_heads,
                            k_cache.shape[1])
    out = torch.empty_like(q)
    _launch(
        "temporal_decode_rm", "sf_temporal_decode_rm",
        (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P, _L, _I, _I, _P), device,
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), cache_len.data_ptr(), out.data_ptr(),
        r, k_cache.shape[1], d, num_heads, (d // num_heads) ** -0.5, *_scratch_args(scratch),
        _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_cache.dtype], library="temporal_decode_pm",
    )
    return out


def temporal_decode_rm_readonly_plain(q, k, v, k_scale, v_scale, cache_len, num_heads):
    """Plain version of ``temporal_decode_rm_readonly``: fp32 throughout,
    the int8 scales folded after the reductions as the kernel folds them."""
    r, c, d = k.shape
    h = num_heads
    dh = d // h
    qf = q.float().view(r, h, dh)
    s = torch.einsum("rhd,rchd->rhc", qf, k.float().view(r, c, h, dh)) * dh**-0.5
    if k_scale is not None:
        s = s * k_scale.permute(0, 2, 1)
    valid = torch.arange(c, device=q.device) <= cache_len.reshape(())
    p = torch.softmax(s.masked_fill(~valid, float("-inf")), dim=-1)  # (R, H, C)
    if v_scale is not None:
        p = p * v_scale.permute(0, 2, 1)
    return torch.einsum("rhc,rchd->rhd", p, v.float().view(r, c, h, dh)).reshape(r, d).to(q.dtype)


@_entry("temporal_decode_rm_readonly",
        "(Tensor q, Tensor k, Tensor v, Tensor? k_scale, Tensor? v_scale, "
        "Tensor cache_len, int num_heads) -> Tensor", _like)
def temporal_decode_rm_readonly(q, k, v, k_scale, v_scale, cache_len, num_heads):
    """Read-only t=1 decode against the row-major cache, float or int8.

    q: (R, D) float32 or bfloat16. k, v: (R, C, D), already holding the new
    frame at position cache_len (the caller wrote it): either in q's dtype
    with ``k_scale`` and ``v_scale`` None, or int8 codes with fp32 scales of
    shape (R, C, H), one per (row, position, head) (``encoder.
    quantize_kv_heads``). cache_len: int32 tensor of one element on the same
    device, read on the device. Each (row, head) attends positions
    0..min(cache_len, C-1), with score ``(q . codes) * dh**-0.5 * k_scale``
    and value weight ``p * v_scale`` in fp32; nothing is written. Returns
    (R, D) in q's dtype."""
    name = "temporal_decode_rm_readonly"
    if q.ndim != 2 or k.ndim != 3 or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[1] \
            or v.shape != k.shape:
        raise ValueError(f"{name}: k {tuple(k.shape)}, v {tuple(v.shape)} do not match q "
                         f"{tuple(q.shape)} as (R, C, D)")
    if cache_len.numel() != 1 or cache_len.dtype != torch.int32:
        raise TypeError(f"{name}: cache_len must be one int32 element")
    r, c, d = k.shape
    device = _check(name, num_heads, d, q=q)
    quantized = k_scale is not None
    if quantized != (v_scale is not None):
        raise ValueError(f"{name}: give both scales or neither")
    want = torch.int8 if quantized else q.dtype
    for key, t in (("k", k), ("v", v)):
        if t.dtype != want:
            raise TypeError(f"{name}: {key} is {t.dtype}, not {want}"
                            + ("" if quantized else " (a float cache in q's dtype)"))
    tensors = dict(k=k, v=v)
    if quantized:
        tensors.update(k_scale=k_scale, v_scale=v_scale)
        for key in ("k_scale", "v_scale"):
            t = tensors[key]
            if t.dtype != torch.float32 or tuple(t.shape) != (r, c, num_heads):
                raise TypeError(f"{name}: {key} must be fp32 of shape {(r, c, num_heads)}, got "
                                f"{t.dtype} {tuple(t.shape)}")
    for key, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, not {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    _check_lengths(name, device, cache_len=cache_len)
    if device.type == "cpu":
        return temporal_decode_rm_readonly_plain(q, k, v, k_scale, v_scale, cache_len, num_heads)
    _cuda_ready(name, q, *tensors.values())
    scratch = _decode_scratch("temporal_decode_rm", "sf_temporal_decode_rm_readonly",
                              (d, num_heads, c, _DTYPE_CODES[q.dtype], int(quantized)), r, device)
    out = torch.empty_like(q)
    _launch(
        name, "sf_temporal_decode_rm_readonly",
        (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P, _L, _I, _I, _P), device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr() if quantized else None, v_scale.data_ptr() if quantized else None,
        cache_len.data_ptr(), out.data_ptr(), r, c, d, num_heads, (d // num_heads) ** -0.5,
        *_scratch_args(scratch), _DTYPE_CODES[q.dtype], int(quantized),
        library="temporal_decode_rm",
    )
    return out


# ---------------------------------------------------------------------------
# D. A with per-stream lengths: continuous batching
# ---------------------------------------------------------------------------


def temporal_decode_pm_ragged_plain(q, k_new, v_new, k_cache, v_cache, lens, rows_per_stream,
                                    num_heads):
    """Plain version of ``temporal_decode_pm_ragged`` (and of A, one stream,
    and of J on the transposed view of its cache): the same function, same
    in-place cache update."""
    c, r, d = k_cache.shape
    h = num_heads
    dh = d // h
    scale = dh**-0.5
    qf = q.float().view(r, h, dh)
    length = lens.long().repeat_interleave(rows_per_stream)  # (R,)
    slot = length % c
    s_new = (qf * k_new.float().view(r, h, dh)).sum(-1, keepdim=True) * scale
    s_old = torch.einsum("rhd,crhd->rhc", qf, k_cache.float().reshape(c, r, h, dh)) * scale
    pos = torch.arange(c, device=q.device)
    valid = (pos[None] < length[:, None]) & (pos[None] != slot[:, None])  # (R, C)
    s_old = s_old.masked_fill(~valid[:, None, :], float("-inf"))
    probs = torch.softmax(torch.cat([s_new, s_old], dim=-1), dim=-1)
    vals = torch.cat(
        [v_new.float().view(r, h, 1, dh),
         v_cache.float().reshape(c, r, h, dh).permute(1, 2, 0, 3)],
        dim=2,
    )
    out = torch.einsum("rhc,rhcd->rhd", probs, vals).reshape(r, d).to(q.dtype)
    rows = torch.arange(r, device=q.device)
    k_cache[slot, rows] = k_new
    v_cache[slot, rows] = v_new
    return out


@_entry("temporal_decode_pm_ragged",
        "(Tensor q, Tensor k_new, Tensor v_new, Tensor(a!) k_cache, Tensor(b!) v_cache, "
        "Tensor lens, int rows_per_stream, int num_heads) -> Tensor", _like)
def temporal_decode_pm_ragged(q, k_new, v_new, k_cache, v_cache, lens, rows_per_stream,
                              num_heads):
    """``temporal_decode_pm`` for a batch of streams, each at its own position.

    q, k_new, v_new: (R, D); k_cache, v_cache: (C, R, D); row r belongs to
    stream ``r // rows_per_stream``. lens: (B,) int32 on the same device,
    B * rows_per_stream == R, the position each stream's new frame takes; it
    is read on the device and not changed. Each stream attends, appends at
    slot ``lens[b] % C`` and excludes that slot, as A does for one length, so
    the call serves the linear cache and the ring; a mixed cache as for A.
    Rows are not padded per
    stream. A ragged row's output equals, bit for bit on the card, A's for a
    lone stream at the same position (one kernel source)."""
    r, d = q.shape
    if k_cache.ndim != 3 or k_cache.shape[1:] != (r, d) or v_cache.shape != k_cache.shape:
        raise ValueError(
            f"temporal_decode_pm_ragged: caches {tuple(k_cache.shape)}, "
            f"{tuple(v_cache.shape)} do not match q {tuple(q.shape)} as (C, R, D)"
        )
    if k_new.shape != q.shape or v_new.shape != q.shape:
        raise ValueError("temporal_decode_pm_ragged: k_new and v_new must have q's shape (R, D)")
    _stream_lengths("temporal_decode_pm_ragged", lens, r, rows_per_stream)
    device = _check_decode("temporal_decode_pm_ragged", num_heads, d, q, k_new, v_new, k_cache,
                           v_cache)
    _check_lengths("temporal_decode_pm_ragged", device, lens=lens)
    if device.type == "cpu":
        return temporal_decode_pm_ragged_plain(q, k_new, v_new, k_cache, v_cache, lens,
                                               rows_per_stream, num_heads)
    scratch = _decode_ready("temporal_decode_pm_ragged", q, k_new, v_new, k_cache, v_cache,
                            num_heads, k_cache.shape[0])
    out = torch.empty_like(q)
    _launch(
        "temporal_decode_pm_ragged", "sf_temporal_decode_pm_ragged",
        (_P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _F, _P, _L, _I, _I, _P), device,
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), lens.data_ptr(), rows_per_stream, out.data_ptr(),
        r, k_cache.shape[0], d, num_heads, (d // num_heads) ** -0.5, *_scratch_args(scratch),
        _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_cache.dtype], library="temporal_decode_pm",
    )
    return out


# ---------------------------------------------------------------------------
# E. t new frames per stream: multi-frame appends, the linear cache and the ring
# ---------------------------------------------------------------------------


def temporal_append_pm_ragged_plain(q, k_new, v_new, k_cache, v_cache, lens, valid,
                                    rows_per_stream, num_heads, causal=True, ring=False):
    """Plain version of ``temporal_append_pm_ragged``: the same function, same
    in-place cache update. fp32 throughout, output rounded to q's dtype."""
    t, r, d = q.shape
    c = k_cache.shape[0]
    h = num_heads
    dh = d // h
    length = lens.long().repeat_interleave(rows_per_stream)  # (R,)

    def heads(a):  # (n, R, D) -> (R, H, n, dh)
        return a.float().view(a.shape[0], r, h, dh).permute(1, 2, 0, 3)

    keys = torch.cat([heads(k_cache), heads(k_new)], dim=2)  # (R, H, C + t, dh)
    vals = torch.cat([heads(v_cache), heads(v_new)], dim=2)
    s = torch.matmul(heads(q), keys.transpose(-1, -2)) * dh**-0.5  # (R, H, t, C + t)
    ti = torch.arange(t, device=q.device)
    slot = torch.arange(c, device=q.device)
    if ring:  # the window of the C positions ending at len + t - 1, for every query
        kpos = slot + c * torch.div(length[:, None] - 1 - slot, c, rounding_mode="floor")
        old = (kpos >= 0) & (kpos > length[:, None] + t - 1 - c)  # (R, C)
        new = (ti > t - 1 - c).expand(t, t)
    else:
        old = slot < length[:, None]  # (R, C)
        new = ti[None, :] <= ti[:, None] if causal else torch.ones(t, t, dtype=torch.bool,
                                                                   device=q.device)
    mask = torch.cat([old[:, None].expand(r, t, c), new.expand(r, t, t)], dim=-1)  # (R, t, C + t)
    p = torch.softmax(s.masked_fill(~mask[:, None], float("-inf")), dim=-1)
    out = torch.matmul(p, vals).permute(2, 0, 1, 3).reshape(t, r, d).to(q.dtype)
    if ring:  # the last min(t, C) frames, after every read
        keep = ti[t - min(t, c):]
        frame, row = keep.repeat_interleave(r), torch.arange(r, device=q.device).repeat(len(keep))
        where = (length[row] + frame) % c
    else:
        where = length[None, :] + ti[:, None]  # (t, R)
        n_valid = valid.long().repeat_interleave(rows_per_stream)
        frame, row = ((ti[:, None] < n_valid[None, :]) & (where < c)).nonzero(as_tuple=True)
        where = where[frame, row]
    k_cache[where, row] = k_new[frame, row]
    v_cache[where, row] = v_new[frame, row]
    return out


def _append_checks(name, t, r, d, k_cache, v_cache, lens, valid, rows_per_stream, kv_dtype,
                   device, causal, ring) -> None:
    """What kernel E requires beyond its new frames' layout: (C, R, D)
    caches of the new frames' dtype, contiguous, on their device; (B,)
    int32 lens and valid; t >= 1; a ring append not causal past one frame.
    Raises on anything else, on the CPU as on the card."""
    if k_cache.ndim != 3 or k_cache.shape[1:] != (r, d) or v_cache.shape != k_cache.shape:
        raise ValueError(f"{name}: caches {tuple(k_cache.shape)}, {tuple(v_cache.shape)} do not "
                         f"match {r} rows of D={d} as (C, R, D)")
    for key, x in (("k_cache", k_cache), ("v_cache", v_cache)):
        if x.dtype != kv_dtype or x.device != device or not x.is_contiguous():
            raise ValueError(f"{name}: {key} must be a contiguous {kv_dtype} tensor on {device} "
                             f"(the new frames' k and v rounded to the cache's dtype), got "
                             f"{x.dtype} on {x.device}")
    _stream_lengths(name, lens, r, rows_per_stream, valid=valid)
    _check_lengths(name, device, lens=lens, valid=valid)
    if t < 1:
        raise NotImplementedError(f"{name}: {t} new frames; a call takes at least one")
    if ring and causal and t > 1:
        raise ValueError(f"{name}: the ring append is not causal past one frame (the encoder "
                         "runs a causal ring as one t=1 decode a frame)")


def _append_kernel(operands, k_cache, v_cache, lens, valid, rows_per_stream, batch, n, t, d,
                   num_heads, causal, ring, dtype) -> None:
    """Launch kernel E on q, k_new, v_new and out read and written in place,
    each a (tensor, column, (b, t, n) element strides) triple; q and out of
    ``dtype``. The whole-table body where its plan fits (``_body_smem``),
    else csrc/tiled.cuh's (``_tiled_plan``: split up to 4 new frames or past
    shared memory, else resident); count it under
    ``temporal_append_pm_ragged``."""
    code, kv_code = _DTYPE_CODES[dtype], _DTYPE_CODES[k_cache.dtype]
    cap = k_cache.shape[0]
    smem = _body_smem("temporal_append_pm", "sf_temporal_append_pm", t, cap, d, num_heads, code,
                      kv_code)
    tiled, scratch = (0, None) if smem else _tiled_launch(
        batch * n * num_heads, t, cap + t, d // num_heads, k_cache.element_size(), k_cache.device)
    ptrs = (_P * 4)(*(x.data_ptr() + col * x.element_size() for x, col, _ in operands))
    strides = (ctypes.c_longlong * 12)(*(s for _, _, st in operands for s in st))
    _launch(
        "temporal_append_pm_ragged", "sf_temporal_append_pm",
        (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _P, _L, _I, _I,
         _P),
        k_cache.device, ptrs, strides, k_cache.data_ptr(), v_cache.data_ptr(), lens.data_ptr(),
        valid.data_ptr(), rows_per_stream, batch, n, t, cap, d, num_heads,
        (d // num_heads) ** -0.5, int(causal), int(ring), tiled, *_scratch_args(scratch), code,
        kv_code,
        library="temporal_append_pm",
    )


@_entry("temporal_append_pm_ragged",
        "(Tensor q, Tensor k_new, Tensor v_new, Tensor(a!) k_cache, Tensor(b!) v_cache, "
        "Tensor lens, Tensor valid, int rows_per_stream, int num_heads, bool causal=True, "
        "bool ring=False) -> Tensor", _like)
def temporal_append_pm_ragged(q, k_new, v_new, k_cache, v_cache, lens, valid, rows_per_stream,
                              num_heads, causal=True, ring=False):
    """Append t new frames per stream to the pos-major cache and attend them
    in one call.

    q, k_new, v_new: (t, R, D), new frame ti of row r at [ti, r]. k_cache,
    v_cache: (C, R, D); row r belongs to stream ``r // rows_per_stream``.
    lens, valid: (B,) int32 on the same device, B * rows_per_stream == R.

    Linear cache (``ring`` False): stream b holds lens[b] positions in slots
    0..lens[b]-1 and appends its first valid[b] new frames at slots lens[b]
    + ti (a slot past C is dropped). Query ti of stream b attends cache
    slots < lens[b] and new frames 0..ti (``causal``), or all t new frames;
    outputs for ti >= valid[b] are unspecified. The caller keeps lens + valid
    <= C (the linear contract, checked by the serving engine on its host
    mirrors, never here, as that would wait on the device).

    Ring (``ring`` True, not causal past one frame): slot s holds the newest
    position p = s mod C below lens[b]; every query attends the C positions
    ending at lens[b] + t - 1 (old positions p > lens[b] + t - 1 - C, new
    frames j > t - 1 - C), and the last min(t, C) frames are then written at
    slots (lens[b] + j) % C; valid is not read. The JAX package's
    ``_ring_attend_pos_major`` with ``causal=False``; at t = 1 it is kernel
    A's ring step.

    lens and valid are read on the device and not changed. Any t and any
    capacity: up to ``APPEND_MAX_FRAMES`` frames where the whole-table plan
    fits (``append_frame_cap``), else the tiled body, with the same bits.
    k_new, v_new and the caches share one dtype, which may differ from q's
    (a mixed cache: the new frames rounded to the cache's dtype by the
    caller). q, k_new and v_new are read in place: their D axis contiguous,
    their data and other strides 16-byte aligned. Returns (t, R, D) in q's
    dtype. On the card a stream fed through this call in chunks reproduces
    the full clip bit for bit (``temporal_fullclip``'s arithmetic)."""
    name = "temporal_append_pm_ragged"
    if q.ndim != 3 or k_new.shape != q.shape or v_new.shape != q.shape:
        raise ValueError(f"{name}: q, k_new, v_new must share one (t, R, D) shape")
    t, r, d = q.shape
    device = _check(name, num_heads, d, strided=True, q=q)
    if _check(name, num_heads, d, strided=True, k_new=k_new, v_new=v_new) != device:
        raise ValueError(f"{name}: k_new is on {k_new.device}, not {device}")
    _append_checks(name, t, r, d, k_cache, v_cache, lens, valid, rows_per_stream, k_new.dtype,
                   device, causal, ring)
    if device.type == "cpu":
        return temporal_append_pm_ragged_plain(q, k_new, v_new, k_cache, v_cache, lens, valid,
                                               rows_per_stream, num_heads, causal, ring)
    _cuda_ready(name, q, k_new, v_new, k_cache, v_cache)
    out = q.new_empty(q.shape)
    # row r of (t, R, D) is (b, n) = (r, 0): strides (R axis, t axis, none)
    _append_kernel([(x, 0, (x.stride(1), x.stride(0), 0)) for x in (q, k_new, v_new, out)],
                   k_cache, v_cache, lens, valid, rows_per_stream, r, 1, t, d, num_heads, causal,
                   ring, q.dtype)
    return out


def temporal_append_pm_qkv_plain(qkv, k_cache, v_cache, lens, valid, rows_per_stream,
                                 num_heads, causal=True, ring=False, kv=None):
    """Plain version of ``temporal_append_pm_qkv``: the JAX encoder's slices
    and transposes of qkv (and kv) around ``temporal_append_pm_ragged_plain``."""
    b, t, n, d3 = qkv.shape
    d = d3 // 3
    parts = _thirds(qkv)
    if kv is not None:
        parts = (parts[0], kv[..., :d], kv[..., d:])
    rows = (x.transpose(0, 1).reshape(t, b * n, d) for x in parts)
    ctx = temporal_append_pm_ragged_plain(*rows, k_cache, v_cache, lens, valid, rows_per_stream,
                                          num_heads, causal, ring)
    return ctx.reshape(t, b, n, -1).transpose(0, 1).contiguous()


@_entry("temporal_append_pm_qkv",
        "(Tensor qkv, Tensor(a!) k_cache, Tensor(b!) v_cache, Tensor lens, Tensor valid, "
        "int rows_per_stream, int num_heads, bool causal=True, bool ring=False, "
        "Tensor? kv=None) -> Tensor", _packed_out)
def temporal_append_pm_qkv(qkv, k_cache, v_cache, lens, valid, rows_per_stream, num_heads,
                           causal=True, ring=False, kv=None):
    """``temporal_append_pm_ragged`` on the encoder's own layout.

    qkv: (B, t, N, 3D), the output of the qkv projection: q, k_new and v_new
    are its three D-wide slices, row b * N + n of the caches (C, B*N, D) is
    (b, n). lens, valid, rows_per_stream, ``causal`` and ``ring`` as for
    ``temporal_append_pm_ragged`` (lockstep: one stream of B*N rows; ragged:
    one stream per b, rows_per_stream = N). A cache in another dtype than
    qkv's takes ``kv``, (B, t, N, 2D): the new frames' k and v rounded to the
    cache's dtype, read in their place. Returns the contiguous (B, t, N, D)
    context in qkv's dtype, which the output projection takes as it is.
    Kernel E reads the slices and writes the context in place, so nothing is
    sliced, transposed or copied around it; it counts under
    ``temporal_append_pm_ragged``. The D axis must be contiguous, and the data
    and the other strides 16-byte aligned (the output of a linear layer is);
    there is no fallback to a copy."""
    name = "temporal_append_pm_qkv"
    device = _packed_check(name, qkv, num_heads)
    b, t, n, d3 = qkv.shape
    d = d3 // 3
    kv_dtype = qkv.dtype
    if kv is not None:
        if kv.shape != (b, t, n, 2 * d):
            raise ValueError(f"{name}: kv must be (B, t, N, 2D) = {(b, t, n, 2 * d)}, not "
                             f"{tuple(kv.shape)}")
        if _check(name, 2 * num_heads, 2 * d, strided=True, kv=kv) != device:
            raise ValueError(f"{name}: kv is on {kv.device}, not {device}")
        kv_dtype = kv.dtype
    _append_checks(name, t, b * n, d, k_cache, v_cache, lens, valid, rows_per_stream, kv_dtype,
                   device, causal, ring)
    if device.type == "cpu":
        return temporal_append_pm_qkv_plain(qkv, k_cache, v_cache, lens, valid, rows_per_stream,
                                            num_heads, causal, ring, kv)
    _cuda_ready(name, k_cache, v_cache, *(() if kv is None else (kv,)))
    out = qkv.new_empty(b, t, n, d)
    new = ((qkv, d), (qkv, 2 * d)) if kv is None else ((kv, 0), (kv, d))
    _append_kernel([(x, col, tuple(x.stride()[:3])) for x, col in ((qkv, 0), *new, (out, 0))],
                   k_cache, v_cache, lens, valid, rows_per_stream, b, n, t, d, num_heads, causal,
                   ring, qkv.dtype)
    return out


# ---------------------------------------------------------------------------
# F and G. t=1 decode on the int8 cache, one length or one per stream
# ---------------------------------------------------------------------------


def temporal_decode_pm_int8_ragged_plain(q, k_new, v_new, k_new_scale, v_new_scale, k_cache,
                                         v_cache, k_scale, v_scale, lens, rows_per_stream,
                                         num_heads):
    """Plain version of ``temporal_decode_pm_int8_ragged`` (and of F, one
    stream): the same function in fp32, same in-place writes of the codes
    and the scales."""
    c, r, d = k_cache.shape
    h = num_heads
    dh = d // h
    scale = dh**-0.5
    qf = q.float().view(r, h, dh)
    length = lens.long().repeat_interleave(rows_per_stream)  # (R,)
    slot = length % c
    s_new = (qf * k_new.float().view(r, h, dh)).sum(-1, keepdim=True) * k_new_scale[:, None, None]
    s_old = torch.einsum("rhd,crhd->rhc", qf, k_cache.float().view(c, r, h, dh))
    s_old = s_old * k_scale.t()[:, None, :]
    pos = torch.arange(c, device=q.device)
    valid = (pos[None] < length[:, None]) & (pos[None] != slot[:, None])  # (R, C)
    s_old = s_old.masked_fill(~valid[:, None, :], float("-inf"))
    probs = torch.softmax(torch.cat([s_new, s_old], dim=-1) * scale, dim=-1)  # (R, H, 1 + C)
    weights = probs * torch.cat([v_new_scale[:, None], v_scale.t()], dim=-1)[:, None, :]
    vals = torch.cat(
        [v_new.float().view(r, h, 1, dh), v_cache.float().view(c, r, h, dh).permute(1, 2, 0, 3)],
        dim=2,
    )
    out = torch.einsum("rhc,rhcd->rhd", weights, vals).reshape(r, d).to(q.dtype)
    rows = torch.arange(r, device=q.device)
    k_cache[slot, rows] = k_new
    v_cache[slot, rows] = v_new
    k_scale[slot, rows] = k_new_scale
    v_scale[slot, rows] = v_new_scale
    return out


def temporal_decode_pm_int8_plain(q, k_new, v_new, k_new_scale, v_new_scale, k_cache, v_cache,
                                  k_scale, v_scale, cache_len, num_heads):
    """Plain version of ``temporal_decode_pm_int8``: the same function, same
    in-place writes."""
    return temporal_decode_pm_int8_ragged_plain(
        q, k_new, v_new, k_new_scale, v_new_scale, k_cache, v_cache, k_scale, v_scale,
        cache_len.reshape(1), q.shape[0], num_heads,
    )


def _check_int8(name, num_heads, q, k_new, v_new, k_new_scale, v_new_scale, k_cache, v_cache,
                k_scale, v_scale) -> torch.device:
    """Shapes, dtypes, devices and contiguity of F's and G's operands."""
    if q.ndim != 2 or k_cache.ndim != 3:
        raise ValueError(f"{name}: q must be (R, D) and the caches (C, R, D)")
    r, d = q.shape
    c = k_cache.shape[0]
    want = {"k_new": (r, d), "v_new": (r, d), "k_new_scale": (r,), "v_new_scale": (r,),
            "k_cache": (c, r, d), "v_cache": (c, r, d), "k_scale": (c, r), "v_scale": (c, r)}
    given = dict(k_new=k_new, v_new=v_new, k_new_scale=k_new_scale, v_new_scale=v_new_scale,
                 k_cache=k_cache, v_cache=v_cache, k_scale=k_scale, v_scale=v_scale)
    for key, t in given.items():
        if tuple(t.shape) != want[key]:
            raise ValueError(f"{name}: {key} is {tuple(t.shape)}, not {want[key]} for q "
                             f"{tuple(q.shape)} and capacity {c}")
        dtype = torch.float32 if key.endswith("scale") else torch.int8
        if t.dtype != dtype:
            raise TypeError(f"{name}: {key} is {t.dtype}, not {dtype}")
        if t.device != q.device:
            raise ValueError(f"{name}: {key} is on {t.device}, not {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    return _check(name, num_heads, d, q=q)


def _launch_int8(name, symbol, q, k_new, v_new, k_new_scale, v_new_scale, k_cache, v_cache,
                 k_scale, v_scale, lens, rows_per_stream, num_heads):
    _cuda_ready(name, q, k_new, v_new, k_new_scale, v_new_scale, k_cache, v_cache, k_scale,
                v_scale)
    r, d = q.shape
    c = k_cache.shape[0]
    scratch = _decode_scratch("temporal_decode_pm_int8", "sf_temporal_decode_pm_int8",
                              (d, num_heads, c, _DTYPE_CODES[q.dtype]), r, q.device)
    out = torch.empty_like(q)
    args = [q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_new_scale.data_ptr(),
            v_new_scale.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), k_scale.data_ptr(),
            v_scale.data_ptr(), lens.data_ptr()]
    types = [_P] * 10
    if rows_per_stream is not None:  # G
        args.append(rows_per_stream)
        types.append(_I)
    _launch(name, symbol, (*types, _P, _I, _I, _I, _I, _F, _P, _L, _I, _P), q.device, *args,
            out.data_ptr(), r, c, d, num_heads, (d // num_heads) ** -0.5,
            *_scratch_args(scratch), _DTYPE_CODES[q.dtype], library="temporal_decode_pm_int8")
    return out


@_entry("temporal_decode_pm_int8",
        "(Tensor q, Tensor k_new, Tensor v_new, Tensor k_new_scale, Tensor v_new_scale, "
        "Tensor(a!) k_cache, Tensor(b!) v_cache, Tensor(c!) k_scale, Tensor(d!) v_scale, "
        "Tensor cache_len, int num_heads) -> Tensor", _like)
def temporal_decode_pm_int8(q, k_new, v_new, k_new_scale, v_new_scale, k_cache, v_cache,
                            k_scale, v_scale, cache_len, num_heads):
    """``temporal_decode_pm`` on the int8 cache, with the new frame quantized.

    q: (R, D) float32 or bfloat16. k_new, v_new: (R, D) int8 codes of the
    new frame, k_new_scale, v_new_scale: (R,) fp32, one scale per row over
    the whole D (``encoder.quantize_kv``). k_cache, v_cache: (C, R, D) int8;
    k_scale, v_scale: (C, R) fp32, the scale of each (position slot, row).
    cache_len: int32 tensor of one element on the same device, the position
    the new frame takes; it is read on the device and not changed.

    Each (row, head) attends old slots c < min(len, C) except slot len % C,
    plus the new frame dequantized, with score ``(q . codes) * k_scale *
    dh**-0.5`` and value weight ``p * v_scale`` in fp32; then the new codes
    and both scales are written IN PLACE at slot len % C. With len < C this
    is the linear cache; past C the ring's sliding window. Returns (R, D) in
    q's dtype."""
    if cache_len.numel() != 1 or cache_len.dtype != torch.int32:
        raise TypeError("temporal_decode_pm_int8: cache_len must be one int32 element")
    device = _check_int8("temporal_decode_pm_int8", num_heads, q, k_new, v_new, k_new_scale,
                         v_new_scale, k_cache, v_cache, k_scale, v_scale)
    _check_lengths("temporal_decode_pm_int8", device, cache_len=cache_len)
    if device.type == "cpu":
        return temporal_decode_pm_int8_plain(q, k_new, v_new, k_new_scale, v_new_scale, k_cache,
                                             v_cache, k_scale, v_scale, cache_len, num_heads)
    return _launch_int8("temporal_decode_pm_int8", "sf_temporal_decode_pm_int8", q, k_new, v_new,
                        k_new_scale, v_new_scale, k_cache, v_cache, k_scale, v_scale, cache_len,
                        None, num_heads)


@_entry("temporal_decode_pm_int8_ragged",
        "(Tensor q, Tensor k_new, Tensor v_new, Tensor k_new_scale, Tensor v_new_scale, "
        "Tensor(a!) k_cache, Tensor(b!) v_cache, Tensor(c!) k_scale, Tensor(d!) v_scale, "
        "Tensor lens, int rows_per_stream, int num_heads) -> Tensor", _like)
def temporal_decode_pm_int8_ragged(q, k_new, v_new, k_new_scale, v_new_scale, k_cache, v_cache,
                                   k_scale, v_scale, lens, rows_per_stream, num_heads):
    """``temporal_decode_pm_int8`` for a batch of streams, each at its own
    position: lens (B,) int32 on the same device, B * rows_per_stream == R,
    row r of stream ``r // rows_per_stream`` attends and appends at slot
    ``lens[b] % C`` (linear cache and ring alike). Rows are not padded per
    stream. A ragged row's output equals, bit for bit on the card, F's for a
    lone stream at the same position (one kernel source)."""
    device = _check_int8("temporal_decode_pm_int8_ragged", num_heads, q, k_new, v_new,
                         k_new_scale, v_new_scale, k_cache, v_cache, k_scale, v_scale)
    _stream_lengths("temporal_decode_pm_int8_ragged", lens, q.shape[0], rows_per_stream)
    _check_lengths("temporal_decode_pm_int8_ragged", device, lens=lens)
    if device.type == "cpu":
        return temporal_decode_pm_int8_ragged_plain(q, k_new, v_new, k_new_scale, v_new_scale,
                                                    k_cache, v_cache, k_scale, v_scale, lens,
                                                    rows_per_stream, num_heads)
    return _launch_int8("temporal_decode_pm_int8_ragged", "sf_temporal_decode_pm_int8_ragged", q,
                        k_new, v_new, k_new_scale, v_new_scale, k_cache, v_cache, k_scale,
                        v_scale, lens, rows_per_stream, num_heads)


# ---------------------------------------------------------------------------
# B and I. spatial attention over the patches of each (b, t) row
# ---------------------------------------------------------------------------


def _heads(a: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(R, L, D) -> fp32 (R, H, L, dh)."""
    r, l, d = a.shape
    return a.float().view(r, l, num_heads, d // num_heads).transpose(1, 2)


def _unheads(a: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(R, H, L, dh) -> (R, L, D) in ``dtype``."""
    r, h, l, dh = a.shape
    return a.transpose(1, 2).reshape(r, l, h * dh).to(dtype)


def spatial_flat_plain(q, k, v, num_heads):
    """Plain version of ``spatial_flat``: fp32 scores and softmax, probs
    rounded to the input dtype before PV."""
    dh = q.shape[-1] // num_heads
    s = torch.matmul(_heads(q, num_heads), _heads(k, num_heads).transpose(-1, -2)) * dh**-0.5
    p = torch.softmax(s, dim=-1).to(q.dtype).float()
    return _unheads(torch.matmul(p, _heads(v, num_heads)), q.dtype)


def spatial_flat_bwd_plain(q, k, v, g, num_heads):
    """Plain version of ``spatial_flat_bwd``: (dq, dk, dv) of
    ``spatial_flat`` for the output gradient g. The probabilities are
    recomputed; s, p, dp and delta are fp32, and ``ds`` and ``p`` are rounded
    to the input dtype before the last three products, as the kernel does."""
    dt = q.dtype
    scale = (q.shape[-1] // num_heads) ** -0.5
    qh, kh, vh, gh = (_heads(a, num_heads) for a in (q, k, v, g))
    p = torch.softmax(torch.matmul(qh, kh.transpose(-1, -2)) * scale, dim=-1)
    dp = torch.matmul(gh, vh.transpose(-1, -2))
    delta = (dp * p).sum(-1, keepdim=True)
    ds = (p * (dp - delta) * scale).to(dt).float()
    pb = p.to(dt).float()
    dq = torch.matmul(ds, kh)
    dk = torch.matmul(ds.transpose(-1, -2), qh)
    dv = torch.matmul(pb.transpose(-1, -2), gh)
    return _unheads(dq, dt), _unheads(dk, dt), _unheads(dv, dt)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _spatial_chunks(device: torch.device, r: int, n: int, num_heads: int,
                    dtype: torch.dtype) -> int:
    """Rows of one (row, head) a block takes. bf16 (tensor cores, one warp
    per 16 rows): ``_TC_ROWS``, and past ``_TC_ROWS`` patches as many
    16-row tiles as give the card two blocks an SM (joint space-time
    attention of one clip has a dozen (row, head) pairs). fp32: the N rows
    are split only when R*H blocks alone would leave SMs idle (the
    streaming step)."""
    sms = _sm_count(device)
    if dtype == torch.bfloat16:
        if n <= _TC_ROWS:
            return n
        chunks = -(-2 * sms // (r * num_heads))
        return max(16, min(_TC_ROWS, _round16(-(-n // chunks))))
    chunks = max(1, min(-(-n // 16), -(-4 * sms // (r * num_heads))))
    return -(-n // chunks)


@functools.lru_cache(maxsize=None)
def _body_smem(library: str, symbol: str, *shape: int) -> int:
    """Shared memory a block of B's, L's, I's, C's, H's or E's whole-row
    body, or of the decode bodies (A, D, J, F, G, K, the scores in shared
    memory), takes at this shape, from the C entry ``{symbol}_smem_bytes``;
    0 where only csrc/tiled.cuh takes the shape. Each whole-row wrapper
    launches with ``tiled`` = 1 exactly where this is 0; a decode wrapper
    passes a scratch for its scores where this passes ``_MAX_SMEM``."""
    return build.function(library, f"{symbol}_smem_bytes", (_I,) * len(shape))(*shape)


# csrc/tiled.cuh's forward (C, E and fp32 B and L past their whole-row
# bodies): at most this many queries an item, or a query tile whose scores
# do not fit a block, run its split body (scores in a scratch the wrapper
# allocates, the keys split over blocks); else its resident body.
_TILED_FEW = 4
# The most bytes the split body's scratch takes: past it the body runs in
# launches over chunks of items, or of one item's queries (the same bits).
_TILED_SCRATCH = 1 << 30


def _tiled_resident_smem(queries: int, keys: int, head_dim: int, itemsize: int) -> int:
    """Shared memory of a block of csrc/tiled.cuh's resident forward
    (``resident_plan``): two stages of 64 key rows of ``itemsize`` bytes an
    element (padded by 16), ``queries`` fp32 query rows of head_dim + 4, and
    their fp32 scores against every key (rows of ``keys | 1``), then four
    barriers. A launch whose plan passes a block's shared memory raises."""
    row = _round16(head_dim * itemsize) + 16
    return (2 * 64 * row + queries * (head_dim + 4) * 4 + _round16(4 * queries * (keys | 1))
            + 32)


def _tiled_plan(t: int, keys: int, head_dim: int, itemsize: int):
    """How csrc/tiled.cuh's forward takes items of ``t`` queries and at most
    ``keys`` keys of ``itemsize`` bytes an element: (queries a block of its
    resident body, the most of 64, 32 and 16, at most t rounded up to 16,
    whose scores fit; 0 for its split body), and the fp32 scratch the split
    body needs for each query of each (row, head): its scores (keys rounded
    up to 4), then one partial max a chunk of 256 keys."""
    if t > _TILED_FEW:
        for qt in (64, 32, 16):
            if (qt == 16 or t > qt // 2) and (
                    _tiled_resident_smem(qt, keys, head_dim, itemsize) <= _MAX_SMEM):
                return qt, 0
    return 0, (keys + 3) // 4 * 4 + -(-keys // 256)


def _tiled_scratch(items: int, t: int, per_query: int) -> int:
    """fp32 values of the split body's scratch for ``items`` items of ``t``
    queries, ``per_query`` each: all of them while that fits
    ``_TILED_SCRATCH``, else as many whole items as fit (the body launches
    over chunks of them), else, where not even one item fits, as many of an
    item's queries as fit, a multiple of 16 and at least 16 (or t)."""
    budget, whole = _TILED_SCRATCH // 4, t * per_query
    if items * whole <= budget:
        return items * whole
    if whole <= budget:
        return budget // whole * whole
    return max(min(t, 16), budget // per_query // 16 * 16) * per_query


def _tiled_launch(items: int, t: int, keys: int, head_dim: int, itemsize: int, device):
    """The ``tiled`` argument of a launch on csrc/tiled.cuh's forward (the
    resident body's queries a block, or -1 for the split body) and the
    split body's scratch for ``items`` (row, head) items (its size goes with
    it to the launch, which never writes past it), or None."""
    qt, per_query = _tiled_plan(t, keys, head_dim, itemsize)
    if qt:
        return qt, None
    return -1, torch.empty(_tiled_scratch(items, t, per_query), dtype=torch.float32,
                           device=device)


# csrc/tiled.cuh's backward plan, two bits (H's and I's launches take 1 +
# the plan as `tiled`): SWEEPS, the query side recomputing its scores and dp
# in four sweeps over the keys, else keeping them in shared memory; STORED,
# the key side reading p and ds that the query side stores in a scratch,
# else recomputing s and dp. Every plan gives the same bits.
_BWD_SWEEPS, _BWD_STORED = 1, 2


@functools.lru_cache(maxsize=None)
def _tiled_c_plan(which: int, queries: int, keys: int, head_dim: int, itemsize: int) -> int:
    """Shared memory of a block of one of csrc/tiled.cuh's plans, from its C
    entry ``sf_tiled_plan``: ``which`` 0, the resident forward; 1, the
    backward's query side with its scores and dp in shared memory."""
    return build.function("temporal_fullclip_bwd", "sf_tiled_plan", (_I,) * 5)(
        which, queries, keys, head_dim, itemsize)


def _tiled_bwd_plan(t: int, head_dim: int, itemsize: int) -> int:
    """csrc/tiled.cuh's backward plan for items of ``t`` queries and keys of
    ``itemsize`` bytes an element: the query side keeps its 32 queries'
    scores and dp in shared memory while they fit a block, else sweeps; the
    key side reads the stored p and ds while one item's (2 x t x t fp32)
    fit ``_TILED_SCRATCH``, else recomputes (the faster on the H100 at every
    shape measured: PERF.md)."""
    plan = 0 if _tiled_c_plan(1, 0, t, head_dim, itemsize) <= _MAX_SMEM else _BWD_SWEEPS
    if 4 * _tiled_stored_floats(t) <= _TILED_SCRATCH:
        plan |= _BWD_STORED
    return plan


def _tiled_stored_floats(t: int) -> int:
    """fp32 values of an item's stored p and ds: 2 x t rows of t rounded up
    to 4."""
    return 2 * t * (-(-t // 4) * 4)


def _tiled_bwd_launch(items: int, t: int, head_dim: int, itemsize: int, device):
    """The ``tiled`` argument of H's and I's launches on csrc/tiled.cuh's
    backward (1 + ``_tiled_bwd_plan``) for ``items`` (row, head) items of
    ``t`` queries, and the stored p and ds's scratch, or None: as many
    items' as fit ``_TILED_SCRATCH`` (the launches then run over chunks of
    them)."""
    plan = _tiled_bwd_plan(t, head_dim, itemsize)
    if not plan & _BWD_STORED:
        return 1 + plan, None
    per = _tiled_stored_floats(t)
    count = min(items, max(1, _TILED_SCRATCH // 4 // per))
    return 1 + plan, torch.empty(count * per, dtype=torch.float32, device=device)


def _scratch_args(scratch):
    """A scratch's pointer and its fp32 values, as a launch takes them."""
    return (None, 0) if scratch is None else (scratch.data_ptr(), scratch.numel())


def _spatial_shape(name: str, q, *others) -> None:
    if q.ndim != 3 or any(t.shape != q.shape for t in others):
        raise ValueError(f"{name}: all operands must share one (R, N, D) shape")


@_entry("spatial_flat",
        "(Tensor q, Tensor k, Tensor v, int num_heads) -> Tensor", _like)
def _spatial_flat_forward(q, k, v, num_heads):
    """Kernel B on the card, its plain version on the CPU; no autograd."""
    _spatial_shape("spatial_flat", q, k, v)
    r, n, d = q.shape
    device = _check("spatial_flat", num_heads, d, q=q, k=k, v=v)
    if device.type == "cpu":
        return spatial_flat_plain(q, k, v, num_heads)
    _cuda_ready("spatial_flat", q, k, v)
    code = _DTYPE_CODES[q.dtype]
    smem = _body_smem("spatial_flat", "sf_spatial_flat", n, d, num_heads, code)
    if smem > _MAX_SMEM:
        raise ValueError(f"spatial_flat: needs {smem} bytes of shared memory per block")
    out = torch.empty_like(q)
    tiled, scratch = (0, None) if smem else _tiled_launch(r * num_heads, n, n, d // num_heads,
                                                          q.element_size(), device)
    _launch(
        "spatial_flat", "sf_spatial_flat",
        (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P, _L, _I, _P),
        device, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        r, n, d, num_heads, _spatial_chunks(device, r, n, num_heads, q.dtype),
        (d // num_heads) ** -0.5, tiled, *_scratch_args(scratch), code,
    )
    return out


def spatial_flat_bwd(q, k, v, g, num_heads):
    """Gradients of ``spatial_flat``: (dq, dk, dv), each (R, N, D) in q's
    dtype, from the inputs and the output gradient g (R, N, D). Nothing of
    the forward is needed but q, k, v: the probabilities are recomputed."""
    _spatial_shape("spatial_flat_bwd", q, k, v, g)
    r, n, d = q.shape
    device = _check("spatial_flat_bwd", num_heads, d, q=q, k=k, v=v, g=g)
    if device.type == "cpu":
        return spatial_flat_bwd_plain(q, k, v, g, num_heads)
    _cuda_ready("spatial_flat_bwd", q, k, v, g)
    code = _DTYPE_CODES[q.dtype]
    smem = _body_smem("spatial_flat_bwd", "sf_spatial_flat_bwd", n, d, num_heads, code)
    if smem > _MAX_SMEM:
        raise ValueError(f"spatial_flat_bwd: needs {smem} bytes of shared memory per block")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    # two launches (fp32, and bf16 past 256 patches): per (row, head, query)
    # the softmax's statistics and delta; the one-block bf16 kernel keeps
    # them in shared memory
    stats = (torch.empty(r * num_heads * 3 * n, dtype=torch.float32, device=device)
             if q.dtype == torch.float32 or n > 256 else None)
    tiled, scratch = (0, None) if smem else _tiled_bwd_launch(r * num_heads, n, d // num_heads,
                                                              q.element_size(), device)
    _launch(
        "spatial_flat_bwd", "sf_spatial_flat_bwd",
        (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P, _L, _I, _P), device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), None if stats is None else stats.data_ptr(), r, n, d, num_heads,
        _spatial_chunks(device, r, n, num_heads, q.dtype), (d // num_heads) ** -0.5,
        tiled, *_scratch_args(scratch), code,
    )
    return dq, dk, dv


class SpatialFlat(torch.autograd.Function):
    """``spatial_flat`` with its gradient: forward is kernel B, backward
    kernel I (their plain versions on the CPU). Saves q, k, v only."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads):
        ctx.save_for_backward(q, k, v)
        ctx.num_heads = num_heads
        return _spatial_flat_forward(q, k, v, num_heads)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = spatial_flat_bwd(q, k, v, g.contiguous(), ctx.num_heads)
        return dq, dk, dv, None


def spatial_flat(q, k, v, num_heads):
    """Non-causal softmax attention over N patches per row.

    q, k, v: (R, N, D), rows are (b, t) pairs. Returns (R, N, D) in q's
    dtype. Any N (224x224 at patch 16 gives 196, 384x384 576, joint
    space-time attention over 8 such frames 1568). Differentiable in q, k,
    v (``SpatialFlat``)."""
    if _wants_grad(q, k, v):
        return SpatialFlat.apply(q, k, v, num_heads)
    return _spatial_flat_forward(q, k, v, num_heads)


# ---------------------------------------------------------------------------
# L. spatial attention on head-split operands
# ---------------------------------------------------------------------------


def spatial_attention_plain(q, k, v):
    """Plain version of ``spatial_attention``: fp32 scores and softmax, probs
    rounded to v's dtype before PV, as the TPU kernel rounds them."""
    dh = q.shape[-1]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * dh**-0.5
    p = torch.softmax(s, dim=-1).to(v.dtype).float()
    return torch.matmul(p, v.float()).to(q.dtype)


@_entry("spatial_attention",
        "(Tensor q, Tensor k, Tensor v) -> Tensor", _like)
def _spatial_attention_forward(q, k, v):
    """Kernel L on the card, its plain version on the CPU; no autograd."""
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("spatial_attention: all operands must share one (R, H, N, dh) shape")
    r, h, n, dh = q.shape
    device = _check("spatial_attention", h, h * dh, q=q, k=k, v=v)
    if device.type == "cpu":
        return spatial_attention_plain(q, k, v)
    _cuda_ready("spatial_attention", q, k, v)
    code = _DTYPE_CODES[q.dtype]
    smem = _body_smem("spatial_flat", "sf_spatial_flat", n, h * dh, h, code)
    if smem > _MAX_SMEM:
        raise ValueError(f"spatial_attention: needs {smem} bytes of shared memory per block")
    out = torch.empty_like(q)
    tiled, scratch = (0, None) if smem else _tiled_launch(r * h, n, n, dh, q.element_size(),
                                                          device)
    _launch(
        "spatial_attention", "sf_spatial_heads",
        (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P, _L, _I, _P),
        device, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        r, h, n, dh, _spatial_chunks(device, r, n, h, q.dtype), dh**-0.5, tiled,
        *_scratch_args(scratch), code,
        library="spatial_flat",
    )
    return out


class SpatialAttention(torch.autograd.Function):
    """``spatial_attention`` with its gradient: forward is kernel L (its
    plain version on the CPU), backward autograd of the plain version, as
    the JAX package's backward is the VJP of its einsum reference."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return _spatial_attention_forward(q, k, v)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            return torch.autograd.grad(spatial_attention_plain(*qkv), qkv, g)


def spatial_attention(q, k, v):
    """Non-causal softmax attention over N patches for each (row, head).

    q, k, v: (R, H, N, dh), any N. Returns (R, H, N, dh) in q's
    dtype. Differentiable in q, k, v (``SpatialAttention``). The encoder
    does not call it (it runs ``spatial_flat`` on flat rows), as the JAX
    package's encoder does not call ``fused_spatial_attention``."""
    if _wants_grad(q, k, v):
        return SpatialAttention.apply(q, k, v)
    return _spatial_attention_forward(q, k, v)


# ---------------------------------------------------------------------------
# C and H. temporal attention over a full clip, causal or not
# ---------------------------------------------------------------------------


def _masked(s: torch.Tensor, causal: bool) -> torch.Tensor:
    """Scores (..., T, T) with the keys after each query at -inf when
    ``causal``."""
    if not causal:
        return s
    t = s.shape[-1]
    return s.masked_fill(~torch.ones(t, t, dtype=torch.bool, device=s.device).tril(),
                         float("-inf"))


def temporal_fullclip_plain(q, k, v, num_heads, causal=True):
    """Plain version of ``temporal_fullclip``: fp32 throughout, output
    rounded to the input dtype."""
    dh = q.shape[-1] // num_heads
    s = torch.matmul(_heads(q, num_heads), _heads(k, num_heads).transpose(-1, -2)) * dh**-0.5
    p = torch.softmax(_masked(s, causal), dim=-1)
    return _unheads(torch.matmul(p, _heads(v, num_heads)), q.dtype)


def temporal_fullclip_bwd_plain(q, k, v, g, num_heads, causal=True):
    """Plain version of ``temporal_fullclip_bwd``: (dq, dk, dv) of
    ``temporal_fullclip`` for the output gradient g, the probabilities
    recomputed, fp32 throughout, each gradient rounded to the input dtype."""
    dt = q.dtype
    scale = (q.shape[-1] // num_heads) ** -0.5
    qh, kh, vh, gh = (_heads(a, num_heads) for a in (q, k, v, g))
    s = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    p = torch.softmax(_masked(s, causal), dim=-1)
    dp = torch.matmul(gh, vh.transpose(-1, -2))
    delta = (dp * p).sum(-1, keepdim=True)
    ds = p * (dp - delta) * scale  # masked keys: p == 0 -> ds == 0
    dq = torch.matmul(ds, kh)
    dk = torch.matmul(ds.transpose(-1, -2), qh)
    dv = torch.matmul(p.transpose(-1, -2), gh)
    return _unheads(dq, dt), _unheads(dk, dt), _unheads(dv, dt)


def _temporal_shape(name: str, q, *others) -> None:
    if q.ndim != 3 or any(t.shape != q.shape for t in others):
        raise ValueError(f"{name}: all operands must share one (R, T, D) shape")


def _frame_strides(x: torch.Tensor):
    """Element strides over (b, t, n) of a (B, T, N, D) view, or of (R, T, D)
    rows taken as B = R, N = 1."""
    return tuple(x.stride()[:3]) if x.ndim == 4 else (x.stride(0), x.stride(1), 0)


def _fullclip_kernel(name: str, symbol: str, operands, batch: int, n: int, t: int, d: int,
                     num_heads: int, causal: bool):
    """Launch C or H on operands read and written in place: each a (tensor,
    column) pair, the D-wide slice from ``column`` on of a (B, T, N, D')
    tensor or of (R, T, D) rows, whose last axis is contiguous; count it
    under ``name``. The whole-row pipeline runs while one head's item fits a
    block, the tiled body (any T, the same bits) past it."""
    first = operands[0][0]
    code = _DTYPE_CODES[first.dtype]
    tiled = not _body_smem(name, symbol, t, d, num_heads, code, int(causal))
    ptrs = (_P * len(operands))(*(x.data_ptr() + col * x.element_size() for x, col in operands))
    strides = (ctypes.c_longlong * (3 * len(operands)))(
        *(s for x, _ in operands for s in _frame_strides(x)))
    args = [batch, n, t, d, num_heads, (d // num_heads) ** -0.5, int(causal), int(tiled)]
    if name == "temporal_fullclip":
        argtypes = (_P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _P, _L, _I, _P)
        scratch = None
        if tiled:  # which of tiled.cuh's bodies, and the split body's scratch
            args[-1], scratch = _tiled_launch(batch * n * num_heads, t, t, d // num_heads,
                                              first.element_size(), first.device)
        args.extend(_scratch_args(scratch))
    else:  # H's tiled body keeps each query's statistics between its two launches
        argtypes = (_P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _P, _P, _L, _I, _P)
        stats = scratch = None
        if tiled:  # and its plan, with the plan's scratch
            stats = torch.empty(batch * n * num_heads * 3 * t, dtype=torch.float32,
                                device=first.device)
            args[-1], scratch = _tiled_bwd_launch(batch * n * num_heads, t, d // num_heads,
                                                  first.element_size(), first.device)
        args.append(None if stats is None else stats.data_ptr())
        args.extend(_scratch_args(scratch))
    _launch(name, symbol, argtypes, first.device, ptrs, strides, *args, code)


@_entry("temporal_fullclip",
        "(Tensor q, Tensor k, Tensor v, int num_heads, bool causal=True) -> Tensor", _like)
def _temporal_fullclip_forward(q, k, v, num_heads, causal=True):
    """Kernel C on the card, its plain version on the CPU; no autograd."""
    _temporal_shape("temporal_fullclip", q, k, v)
    r, t, d = q.shape
    device = _check("temporal_fullclip", num_heads, d, q=q, k=k, v=v)
    if device.type == "cpu":
        return temporal_fullclip_plain(q, k, v, num_heads, causal)
    _cuda_ready("temporal_fullclip", q, k, v)
    out = torch.empty_like(q)
    _fullclip_kernel("temporal_fullclip", "sf_temporal_fullclip",
                     [(x, 0) for x in (q, k, v, out)], r, 1, t, d, num_heads, causal)
    return out


def temporal_fullclip_bwd(q, k, v, g, num_heads, causal=True):
    """Gradients of ``temporal_fullclip``: (dq, dk, dv), each (R, T, D) in
    q's dtype, from the inputs and the output gradient g (R, T, D). Nothing
    of the forward is needed but q, k, v: the probabilities are recomputed."""
    _temporal_shape("temporal_fullclip_bwd", q, k, v, g)
    r, t, d = q.shape
    device = _check("temporal_fullclip_bwd", num_heads, d, q=q, k=k, v=v, g=g)
    if device.type == "cpu":
        return temporal_fullclip_bwd_plain(q, k, v, g, num_heads, causal)
    _cuda_ready("temporal_fullclip_bwd", q, k, v, g)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    _fullclip_kernel("temporal_fullclip_bwd", "sf_temporal_fullclip_bwd",
                     [(x, 0) for x in (q, k, v, g, dq, dk, dv)], r, 1, t, d, num_heads, causal)
    return dq, dk, dv


class TemporalFullclip(torch.autograd.Function):
    """``temporal_fullclip`` with its gradient: forward is kernel C,
    backward kernel H (their plain versions on the CPU). Saves q, k, v only."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads, causal=True):
        ctx.save_for_backward(q, k, v)
        ctx.num_heads, ctx.causal = num_heads, causal
        return _temporal_fullclip_forward(q, k, v, num_heads, causal)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = temporal_fullclip_bwd(q, k, v, g.contiguous(), ctx.num_heads, ctx.causal)
        return dq, dk, dv, None, None


def temporal_fullclip(q, k, v, num_heads, causal=True):
    """Attention over the T frames of each row, any T.

    q, k, v: (R, T, D), rows are (b, n) pairs; query t attends keys 0..t
    (``causal``), or every key. Returns (R, T, D) in q's dtype.
    Differentiable in q, k, v (``TemporalFullclip``)."""
    if _wants_grad(q, k, v):
        return TemporalFullclip.apply(q, k, v, num_heads, causal)
    return _temporal_fullclip_forward(q, k, v, num_heads, causal)


# The packed entry: the encoder's own layout, read and written in place.


def _thirds(qkv: torch.Tensor):
    """q, k, v (or dq, dk, dv): the three D-wide views of a (B, T, N, 3D)
    tensor."""
    d = qkv.shape[-1] // 3
    return qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]


def _packed_rows(x: torch.Tensor) -> torch.Tensor:
    """(B, T, N, D) -> (B*N, T, D), the JAX encoder's transpose."""
    b, t, n, d = x.shape
    return x.transpose(1, 2).reshape(b * n, t, d)


def _unpacked(rows: torch.Tensor, b: int, n: int) -> torch.Tensor:
    """(B*N, T, D) -> a (B, T, N, D) view."""
    r, t, d = rows.shape
    return rows.reshape(b, n, t, d).transpose(1, 2)


def temporal_fullclip_qkv_plain(qkv, num_heads, causal=True):
    """Plain version of ``temporal_fullclip_qkv``: the slices and transposes
    of the JAX encoder around ``temporal_fullclip_plain``."""
    b, _, n, _ = qkv.shape
    rows = (_packed_rows(x) for x in _thirds(qkv))
    return _unpacked(temporal_fullclip_plain(*rows, num_heads, causal), b, n).contiguous()


def temporal_fullclip_qkv_bwd_plain(qkv, g, num_heads, causal=True):
    """Plain version of ``temporal_fullclip_qkv_bwd``: ``temporal_fullclip_bwd_plain``
    on the transposed slices, its three gradients put back side by side."""
    b, _, n, _ = qkv.shape
    grads = temporal_fullclip_bwd_plain(*(_packed_rows(x) for x in _thirds(qkv)),
                                        _packed_rows(g), num_heads, causal)
    return torch.cat([_unpacked(x, b, n) for x in grads], -1)


def _packed_check(name: str, qkv, num_heads, **more) -> torch.device:
    """What the packed entries require: a (B, T, N, 3D) qkv (and a (B, T,
    N, D) g), and layouts the bulk copies take: D contiguous,
    strides and data 16-byte aligned. Raises on anything else, on the CPU
    as on the card: there is no fallback to a copy."""
    if qkv.ndim != 4 or qkv.shape[-1] % 3:
        raise ValueError(f"{name}: qkv must be (B, T, N, 3D), not {tuple(qkv.shape)}")
    b, t, n, d3 = qkv.shape
    for key, x in more.items():
        if x.shape != (b, t, n, d3 // 3):
            raise ValueError(f"{name}: {key} must be (B, T, N, D) = {(b, t, n, d3 // 3)}")
    device = _check(name, num_heads, d3 // 3, strided=True, qkv=qkv, **more)
    if device.type == "cuda":
        _cuda_ready(name, qkv, *more.values())
    return device


@_entry("temporal_fullclip_qkv",
        "(Tensor qkv, int num_heads, bool causal=True) -> Tensor", _packed_out)
def _temporal_fullclip_qkv_forward(qkv, num_heads, causal=True):
    """Kernel C on the card, its plain version on the CPU; no autograd."""
    device = _packed_check("temporal_fullclip_qkv", qkv, num_heads)
    if device.type == "cpu":
        return temporal_fullclip_qkv_plain(qkv, num_heads, causal)
    b, t, n, d3 = qkv.shape
    d = d3 // 3
    out = qkv.new_empty(b, t, n, d)
    _fullclip_kernel("temporal_fullclip", "sf_temporal_fullclip",
                     [(qkv, 0), (qkv, d), (qkv, 2 * d), (out, 0)], b, n, t, d, num_heads,
                     causal)
    return out


def temporal_fullclip_qkv_bwd(qkv, g, num_heads, causal=True):
    """Gradient of ``temporal_fullclip_qkv``: one (B, T, N, 3D) tensor, dq,
    dk and dv side by side as q, k and v are in ``qkv``, written in place by
    kernel H from qkv and the output gradient g (B, T, N, D)."""
    device = _packed_check("temporal_fullclip_qkv_bwd", qkv, num_heads, g=g)
    if device.type == "cpu":
        return temporal_fullclip_qkv_bwd_plain(qkv, g, num_heads, causal)
    b, t, n, d3 = qkv.shape
    d = d3 // 3
    grad = qkv.new_empty(qkv.shape)
    thirds = [(qkv, 0), (qkv, d), (qkv, 2 * d)]
    _fullclip_kernel("temporal_fullclip_bwd", "sf_temporal_fullclip_bwd",
                     [*thirds, (g, 0), *((grad, col) for _, col in thirds)], b, n, t, d, num_heads,
                     causal)
    return grad


class TemporalFullclipQKV(torch.autograd.Function):
    """``temporal_fullclip_qkv`` with its gradient: forward is kernel C,
    backward kernel H, both on the packed layout (their plain versions on
    the CPU). Saves qkv only."""

    @staticmethod
    def forward(ctx, qkv, num_heads, causal=True):
        ctx.save_for_backward(qkv)
        ctx.num_heads, ctx.causal = num_heads, causal
        return _temporal_fullclip_qkv_forward(qkv, num_heads, causal)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        (qkv,) = ctx.saved_tensors
        return temporal_fullclip_qkv_bwd(qkv, g, ctx.num_heads, ctx.causal), None, None


def temporal_fullclip_qkv(qkv, num_heads, causal=True):
    """``temporal_fullclip`` on the encoder's own layout.

    qkv: (B, T, N, 3D), the output of the qkv projection: q, k, v are its
    three D-wide slices, and (b, n) its rows. Returns the contiguous (B, T,
    N, D) context in qkv's dtype, which the output projection takes as it
    is. Kernels C and H read and write the operands in place, so nothing is
    sliced, transposed or copied around them; the gradient is one (B, T, N,
    3D) tensor. Differentiable in qkv (``TemporalFullclipQKV``). The D axis
    must be contiguous, and the data and the other strides 16-byte aligned
    (the output of a linear layer is); the output gradient too. Any T;
    ``causal=False`` lets every frame attend every frame."""
    if _wants_grad(qkv):
        return TemporalFullclipQKV.apply(qkv, num_heads, causal)
    return _temporal_fullclip_qkv_forward(qkv, num_heads, causal)
