"""Deployment export: the port's programs as ``torch.export`` artifacts.

The port of the JAX package's ``export.py``. Trace a program once on the
build machine, write a versioned artifact, and serve it from any process
with ``load_exported`` alone: no model code and no config on the serving
side. The artifact is a ``torch.export`` program written by
``torch.export.save``; its calling convention is the JAX package's:

- ``export_streaming_step``: ``(params, frames, cache) -> (outputs, new_cache)``
- ``export_full_clip``: ``(params, pixel_values) -> outputs``
- ``export_lm_decode``: ``(params, toks, cache, active) -> (next_tokens, new_cache)``
- ``export_sharded_forward``: ``(rank's params, rank's rows) -> outputs``, one
  SPMD program over a (data, model) mesh

``params`` is the port's state dict (``model.state_dict()``, or that of a
model quantized by ``ops.quant``); the artifact holds no weights: the
module is built on the ``meta`` device and called through
``torch.func.functional_call`` on the params given. Shapes are static. The
attention kernels are ``torch.library`` ops (``ops.attention.OPS``), so the
program calls the same kernels the live path launches, counted in
``ops.attention.LAUNCHES``, or their plain versions on the CPU. A program is
exported for one device type (``device``, the card by default) and refuses
to load or run on another; it is never moved. The cache is written in place
by the kernels and returned, as the live calls return it.

The artifact's metadata records the device type, the torch version that
wrote it and ``CACHE_LAYOUT_VERSION``; ``load_exported`` refuses an
artifact of another cache layout (re-export it: no weights change).

    python -m streamformer_tpu_torch.export --out step.pt2 --streaming --batch 8 \\
        --capacity 16 --device cuda
"""

from __future__ import annotations

import io
import json
from typing import Any, Callable, Dict, Optional, Sequence

import torch

# streamformer::* ops: the kernels a loaded program calls
from streamformer_tpu_torch.ops import attention as _ops  # noqa: F401

__all__ = [
    "CACHE_LAYOUT_VERSION",
    "export_streaming_step",
    "export_full_clip",
    "export_lm_decode",
    "export_sharded_forward",
    "load_exported",
]

# The version of the caches' layout a program reads and writes: the encoder's
# pos-major (C, B*N, D) and row-major (B, N, C, D) planes with int32 lengths,
# and the LM's flat (B, C, hkv*dh) planes with int64 lengths. Bump it when a
# layout changes: artifacts of another version are refused.
CACHE_LAYOUT_VERSION = 1
_META_FILE = "streamformer.json"


def _device(device) -> torch.device:
    """The device a program is exported for: ``cuda`` unless named."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available to export for; pass device='cpu'")
    return dev


class _Bound(torch.nn.Module):
    """``fn(model, *args)`` as a module's forward."""

    def __init__(self, model: torch.nn.Module, fn: Callable):
        super().__init__()
        self.model = model
        self._fn = fn

    def forward(self, *args):
        return self._fn(self.model, *args)


class _Program(torch.nn.Module):
    """``fn(model, *args)`` on the parameters and buffers ``params`` (through
    ``torch.func.functional_call``). The model is held outside the module
    tree, so the exported program lifts none of its (meta) tensors."""

    def __init__(self, model: torch.nn.Module, fn: Callable):
        super().__init__()
        self._held = [_Bound(model, fn)]

    def forward(self, params: Dict[str, torch.Tensor], *args):
        tensors = {"model." + k: v for k, v in params.items()}
        return torch.func.functional_call(self._held[0], tensors, args)


def _empty_like_meta(tensors: Dict[str, torch.Tensor],
                     dev: torch.device) -> Dict[str, torch.Tensor]:
    """Uninitialised tensors of each meta tensor's shape and dtype on ``dev``:
    the example inputs export traces with (their values are never read)."""
    return {k: torch.empty(v.shape, dtype=v.dtype, device=dev) for k, v in tensors.items()}


def _export(program: _Program, args: tuple, dev: torch.device, kind: str, params_keys,
            info: Dict[str, Any], path: Optional[str]) -> bytes:
    with torch.no_grad():
        ep = torch.export.export(program, args)
    # the traced inputs would be saved with the program (the weights and the
    # cache among them); the dtype checks of its casts guard what its static
    # input dtypes already fix
    ep.example_inputs = None
    for node in list(ep.graph.nodes):
        if node.target is torch.ops.aten._assert_tensor_metadata.default:
            ep.graph.erase_node(node)
    ep.graph_module.recompile()
    meta = {"format": "streamformer_tpu_torch.export", "kind": kind, "device_type": dev.type,
            "torch": torch.__version__, "cache_layout_version": CACHE_LAYOUT_VERSION,
            "params": list(params_keys), **info}
    buf = io.BytesIO()
    torch.export.save(ep, buf, extra_files={_META_FILE: json.dumps(meta)})
    blob = buf.getvalue()
    if path:
        with open(path, "wb") as f:
            f.write(blob)
    return blob


def _meta_encoder(cfg, quantized_weights: bool):
    from streamformer_tpu_torch.models import encoder
    from streamformer_tpu_torch.ops import quant

    with torch.device("meta"):
        model = encoder.StreamformerEncoder(cfg, device="meta")
        if quantized_weights:
            quant.quantize_encoder(model)
    return model


def export_streaming_step(cfg, batch: int, t_new: int = 1, *, per_stream_len: bool = False,
                          quantized_weights: bool = False, path: Optional[str] = None,
                          device=None) -> bytes:
    """The streaming step ``encoder.streaming_forward`` as an artifact.

    Signature ``(params, frames (B, t_new, 3, H, W), cache) -> (outputs,
    new_cache)``, ``outputs = {"last_hidden_state": (B, t_new, N, D),
    "pooler_output": (B, t_new, D)}``; ``cache`` is ``encoder.init_cache(cfg,
    batch, per_stream_len=per_stream_len)`` (``cfg`` fixes its capacity,
    mode, layout and dtype) and is updated in place, ``len`` too, then
    returned. ``quantized_weights`` exports the int8-weight program: params
    are then the state dict of ``quant.quantize_encoder(model)``. Returns
    the artifact's bytes, also written to ``path`` when given."""
    from streamformer_tpu_torch.models import encoder

    dev = _device(device)
    model = _meta_encoder(cfg, quantized_weights)
    params = _empty_like_meta(model.state_dict(), dev)
    frames = torch.empty(batch, t_new, cfg.num_channels, cfg.image_size, cfg.image_size,
                         dtype=encoder.compute_dtype(cfg), device=dev)
    cache = encoder.init_cache(cfg, batch, per_stream_len=per_stream_len, device=dev)

    def step(m, x, c):
        return encoder.streaming_forward(m, x, c, cfg=cfg)

    info = {"batch": batch, "t_new": t_new, "per_stream_len": per_stream_len,
            "quantized_weights": quantized_weights, "config": cfg.to_dict()}
    return _export(_Program(model, step), (params, frames, cache), dev, "streaming_step",
                   params, info, path)


def export_full_clip(cfg, batch: int, num_frames: Optional[int] = None, *,
                     path: Optional[str] = None, device=None) -> bytes:
    """The full-clip forward ``encoder.model_forward`` as an artifact:
    ``(params, pixel_values (B, T, 3, H, W)) -> {"last_hidden_state": (B, T,
    N, D), "pooler_output": (B, T, D)}``, T = ``num_frames`` (default
    ``cfg.num_frames``)."""
    from streamformer_tpu_torch.models import encoder

    dev = _device(device)
    t = num_frames if num_frames is not None else cfg.num_frames
    model = _meta_encoder(cfg, False)
    params = _empty_like_meta(model.state_dict(), dev)
    px = torch.empty(batch, t, cfg.num_channels, cfg.image_size, cfg.image_size,
                     dtype=encoder.compute_dtype(cfg), device=dev)
    info = {"batch": batch, "num_frames": t, "config": cfg.to_dict()}
    return _export(_Program(model, encoder.model_forward), (params, px), dev, "full_clip",
                   params, info, path)


def export_lm_decode(lm_cfg, slots: int, capacity: int, *, quantized_weights: bool = False,
                     cache_dtype: Optional[str] = None, path: Optional[str] = None,
                     device=None) -> bytes:
    """The continuous-batching LM decode step, greedy, as an artifact.

    Signature ``(params, toks (S,) int64, cache, active (S,) bool) ->
    (next_tokens (S,) int32, new_cache)`` over the ragged cache
    (``language_model.init_cache(lm_cfg, slots, capacity, per_stream_len=True,
    cache_dtype=cache_dtype)``): ``DecodeEngine``'s decode step with the
    idle-slot hold, the length of a slot whose ``active`` is False rolled
    back so that it does not advance (its token means nothing). The cache
    planes are written in place and returned with the new lengths.
    ``quantized_weights``: params of ``quant.quantize_lm(model)``."""
    from streamformer_tpu_torch.models import language_model as LM
    from streamformer_tpu_torch.ops import quant

    dev = _device(device)
    with torch.device("meta"):
        model = LM.LanguageModel(lm_cfg, device="meta")
        if quantized_weights:
            quant.quantize_lm(model)
    model.rope_inv = LM.rope_inverse_frequencies(lm_cfg).to(dev)  # a constant of the program
    params = _empty_like_meta(model.state_dict(), dev)
    toks = torch.zeros(slots, dtype=torch.int64, device=dev)
    active = torch.ones(slots, dtype=torch.bool, device=dev)
    cache = LM.init_cache(lm_cfg, slots, capacity, per_stream_len=True, cache_dtype=cache_dtype,
                          device=dev)

    def step(m, tk, c, act):
        emb = LM.embed_tokens(m, tk)[:, None]
        out, c = LM.forward(m, emb, cache=c)
        c = {"layers": c["layers"], "len": torch.where(act, c["len"], c["len"] - 1)}
        return out["logits"][:, -1].argmax(-1).to(torch.int32), c

    info = {"slots": slots, "capacity": capacity, "quantized_weights": quantized_weights,
            "cache_dtype": cache_dtype}
    return _export(_Program(model, step), (params, toks, cache, active), dev, "lm_decode",
                   params, info, path)


def _group_names(mesh) -> Dict[str, str]:
    """The process-group name of each of ``mesh``'s dims on this rank."""
    return {name: mesh.get_group(name).group_name for name in mesh.mesh_dim_names}


def export_sharded_forward(cfg, batch: int, mesh, num_frames: Optional[int] = None, *,
                           path: Optional[str] = None) -> bytes:
    """The full clip over a ``(data, model)`` mesh (``parallel.mesh.
    make_mesh``) as one SPMD artifact, called by every rank of the mesh.

    Data parallelism over ``data`` (batch rows), tensor parallelism over
    ``model`` (``parallel.sharding.shard_encoder``'s rules), outputs
    replicated, as the JAX package's artifact partitions them. Signature
    ``(params, pixel_values (batch / data, T, 3, H, W)) -> {"last_hidden_state":
    (batch, T, N, D), "pooler_output": (batch, T, D)}``: ``params`` is this
    rank's ``state_dict()`` of the model cut by ``shard_encoder`` over the
    mesh's model group, ``pixel_values`` this rank's rows of the batch (data
    rank i holds rows i * batch / data ..), and every rank gets the whole
    batch's outputs (gathered over ``data``). The params are inputs, so one
    program serves every rank: its collectives name the process groups, and
    ``load_exported(..., mesh=)`` binds them to the loading rank's. The
    metadata records the mesh's shape; a mesh of another shape is refused at
    load. ``cfg.shard_patches`` exports the sequence-parallel trunk. Every
    rank returns the artifact's bytes; rank 0 of the job writes ``path``."""
    import torch.distributed as dist

    from streamformer_tpu_torch.models import encoder
    from streamformer_tpu_torch.parallel import mesh as mesh_lib
    from streamformer_tpu_torch.parallel import sharding

    shape = {name: mesh_lib.dim_size(mesh, name) for name in ("data", "model")}
    if mesh is None or shape["data"] * shape["model"] != mesh.size():
        raise ValueError("export_sharded_forward needs the (data, model) mesh of "
                         f"parallel.mesh.make_mesh, not {mesh}")
    if batch % shape["data"]:
        raise ValueError(f"batch {batch} does not divide over data={shape['data']}")
    dev = torch.device(mesh.device_type)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    t = num_frames if num_frames is not None else cfg.num_frames
    model = _meta_encoder(cfg, False)
    sharding.shard_encoder(model, mesh.get_group("model"), cfg.shard_patches)
    params = _empty_like_meta(model.state_dict(), dev)
    px = torch.empty(batch // shape["data"], t, cfg.num_channels, cfg.image_size,
                     cfg.image_size, dtype=encoder.compute_dtype(cfg), device=dev)
    data_group = mesh.get_group("data") if shape["data"] > 1 else None

    def forward(m, x):
        out = encoder.model_forward(m, x)
        if data_group is None:
            return out
        return {k: sharding.all_gather(v, data_group) for k, v in out.items()}

    info = {"batch": batch, "num_frames": t, "config": cfg.to_dict(), "mesh": shape,
            "groups": _group_names(mesh)}
    write = path if dist.get_rank() == 0 else None
    return _export(_Program(model, forward), (params, px), dev, "sharded_forward", params, info,
                   write)


class ExportedProgram:
    """A loaded artifact: call it as the exported function. ``metadata`` is
    the artifact's record (kind, device type, torch version, cache layout,
    shapes)."""

    def __init__(self, module: Callable, metadata: Dict[str, Any]):
        self.module = module
        self.metadata = metadata
        self._keys = metadata["params"]

    def __call__(self, params, *args):
        want = self.metadata["device_type"]
        for x in (*args, *params.values()):
            if isinstance(x, torch.Tensor) and x.device.type != want:
                raise ValueError(f"this program was exported for {want}; an input is on "
                                 f"{x.device} (re-export for {x.device.type}: a program is "
                                 "never moved)")
        missing = [k for k in self._keys if k not in params]
        if missing:
            raise KeyError(f"params lack {len(missing)} tensors the program takes: {missing[:5]}")
        return self.module({k: params[k] for k in self._keys}, *args)


def _bind_groups(ep, meta: Dict[str, Any], mesh) -> None:
    """Point a sharded program's collectives at this rank's process groups
    (``mesh``'s), in place: the exporting rank's group names are replaced
    by the loading rank's, dim by dim. A mesh of another shape is refused."""
    import torch.distributed as dist

    from streamformer_tpu_torch.parallel import mesh as mesh_lib

    want = meta["mesh"]
    if mesh is None or not dist.is_initialized():
        raise ValueError(f"a program sharded over a (data, model) mesh of {want}: load it on "
                         "every rank with load_exported(..., mesh=make_mesh(...))")
    got = {name: mesh_lib.dim_size(mesh, name) for name in want}
    if got != want or dist.get_world_size() != want["data"] * want["model"]:
        raise ValueError(f"the program was exported for a mesh of {want}; this group is "
                         f"{got} of {dist.get_world_size()} processes: re-export it for this mesh")
    rename = {meta["groups"][name]: g for name, g in _group_names(mesh).items()
              if name in meta["groups"]}
    for node in ep.graph.nodes:
        if node.op == "call_function" and "c10d_functional" in str(node.target):
            node.args = tuple(rename.get(a, a) if isinstance(a, str) else a for a in node.args)
    ep.graph_module.recompile()


def load_exported(blob_or_path, *, device=None, mesh=None) -> ExportedProgram:
    """Load an artifact from its bytes or a file, to run on ``device`` (the
    card unless named). Raises ``ValueError`` when the artifact was written
    for another cache layout (re-export it) or another device type. A
    sharded program (``export_sharded_forward``) is loaded by every rank of
    a ``mesh`` of the shape it was exported for, whose process groups its
    collectives then use; another shape is refused."""
    if isinstance(blob_or_path, (bytes, bytearray)):
        source = io.BytesIO(blob_or_path)
    else:
        source = str(blob_or_path)
    extra = {_META_FILE: ""}
    ep = torch.export.load(source, extra_files=extra)
    if not extra[_META_FILE]:
        raise ValueError("not an artifact of streamformer_tpu_torch.export (no metadata)")
    meta = json.loads(extra[_META_FILE])
    if meta.get("cache_layout_version") != CACHE_LAYOUT_VERSION:
        raise ValueError(
            f"cache layout changed: the artifact reads layout version "
            f"{meta.get('cache_layout_version')}, this code builds version "
            f"{CACHE_LAYOUT_VERSION}; re-export it (no weights change)")
    want = torch.device("cuda" if device is None else device).type
    if meta["device_type"] != want:
        raise ValueError(f"the artifact was exported for {meta['device_type']}, not {want}: "
                         "re-export it for this device (a program is never moved)")
    if meta["kind"] == "sharded_forward":
        _bind_groups(ep, meta, mesh)
    return ExportedProgram(ep.module(), meta)


def main(argv: Optional[Sequence[str]] = None) -> None:
    """Write a deployment artifact for a config (the flagship widths, or
    those of ``--config``).

    python -m streamformer_tpu_torch.export --out step.pt2 [--streaming]
        [--batch 8] [--t_new 1] [--capacity 16] [--ragged] [--int8_weights]
        [--config ckpt/config.json] [--device cuda]
    """
    import argparse

    from streamformer_tpu_torch.config import StreamformerConfig

    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("--out", required=True)
    p.add_argument("--streaming", action="store_true",
                   help="export the streaming step (default: full clip)")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--t_new", type=int, default=1)
    p.add_argument("--num_frames", type=int, default=16)
    p.add_argument("--capacity", type=int, default=16)
    p.add_argument("--ragged", action="store_true",
                   help="per-stream lengths (continuous batching)")
    p.add_argument("--int8_weights", action="store_true",
                   help="int8-weight serving program (params of quant.quantize_encoder)")
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--config", default=None,
                   help="a checkpoint's config.json (or its directory) to take the widths "
                        "from (default: the flagship's)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)

    if (args.ragged or args.int8_weights) and not args.streaming:
        p.error("--ragged/--int8_weights are streaming-step options; pass --streaming")
    base = StreamformerConfig.from_pretrained(args.config) if args.config else StreamformerConfig()
    cfg = base.replace(dtype=args.dtype, cache_capacity=args.capacity, num_frames=args.num_frames)
    if args.streaming:
        blob = export_streaming_step(cfg, args.batch, args.t_new, per_stream_len=args.ragged,
                                     quantized_weights=args.int8_weights, path=args.out,
                                     device=args.device)
    else:
        blob = export_full_clip(cfg, args.batch, args.num_frames, path=args.out,
                                device=args.device)
    print(f"wrote {len(blob)} bytes -> {args.out}")


if __name__ == "__main__":
    main()
