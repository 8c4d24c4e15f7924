"""A tensor-parallel lockstep stream on several processes of one host
(and, with ``--serve``, the engine over the data axis and the sharded
export).

Each rank joins a gloo group on localhost, loads the encoder of a checkpoint
directory on the card (or the CPU), cuts it over its model group
(``parallel.sharding.shard_encoder``) and streams a clip a frame a call on
the ring cache of the rank's heads, counting the kernels it launches. Gloo
reduces CUDA tensors, which is all tensor parallelism without
``shard_patches`` needs, so two ranks can share one card (NCCL refuses two
ranks on one GPU); ``--backend nccl`` puts each rank on a card of its own.
``--reference`` also streams the clip in one process and prints each
rank's distance from it and both times. ``--serve SPEC`` first runs
``StreamingEngine`` over a (world, 1) mesh, each rank its share of the
slots (a poll broadcasts the owner's features), and the clip of the
model's first layers through ``export_sharded_forward`` over (1, world),
loaded on each rank's groups.

    python -m streamformer_tpu_torch.tools.tp_stream --ckpt DIR --video clip.pt \\
        --out DIR [--world 2] [--capacity 16] [--cache_dtypes float,int8] [--device cuda] \\
        [--backend gloo|nccl] [--serve SPEC] [--reference]

``launch`` runs the ranks from Python and returns their results: for each
cache dtype, each rank's pooled outputs (B, T, D), its launch counts, its
seconds and its cache's width; ``reference`` is the one-process stream
they are held to.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Sequence

import torch


def engine_run(eng, clips: Sequence, frames: int, burst_ticks: int = 2):
    """Serve ``clips`` (uint8 (n, 3, H, W) arrays) on ``eng`` in bursts:
    half of each clip, ``burst_ticks`` ticks of ``frames``, the rest, to the
    end. Returns (each stream's features, ticks); raises if a stream did not
    finish."""
    sids = [eng.open() for _ in clips]
    for sid, clip in zip(sids, clips):
        eng.feed(sid, clip[:len(clip) // 2])
    ticks = sum(eng.tick(frames=frames) for _ in range(burst_ticks))
    for sid, clip in zip(sids, clips):
        eng.feed(sid, clip[len(clip) // 2:])
        eng.close(sid)
    ticks += eng.run_until_idle(frames=frames)
    polled = [eng.poll(sid) for sid in sids]
    if not all(done for _, done in polled):
        raise RuntimeError("an engine stream did not finish")
    return [f for f, _ in polled], ticks


def _serve(model, video, world: int, spec: dict) -> dict:
    """The engine over a (world, 1) mesh (the whole model on every rank,
    each rank its share of the slots) and, where ``spec["export_layers"]``
    is not 0, the full clip of the model's first so many layers exported
    over (1, world), loaded on this rank's groups and run beside the live
    tensor-parallel clip."""
    from streamformer_tpu_torch import export as EX
    from streamformer_tpu_torch.models import encoder
    from streamformer_tpu_torch.ops import attention as ops
    from streamformer_tpu_torch.parallel import mesh as mesh_lib
    from streamformer_tpu_torch.parallel import sharding
    from streamformer_tpu_torch.serving import StreamingEngine

    dev_type = model.device.type
    out = {"engine": {}}
    data = mesh_lib.make_mesh(world, 1, device_type=dev_type)
    for frames in spec["tick_frames"]:
        eng = StreamingEngine(model, slots=spec["slots"], mode="linear", stage_dtype="uint8",
                              mesh=data)
        ops.reset_launches()
        feats, ticks = engine_run(eng, spec["clips"], frames, spec["burst_ticks"])
        if dev_type == "cuda":
            torch.cuda.synchronize()
        out["engine"][frames] = {"feats": feats, "ticks": ticks, "launches": dict(ops.LAUNCHES),
                                 "local_slots": eng._local}
        del eng
    if not spec["export_layers"]:
        return out
    tp = mesh_lib.make_mesh(1, world, device_type=dev_type)
    cfg = model.cfg.replace(num_hidden_layers=spec["export_layers"])
    cut = encoder.StreamformerEncoder(cfg, device=model.device)
    cut.load_state_dict({k: v for k, v in model.state_dict().items() if k in cut.state_dict()})
    sharding.shard_encoder(cut, tp.get_group("model"))
    b, t = video.shape[:2]
    prog = EX.load_exported(EX.export_sharded_forward(cfg, b, tp, t), device=dev_type, mesh=tp)
    px = video.to(encoder.compute_dtype(cfg))
    ops.reset_launches()
    got = prog(cut.state_dict(), px)
    if dev_type == "cuda":
        torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    live = encoder.model_forward(cut, px)
    out["export"] = {"mesh": prog.metadata["mesh"], "launches": launches,
                     "vs_live": {k: (got[k].float() - live[k].float()).abs().max().item()
                                 for k in ("last_hidden_state", "pooler_output")},
                     **{k: got[k].cpu() for k in ("last_hidden_state", "pooler_output")}}
    return out


def run_rank(rank: int, world: int, port: int, ckpt: str, video_path: str, out_dir: str,
             capacity: int = 16, cache_dtypes: Sequence[str] = ("float",),
             device: str = "cuda", backend: str = "gloo", serve: str = None) -> None:
    """One rank: the stream of ``video_path``'s (B, T, 3, H, W) clip on a
    cache of each of ``cache_dtypes`` ("float": the compute dtype; "int8"),
    after two frames on a cache of its own to warm up, the pooled outputs,
    launch counts and seconds written to ``out_dir/rank<r>.pt``. With
    ``serve`` (a ``torch.save``d dict: ``clips``, ``slots``, ``tick_frames``,
    ``burst_ticks``, ``export_layers``) first the engine over the data axis
    and the sharded export (``_serve``), under the key "serve"."""
    from streamformer_tpu_torch.checkpoint import from_pretrained
    from streamformer_tpu_torch.models import encoder
    from streamformer_tpu_torch.ops import attention as ops
    from streamformer_tpu_torch.parallel import mesh as mesh_lib
    from streamformer_tpu_torch.parallel import sharding

    nccl = backend == "nccl"  # a card a rank; else gloo, the ranks on ``device``
    own = mesh_lib.init_distributed(f"localhost:{port}", world, rank,
                                    device="cuda" if nccl else "cpu")
    try:
        if torch.distributed.get_backend() != backend:
            raise RuntimeError(f"the ranks run {torch.distributed.get_backend()}, not {backend}")
        model = from_pretrained(ckpt, device=own if nccl else device)
        video = torch.load(video_path).to(model.device)
        results = {}
        if serve:
            results["serve"] = _serve(model, video, world,
                                      torch.load(serve, weights_only=False))
        mesh = mesh_lib.make_mesh(1, world)
        sharding.shard_encoder(model, mesh.get_group("model"))
        b, t = video.shape[:2]
        for name in cache_dtypes:
            cfg = model.cfg.replace(cache_mode="ring", cache_capacity=capacity,
                                    cache_dtype=None if name == "float" else name)
            cache = encoder.init_cache(cfg, b, device=model.device,
                                       shards=encoder.cache_shards(model))
            warm = encoder.init_cache(cfg, b, device=model.device,
                                      shards=encoder.cache_shards(model))
            for i in range(2):  # the groups' communicators, the kernels, the GEMMs' plans
                encoder.streaming_forward(model, video[:, i:i + 1], warm, cfg=cfg)
            del warm
            if model.device.type == "cuda":
                torch.cuda.synchronize()
            mesh_lib.barrier()
            ops.reset_launches()
            t0 = time.perf_counter()
            pooled = []
            for i in range(t):
                out, cache = encoder.streaming_forward(model, video[:, i:i + 1], cache, cfg=cfg)
                pooled.append(out["pooler_output"])
            if model.device.type == "cuda":
                torch.cuda.synchronize()
            results[name] = {"pooled": torch.cat(pooled, 1).float().cpu(),
                             "launches": dict(ops.LAUNCHES),
                             "seconds": time.perf_counter() - t0,
                             "width": cache["layers"][0]["k"].shape[-1]}
            del cache
        torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
        mesh_lib.barrier()
    finally:
        mesh_lib.shutdown()


def launch(world: int, ckpt: str, video_path: str, out_dir: str, capacity: int = 16,
           cache_dtypes: Sequence[str] = ("float",), device: str = "cuda",
           timeout: float = 600, backend: str = "gloo", serve: str = None) -> List[dict]:
    """Run the ranks as subprocesses of this Python; returns each rank's
    results (a dict by cache dtype, and "serve" with ``serve``), or raises
    ``RuntimeError`` with a failed rank's output."""
    from streamformer_tpu_torch.parallel import mesh as mesh_lib

    mesh_lib.run_ranks(["-m", "streamformer_tpu_torch.tools.tp_stream", "--ckpt", ckpt,
                        "--video", video_path, "--out", out_dir, "--capacity", str(capacity),
                        "--device", device, "--cache_dtypes", ",".join(cache_dtypes),
                        "--backend", backend] + (["--serve", serve] if serve else []),
                       world, timeout)
    # the ranks' own results (numpy features among them), not a foreign checkpoint
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ckpt", required=True, help="a checkpoint directory (from_pretrained)")
    p.add_argument("--video", required=True, help="a (B, T, 3, H, W) tensor saved by torch.save")
    p.add_argument("--out", required=True, help="the directory each rank writes its results to")
    p.add_argument("--world", type=int, default=2)
    p.add_argument("--rank", type=int, default=None, help="run this rank (else launch them all)")
    p.add_argument("--port", type=int, default=None)
    p.add_argument("--capacity", type=int, default=16)
    p.add_argument("--cache_dtypes", default="float", help="float, int8, or both: float,int8")
    p.add_argument("--device", default="cuda")
    p.add_argument("--backend", default="gloo", help="gloo (the ranks share --device) or nccl")
    p.add_argument("--serve", default=None,
                   help="also run the engine over the data axis and the sharded export on "
                        "this torch.save'd spec (clips, slots, tick_frames, burst_ticks, "
                        "export_layers)")
    p.add_argument("--reference", action="store_true",
                   help="also stream in one process and print each rank's distance from it")
    args = p.parse_args(argv)
    dtypes = args.cache_dtypes.split(",")
    if args.rank is not None:
        run_rank(args.rank, args.world, args.port, args.ckpt, args.video, args.out,
                 args.capacity, dtypes, args.device, args.backend, args.serve)
        return
    ranks = launch(args.world, args.ckpt, args.video, args.out, args.capacity, dtypes,
                   args.device, backend=args.backend, serve=args.serve)
    one = {}
    if args.reference:
        from streamformer_tpu_torch.checkpoint import from_pretrained

        model = from_pretrained(args.ckpt, device=args.device)
        one = reference(model, torch.load(args.video).to(model.device), args.capacity, dtypes)
    for r, res in enumerate(ranks):
        res.pop("serve", None)
        for name, got in res.items():
            line = {"rank": r, "world": args.world, "backend": args.backend, "cache": name,
                    "frames": got["pooled"].shape[1], "seconds": got["seconds"],
                    "launches": {k: v for k, v in got["launches"].items() if v}}
            if name in one:
                want, secs = one[name]
                line.update(max_abs=(got["pooled"] - want).abs().max().item(),
                            cosine=torch.nn.functional.cosine_similarity(
                                got["pooled"].flatten(), want.flatten(), dim=0).item(),
                            one_process_seconds=secs)
            print(json.dumps(line))


def reference(model, video: torch.Tensor, capacity: int,
              cache_dtypes: Sequence[str]) -> dict:
    """The same streams in one process, on ``model`` (whole) and ``video``
    on its device: cache dtype -> (pooled (B, T, D) on the CPU, seconds of
    the stream after one warm-up stream)."""
    from streamformer_tpu_torch.models import encoder

    out = {}
    for name in cache_dtypes:
        cfg = model.cfg.replace(cache_mode="ring", cache_capacity=capacity,
                                cache_dtype=None if name == "float" else name)
        for _ in range(2):
            cache = encoder.init_cache(cfg, video.shape[0], device=model.device)
            if model.device.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            pooled = torch.cat([encoder.streaming_forward(model, video[:, i:i + 1], cache,
                                                          cfg=cfg)[0]["pooler_output"]
                                for i in range(video.shape[1])], 1)
            if model.device.type == "cuda":
                torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            del cache
        out[name] = (pooled.float().cpu(), seconds)
    return out

if __name__ == "__main__":
    main()
