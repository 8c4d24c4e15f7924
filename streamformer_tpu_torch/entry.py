"""Entry points: the flagship forward on one card, and a multi-process dry
run of the distributed paths.

The port's counterpart of the JAX package's ``__graft_entry__.py``:

* ``entry()`` returns ``(fn, example_args)``: the flagship full-clip forward
  (224², 16 frames, 768 hidden, 12 layers of 12 heads, bf16) on the card;
* ``dryrun_multiprocess(n)`` starts ``n`` ranks at a tiny width, NCCL with
  a card a rank (gloo on the CPU when the caller names ``device="cpu"``),
  and runs, SPMD as under ``torchrun``, the JAX dry run's regimes 1-4c in
  PyTorch, each held to the same computation in one process: the data x
  tensor-parallel training step, the tensor-parallel lockstep and ragged
  streams, ``StreamingEngine`` over the mesh, the tensor-parallel LM's
  lockstep and ragged decode steps, ``DecodeEngine`` over the mesh, and
  ``export_sharded_forward``.

    python -m streamformer_tpu_torch.entry --dryrun 4                # 4 cards; non-zero on a mismatch
    python -m streamformer_tpu_torch.entry --dryrun 2 --device cpu   # 2 gloo ranks on the CPU
"""

from __future__ import annotations

import argparse
from typing import Callable, Tuple

import numpy as np
import torch

def entry(device=None) -> Tuple[Callable, tuple]:
    """``(fn, (model, pixel_values))``: ``fn(model, pixel_values)`` is the
    flagship full-clip forward's pooled output (B, T, D), the model seeded
    random weights, the pixels a (1, 16, 3, 224, 224) bf16 clip of zeros,
    both on the card unless ``device`` names another."""
    from streamformer_tpu_torch import export as EX
    from streamformer_tpu_torch.config import StreamformerConfig
    from streamformer_tpu_torch.models import encoder

    cfg = StreamformerConfig(dtype="bfloat16")
    model = encoder.StreamformerEncoder(cfg, device=device,
                                        generator=torch.Generator().manual_seed(0))

    def fwd(model, pixel_values):
        with torch.no_grad():
            return encoder.model_forward(model, pixel_values)["pooler_output"]

    px = torch.zeros(1, cfg.num_frames, cfg.num_channels, cfg.image_size, cfg.image_size,
                     dtype=torch.bfloat16, device=model.device)
    return fwd, (model, px)


# --------------------------------------------------------------------------
# The multi-process dry run
# --------------------------------------------------------------------------

TINY = dict(image_size=32, patch_size=16, num_frames=4, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=128, dtype="float32", cache_capacity=8)
TINY_LM = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
               rope_theta=10000.0, tie_word_embeddings=False, attention_bias=True,
               dtype="float32")
TOL = 1e-5  # fp32: a row-parallel product's partial sums are added in another order


def dryrun_multiprocess(n: int, timeout: float = 600, device: str = "cuda") -> None:
    """Run the dry run on ``n`` ranks (subprocesses of this Python): NCCL, a
    card each, unless ``device`` names the CPU (gloo, one thread a rank).
    Raises ``RuntimeError`` when fewer than ``n`` cards are present, or with
    the failing ranks' output when any rank fails or a regime's result
    differs from one process's."""
    from streamformer_tpu_torch.parallel import mesh as mesh_lib

    if torch.device(device).type == "cuda" and torch.cuda.device_count() < n:
        raise RuntimeError(f"the dry run on {n} NCCL ranks needs {n} CUDA devices, found "
                           f"{torch.cuda.device_count()}; pass device='cpu' (--device cpu) to "
                           "run it over gloo on the CPU")

    logs = mesh_lib.run_ranks(["-m", "streamformer_tpu_torch.entry", "--device", device], n,
                              timeout, env={"OMP_NUM_THREADS": "1"})
    print(logs[0].strip().splitlines()[-1])


def _check(what: str, got, want, tol: float = TOL) -> None:
    err = (got.float() - want.float()).abs().max().item()
    if not err <= tol:
        raise AssertionError(f"{what}: max-abs {err} from one process (limit {tol})")


def _rank_main(rank: int, world: int, port: int, device: str = "cuda") -> None:
    """One rank of the dry run (every rank makes the same calls)."""
    import torch.distributed as dist

    from streamformer_tpu_torch import export as EX
    from streamformer_tpu_torch.config import StreamformerConfig
    from streamformer_tpu_torch.lm_serving import DecodeEngine
    from streamformer_tpu_torch.models import encoder
    from streamformer_tpu_torch.models import language_model as LM
    from streamformer_tpu_torch.parallel import mesh as mesh_lib
    from streamformer_tpu_torch.parallel import sharding
    from streamformer_tpu_torch.serving import StreamingEngine

    torch.set_num_threads(1)
    dev = mesh_lib.init_distributed(f"localhost:{port}", world, rank, device=device)
    try:
        mp = 2 if world % 2 == 0 else 1
        mesh = mesh_lib.make_mesh(world // mp, mp)
        group, data = mesh.get_group("model"), mesh.get_group("data")
        d_rank, dp = mesh_lib.dim_rank(mesh, "data"), mesh_lib.dim_size(mesh, "data")
        cfg = StreamformerConfig(**TINY)
        rng = np.random.default_rng(0)
        video = torch.from_numpy(rng.standard_normal((2 * dp, 6, 3, 32, 32)).astype(np.float32))
        video = video.to(dev)

        def make(trainable=False, cut=True, **over):
            m = encoder.StreamformerEncoder(cfg.replace(**over), device=dev,
                                            generator=torch.Generator().manual_seed(1),
                                            trainable=trainable)
            with torch.no_grad():
                for layer in m.encoder.layer:
                    layer.temporal_attention_gating.fill_(0.5)
            return sharding.shard_encoder(m, group) if cut else m

        # regime 1: the data x tensor-parallel training step (SGD on the mean
        # loss), every whole parameter against one process on the global batch
        lr, rows = 0.1, slice(2 * d_rank, 2 * d_rank + 2)
        model, whole = make(trainable=True), make(trainable=True, cut=False)
        for m, px, scale in ((model, video[rows, :4], 1.0 / dp), (whole, video[:, :4], 1.0)):
            loss = (encoder.model_forward(m, px)["pooler_output"] ** 2).mean() * scale
            loss.backward()
        wholes = dict(whole.named_parameters())
        with torch.no_grad():
            for name, p in model.named_parameters():
                w = wholes[name]
                g = p.grad.clone()
                if getattr(p, "tp_partial", None) is not None:
                    dist.all_reduce(g, group=group)
                if dp > 1:
                    dist.all_reduce(g, group=data)
                new = sharding.full_tensor(p - lr * g, sharding.shard_info(p))
                _check(f"training step: {name}", new, w - lr * w.grad)

        # regime 3: tensor-parallel lockstep (ring) and ragged streams
        for over, calls, ragged in (({"cache_mode": "ring", "cache_capacity": 4}, [1] * 6, False),
                                    ({}, [3, 1, 2], True)):
            outs = []
            for m in (make(**over), make(cut=False, **over)):
                c = m.init_cache(video.shape[0], per_stream_len=ragged)
                lo, got = 0, []
                for t in calls:
                    got.append(encoder.streaming_forward(m, video[:, lo:lo + t], c,
                                                         cfg=m.cfg)[0]["pooler_output"])
                    lo += t
                outs.append(torch.cat(got, 1))
            _check(f"tensor-parallel stream {over or 'ragged'}", *outs)

        # regime 3c: StreamingEngine over the data axis
        clips = {i: rng.integers(0, 256, (k, 3, 32, 32), dtype=np.uint8)
                 for i, k in enumerate([5, 3, 6, 2])}
        feats = []
        for m in (mesh, None):
            eng = StreamingEngine(make(cut=False), slots=2 * dp, stage_dtype="uint8",
                                  mode="linear", mesh=m)
            sids = {i: eng.open() for i in clips}
            for i, c in clips.items():
                eng.feed(sids[i], c)
                eng.close(sids[i])
            eng.run_until_idle(frames=2)
            feats.append(torch.cat([torch.from_numpy(eng.poll(s)[0]) for s in sids.values()]))
        _check("StreamingEngine over the mesh", *feats)

        # regime 4, 4b: the tensor-parallel LM, lockstep prompt and step, ragged step
        lm_cfg = LM.LMConfig(**TINY_LM)

        def lm(cut=True):
            m = LM.LanguageModel(lm_cfg, device="cpu", generator=torch.Generator().manual_seed(2))
            m.to(dev)
            return sharding.shard_lm(m, group) if cut else m

        ids = torch.from_numpy(rng.integers(0, 64, (2, 6))).to(dev)
        logits = []
        for m in (lm(), lm(False)):
            c = LM.init_cache(lm_cfg, 2, 16, device=dev, kv_heads=LM.local_kv_heads(m))
            a, c = LM.forward(m, LM.embed_tokens(m, ids), cache=c)
            b, c = LM.forward(m, LM.embed_tokens(m, ids[:, -1:]), cache=c)
            r = LM.init_cache(lm_cfg, 2, 16, per_stream_len=True, device=dev,
                              kv_heads=LM.local_kv_heads(m))
            r["len"] = torch.tensor([2, 5], device=dev)
            rr, _ = LM.forward(m, LM.embed_tokens(m, ids[:, :1]), cache=r)
            logits.append(torch.cat([a["logits"][:, -1], b["logits"][:, -1],
                                     rr["logits"][:, -1]]))
        _check("tensor-parallel LM decode", *logits)

        # regime 4c: DecodeEngine over the mesh (slots over data, the LM cut over model)
        prompts = [rng.integers(0, 64, (k,)) for k in (3, 7, 2, 6, 5)]
        tokens = []
        for m, msh in ((lm(), mesh), (lm(False), None)):
            eng = DecodeEngine(m, slots=2 * dp, capacity=24, max_new_tokens=4,
                               prefill_buckets=(4, 8), mesh=msh)
            sids = [eng.open_tokens(p) for p in prompts]
            eng.run_until_idle()
            tokens.append([eng.poll(s)[0] for s in sids])
        if tokens[0] != tokens[1]:
            raise AssertionError(f"DecodeEngine over the mesh: {tokens[0]} != {tokens[1]}")
        # regime 5: the full clip exported over the mesh, loaded on this rank's groups
        blob = EX.export_sharded_forward(cfg, 2 * dp, mesh, num_frames=4)
        prog = EX.load_exported(blob, device=dev.type, mesh=mesh)
        got = prog(make().state_dict(), video[rows, :4])["pooler_output"]
        _check("export_sharded_forward", got,
               encoder.model_forward(make(cut=False), video[:, :4])["pooler_output"])
        mesh_lib.barrier()
        print(f"dryrun_multiprocess OK on {world} {dist.get_backend()} ranks, mesh data={dp} x "
              f"model={mp}")
    finally:
        mesh_lib.shutdown()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dryrun", type=int, default=None, help="run the dry run on this many ranks")
    p.add_argument("--rank", type=int, default=None)
    p.add_argument("--world", type=int, default=None)
    p.add_argument("--port", type=int, default=None)
    p.add_argument("--device", default="cuda", help="cuda (NCCL, a card a rank) or cpu (gloo)")
    args = p.parse_args(argv)
    if args.rank is not None:
        _rank_main(args.rank, args.world, args.port, args.device)
    else:
        dryrun_multiprocess(args.dryrun or 2, device=args.device)


if __name__ == "__main__":
    main()
