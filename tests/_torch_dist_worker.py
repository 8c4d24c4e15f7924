"""Rank entry points of the port's multi-process CPU tests
(``tests/test_torch_parallel.py``, ``test_torch_dist_train.py``,
``test_torch_dist_cli.py``, ``test_torch_dist_serve.py``).

The test writes its inputs to a directory, then ``launch`` starts one
process per rank through ``parallel.mesh.run_ranks``, ``python
tests/_torch_dist_worker.py <case> <dir> --rank <r> --world <n> --port
<p>``: each joins a gloo process group on localhost, runs the case on one
thread, and writes ``<case>_<rank>.pt`` for the test to hold against the
JAX package and the one-process port. This module imports torch and the
port only, never JAX.
"""

import argparse
import os
import shutil
import sys

import numpy as np
import torch

from streamformer_tpu_torch.parallel.mesh import free_port, run_ranks  # noqa: F401 (free_port:
# the tests' own coordinators)


def launch(case: str, world: int, out_dir: str, timeout: float = 300) -> list:
    """Run ``case`` on ``world`` ranks; returns each rank's results."""
    return start(case, world, out_dir, timeout)()


def start(case: str, world: int, out_dir: str, timeout: float = 300):
    """Start ``case`` on ``world`` ranks; returns a function that waits for
    them and returns each rank's results (the caller works meanwhile)."""
    join = run_ranks([os.path.abspath(__file__), case, out_dir], world, timeout,
                     env={"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
                          "STREAMFORMER_ALLOW_HASH_TOKENIZER": "1"}, wait=False)

    def results() -> list:
        join()
        return [torch.load(os.path.join(out_dir, f"{case}_{r}.pt"), weights_only=False)
                for r in range(world)]

    return results


# --------------------------------------------------------------------------
# helpers run on the ranks
# --------------------------------------------------------------------------


def _full_grads(model, data_group=None):
    """Every parameter's whole gradient (zeros where none): shards gathered
    over their model group, partial sums summed over it, then the sum over
    the data group."""
    import torch.distributed as dist

    from streamformer_tpu_torch.parallel import sharding

    out = {}
    for name, p in model.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        par = getattr(p, "tp_partial", None)
        if par is not None:
            g = g.clone()
            dist.all_reduce(g, group=par.group)
        g = sharding.full_tensor(g, sharding.shard_info(p))
        if data_group is not None:
            g = g.clone()
            dist.all_reduce(g, group=data_group)
        out[name] = g.detach().clone()
    return out


def _full_params(model):
    from streamformer_tpu_torch.parallel import sharding

    return {n: sharding.full_tensor(p.detach(), sharding.shard_info(p)).clone()
            for n, p in model.named_parameters()}


def _encoder(cfg, state):
    from streamformer_tpu_torch.models import encoder

    model = encoder.StreamformerEncoder(cfg, device="cpu", trainable=True)
    model.load_state_dict(state)
    return model


# --------------------------------------------------------------------------
# cases
# --------------------------------------------------------------------------


def case_parallel(rank, world, inp):
    """The ring loss, the gathered features and heads at world 2, 3 and 4;
    the tensor-parallel encoder (mp=2, with and without sequence
    parallelism) forward and gradients; the pipeline (pipe 4, and pipe 2 x
    data 2) forward and gradients, and its dropout."""
    import torch.distributed as dist

    from streamformer_tpu_torch.config import StreamformerConfig
    from streamformer_tpu_torch.models import encoder, heads
    from streamformer_tpu_torch.parallel import contrastive, pipeline, sharding
    from streamformer_tpu_torch.parallel.mesh import make_mesh, make_pipeline_mesh

    res = {}
    b = inp["per_rank"]
    scale, bias = torch.tensor(10.0), torch.tensor(-2.0)
    for w in (2, 3, 4):
        group = dist.new_group(list(range(w)))
        if rank >= w:
            continue
        rows = slice(rank * b, (rank + 1) * b)
        img = inp["img"][rows].clone().requires_grad_()
        txt = inp["txt"][rows].clone().requires_grad_()
        loss = contrastive.siglip_ring_loss(img, txt, scale, bias, group)
        loss.backward()
        x = inp["img"][rows].clone().requires_grad_()
        gathered = contrastive.all_gather_features(x, group)
        (gathered * inp["gather_w"][:w * b]).sum().backward()
        pooler = inp["pooler"][rows].clone().requires_grad_()
        text = inp["text"][rows].clone().requires_grad_()
        ls, lb = (torch.tensor(float(np.log(10.0)), requires_grad=True),
                  torch.tensor(-2.0, requires_grad=True))
        g_loss, _ = heads.grounding_contrastive_head(pooler, text, inp["frame_labels"][rows],
                                                     ls, lb, group=group)
        g_loss.backward()
        last = inp["last"][rows].clone().requires_grad_()
        rv_text = inp["text"][rows].clone().requires_grad_()
        rs, rb = (torch.tensor(float(np.log(10.0)), requires_grad=True),
                  torch.tensor(-2.0, requires_grad=True))
        r_loss, _ = heads.refervos_contrastive_head(last, inp["proj"], rv_text,
                                                    inp["mask_target"][rows], rs, rb, group=group)
        r_loss.backward()
        res[f"world{w}"] = {
            "ring": (loss.detach(), img.grad, txt.grad), "gather": (gathered.detach(), x.grad),
            "grounding": (g_loss.detach(), pooler.grad, text.grad, ls.grad, lb.grad),
            "refervos": (r_loss.detach(), last.grad, rv_text.grad, rs.grad, rb.grad),
            "rank": contrastive.axis_rank(group)}

    for tag, shard_patches in (("tp", False), ("sp", True)):
        cfg = StreamformerConfig(**inp[f"{tag}_cfg"]).replace(shard_patches=shard_patches)
        mesh = make_mesh(2, 2)
        model = sharding.shard_encoder(_encoder(cfg, inp[f"{tag}_state"]), mesh.get_group("model"),
                                       shard_patches)
        px = inp[f"{tag}_px"]
        n = px.shape[0] // 2
        d_rank = mesh.get_local_rank("data")
        out = encoder.model_forward(model, px[d_rank * n:(d_rank + 1) * n])
        (out["pooler_output"] ** 2).sum().backward()
        res[tag] = {"pooler": out["pooler_output"].detach(), "data_rank": d_rank,
                    "grads": _full_grads(model, mesh.get_group("data")),
                    "qkv": model.encoder.layer[0].attention.attention.qkv.weight.detach().clone(),
                    "model_rank": mesh.get_local_rank("model")}

    cfg = StreamformerConfig(**inp["pp_cfg"])
    for data, pipe in ((1, 4), (2, 2)):
        mesh = make_pipeline_mesh(data, pipe)
        model = _encoder(cfg, inp["pp_state"])
        stage = pipeline.place_pipeline_params(model, mesh)
        px = inp["pp_px"]
        n = px.shape[0] // data
        d_rank = mesh.get_local_rank("data")
        out = pipeline.model_forward_pp(model, px[d_rank * n:(d_rank + 1) * n], mesh=mesh,
                                        num_microbatches=2, stage=stage)
        (out["pooler_output"] ** 2).sum().backward()
        data_group = mesh.get_group("data") if data > 1 else None
        grads = {}
        for name, p in model.named_parameters():
            g = p.grad.clone()
            if data_group is not None:
                dist.all_reduce(g, group=data_group)
            grads[name] = g
        res[f"pp{pipe}"] = {"pooler": out["pooler_output"].detach(),
                            "last": out["last_hidden_state"].detach(), "data_rank": d_rank,
                            "grads": grads}
    # dropout: four equal rows, two microbatches of two, keyed by row
    mesh = make_pipeline_mesh(2, 2)
    drop_cfg = cfg.replace(hidden_dropout_prob=0.3, drop_path_rate=0.2)
    model = _encoder(drop_cfg, inp["pp_state"])
    stages, _ = pipeline.stack_pipeline_params(model, 2)
    x = inp["pp_rows"]
    got = pipeline.pipelined_trunk(stages, x, drop_cfg, mesh=mesh, num_microbatches=2,
                                   generator=torch.Generator().manual_seed(7),
                                   deterministic=False)
    want = encoder.run_layers(model.encoder.layer, x, drop_cfg,
                              generator=torch.Generator().manual_seed(7), deterministic=False)
    res["pp_dropout"] = {"got": got.detach(), "want": want.detach()}
    return res


class LossLog:
    """A log writer that keeps each micro-step's loss."""

    def __init__(self):
        self.losses = []

    def set_step(self):
        pass

    def update(self, head="", **kw):
        if head == "loss":
            self.losses.extend(kw.values())


def train_run(inp, mesh, opt, rates=None, generator=None, stream=None, restore=None,
              save=None):
    """``MultitaskTrainer.train_one_epoch`` over ``stream`` (the global
    batches of ``inp``), the model sharded over ``mesh``'s model dim when it
    has one; returns (whole parameters, losses, stats). ``restore`` and
    ``save`` name a checkpoint directory to start from and to end in. Also
    the one-process run (``mesh`` None)."""
    from streamformer_tpu_torch.config import StreamformerConfig
    from streamformer_tpu_torch.models.multitask import MultitaskModel
    from streamformer_tpu_torch.models.text_encoder import SiglipTextConfig
    from streamformer_tpu_torch.parallel.sharding import shard_model
    from streamformer_tpu_torch.train import checkpoint, optim
    from streamformer_tpu_torch.train.trainer import MultitaskTrainer, TrainState

    cfg = StreamformerConfig(**dict(inp["kw"], **(rates or {})))
    model = MultitaskModel(cfg, inp["tasks"], SiglipTextConfig(**inp["text_kw"]), device="cpu",
                           generator=torch.Generator().manual_seed(0))
    model.load_state_dict(inp["state"])
    shard_model(model, mesh)
    tx = optim.create_optimizer(model, optim.cosine_lr_schedule(**inp["lr"]),
                                trainable_mask=optim.trainable_mask_frozen_text(model),
                                opt_name=opt, **inp["common"])
    if restore is not None:
        checkpoint.restore_checkpoint(restore, 0, model, tx)
    trainer = MultitaskTrainer(model, tx, update_freq=2, mesh=mesh)
    state = TrainState.create(model, tx)
    log = LossLog()
    batches = [(task, trainer.shard_batch(task, inp["batches"][i]) if mesh else inp["batches"][i])
               for task, i in (stream or inp["stream"])]
    state, stats = trainer.train_one_epoch(state, iter(batches), 0, generator, log_writer=log,
                                           print_freq=len(batches))
    if save is not None:
        checkpoint.save_checkpoint(save, 0, model, tx, step=state.step)
    return _full_params(model), log.losses, stats


def accumulated_grads(inp, mesh, shard_patches):
    """The trainer's accumulated gradients after a classification and a
    retrieval micro-step and the update's sync (``_sync_gradients``), whole;
    LoRA on, its B products and the gates opened, dropout and stochastic
    depth at 0.1."""
    from streamformer_tpu_torch.config import StreamformerConfig
    from streamformer_tpu_torch.models.multitask import MultitaskModel
    from streamformer_tpu_torch.models.text_encoder import SiglipTextConfig
    from streamformer_tpu_torch.parallel import sharding
    from streamformer_tpu_torch.train import optim
    from streamformer_tpu_torch.train.trainer import MultitaskTrainer, TrainState

    cfg = StreamformerConfig(**dict(inp["kw"], **inp["rates"], add_lora_spatial=True, lora_rank=4,
                                    shard_patches=shard_patches))
    model = MultitaskModel(cfg, inp["tasks"], SiglipTextConfig(**inp["text_kw"]), device="cpu",
                           generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in model.backbone.named_parameters():
            if "lora_b" in name or name.endswith("gating"):
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
    sharding.shard_model(model, mesh)
    tx = optim.create_optimizer(model, lambda count: 0.0, weight_decay=0.0, opt_name="sgd",
                                trainable_mask=optim.trainable_mask_frozen_text(model))
    trainer = MultitaskTrainer(model, tx, update_freq=2, mesh=mesh)
    state = TrainState.create(model, tx)
    for task, i in (("Kinetics", 0), ("MSRVTT", 1)):
        batch = trainer.shard_batch(task, inp["batches"][i]) if mesh else inp["batches"][i]
        state, _ = trainer.step_fn(task, False)(state, batch["pixel_values"], batch["task_input"],
                                                torch.Generator().manual_seed(5 + i))
    trainer._sync_gradients(state)
    params = dict(model.named_parameters())
    return {n: sharding.full_tensor(g, sharding.shard_info(params[n])).clone()
            for n, g in state.grad_accum.items()}


def case_train(rank, world, inp):
    """The trainer at data=2 x model=2 (SGD, AdamW, SGD with dropout and
    stochastic depth), a checkpoint saved there and restored at data=4; the
    synced gradients with LoRA, with and without sequence parallelism."""
    from streamformer_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(2, 2)
    res = {"sgd": train_run(inp, mesh, "sgd"),
           "adamw": train_run(inp, mesh, "adamw", save=inp["ckpt"]),
           "dropout": train_run(inp, mesh, "sgd", rates=inp["rates"],
                                generator=torch.Generator().manual_seed(7))}
    res["resumed"] = train_run(inp, make_mesh(4, 1), "adamw", stream=inp["more"],
                               restore=inp["ckpt"])
    for shard_patches in (False, True):
        res[f"grads_sp{int(shard_patches)}"] = accumulated_grads(inp, mesh, shard_patches)
    return res


def case_cli(rank, world, port, out_dir):
    """``train/run.py --distributed`` at data=2 (one epoch), then the same
    output's next epoch at model=2, resumed from the first's checkpoint."""
    from streamformer_tpu_torch.train import run

    inp = torch.load(os.path.join(out_dir, "cli_inputs.pt"), weights_only=False)
    first, second = inp["dirs"]

    def argv(out, epochs, port, extra):
        return inp["argv"] + ["--output_dir", out, "--epochs", str(epochs), "--distributed",
                              "--coordinator_address", f"localhost:{port}", "--num_processes",
                              str(world), "--process_id", str(rank)] + extra

    run.main(argv(first, 1, port, ["--dp", "2"]))
    if rank == 0:
        shutil.copytree(os.path.join(first, "checkpoint-0"),
                        os.path.join(second, "checkpoint-0"))
    run.main(argv(second, 2, inp["port"], ["--mp", "2"]))
    return {}


def _stream_tp(model, cfg, video, calls, *, ragged=False, new_valid=None, reset=None):
    """``streaming_forward`` of ``video`` in calls of the given frame counts
    on ``model``'s cache (the rank's heads when it is cut); returns each
    call's outputs and the cache."""
    from streamformer_tpu_torch.models import encoder

    cache = encoder.init_cache(cfg, video.shape[0], per_stream_len=ragged, device="cpu",
                               shards=encoder.cache_shards(model))
    outs, lo = [], 0
    for i, t in enumerate(calls):
        valid = None if new_valid is None else torch.tensor(new_valid[i], dtype=torch.int32)
        out, cache = encoder.streaming_forward(model, video[:, lo:lo + t], cache, cfg=cfg,
                                               new_valid=valid)
        outs.append({k: v.clone() for k, v in out.items()})
        lo += t
        if i == 0 and reset is not None:
            encoder.reset_streams(cache, torch.tensor(reset))
    return outs, cache


class CollectiveCount:
    """Counts the calls of ``torch.distributed``'s collectives while on."""

    NAMES = ("broadcast", "all_reduce", "all_gather", "all_gather_into_tensor",
             "reduce_scatter_tensor", "barrier", "send", "recv", "isend", "irecv")

    def __init__(self):
        import torch.distributed as dist

        self.dist, self.calls, self.saved = dist, [], {}

    def __enter__(self):
        for name in self.NAMES:
            fn = getattr(self.dist, name)
            self.saved[name] = fn

            def counted(*a, _fn=fn, _name=name, **k):
                self.calls.append(_name)
                return _fn(*a, **k)

            setattr(self.dist, name, counted)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.dist, name, fn)


def _serve_engine(model, clips, mesh, **kw):
    """JAX ``test_serving.py``'s churn: every stream opened and fed its first
    half, then its second half and closed, run to idle. Returns each
    stream's features and the collectives the ticks and the polls called."""
    from streamformer_tpu_torch.serving import StreamingEngine

    eng = StreamingEngine(model, slots=4, stage_dtype="uint8", mode="linear", mesh=mesh, **kw)
    sids = {}
    for i, c in clips.items():
        sids[i] = eng.open()
        eng.feed(sids[i], c[: len(c) // 2])
    for i, c in clips.items():
        eng.feed(sids[i], c[len(c) // 2:])
        eng.close(sids[i])
    with CollectiveCount() as ticks:
        n = eng.run_until_idle()
    with CollectiveCount() as polls:
        feats = {i: eng.poll(s)[0] for i, s in sids.items()}
    return {"feats": feats, "ticks": n, "tick_calls": ticks.calls, "poll_calls": polls.calls,
            "forwards": eng.forwards}


def _decode(model, prompts, mesh, **kw):
    from streamformer_tpu_torch.lm_serving import DecodeEngine

    eng = DecodeEngine(model, slots=4, capacity=24, max_new_tokens=5, prefill_buckets=(4, 8),
                       mesh=mesh, **kw)
    sids = [eng.open_tokens(p) for p in prompts]
    eng.run_until_idle()
    out = []
    for sid in sids:
        toks, done = eng.poll(sid)
        assert done, sid
        out.append(toks)
    return out


def case_serve(rank, world, inp):
    """Serving over two ranks: the tensor-parallel stream (mesh (1, 2):
    linear, ring, ragged with ``new_valid``, row-major, int8, sequence
    parallel), ``space_only`` and ``joint_space_time`` under tensor
    parallelism forward and backward, ``StreamingEngine`` over the data axis
    (mesh (2, 1), float and int8, the collectives of its ticks and polls
    counted), the tensor-parallel LM forward and ragged step, ``DecodeEngine``
    over (2, 1) and (1, 2), and ``export_sharded_forward`` at (1, 2)."""
    from streamformer_tpu_torch import export as EX
    from streamformer_tpu_torch.config import StreamformerConfig
    from streamformer_tpu_torch.models import encoder
    from streamformer_tpu_torch.models import language_model as LM
    from streamformer_tpu_torch.parallel import sharding
    from streamformer_tpu_torch.parallel.mesh import make_mesh

    tp, dp = make_mesh(1, 2), make_mesh(2, 1)
    group = tp.get_group("model")
    res = {"model_rank": tp.get_local_rank("model")}
    video = inp["video"]

    def tp_encoder(cfg, trainable=False, shard_patches=False):
        model = encoder.StreamformerEncoder(cfg, device="cpu", trainable=trainable)
        model.load_state_dict({k: inp["enc_state"][k] for k in model.state_dict()})
        return sharding.shard_encoder(model, group, shard_patches)

    base = StreamformerConfig(**inp["enc_kw"])
    res["streams"] = {}
    for name, case in inp["streams"].items():
        cfg = base.replace(**case["cfg"])
        model = tp_encoder(cfg, shard_patches=case.get("shard_patches", False))
        outs, cache = _stream_tp(model, cfg, video, case["calls"], ragged=case.get("ragged", False),
                                 new_valid=case.get("new_valid"), reset=case.get("reset"))
        res["streams"][name] = {"outs": outs, "cache": cache}

    res["attention_types"] = {}
    for kind in ("space_only", "joint_space_time"):
        model = tp_encoder(base.replace(attention_type=kind), trainable=True)
        out = encoder.model_forward(model, video[:, :4])
        (out["pooler_output"] ** 2).sum().backward()
        res["attention_types"][kind] = {"pooler": out["pooler_output"].detach(),
                                        "hidden": out["last_hidden_state"].detach(),
                                        "grads": _full_grads(model)}

    x = inp["quantize"]
    half = x.shape[1] // 2
    mine = x[:, res["model_rank"] * half:(res["model_rank"] + 1) * half]
    par = sharding.TensorParallel(group, 2, res["model_rank"])
    res["quantize"] = (*sharding.quantize_rows(mine, par),
                       sharding.quantize_rows(mine, None)[1])

    res["engine"] = {}
    for tag, over in (("float", {}), ("int8", {"cache_dtype": "int8"})):
        whole = encoder.StreamformerEncoder(base.replace(**over), device="cpu")
        whole.load_state_dict(inp["enc_state"])
        res["engine"][tag] = _serve_engine(whole, inp["clips"], dp)
    from streamformer_tpu_torch.serving import StreamingEngine

    res["refusals"] = {}
    for tag, make in (("cut", lambda: StreamingEngine(tp_encoder(base), slots=4, mesh=dp)),
                      ("slots", lambda: StreamingEngine(whole, slots=3, mesh=dp))):
        try:
            make()
            res["refusals"][tag] = ""
        except ValueError as e:
            res["refusals"][tag] = str(e)

    lm_cfg = LM.LMConfig(**inp["lm_kw"])

    def lm_model(cut):
        model = LM.LanguageModel(lm_cfg, device="cpu")
        model.load_state_dict(inp["lm_state"])
        return sharding.shard_lm(model, group) if cut else model

    lm = lm_model(True)
    ids = inp["lm_ids"]
    cache = LM.init_cache(lm_cfg, ids.shape[0], 16, device="cpu",
                          kv_heads=LM.local_kv_heads(lm))
    first, cache = LM.forward(lm, LM.embed_tokens(lm, ids), cache=cache)
    step, cache = LM.forward(lm, LM.embed_tokens(lm, ids[:, -1:]), cache=cache)
    ragged = LM.init_cache(lm_cfg, 2, 16, per_stream_len=True, device="cpu",
                           kv_heads=LM.local_kv_heads(lm))
    ragged["len"] = torch.tensor([3, 5])
    r_out, ragged = LM.forward(lm, LM.embed_tokens(lm, ids[:, :1]), cache=ragged)
    res["lm"] = {"first": first["logits"], "step": step["logits"], "ragged": r_out["logits"],
                 "kv_heads": LM.local_kv_heads(lm),
                 "embed_rows": lm.model.embed_tokens.weight.shape[0]}
    prompts = inp["prompts"]
    res["decode"] = {
        "dp_greedy": _decode(lm_model(False), prompts, dp),
        "dp_int4": _decode(lm_model(False), prompts, dp, cache_dtype="int4"),
        "tp_greedy": _decode(lm, prompts, tp),
        "tp_int4": _decode(lm, prompts, tp, cache_dtype="int4"),
        "tp_sampled": _decode(lm, prompts, tp, temperature=0.8, seed=3),
        "tp_top_k": _decode(lm, prompts, tp, temperature=0.8, top_k=5, seed=3),
        "dp_eos_each_token": _decode(lm_model(False), prompts, dp, **inp["eos_each"]),
        "dp_eos_lazy": _decode(lm_model(False), prompts, dp, **inp["eos_lazy"]),
    }

    blob = EX.export_sharded_forward(base, 2, tp, num_frames=4)
    prog = EX.load_exported(blob, device="cpu", mesh=tp)
    model = tp_encoder(base)
    res["export"] = {"got": prog(model.state_dict(), video[:, :4]),
                     "live": encoder.model_forward(model, video[:, :4]),
                     "mesh": prog.metadata["mesh"]}
    try:
        EX.load_exported(blob, device="cpu", mesh=dp)
        res["export"]["refused"] = None
    except ValueError as e:
        res["export"]["refused"] = str(e)
    return res


CASES = {"parallel": case_parallel, "train": case_train, "cli": case_cli, "serve": case_serve}


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("case", choices=list(CASES))
    p.add_argument("out_dir")
    for flag in ("--rank", "--world", "--port"):
        p.add_argument(flag, type=int, required=True)
    args = p.parse_args()
    case, rank, world, port, out_dir = args.case, args.rank, args.world, args.port, args.out_dir
    torch.set_num_threads(1)
    import torch.distributed as dist

    if case.startswith("cli"):
        sys.modules["transformers"] = None  # the hash tokenizer, without a slow lookup
        res = CASES[case](rank, world, int(port), out_dir)
    else:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                                world_size=world)
        inp = torch.load(os.path.join(out_dir, f"{case}_inputs.pt"), weights_only=False)
        res = CASES[case](rank, world, inp)
        dist.barrier()
        dist.destroy_process_group()
    torch.save(res, os.path.join(out_dir, f"{case}_{rank}.pt"))


if __name__ == "__main__":
    main()
