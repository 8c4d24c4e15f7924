"""The port's training entry point against the JAX package: checkpoints
(save, restore, retention), the SigLIP weight surgery, the CLI on the CPU
with resume after SIGTERM, and the slice as a whole (an eval-mode loader
feeding the trainer in both packages).

Tolerances: copied SigLIP leaves equal to the JAX package's (carried across
by ``params_from_jax`` / ``text_params_from_jax``); the initialised encoder
within 1e-4 of ``SiglipVisionModel`` per frame (fp32); losses of the whole
slice within 1e-4 relative of the JAX trainer's; checkpoints, retention
and resumed runs equal bit for bit.
"""

import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from streamformer_tpu.checkpoint.siglip_init import init_from_siglip as jax_init_from_siglip
from streamformer_tpu.config import StreamformerConfig as JaxConfig
from streamformer_tpu.data import collate as jax_collate
from streamformer_tpu.data import samplers as jax_S
from streamformer_tpu.data.build import build_multi_task_dataset as jax_build
from streamformer_tpu.models.multitask import MultitaskModel as JaxMultitask
from streamformer_tpu.models.text_encoder import SiglipTextConfig as JaxTextConfig
from streamformer_tpu.train import checkpoint as jax_ckpt
from streamformer_tpu.train import optim as jax_optim
from streamformer_tpu.train.trainer import MultitaskTrainer as JaxTrainer
from streamformer_tpu.train.trainer import TrainState as JaxTrainState
from streamformer_tpu_torch.checkpoint import multitask_from_jax, params_from_jax, text_params_from_jax
from streamformer_tpu_torch.checkpoint.siglip_init import init_from_siglip, init_from_siglip_dir
from streamformer_tpu_torch.config import StreamformerConfig
from streamformer_tpu_torch.data import collate, samplers
from streamformer_tpu_torch.data.build import build_multi_task_dataset
from streamformer_tpu_torch.models import encoder
from streamformer_tpu_torch.models.multitask import MultitaskModel
from streamformer_tpu_torch.models.text_encoder import SiglipTextConfig, SiglipTextEncoder
from streamformer_tpu_torch.train import checkpoint as ckpt
from streamformer_tpu_torch.train import optim, run
from streamformer_tpu_torch.train import trainer as trainer_mod
from streamformer_tpu_torch.train.trainer import MultitaskTrainer, TrainState

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(image_size=32, patch_size=16, num_frames=4, hidden_size=32, num_hidden_layers=2,
          num_attention_heads=4, intermediate_size=64, dtype="float32")
TEXT_KW = dict(vocab_size=64, hidden_size=32, num_hidden_layers=1, num_attention_heads=4,
               intermediate_size=64, max_position_embeddings=8)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these tensors are tiny, and the 6-worker run
    oversubscribes the cores with each worker's default thread pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _write_video(path, n=12, h=48, w=64, seed=0):
    import cv2

    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10, (w, h))
    rng = np.random.default_rng(seed)
    for _ in range(n):
        vw.write(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    vw.release()


@pytest.fixture(scope="module")
def metadata(tmp_path_factory):
    """A YAML metadata file over cv2-written videos: a classification task
    (4 clips) and a grounding task (4 clips)."""
    root = tmp_path_factory.mktemp("train_run")
    vids = []
    for i in range(8):
        p = str(root / f"v{i}.avi")
        _write_video(p, seed=i)
        vids.append(p)
    cls = str(root / "cls.csv")
    with open(cls, "w") as f:
        for i, v in enumerate(vids[:4]):
            f.write(f"{v} {i % 2}\n")
    grd = str(root / "grd.json")
    with open(grd, "w") as f:
        json.dump([{"video": v, "start": 0.2, "end": 0.8, "duration": 1.2,
                    "sentence": f"a person does thing {i}"} for i, v in enumerate(vids[4:])], f)
    meta = {"datasets": {
        "Kinetics": {"train": {"data_path": cls, "num_frames": 4, "short_side_size": 48}},
        "TaskGrounding": {"train": {"data_path": grd, "num_frames": 4, "short_side_size": 48}},
    }}
    path = str(root / "meta.yaml")
    with open(path, "w") as f:
        json.dump(meta, f)  # JSON is YAML
    return path


@pytest.fixture
def hash_tokenizer(monkeypatch):
    """Both packages' ``MultitaskModel`` fall back to their word-hash
    tokenizer without ``transformers``: blocking it skips a slow lookup of
    tokenizer files that are not here (the fallback is what runs anyway)."""
    monkeypatch.setitem(sys.modules, "transformers", None)


def _small_model(seed=0):
    return MultitaskModel(StreamformerConfig(**KW), {"Kinetics": {"label2id": {"a": 0, "b": 1}}},
                          SiglipTextConfig(**TEXT_KW), device="cpu",
                          generator=torch.Generator().manual_seed(seed))


def _opt_state(tx):
    sd = tx.state_dict()
    return {k: {f: v.clone() for f, v in st.items()} for k, st in sd["inner"]["state"].items()}, \
        sd["count"]


def _assert_same_training_state(model_a, tx_a, model_b, tx_b):
    sa, sb = model_a.state_dict(), model_b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    (oa, ca), (ob, cb) = _opt_state(tx_a), _opt_state(tx_b)
    assert ca == cb and oa.keys() == ob.keys()
    for k in oa:
        assert oa[k].keys() == ob[k].keys()
        for f in oa[k]:
            assert torch.equal(oa[k][f], ob[k][f]), (k, f)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _trained_small(steps=2):
    model = _small_model()
    model.prepare_for_multi_tasks()
    tx = optim.create_optimizer(model, optim.cosine_lr_schedule(1e-3, 1e-5, 1, 4),
                                trainable_mask=optim.trainable_mask_frozen_text(model),
                                clip_grad=1.0)
    trainer = MultitaskTrainer(model, tx)
    rng = np.random.default_rng(0)
    batch = {"pixel_values": rng.standard_normal((2, 4, 3, 32, 32)).astype(np.float32),
             "task_input": {"label_embeddings": model.label_embeddings["Kinetics"],
                            "label": np.array([0, 1])}}
    trainer.train_one_epoch(TrainState.create(model, tx), iter([("Kinetics", batch)] * steps), 0)
    return model, tx


@pytest.mark.parametrize("block", [True, False])
def test_checkpoint_roundtrip(tmp_path, block, hash_tokenizer):
    """A mid-epoch save restores the parameters, the optimizer's moments and
    update count and the meta bit for bit; an asynchronous save is visible
    once committed, and never half-written."""
    model, tx = _trained_small()
    out = str(tmp_path / "out")
    path = ckpt.save_checkpoint(out, 3, model, tx, step=tx.count, micro=5, block=block)
    assert path.endswith("checkpoint-3")
    assert ckpt.latest_checkpoint(out) == 3  # waits for the save in flight
    assert sorted(os.listdir(out)) == ["checkpoint-3"]  # no temporary directory left
    fresh = _small_model(seed=9)
    fresh_tx = optim.create_optimizer(fresh, optim.cosine_lr_schedule(1e-3, 1e-5, 1, 4),
                                      trainable_mask=optim.trainable_mask_frozen_text(fresh),
                                      clip_grad=1.0)
    meta = ckpt.auto_resume(out, fresh, fresh_tx)
    assert meta == {"epoch": 3, "step": 2, "micro": 5}
    _assert_same_training_state(model, tx, fresh, fresh_tx)
    # the epoch's end saves over its mid-epoch checkpoint
    ckpt.save_checkpoint(out, 3, model, tx, step=tx.count, block=False)
    assert ckpt.restore_checkpoint(out, 3, fresh, fresh_tx)["micro"] == 0
    assert sorted(os.listdir(out)) == ["checkpoint-3"]


def test_retention_keeps_the_jax_epochs(tmp_path, hash_tokenizer):
    """``_prune`` keeps the same checkpoints as the JAX package's for epochs
    0-23 (milestones every 10, the last two)."""
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    ours.mkdir()
    theirs.mkdir()
    for epoch in range(24):
        (ours / f"checkpoint-{epoch}").mkdir()
        (theirs / f"checkpoint-{epoch}").mkdir()
        (ours / f"checkpoint-{epoch}.tmp-1").mkdir(exist_ok=True)  # uncommitted: never pruned
        ckpt._prune(str(ours), epoch, keep_every=10, keep_last=2)
        jax_ckpt._prune(str(theirs), epoch, keep_every=10, keep_last=2)
        committed = sorted(d for d in os.listdir(ours) if ".tmp-" not in d)
        assert committed == sorted(os.listdir(theirs)), epoch
    assert sorted(os.listdir(theirs), key=lambda d: int(d.split("-")[1])) == \
        ["checkpoint-0", "checkpoint-10", "checkpoint-20", "checkpoint-22", "checkpoint-23"]
    model, tx = _trained_small(steps=1)
    for epoch in range(4):
        ckpt.save_checkpoint(str(tmp_path / "saves"), epoch, model, tx, keep_every=10, block=False)
    assert ckpt.latest_checkpoint(str(tmp_path / "saves")) == 3
    assert sorted(os.listdir(tmp_path / "saves")) == ["checkpoint-0", "checkpoint-2",
                                                      "checkpoint-3"]


# ---------------------------------------------------------------------------
# SigLIP initialisation
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def siglip():
    """The tiny random ``SiglipModel`` of the JAX package's test, its vision
    MLP on the exact GELU the encoder's fp32 MLP uses."""
    from transformers import SiglipConfig, SiglipModel
    from transformers.models.siglip.configuration_siglip import (
        SiglipTextConfig as HFTextCfg, SiglipVisionConfig as HFVisionCfg)

    torch.manual_seed(0)
    cfg = SiglipConfig.from_text_vision_configs(
        HFTextCfg(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                  num_attention_heads=4, max_position_embeddings=8),
        HFVisionCfg(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                    num_attention_heads=4, image_size=48, patch_size=16, hidden_act="gelu"))
    return SiglipModel(cfg).eval()


SIGLIP_CFG = dict(image_size=48, patch_size=16, num_frames=4, hidden_size=32, num_hidden_layers=2,
                  num_attention_heads=4, intermediate_size=64, hidden_act="gelu", dtype="float32")


def test_siglip_surgery_copies_what_the_jax_package_copies(siglip, tmp_path):
    sd = {k: v.numpy() for k, v in siglip.state_dict().items()}
    jcfg = JaxConfig(use_pallas=False, **SIGLIP_CFG)
    cfg = StreamformerConfig(**SIGLIP_CFG)
    jaudit, audit = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    jparams, jtext, jextras = jax_init_from_siglip(sd, jcfg, audit_path=jaudit)
    enc, text, extras = init_from_siglip(sd, cfg, generator=torch.Generator().manual_seed(1),
                                         audit_path=audit)
    want = params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    assert enc.keys() == want.keys()
    fresh = ("temporal_attention.attention.qkv.weight", "temporal_attention.output.dense.weight",
             "temporal_dense.weight", "time_embeddings")
    copied = [k for k in enc if not k.endswith(fresh)]
    assert len(copied) > 30
    for k in copied:
        assert torch.equal(enc[k], want[k]), k
    for k in enc:
        if k.endswith(fresh):  # freshly drawn, normal(0, 0.02)
            assert 0.01 < float(enc[k].std()) < 0.03, k
        if k.endswith("temporal_attention_gating"):
            assert float(enc[k]) == 0.0
    jt = text_params_from_jax(jax.tree.map(np.asarray, jtext))
    assert text.keys() == jt.keys()
    for k in text:
        assert torch.equal(text[k], jt[k]), k
    for k in ("logit_scale", "logit_bias"):
        assert torch.equal(extras[k], torch.tensor(np.asarray(jextras[k])))
    with open(audit) as f, open(jaudit) as g:
        assert json.load(f) == json.load(g)
    # the text tower loads as it is; the geometry is read from the state dict
    tower = SiglipTextEncoder(SiglipTextConfig(**dict(TEXT_KW, num_hidden_layers=2)), device="cpu")
    tower.load_state_dict(text)


def test_siglip_init_encodes_each_frame_as_siglip(siglip, tmp_path):
    """At gate 0, with the time table zeroed, the initialised encoder on a
    4-frame clip is ``SiglipVisionModel`` on each frame (fp32, 1e-4)."""
    torch.save(siglip.state_dict(), str(tmp_path / "pytorch_model.bin"))
    cfg = StreamformerConfig(**SIGLIP_CFG)
    enc_sd, _, _ = init_from_siglip_dir(str(tmp_path), cfg)
    model = encoder.StreamformerEncoder(cfg, device="cpu")
    model.load_state_dict(enc_sd)
    with torch.no_grad():
        model.embeddings.time_embeddings.zero_()
    px = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 4, 3, 48, 48))
                          .astype(np.float32))
    with torch.no_grad():
        out = encoder.model_forward(model, px)
        ref = siglip.vision_model(px.reshape(8, 3, 48, 48))
    np.testing.assert_allclose(out["pooler_output"].reshape(8, -1).numpy(),
                               ref.pooler_output.numpy(), atol=1e-4, rtol=0)
    np.testing.assert_allclose(out["last_hidden_state"].reshape(8, 9, -1).numpy(),
                               ref.last_hidden_state.numpy(), atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------


def test_eval_loader_and_trainer_match_the_jax_package(metadata, hash_tokenizer):
    """Four micro-steps (two updates, AdamW, clip, LLRD, frozen text tower)
    fed by an eval-mode loader over the same videos, weights carried across
    by ``multitask_from_jax``: every loss within 1e-4 relative. (Sampler
    seed 3 alternates the two tasks, so the JAX trainer compiles two step
    functions, not four.)"""
    jtrain, _, jmtc = jax_build(metadata)
    ptrain, _, pmtc = build_multi_task_dataset(metadata)
    assert jmtc == pmtc
    jmodel = JaxMultitask(JaxConfig(use_pallas=False, **KW), jmtc,
                          text_cfg=JaxTextConfig(**TEXT_KW), rng=jax.random.PRNGKey(3))
    params = jax.tree.map(np.asarray, jmodel.params)
    for lp in params["backbone"]["layers"]:  # open the temporal path
        lp["temporal_attention_gating"] = np.asarray(0.5, np.float32)
    jmodel.params = jax.tree.map(jnp.asarray, params)
    model = MultitaskModel(StreamformerConfig(**KW), pmtc, SiglipTextConfig(**TEXT_KW),
                           device="cpu")
    model.load_state_dict(multitask_from_jax(params, model.cfg))
    jmodel.prepare_for_multi_tasks()
    model.prepare_for_multi_tasks()
    lr = dict(base_lr=1e-3, min_lr=1e-5, epochs=1, steps_per_epoch=2, warmup_steps=1)
    common = dict(weight_decay=0.05, clip_grad=1.0, layer_decay=0.75, num_layers=2)
    jtx = jax_optim.create_optimizer(jmodel.params, jax_optim.cosine_lr_schedule(**lr),
                                     trainable_mask=jax_optim.trainable_mask_frozen_text(
                                         jmodel.params), **common)
    tx = optim.create_optimizer(model, optim.cosine_lr_schedule(**lr),
                                trainable_mask=optim.trainable_mask_frozen_text(model), **common)
    jtrainer = JaxTrainer(jmodel, jtx, update_freq=2, donate_state=False)
    jstate = JaxTrainState.create(jmodel.params, jtx)
    trainer = MultitaskTrainer(model, tx, update_freq=2)
    state = TrainState.create(model, tx)
    jl = jax_collate.MultitaskLoader(jtrain, jax_S.DistributedBatchTaskUniqueSampler(
        jtrain.task_specs(), 2, seed=3), jmodel, crop_size=32, train=False, num_workers=2)
    pl = collate.MultitaskLoader(ptrain, samplers.DistributedBatchTaskUniqueSampler(
        ptrain.task_specs(), 2, seed=3), model, crop_size=32, train=False, num_workers=2)
    tasks = []
    for micro, ((ta, ba), (tb, bb)) in enumerate(zip(jl, pl)):
        assert ta == tb
        tasks.append(tb)
        apply_update = (micro + 1) % 2 == 0
        jstate, ref = jtrainer.step_fn(ta, apply_update)(jstate, ba["pixel_values"],
                                                         ba["task_input"], jax.random.PRNGKey(0))
        state, out = trainer.step_fn(tb, apply_update)(state, bb["pixel_values"],
                                                       bb["task_input"], None)
        np.testing.assert_allclose(out["loss"].item(), float(ref["loss"]), rtol=1e-4,
                                   err_msg=f"micro-step {micro} ({tb})")
    assert len(tasks) == 4 and set(tasks) == {"Kinetics", "TaskGrounding"} and state.step == 2


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def _argv(metadata, out, epochs):
    return ["--metadata", metadata, "--output_dir", out, "--device", "cpu", "--epochs",
            str(epochs), "--batch_size", "2", "--input_size", "32", "--num_frames", "4",
            "--hidden_size", "32", "--num_layers", "1", "--num_heads", "2",
            "--intermediate_size", "64", "--text_layers", "1", "--num_workers", "2",
            "--lr", "1e-3", "--warmup_steps", "1", "--clip_grad", "1.0", "--seed", "3"]


def test_cli_trains_one_epoch_on_the_cpu(metadata, tmp_path, capsys, hash_tokenizer):
    """``main`` (what ``python -m streamformer_tpu_torch.train.run`` runs)
    on cv2-written videos from a YAML metadata file: one epoch writes
    ``log.txt`` and ``checkpoint-0``. It runs in this process (a new one
    would spend most of its time importing); the module's own entry is
    checked by ``--help``."""
    proc = subprocess.run([sys.executable, "-m", "streamformer_tpu_torch.train.run", "--help"],
                          cwd=ROOT, capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0 and "--device" in proc.stdout
    out = str(tmp_path / "out")
    run.main(_argv(metadata, out, 1))
    with open(os.path.join(out, "log.txt")) as f:
        lines = [json.loads(line) for line in f]
    assert len(lines) == 1 and lines[0]["epoch"] == 0 and np.isfinite(lines[0]["loss"])
    assert sorted(d for d in os.listdir(out) if d.startswith("checkpoint")) == ["checkpoint-0"]
    with open(os.path.join(out, "args.json")) as f:
        assert json.load(f)["device"] == "cpu"
    assert "done" in capsys.readouterr().out


def test_cli_refuses_what_it_cannot_run(metadata, monkeypatch):
    """A mesh needs its processes (one a GPU): in one process --dp or --mp
    past 1 is refused, and --distributed without a job to join
    (tests/test_torch_dist_cli.py runs it on two ranks)."""
    for extra in (["--dp", "2"], ["--mp", "2"], ["--mp", "2", "--shard_patches"]):
        with pytest.raises(ValueError, match="world size 1"):
            run.main(_argv(metadata, "unused", 1) + extra)
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        run.main(_argv(metadata, "unused", 1) + ["--distributed"])


def test_sigterm_mid_epoch_then_resume_equals_an_uninterrupted_run(metadata, tmp_path,
                                                                  hash_tokenizer):
    """Two epochs of 4 micro-steps (4 updates each): a SIGTERM after the second update of
    epoch 1 leaves a mid-epoch checkpoint; a fresh call resumes from it and
    ends where an uninterrupted run ends, bit for bit (parameters, AdamW
    moments, update count)."""
    args = run.get_args(_argv(metadata, str(tmp_path / "whole"), 2))
    data = run.build_datasets(args)
    whole = run.train(args, *data)

    real_step_fn = trainer_mod.MultitaskTrainer.step_fn
    updates = {"n": 0}

    def step_fn(self, task_name, apply_update):
        fn = real_step_fn(self, task_name, apply_update)

        def wrapped(state, *a):
            state, out = fn(state, *a)
            if apply_update and state.step > 4:  # an update of epoch 1
                updates["n"] += 1
                if updates["n"] == 2:
                    signal.raise_signal(signal.SIGTERM)
            return state, out

        return wrapped

    args = run.get_args(_argv(metadata, str(tmp_path / "cut"), 2))
    handler = signal.getsignal(signal.SIGTERM)
    trainer_mod.MultitaskTrainer.step_fn = step_fn
    try:
        cut = run.train(args, *data)
    finally:
        trainer_mod.MultitaskTrainer.step_fn = real_step_fn
    assert cut.step == 6
    meta = ckpt._load_flat(os.path.join(args.output_dir, "checkpoint-1"))
    assert int(meta["meta/micro"]) == 2 and int(meta["meta/epoch"]) == 1
    resumed = run.train(args, *data)
    assert resumed.step == whole.step == 8
    _assert_same_training_state(whole.model, whole.optimizer, resumed.model, resumed.optimizer)
    assert signal.getsignal(signal.SIGTERM) is handler
