"""The port's VideoQA training against the JAX package's, on the CPU in fp32.

``tests/test_videoqa.py``'s tiny tower and LM (gates and biases opened so
that they matter), the same numpy-seeded weights on both sides through
``params_from_jax``, ``projector_params_from_jax`` and
``lm_params_from_jax`` (linear maps, so they carry gradients too). After two
steps of each stage and of DPO the losses, the DPO metrics and every
parameter agree within 1e-4; frozen parts are unchanged bit for bit. At
each step the port's gradients of every trained part are held to JAX's
(those of the step's own loss, which the JAX package does not return, so the
test writes it out and holds its value to the step's), and the update each
parameter takes from JAX's gradients to optax's within a hundredth of its
part's lr: the lrs of 2e-5 and 2e-6 move a parameter by about that much a
step, far inside the 1e-4 of the parameters' check. The per-part clip is
held to optax's on gradients whose part norms straddle the clip. The port's CLI runs in-process on videos written with cv2, and the
port's interleave scorer equals the JAX package's.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from streamformer_tpu.config import StreamformerConfig as JaxConfig
from streamformer_tpu.downstream import videoqa as JVQ
from streamformer_tpu.eval import interleave as jax_interleave
from streamformer_tpu.models import encoder as jax_encoder
from streamformer_tpu.models import language_model as JLM
from streamformer_tpu_torch.checkpoint import (lm_params_from_jax, params_from_jax,
                                               projector_params_from_jax)
from streamformer_tpu_torch.config import StreamformerConfig
from streamformer_tpu_torch.downstream import videoqa as VQ
from streamformer_tpu_torch.eval import interleave
from streamformer_tpu_torch.models import encoder
from streamformer_tpu_torch.models import language_model as LM

from test_torch_encoder import _jax_params

ATOL = 1e-4
GRAD_RTOL = 1e-5  # a gradient against JAX's, relative to its part's largest
# tests/test_videoqa.py's tower and LM
TOWER = dict(image_size=32, patch_size=16, num_frames=4, hidden_size=32, num_hidden_layers=1,
             num_attention_heads=4, intermediate_size=64, dtype="float32", cache_capacity=16,
             streaming_mode=True, context_length=4)
JLM_CFG = JLM.LMConfig(vocab_size=50, hidden_size=24, intermediate_size=48, num_hidden_layers=2,
                       num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
                       rope_theta=10000.0, tie_word_embeddings=True)
JCFG = JaxConfig(use_pallas=False, **TOWER)
CFG = StreamformerConfig(**TOWER)
MAX_LEN = 12


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these tensors are tiny, and the 6-worker run
    oversubscribes the cores with each worker's default thread pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_params_all():
    """The numpy tree {tower, projector, lm}, biases drawn so that they matter."""
    rng = np.random.default_rng(11)
    proj = jax.tree.map(np.asarray, JVQ.init_mm_projector(jax.random.PRNGKey(3), CFG.hidden_size,
                                                          JLM_CFG.hidden_size))
    for fc in ("fc1", "fc2"):
        proj[fc]["bias"] = 0.05 * rng.standard_normal(proj[fc]["bias"].shape).astype(np.float32)
    lm = jax.tree.map(np.asarray, JLM.init_params(jax.random.PRNGKey(7), JLM_CFG))
    for layer in lm["layers"]:
        for key in "qkv":
            b = layer["attn"][key]["bias"]
            layer["attn"][key]["bias"] = 0.05 * rng.standard_normal(b.shape).astype(np.float32)
    return {"tower": _jax_params(JCFG, seed=2), "projector": proj, "lm": lm}


PARAMS = _jax_params_all()


def _port_sd(params):
    """The JAX tree (or a gradient tree) under the port's ``VideoQAModel`` names."""
    sd = {"tower." + k: v for k, v in params_from_jax(params["tower"], CFG).items()}
    sd.update({"projector." + k: v for k, v in projector_params_from_jax(params["projector"]).items()})
    sd.update({"lm." + k: v for k, v in lm_params_from_jax(params["lm"]).items()})
    return sd


def _port_model():
    model = VQ.VideoQAModel(
        encoder.StreamformerEncoder(CFG, device="cpu", trainable=True),
        VQ.init_mm_projector(CFG.hidden_size, JLM_CFG.hidden_size, device="cpu"),
        LM.LanguageModel(LM.LMConfig(**{f: getattr(JLM_CFG, f) for f in (
            "vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
            "num_attention_heads", "num_key_value_heads", "max_position_embeddings",
            "rope_theta", "rms_norm_eps", "tie_word_embeddings", "attention_bias", "dtype")}),
            device="cpu", trainable=True))
    model.load_state_dict(_port_sd(PARAMS))
    return model


def _video(seed=5):
    return np.random.default_rng(seed).standard_normal((1, 4, 3, 32, 32)).astype(np.float32)


def _sub(answer):
    ids = np.array([3, VQ.IMAGE_TOKEN_INDEX, 9] + answer)
    labels = np.array([-100, -100, -100] + answer)
    return ids, labels


def _jax_batch(ids, labels, px=None):
    plan = JVQ.build_splice_plan(ids, CFG.num_frames, MAX_LEN, labels)
    batch = {k: jnp.asarray(v)[None] for k, v in plan.items()}
    batch["text_ids"] = jnp.asarray(np.where(ids == VQ.IMAGE_TOKEN_INDEX, 0, ids))[None]
    if px is not None:
        batch["pixel_values"] = jnp.asarray(px)
    return batch


def _port_batch(ids, labels, px=None):
    batch = VQ.make_batch(ids, labels, CFG.num_frames, MAX_LEN, device="cpu")
    if px is not None:
        batch["pixel_values"] = torch.from_numpy(px)
    return batch


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))))


def _held(model, jparams, frozen, initial):
    """Every parameter within ATOL of the JAX tree; frozen parts bit for bit
    their initial values."""
    want = _port_sd(jax.tree.map(np.asarray, jparams))
    for name, p in model.state_dict().items():
        assert _err(p, want[name]) <= ATOL, name
        if name.split(".")[0] in frozen:
            assert torch.equal(p, initial[name]), name


def _jax_logits_and_labels(params, img, sub):
    text = JLM.embed_tokens(params["lm"], sub["text_ids"])
    embeds = JVQ.apply_splice_plan(sub, text, img)
    out, _ = JLM.forward(params["lm"], embeds, JLM_CFG,
                         attention_mask=sub["attention_mask"].astype(jnp.int32))
    return out["logits"], jnp.where(sub["attention_mask"], sub["labels"], -100)


def _jax_encode(params, px):
    feats = jax_encoder.model_forward(params["tower"], px, JCFG)["last_hidden_state"]
    return JVQ.mm_projector(params["projector"], feats.mean(axis=2))


def _jax_sft_loss(params, batch):
    """``make_videoqa_train_step``'s loss, written out for its gradient."""
    img = _jax_encode(params, batch["pixel_values"])
    return JLM.lm_loss(*_jax_logits_and_labels(params, img, batch))


def _jax_dpo_loss(params, ref_params, batch, beta, gamma):
    """``make_videoqa_dpo_step``'s loss (dpo_alpha 1), written out for its
    gradient."""
    def logps(p, img, sub):
        logits, lab = _jax_logits_and_labels(p, img, sub)
        return JVQ.sequence_logps(logits, lab), logits, lab

    img = _jax_encode(params, batch["pixel_values"])
    pc, logits_c, lab_c = logps(params, img, batch["chosen"])
    pr = logps(params, img, batch["rejected"])[0]
    ref_img = _jax_encode(ref_params, batch["pixel_values"])
    rc = jax.lax.stop_gradient(logps(ref_params, ref_img, batch["chosen"])[0])
    rr = jax.lax.stop_gradient(logps(ref_params, ref_img, batch["rejected"])[0])
    losses = JVQ.dpo_loss(pc, pr, rc, rr, beta)[0]
    return losses.mean() + gamma * JLM.lm_loss(logits_c, lab_c)


def _np(tree):
    return jax.tree.map(np.array, tree)  # copies: the DPO step donates its params


def _on_jax_grads(opt, model):
    """Wrap ``opt.step``: record the port's own gradients as the step starts
    (``seen``), then step on ``feed`` (JAX's gradients, set by the caller) in
    their place, so that the update is held to optax's on equal gradients."""
    seen, feed = {}, {}
    inner = opt.step

    def step():
        for name, p in model.named_parameters():
            seen[name] = None if p.grad is None else p.grad.detach().clone()
            if p.grad is not None:
                p.grad.copy_(feed[name])
        inner()

    opt.step = step
    return seen, feed


def _step_held(model, seen, jgrads, before, jbefore, jafter, lrs):
    """One step of ``model`` against JAX's: each trained part's gradients
    within GRAD_RTOL of the part's largest (none where JAX's is zero, as for
    the pooling head that the last hidden state skips), a frozen part none;
    each parameter's update within a hundredth of its part's lr of optax's
    (plus the rounding of the parameter itself), and optax's update of each
    trained part at least half its lr somewhere, so that the check sees it."""
    want = _port_sd(jgrads)
    scale, jmove = {}, {}
    for name, g in want.items():
        part = name.split(".")[0]
        scale[part] = max(scale.get(part, 0.0), float(g.abs().max()))
    jb, ja = _port_sd(jbefore), _port_sd(jafter)
    for name, p in model.named_parameters():
        part = name.split(".")[0]
        if part not in lrs:
            assert seen[name] is None, name
            continue
        got = torch.zeros_like(want[name]) if seen[name] is None else seen[name]
        assert _err(got, want[name]) <= GRAD_RTOL * scale[part], name
        moved, jmoved = p.detach() - before[name], ja[name] - jb[name]
        rounding = 2 * float(np.finfo(np.float32).eps) * float(p.detach().abs().max())
        assert _err(moved, jmoved) <= 1e-2 * lrs[part] + rounding, name
        jmove[part] = max(jmove.get(part, 0.0), float(jmoved.abs().max()))
    for part, lr in lrs.items():
        assert jmove[part] >= 0.5 * lr, part


def _lrs(stage):
    pol = VQ.stage_policy(stage)
    return {part: pol["lr"][name] for part, name in VQ.PARTS.items() if name in pol["train"]}


def test_stage_policy_equals_jax():
    for stage in (1, 2, 3):
        assert VQ.stage_policy(stage) == JVQ.stage_policy(stage)


def test_optimizer_is_optax_adamw_a_part():
    """Each trained part one AdamW group at its stage lr with optax.adamw's
    defaults (b1, b2, eps and a weight decay of 1e-4 on every parameter, not
    torch's 0.01), clipped by its own norm; frozen parts require no grad."""
    import inspect

    defaults = {k: v.default for k, v in inspect.signature(optax.adamw).parameters.items()}
    for stage in (1, 2, 3):
        model = _port_model()
        opt = VQ.make_optimizer(model, stage)
        pol = JVQ.stage_policy(stage)
        assert opt.clip_each_group and opt.clip_grad == 1.0
        assert [g["lr_scale"] for g in opt.param_groups] == [
            pol["lr"][VQ.PARTS[part]] for part in VQ.PARTS if VQ.PARTS[part] in pol["train"]]
        for g in opt.param_groups:
            assert g["betas"] == (defaults["b1"], defaults["b2"]) and g["eps"] == defaults["eps"]
            assert g["decayed"] and g["base_weight_decay"] == defaults["weight_decay"]
        for part, name in VQ.PARTS.items():
            assert all(p.requires_grad == (name in pol["train"])
                       for p in getattr(model, part).parameters())


def test_sequence_logps_and_dpo_loss_match_jax():
    """Within 1e-6, relative to the log-probability sums (about 20 here, where
    one fp32 ulp is 1.9e-6), and absolute for the DPO losses and rewards."""
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 7, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (3, 7))
    labels[:, :3] = -100
    labels[1, 5] = -100
    ref = JVQ.sequence_logps(jnp.asarray(logits), jnp.asarray(labels))
    got = VQ.sequence_logps(torch.from_numpy(logits), torch.from_numpy(labels))
    assert _err(got, ref) <= 1e-6 * max(1.0, float(np.abs(np.asarray(ref)).max()))
    lps = [rng.standard_normal(4).astype(np.float32) * 5 for _ in range(4)]
    for beta, smooth in ((0.1, 0.0), (0.5, 0.2)):
        ref = JVQ.dpo_loss(*map(jnp.asarray, lps), beta=beta, label_smoothing=smooth)
        got = VQ.dpo_loss(*map(torch.from_numpy, lps), beta=beta, label_smoothing=smooth)
        for r, g in zip(ref, got):
            assert _err(g, r) <= 1e-6


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_stage_steps_match_jax(stage):
    """Two steps of a stage: the losses and every parameter within 1e-4 of
    ``make_videoqa_train_step``, each step's gradients and updates held to
    JAX's (``_step_held``); the frozen parts unchanged bit for bit."""
    ids, labels = _sub([9, 12, 5])
    px = _video()
    tx, jstep = JVQ.make_videoqa_train_step(JCFG, JLM_CFG, stage)
    jgrad = jax.jit(jax.value_and_grad(_jax_sft_loss))
    jp = jax.tree.map(jnp.asarray, PARAMS)
    state = tx.init(jp)
    model = _port_model()
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    opt, step = VQ.make_videoqa_train_step(model, stage)
    seen, feed = _on_jax_grads(opt, model)
    jb, pb = _jax_batch(ids, labels, px), _port_batch(ids, labels, px)
    for _ in range(2):
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        jbefore = _np(jp)
        jl, jg = jgrad(jp, jb)
        feed.update(_port_sd(_np(jg)))
        jp, state, jloss = jstep(jp, state, jb)
        assert abs(float(jl) - float(jloss)) <= 1e-6 * max(1.0, abs(float(jloss)))
        loss = step(pb)
        assert abs(float(loss) - float(jloss)) <= ATOL
        _step_held(model, seen, _np(jg), before, jbefore, _np(jp), _lrs(stage))
    frozen = {"tower": stage < 3, "lm": stage < 2, "projector": False}
    _held(model, jp, {k for k, v in frozen.items() if v}, initial)
    assert not torch.equal(model.projector.fc1.weight, initial["projector.fc1.weight"])


def test_each_part_is_clipped_by_its_own_norm():
    """Stage 3 on a batch whose projector gradient norm exceeds the clip and
    whose tower and LM norms do not (or the other way): the port's clipped
    gradients equal optax's ``clip_by_global_norm`` a part, which one global
    clip would not give."""
    ids, labels = _sub([9, 12, 5])
    px = _video()

    params = jax.tree.map(jnp.asarray, PARAMS)
    params["projector"] = jax.tree.map(lambda x: 20.0 * x, params["projector"])
    grads = jax.jit(jax.grad(_jax_sft_loss))(params, _jax_batch(ids, labels, px))
    norms = {part: float(optax.global_norm(g)) for part, g in grads.items()}
    assert min(norms.values()) < 1.0 < max(norms.values()), norms
    clip = optax.clip_by_global_norm(1.0)
    clipped = {part: clip.update(g, clip.init(g))[0] for part, g in grads.items()}
    want = _port_sd(jax.tree.map(np.asarray, clipped))
    model = _port_model()
    model.load_state_dict(_port_sd(jax.tree.map(np.asarray, params)))
    _, step = VQ.make_videoqa_train_step(model, 3)
    step(_port_batch(ids, labels, px))
    whole = float(optax.global_norm(grads))
    for name, p in model.named_parameters():
        w = want[name].numpy()
        assert _err(p.grad.numpy(), w) <= 1e-5 * max(1.0, float(np.abs(w).max())), name
    # one global clip would have scaled the small parts too
    small = min(norms, key=norms.get)
    assert whole > 1.0 and norms[small] < 1.0


def test_dpo_step_matches_jax():
    """Two DPO steps (stage 3, beta 0.5, gamma 0.1): loss, metrics and every
    parameter within 1e-4 of ``make_videoqa_dpo_step``, each step's
    gradients (the DPO loss's and the SFT term's) and updates held to JAX's
    (``_step_held``); the reference copy unchanged bit for bit."""
    px = _video()
    jb = {"pixel_values": jnp.asarray(px), "chosen": _jax_batch(*_sub([9, 12])),
          "rejected": _jax_batch(*_sub([7, 5]))}
    pb = {"pixel_values": torch.from_numpy(px), "chosen": _port_batch(*_sub([9, 12])),
          "rejected": _port_batch(*_sub([7, 5]))}
    tx, jstep = JVQ.make_videoqa_dpo_step(JCFG, JLM_CFG, stage=3, beta=0.5, gamma=0.1)
    jgrad = jax.jit(jax.value_and_grad(_jax_dpo_loss), static_argnums=(3, 4))
    jp = jax.tree.map(jnp.asarray, PARAMS)
    jref = jax.tree.map(jnp.asarray, PARAMS)
    state = tx.init(jp)
    model = _port_model()
    ref = VQ.reference_copy(model)
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    opt, step = VQ.make_videoqa_dpo_step(model, ref, stage=3, beta=0.5, gamma=0.1)
    seen, feed = _on_jax_grads(opt, model)
    for _ in range(2):
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        jbefore = _np(jp)
        jl, jg = jgrad(jp, jref, jb, 0.5, 0.1)
        jg = _np(jg)
        feed.update(_port_sd(jg))
        jp, state, jloss, jm = jstep(jp, jref, state, jb)
        assert abs(float(jl) - float(jloss)) <= 1e-6 * max(1.0, abs(float(jloss)))
        loss, m = step(pb)
        assert abs(float(loss) - float(jloss)) <= ATOL
        assert m.keys() == jm.keys()
        for k in m:
            assert abs(float(m[k]) - float(jm[k])) <= ATOL, k
        _step_held(model, seen, jg, before, jbefore, _np(jp), _lrs(3))
    _held(model, jp, set(), initial)
    for name, p in ref.state_dict().items():
        assert torch.equal(p, initial[name]), name


def test_interleave_scorer_equals_jax():
    rows = [
        {"sample_id": 0, "dataset": "spot-the-diff", "question_type": "open-ended",
         "gt_response": "The red car moved to the left.", "pred_response": "the car moved left"},
        {"sample_id": 1, "dataset": "nlrv2", "question_type": "multi-choice",
         "gt_response": "B", "pred_response": "B: two dogs"},
        {"sample_id": 2, "dataset": "nlrv2", "question_type": "multi-choice",
         "gt_response": "A", "pred_response": "C"},
        {"sample_id": 3, "dataset": "qbench", "question_type": "open-ended",
         "gt_response": "It is blurry. The light is low.", "pred_response": "blurry and dark"},
    ]
    assert interleave.score_results(rows) == jax_interleave.score_results(rows)
    for pred, ref in (("a b c d", "b c e"), ("", "x"), ("Same words.", "same words")):
        assert interleave.rouge_l_f(pred, ref) == jax_interleave.rouge_l_f(pred, ref)


CLI_TINY = ["--hidden_size", "32", "--num_layers", "1", "--num_heads", "4",
            "--intermediate_size", "64", "--input_size", "32", "--num_frames", "4",
            "--lm_hidden", "32", "--lm_layers", "1", "--lm_heads", "4", "--lm_kv_heads", "2",
            "--lm_intermediate", "64", "--lm_vocab", "64", "--device", "cpu", "--max_len", "24"]


def _write_video(path, seed, n=12, h=48, w=64):
    import cv2

    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10, (w, h))
    rng = np.random.default_rng(seed)
    for _ in range(n):
        vw.write(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    vw.release()


def test_eval_builds_the_serving_modules():
    """``--eval`` builds the serving tower and LM (compute-dtype weights, no
    grad), and a training model's fp32 masters load into them cast once;
    training builds fp32 masters that require grad."""
    from streamformer_tpu_torch.downstream import videoqa_run

    args = videoqa_run.get_args(["--bf16", "--data", "x.json"] + CLI_TINY)
    trained = videoqa_run.build_model(args)
    serving = videoqa_run.build_model(args, serving=True)
    for part in ("tower", "lm"):
        assert all(p.dtype == torch.float32 and p.requires_grad
                   for p in getattr(trained, part).parameters())
        assert not any(p.requires_grad for p in getattr(serving, part).parameters())
    assert serving.lm.model.embed_tokens.weight.dtype == torch.bfloat16
    assert serving.tower.encoder.layer[0].intermediate.dense.weight.dtype == torch.bfloat16
    serving.load_state_dict(trained.state_dict())
    sd = trained.state_dict()
    for name, p in serving.state_dict().items():
        assert torch.equal(p, sd[name].to(p.dtype)), name


def test_cli_trains_stage_1_and_dpo_then_answers_from_the_checkpoint(tmp_path, capsys):
    """The port's CLI in-process: a stage-1 epoch and a DPO epoch (each a
    log line and a checkpoint), then ``--eval --ckpt`` restoring the DPO
    run's checkpoint and answering a two-turn row and a one-turn row through
    the ``DecodeEngine``: three answers in the reference schema."""
    from streamformer_tpu_torch.downstream import videoqa_run
    from streamformer_tpu_torch.train import checkpoint as ckpt_lib

    videos = []
    for i in range(2):
        videos.append(str(tmp_path / f"v{i}.avi"))
        _write_video(videos[-1], seed=i)
    sft = [{"video": videos[i], "conversations": [
        {"from": "human", "value": "<image>\nwhat happens"},
        {"from": "gpt", "value": "something moves" if i else "three"}]} for i in range(2)]
    dpo = [{"video": videos[i], "prompt": "<image>\nwhat happens", "chosen": "a dog runs",
            "rejected": "nothing"} for i in range(2)]
    questions = [{"video": videos[0], "sample_id": "q0", "metadata": {"dataset": "nlrv2"},
                  "conversations": [{"from": "human", "value": "what happens"},
                                    {"from": "gpt", "value": "it moves"},
                                    {"from": "human", "value": "and then"},
                                    {"from": "gpt", "value": "it stops"}]},
                 {"video": videos[1], "sample_id": "q1",
                  "conversations": [{"from": "human", "value": "count"}]}]
    paths = {}
    for name, rows in (("sft", sft), ("dpo", dpo), ("questions", questions)):
        paths[name] = str(tmp_path / f"{name}.json")
        with open(paths[name], "w") as f:
            json.dump(rows, f)
    out1, out2 = str(tmp_path / "stage1"), str(tmp_path / "dpo")
    videoqa_run.main(["--data", paths["sft"], "--stage", "1", "--output_dir", out1,
                      "--eval_samples", "1"] + CLI_TINY)
    videoqa_run.main(["--data", paths["dpo"], "--stage", "3", "--dpo", "--output_dir", out2,
                      "--eval_samples", "0"] + CLI_TINY)
    for out, keys in ((out1, {"stage", "loss"}), (out2, {"dpo", "reward_accuracy"})):
        with open(os.path.join(out, "log.txt")) as f:
            line = json.loads(f.readline())
        assert keys <= line.keys() and np.isfinite(line["loss"])
        assert ckpt_lib.latest_checkpoint(out) == 0
    assert '"answer_token_ids"' in capsys.readouterr().out
    answers = str(tmp_path / "answers.jsonl")
    videoqa_run.main(["--eval", "--data", paths["questions"], "--ckpt", out2, "--answers_file",
                      answers, "--max_new_tokens", "4", "--engine_slots", "2"] + CLI_TINY)
    with open(answers) as f:
        got = [json.loads(ln) for ln in f]
    assert sorted((r["sample_id"], r["prompt"]) for r in got) == sorted(
        [("q0", "<image>\nwhat happens"), ("q0", "and then"), ("q1", "<image>\ncount")])
    for r in got:
        assert r["model_id"] == "dpo" and 1 <= len(r["pred_token_ids"]) <= 4
        assert set(r) == {"dataset", "sample_id", "prompt", "pred_response", "pred_token_ids",
                          "gt_response", "shortuuid", "model_id", "question_type"}
    assert {r["prompt"]: r["gt_response"] for r in got if r["sample_id"] == "q0"} == {
        "<image>\nwhat happens": "it moves", "and then": "it stops"}
