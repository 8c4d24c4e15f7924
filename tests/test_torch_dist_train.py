"""The port's trainer over a (data, model) mesh of four gloo ranks against
the one-process port on the global batch and the JAX trainer on a data=4
mesh: grad accumulation across two tasks (classification, and retrieval
with the ring SigLIP loss), SGD, AdamW, dropout and stochastic depth on,
and a checkpoint saved at data=2 x model=2 and restored at data=4 and in
one process.

The ranks (``tests/_torch_dist_worker.py``, case "train") start once for
the module. Tolerances: SGD parameters within 1e-5 of the one-process
port (the masks keyed by sample make the dropout run one too), losses and
gradient norms within 1e-5 relative; AdamW parameters within 2 lr (Adam's
first updates are g / |g|, so a gradient that is rounding noise becomes an
lr-sized difference); the JAX trainer's SGD parameters within 1e-3.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_dist_worker as worker
from streamformer_tpu.config import StreamformerConfig as JaxConfig
from streamformer_tpu.models.multitask import MultitaskModel as JaxMultitask
from streamformer_tpu.models.text_encoder import SiglipTextConfig as JaxTextConfig
from streamformer_tpu.parallel.mesh import make_mesh as jax_make_mesh
from streamformer_tpu.train import optim as jax_optim
from streamformer_tpu.train.trainer import MultitaskTrainer as JaxTrainer
from streamformer_tpu.train.trainer import TrainState as JaxTrainState
from streamformer_tpu_torch.checkpoint import multitask_from_jax
from streamformer_tpu_torch.config import StreamformerConfig
from streamformer_tpu_torch.train import checkpoint

KW = dict(image_size=32, patch_size=16, num_frames=4, hidden_size=32, num_hidden_layers=2,
          num_attention_heads=4, intermediate_size=64, dtype="float32")
TEXT_KW = dict(vocab_size=64, hidden_size=32, num_hidden_layers=1, num_attention_heads=4,
               intermediate_size=64, max_position_embeddings=8)
TASKS = {"Kinetics": {"label2id": {"a": 0, "b": 1, "c": 2}}, "MSRVTT": {}}
LR = dict(base_lr=1e-3, min_lr=1e-5, epochs=1, steps_per_epoch=2, warmup_steps=1)
COMMON = dict(weight_decay=0.05, clip_grad=1.0, layer_decay=0.75, num_layers=2)
STREAM = [("Kinetics", 0), ("MSRVTT", 1), ("MSRVTT", 2), ("Kinetics", 3)]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these tensors are tiny, and the 6-worker run
    oversubscribes the cores with each worker's default thread pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batches(rng, b=4):
    def px():
        return rng.standard_normal((b, 4, 3, 32, 32)).astype(np.float32)

    lab = rng.standard_normal((3, 32)).astype(np.float32)
    lab /= np.linalg.norm(lab, axis=-1, keepdims=True)
    cls = [{"pixel_values": px(), "task_input": {"label_embeddings": lab,
                                                 "label": rng.integers(0, 3, b)}}
           for _ in range(3)]
    ret = [{"pixel_values": px(), "task_input": {
        "caption_ids": rng.integers(2, 64, (b, 8)).astype(np.int32)}} for _ in range(2)]
    return [cls[0], ret[0], ret[1], cls[1], cls[2]]


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_train")
    jmodel = JaxMultitask(JaxConfig(use_pallas=False, **KW), TASKS,
                          text_cfg=JaxTextConfig(**TEXT_KW), rng=jax.random.PRNGKey(3))
    params = jax.tree.map(np.asarray, jmodel.params)
    rng = np.random.default_rng(4)
    for lp in params["backbone"]["layers"]:  # open the temporal path
        lp["temporal_attention_gating"] = np.asarray(0.5, np.float32)
    params["backbone"]["embeddings"]["time_embeddings"] = (
        0.1 * rng.standard_normal((4, 32)).astype(np.float32))
    state = multitask_from_jax(params, StreamformerConfig(**KW))
    inp = {"kw": KW, "text_kw": TEXT_KW, "tasks": TASKS, "lr": LR, "common": COMMON,
           "state": state, "batches": _batches(rng), "stream": STREAM,
           "more": [("Kinetics", 4), ("MSRVTT", 1)],
           "rates": dict(hidden_dropout_prob=0.1, drop_path_rate=0.1), "ckpt": str(d / "ckpt")}
    torch.save(inp, str(d / "train_inputs.pt"))
    ranks = worker.launch("train", 4, str(d))
    return {"inp": inp, "ranks": ranks, "jmodel": jmodel, "params": params}


def _close_params(got, want, tol, what):
    assert set(got) == set(want)
    for name in want:
        err = float((got[name] - want[name]).abs().max())
        assert err <= tol, (what, name, err)


@pytest.mark.parametrize("run", ["sgd", "dropout"])
def test_sgd_steps_equal_the_one_process_port(case, run):
    """data=2 x model=2, update_freq=2 over a classification and a
    retrieval task: every rank's whole parameters, each micro-step's loss
    and the update's gradient norm equal the one-process run on the global
    batch; with dropout and stochastic depth at 0.1 each data rank draws
    its rows' masks of the one-process run."""
    inp = case["inp"]
    rates, gen = (inp["rates"], 7) if run == "dropout" else (None, None)
    want, losses, stats = worker.train_run(
        inp, None, "sgd", rates=rates,
        generator=None if gen is None else torch.Generator().manual_seed(gen))
    for r, res in enumerate(case["ranks"]):
        got, got_losses, got_stats = res[run]
        _close_params(got, want, 1e-5, f"rank {r}")
        np.testing.assert_allclose(got_losses, losses, rtol=1e-5)
        np.testing.assert_allclose(got_stats["grad_norm"], stats["grad_norm"], rtol=1e-5)
    if run == "dropout":  # the masks matter: the first loss without them is another
        plain = case["ranks"][0]["sgd"][1]
        assert abs(plain[0] - losses[0]) > 1e-3 * abs(plain[0])


@pytest.mark.parametrize("shard_patches", [False, True])
def test_synced_gradients_equal_the_one_process_port(case, shard_patches):
    """The gradient buffer after two micro-steps and the update's sync, LoRA
    on (its A a partial sum over the model group, its B sharded), dropout
    and stochastic depth on (each shard's window of the masks): every whole
    leaf within 1e-4 of its largest magnitude of the one-process buffer,
    with the patch axis sharded too or not."""
    want = worker.accumulated_grads(case["inp"], None, False)
    for r, res in enumerate(case["ranks"]):
        got = res[f"grads_sp{int(shard_patches)}"]
        assert set(got) == set(want)
        for name, g in want.items():
            bound = 1e-4 * max(float(g.abs().max()), 1e-6)
            err = float((got[name] - g).abs().max())
            assert err <= bound, (r, name, err, bound)


def test_adamw_steps_match_the_one_process_port(case):
    want, losses, _ = worker.train_run(case["inp"], None, "adamw")
    for r, res in enumerate(case["ranks"]):
        got, got_losses, _ = res["adamw"]
        _close_params(got, want, 2 * LR["base_lr"], f"rank {r}")
        np.testing.assert_allclose(got_losses, losses, rtol=1e-5)


def test_sgd_steps_match_the_jax_trainer_on_a_data_mesh(case):
    """The JAX trainer over make_mesh(data=4) on the same global batches."""
    jmodel, params = case["jmodel"], case["params"]
    jparams = jax.tree.map(jnp.asarray, params)
    jtx = jax_optim.create_optimizer(jparams, jax_optim.cosine_lr_schedule(**LR),
                                     trainable_mask=jax_optim.trainable_mask_frozen_text(jparams),
                                     opt_name="sgd", **COMMON)
    mesh = jax_make_mesh(data=4, model=1, devices=jax.devices()[:4])
    trainer = JaxTrainer(jmodel, jtx, update_freq=2, donate_state=False, mesh=mesh)
    state = JaxTrainState.create(jparams, jtx)
    batches = case["inp"]["batches"]
    losses = []
    for micro, (task, i) in enumerate(STREAM):
        batch = trainer.shard_batch(jax.tree.map(jnp.asarray, batches[i]))
        state, out = trainer.step_fn(task, (micro + 1) % 2 == 0)(
            state, batch["pixel_values"], batch["task_input"], jax.random.PRNGKey(0))
        losses.append(float(out["loss"]))
    want = multitask_from_jax(jax.tree.map(np.asarray, state.params), StreamformerConfig(**KW))
    got, got_losses, _ = case["ranks"][0]["sgd"]
    _close_params(got, want, 1e-3, "against JAX")
    np.testing.assert_allclose(got_losses, losses, rtol=1e-3)


def test_a_checkpoint_changes_topology(case):
    """Saved at data=2 x model=2 (whole tensors, rank 0 writing), it
    restores into one process bit for bit, and the next update at data=4
    equals the one-process one."""
    inp = case["inp"]
    from streamformer_tpu_torch.models.multitask import MultitaskModel
    from streamformer_tpu_torch.models.text_encoder import SiglipTextConfig

    model = MultitaskModel(StreamformerConfig(**KW), TASKS, SiglipTextConfig(**TEXT_KW),
                           device="cpu", generator=torch.Generator().manual_seed(1))
    meta = checkpoint.restore_checkpoint(inp["ckpt"], 0, model)
    assert meta["step"] == 2
    saved = case["ranks"][0]["adamw"][0]
    assert all(torch.equal(p.detach(), saved[n]) for n, p in model.named_parameters())
    want, losses, _ = worker.train_run(inp, None, "adamw", stream=inp["more"],
                                       restore=inp["ckpt"])
    for r, res in enumerate(case["ranks"]):
        got, got_losses, _ = res["resumed"]
        _close_params(got, want, 2 * LR["base_lr"], f"rank {r}")
        np.testing.assert_allclose(got_losses, losses, rtol=1e-5)
