"""The port's trainer: counterparts of the JAX package's trainer tests that
need neither a checkpoint library nor a mesh, and a four-micro-step run held
against the JAX trainer from the same weights and batches.

Tolerances against the JAX trainer (fp32, CPU): each step's loss within 1e-3
relative (the runs reach about 1e-5) and its gradient norm
within 1e-3 relative. Parameters after SGD updates within 1e-5 max-abs.
After AdamW updates parameters are held only to 2 lr: Adam's first updates
are g / |g|, so a gradient that is rounding noise in both packages becomes
an lr-sized difference.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from streamformer_tpu.config import StreamformerConfig as JaxConfig
from streamformer_tpu.models.multitask import MultitaskModel as JaxMultitask
from streamformer_tpu.models.text_encoder import SiglipTextConfig as JaxTextConfig
from streamformer_tpu.train import optim as jax_optim
from streamformer_tpu.train.trainer import MultitaskTrainer as JaxTrainer
from streamformer_tpu.train.trainer import TrainState as JaxTrainState
from streamformer_tpu_torch.checkpoint import multitask_from_jax
from streamformer_tpu_torch.config import StreamformerConfig
from streamformer_tpu_torch.models.multitask import MultitaskModel
from streamformer_tpu_torch.models.text_encoder import SiglipTextConfig
from streamformer_tpu_torch.train import metrics as metrics_lib
from streamformer_tpu_torch.train import optim
from streamformer_tpu_torch.train.trainer import MultitaskTrainer, NonFiniteLossError, TrainState

KW = dict(image_size=32, patch_size=16, num_frames=4, hidden_size=32, num_hidden_layers=2,
          num_attention_heads=4, intermediate_size=64, dtype="float32")
TEXT_KW = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
               intermediate_size=64, max_position_embeddings=8)
TASKS = {"Kinetics": {"label2id": {"a": 0, "b": 1}}}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these tensors are tiny, and the 6-worker run
    oversubscribes the cores with each worker's default thread pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _model(seed=0, **overrides):
    return MultitaskModel(StreamformerConfig(**dict(KW, **overrides)), TASKS,
                          SiglipTextConfig(**TEXT_KW), device="cpu",
                          generator=torch.Generator().manual_seed(seed))


def _class_batch(rng, b=4, l=3):
    lab = rng.standard_normal((l, 32)).astype(np.float32)
    lab /= np.linalg.norm(lab, axis=-1, keepdims=True)
    return {"pixel_values": rng.standard_normal((b, 4, 3, 32, 32)).astype(np.float32),
            "task_input": {"label_embeddings": lab, "label": rng.integers(0, l, b)}}


def _grounding_batch(rng, b=4):
    return {"pixel_values": rng.standard_normal((b, 4, 3, 32, 32)).astype(np.float32),
            "task_input": {"caption_ids": rng.integers(0, 64, (b, 8)).astype(np.int32),
                           "label": rng.integers(0, 2, (b, 4)).astype(np.float32)}}


def _params(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def test_four_micro_steps_match_the_jax_trainer():
    """Two tasks, update_freq=2, clip, decay, LLRD and the frozen text tower:
    the same weights, batches and schedule through both trainers."""
    jmodel = JaxMultitask(JaxConfig(use_pallas=False, **KW), TASKS,
                          text_cfg=JaxTextConfig(**TEXT_KW), rng=jax.random.PRNGKey(3))
    params = jax.tree.map(np.asarray, jmodel.params)
    rng = np.random.default_rng(4)
    for lp in params["backbone"]["layers"]:  # open the temporal path
        lp["temporal_attention_gating"] = np.asarray(0.5, np.float32)
    params["backbone"]["embeddings"]["time_embeddings"] = (
        0.1 * rng.standard_normal((4, 32)).astype(np.float32))
    model = _model()
    model.load_state_dict(multitask_from_jax(params, model.cfg))
    text_before = {n: p.clone() for n, p in model.named_parameters() if n.startswith("text.")}
    lr = dict(base_lr=1e-3, min_lr=1e-5, epochs=1, steps_per_epoch=2, warmup_steps=1)
    common = dict(weight_decay=0.05, clip_grad=1.0, layer_decay=0.75, num_layers=2)
    jparams = jax.tree.map(jnp.asarray, params)
    jtx = jax_optim.create_optimizer(jparams, jax_optim.cosine_lr_schedule(**lr),
                                     trainable_mask=jax_optim.trainable_mask_frozen_text(jparams),
                                     **common)
    jtrainer = JaxTrainer(jmodel, jtx, update_freq=2, donate_state=False)
    jstate = JaxTrainState.create(jparams, jtx)
    tx = optim.create_optimizer(model, optim.cosine_lr_schedule(**lr),
                                trainable_mask=optim.trainable_mask_frozen_text(model), **common)
    trainer = MultitaskTrainer(model, tx, update_freq=2)
    state = TrainState.create(model, tx)
    stream = [("Kinetics", _class_batch(rng)), ("CharadesSTA", _grounding_batch(rng)),
              ("CharadesSTA", _grounding_batch(rng)), ("Kinetics", _class_batch(rng))]
    key = jax.random.PRNGKey(0)
    for micro, (task, batch) in enumerate(stream):
        apply_update = (micro + 1) % 2 == 0
        jstate, ref = jtrainer.step_fn(task, apply_update)(
            jstate, jnp.asarray(batch["pixel_values"]),
            jax.tree.map(jnp.asarray, batch["task_input"]), key)
        state, out = trainer.step_fn(task, apply_update)(
            state, batch["pixel_values"], batch["task_input"], None)
        np.testing.assert_allclose(out["loss"].item(), float(ref["loss"]), rtol=1e-3,
                                   err_msg=f"micro-step {micro}")
        np.testing.assert_allclose(out["grad_norm"].item(), float(ref["grad_norm"]), rtol=1e-3,
                                   atol=1e-7)
        assert state.accum_count == int(jstate.accum_count) and state.step == int(jstate.step)
    assert state.step == 2 and tx.count == 2
    want = multitask_from_jax(jax.tree.map(np.asarray, jstate.params), model.cfg)
    for name, p in model.named_parameters():
        assert float((p.detach() - want[name]).abs().max()) <= 2 * lr["base_lr"], name
    assert all(torch.equal(p, text_before[n]) for n, p in model.named_parameters()
               if n.startswith("text."))  # not a bit of the text tower moved


def test_sgd_steps_match_the_jax_trainer_tightly():
    jmodel = JaxMultitask(JaxConfig(use_pallas=False, **KW), TASKS,
                          text_cfg=JaxTextConfig(**TEXT_KW), rng=jax.random.PRNGKey(5))
    params = jax.tree.map(np.asarray, jmodel.params)
    model = _model()
    model.load_state_dict(multitask_from_jax(params, model.cfg))
    jtx = optax.sgd(0.1)
    jtrainer = JaxTrainer(jmodel, jtx, update_freq=1, donate_state=False)
    jstate = JaxTrainState.create(jax.tree.map(jnp.asarray, params), jtx)
    tx = optim.create_optimizer(model, lambda step: 0.1, weight_decay=0.0, betas=(0.0, 0.0),
                                opt_name="sgd")
    trainer = MultitaskTrainer(model, tx)
    state = TrainState.create(model, tx)
    rng = np.random.default_rng(6)
    for _ in range(2):
        batch = _class_batch(rng)
        jstate, _ = jtrainer.step_fn("Kinetics", True)(
            jstate, jnp.asarray(batch["pixel_values"]),
            jax.tree.map(jnp.asarray, batch["task_input"]), jax.random.PRNGKey(0))
        state, _ = trainer.step_fn("Kinetics", True)(state, batch["pixel_values"],
                                                     batch["task_input"])
    want = multitask_from_jax(jax.tree.map(np.asarray, jstate.params), model.cfg)
    for name, p in model.named_parameters():
        assert float((p.detach() - want[name]).abs().max()) <= 1e-5, name


def test_multitask_training_loss_decreases():
    model = _model()
    lr = optim.cosine_lr_schedule(3e-3, 1e-5, epochs=1, steps_per_epoch=20)
    tx = optim.create_optimizer(model, lr, weight_decay=0.01, clip_grad=1.0)
    trainer = MultitaskTrainer(model, tx, update_freq=1)
    state = TrainState.create(model, tx)
    rng = np.random.default_rng(0)
    cb, gb = _class_batch(rng), _grounding_batch(rng)
    first, last = {}, {}
    for _ in range(8):
        for task, batch in (("Kinetics", cb), ("CharadesSTA", gb)):
            state, out = trainer.step_fn(task, True)(state, batch["pixel_values"],
                                                     batch["task_input"])
            first.setdefault(task, out["loss"].item())
            last[task] = out["loss"].item()
    for task in first:
        assert last[task] < first[task], (task, first[task], last[task])
    assert state.step == 16


def test_grad_accumulation_equivalence():
    """update_freq=2 on two identical batches == one step on the batch."""
    batch = _class_batch(np.random.default_rng(1))
    results = []
    for update_freq in (1, 2):
        model = _model(seed=2)
        tx = optim.create_optimizer(model, lambda step: 0.1, weight_decay=0.0, betas=(0.0, 0.0),
                                    opt_name="sgd")
        trainer = MultitaskTrainer(model, tx, update_freq=update_freq)
        state = TrainState.create(model, tx)
        for i in range(update_freq):
            state, out = trainer.step_fn("Kinetics", i == update_freq - 1)(
                state, batch["pixel_values"], batch["task_input"])
        results.append((_params(model), out["grad_norm"].item()))
        assert state.step == 1 and state.accum_count == 0
        assert all(float(b.abs().max()) == 0.0 for b in state.grad_accum.values())
    name = "backbone.encoder.layer.0.attention.attention.qkv.weight"
    np.testing.assert_allclose(results[0][0][name].numpy(), results[1][0][name].numpy(), atol=1e-6)
    np.testing.assert_allclose(results[0][1], results[1][1], rtol=1e-6)


def _trainer(update_freq=1, steps=6, **overrides):
    model = _model(**overrides)
    lr = optim.cosine_lr_schedule(1e-3, 1e-5, epochs=1, steps_per_epoch=steps)
    tx = optim.create_optimizer(model, lr, weight_decay=0.01)
    return MultitaskTrainer(model, tx, update_freq=update_freq), TrainState.create(model, tx), lr


def test_epoch_start_discards_leftover_accum():
    trainer, state, _ = _trainer(update_freq=2, steps=2)
    rng = np.random.default_rng(2)
    batches = [("Kinetics", _class_batch(rng)) for _ in range(3)]  # odd
    state, _ = trainer.train_one_epoch(state, iter(batches), 0)
    assert state.accum_count == 1
    leftover = {n: b.clone() for n, b in state.grad_accum.items()}
    assert any(float(b.abs().max()) > 0 for b in leftover.values())
    state, _ = trainer.train_one_epoch(state, iter(batches), 1)
    assert state.accum_count == 1  # 3 % 2, from THIS epoch only
    assert state.step == 2


def test_logged_lr_matches_applied_lr():
    """The opt/lr point logged for an update is the rate that update was
    APPLIED with: the schedule at the count before the update."""
    model = _model()
    lr = optim.cosine_lr_schedule(1e-2, 1e-5, epochs=1, steps_per_epoch=4, warmup_epochs=1)
    tx = optim.create_optimizer(model, lr, weight_decay=0.01)
    trainer = MultitaskTrainer(model, tx)
    state = TrainState.create(model, tx)
    rng = np.random.default_rng(3)
    batches = [("Kinetics", _class_batch(rng)) for _ in range(4)]
    logged, applied = [], []

    class _Writer:
        def set_step(self):
            pass

        def update(self, head="", **kw):
            if head == "opt" and "lr" in kw:
                logged.append(kw["lr"])

    inner_step = tx.inner.step

    def spy():
        applied.append(max(g["lr"] for g in tx.param_groups))
        inner_step()

    tx.inner.step = spy
    trainer.train_one_epoch(state, iter(batches), 0, log_writer=_Writer(), lr_schedule=lr,
                            print_freq=1)
    want = [lr(i) for i in range(4)]
    np.testing.assert_allclose(logged, want, rtol=1e-6)
    np.testing.assert_allclose(applied, want, rtol=1e-6)  # no off-by-one in what was applied
    jax_lr = jax_optim.cosine_lr_schedule(1e-2, 1e-5, epochs=1, steps_per_epoch=4, warmup_epochs=1)
    np.testing.assert_allclose(logged, [float(jax_lr(i)) for i in range(4)], rtol=5e-6)


def test_non_finite_loss_raises_at_the_flush():
    trainer, state, _ = _trainer()
    batch = _class_batch(np.random.default_rng(4))
    batch["pixel_values"][0, 0, 0, 0, 0] = np.nan
    with pytest.raises(NonFiniteLossError, match="Kinetics"):
        trainer.train_one_epoch(state, iter([("Kinetics", batch)]), 0)


def test_preemption_stops_only_on_update_boundary():
    trainer, state, _ = _trainer(update_freq=2, steps=4)
    rng = np.random.default_rng(5)
    batches = [("Kinetics", _class_batch(rng)) for _ in range(8)]
    state, stats = trainer.train_one_epoch(state, iter(batches), 0, should_stop=lambda: True)
    # stopped at the FIRST update boundary: 2 micro-batches, 1 update
    assert stats["preempted_at_micro"] == 2
    assert state.step == 1 and state.accum_count == 0


def test_preemption_stop_and_exact_resume_with_dropout():
    """An early stop after the third update and a resume from micro-step 3
    reproduce an uninterrupted epoch bit for bit, dropout and stochastic
    depth on: micro-step m draws the same masks either way."""
    rng = np.random.default_rng(6)
    batches = [("Kinetics", _class_batch(rng)) for _ in range(6)]
    rates = dict(hidden_dropout_prob=0.1, drop_path_rate=0.1)

    trainer, state_a, _ = _trainer(**rates)
    state_a, stats_a = trainer.train_one_epoch(state_a, iter(batches), 0,
                                               torch.Generator().manual_seed(7))
    assert "preempted_at_micro" not in stats_a

    trainer, state_b, _ = _trainer(**rates)
    polls = []

    def stop():
        polls.append(1)
        return len(polls) >= 3

    state_b, stats_b = trainer.train_one_epoch(state_b, iter(batches), 0,
                                               torch.Generator().manual_seed(7), should_stop=stop)
    assert stats_b["preempted_at_micro"] == 3 and state_b.step == 3
    state_b, _ = trainer.train_one_epoch(state_b, iter(batches[3:]), 0,
                                         torch.Generator().manual_seed(7), start_micro=3)
    assert state_b.step == 6
    a, b = _params(state_a.model), _params(state_b.model)
    assert all(torch.equal(a[n], b[n]) for n in a)
    # the masks matter: another seed gives other parameters
    trainer, state_c, _ = _trainer(**rates)
    state_c, _ = trainer.train_one_epoch(state_c, iter(batches), 0,
                                         torch.Generator().manual_seed(8))
    c = _params(state_c.model)
    assert any(not torch.equal(a[n], c[n]) for n in a)


def test_profile_steps_capture_a_trace(tmp_path):
    trainer, state, _ = _trainer()
    rng = np.random.default_rng(7)
    batches = [("Kinetics", _class_batch(rng)) for _ in range(6)]
    state, _ = trainer.train_one_epoch(state, iter(batches), 0, profile_steps=2,
                                       profile_dir=str(tmp_path / "profile"))
    assert state.step == 6
    assert (tmp_path / "profile" / "trace_epoch0.json").stat().st_size > 0
    assert trainer.last_profile is not None and len(trainer.last_profile.key_averages()) > 0
    # an epoch that ends inside the window still stops the trace and trains every batch
    trainer, state, _ = _trainer(steps=3)
    state, _ = trainer.train_one_epoch(state, iter(batches[:3]), 0, profile_steps=50,
                                       profile_dir=str(tmp_path / "p2"))
    assert state.step == 3 and (tmp_path / "p2" / "trace_epoch0.json").exists()


def test_encode_texts_reads_the_current_text_tower():
    model = _model()
    base = model.encode_texts(["a video of a dog"]).numpy()
    with torch.no_grad():
        for p in model.text.parameters():
            p.zero_()
    assert not np.allclose(base, model.encode_texts(["a video of a dog"]).numpy())


def test_a_mesh_is_refused_and_stats_are_averages():
    """A mesh that is not a DeviceMesh of dims ("data", "model") is refused
    (the multi-process trainer: tests/test_torch_dist_train.py)."""
    trainer, state, _ = _trainer()
    with pytest.raises(ValueError, match="DeviceMesh"):
        MultitaskTrainer(trainer.model, trainer.tx, mesh=object())
    rng = np.random.default_rng(8)
    batches = [("Kinetics", _class_batch(rng)), ("CharadesSTA", _grounding_batch(rng))]
    state, stats = trainer.train_one_epoch(state, iter(batches), 0)
    assert set(stats) == {"loss_Kinetics", "loss_CharadesSTA", "loss", "grad_norm"}
    assert math.isclose(stats["loss"], (stats["loss_Kinetics"] + stats["loss_CharadesSTA"]) / 2,
                        rel_tol=1e-6)


def test_metrics_meters_and_log_line(tmp_path):
    meter = metrics_lib.SmoothedValue(window_size=3)
    for v in (1.0, 2.0, 6.0, 3.0):
        meter.update(v)
    assert meter.median == 3.0 and meter.max == 6.0 and meter.value == 3.0
    assert meter.global_avg == 3.0 and math.isclose(meter.avg, 11.0 / 3)
    logger = metrics_lib.MetricLogger()
    logger.update(loss=torch.tensor(2.0), lr=0.1)
    assert logger.loss.global_avg == 2.0 and "lr: 0.1000" in str(logger)
    with pytest.raises(AttributeError):
        logger.missing
    assert list(logger.log_every(range(3), 2, header="x")) == [0, 1, 2]
    metrics_lib.write_log_line(str(tmp_path / "out"), {"epoch": 1, "loss": 0.5})
    metrics_lib.write_log_line(str(tmp_path / "out"), {"epoch": 2})
    lines = (tmp_path / "out" / "log.txt").read_text().splitlines()
    assert lines == ['{"epoch": 1, "loss": 0.5}', '{"epoch": 2}']
