"""The port's optimizer factory against the JAX package's optax chain.

The decayed set, the LLRD scales and the LoRA mask are held to the images of
the JAX package's under ``checkpoint.convert``'s name map: a JAX tree of
per-leaf values is carried across as if it were weights, and every element
of every port tensor must then hold the port's value for that tensor.

Tolerances. Schedules: 2e-7 of the base rate at every step, and 5e-6
relative (XLA's and numpy's fp32 cosines differ by an ulp, which the
cosine's tail, where the rate is near its floor, turns into a few 1e-6
relative; warm-up and the body agree to 1e-7). Updates: parameters after
each of three updates within 1e-6 max-abs of optax's, from identical
gradients, for AdamW, SGD with momentum and Lion, with clip, decay, LLRD and
the frozen text tower.
"""

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
from streamformer_tpu_torch.checkpoint import multitask_from_jax
from streamformer_tpu_torch.config import StreamformerConfig
from streamformer_tpu_torch.models.multitask import MultitaskModel
from streamformer_tpu_torch.models.text_encoder import SiglipTextConfig
from streamformer_tpu_torch.train import optim

KW = dict(image_size=32, patch_size=16, num_frames=4, hidden_size=32, num_hidden_layers=2,
          num_attention_heads=4, intermediate_size=64, dtype="float32")
TEXT_KW = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
               intermediate_size=64, max_position_embeddings=8)
L = KW["num_hidden_layers"]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these tensors are tiny, and the 6-worker run
    oversubscribes the cores with each worker's default thread pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(lora=False):
    kw = dict(KW, **(dict(add_lora_spatial=True, lora_rank=4) if lora else {}))
    jmodel = JaxMultitask(JaxConfig(use_pallas=False, **kw), {}, text_cfg=JaxTextConfig(**TEXT_KW))
    params = jax.tree.map(np.asarray, jmodel.params)
    if lora:
        rng = np.random.default_rng(0)
        for lp in params["backbone"]["layers"]:
            for name, width in (("qkv", 96), ("out", 32)):
                lp["attention"][name]["lora_a"] = 0.05 * rng.standard_normal((32, 4)).astype(np.float32)
                lp["attention"][name]["lora_b"] = 0.05 * rng.standard_normal((4, width)).astype(np.float32)
    cfg = StreamformerConfig(**kw)
    model = MultitaskModel(cfg, {}, SiglipTextConfig(**TEXT_KW), device="cpu")
    model.load_state_dict(multitask_from_jax(params, cfg))
    return params, model


def _image(params, values, cfg):
    """Carry a JAX tree of per-leaf scalars across the name map: each port
    tensor filled with its JAX leaf's value."""
    filled = jax.tree.map(lambda p, v: np.full(np.shape(p), float(v), np.float32), params, values)
    return multitask_from_jax(filled, cfg)


def test_weight_decay_mask_is_the_image_of_the_jax_mask():
    params, model = _pair(lora=True)
    image = _image(params, jax_optim.weight_decay_mask(params), model.cfg)
    mask = optim.weight_decay_mask(model)
    assert set(mask) == set(image)
    for name, decayed in mask.items():
        assert bool((image[name] == float(decayed)).all()), name
    # counterparts of the JAX package's spot checks, and the shapes that differ
    assert mask["logit_scale"] is False
    assert mask["backbone.post_layernorm.weight"] is False
    assert mask["backbone.encoder.layer.0.attention.attention.qkv.weight"] is True
    assert mask["backbone.head.probe"] is False  # (1, 1, D) here, (D,) there
    assert mask["backbone.embeddings.position_embeddings"] is True
    assert mask["backbone.embeddings.patch_embeddings.projection.weight"] is True
    assert mask["backbone.head.attention.in_proj_weight"] is True
    assert mask["backbone.head.attention.in_proj_bias"] is False
    assert mask["backbone.encoder.layer.0.temporal_attention_gating"] is False


def test_layer_decay_scales_are_the_image_of_the_jax_scales():
    params, model = _pair(lora=True)
    image = _image(params, jax_optim.layer_decay_scales(params, L, 0.75), model.cfg)
    scales = optim.layer_decay_scales(model, L, 0.75)
    for name, scale in scales.items():
        assert bool((image[name] == np.float32(scale)).all()), name
    emb = scales["backbone.embeddings.position_embeddings"]
    l0 = scales["backbone.encoder.layer.0.attention.attention.qkv.weight"]
    l1 = scales["backbone.encoder.layer.1.attention.attention.qkv.weight"]
    assert emb < l0 < l1 < scales["backbone.head.probe"] == 1.0


def test_trainable_masks_are_the_images_of_the_jax_masks():
    params, model = _pair(lora=True)
    jmask = {"backbone": jax_optim.trainable_mask_lora_spatial(params["backbone"]),
             "text": jax.tree.map(lambda _: True, params["text"]),
             "logit_scale": True, "logit_bias": True}
    image = _image(params, jmask, model.cfg)
    mask = optim.trainable_mask_lora_spatial(model)
    for name, trainable in mask.items():
        assert bool((image[name] == float(trainable)).all()), name
    l0 = "backbone.encoder.layer.0."
    assert mask[l0 + "attention.attention.qkv.weight"] is False
    assert mask[l0 + "attention.output.dense.bias"] is False
    assert mask[l0 + "attention.attention.qkv_lora_a.weight"] is True
    assert mask[l0 + "temporal_attention.attention.qkv.weight"] is True
    assert mask[l0 + "intermediate.dense.weight"] is True
    assert mask["backbone.head.attention.out_proj.weight"] is True
    frozen = optim.trainable_mask_frozen_text(model)
    image = _image(params, jax_optim.trainable_mask_frozen_text(params), model.cfg)
    for name, trainable in frozen.items():
        assert bool((image[name] == float(trainable)).all()), name
    assert all(optim.trainable_mask_all(model).values())


SCHEDULES = [
    dict(base_lr=1e-3, min_lr=1e-6, epochs=2, steps_per_epoch=50, warmup_epochs=1),
    dict(base_lr=3e-3, min_lr=1e-5, epochs=1, steps_per_epoch=20),
    dict(base_lr=1e-2, min_lr=1e-5, epochs=1, steps_per_epoch=37, warmup_steps=5),
    dict(base_lr=1e-2, min_lr=1e-5, epochs=1, steps_per_epoch=4, warmup_epochs=1),
]


@pytest.mark.parametrize("kw", SCHEDULES, ids=lambda kw: f"{kw['epochs']}x{kw['steps_per_epoch']}")
def test_lr_schedule_equals_optax_at_every_step(kw):
    ours, theirs = optim.cosine_lr_schedule(**kw), jax_optim.cosine_lr_schedule(**kw)
    for step in range(kw["epochs"] * kw["steps_per_epoch"] + 3):  # and past the end
        want = float(theirs(step))
        assert abs(ours(step) - want) <= 2e-7 * kw["base_lr"], step
        assert abs(ours(step) - want) <= 5e-6 * abs(want), step


def test_lr_schedule_warmup_and_decay():
    sched = optim.cosine_lr_schedule(1e-3, 1e-6, epochs=2, steps_per_epoch=50, warmup_epochs=1)
    assert sched(0) < 1e-4
    np.testing.assert_allclose(sched(50), 1e-3, rtol=1e-4)
    assert sched(99) < 2e-4


def test_wd_schedule_equals_optax_and_scale_lr():
    ours = optim.cosine_wd_schedule(0.05, 0.5, 2, 10)
    theirs = jax_optim.cosine_wd_schedule(0.05, 0.5, 2, 10)
    for step in range(24):
        assert abs(ours(step) - float(theirs(step))) <= 5e-7 * 0.5, step
    assert optim.cosine_wd_schedule(0.05, None, 2, 10)(7) == 0.05
    assert optim.scale_lr(1e-3, 512, 2) == jax_optim.scale_lr(1e-3, 512, 2) == 4e-3


def _grads(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: rng.standard_normal(np.shape(p)).astype(np.float32), params)


@pytest.mark.parametrize("opt_name,betas", [("adamw", (0.9, 0.999)), ("sgd", (0.9, 0.999)),
                                            ("lion", (0.9, 0.99))])
@pytest.mark.parametrize("wd_end", [None, 0.2], ids=["fixed-wd", "wd-schedule"])
def test_updates_equal_optax(opt_name, betas, wd_end):
    """Three updates with clip, decoupled decay, LLRD and the frozen text
    tower, from the same gradients (random, far above the clip, the text
    tower's included so that a clip over all leaves would show)."""
    params, model = _pair()
    lr = dict(base_lr=1e-2, min_lr=1e-4, epochs=1, steps_per_epoch=6, warmup_steps=2)
    common = dict(weight_decay=0.05, betas=betas, clip_grad=1.0, layer_decay=0.75, num_layers=L,
                  opt_name=opt_name)
    jparams = jax.tree.map(jnp.asarray, params)
    tx = jax_optim.create_optimizer(
        jparams, jax_optim.cosine_lr_schedule(**lr),
        wd_schedule=jax_optim.cosine_wd_schedule(0.05, wd_end, 1, 6) if wd_end else None,
        trainable_mask=jax_optim.trainable_mask_frozen_text(jparams), **common)
    opt_state = tx.init(jparams)
    ours = optim.create_optimizer(
        model, optim.cosine_lr_schedule(**lr),
        wd_schedule=optim.cosine_wd_schedule(0.05, wd_end, 1, 6) if wd_end else None,
        trainable_mask=optim.trainable_mask_frozen_text(model), **common)
    named = dict(model.named_parameters())
    text_before = {n: p.clone() for n, p in named.items() if n.startswith("text.")}
    for step in range(3):
        grads = _grads(params, 100 + step)
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, grads), opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for name, g in multitask_from_jax(grads, model.cfg).items():
            if named[name].requires_grad:
                named[name].grad = g
        ours.step()
        want = multitask_from_jax(jax.tree.map(np.asarray, jparams), model.cfg)
        for name, p in named.items():
            err = float((p.detach() - want[name]).abs().max())
            assert err <= 1e-6, (step, name, err)
    assert ours.count == 3
    assert all(torch.equal(named[n], t) for n, t in text_before.items())


def test_layer_decay_composes_with_trainable_mask():
    params, model = _pair()
    lr = optim.cosine_lr_schedule(1e-3, 1e-6, epochs=1, steps_per_epoch=10)
    tx = optim.create_optimizer(model, lr, weight_decay=0.01, clip_grad=1.0, layer_decay=0.75,
                                num_layers=L, trainable_mask=optim.trainable_mask_frozen_text(model))
    named = dict(model.named_parameters())
    before = {n: p.detach().clone() for n, p in named.items()}
    for p in named.values():
        if p.requires_grad:
            p.grad = torch.ones_like(p)
    tx.step()
    moved = {n: float((p.detach() - before[n]).abs().max()) for n, p in named.items()}
    assert all(moved[n] == 0.0 for n in named if n.startswith("text."))  # frozen: not a bit moves
    # LLRD ordering: |update| grows with depth (embeddings < layer 0 < head)
    assert (moved["backbone.embeddings.position_embeddings"]
            < moved["backbone.encoder.layer.0.attention.attention.qkv.weight"]
            < moved["backbone.head.probe"])
    groups = tx.param_groups
    assert len({(g["lr_scale"], g["decayed"]) for g in groups}) == len(groups)
    assert sum(len(g["params"]) for g in groups) == sum(p.requires_grad for p in named.values())


def test_a_parameter_without_a_gradient_is_stepped_with_zero_and_state_round_trips():
    """optax steps every leaf: a leaf whose gradient is absent still decays
    and still advances Adam's moments. The optimizer's state dict carries
    the update count."""
    _, model = _pair()
    tx = optim.create_optimizer(model, lambda step: 0.1, weight_decay=0.5)
    w = model.backbone.encoder.layer[0].intermediate.dense.weight
    before = w.detach().clone()
    tx.step()  # no gradient anywhere
    np.testing.assert_allclose(w.detach().numpy(), (before * (1 - 0.1 * 0.5)).numpy(), rtol=1e-6)
    state = tx.state_dict()
    fresh = optim.create_optimizer(model, lambda step: 0.1, weight_decay=0.5)
    fresh.load_state_dict(state)
    assert fresh.count == 1
    with pytest.raises(ValueError):
        optim.create_optimizer(model, lambda step: 0.1, opt_name="adagrad")
