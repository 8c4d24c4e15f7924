"""The port's ``MultitaskModel`` against the JAX package's, on the CPU in
fp32: ``loss_fn`` for one task of each of the seven kinds, and the gradient
of the whole slice (every backbone leaf, ``logit_scale``, ``logit_bias``)
against ``jax.grad`` of the JAX ``loss_fn``, with remat off and on, LoRA off
and on. Weights and gradient trees are carried across by
``checkpoint.convert.multitask_from_jax``. Dropout and stochastic depth
cannot match the JAX package's random streams; the parity runs keep their
rates at 0 and the masks get tests of their own.

Tolerances: loss 1e-4 max-abs; each gradient leaf 1e-4 of that leaf's
largest JAX gradient magnitude (floored at 1e-6 absolute, for leaves whose
gradient is rounding noise). The runs reach about 2e-5 of the leaf's largest
magnitude.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from streamformer_tpu.config import StreamformerConfig as JaxConfig
from streamformer_tpu.models.multitask import MultitaskModel as JaxMultitask
from streamformer_tpu.models.text_encoder import SiglipTextConfig as JaxTextConfig
from streamformer_tpu_torch.checkpoint import multitask_from_jax
from streamformer_tpu_torch.config import StreamformerConfig
from streamformer_tpu_torch.models import encoder, multitask
from streamformer_tpu_torch.models.multitask import MultitaskModel
from streamformer_tpu_torch.models.text_encoder import SiglipTextConfig

KW = dict(image_size=32, patch_size=16, num_frames=4, hidden_size=32, num_hidden_layers=2,
          num_attention_heads=4, intermediate_size=64, dtype="float32")
TEXT_KW = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
               intermediate_size=64, max_position_embeddings=8)
TASKS = {"Kinetics": {"label2id": {"a": 0, "b": 1}}}
B, T, D, N = 4, 4, 32, 4
ONE_TASK_PER_KIND = ["Kinetics", "TaskRetrieval", "CharadesSTA", "TaskLocalization", "THUMOS14",
                     "YoutubeVIS", "MEVIS"]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these tensors are tiny, and the 6-worker run
    oversubscribes the cores with each worker's default thread pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _open(params, seed, lora_rank=0):
    """Open the zero-initialised parts (gates, embeddings, biases), so that
    every leaf receives a gradient that matters; add LoRA factors if asked."""
    rng = np.random.default_rng(seed)
    bb = params["backbone"]
    for key in ("position_embeddings", "time_embeddings"):
        bb["embeddings"][key] = 0.1 * rng.standard_normal(bb["embeddings"][key].shape).astype(np.float32)
    for lp in bb["layers"]:
        lp["temporal_attention_gating"] = np.asarray(0.7, np.float32)
        for name, width in (("qkv", 3 * D), ("out", D)):
            lp["attention"][name]["bias"] = 0.02 * rng.standard_normal(width).astype(np.float32)
            if lora_rank:
                lp["attention"][name]["lora_a"] = 0.05 * rng.standard_normal((D, lora_rank)).astype(np.float32)
                lp["attention"][name]["lora_b"] = 0.05 * rng.standard_normal((lora_rank, width)).astype(np.float32)
    return params


def _pair(lora=False, remat="none", grounding_head="default", seed=0, **overrides):
    kw = dict(KW, remat=remat, **overrides)
    if lora:
        kw.update(add_lora_spatial=True, lora_rank=4)
    jmodel = JaxMultitask(JaxConfig(use_pallas=False, **kw), TASKS,
                          text_cfg=JaxTextConfig(**TEXT_KW), rng=jax.random.PRNGKey(seed),
                          grounding_head=grounding_head)
    params = _open(jax.tree.map(np.asarray, jmodel.params), seed + 1, 4 if lora else 0)
    cfg = StreamformerConfig(**kw)
    model = MultitaskModel(cfg, TASKS, SiglipTextConfig(**TEXT_KW), device="cpu",
                           grounding_head=grounding_head)
    model.load_state_dict(multitask_from_jax(params, cfg))
    return jmodel, params, model


def _batch(task, seed=5):
    rng = np.random.default_rng(seed)
    kind = multitask.head_type_for_task(task)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    unit = lambda x: x / np.linalg.norm(x, axis=-1, keepdims=True)  # noqa: E731
    px = f(B, T, 3, 32, 32)
    captions = rng.integers(0, 64, (B, 8)).astype(np.int32)
    if kind == "classification":
        ti = {"label_embeddings": unit(f(3, D)), "label": rng.integers(0, 3, B).astype(np.int32)}
    elif kind == "retrieval":
        ti = {"caption_ids": captions}
    elif kind == "grounding":
        ti = {"caption_ids": captions, "label": rng.integers(0, 2, (B, T)).astype(np.float32)}
    elif kind == "universal_localization":
        mask = np.ones((B, 5), bool)
        mask[:, -1] = False
        ti = {"label_embeddings": unit(f(B, 5, D)), "class_mask": mask,
              "label": rng.integers(-1, 4, (B, T)).astype(np.int32)}
    elif kind == "naive_localization":  # B = 2 videos of 2 windows
        ti = {"label_embeddings": f(5, D),
              "target_labels": rng.integers(-1, 2, (2, 2 * T, 5)).astype(np.float32)}
    elif kind == "vis":
        ti = {"label_embeddings": unit(f(B, 5, D)), "class_mask": np.ones((B, 5), bool),
              "mask_target": rng.integers(-1, 5, (B, T, 8, 8)).astype(np.int32)}
    else:
        ti = {"caption_ids": captions,
              "mask_target": rng.integers(-1, 2, (B, T, 8, 8)).astype(np.int32)}
    return px, ti


def _jax_loss_and_grads(jmodel, params, task, px, ti):
    def loss(p):
        return jmodel.loss_fn(p, task, jnp.asarray(px), jax.tree.map(jnp.asarray, ti))

    (value, logits), grads = jax.value_and_grad(loss, has_aux=True)(jax.tree.map(jnp.asarray, params))
    return float(value), np.asarray(logits), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("task", ONE_TASK_PER_KIND)
def test_loss_fn_matches_jax_for_each_kind_of_task(task):
    jmodel, params, model = _pair()
    px, ti = _batch(task)
    ref_loss, ref_logits, _ = _jax_loss_and_grads(jmodel, params, task, px, ti)
    loss, logits = model.loss_fn(task, torch.from_numpy(px), ti)
    np.testing.assert_allclose(loss.item(), ref_loss, atol=1e-4, rtol=0)
    np.testing.assert_allclose(logits.detach().numpy(), ref_logits, atol=1e-4, rtol=0)


def test_contrastive_grounding_head_matches_jax():
    jmodel, params, model = _pair(grounding_head="contrastive")
    px, ti = _batch("CharadesSTA")
    ref_loss, ref_logits, _ = _jax_loss_and_grads(jmodel, params, "CharadesSTA", px, ti)
    loss, logits = model.loss_fn("CharadesSTA", px, ti)  # numpy pixel values are taken too
    np.testing.assert_allclose(loss.item(), ref_loss, atol=1e-4, rtol=0)
    assert logits.shape == ref_logits.shape == (B * T, B)


@pytest.mark.parametrize("remat", ["none", "layer"])
@pytest.mark.parametrize("lora", [False, True], ids=["base", "lora"])
@pytest.mark.parametrize("task", ["Kinetics", "YoutubeVIS"])
def test_whole_slice_gradient_matches_jax_grad(task, lora, remat):
    """Every trainable leaf: the backbone through the autograd Functions'
    plain backwards (kernels I and H on the card), the MAP head, the
    embeddings, the gates, LoRA, ``logit_scale`` and ``logit_bias``."""
    jmodel, params, model = _pair(lora=lora, remat=remat)
    px, ti = _batch(task, seed=6)
    _, _, ref = _jax_loss_and_grads(jmodel, params, task, px, ti)
    ref = multitask_from_jax(ref, model.cfg)
    loss, _ = model.loss_fn(task, torch.from_numpy(px), ti)
    loss.backward()
    named = dict(model.named_parameters())
    assert set(ref) == set(named)
    checked = 0
    for name, p in named.items():
        if name.startswith("text."):  # frozen: no gradient here, exactly zero in JAX
            assert p.grad is None and float(ref[name].abs().max()) == 0.0
            continue
        if task == "YoutubeVIS" and name in ("backbone.head.probe",
                                             "backbone.head.attention.in_proj_weight",
                                             "backbone.head.attention.in_proj_bias") \
                or task == "YoutubeVIS" and name.startswith("backbone.head."):
            # the VIS head reaches the MAP head only through its detached copy
            assert p.grad is None or float(p.grad.abs().max()) == 0.0
            assert float(ref[name].abs().max()) == 0.0
            continue
        assert p.grad is not None, name
        bound = max(1e-4 * float(ref[name].abs().max()), 1e-6)
        err = float((p.grad - ref[name]).abs().max())
        assert err <= bound, (name, err, bound)
        checked += 1
    assert checked >= 50 + (16 if lora else 0) - (10 if task == "YoutubeVIS" else 0)


def test_remat_recomputes_with_the_same_masks():
    """With dropout and stochastic depth on, remat="layer" gives the
    gradients of remat="none" bit for bit: the recompute in the backward
    draws the masks the forward drew."""
    grads = {}
    for remat in ("none", "layer"):
        _, _, model = _pair(remat=remat, hidden_dropout_prob=0.2, drop_path_rate=0.3)
        px, ti = _batch("Kinetics", seed=7)
        gen = torch.Generator().manual_seed(11)
        loss, _ = model.loss_fn("Kinetics", torch.from_numpy(px), ti, generator=gen,
                                deterministic=False)
        loss.backward()
        grads[remat] = ({n: p.grad.clone() for n, p in model.named_parameters()
                         if p.grad is not None}, loss.item(), gen.get_state())
    assert grads["none"][1] == grads["layer"][1]
    assert torch.equal(grads["none"][2], grads["layer"][2])  # the generator ends where it ended
    assert grads["none"][0].keys() == grads["layer"][0].keys()
    for name, g in grads["none"][0].items():
        assert torch.equal(g, grads["layer"][0][name]), name


def test_dropout_and_drop_path():
    gen = torch.Generator().manual_seed(0)
    x = torch.ones(64, 8, 50)
    assert encoder.dropout(x, 0.0, gen, False) is x  # rate 0: the identity
    assert encoder.dropout(x, 0.5, gen, True) is x  # deterministic
    assert encoder.dropout(x, 0.5, None, False) is x  # no generator, no dropout (as rng=None)
    assert encoder.drop_path(x, 0.0, gen, False) is x
    kept = float(torch.tensor(1.0) / 0.75)  # a survivor, in fp32
    y = encoder.dropout(x, 0.25, gen, False)
    assert set(y.unique().tolist()) == {0.0, kept}
    assert abs(float(y.mean()) - 1.0) < 0.02  # the expectation is kept
    z = encoder.drop_path(x, 0.25, gen, False)
    per_sample = z.flatten(1)
    assert bool(((per_sample == 0).all(1) | (per_sample == kept).all(1)).all())  # one draw a sample
    assert 0 < int((per_sample[:, 0] == 0).sum()) < 64
    assert abs(float(encoder.drop_path(torch.ones(4000, 1), 0.25, gen, False).mean()) - 1.0) < 0.05
    again = encoder.dropout(x, 0.25, torch.Generator().manual_seed(0), False)
    assert torch.equal(encoder.dropout(x, 0.25, torch.Generator().manual_seed(0), False), again)
    cfg = StreamformerConfig(num_hidden_layers=5, drop_path_rate=0.2)
    assert encoder._drop_path_rates(cfg) == pytest.approx([0.0, 0.05, 0.1, 0.15, 0.2])
    assert encoder._drop_path_rates(cfg.replace(num_hidden_layers=1)) == [0.0]


def test_training_mode_changes_the_output_and_rate_zero_does_not():
    _, _, model = _pair(hidden_dropout_prob=0.2, drop_path_rate=0.2)
    px = torch.from_numpy(_batch("Kinetics")[0])
    base = encoder.model_forward(model.backbone, px)["pooler_output"]
    gen = torch.Generator().manual_seed(3)
    noisy = encoder.model_forward(model.backbone, px, generator=gen,
                                  deterministic=False)["pooler_output"]
    assert not torch.allclose(base, noisy)
    _, _, plain = _pair()  # the flagship's rates: 0
    out = encoder.model_forward(plain.backbone, px, generator=gen, deterministic=False)
    np.testing.assert_array_equal(out["pooler_output"].detach().numpy(),
                                  encoder.model_forward(plain.backbone, px)["pooler_output"]
                                  .detach().numpy())


def test_master_parameters_are_fp32_under_bf16_compute():
    """The trainer's encoder keeps fp32 parameters whatever ``cfg.dtype``;
    the serving encoder keeps them in the compute dtype without grad; a bf16
    step gives fp32 gradients close to the fp32 step's."""
    cfg = StreamformerConfig(**dict(KW, dtype="bfloat16"))
    model = MultitaskModel(cfg, TASKS, SiglipTextConfig(**TEXT_KW), device="cpu",
                           generator=torch.Generator().manual_seed(0))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(p.requires_grad for p in model.backbone.parameters())
    serving = encoder.StreamformerEncoder(cfg, device="cpu")
    assert serving.encoder.layer[0].intermediate.dense.weight.dtype == torch.bfloat16
    assert not any(p.requires_grad for p in serving.parameters())
    assert not encoder.model_forward(serving, torch.zeros(1, 2, 3, 32, 32))["pooler_output"].requires_grad
    px, ti = _batch("Kinetics")
    loss, _ = model.loss_fn("Kinetics", torch.from_numpy(px), ti)
    loss.backward()
    g16 = model.backbone.encoder.layer[0].intermediate.dense.weight.grad
    assert g16.dtype == torch.float32
    ref = MultitaskModel(cfg.replace(dtype="float32"), TASKS, SiglipTextConfig(**TEXT_KW),
                         device="cpu")
    ref.load_state_dict(model.state_dict())
    loss32, _ = ref.loss_fn("Kinetics", torch.from_numpy(px), ti)
    loss32.backward()
    g32 = ref.backbone.encoder.layer[0].intermediate.dense.weight.grad
    assert abs(loss.item() - loss32.item()) < 0.05 * abs(loss32.item())
    cos = torch.nn.functional.cosine_similarity(g16.flatten(), g32.flatten(), dim=0)
    assert float(cos) > 0.98


def test_tokenizer_contract_and_label_tables_match_jax(monkeypatch):
    jmodel, params, model = _pair()
    texts = ["A video of a Dog", "two words", ""]
    np.testing.assert_array_equal(model.tokenize(texts), jmodel.tokenize(texts))
    jmodel.params = jax.tree.map(jnp.asarray, params)
    np.testing.assert_allclose(model.encode_texts(texts).numpy(),
                               np.asarray(jmodel.encode_texts(texts)), atol=1e-5, rtol=0)
    model.prepare_for_multi_tasks()
    jmodel.prepare_for_multi_tasks()
    np.testing.assert_allclose(model.label_embeddings["Kinetics"].numpy(),
                               np.asarray(jmodel.label_embeddings["Kinetics"]), atol=1e-5, rtol=0)
    assert not model.label_embeddings["Kinetics"].requires_grad
    # the stand-in tokenizer only behind the variable; local files only
    monkeypatch.delenv("STREAMFORMER_ALLOW_HASH_TOKENIZER")
    monkeypatch.setenv("STREAMFORMER_TOKENIZER", "/nonexistent/tokenizer")
    fresh = MultitaskModel(StreamformerConfig(**KW), TASKS, SiglipTextConfig(**TEXT_KW),
                           device="cpu")
    with pytest.raises(RuntimeError, match="STREAMFORMER_ALLOW_HASH_TOKENIZER"):
        fresh.tokenize(["x"])


def test_task_registry_and_per_dataset_tables():
    for task, kind in (("SSV2", "classification"), ("HACSGrounding", "universal_localization"),
                       ("FineAction", "naive_localization"), ("WebVid", "retrieval"),
                       ("QVHighlights", "grounding"), ("LVVIS", "vis"), ("RefCOCOPseudo", "refervos")):
        assert multitask.head_type_for_task(task) == kind
    with pytest.raises(NotImplementedError):
        multitask.head_type_for_task("Unknown")
    with pytest.raises(ValueError):
        MultitaskModel(StreamformerConfig(**KW), grounding_head="other", device="cpu")
    tasks = {"TaskVIS": {"label2id": {"ytvis": {"cat": 0, "dog": 1}, "lvvis": {"cup": 0}}},
             "THUMOS14": {"label2id": {"run": 0, "jump": 1, "dive": 2}}}
    model = MultitaskModel(StreamformerConfig(**KW), tasks, SiglipTextConfig(**TEXT_KW),
                           device="cpu")
    model.prepare_for_multi_tasks()
    assert model.label_embeddings["TaskVIS"]["ytvis"].shape == (2, D)
    assert model.label_embeddings["TaskVIS"]["lvvis"].shape == (1, D)
    assert model.label_embeddings["THUMOS14"].shape == (3, D)


def test_inference_apis_match_jax():
    jmodel, params, model = _pair()
    jparams = jax.tree.map(jnp.asarray, params)
    px = np.random.default_rng(8).standard_normal((2, 10, 3, 32, 32)).astype(np.float32)
    ref = jmodel.extract_feature(jparams, jnp.asarray(px), window_size=8)
    got = model.extract_feature(torch.from_numpy(px), window_size=8)
    assert got.shape == (2, 10, D) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
    clip = px[:, :4]
    for method in ("mean", "no_pooling", "last"):
        ref = jmodel.forward_features(jparams, jnp.asarray(clip), pooling_method=method)
        got = model.forward_features(torch.from_numpy(clip), pooling_method=method)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=1e-4, rtol=0)
