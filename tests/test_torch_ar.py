"""The port's action-recognition fine-tuning against the JAX package's, on the
CPU in fp32.

The same numpy-seeded weights on both sides (the encoder through
``params_from_jax``, the head through ``classifier_params_from_jax``). Mixup
on a shared draw (the JAX package's threefry draws read back and handed to
the port) equals the JAX batch in both layouts; the soft-target loss and the
logits agree within 1e-5; two train steps with mixup off and drop rates 0,
on both packages' ``create_optimizer`` (AdamW, clip 5, layer decay, cosine
warm-up), within 1e-4; the EMA step, validation and the multi-view test
equal. The port's CLI runs in-process on videos written with cv2.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from streamformer_tpu.config import StreamformerConfig as JaxConfig
from streamformer_tpu.data import mixup as jax_mixup
from streamformer_tpu.downstream import ar as jax_ar
from streamformer_tpu.train import optim as jax_optim
from streamformer_tpu_torch.checkpoint import classifier_params_from_jax, params_from_jax
from streamformer_tpu_torch.config import StreamformerConfig
from streamformer_tpu_torch.data import mixup
from streamformer_tpu_torch.downstream import ar
from streamformer_tpu_torch.models import encoder
from streamformer_tpu_torch.train import optim

from test_torch_encoder import _jax_params

# tests/test_downstream.py's encoder
TOWER = dict(image_size=32, patch_size=16, num_frames=4, hidden_size=32, num_hidden_layers=2,
             num_attention_heads=4, intermediate_size=64, dtype="float32")
JCFG = JaxConfig(use_pallas=False, **TOWER)
CFG = StreamformerConfig(**TOWER)
CLASSES = 5


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these tensors are tiny, and the 6-worker run
    oversubscribes the cores with each worker's default thread pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_tree():
    head = jax.tree.map(np.asarray, jax_ar.init_classifier_params(jax.random.PRNGKey(1), JCFG,
                                                                  CLASSES))
    rng = np.random.default_rng(4)
    head["fc_norm"]["scale"] = (1 + 0.1 * rng.standard_normal(32)).astype(np.float32)
    head["fc_norm"]["bias"] = (0.1 * rng.standard_normal(32)).astype(np.float32)
    head["classifier"]["bias"] = (0.1 * rng.standard_normal(CLASSES)).astype(np.float32)
    return {"backbone": _jax_params(JCFG, seed=3), "head": head}


TREE = _jax_tree()


def _port_sd(tree):
    sd = {"backbone." + k: v for k, v in params_from_jax(tree["backbone"], CFG).items()}
    sd.update({"head." + k: v for k, v in classifier_params_from_jax(tree["head"]).items()})
    return sd


def _port_model():
    model = ar.ARModel(encoder.StreamformerEncoder(CFG, device="cpu", trainable=True),
                       ar.init_classifier(CFG, CLASSES, device="cpu"))
    model.load_state_dict(_port_sd(TREE))
    return model


def _clips(b=4, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, 4, 3, 32, 32)).astype(np.float32),
            rng.integers(0, CLASSES, b))


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))))


def _jax_draw(key, h, w, mixup_alpha, cutmix_alpha, switch_prob=0.5):
    """The JAX package's draws of ``mixup_batch(key, ...)``, read back."""
    k_lam, k_switch, k_clam, k_box = jax.random.split(key, 4)
    ky, kx = jax.random.split(k_box)
    return mixup.MixupDraw(
        lam_mix=float(jax.random.beta(k_lam, mixup_alpha, mixup_alpha)),
        lam_cut=float(jax.random.beta(k_clam, cutmix_alpha, cutmix_alpha)),
        use_cutmix=bool(jax.random.bernoulli(k_switch, switch_prob)) and cutmix_alpha > 0,
        cy=int(jax.random.randint(ky, (), 0, h)), cx=int(jax.random.randint(kx, (), 0, w)))


@pytest.mark.parametrize("channels_last", [True, False], ids=["BTHWC", "BTCHW"])
def test_mixup_on_the_same_draw_equals_jax(channels_last):
    rng = np.random.default_rng(1)
    shape = (4, 3, 20, 24, 3) if channels_last else (4, 3, 3, 20, 24)
    clips = rng.standard_normal(shape).astype(np.float32)
    labels = rng.integers(0, 7, 4)
    kinds = set()
    for i in range(8):
        key = jax.random.PRNGKey(i)
        ref_x, ref_y = jax_mixup.mixup_batch(key, jnp.asarray(clips), jnp.asarray(labels), 7,
                                             label_smoothing=0.1, channels_last=channels_last)
        draw = _jax_draw(key, 20, 24, 0.8, 1.0)
        kinds.add(draw.use_cutmix)
        got_x, got_y = mixup.mix_batch(torch.from_numpy(clips), torch.from_numpy(labels), 7, draw,
                                       label_smoothing=0.1, channels_last=channels_last)
        np.testing.assert_array_equal(got_x.numpy(), np.asarray(ref_x))
        assert _err(got_y, ref_y) <= 1e-7
    assert kinds == {True, False}  # both branches ran
    # the port's own draws from a generator: reproducible, lambda within (0, 1)
    d1, d2 = (mixup.draw_mixup(torch.Generator().manual_seed(5), 20, 24) for _ in range(2))
    assert d1 == d2 and 0 < d1.lam_mix < 1 and 0 <= d1.cy < 20 and 0 <= d1.cx < 24
    x, y = mixup.mixup_batch(torch.Generator().manual_seed(5), torch.from_numpy(clips),
                             torch.from_numpy(labels), 7, channels_last=channels_last)
    want_x, want_y = mixup.mix_batch(torch.from_numpy(clips), torch.from_numpy(labels), 7, d1,
                                     channels_last=channels_last)
    assert torch.equal(x, want_x) and torch.equal(y, want_y)


def test_soft_target_cross_entropy_and_forward_match_jax():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((6, CLASSES)).astype(np.float32) * 3
    targets = rng.dirichlet(np.ones(CLASSES), 6).astype(np.float32)
    ref = jax_mixup.soft_target_cross_entropy(jnp.asarray(logits), jnp.asarray(targets))
    got = mixup.soft_target_cross_entropy(torch.from_numpy(logits), torch.from_numpy(targets))
    assert abs(float(got) - float(ref)) <= 1e-5
    px, _ = _clips()
    ref = jax_ar.classification_forward(jax.tree.map(jnp.asarray, TREE), jnp.asarray(px), JCFG)
    with torch.no_grad():
        got = ar.classification_forward(_port_model(), torch.from_numpy(px))
    assert got.shape == (4, CLASSES) and _err(got, ref) <= 1e-5


def test_train_steps_match_jax():
    """Two steps, mixup off, drop rates 0, layer decay 0.75, clip 5, cosine
    warm-up: the loss and every parameter within 1e-4."""
    px, labels = _clips()
    sched = dict(base_lr=2e-4, min_lr=1e-6, epochs=1, steps_per_epoch=2, warmup_epochs=1)
    kw = dict(weight_decay=0.05, clip_grad=5.0, layer_decay=0.75, num_layers=2)
    jparams = jax.tree.map(jnp.asarray, TREE)
    tx = jax_optim.create_optimizer(jparams, jax_optim.cosine_lr_schedule(*sched.values()), **kw)
    state = tx.init(jparams)
    jstep = jax_ar.make_train_step(JCFG, tx, CLASSES, use_mixup=False)
    model = _port_model()
    opt = optim.create_optimizer(model, optim.cosine_lr_schedule(*sched.values()), **kw)
    step = ar.make_train_step(model, opt, CLASSES, use_mixup=False)
    for i in range(2):
        jparams, state, jloss = jstep(jparams, state, jnp.asarray(px), jnp.asarray(labels),
                                      jax.random.PRNGKey(i))
        loss = step(torch.from_numpy(px), torch.from_numpy(labels), i)
        assert abs(float(loss) - float(jloss)) <= 1e-4
    want = _port_sd(jax.tree.map(np.asarray, jparams))
    for name, p in model.state_dict().items():
        assert _err(p, want[name]) <= 1e-4, name
    assert not torch.equal(model.head.classifier.weight, _port_sd(TREE)["head.classifier.weight"])


def test_ema_update_matches_jax():
    model = _port_model()
    ema = ar.init_ema(model)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.01)
    moved = jax.tree.map(lambda x: x + np.float32(0.01), TREE)
    ref = jax_ar.ema_update(jax.tree.map(jnp.asarray, TREE), jax.tree.map(jnp.asarray, moved),
                            0.9)
    ar.ema_update(ema, model, 0.9)
    want = _port_sd(jax.tree.map(np.asarray, ref))
    for name, p in ema.named_parameters():
        assert p.dtype == torch.float32 and not p.requires_grad
        assert _err(p, want[name]) <= 1e-7, name


def test_validate_and_final_test_equal_jax():
    model, jparams = _port_model(), jax.tree.map(jnp.asarray, TREE)
    batches = [_clips(4, seed=s) for s in range(3)]
    ref = jax_ar.validate(jparams, JCFG, [(jnp.asarray(x), jnp.asarray(y)) for x, y in batches])
    got = ar.validate(model, [(torch.from_numpy(x), torch.from_numpy(y)) for x, y in batches])
    assert got == ref
    # two views each of six videos
    vids = [np.array([0, 1, 2, 0]), np.array([1, 2, 3, 4]), np.array([5, 3, 4, 5])]
    labels = {v: int(v) % CLASSES for v in range(6)}
    views = [(x, np.array([labels[v] for v in vid]), vid) for (x, _), vid in zip(batches, vids)]
    ref = jax_ar.final_test(jparams, JCFG, [(jnp.asarray(x), jnp.asarray(y), v)
                                           for x, y, v in views])
    got = ar.final_test(model, [(torch.from_numpy(x), torch.from_numpy(y), v)
                                for x, y, v in views])
    assert got == ref


def _write_video(path, seed, n=12, h=48, w=64):
    import cv2

    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10, (w, h))
    rng = np.random.default_rng(seed)
    for _ in range(n):
        vw.write(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    vw.release()


def test_cli_epoch_validation_final_test_and_checkpoint(tmp_path):
    """The port's ``ar_run`` in-process on four cv2-written videos: an epoch
    of two steps with mixup and the EMA, validation of both, the multi-view
    test (2 segments x 3 crops) and a checkpoint that restores."""
    from streamformer_tpu_torch.downstream import ar_run
    from streamformer_tpu_torch.train import checkpoint as ckpt_lib

    anno = str(tmp_path / "train.csv")
    with open(anno, "w") as f:
        for i in range(4):
            path = str(tmp_path / f"v{i}.avi")
            _write_video(path, seed=i)
            f.write(f"{path} {i % 2}\n")
    out = str(tmp_path / "out")
    argv = ["--anno_train", anno, "--anno_val", anno, "--anno_test", anno, "--num_classes", "2",
            "--batch_size", "2", "--epochs", "1", "--lr", "1e-3", "--warmup_epochs", "0",
            "--num_workers", "2", "--output_dir", out, "--model_ema", "--model_ema_decay", "0.9",
            "--test_num_segment", "2", "--test_num_crop", "3", "--device", "cpu",
            "--hidden_size", "32", "--num_layers", "1", "--num_heads", "4",
            "--intermediate_size", "64", "--input_size", "32", "--num_frames", "4"]
    args = ar_run.get_args(argv)
    res = ar_run.train(args, *ar_run.build_datasets(args))
    with open(os.path.join(out, "log.txt")) as f:
        lines = [json.loads(ln) for ln in f]
    assert np.isfinite(lines[0]["loss"]) and {"top1", "top5", "top1_ema"} <= lines[0].keys()
    assert lines[1] == {"final_test": res["final_test"]} and "top1" in res["final_test"]
    model = ar_run.build_model(args)
    assert ckpt_lib.auto_resume(out, model)["epoch"] == 0
    assert not torch.equal(model.head.classifier.weight,
                           ar_run.build_model(args).head.classifier.weight)
