"""The port's online action detection (LSTR/MAT, its data layer, training
step, batch inference, stream and CLI) against the JAX package's, on the CPU
in fp32.

Both sides start from the same numpy weights (the JAX ``init_params`` tree,
its zero biases and unit norms opened up, carried across by
``lstr_params_from_jax``); inputs come from this file's own
``np.random.default_rng`` seeds.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from streamformer_tpu.downstream import oad_data as jax_data
from streamformer_tpu.downstream import oad_lstr as jax_lstr
from streamformer_tpu_torch.checkpoint import lstr_params_from_jax
from streamformer_tpu_torch.downstream import oad_data, oad_lstr, oad_run

# tests/test_oad_suite.py's detector
TINY = dict(visual_size=16, d_model=32, num_heads=4, dim_feedforward=64, num_classes=4,
            long_memory_num_samples=8, work_memory_num_samples=4, enc_queries_0=4,
            enc_queries_1=4, groups=2, future_num_samples=0, anticipation_num_samples=0)
VARIANTS = {
    "lstr": {},
    "mat": dict(future_num_samples=6, anticipation_num_samples=2, gen_queries=3, fut_queries=5,
                cci_times=3),
    "flow": dict(motion_size=6),
}
FRAMES = 40
FLOW = 6


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these tensors are tiny, and the 6-worker run
    oversubscribes the cores with each worker's default thread pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _configs(variant):
    kw = dict(TINY, **VARIANTS[variant])
    return jax_lstr.LSTRConfig(**kw), oad_lstr.LSTRConfig(**kw)


def _jax_tree(jcfg, seed=0):
    """JAX init_params with its zero biases and unit norms drawn instead, so
    every leaf matters."""
    tree = jax.tree.map(np.asarray, jax_lstr.init_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed + 100)

    def perturb(path, x):
        name = jax.tree_util.keystr(path)
        if name.endswith("['bias']"):
            return (0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        if name.endswith("['scale']"):
            return (1 + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(perturb, tree)


def _port(cfg, tree):
    model = oad_lstr.LSTR(cfg, device="cpu")
    model.load_state_dict(lstr_params_from_jax(tree))
    return model


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))))


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    """Two videos of FRAMES frames: visual (16) and flow (6) features and
    one-hot targets in PerFrameDataset's layout."""
    root = tmp_path_factory.mktemp("oad")
    rng = np.random.default_rng(7)
    names = []
    for sub in ("feat", "flow", "tgt"):
        (root / sub).mkdir()
    for i in range(2):
        name = f"video_{i}"
        np.save(root / "feat" / f"{name}.npy",
                rng.standard_normal((FRAMES, 16)).astype(np.float32))
        np.save(root / "flow" / f"{name}.npy",
                rng.standard_normal((FRAMES, FLOW)).astype(np.float32))
        tgt = np.zeros((FRAMES, 4), np.float32)
        tgt[np.arange(FRAMES), rng.integers(0, 4, FRAMES)] = 1
        np.save(root / "tgt" / f"{name}.npy", tgt)
        names.append(name)
    return {k: str(root / k) for k in ("feat", "flow", "tgt")}, names, root


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_matches_jax(variant):
    jcfg, cfg = _configs(variant)
    tree = _jax_tree(jcfg)
    model = _port(cfg, tree)
    rng = np.random.default_rng(1)
    ln, lw = cfg.long_memory_num_samples, cfg.work_memory_num_samples
    b = 3
    visual = rng.standard_normal((b, ln + lw, cfg.visual_size)).astype(np.float32)
    motion = (rng.standard_normal((b, ln + lw, cfg.motion_size)).astype(np.float32)
              if cfg.motion_size else None)
    mask = np.ones((b, ln), bool)
    mask[0, :ln // 2] = False  # a whole group padded: that group attends uniformly
    mask[1, :3] = False
    want = jax_lstr.forward(tree, jcfg, jnp.asarray(visual),
                            None if motion is None else jnp.asarray(motion), jnp.asarray(mask))
    got = oad_lstr.forward(model, torch.from_numpy(visual),
                           None if motion is None else torch.from_numpy(motion),
                           torch.from_numpy(mask))
    assert set(got) == set(want)
    for key in want:
        assert got[key].shape == want[key].shape
        assert _err(got[key].detach(), want[key]) <= 1e-5, key
    if cfg.motion_size:  # the flow stream as columns after the visual ones, motion=None
        cat = np.concatenate([visual, motion], -1)
        got_cat = oad_lstr.forward(model, torch.from_numpy(cat), None, torch.from_numpy(mask))
        assert _err(got_cat["logits"].detach(), want["logits"]) <= 1e-5


@pytest.mark.parametrize("flow", [False, True], ids=["visual", "visual+flow"])
def test_perframe_dataset_batches_equal_jax(dumps, flow):
    dirs, names, _ = dumps
    jcfg, cfg = _configs("flow" if flow else "lstr")
    kw = dict(long_sample_rate=2, flow_root=dirs["flow"] if flow else None)
    for mode in ("train", "val"):
        jds = jax_data.PerFrameDataset(dirs["feat"], dirs["tgt"], names, jcfg, mode=mode, **kw)
        pds = oad_data.PerFrameDataset(dirs["feat"], dirs["tgt"], names, cfg, mode=mode, **kw)
        assert len(pds) == len(jds) == 2 * (FRAMES - cfg.work_memory_num_samples + 1)
        jb = list(jds.batches(16, np.random.default_rng(3)))
        pb = list(pds.batches(16, np.random.default_rng(3)))
        assert len(pb) == len(jb)
        for x, y in zip(pb, jb):
            assert x.keys() == y.keys()
            for k in x:
                assert x[k].dtype == y[k].dtype
                np.testing.assert_array_equal(x[k], y[k])


def test_two_train_steps_match_jax(dumps):
    """Loss and gradients of two AdamW steps (the CLI's lr and weight
    decay) within 1e-4, each step's update on the JAX gradients equal to
    optax's within 1e-6 (Adam's first steps turn gradient noise into an
    lr-sized step, so the port steps on the JAX package's gradients to
    compare the update itself)."""
    dirs, names, _ = dumps
    jcfg, cfg = _configs("lstr")
    tree = _jax_tree(jcfg, seed=2)
    model = _port(cfg, tree)
    lr, wd = 7e-5, 5e-5
    ds = oad_data.PerFrameDataset(dirs["feat"], dirs["tgt"], names, cfg, long_sample_rate=2)
    batches = list(ds.batches(8, np.random.default_rng(0)))[:2]

    def jax_loss(p, feats, mask, targets):  # oad_data.make_train_step's loss_fn
        out = jax_lstr.forward(p, jcfg, feats, memory_mask=mask)
        return optax.sigmoid_binary_cross_entropy(
            out["logits"][:, :jcfg.work_memory_num_samples], targets).mean()

    tx = optax.adamw(lr, weight_decay=wd)
    params = jax.tree.map(jnp.asarray, tree)
    state = tx.init(params)
    opt = oad_data.make_optimizer(model, lr, wd)
    inner_step = opt.step
    seen = {}

    def step_on_jax_grads():
        seen["grads"] = {k: p.grad.clone() for k, p in model.named_parameters()}
        for k, p in model.named_parameters():
            p.grad.copy_(seen["jax_grads"][k])
        inner_step()

    opt.step = step_on_jax_grads
    step = oad_data.make_train_step(model, opt)
    value_and_grad = jax.jit(jax.value_and_grad(jax_loss))

    @jax.jit
    def update(grads, state, params):
        updates, state = tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    for batch in batches:
        args = [jnp.asarray(batch[k]) for k in ("features", "memory_mask", "targets")]
        loss, grads = value_and_grad(params, *args)
        params, state = update(grads, state, params)
        seen["jax_grads"] = lstr_params_from_jax(jax.tree.map(np.asarray, grads))
        got = step(batch)
        assert abs(float(got) - float(loss)) <= 1e-4
        assert max(_err(seen["grads"][k], seen["jax_grads"][k]) for k in seen["grads"]) <= 1e-4
        want = lstr_params_from_jax(jax.tree.map(np.asarray, params))
        assert max(_err(p.detach(), want[k]) for k, p in model.named_parameters()) <= 1e-6


def test_batch_inference_equals_jax(dumps):
    dirs, names, _ = dumps
    jcfg, cfg = _configs("lstr")
    tree = _jax_tree(jcfg, seed=3)
    kw = dict(long_sample_rate=2, mode="val")
    want = jax_data.batch_inference(jax.tree.map(jnp.asarray, tree), jcfg,
                                    jax_data.PerFrameDataset(dirs["feat"], dirs["tgt"], names,
                                                             jcfg, **kw), batch_size=16)
    got = oad_data.batch_inference(_port(cfg, tree),
                                   oad_data.PerFrameDataset(dirs["feat"], dirs["tgt"], names, cfg,
                                                            **kw), batch_size=16)
    assert got.keys() == want.keys() and {"mAP", "mcAP"} <= got.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("variant", ["lstr", "flow"])
def test_stream_equals_jax_every_step(variant):
    """LSTRStream over 40 frames (graduations every 2 steps past the work
    memory) against the JAX stream, every step within 1e-5; the compressed
    memory is recomputed exactly on the graduating steps."""
    jcfg, cfg = _configs(variant)
    tree = _jax_tree(jcfg, seed=4)
    rate = 2
    jstream = jax_lstr.LSTRStream(jax.tree.map(jnp.asarray, tree), jcfg, long_sample_rate=rate)
    stream = oad_lstr.LSTRStream(_port(cfg, tree), long_sample_rate=rate)
    feats = np.random.default_rng(5).standard_normal(
        (40, cfg.visual_size + cfg.motion_size)).astype(np.float32)
    lw = cfg.work_memory_num_samples
    for i, f in enumerate(feats):
        want = jstream.step(f)
        got = stream.step(f)
        assert got.shape == (cfg.num_classes,)
        assert _err(got, want) <= 1e-5, i
        assert stream.recomputed == (i == 0 or (i >= lw and i % rate == 0)), i
    long_feat, valid = stream.long_memory
    np.testing.assert_array_equal(valid.numpy(), jstream._long_valid)
    np.testing.assert_array_equal(long_feat.numpy(), jstream._long)


def test_oad_run_cli_epoch_validation_and_checkpoint(dumps, tmp_path, capsys):
    dirs, names, root = dumps
    for split in ("train", "val"):
        (root / f"{split}.txt").write_text("\n".join(names) + "\n")
    out = tmp_path / "out"
    oad_run.main(["--feature_root", dirs["feat"], "--target_root", dirs["tgt"],
                  "--train_list", str(root / "train.txt"), "--val_list", str(root / "val.txt"),
                  "--num_classes", "4", "--feature_dim", "16", "--hidden", "32",
                  "--long_memory_num_samples", "16", "--work_memory_num_samples", "4",
                  "--long_sample_rate", "2", "--batch_size", "8", "--epochs", "1",
                  "--steps_per_epoch", "3", "--output_dir", str(out), "--device", "cpu"])
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["epoch"] == 0 and np.isfinite(stats["loss"])
    assert 0 <= stats["mAP"] <= 100 and 0 <= stats["mcAP"] <= 100
    logged = [json.loads(line) for line in (out / "log.txt").read_text().splitlines()]
    assert logged == [stats]
    assert os.path.isdir(out / "checkpoint-0")
    from streamformer_tpu_torch.train import checkpoint as ckpt_lib

    assert ckpt_lib.latest_checkpoint(str(out)) == 0
