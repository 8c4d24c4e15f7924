"""The port's validation loops (``eval/validate.py``) against the JAX
package's, and ``train/run.py --eval_freq``, on the CPU in fp32.

Both packages' ``MultitaskModel`` hold the same weights
(``checkpoint.multitask_from_jax``) and the same word-hash tokenizer. The
validators return metrics only, so the tests also capture what each
package hands its metric functions (logits, similarity matrices, grounding
probabilities) by wrapping them: those agree within 1e-5, and the metrics
(top-k, recalls, mIoU, R@tIoU) are equal. The seeds are chosen so that no
decision sits near a tie: the smallest margin of each decision (a label's
logit against the others, a caption's similarity against the diagonal, a
probability against the proposal threshold and the argmax) is asserted to
exceed twice the largest difference between the packages, so that the
summation-order noise cannot flip a rank or a proposal edge.
"""

import json
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import streamformer_tpu.eval.metrics as jax_metrics
import streamformer_tpu_torch.eval.metrics as port_metrics
from streamformer_tpu.config import StreamformerConfig as JaxConfig
from streamformer_tpu.eval import validate as jax_validate
from streamformer_tpu.models.multitask import MultitaskModel as JaxMultitask
from streamformer_tpu.models.text_encoder import SiglipTextConfig as JaxTextConfig
from streamformer_tpu_torch.checkpoint import multitask_from_jax
from streamformer_tpu_torch.config import StreamformerConfig
from streamformer_tpu_torch.data.datasets import MultiTaskDataset
from streamformer_tpu_torch.eval import validate
from streamformer_tpu_torch.models.multitask import MultitaskModel
from streamformer_tpu_torch.models.text_encoder import SiglipTextConfig
from streamformer_tpu_torch.train import run

KW = dict(image_size=32, patch_size=16, num_frames=4, hidden_size=32, num_hidden_layers=2,
          num_attention_heads=4, intermediate_size=64, dtype="float32")
TEXT_KW = dict(vocab_size=64, hidden_size=32, num_hidden_layers=1, num_attention_heads=4,
               intermediate_size=64, max_position_embeddings=8)
LABELS = {f"action {i}": i for i in range(8)}
TASKS = {"Kinetics": {"label2id": LABELS}}
TOL = 1e-5
FACTOR = 0.12  # localization's threshold: the tiny model's probabilities sit around it
CAPTIONS = ["a red car turns left", "two dogs play outside", "someone cooks dinner slowly",
            "the crowd cheers loudly", "waves hit rocks", "a child rides bikes"]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these tensors are tiny, and the 6-worker run
    oversubscribes the cores with each worker's default thread pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def hash_tokenizer():
    """Both packages take their word-hash tokenizer (no ``transformers``)."""
    mp = pytest.MonkeyPatch()
    mp.setitem(sys.modules, "transformers", None)
    mp.setenv("STREAMFORMER_ALLOW_HASH_TOKENIZER", "1")
    yield
    mp.undo()


@pytest.fixture(scope="module")
def pair():
    jmodel = JaxMultitask(JaxConfig(use_pallas=False, **KW), TASKS,
                          text_cfg=JaxTextConfig(**TEXT_KW), rng=jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, jmodel.params)
    rng = np.random.default_rng(1)
    for lp in params["backbone"]["layers"]:  # open the gates: the temporal path counts
        lp["temporal_attention_gating"] = np.asarray(0.7, np.float32)
    params["backbone"]["embeddings"]["time_embeddings"] = 0.1 * rng.standard_normal(
        params["backbone"]["embeddings"]["time_embeddings"].shape).astype(np.float32)
    jmodel.params = jax.tree.map(jnp.asarray, params)
    jmodel.prepare_for_multi_tasks()
    cfg = StreamformerConfig(**KW)
    model = MultitaskModel(cfg, TASKS, SiglipTextConfig(**TEXT_KW), device="cpu")
    model.load_state_dict(multitask_from_jax(params, cfg))
    model.prepare_for_multi_tasks()
    return jmodel, jmodel.params, model


@pytest.fixture(autouse=True)
def writable_jax_features(monkeypatch):
    """The JAX package's ``validate_classification`` normalizes
    ``np.asarray(<jax array>)`` in place, which numpy refuses (the array is
    read-only); its module gets an ``asarray`` that copies, here only."""
    shim = types.SimpleNamespace(**{k: getattr(np, k) for k in dir(np) if not k.startswith("__")})
    shim.asarray = lambda a, *args, **kwargs: np.array(a, *args, **kwargs)
    monkeypatch.setattr(jax_validate, "np", shim)


def _capture(monkeypatch, module, name, into):
    real = getattr(module, name)

    def wrapped(*args, **kwargs):
        into.append(np.array(args[0], np.float32))
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, wrapped)


class _Task:
    """A task of seeded uint8 clips in the datasets' ``task_input`` shapes."""

    def __init__(self, task_name, n, seed, extra):
        rng = np.random.default_rng(seed)
        self.task_name = task_name
        self.frames = rng.integers(0, 256, (n, 4, 40, 40, 3), dtype=np.uint8)
        self.extra = extra

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, i):
        return {"task_name": self.task_name,
                "task_input": {"frames": self.frames[i], **self.extra(i)}}


def _grounding_meta(i):
    return {"caption": f"a person does thing {i} and stops",
            "label": (np.arange(4) >= i % 3).astype(np.float32),
            "meta": {"times": np.arange(4) * 0.5, "gt": (0.5 * (i % 3), 1.5), "qid": 100 + i}}


def _union(seed=0):
    class Nameless:  # no task_name: skipped, as the JAX package skips it
        def __len__(self):
            return 1

    return MultiTaskDataset([
        _Task("Kinetics", 10, seed, lambda i: {"label": np.int64(i % 8)}),
        _Task("TaskRetrieval", 6, seed + 1, lambda i: {"caption": CAPTIONS[i]}),
        _Task("CharadesSTA", 5, seed + 2, _grounding_meta),
        _Task("THUMOS14Grounding", 2, seed + 3, lambda i: {}),  # localization: not dispatched
        Nameless(),
    ])


def _rank_margin(scores):
    """The smallest gap between two scores of a row."""
    s = np.sort(scores, axis=1)
    return float(np.diff(s, axis=1).min())


def test_evaluate_multitask_matches_the_jax_package(pair, monkeypatch):
    """classification, retrieval and grounding through ``evaluate_multitask``
    on one in-memory eval union: equal metrics, the logits, similarity
    matrices and probabilities within 1e-5; THUMOS14Grounding and a dataset
    without a task name are skipped by both."""
    jmodel, params, model = pair
    union = _union()
    seen = {}
    for pkg, mod in (("jax", jax_metrics), ("port", port_metrics)):
        for fn in ("topk_accuracy", "retrieval_recall", "threshold_prob_proposal"):
            _capture(monkeypatch, mod, fn, seen.setdefault((pkg, fn), []))
    want = jax_validate.evaluate_multitask(jmodel, params, union, crop_size=32, batch_size=4)
    got = validate.evaluate_multitask(model, union, crop_size=32, batch_size=4)
    assert set(got) == {"Kinetics", "TaskRetrieval", "CharadesSTA"} == set(want)
    assert got == want
    worst = 0.0
    for fn in ("topk_accuracy", "retrieval_recall", "threshold_prob_proposal"):
        ours, theirs = seen[("port", fn)], seen[("jax", fn)]
        assert len(ours) == len(theirs) > 0
        for a, b in zip(ours, theirs):
            np.testing.assert_allclose(a, b, atol=TOL, rtol=0)
            worst = max(worst, float(np.abs(a - b).max()))
    logits = seen[("port", "topk_accuracy")][0]
    labels = np.arange(10) % 8
    gaps = np.abs(logits - logits[np.arange(10), labels][:, None])
    gaps[np.arange(10), labels] = np.inf
    sim = seen[("port", "retrieval_recall")][0]
    off = np.abs(sim - np.diag(sim)[:, None])[~np.eye(6, dtype=bool)]
    probs = seen[("port", "threshold_prob_proposal")]
    margins = {"label logits": gaps.min(), "retrieval": off.min(),
               "grounding": min(min(np.diff(np.sort(p)).min(), np.abs(p - 0.7 * p.max()).min())
                                for p in probs)}
    assert all(m > 2 * worst for m in margins.values()), (margins, worst)


def _frames(seed, b=3):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, 4, 3, 32, 32)).astype(np.float32)


def test_grounding_jsonl_and_localization_match_the_jax_package(pair, tmp_path, monkeypatch):
    """``validate_grounding``'s QVHighlights JSONL equal line for line and
    its metrics equal; ``validate_localization``'s result dict equal in
    labels and segments, scores within 1e-5."""
    jmodel, params, model = pair
    px = [_frames(s) for s in (11, 12)]
    captions = [[f"someone opens door {i}" for i in range(3)], ["a dog runs", "b", "c d e"]]
    metas = [[{"times": np.arange(4) * 0.25 + 1.0, "gt": (1.0, 1.5 + 0.25 * i), "qid": f"q{j}{i}"}
              for i in range(3)] for j in range(2)]
    ids = [model.tokenize(c) for c in captions]
    want = jax_validate.validate_grounding(
        jmodel, params, [(jnp.asarray(x), jnp.asarray(i), m) for x, i, m in zip(px, ids, metas)],
        jsonl_path=str(tmp_path / "jax" / "preds.jsonl"))
    got = validate.validate_grounding(
        model, [(torch.from_numpy(x), i, m) for x, i, m in zip(px, ids, metas)],
        jsonl_path=str(tmp_path / "port" / "preds.jsonl"))
    assert got == want
    lines = [(tmp_path / d / "preds.jsonl").read_text().splitlines() for d in ("port", "jax")]
    assert lines[0] == lines[1] and len(lines[0]) == 6
    assert json.loads(lines[0][0])["qid"] == "q00"

    rng = np.random.default_rng(13)
    tables = rng.standard_normal((3, 5, 32)).astype(np.float32)
    tables /= np.linalg.norm(tables, axis=-1, keepdims=True)
    mask = np.ones((3, 5), bool)
    mask[:, 4] = False
    lmeta = [{"times": np.arange(4) * 0.5, "video_id": f"v{i}"} for i in range(3)]
    seen = {"jax": [], "port": []}
    _capture(monkeypatch, jax_metrics, "multi_segment_proposal", seen["jax"])
    _capture(monkeypatch, port_metrics, "multi_segment_proposal", seen["port"])
    want = jax_validate.validate_localization(
        jmodel, params, [(jnp.asarray(px[0]), jnp.asarray(tables), mask, lmeta)], factor=FACTOR)
    got = validate.validate_localization(model, [(torch.from_numpy(px[0]), tables, mask, lmeta)],
                                         factor=FACTOR)
    assert list(got) == list(want) == ["v0", "v1", "v2"]
    for vid in want:
        assert [(r["label"], r["segment"]) for r in got[vid]] == \
            [(r["label"], r["segment"]) for r in want[vid]]
        np.testing.assert_allclose([r["score"] for r in got[vid]],
                                   [r["score"] for r in want[vid]], atol=TOL, rtol=0)
    assert 0 < sum(len(v) for v in got.values()) < 12 * 4  # some frames above, some below
    ours, theirs = np.stack(seen["port"]), np.stack(seen["jax"])
    np.testing.assert_allclose(ours, theirs, atol=TOL, rtol=0)
    assert np.abs(ours - FACTOR).min() > 2 * np.abs(ours - theirs).max()


def _cli_data():
    train = MultiTaskDataset([
        _Task("Kinetics", 4, 20, lambda i: {"label": np.int64(i % 2)}),
        _Task("CharadesSTA", 4, 21, _grounding_meta),
    ])
    mtc = {"Kinetics": {"label2id": {"a": 0, "b": 1}}, "CharadesSTA": {"label2id": None}}
    return train, _union(30), mtc


def _cli_argv(out, extra=()):
    return ["--metadata", "(in memory)", "--output_dir", out, "--device", "cpu", "--epochs", "2",
            "--batch_size", "2", "--input_size", "32", "--num_frames", "4", "--hidden_size",
            "32", "--num_layers", "1", "--num_heads", "2", "--intermediate_size", "64",
            "--text_layers", "1", "--num_workers", "2", "--lr", "1e-3", "--warmup_steps", "1",
            "--seed", "3", *extra]


def test_cli_eval_freq_logs_and_leaves_training_unchanged(tmp_path, monkeypatch, capsys):
    """``run.main(... --eval_freq 1 --device cpu)`` over an in-memory union
    validates after each epoch and logs ``eval_<task>_<metric>`` to
    log.txt; the training lines (losses of both epochs) equal those of a
    run without ``--eval_freq`` bit for bit."""
    monkeypatch.setattr(run, "build_datasets", lambda args: _cli_data())
    run.main(_cli_argv(str(tmp_path / "eval"), ["--eval_freq", "1"]))
    assert "epoch 0 eval:" in capsys.readouterr().out
    run.main(_cli_argv(str(tmp_path / "plain")))
    logs = {}
    for name in ("eval", "plain"):
        with open(tmp_path / name / "log.txt") as f:
            logs[name] = [json.loads(line) for line in f]
    evals = [r for r in logs["eval"] if "eval_Kinetics_top1" in r]
    assert [r["epoch"] for r in evals] == [0, 1]
    for key in ("eval_Kinetics_top5", "eval_TaskRetrieval_v2t_R@1", "eval_TaskRetrieval_t2v_MedR",
                "eval_CharadesSTA_mIoU"):
        assert all(np.isfinite(r[key]) for r in evals), key
    trained = [r for r in logs["eval"] if "loss" in r]
    assert len(trained) == 2
    for a, b in zip(trained, logs["plain"]):
        assert {k: v for k, v in a.items() if k != "epoch_time"} == \
            {k: v for k, v in b.items() if k != "epoch_time"}
