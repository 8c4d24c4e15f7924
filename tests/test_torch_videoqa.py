"""The port's VideoQA inference path against the JAX package's, on the CPU in
fp32, and its two HTTP servers.

Same weights on both sides: the tower through ``params_from_jax`` (the
JAX tower on its plain reference, ``use_pallas=False``), the projector
through ``projector_params_from_jax``, the LM through ``lm_params_from_jax``.
The splice's arrays equal the JAX package's exactly; the projector within
1e-6; spliced prompts, logits and losses within 1e-4 (fp32, summation order
only); greedy tokens and the multiple-choice pick exactly. The servers run a
real ``ThreadingHTTPServer`` over a socket: their tokens equal the
in-process engine's, with the error mapping (400, 404, 503) and the refusal
of a streaming tower.
"""

import base64
import json
import os
import pathlib
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from streamformer_tpu.downstream import videoqa as JVQ
from streamformer_tpu.downstream.vision_tower import TimesformerVisionTower as JaxTower
from streamformer_tpu_torch.checkpoint import projector_params_from_jax
from streamformer_tpu_torch.downstream import videoqa as VQ
from streamformer_tpu_torch.downstream.vision_tower import TimesformerVisionTower
from streamformer_tpu_torch.lm_serving import DecodeEngine
from streamformer_tpu_torch.server import DecodeServer, VideoQAServer

from test_torch_encoder import _pair, _video
from test_torch_language_model import SMALL, err, pair

ATOL = 1e-4
PROMPTS = [np.array([3, VQ.IMAGE_TOKEN_INDEX, 9, 12]), np.array([5, 7, VQ.IMAGE_TOKEN_INDEX, 2])]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these tensors are tiny, and the 6-worker run
    oversubscribes the cores with each worker's default thread pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _models(streaming=False, **overrides):
    """(JAX LlavaQwenModel, port LlavaQwenModel) on the same weights."""
    kw = dict(cache_capacity=16, context_length=16) if streaming else {}
    jcfg, tparams, _, tmodel = _pair(streaming_mode=streaming, **kw, **overrides)
    lm_params, lm = pair(seed=7)
    proj = JVQ.init_mm_projector(jax.random.PRNGKey(1), jcfg.hidden_size, SMALL.hidden_size)
    proj = jax.tree.map(lambda x: x + 0.05 * jax.random.normal(jax.random.PRNGKey(2), x.shape),
                        proj)  # biases drawn, so that they matter
    jmodel = JVQ.LlavaQwenModel(
        tower=JaxTower(jcfg, jax.tree.map(jnp.asarray, tparams), streaming_mode=streaming),
        lm_cfg=SMALL, params={"projector": proj, "lm": lm_params})
    projector = VQ.init_mm_projector(jcfg.hidden_size, SMALL.hidden_size, device="cpu")
    projector.load_state_dict(projector_params_from_jax(jax.tree.map(np.asarray, proj)))
    model = VQ.LlavaQwenModel(tower=TimesformerVisionTower(tmodel, streaming_mode=streaming),
                              lm=lm, projector=projector)
    return jmodel, model


@pytest.fixture(scope="module")
def models():
    return _models()


def _videos(n=2, t=4):
    return [_video(1, t, seed=s) for s in range(n)]


@pytest.mark.parametrize("max_len", [None, 10, 3], ids=["exact", "padded", "cut"])
def test_splice_functions_match_jax(max_len):
    ids = np.array([5, VQ.IMAGE_TOKEN_INDEX, 7, 8, VQ.IMAGE_TOKEN_INDEX])
    rng = np.random.default_rng(0)
    text = rng.standard_normal((5, 6)).astype(np.float32)
    img = rng.standard_normal((3, 6)).astype(np.float32)
    labels = np.array([5, -100, 7, 8, -100])
    ref = JVQ.splice_multimodal_inputs(ids, text, img, labels, max_len)
    got = VQ.splice_multimodal_inputs(ids, text, img, labels, max_len)
    assert ref.keys() == got.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    plan_len = max_len or 10
    jplan = JVQ.build_splice_plan(ids, 3, plan_len, labels)
    plan = VQ.build_splice_plan(ids, 3, plan_len, labels)
    for k in jplan:
        np.testing.assert_array_equal(plan[k], jplan[k], err_msg=k)
    ref = JVQ.apply_splice_plan({k: jnp.asarray(v)[None] for k, v in jplan.items()},
                                jnp.asarray(text)[None], jnp.asarray(img)[None])
    got = VQ.apply_splice_plan({k: torch.from_numpy(v)[None] for k, v in plan.items()},
                               torch.from_numpy(text)[None], torch.from_numpy(img)[None])
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_projector_matches_jax(models):
    jmodel, model = models
    x = np.random.default_rng(3).standard_normal((2, 5, 96)).astype(np.float32)
    ref = JVQ.mm_projector(jmodel.params["projector"], jnp.asarray(x))
    got = VQ.mm_projector(model.projector, torch.from_numpy(x))
    assert got.dtype == torch.float32 and err(got, ref) <= 1e-6


def test_forward_logits_and_loss_match_jax(models):
    """``forward`` over a prompt with a placeholder, labels on the text
    tokens, padded to 16: logits and the loss within 1e-4."""
    jmodel, model = models
    (px,) = _videos(1)
    ids = np.array([3, VQ.IMAGE_TOKEN_INDEX, 9, 12, 5])
    labels = np.array([-100, -100, 9, 12, 5])
    ref, ref_loss = jmodel.forward(ids, jnp.asarray(px), labels=labels, max_len=16)
    got, loss = model.forward(ids, torch.from_numpy(px), labels=labels, max_len=16)
    assert got.shape == (1, 16, SMALL.vocab_size)
    assert err(got, ref) <= ATOL
    assert abs(float(loss) - float(ref_loss)) <= ATOL
    assert model.forward(ids, torch.from_numpy(px), max_len=16)[1] is None


def test_prompt_embeds_and_generate_match_jax(models):
    """The exact-length spliced prompt (L - placeholders + T frames) within
    1e-4 and the greedy answer equal to the JAX package's, for two prompts
    and videos."""
    jmodel, model = models
    for ids, px in zip(PROMPTS, _videos()):
        ref = jmodel.prompt_embeds(ids, jnp.asarray(px))
        got = model.prompt_embeds(ids, torch.from_numpy(px))
        assert got.shape == (len(ids) - 1 + 4, SMALL.hidden_size)
        assert err(got, ref) <= ATOL
        np.testing.assert_array_equal(
            model.generate(ids, torch.from_numpy(px), max_new_tokens=5),
            np.asarray(jmodel.generate(ids, jnp.asarray(px), max_new_tokens=5)))
    with pytest.raises(ValueError, match="IMAGE_TOKEN_INDEX"):
        model.prompt_embeds(np.array([3, -1, VQ.IMAGE_TOKEN_INDEX]), torch.from_numpy(px))


def test_streaming_tower_generation_matches_jax():
    """The reference's KV-cache contract through the whole path on a linear
    streaming tower (C=16): an answer after frames 0-3, the same answer from
    the held context (``pixel_values=None``), and after frames 4-7 the
    answer of a fresh encode of 0-7; each equal to the JAX package's."""
    jmodel, model = _models(streaming=True)
    px = _video(1, 8, seed=5)
    prompt = PROMPTS[0]
    for frames in (px[:, :4], None, px[:, 4:]):
        got = model.generate(prompt, None if frames is None else torch.from_numpy(frames),
                             max_new_tokens=5)
        ref = jmodel.generate(prompt, None if frames is None else jnp.asarray(frames),
                              max_new_tokens=5)
        np.testing.assert_array_equal(got, np.asarray(ref))
    model.tower.clear_cache()
    fresh = model.generate(prompt, torch.from_numpy(px), max_new_tokens=5)
    np.testing.assert_array_equal(fresh, got)


def test_score_option_loglik_and_multiple_choice_match_jax(models):
    jmodel, model = models
    (px,) = _videos(1)
    prompt = np.array([3, VQ.IMAGE_TOKEN_INDEX, 9])
    options = [np.array([7, 7]), np.array([11, 13]), np.array([21, 22])]
    refs = [JVQ.score_option_loglik(jmodel, prompt, o, jnp.asarray(px)) for o in options]
    got = [VQ.score_option_loglik(model, prompt, o, torch.from_numpy(px)) for o in options]
    assert err(got, refs) <= ATOL
    rows = [{"pixel_values": torch.from_numpy(px), "prompt_ids": prompt, "options": options,
             "answer": int(np.argmax(refs))}]
    assert VQ.evaluate_multiple_choice(model, rows) == {"accuracy": 1.0, "n": 1}


def test_llava_stream_model_matches_jax(models):
    """The pluggable-LM form: a toy tied head over the same table."""
    jmodel, model = models
    (px,) = _videos(1)
    table = np.random.default_rng(0).standard_normal((50, SMALL.hidden_size)).astype(np.float32)
    jm = JVQ.LlavaStreamModel(jmodel.tower, jmodel.params["projector"],
                              lambda ids: jnp.asarray(table)[ids],
                              lambda e, m: e @ jnp.asarray(table).T)
    pm = VQ.LlavaStreamModel(model.tower, model.projector, lambda ids: torch.from_numpy(table)[ids],
                             lambda e, m: e @ torch.from_numpy(table).T)
    ref, jsp = jm.forward(PROMPTS[0], jnp.asarray(px), max_len=12)
    got, sp = pm.forward(PROMPTS[0], torch.from_numpy(px), max_len=12)
    assert err(got, ref) <= ATOL
    np.testing.assert_array_equal(sp["attention_mask"], jsp["attention_mask"])


def _req(port, method, path, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _b64(arr: np.ndarray) -> dict:
    arr = np.ascontiguousarray(arr, np.float32)
    return {"b64": base64.b64encode(arr.tobytes()).decode(), "shape": list(arr.shape)}


def _tokens(port, prefix, rid):
    toks, deadline = [], time.time() + 60
    while time.time() < deadline:
        r = _req(port, "GET", f"/{prefix}/{rid}/tokens")
        toks += r["tokens"]
        if r["done"]:
            return toks
        time.sleep(0.01)
    raise AssertionError(f"request {rid} did not finish")


def _engine_tokens(lm, prompts, kw):
    eng = DecodeEngine(lm, **kw)
    sids = [eng.open(p) for p in prompts]
    eng.run_until_idle()
    return [eng.poll(s)[0] for s in sids]


def test_decode_server_over_http(models):
    """Three requests over two slots from two client threads: tokens equal
    the in-process engine's; a bad shape is a 400, an unknown request a 400,
    a bad route a 404, a dead actor a 503 on every route."""
    _, model = models
    rng = np.random.default_rng(9)
    prompts = [rng.standard_normal((n, SMALL.hidden_size)).astype(np.float32) for n in (3, 6, 2)]
    kw = dict(slots=2, capacity=24, max_new_tokens=4, prefill_buckets=(4, 8))
    want = _engine_tokens(model.lm, prompts, kw)
    srv = DecodeServer(model.lm, port=0, **kw).start()
    try:
        got = {}

        def client(i):
            b = _b64(prompts[i])
            rid = _req(srv.port, "POST", "/requests", {"embeds_b64": b["b64"], "shape": b["shape"]})
            got[i] = _tokens(srv.port, "requests", rid["rid"])

        threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert [got[i] for i in range(3)] == want
        health = _req(srv.port, "GET", "/healthz")
        assert health["ok"] and health["slots"] == 2 and health["pending"] == 0
        b = _b64(np.zeros((30, SMALL.hidden_size)))
        for payload in ({"embeds_b64": b["b64"], "shape": b["shape"]},  # past the capacity
                        {"embeds_b64": b["b64"], "shape": [30, 8, 4]}):  # not (L, D)
            with pytest.raises(urllib.error.HTTPError) as ei:
                _req(srv.port, "POST", "/requests", payload)
            assert ei.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as ei:
            _req(srv.port, "GET", "/requests/99/tokens")
        assert ei.value.code == 400 and "unknown request" in json.loads(ei.value.read())["error"]
        for path in ("/nope", "/requests/abc/tokens", "/requests/0/nothing"):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _req(srv.port, "GET", path)
            assert ei.value.code == 404, path
    finally:
        srv.stop()

    srv = DecodeServer(model.lm, port=0, **kw)

    def broken_tick():
        raise RuntimeError("device lost")

    srv._engine.tick = broken_tick
    srv.start()
    try:
        b = _b64(prompts[0])
        _req(srv.port, "POST", "/requests", {"embeds_b64": b["b64"], "shape": b["shape"]})
        for path in ("/healthz", "/requests/0/tokens"):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _req(srv.port, "GET", path)
            assert ei.value.code == 503 and "device lost" in json.loads(ei.value.read())["error"]
    finally:
        srv.stop()


def test_videoqa_server_over_http(models):
    """Two clients post /qa at once (frames and prompt ids): each answer
    equals the in-process engine's on the same spliced prompt; an id outside
    the vocabulary is a 400; a streaming tower is refused."""
    _, model = models
    videos = _videos()
    kw = dict(slots=2, capacity=32, max_new_tokens=4, prefill_buckets=(8, 16))
    want = _engine_tokens(model.lm, [model.prompt_embeds(p, torch.from_numpy(v))
                                     for p, v in zip(PROMPTS, videos)], kw)
    srv = VideoQAServer(model, port=0, **kw).start()
    try:
        got = {}

        def client(i):
            b = _b64(videos[i][0])
            rid = _req(srv.port, "POST", "/qa", {"prompt_ids": PROMPTS[i].tolist(),
                                                "frames_b64": b["b64"], "shape": b["shape"]})
            got[i] = _tokens(srv.port, "qa", rid["rid"])

        threads = [threading.Thread(target=client, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert [got[0], got[1]] == want
        b = _b64(videos[0][0])
        with pytest.raises(urllib.error.HTTPError) as ei:
            _req(srv.port, "POST", "/qa", {"prompt_ids": [3, SMALL.vocab_size],
                                           "frames_b64": b["b64"], "shape": b["shape"]})
        assert ei.value.code == 400
    finally:
        srv.stop()
    _, streaming = _models(streaming=True)
    with pytest.raises(ValueError, match="non-streaming tower"):
        VideoQAServer(streaming, port=0)


def test_serving_path_runs_with_jax_unimportable():
    """The LM, its engine, the servers and VideoQA import and run a greedy
    request with ``jax`` and ``streamformer_tpu`` blocked from import."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = sys.modules['streamformer_tpu'] = None\n"
        "import torch\n"
        "from streamformer_tpu_torch.models import language_model as LM\n"
        "from streamformer_tpu_torch.lm_serving import DecodeEngine\n"
        "from streamformer_tpu_torch.server import DecodeServer, VideoQAServer\n"
        "from streamformer_tpu_torch.downstream import videoqa\n"
        "cfg = LM.LMConfig(vocab_size=16, hidden_size=8, intermediate_size=16,"
        " num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=1, dtype='float32')\n"
        "m = LM.LanguageModel(cfg, device='cpu', generator=torch.Generator().manual_seed(0))\n"
        "e = DecodeEngine(m, slots=1, capacity=8, max_new_tokens=3, prefill_buckets=(4,))\n"
        "sid = e.open_tokens([1, 2, 3])\n"
        "e.run_until_idle()\n"
        "toks, done = e.poll(sid)\n"
        "assert done and len(toks) == 3\n"
    )
    root = pathlib.Path(__file__).resolve().parent.parent
    # one intra-op thread, as the tests in this process run
    subprocess.run([sys.executable, "-c", code], cwd=root,
                   env=dict(os.environ, OMP_NUM_THREADS="1"), check=True, timeout=120)
