"""Serving over several ranks (two gloo ranks on the CPU) against the
one-process port and the JAX package: the tensor-parallel stream (mesh
(1, 2): linear, ring, ragged with ``new_valid``, row-major, int8 with its
row scales MAX-reduced over the model group, a mixed float cache, sequence
parallel), ``space_only`` and ``joint_space_time`` under tensor
parallelism forward and backward, ``StreamingEngine`` over the data axis
(mesh (2, 1); JAX ``test_serving.py``'s 6 streams over 4 slots with churn,
float and int8), the tensor-parallel LM forward and ragged step,
``DecodeEngine`` over (2, 1) and (1, 2), ``export_sharded_forward`` at
(1, 2), and ``entry.dryrun_multiprocess(2)``.

The ranks (``tests/_torch_dist_worker.py``, case "serve") start once for
the module; the JAX oracles run jitted in this process. Tolerances: the
one-process port 1e-5 (fp32: the partial sums of a row-parallel product
are added in another order); the JAX package 1e-3 (the fp32 parity of
``test_torch_encoder.py``), its gradients 1e-4 (``test_torch_shapes.py``);
tokens equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_dist_worker as worker
from streamformer_tpu.config import StreamformerConfig as JaxConfig
from streamformer_tpu.models import encoder as jax_encoder
from streamformer_tpu.models import language_model as JLM
from streamformer_tpu.serving import StreamingEngine as JaxEngine
from streamformer_tpu_torch.checkpoint import lm_params_from_jax, params_from_jax
from streamformer_tpu_torch.config import StreamformerConfig
from streamformer_tpu_torch.models import encoder
from streamformer_tpu_torch.models import language_model as LM
from streamformer_tpu_torch.ops import quant

from test_torch_encoder import _jax_params

VS_PORT, VS_JAX, GRAD_VS_JAX = 1e-5, 1e-3, 1e-4
ENC = dict(image_size=32, patch_size=16, num_frames=4, hidden_size=64, num_hidden_layers=2,
           num_attention_heads=4, intermediate_size=128, dtype="float32", cache_capacity=8)
LM_KW = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
             rope_theta=10000.0, rms_norm_eps=1e-6, tie_word_embeddings=False,
             attention_bias=True)
STREAMS = {
    "linear": dict(cfg={}, calls=[1] * 6),
    "linear_chunks": dict(cfg={}, calls=[3, 3]),
    "ring": dict(cfg=dict(cache_mode="ring", cache_capacity=4), calls=[1] * 6),
    "ragged_new_valid": dict(cfg={}, calls=[3, 3], ragged=True, new_valid=[[3, 2], [1, 3]]),
    "row_major": dict(cfg=dict(cache_layout="row_major"), calls=[1, 1, 1, 3]),
    "row_major_int8": dict(cfg=dict(cache_layout="row_major", cache_dtype="int8"),
                           calls=[1, 1, 1]),
    "int8": dict(cfg=dict(cache_dtype="int8"), calls=[1] * 6),
    "int8_ragged": dict(cfg=dict(cache_dtype="int8"), calls=[1, 1, 2], ragged=True,
                        reset=[False, True]),
    "mixed": dict(cfg=dict(cache_dtype="bfloat16"), calls=[1, 1, 2]),
    "shard_patches": dict(cfg={}, calls=[1, 1, 2], shard_patches=True),
}
PROMPTS = [np.random.default_rng(17).integers(0, 64, size=(n,)) for n in [3, 7, 2, 6, 5, 4]]
# EOS checked every token (the host reads each tick's tokens, gathered over the ranks) and
# every 3 ticks (the lazy drain trims at the first EOS)
EOS_EACH, EOS_LAZY = dict(eos_token_id=31, eos_interval=1), dict(eos_token_id=31, eos_interval=3)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these tensors are tiny."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_serve")
    jcfg = JaxConfig(use_pallas=False, **ENC)
    params = _jax_params(jcfg)
    cfg = StreamformerConfig(**ENC)
    state = params_from_jax(params, cfg)
    jlm_cfg = JLM.LMConfig(**LM_KW)
    lm_params = JLM.init_params(jax.random.PRNGKey(0), jlm_cfg)
    rng = np.random.default_rng(11)
    inp = {"enc_kw": ENC, "enc_state": state, "lm_kw": LM_KW,
           "lm_state": lm_params_from_jax(jax.tree.map(np.asarray, lm_params)),
           "video": torch.from_numpy(rng.standard_normal((2, 6, 3, 32, 32)).astype(np.float32)),
           "clips": {i: rng.integers(0, 256, (n, 3, 32, 32), dtype=np.uint8)
                     for i, n in enumerate([5, 3, 6, 2, 4, 7])},
           "streams": STREAMS, "lm_ids": torch.from_numpy(rng.integers(0, 64, (2, 5))),
           "prompts": PROMPTS, "eos_each": EOS_EACH, "eos_lazy": EOS_LAZY,
           "quantize": torch.from_numpy(
               rng.standard_normal((6, 64)).astype(np.float32))}
    torch.save(inp, str(d / "serve_inputs.pt"))
    return _Case(worker.start("serve", 2, str(d)), inp=inp, jcfg=jcfg, params=params, cfg=cfg,
                 jlm_cfg=jlm_cfg, lm_params=lm_params)


class _Case(dict):
    """The module's inputs; ``["ranks"]`` waits for the ranks (started by
    the fixture, so the first test's oracles run while they work)."""

    def __init__(self, wait, **kw):
        super().__init__(**kw)
        self._wait = wait

    def __getitem__(self, key):
        if key == "ranks" and not self.__contains__(key):
            self["ranks"] = self._wait()
        return super().__getitem__(key)


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))))


def _whole(case, **overrides):
    model = encoder.StreamformerEncoder(case["cfg"].replace(**overrides), device="cpu")
    model.load_state_dict(case["inp"]["enc_state"])
    return model


def _jax_stream(jcfg, params, video, calls, ragged=False, new_valid=None, reset=None):
    step = jax.jit(lambda p, f, c, v: jax_encoder.streaming_forward(p, f, c, jcfg, new_valid=v))
    cache = jax_encoder.init_cache(jcfg, batch=video.shape[0], per_stream_len=ragged)
    jparams = jax.tree.map(jnp.asarray, params)
    outs, lo = [], 0
    for i, t in enumerate(calls):
        valid = None if new_valid is None else jnp.asarray(new_valid[i], jnp.int32)
        out, cache = step(jparams, jnp.asarray(video[:, lo:lo + t].numpy()), cache, valid)
        outs.append(out)
        lo += t
        if i == 0 and reset is not None:
            cache = jax_encoder.reset_streams(cache, jnp.asarray(np.asarray(reset)))
    return outs


@pytest.mark.parametrize("name", list(STREAMS))
def test_tp_stream_matches_one_process_and_jax(case, name):
    """Each rank's outputs of the tensor-parallel stream (mp = 2, the
    kernels at 2 heads, the cache at D / 2) against the one-process port's
    stream and the JAX package's, every call, every valid frame."""
    spec = STREAMS[name]
    cfg = case["cfg"].replace(**spec["cfg"])
    video = case["inp"]["video"]
    kw = dict(ragged=spec.get("ragged", False), new_valid=spec.get("new_valid"),
              reset=spec.get("reset"))
    want, cache = worker._stream_tp(_whole(case, **spec["cfg"]), cfg, video, spec["calls"], **kw)
    jcfg = case["jcfg"].replace(**spec["cfg"])
    ref = _jax_stream(jcfg, case["params"], video, spec["calls"], **kw)
    for rank in case["ranks"]:
        got = rank["streams"][name]
        assert got["cache"]["layers"][0]["k"].shape[-1] == ENC["hidden_size"] // 2
        assert got["cache"]["len"].tolist() == cache["len"].tolist()
        for i, t in enumerate(spec["calls"]):
            for b in range(video.shape[0]):
                v = t if spec.get("new_valid") is None else spec["new_valid"][i][b]
                for key in ("last_hidden_state", "pooler_output"):
                    g = got["outs"][i][key][b, :v]
                    assert _err(g, want[i][key][b, :v]) <= VS_PORT, (i, b, key)
                    assert _err(g, ref[i][key][b, :v]) <= VS_JAX, (i, b, key)


@pytest.mark.parametrize("name", ["int8", "int8_ragged", "row_major_int8"])
def test_tp_int8_cache_holds_the_one_process_codes_and_scales(case, name):
    """Each rank's int8 planes are the one-process cache's columns of its
    heads, and its scales the one-process scales: the pos-major row scale is
    over the whole D (the absmax MAX-reduced over the model group), the
    row-major scales one a head. The first layer's bits are equal; later
    layers take inputs the row-parallel sums round differently, so their
    codes may sit one step apart."""
    spec = STREAMS[name]
    cfg = case["cfg"].replace(**spec["cfg"])
    _, cache = worker._stream_tp(_whole(case, **spec["cfg"]), cfg, case["inp"]["video"],
                                 spec["calls"], ragged=spec.get("ragged", False),
                                 reset=spec.get("reset"))
    half = ENC["hidden_size"] // 2
    for rank in case["ranks"]:
        r = rank["model_rank"]
        for i, (got, want) in enumerate(zip(rank["streams"][name]["cache"]["layers"],
                                            cache["layers"])):
            for key in ("k", "v"):
                codes = want[key][..., r * half:(r + 1) * half]
                scale = want[f"{key}_scale"]
                if "row_major" in name:  # per head: this rank's heads
                    heads = scale.shape[-1] // 2
                    scale = scale[..., r * heads:(r + 1) * heads]
                gap = (got[key].int() - codes.int()).abs().max().item()
                rel = ((got[f"{key}_scale"] - scale).abs() / scale.clamp_min(1e-8)).max().item()
                if i == 0:
                    assert gap == 0 and rel == 0, (i, key, gap, rel)
                assert gap <= 1 and rel <= 1e-5, (i, key, gap, rel)


def test_tp_quantize_rows_equals_the_whole_rows(case):
    """``sharding.quantize_rows`` of each rank's half of the rows: the whole
    rows' codes and scales bit for bit; each half alone would not be."""
    x = case["inp"]["quantize"]
    codes, scale = quant.quantize_rows(x)
    for rank in case["ranks"]:
        r = rank["model_rank"]
        got_codes, got_scale, alone = rank["quantize"]
        assert torch.equal(got_codes, codes[:, r * 32:(r + 1) * 32])
        assert torch.equal(got_scale, scale)
        assert not torch.equal(alone, scale)


@pytest.mark.parametrize("kind", ["space_only", "joint_space_time"])
def test_tp_attention_types_forward_and_gradients(case, kind):
    """``space_only`` and ``joint_space_time`` under tensor parallelism: the
    full clip and the gradients of its pooled sum of squares against one
    process and against ``jax.grad`` (carried across ``params_from_jax``, a
    linear map)."""
    cfg = case["cfg"].replace(attention_type=kind)
    model = encoder.StreamformerEncoder(cfg, device="cpu", trainable=True)
    model.load_state_dict({k: case["inp"]["enc_state"][k] for k in model.state_dict()})
    px = case["inp"]["video"][:, :4]
    out = encoder.model_forward(model, px)
    (out["pooler_output"] ** 2).sum().backward()
    jcfg = case["jcfg"].replace(attention_type=kind)
    jparams = jax.tree.map(jnp.asarray, case["params"])

    def loss(p):
        o = jax_encoder.model_forward(p, jnp.asarray(px.numpy()), jcfg)
        return (o["pooler_output"] ** 2).sum(), o

    (_, jout), jgrad = jax.jit(jax.value_and_grad(loss, has_aux=True))(jparams)
    jgrad = params_from_jax(jax.tree.map(np.asarray, jgrad), cfg)
    for rank in case["ranks"]:
        got = rank["attention_types"][kind]
        for key, name in (("pooler", "pooler_output"), ("hidden", "last_hidden_state")):
            assert _err(got[key], out[name].detach()) <= VS_PORT
            assert _err(got[key], jout[name]) <= VS_JAX
        for name, p in model.named_parameters():  # no gradient: a table space_only skips
            g, want = got["grads"][name], torch.zeros_like(p) if p.grad is None else p.grad
            scale = max(1.0, want.abs().max().item())
            assert _err(g, want) <= VS_PORT * scale, name
            assert _err(g, jgrad[name]) <= GRAD_VS_JAX * scale, name


@pytest.mark.parametrize("tag", ["float", "int8"])
def test_engine_over_the_data_axis_matches_one_process_and_jax(case, tag):
    """JAX ``test_serving.py``'s churn, 6 streams over 4 slots, uint8
    staging: each rank serves 2 slots, every rank's ``poll`` returns every
    stream's features, equal to the one-process engine's and within the
    fp32 parity of the JAX engine's (``mode="linear"``)."""
    over = {} if tag == "float" else {"cache_dtype": "int8"}
    want = worker._serve_engine(_whole(case, **over), case["inp"]["clips"], None)
    jeng = lambda: JaxEngine(case["params"], case["jcfg"].replace(**over), slots=4,  # noqa: E731
                             stage_dtype="uint8", mode="linear")
    ref = _jax_serve(jeng(), case["inp"]["clips"])
    for rank in case["ranks"]:
        got = rank["engine"][tag]
        assert got["forwards"] == want["forwards"] and got["ticks"] == want["ticks"]
        for i, clip in case["inp"]["clips"].items():
            assert got["feats"][i].shape == (len(clip), ENC["hidden_size"])
            assert _err(got["feats"][i], want["feats"][i]) <= VS_PORT, i
            assert _err(got["feats"][i], ref[i]) <= VS_JAX, i


def _jax_serve(eng, clips):
    sids = {}
    for i, c in clips.items():
        sids[i] = eng.open()
        eng.feed(sids[i], c[: len(c) // 2])
    for i, c in clips.items():
        eng.feed(sids[i], c[len(c) // 2:])
        eng.close(sids[i])
    eng.run_until_idle()
    return {i: eng.poll(s)[0] for i, s in sids.items()}


def test_engine_tick_issues_no_collective(case):
    """No tick of the mesh engine calls a collective (its slots' state is
    the rank's own); a poll broadcasts the owner's features, once a stream
    with new features."""
    for rank in case["ranks"]:
        for tag in ("float", "int8"):
            got = rank["engine"][tag]
            assert got["ticks"] > 0 and got["tick_calls"] == [], got["tick_calls"]
            assert got["poll_calls"] == ["broadcast"] * len(case["inp"]["clips"])


def test_engine_mesh_refuses_a_cut_model_and_uneven_slots(case):
    """What the mesh engine still refuses, from the ranks: a model cut by
    ``shard_encoder`` (the JAX engine replicates the params) and slots that
    do not divide over the axis."""
    for rank in case["ranks"]:
        assert "replicated over the mesh" in rank["refusals"]["cut"]
        assert "must divide over mesh axis 'data'=2" in rank["refusals"]["slots"]


def test_tp_lm_forward_and_ragged_step(case):
    """The LM cut by ``shard_lm`` (a kv-head and half the vocab a rank): a
    prompt then a step on the lockstep cache and one ragged step, the
    gathered logits against one process and the JAX package."""
    jcfg, jparams = case["jlm_cfg"], case["lm_params"]
    model = LM.LanguageModel(LM.LMConfig(**LM_KW), device="cpu")
    model.load_state_dict(case["inp"]["lm_state"])
    ids = case["inp"]["lm_ids"]
    cache = LM.init_cache(model.cfg, 2, 16, device="cpu")
    first, cache = LM.forward(model, LM.embed_tokens(model, ids), cache=cache)
    step, cache = LM.forward(model, LM.embed_tokens(model, ids[:, -1:]), cache=cache)
    ragged = LM.init_cache(model.cfg, 2, 16, per_stream_len=True, device="cpu")
    ragged["len"] = torch.tensor([3, 5])
    r_out, _ = LM.forward(model, LM.embed_tokens(model, ids[:, :1]), cache=ragged)
    fwd = jax.jit(lambda p, x, c: JLM.forward(p, JLM.embed_tokens(p, x), jcfg, cache=c))
    jc = JLM.init_cache(jcfg, 2, 16)
    jfirst, jc = fwd(jparams, jnp.asarray(ids.numpy()), jc)
    jstep, _ = fwd(jparams, jnp.asarray(ids[:, -1:].numpy()), jc)
    jr = JLM.init_cache(jcfg, 2, 16, per_stream_len=True)
    jr = {**jr, "len": jnp.asarray([3, 5], jnp.int32)}
    jragged, _ = fwd(jparams, jnp.asarray(ids[:, :1].numpy()), jr)
    for rank in case["ranks"]:
        got = rank["lm"]
        assert got["kv_heads"] == 1 and got["embed_rows"] == 32
        for key, want, ref in (("first", first, jfirst), ("step", step, jstep),
                               ("ragged", r_out, jragged)):
            assert _err(got[key], want["logits"]) <= VS_PORT, key
            assert _err(got[key], ref["logits"]) <= VS_JAX, key


@pytest.mark.parametrize("run", ["dp_greedy", "dp_int4", "tp_greedy", "tp_int4", "tp_sampled",
                                 "tp_top_k", "dp_eos_each_token", "dp_eos_lazy"])
def test_decode_engine_over_the_mesh_gives_the_one_process_tokens(case, run):
    """JAX ``test_lm_serving.py``'s 6 requests over 4 slots: over the data
    axis (2, 1) with the LM replicated, and over (1, 2) with the LM cut by
    ``shard_lm`` (the vocab-sharded head's greedy and Gumbel-max picks
    reduced over the shards, top-k on the gathered vocab), greedy, int4 KV
    and sampled, and with an EOS checked every token and lazily: every
    rank's tokens equal the one-process engine's."""
    model = LM.LanguageModel(LM.LMConfig(**LM_KW), device="cpu")
    model.load_state_dict(case["inp"]["lm_state"])
    kw = {"dp_int4": dict(cache_dtype="int4"), "tp_int4": dict(cache_dtype="int4"),
          "tp_sampled": dict(temperature=0.8, seed=3),
          "tp_top_k": dict(temperature=0.8, top_k=5, seed=3), "dp_eos_each_token": EOS_EACH,
          "dp_eos_lazy": EOS_LAZY}.get(run, {})
    want = worker._decode(model, PROMPTS, None, **kw)
    if "eos" in run:  # some request stops at the EOS, the rest run their budget
        assert any(t[-1] == 31 and len(t) < 5 for t in want)
    else:
        assert all(len(t) == 5 for t in want)
    for rank in case["ranks"]:
        assert rank["decode"][run] == want


def test_export_sharded_forward_at_model_2(case):
    """``export_sharded_forward`` over (1, 2), loaded by both ranks on their
    own groups: the rank's params and rows give the one-process full clip
    and the live tensor-parallel one; a mesh of another shape is refused."""
    want = encoder.model_forward(_whole(case), case["inp"]["video"][:, :4])
    for rank in case["ranks"]:
        got = rank["export"]
        assert got["mesh"] == {"data": 1, "model": 2}
        for key in ("last_hidden_state", "pooler_output"):
            assert _err(got["got"][key], got["live"][key]) <= VS_PORT
            assert _err(got["got"][key], want[key]) <= VS_PORT
        assert "exported for a mesh of {'data': 1, 'model': 2}" in got["refused"]


def test_dryrun_multiprocess_two_ranks():
    """``entry.dryrun_multiprocess(2)``: the regimes of the JAX package's
    multi-chip dry run on two gloo ranks, each held to one process."""
    from streamformer_tpu_torch import entry

    entry.dryrun_multiprocess(2, device="cpu")


@pytest.mark.parametrize("argv", [["--dryrun", "2"], []])
def test_dryrun_runs_on_the_card_unless_told_the_cpu(argv, monkeypatch):
    """The dry run's NCCL ranks default to a card each: without the cards
    it raises before it starts a rank, and names ``--device cpu``."""
    from streamformer_tpu_torch import entry

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="needs 2 CUDA devices, found 0.*--device cpu"):
        entry.main(argv)
