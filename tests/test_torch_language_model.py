"""The port's language model against the JAX package's, on the CPU in fp32.

Same weights (the JAX ``init_params`` tree through ``lm_params_from_jax``)
and the same seeded numpy inputs. Logits within 1e-4 (fp32, summation order
only); greedy tokens, int8 weight codes and int8 / int4 KV codes exactly;
the quantized caches within the JAX tests' cosine gates (0.999 int8, 0.995
int4) of the float cache. HF parity runs against ``transformers``' Qwen2
and Llama on random small configs.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from streamformer_tpu.models import language_model as JLM
from streamformer_tpu.ops import quant as jax_quant
from streamformer_tpu_torch.checkpoint import lm_params_from_jax
from streamformer_tpu_torch.models import language_model as LM
from streamformer_tpu_torch.ops import quant

ATOL = 1e-4
SMALL = JLM.LMConfig(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                     num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
                     rope_theta=10000.0, rms_norm_eps=1e-6, tie_word_embeddings=True,
                     attention_bias=True)
FAMILIES = {"qwen2_tied": dict(), "qwen2_untied": dict(tie_word_embeddings=False),
            "llama_untied": dict(attention_bias=False, tie_word_embeddings=False),
            "llama_tied": dict(attention_bias=False)}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these tensors are tiny, and the 6-worker run
    oversubscribes the cores with each worker's default thread pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port_cfg(jcfg: JLM.LMConfig) -> LM.LMConfig:
    return LM.LMConfig(**dataclasses.asdict(jcfg))


def pair(jcfg=SMALL, seed=0, quantize=None):
    """(JAX params, port model) on the same weights; ``quantize`` a
    ``min_elements`` for both packages' int8 walks."""
    params = JLM.init_params(jax.random.PRNGKey(seed), jcfg)
    model = LM.LanguageModel(port_cfg(jcfg), device="cpu")
    if quantize is not None:
        params = jax_quant.quantize_encoder_params(params, min_elements=quantize)
        quant.quantize_lm(model, min_elements=quantize)
    model.load_state_dict(lm_params_from_jax(jax.tree.map(np.asarray, params)))
    return params, model


def embeds(params, ids):
    return np.asarray(JLM.embed_tokens(params, jnp.asarray(ids)), np.float32)


def err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))))


def cosine(a, b):
    a, b = np.ravel(a), np.ravel(b)
    return float((a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b)))


@pytest.mark.parametrize("family", FAMILIES)
def test_forward_matches_jax(family):
    """Qwen2-style (q/k/v biases) and Llama-style, tied and untied heads, a
    right-padded row; biases and norms drawn so that they matter."""
    jcfg = SMALL.replace(**FAMILIES[family])
    params, _ = pair(jcfg, seed=1)
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda x: x + 0.05 * jnp.asarray(
        rng.standard_normal(x.shape), x.dtype) if x.ndim == 1 else x, params)
    model = LM.LanguageModel(port_cfg(jcfg), device="cpu")
    model.load_state_dict(lm_params_from_jax(jax.tree.map(np.asarray, params)))
    ids = rng.integers(0, jcfg.vocab_size, (2, 9))
    mask = np.ones((2, 9), np.int64)
    mask[1, -3:] = 0
    emb = embeds(params, ids)
    ref, _ = JLM.forward(params, jnp.asarray(emb), jcfg, attention_mask=jnp.asarray(mask))
    got, _ = LM.forward(model, torch.from_numpy(emb), attention_mask=torch.from_numpy(mask))
    assert got["logits"].dtype == torch.float32 and got["logits"].shape == (2, 9, 64)
    assert err(got["logits"], ref["logits"]) <= ATOL
    assert err(got["last_hidden_state"], ref["last_hidden_state"]) <= ATOL
    assert err(LM.embed_tokens(model, torch.from_numpy(ids)), emb) == 0.0


def test_ragged_step_equals_lone_steps_and_jax():
    """One ragged step at depths 0, 4 and 9 equals each row's lone
    lockstep steps (logits within 1e-4, the appended K row within 1e-5), and
    the JAX ragged step; ``reset_streams`` re-admits one row."""
    params, model = pair(seed=3)
    rng = np.random.default_rng(0)
    cap, depths = 16, [0, 4, 9]
    hist = rng.integers(0, 64, (3, 10))
    new = rng.integers(0, 64, (3,))
    lone_logits, lone_k = [], []
    for r, dep in enumerate(depths):
        c = LM.init_cache(model.cfg, 1, cap, device="cpu")
        if dep:
            _, c = LM.forward(model, torch.from_numpy(embeds(params, hist[r, :dep])[None]), cache=c)
        out, c = LM.forward(model, torch.from_numpy(embeds(params, new[r:r + 1])[None]), cache=c)
        lone_logits.append(out["logits"][0, -1])
        lone_k.append(c["layers"][0]["k"][0])
    cr = LM.init_cache(model.cfg, 3, cap, per_stream_len=True, device="cpu")
    jr = JLM.init_cache(SMALL, 3, cap, per_stream_len=True)
    for r, dep in enumerate(depths):
        if dep:
            c1 = LM.init_cache(model.cfg, 1, cap, device="cpu")
            _, c1 = LM.forward(model, torch.from_numpy(embeds(params, hist[r, :dep])[None]),
                               cache=c1)
            for i in range(SMALL.num_hidden_layers):
                for kv in ("k", "v"):
                    cr["layers"][i][kv][r] = c1["layers"][i][kv][0]
                    jr["layers"][i][kv] = jr["layers"][i][kv].at[r].set(
                        c1["layers"][i][kv][0].numpy())
    cr["len"] = torch.tensor(depths)
    jr = {**jr, "len": jnp.asarray(depths, jnp.int32)}
    step = embeds(params, new)[:, None]
    out, cr = LM.forward(model, torch.from_numpy(step), cache=cr)
    jout, jr = JLM.forward(params, jnp.asarray(step), SMALL, cache=jr)
    for r in range(3):
        assert err(out["logits"][r, -1], lone_logits[r]) <= ATOL, r
        assert err(cr["layers"][0]["k"][r], lone_k[r]) <= 1e-5, r
    assert err(out["logits"], jout["logits"]) <= ATOL
    assert err(cr["layers"][1]["v"], jr["layers"][1]["v"]) <= 1e-5
    assert cr["len"].tolist() == [d + 1 for d in depths]
    cr = LM.reset_streams(cr, torch.tensor([False, True, False]))
    assert cr["len"].tolist() == [depths[0] + 1, 0, depths[2] + 1]


def test_cache_decode_equals_full_forward():
    """A prefill of 4 then two single steps through the cache, under a
    mask over the capacity, equal the full forward's logits."""
    params, model = pair()
    emb = torch.from_numpy(embeds(params, np.random.default_rng(1).integers(0, 64, (2, 6))))
    am = torch.cat([torch.ones(2, 6, dtype=torch.int64), torch.zeros(2, 10, dtype=torch.int64)], 1)
    cache = LM.init_cache(model.cfg, 2, 16, device="cpu")
    outs = []
    for lo, hi in ((0, 4), (4, 5), (5, 6)):
        out, cache = LM.forward(model, emb[:, lo:hi], attention_mask=am, cache=cache)
        outs.append(out["logits"])
    full, _ = LM.forward(model, emb)
    assert err(torch.cat(outs, 1), full["logits"]) <= ATOL
    assert int(cache["len"]) == 6 and cache["len"].ndim == 0


@pytest.mark.parametrize("padded", [False, True], ids=["plain", "right_padded"])
def test_greedy_generate_matches_jax(padded):
    """Greedy tokens equal the JAX package's exactly; a right-padded batch
    equals each row generated alone (its first new token at last valid
    position + 1)."""
    params, model = pair(seed=2)
    rng = np.random.default_rng(2)
    ids = rng.integers(1, 64, (2, 7))
    mask = np.ones((2, 7), np.int64)
    if padded:
        mask[0, 3:] = 0
        ids[0, 3:] = 0
    emb = embeds(params, ids)
    ref = JLM.greedy_generate(params, SMALL, jnp.asarray(emb), max_new_tokens=6,
                              attention_mask=jnp.asarray(mask))
    got = LM.greedy_generate(model, torch.from_numpy(emb), max_new_tokens=6,
                             attention_mask=torch.from_numpy(mask))
    assert got.shape == (2, 6)
    np.testing.assert_array_equal(got, np.asarray(ref))
    if padded:
        solo = LM.greedy_generate(model, torch.from_numpy(emb[:1, :3]), max_new_tokens=6)
        np.testing.assert_array_equal(got[0], solo[0])
    # the loop stops after the first step whose tokens are all EOS, as JAX's
    eos = int(got[0, 1])
    ref = JLM.greedy_generate(params, SMALL, jnp.asarray(emb[:1]), max_new_tokens=6,
                              attention_mask=jnp.asarray(mask[:1]), eos_token_id=eos)
    first = LM.greedy_generate(model, torch.from_numpy(emb[:1]), max_new_tokens=6,
                               attention_mask=torch.from_numpy(mask[:1]), eos_token_id=eos)
    np.testing.assert_array_equal(first, np.asarray(ref))
    assert first.shape[1] == 2


def test_lm_loss_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 5, 8)).astype(np.float32)
    labels = np.asarray([[1, 2, -100, 3, 4], [-100, 5, 6, -100, 7]])
    ref = float(JLM.lm_loss(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(LM.lm_loss(torch.from_numpy(logits), torch.from_numpy(labels)))
    assert abs(got - ref) <= 1e-6
    # every label ignored: zero, not nan
    assert float(LM.lm_loss(torch.from_numpy(logits), torch.full((2, 5), -100))) == 0.0


@pytest.mark.parametrize("min_elements", [0, 2048], ids=["all", "threshold"])
def test_int8_weights_match_jax(min_elements):
    """``quantize_lm`` quantizes the layers ``quantize_encoder_params``
    quantizes (the untied ``lm_head`` included; at 2048 elements only the
    MLP and the head), with the JAX codes and scales; the int8 forward's
    logits within 1e-4 of the JAX int8 forward's, and close to the float
    model's (cosine > 0.99, the JAX test's gate)."""
    jcfg = SMALL.replace(tie_word_embeddings=False)
    params, model = pair(jcfg, seed=4)
    qparams, qmodel = pair(jcfg, seed=4, quantize=min_elements)
    # quantize_lm on the float port model gives the JAX tree's codes
    fresh = LM.LanguageModel(port_cfg(jcfg), device="cpu")
    fresh.load_state_dict(lm_params_from_jax(jax.tree.map(np.asarray, params)))
    quant.quantize_lm(fresh, min_elements=min_elements)
    swapped = [n for n, m in fresh.named_modules() if isinstance(m, quant.Int8Linear)]
    assert ("lm_head" in swapped) and (len(swapped) == (15 if min_elements == 0 else 7))
    for (name, a), (_, b) in zip(fresh.state_dict().items(), qmodel.state_dict().items()):
        if a.dtype == torch.int8:
            assert torch.equal(a, b), name
        else:
            assert err(a, b) <= 1e-7, name
    assert "lm_head_q" in qparams and "lm_head" not in qparams
    ids = np.random.default_rng(10).integers(0, 64, (1, 6))
    emb = embeds(params, ids)
    ref, _ = JLM.forward(qparams, jnp.asarray(emb), jcfg)
    got, _ = LM.forward(fresh, torch.from_numpy(emb))
    flt, _ = LM.forward(model, torch.from_numpy(emb))
    assert err(got["logits"], ref["logits"]) <= ATOL
    assert cosine(got["logits"].numpy(), flt["logits"].numpy()) > 0.99


@pytest.mark.parametrize("cache_dtype,gate", [("int8", 0.999), ("int4", 0.995)])
def test_quantized_kv_matches_jax(cache_dtype, gate):
    """The int8 / int4 cache: codes equal the JAX package's, scales within
    1e-7, the next step's logits within 1e-4 of JAX's and within the cosine
    gate of the float cache's; the int4 plane is half the int8 one."""
    params, model = pair(seed=3)
    rng = np.random.default_rng(6)
    hist = embeds(params, rng.integers(0, 64, (6,)))[None].repeat(2, 0)
    new = embeds(params, rng.integers(0, 64, (2,)))[:, None]

    def port(cd):
        c = LM.init_cache(model.cfg, 2, 16, per_stream_len=True, cache_dtype=cd, device="cpu")
        _, c = LM.forward(model, torch.from_numpy(hist), cache=c)
        out, c = LM.forward(model, torch.from_numpy(new), cache=c)
        return out["logits"][:, -1].numpy(), c

    jc = JLM.init_cache(SMALL, 2, 16, per_stream_len=True, cache_dtype=cache_dtype)
    _, jc = JLM.forward(params, jnp.asarray(hist), SMALL, cache=jc)
    jout, jc = JLM.forward(params, jnp.asarray(new), SMALL, cache=jc)
    q, c = port(cache_dtype)
    fp, _ = port(None)
    for i in range(SMALL.num_hidden_layers):
        for name in ("k", "v"):
            np.testing.assert_array_equal(c["layers"][i][name].numpy(),
                                          np.asarray(jc["layers"][i][name]))
            assert err(c["layers"][i][name + "_scale"], jc["layers"][i][name + "_scale"]) <= 1e-7
    assert err(q, np.asarray(jout["logits"][:, -1])) <= ATOL
    assert cosine(fp, q) > gate
    width = c["layers"][0]["k"].shape[-1]
    assert width == SMALL.num_key_value_heads * SMALL.head_dim // (2 if cache_dtype == "int4" else 1)


@pytest.mark.parametrize("ragged,start,new", [(False, 16, 1), (True, 16, 1), (True, 15, 2)],
                         ids=["lockstep_full", "ragged_full", "ragged_overhang"])
def test_append_clamps_at_the_capacity_edge(ragged, start, new):
    """An append that would overhang the capacity lands at C - L, as
    ``dynamic_update_slice`` clamps it (the engine's idle slots at the edge):
    the planes equal JAX's, nothing is written out of bounds, and the
    logits (rotary positions and the mask at the unclamped start) equal
    JAX's."""
    params, model = pair(seed=5)
    rng = np.random.default_rng(7)
    cap = 16
    hist = embeds(params, rng.integers(0, 64, (2, start)))
    step = embeds(params, rng.integers(0, 64, (2, new)))
    c = LM.init_cache(model.cfg, 2, cap, per_stream_len=ragged, device="cpu")
    jc = JLM.init_cache(SMALL, 2, cap, per_stream_len=ragged)
    _, c = LM.forward(model, torch.from_numpy(hist), cache=c)
    _, jc = JLM.forward(params, jnp.asarray(hist), SMALL, cache=jc)
    before = c["layers"][0]["k"].clone()
    out, c = LM.forward(model, torch.from_numpy(step), cache=c)
    jout, jc = JLM.forward(params, jnp.asarray(step), SMALL, cache=jc)
    for i in range(SMALL.num_hidden_layers):
        assert err(c["layers"][i]["k"], jc["layers"][i]["k"]) <= 1e-5
        assert err(c["layers"][i]["v"], jc["layers"][i]["v"]) <= 1e-5
    # the clamped write moved rows C - L.. only
    assert torch.equal(c["layers"][0]["k"][:, :cap - new], before[:, :cap - new])
    assert not torch.equal(c["layers"][0]["k"][:, cap - new:], before[:, cap - new:])
    assert err(out["logits"], jout["logits"]) <= ATOL
    assert np.asarray(c["len"]).tolist() == np.asarray(jc["len"]).tolist()


@pytest.mark.parametrize("family", ["qwen2", "llama"])
def test_convert_hf_state_dict_matches_transformers(family):
    """An HF state dict loads through ``convert_hf_state_dict`` as it is; the
    logits equal ``transformers``' (eager attention, a right-padded row)
    within 1e-4."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    kw = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
              rope_theta=10000.0, rms_norm_eps=1e-6, attn_implementation="eager")
    if family == "qwen2":
        cfg = port_cfg(SMALL)
        hf = transformers.Qwen2ForCausalLM(transformers.Qwen2Config(tie_word_embeddings=True, **kw))
    else:
        cfg = port_cfg(SMALL.replace(attention_bias=False, tie_word_embeddings=False))
        hf = transformers.LlamaForCausalLM(transformers.LlamaConfig(
            tie_word_embeddings=False, attention_bias=False, **kw))
    hf = hf.eval()
    with torch.no_grad():  # biases drawn, so that they matter
        for name, p in hf.named_parameters():
            if name.endswith("bias"):
                p.normal_(0.0, 0.05)
    model = LM.LanguageModel(cfg, device="cpu")
    model.load_state_dict(LM.convert_hf_state_dict(hf.state_dict(), cfg))
    ids = np.random.default_rng(0).integers(0, 64, (2, 9))
    mask = np.ones((2, 9), np.int64)
    mask[1, -3:] = 0
    with torch.no_grad():
        ref = hf(input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask)).logits
    out, _ = LM.forward(model, LM.embed_tokens(model, torch.from_numpy(ids)),
                        attention_mask=torch.from_numpy(mask))
    valid = mask.astype(bool)
    assert err(out["logits"].numpy()[valid], ref.numpy()[valid]) <= ATOL


def test_entry_points_default_to_the_card(monkeypatch):
    """Without a card ``LanguageModel``, ``init_cache`` and the projector ask
    for ``device="cpu"`` instead of moving there on their own."""
    from streamformer_tpu_torch.downstream import videoqa

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LM.LanguageModel(port_cfg(SMALL))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LM.init_cache(port_cfg(SMALL), 1, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        videoqa.init_mm_projector(8, 16)
