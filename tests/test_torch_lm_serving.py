"""The port's continuous-batching decode engine (streamformer_tpu_torch/
lm_serving.py) on the CPU.

Greedy engine tokens equal the JAX package's lone ``greedy_generate`` on the
same weights (once, across bucket padding, chunked prefill, slot recycling
and idle holds); the other contracts hold the engine to the port's own lone
``greedy_generate`` (itself held to JAX in test_torch_language_model.py) or
to another schedule of itself, as the JAX package's tests do. Sampling is
held to reproducibility and to its distribution, not to JAX's threefry
tokens: a chi-square test of 4,000 fixed-seed draws against the truncated
tempered softmax at the 0.1 % level.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from streamformer_tpu.models import language_model as JLM
from streamformer_tpu_torch.lm_serving import DecodeEngine, truncate_logits, gumbel_uniforms
from streamformer_tpu_torch.models import language_model as LM
from streamformer_tpu_torch.ops import quant

from test_torch_language_model import SMALL, embeds, pair


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these tensors are tiny, and the 6-worker run
    oversubscribes the cores with each worker's default thread pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def lm():
    return pair(seed=3)


def lone(model, params, ids, max_new, cap, **kw):
    return [int(t) for t in LM.greedy_generate(model, torch.from_numpy(embeds(params, ids)[None]),
                                               max_new_tokens=max_new, capacity=cap, **kw)[0]]


def run(model, prompts, params=None, budgets=None, tokens=False, **kw):
    """Open every prompt (ids, or embeddings when ``params`` is given), run
    until idle, and return each request's tokens (all finished)."""
    eng = DecodeEngine(model, **kw)
    budgets = budgets or [None] * len(prompts)
    if tokens:
        sids = [eng.open_tokens(p, max_new_tokens=b) for p, b in zip(prompts, budgets)]
    else:
        sids = [eng.open(embeds(params, p), max_new_tokens=b) for p, b in zip(prompts, budgets)]
    eng.run_until_idle()
    out = []
    for sid in sids:
        toks, done = eng.poll(sid)
        assert done, sid
        out.append(toks)
    return out, eng


def test_engine_matches_jax_lone_greedy(lm):
    """4 prompts over 2 slots, buckets (4, 8): every request's tokens equal
    the JAX package's lone ``greedy_generate`` and the port's."""
    params, model = lm
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 64, (n,)) for n in (3, 7, 2, 11)]
    refs = [list(np.asarray(JLM.greedy_generate(
        params, SMALL, jnp.asarray(embeds(params, p)[None]), max_new_tokens=5,
        capacity=24))[0]) for p in prompts]
    got, _ = run(model, prompts, params, slots=2, capacity=24, max_new_tokens=5,
                 prefill_buckets=(4, 8))
    assert got == refs
    assert [lone(model, params, p, 5, 24) for p in prompts] == refs


def test_chunked_prefill_overhang_and_refusals(lm):
    """A prompt past the largest bucket prefills in chained chunks; a last
    chunk whose padding overhangs the capacity (9 at buckets of 4, capacity
    10: 8 -> 12) does not clamp onto valid rows; bad requests are refused at
    open."""
    params, model = lm
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 64, (11,))
    got, _ = run(model, [ids], params, slots=1, capacity=24, max_new_tokens=4,
                 prefill_buckets=(4,))
    assert got == [lone(model, params, ids, 4, 24)]
    ids = rng.integers(0, 64, (9,))
    got, _ = run(model, [ids], params, slots=1, capacity=10, max_new_tokens=1,
                 prefill_buckets=(4,))
    assert got == [lone(model, params, ids, 1, 10)]
    eng = DecodeEngine(model, slots=1, capacity=24, max_new_tokens=4, prefill_buckets=(4,))
    with pytest.raises(ValueError, match="capacity"):
        eng.open(np.zeros((25, 32), np.float32))
    with pytest.raises(ValueError, match="L>=1"):
        eng.open(np.zeros((0, 32), np.float32))
    with pytest.raises(ValueError, match="hidden size"):
        eng.open(np.zeros((3, 16), np.float32))
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.open(np.zeros((2, 32), np.float32), max_new_tokens=0)
    with pytest.raises(ValueError, match="token ids"):
        eng.open_tokens([1, 64])
    with pytest.raises(ValueError, match="unknown request"):
        eng.poll(0)


def test_eos_capacity_and_stranding(lm):
    """EOS finishes a stream and frees its slot for a queued one; a stream at
    the capacity is finished (1 prefill token + capacity - prompt decodes),
    and its freed slot serves the queued request in the same tick; a
    reclaimed id answers ([], True); a prompt of exactly the capacity yields
    its prefill token only, its neighbour unharmed."""
    params, model = lm
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 64, (3,))
    ref = lone(model, params, ids, 4, 16)
    got, _ = run(model, [ids, ids], params, slots=1, capacity=16, max_new_tokens=8,
                 eos_token_id=ref[0], prefill_buckets=(4,))
    assert got == [[ref[0]], [ref[0]]]
    got, eng = run(model, [ids, ids], params, slots=1, capacity=8, max_new_tokens=50,
                   prefill_buckets=(4,))
    assert len(got[0]) == 1 + 5 and got[1] == got[0]
    assert eng.poll(0) == ([], True)
    full, small = rng.integers(0, 64, (12,)), rng.integers(0, 64, (3,))
    got, _ = run(model, [full, small], params, slots=2, capacity=12, max_new_tokens=4,
                 prefill_buckets=(4,))
    assert got == [lone(model, params, full, 1, 16), lone(model, params, small, 4, 12)]


@pytest.mark.parametrize("seed", [0, 1])
def test_fuzzed_schedules(lm, seed):
    """Requests opened at random points between ticks, random lengths and
    budgets, 2 slots: each equals its lone ``greedy_generate``."""
    params, model = lm
    rng = np.random.default_rng(200 + seed)
    eng = DecodeEngine(model, slots=2, capacity=20, max_new_tokens=4, prefill_buckets=(4, 8))
    expected = {}
    for _ in range(6):
        for _ in range(int(rng.integers(0, 4))):
            eng.tick()
        ids = rng.integers(0, 64, (int(rng.integers(1, 8)),))
        budget = int(rng.integers(1, 5))
        expected[eng.open(embeds(params, ids), max_new_tokens=budget)] = (
            lone(model, params, ids, budget, 20))
    eng.run_until_idle()
    for sid, ref in expected.items():
        assert eng.poll(sid) == (ref, True), sid


def test_sync_free_matches_forced_sync(lm):
    """Without an EOS id the engine is sync-free; it equals the same engine
    forced onto the per-tick sync, a mid-flight poll drains the prefix, and
    an in-tick drain at the stash limit changes nothing (sampled, so that
    the draw counts matter)."""
    params, model = lm
    rng = np.random.default_rng(77)
    prompts = [rng.integers(0, 64, (n,)) for n in (3, 6, 2)]
    kw = dict(capacity=24, max_new_tokens=6, prefill_buckets=(4, 8), temperature=0.6, seed=9)
    free = DecodeEngine(model, slots=2, **kw)
    assert free._sync_free
    free._stash_limit = 2
    sids = [free.open(embeds(params, p)) for p in prompts]
    free.tick()
    free.tick()
    prefix, done = free.poll(sids[0])
    assert not done and 1 <= len(prefix) <= 3
    free.run_until_idle()
    out_free = [prefix + free.poll(sids[0])[0]] + [free.poll(s)[0] for s in sids[1:]]
    synced = DecodeEngine(model, slots=2, **kw)
    synced._sync_free = False
    ss = [synced.open(embeds(params, p)) for p in prompts]
    synced.run_until_idle()
    assert out_free == [synced.poll(s)[0] for s in ss]
    assert all(len(t) == 6 for t in out_free)


def test_lazy_eos_matches_per_tick_eos(lm):
    """With an EOS id the engine checks it every ``eos_interval`` ticks; the
    overshoot is trimmed at the drain, so its streams equal the
    check-every-token engine's, each ending at its first EOS."""
    params, model = lm
    rng = np.random.default_rng(31)
    prompts = [rng.integers(0, 64, (n,)) for n in (3, 5, 2, 6)]
    eos = lone(model, params, prompts[0], 4, 24)[1]
    kw = dict(slots=2, capacity=24, max_new_tokens=12, prefill_buckets=(4, 8), eos_token_id=eos)
    lazy, eng = run(model, prompts, params, eos_interval=8, **kw)
    assert eng._sync_free
    legacy, eng = run(model, prompts, params, eos_interval=1, **kw)
    assert not eng._sync_free
    assert lazy == legacy
    assert lazy[0][-1] == eos and len(lazy[0]) <= 4
    assert all(eos not in t[:-1] for t in lazy)


def test_k_step_ticks_equal_one_step_ticks(lm):
    """``decode_steps_per_tick=4`` equals k=1 with budgets that are not
    multiples of 4, with and without a live EOS, and counts its ticks."""
    params, model = lm
    rng = np.random.default_rng(29)
    prompts = [rng.integers(0, 64, (n,)) for n in (3, 7, 2, 6, 5)]
    budgets = [5, 7, 4, 8, 6]
    kw = dict(slots=2, capacity=32, prefill_buckets=(4, 8), eos_interval=3, tokens=True,
              budgets=budgets)
    one, _ = run(model, prompts, **kw)
    four, eng = run(model, prompts, decode_steps_per_tick=4, **kw)
    assert four == one and eng.stats["decode_by_k"].get(4, 0) > 0
    eos = one[0][1]
    assert (run(model, prompts, decode_steps_per_tick=4, eos_token_id=eos, **kw)[0]
            == run(model, prompts, eos_token_id=eos, **kw)[0])
    with pytest.raises(ValueError, match="sync-free"):
        DecodeEngine(model, decode_steps_per_tick=4, eos_token_id=1, eos_interval=1)


def test_interleaved_admission_equals_eager(lm):
    params, model = lm
    rng = np.random.default_rng(31)
    prompts = [rng.integers(0, 64, (n,)) for n in (11, 3, 9, 2, 7, 10)]
    outs = [run(model, prompts, slots=2, capacity=24, max_new_tokens=5, prefill_buckets=(4,),
                tokens=True, prefill_chunks_per_tick=cpt)[0] for cpt in (1, None, 2)]
    assert outs[0] == outs[1] == outs[2]


def test_open_tokens_equals_open_embeds(lm):
    """Token ids embedded in the prefill, host embeddings and embeddings on
    the engine's device give the same tokens, chunked prefills included."""
    params, model = lm
    rng = np.random.default_rng(23)
    prompts = [rng.integers(0, 64, (n,)) for n in (3, 11, 2, 7, 6)]
    kw = dict(slots=2, capacity=24, max_new_tokens=5, prefill_buckets=(4, 8))
    by_emb = run(model, prompts, params, **kw)[0]
    assert run(model, prompts, tokens=True, **kw)[0] == by_emb
    eng = DecodeEngine(model, **kw)
    sids = [eng.open(LM.embed_tokens(model, torch.from_numpy(p))) for p in prompts]
    eng.run_until_idle()
    assert [eng.poll(s)[0] for s in sids] == by_emb


def test_stats_count_dispatches(lm):
    _, model = lm
    rng = np.random.default_rng(37)
    prompts = [rng.integers(0, 64, (n,)) for n in (3, 7, 11)]  # buckets 4, 8, then 8 + 4
    _, eng = run(model, prompts, slots=2, capacity=24, max_new_tokens=4, prefill_buckets=(4, 8),
                 tokens=True)
    assert eng.stats["admits"] == 3
    assert eng.stats["prefill_chunks"] == {4: 2, 8: 2}
    assert eng.stats["prefill_positions"] == 3 + 7 + 11
    assert eng.stats["decode_steps"] == eng.stats["decode_dispatches"]
    assert 5 <= eng.stats["decode_dispatches"] <= 9


def test_quantized_engines(lm):
    """An int8 cache's engine gives the float engine's greedy tokens on this
    toy model; int4 at most one flip in 8 (the JAX tests' policies); int8
    weights with the int8 ``lm_head`` run the engine, equal prompts giving
    equal tokens."""
    params, model = lm
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 64, (n,)) for n in (3, 5)]
    kw = dict(slots=2, capacity=16, max_new_tokens=4, prefill_buckets=(8,))
    fp = run(model, prompts, params, **kw)[0]
    assert run(model, prompts, params, cache_dtype="int8", **kw)[0] == fp
    q4 = run(model, prompts, params, cache_dtype="int4", **kw)[0]
    assert sum(a != b for x, y in zip(fp, q4) for a, b in zip(x, y)) <= 1
    _, qmodel = pair(SMALL.replace(tie_word_embeddings=False), seed=3, quantize=0)
    assert isinstance(qmodel.lm_head, quant.Int8Linear)
    outs = run(qmodel, [prompts[0]] * 3, params, slots=2, capacity=16, max_new_tokens=3,
               prefill_buckets=(8,))[0]
    assert len({tuple(t) for t in outs}) == 1 and all(0 <= t < 64 for t in outs[0])


def test_sampling_is_reproducible_and_slot_independent(lm):
    """A sampled request's tokens depend only on (seed, sid, n): packed with
    neighbours over 2 slots or alone in its own engine, they are equal;
    ``top_k=1`` at any temperature is greedy."""
    params, model = lm
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 64, (n,)) for n in (3, 5, 4)]
    kw = dict(capacity=24, max_new_tokens=5, prefill_buckets=(8,), temperature=0.8, seed=11)
    packed, _ = run(model, prompts, params, slots=2, **kw)
    for i, p in enumerate(prompts):
        eng = DecodeEngine(model, slots=1, **kw)
        for _ in range(i):  # burn sids, so that this request is sid i
            eng.open(embeds(params, prompts[0]))
            eng._pending.clear()
        sid = eng.open(embeds(params, p))
        eng.run_until_idle()
        assert eng.poll(sid) == (packed[i], True), i
    assert len({tuple(t) for t in packed}) > 1
    greedy = run(model, prompts[:1], params, slots=1, capacity=24, max_new_tokens=5,
                 prefill_buckets=(8,), temperature=0.7, top_k=1)[0]
    assert greedy == [lone(model, params, prompts[0], 5, 24)]


@pytest.mark.parametrize("top_k,top_p", [(None, None), (4, None), (None, 0.8)],
                         ids=["tempered", "top_k", "top_p"])
def test_sampler_follows_the_truncated_softmax(top_k, top_p):
    """4,000 draws (sids 0..3999, n = 0) from fixed logits over 6 tokens at
    temperature 0.7: the counts pass a chi-square test against
    softmax(truncated logits / 0.7) at the 0.1 % level (the critical values
    of 5, 3 and 2 degrees of freedom: 20.52, 16.27, 13.82), and truncated
    tokens are never drawn. The top-p cut keeps the smallest prefix reaching
    0.8 (the JAX engine's rule)."""
    logits = torch.tensor([[1.0, 0.5, 0.2, -0.3, -1.0, 0.8]])
    n = 4000
    lg = truncate_logits(logits.expand(n, 6), 0.7, top_k, top_p)
    u = gumbel_uniforms(1234, torch.arange(n), torch.zeros(n, dtype=torch.int64), 6)
    draws = (lg - torch.log(-torch.log(u))).argmax(-1)
    counts = torch.bincount(draws, minlength=6).double()
    kept = torch.isfinite(lg[0])
    p = torch.softmax(lg[0].double(), -1)
    assert counts[~kept].sum() == 0
    expected = n * p[kept]
    chi2 = float(((counts[kept] - expected) ** 2 / expected).sum())
    critical = {6: 20.52, 4: 16.27, 3: 13.82}[int(kept.sum())]
    assert chi2 < critical, (chi2, counts.tolist(), expected.tolist())
    if top_p is not None:  # sorted probs 0.361, 0.271, 0.177, ...: three reach 0.8
        assert kept.tolist() == [True, True, False, False, False, True]


def test_mesh_is_refused_naming_the_roadmap_item(lm):
    """The mesh's refusals that remain (the multi-rank engine runs in
    ``test_torch_dist_serve.py``): an axis the mesh lacks, slots that do not
    divide over it; and a trainable LM cut by ``shard_lm``, ROADMAP item
    14c."""
    class StubMesh:
        def __init__(self, names, size):
            self.mesh_dim_names, self._size = names, size

        def size(self, dim):
            return self._size

    with pytest.raises(ValueError, match="no axis 'data'"):
        DecodeEngine(lm[1], slots=2, mesh=StubMesh(("model",), 2))
    with pytest.raises(ValueError, match="must divide over mesh axis 'data'=3"):
        DecodeEngine(lm[1], slots=4, mesh=StubMesh(("data",), 3))
    from streamformer_tpu_torch.parallel import sharding

    trainable = LM.LanguageModel(lm[1].cfg, device="cpu", trainable=True)
    with pytest.raises(NotImplementedError, match="item 14c"):
        sharding.shard_lm(trainable, group=None)
