"""Deployment artifacts (``streamformer_tpu_torch/export.py``) on the CPU:
the full clip and the LM decode step against the live port (exactly) and
the JAX package (within 1e-3), loaded from bytes and from a file; the
refusals of another cache layout or device type; the traced graph of the
streaming step; the CLI. The streaming programs are in
``test_torch_export.py``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from streamformer_tpu.config import StreamformerConfig as JaxConfig
from streamformer_tpu.models import encoder as jax_encoder
from streamformer_tpu.models import language_model as JLM
from streamformer_tpu_torch import export as EX
from streamformer_tpu_torch.checkpoint import lm_params_from_jax, params_from_jax
from streamformer_tpu_torch.config import StreamformerConfig
from streamformer_tpu_torch.models import encoder
from streamformer_tpu_torch.models import language_model as LM

from test_torch_export import KW, B, JAX_TOL, _programs, draw_weights  # noqa: E402


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these tensors are tiny, and the 6-worker run
    oversubscribes the cores with each worker's default thread pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_full_clip_artifact(tmp_path):
    weights = draw_weights()
    cfg = StreamformerConfig(**KW)
    model = encoder.StreamformerEncoder(cfg, device="cpu")
    model.load_state_dict(params_from_jax(weights, cfg))
    blob = EX.export_full_clip(cfg, B, device="cpu")
    px = np.random.default_rng(2).standard_normal((B, 8, 3, 32, 32)).astype(np.float32)
    live = encoder.model_forward(model, torch.from_numpy(px))
    jcfg = JaxConfig(use_pallas=False, **KW)
    want = jax.jit(lambda p, x: jax_encoder.model_forward(p, x, jcfg))(weights, jnp.asarray(px))
    for call in _programs(blob, tmp_path):
        assert call.metadata["kind"] == "full_clip" and call.metadata["device_type"] == "cpu"
        got = call(model.state_dict(), torch.from_numpy(px))
        for key in ("pooler_output", "last_hidden_state"):
            assert torch.equal(got[key], live[key]), key
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=JAX_TOL,
                                       rtol=0, err_msg=key)


def _lm_pair():
    from test_language_model import SMALL

    jparams = jax.tree.map(np.asarray, JLM.init_params(jax.random.PRNGKey(5), SMALL))
    cfg = LM.LMConfig(**{k: getattr(SMALL, k) for k in LM.LMConfig.__dataclass_fields__
                         if hasattr(SMALL, k)})
    model = LM.LanguageModel(cfg, device="cpu")
    model.load_state_dict(lm_params_from_jax(jparams))
    return SMALL, jparams, cfg, model


@pytest.mark.parametrize("cache_dtype", [None, "int8"], ids=["float", "int8"])
def test_lm_decode_artifact_holds_idle_slots(tmp_path, cache_dtype):
    """Two slots at mixed depths, slot 1 idle for one step: the artifact's
    tokens equal the live port's greedy step and the JAX package's argmax,
    and the idle slot's frontier stays one behind."""
    jcfg, jparams, cfg, model = _lm_pair()
    blob = EX.export_lm_decode(cfg, 2, 12, cache_dtype=cache_dtype, device="cpu")
    programs = _programs(blob, tmp_path)

    def fresh():
        c = LM.init_cache(cfg, 2, 12, per_stream_len=True, cache_dtype=cache_dtype, device="cpu")
        c["len"] = torch.tensor([0, 3])
        return c

    caches = [fresh() for _ in range(3)]
    jcache = JLM.init_cache(jcfg, 2, 12, per_stream_len=True, cache_dtype=cache_dtype)
    jcache = {**jcache, "len": jnp.asarray([0, 3], jcache["len"].dtype)}
    jstep = jax.jit(lambda p, x, c: JLM.forward(p, JLM.embed_tokens(p, x)[:, None], jcfg, cache=c))
    rng = np.random.default_rng(11)
    for act in ([True, True], [True, False], [True, True]):
        toks = rng.integers(0, cfg.vocab_size, (2,))
        active = torch.tensor(act)
        out, caches[0] = LM.forward(model, LM.embed_tokens(model, torch.from_numpy(toks))[:, None],
                                    cache=caches[0])
        caches[0]["len"] = torch.where(active, caches[0]["len"], caches[0]["len"] - 1)
        live = out["logits"][:, -1].argmax(-1)
        jout, jcache = jstep(jparams, jnp.asarray(toks), jcache)
        jcache = {**jcache, "len": jnp.where(jnp.asarray(act), jcache["len"], jcache["len"] - 1)}
        np.testing.assert_allclose(out["logits"][:, -1].numpy(), np.asarray(jout["logits"][:, -1]),
                                   atol=JAX_TOL, rtol=0)
        for j, call in enumerate(programs, start=1):
            got, caches[j] = call(model.state_dict(), torch.from_numpy(toks), caches[j], active)
            assert got.dtype == torch.int32
            assert got.tolist() == live.tolist() == np.argmax(np.asarray(jout["logits"][:, -1]),
                                                               -1).tolist()
    for c in caches:
        assert c["len"].tolist() == [3, 5] == np.asarray(jcache["len"]).tolist()


def test_artifacts_refuse_another_layout_or_device(monkeypatch):
    cfg = StreamformerConfig(**KW)
    model = encoder.StreamformerEncoder(cfg, device="cpu")
    blob = EX.export_streaming_step(cfg, B, device="cpu")
    with pytest.raises(ValueError, match="exported for cpu, not cuda"):
        EX.load_exported(blob)  # the card by default: never moved
    call = EX.load_exported(blob, device="cpu")
    meta_params = {k: v.to("meta") for k, v in model.state_dict().items()}
    cache = encoder.init_cache(cfg, B, device="cpu")
    with pytest.raises(ValueError, match="exported for cpu"):
        call(meta_params, torch.zeros(B, 1, 3, 32, 32), cache)
    with pytest.raises(KeyError, match="params lack"):
        call({}, torch.zeros(B, 1, 3, 32, 32), cache)
    monkeypatch.setattr(EX, "CACHE_LAYOUT_VERSION", EX.CACHE_LAYOUT_VERSION + 1)
    with pytest.raises(ValueError, match="cache layout changed.*re-export"):
        EX.load_exported(blob, device="cpu")
    with pytest.raises(ValueError, match="needs the \\(data, model\\) mesh"):
        EX.export_sharded_forward(cfg, B, mesh=None)  # the sharded program: test_torch_dist_serve


def test_traced_step_calls_the_ops_in_place():
    """The streaming step's graph calls ``streamformer::temporal_decode_pm``
    and ``spatial_flat`` once a layer on the caches given, and holds no clone
    or copy of them (no functionalization copies)."""
    cfg = StreamformerConfig(**KW).replace(num_hidden_layers=2)
    call = EX.load_exported(EX.export_streaming_step(cfg, B, device="cpu"), device="cpu")
    targets = [str(n.target) for n in call.module.graph.nodes if n.op == "call_function"]
    assert targets.count("streamformer.temporal_decode_pm.default") == 2
    assert targets.count("streamformer.spatial_flat.default") == 2
    assert not [t for t in targets if "clone" in t or "copy" in t or "auto_functionalized" in t]


def test_cli_writes_an_artifact(tmp_path, capsys):
    """``main`` at the widths of a checkpoint's config.json (``--config``)."""
    StreamformerConfig(**KW).save_pretrained(str(tmp_path / "ckpt"))
    out = tmp_path / "step.pt2"
    EX.main(["--out", str(out), "--streaming", "--batch", "1", "--capacity", "8",
             "--num_frames", "8", "--dtype", "float32", "--config", str(tmp_path / "ckpt"),
             "--device", "cpu"])
    assert f"-> {out}" in capsys.readouterr().out
    call = EX.load_exported(str(out), device="cpu")
    assert call.metadata["kind"] == "streaming_step" and call.metadata["batch"] == 1
    assert call.metadata["config"]["hidden_size"] == KW["hidden_size"]
    with pytest.raises(SystemExit):
        EX.main(["--out", str(out), "--ragged", "--device", "cpu"])
