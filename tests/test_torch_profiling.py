"""``utils/profiling.py`` against the JAX package's: the FLOP counts equal
at three configurations, ``mfu`` divides by the H100's bf16 peak, and
``timed`` and ``trace`` run on the CPU."""

import json
import os

import pytest
import torch

from streamformer_tpu.config import StreamformerConfig as JaxConfig
from streamformer_tpu.utils import profiling as jax_profiling
from streamformer_tpu_torch.config import StreamformerConfig
from streamformer_tpu_torch.utils import profiling

CONFIGS = {"flagship": {}, "small": dict(image_size=48, hidden_size=96, num_hidden_layers=3,
                                         num_attention_heads=4, intermediate_size=192),
           "ar_384": dict(image_size=384, num_frames=16)}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these tensors are tiny, and the 6-worker run
    oversubscribes the cores with each worker's default thread pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_flop_counts_equal_the_jax_package(name):
    cfg, jcfg = StreamformerConfig(**CONFIGS[name]), JaxConfig(**CONFIGS[name])
    for batch, frames in ((1, 16), (8, 4)):
        assert profiling.encoder_flops(cfg, batch, frames) == \
            jax_profiling.encoder_flops(jcfg, batch, frames)
        for context, t_new in ((16, 1), (24, 8)):
            assert profiling.streaming_step_flops(cfg, batch, context, t_new) == \
                jax_profiling.streaming_step_flops(jcfg, batch, context, t_new)
    # the same utilization against the H100's dense bf16 peak, not v5e's
    assert profiling.mfu(cfg, 8, 16, 0.5) == pytest.approx(
        jax_profiling.mfu(jcfg, 8, 16, 0.5, peak_tflops=989.0), rel=1e-12)
    assert profiling.mfu(cfg, 8, 16, 0.5) == pytest.approx(
        jax_profiling.mfu(jcfg, 8, 16, 0.5) * 197.0 / 989.0, rel=1e-12)


def test_timed_and_trace_run_on_the_cpu(tmp_path):
    x = torch.randn(64, 64)
    calls = []

    def fn():
        calls.append(1)
        return x @ x

    s = profiling.timed(fn, iters=4, warmup=1, reps=3, device="cpu")
    assert s > 0 and len(calls) == 1 + 4 * 3
    with profiling.trace(str(tmp_path / "prof"), device="cpu") as prof:
        fn()
    assert any("mm" in e.key for e in prof.key_averages())
    with open(os.path.join(tmp_path, "prof", "trace.json")) as f:
        assert json.load(f)["traceEvents"]


@pytest.mark.parametrize("call", ["timed", "trace"])
def test_measuring_the_card_without_one_raises(call, tmp_path, monkeypatch):
    """The card is measured unless the caller names the CPU: without a card
    ``timed`` and ``trace`` raise instead of falling back to the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if call == "timed":
            profiling.timed(lambda: None)
        else:
            with profiling.trace(str(tmp_path / "prof")):
                pass
