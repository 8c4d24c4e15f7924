"""The port's demos (``python -m streamformer_tpu_torch.examples.<name>``)
in-process at toy size on the CPU (``STREAMFORMER_DEMO_SMOKE=1``), each
with its JAX counterpart's check: the second half streamed on the first
half's cache equals the full clip's tail, ragged rows equal lone streams,
and the engine's and the HTTP server's answers equal lone ``generate``
calls."""

import pytest
import torch

from streamformer_tpu_torch.examples import (continuous_batching_demo, streaming_demo,
                                             videoqa_serving_demo)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these tensors are tiny, and the 6-worker run
    oversubscribes the cores with each worker's default thread pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def smoke(monkeypatch):
    monkeypatch.setenv("STREAMFORMER_DEMO_SMOKE", "1")


def test_streaming_demo(capsys):
    out = streaming_demo.main(["--device", "cpu"])
    assert out["tail_err"] < streaming_demo.TOL and out["ring_finite"]
    assert out["int8_cosine"] > 0.99
    assert "(OK)" in capsys.readouterr().out


def test_continuous_batching_demo(capsys):
    out = continuous_batching_demo.main(["--device", "cpu"])
    assert out["worst"] < continuous_batching_demo.TOL and out["ticks"] >= 8
    assert "contract holds" in capsys.readouterr().out


def test_videoqa_serving_demo(capsys):
    out = videoqa_serving_demo.main(["--device", "cpu"])
    assert out["http"] == out["lone"][0] and all(len(t) == 4 for t in out["lone"])
    assert "videoqa serving demo OK" in capsys.readouterr().out


def test_demos_run_on_the_card_by_default():
    """Without ``--device`` a demo asks for the card (and raises without one
    rather than moving to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        streaming_demo.main([])
