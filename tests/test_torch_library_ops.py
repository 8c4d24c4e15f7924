"""The kernels' forward entries as ``torch.library`` ops (``streamformer::``):
``torch.library.opcheck`` on every op (schema and its in-place writes, fake
implementation, dispatch under AOT tracing) on the CPU, where each op's
implementation is the entry's plain version; and the entries' dispatch: an
eager call runs the entry's body, a traced one the op, with the same
result and the same cache writes. The card's cases (each op against the
launcher called directly, ``opcheck`` on CUDA tensors) are in
``tests/test_torch_cuda.py``."""

import pytest
import torch

from streamformer_tpu_torch.ops import attention as ops

R, D, H, C, T = 6, 32, 4, 5, 3


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these tensors are tiny, and the 6-worker run
    oversubscribes the cores with each worker's default thread pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _q8(x):
    s = x.abs().amax(-1) / 127
    return torch.round(x / s[..., None]).to(torch.int8), s


def op_inputs(name, device="cpu", dtype=torch.float32):
    """Small inputs of each op: 2 streams of 3 rows, D=32 over 4 heads, a
    cache of 5 slots, 3 new frames."""
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, generator=g).to(device, dtype)

    def i32(*v):
        return torch.tensor(v, dtype=torch.int32, device=device)

    one = torch.tensor(2, dtype=torch.int32, device=device)
    if name.startswith("temporal_decode_pm_int8"):
        kq, ks = _q8(r(R, D).float())
        vq, vs = _q8(r(R, D).float())
        kc, kcs = _q8(r(C, R, D).float())
        vc, vcs = _q8(r(C, R, D).float())
        lens = (one,) if name == "temporal_decode_pm_int8" else (i32(1, 6), 3)
        return (r(R, D), kq, vq, ks, vs, kc, vc, kcs, vcs, *lens, H)
    return {
        "temporal_decode_pm": lambda: (r(R, D), r(R, D), r(R, D), r(C, R, D), r(C, R, D), one, H),
        "temporal_decode_rm": lambda: (r(R, D), r(R, D), r(R, D), r(R, C, D), r(R, C, D), one, H),
        "temporal_decode_rm_readonly": lambda: (r(R, D), r(R, C, D), r(R, C, D), None, None, one,
                                                H),
        "temporal_decode_pm_ragged": lambda: (r(R, D), r(R, D), r(R, D), r(C, R, D), r(C, R, D),
                                              i32(1, 4), 3, H),
        "temporal_append_pm_ragged": lambda: (r(T, R, D), r(T, R, D), r(T, R, D), r(C, R, D),
                                              r(C, R, D), i32(0, 1), i32(3, 2), 3, H),
        "temporal_append_pm_qkv": lambda: (r(2, T, 3, 3 * D), r(C, R, D), r(C, R, D), i32(0, 1),
                                           i32(3, 2), 3, H),
        "spatial_flat": lambda: (r(R, 7, D), r(R, 7, D), r(R, 7, D), H),
        "spatial_attention": lambda: (r(R, H, 7, 8), r(R, H, 7, 8), r(R, H, 7, 8)),
        "temporal_fullclip": lambda: (r(R, T, D), r(R, T, D), r(R, T, D), H),
        "temporal_fullclip_qkv": lambda: (r(2, T, 3, 3 * D), H),
    }[name]()


ENTRIES = {  # op name -> the entry the encoder calls
    "temporal_decode_pm": "temporal_decode_pm", "temporal_decode_rm": "temporal_decode_rm",
    "temporal_decode_rm_readonly": "temporal_decode_rm_readonly",
    "temporal_decode_pm_ragged": "temporal_decode_pm_ragged",
    "temporal_append_pm_ragged": "temporal_append_pm_ragged",
    "temporal_append_pm_qkv": "temporal_append_pm_qkv",
    "temporal_decode_pm_int8": "temporal_decode_pm_int8",
    "temporal_decode_pm_int8_ragged": "temporal_decode_pm_int8_ragged",
    "spatial_flat": "spatial_flat", "spatial_attention": "spatial_attention",
    "temporal_fullclip": "temporal_fullclip", "temporal_fullclip_qkv": "temporal_fullclip_qkv",
}


def test_every_forward_kernel_is_an_op():
    """A to G, J, K and L (E and C each with their packed entry)."""
    assert sorted(ops.OPS) == sorted(ENTRIES)


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_opcheck(name):
    result = torch.library.opcheck(ops.OPS[name], op_inputs(name))
    assert set(result.values()) == {"SUCCESS"}, result


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_traced_calls_take_the_op_and_agree_with_eager_ones(name, monkeypatch):
    """While traced (``_via_op`` true, as under ``torch.export``) the entry
    calls the op; its output and every in-place cache write equal an eager
    call's."""
    eager_args, traced_args = op_inputs(name), op_inputs(name)
    entry = getattr(ops, ENTRIES[name])
    want = entry(*eager_args)
    asked = []
    monkeypatch.setattr(ops, "_via_op", lambda: asked.append(name) or True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = entry(*traced_args)
    assert asked and f"streamformer::{name}" in {e.key for e in prof.key_averages()}
    assert torch.equal(got, want)
    for a, b in zip(eager_args, traced_args):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)


def test_a_loaded_program_needs_the_ops_and_no_model_code(tmp_path):
    """A process that imports ``export`` alone (which registers the ops)
    loads a streaming artifact and runs it, equal to the live step, without
    importing the model code; ``jax`` and the JAX package are blocked."""
    import os
    import subprocess
    import sys

    from streamformer_tpu_torch import export as EX
    from streamformer_tpu_torch.config import StreamformerConfig
    from streamformer_tpu_torch.models import encoder

    cfg = StreamformerConfig(image_size=32, num_frames=4, hidden_size=32, num_hidden_layers=1,
                             num_attention_heads=4, intermediate_size=64, dtype="float32",
                             cache_capacity=4)
    model = encoder.StreamformerEncoder(cfg, device="cpu",
                                        generator=torch.Generator().manual_seed(0))
    EX.export_streaming_step(cfg, 2, path=str(tmp_path / "step.pt2"), device="cpu")
    frames = torch.randn(2, 1, 3, 32, 32, generator=torch.Generator().manual_seed(1))
    cache = encoder.init_cache(cfg, 2, device="cpu")
    torch.save({"params": model.state_dict(), "frames": frames, "cache": cache},
               tmp_path / "inputs.pt")
    want, _ = encoder.streaming_forward(model, frames, encoder.init_cache(cfg, 2, device="cpu"))
    code = (
        "import sys, torch\n"
        "sys.modules['jax'] = sys.modules['streamformer_tpu'] = None\n"
        "from streamformer_tpu_torch import export\n"
        f"d = torch.load({str(tmp_path / 'inputs.pt')!r})\n"
        f"step = export.load_exported({str(tmp_path / 'step.pt2')!r}, device='cpu')\n"
        "out, cache = step(d['params'], d['frames'], d['cache'])\n"
        "assert int(cache['len']) == 1\n"
        "assert not [m for m in sys.modules if m.startswith('streamformer_tpu_torch.models')]\n"
        f"torch.save(out['pooler_output'], {str(tmp_path / 'out.pt')!r})\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": root}
    run = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    assert run.returncode == 0, run.stderr[-3000:]
    assert torch.equal(torch.load(tmp_path / "out.pt"), want["pooler_output"])
