"""The port's HTTP front end (streamformer_tpu_torch/server.py) on the CPU.

Drives the real ThreadingHTTPServer over a socket: open, feed, close and
poll through JSON and base64, three streams over two slots, features equal
to the port engine's, and the error mapping (400, 404, 503). All engine
work runs on the server's actor thread.
"""

import base64
import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from streamformer_tpu_torch.config import StreamformerConfig
from streamformer_tpu_torch.models import encoder
from streamformer_tpu_torch.server import StreamingServer
from streamformer_tpu_torch.serving import StreamingEngine

from test_torch_serving import SMALL, lone_stream


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these tensors are tiny, and the 6-worker run
    oversubscribes the cores with each worker's default thread pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def model():
    m = encoder.StreamformerEncoder(StreamformerConfig(**SMALL), device="cpu",
                                    generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for layer in m.encoder.layer:
            layer.temporal_attention_gating.fill_(0.5)
    return m


def _req(port, method, path, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _frames(arr: np.ndarray) -> dict:
    arr = np.ascontiguousarray(arr)
    return {"frames_b64": base64.b64encode(arr.tobytes()).decode(), "shape": list(arr.shape),
            "dtype": str(arr.dtype)}


def _features(port, sids, hidden):
    got, acc = {}, {sid: [] for sid in sids}
    deadline = time.time() + 60
    while len(got) < len(sids) and time.time() < deadline:
        for sid in sids:
            if sid in got:
                continue
            r = _req(port, "GET", f"/streams/{sid}/features")
            # an empty poll comes back as [], shape (0,)
            acc[sid].append(np.asarray(r["features"], np.float32).reshape(-1, hidden))
            if r["done"]:
                got[sid] = np.concatenate(acc[sid])
        time.sleep(0.02)
    return got


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_http_server_end_to_end(model, dtype):
    """3 streams over 2 slots, fed in two bursts each: every stream's
    features equal the engine's and a lone stream's."""
    rng = np.random.default_rng(0)
    lens = [3, 5, 2]
    if dtype == "uint8":
        clips = [rng.integers(0, 256, (n, 3, 32, 32), dtype=np.uint8) for n in lens]
        kw = dict(stage_dtype="uint8")
    else:
        clips = [rng.standard_normal((n, 3, 32, 32)).astype(np.float32) for n in lens]
        kw = {}
    srv = StreamingServer(model, slots=2, port=0, **kw).start()
    try:
        health = _req(srv.port, "GET", "/healthz")
        assert health["ok"] and health["slots"] == 2
        sids = []
        for clip in clips:
            sid = _req(srv.port, "POST", "/streams")["sid"]
            _req(srv.port, "POST", f"/streams/{sid}/frames", _frames(clip[:1]))
            _req(srv.port, "POST", f"/streams/{sid}/frames", _frames(clip[1:]))
            _req(srv.port, "POST", f"/streams/{sid}/close")
            sids.append(sid)
        got = _features(srv.port, sids, 64)
    finally:
        srv.stop()
    eng = StreamingEngine(model, slots=2, mode="linear", **kw)
    for sid, clip in zip(sids, clips):
        assert sid in got, f"stream {sid} never finished"
        s = eng.open()
        eng.feed(s, clip)
        eng.close(s)
        eng.run_until_idle()
        ref = eng.poll(s)[0]
        assert got[sid].shape == ref.shape == (len(clip), 64)
        assert np.abs(got[sid] - ref).max() <= 1e-5
        lone = lone_stream(model, clip.astype(np.float32) / (255.0 if dtype == "uint8" else 1.0))
        assert np.abs(got[sid] - lone).max() <= 1e-5


def test_http_server_errors(model):
    srv = StreamingServer(model, slots=1, port=0).start()
    try:
        sid = _req(srv.port, "POST", "/streams")["sid"]
        with pytest.raises(urllib.error.HTTPError) as ei:  # linear overflow
            _req(srv.port, "POST", f"/streams/{sid}/frames",
                 _frames(np.zeros((17, 3, 32, 32), np.float32)))
        assert ei.value.code == 400 and "exceed" in json.loads(ei.value.read())["error"]
        for path in ("/nope", "/streams/abc/features", f"/streams/{sid}/nothing"):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _req(srv.port, "GET", path)
            assert ei.value.code == 404, path
        with pytest.raises(urllib.error.HTTPError) as ei:  # unknown stream: the engine refuses
            _req(srv.port, "GET", "/streams/999/features")
        assert ei.value.code == 400
    finally:
        srv.stop()


def test_dead_engine_actor_is_503(model):
    """A tick that raises kills the actor; every later request is a 503."""
    srv = StreamingServer(model, slots=1, port=0)

    def broken_tick(frames=1):
        raise RuntimeError("device lost")

    srv._engine.tick = broken_tick
    srv.start()
    try:
        sid = _req(srv.port, "POST", "/streams")["sid"]
        _req(srv.port, "POST", f"/streams/{sid}/frames",
             _frames(np.zeros((1, 3, 32, 32), np.float32)))
        for path in ("/healthz", f"/streams/{sid}/features"):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _req(srv.port, "GET", path)
            assert ei.value.code == 503
            assert "device lost" in json.loads(ei.value.read())["error"]
    finally:
        srv.stop()
