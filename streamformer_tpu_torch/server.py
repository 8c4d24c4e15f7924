"""HTTP front ends over the PyTorch serving engines.

Port of the JAX package's ``server.py``: stdlib ``ThreadingHTTPServer``s
over ``serving.StreamingEngine`` (streaming encode) and
``lm_serving.DecodeEngine`` (generation; ``VideoQAServer`` runs the vision
tower and the splice in front of it). Request handlers run on the server's
thread pool, but every engine call, and so all device work, runs on ONE
actor thread through a command queue. The actor ticks the engine whenever
``engine.has_work()`` says a tick would make progress, and otherwise blocks
on the queue, so an idle server burns no cycles. The engine's tick runs
under ``torch.no_grad()`` on that thread (grad mode is thread-local, so a
caller's ``no_grad`` does not reach it).

StreamingServer routes (frames are base64 of raw float32 or uint8 (t, C, H, W)):

    POST /streams                      -> {"sid": int}
    POST /streams/<sid>/frames  {"frames_b64", "shape", "dtype"} -> {"ok"}
    POST /streams/<sid>/close          -> {"ok": true}
    GET  /streams/<sid>/features       -> {"features": [[...]], "done"}
    GET  /healthz                      -> {"ok", "slots", occupancy}

DecodeServer routes (prompt embeddings as base64 of raw float32 (L, D); build
them with ``LlavaQwenModel.prompt_embeds`` for a vision-spliced prompt):

    POST /requests  {"embeds_b64", "shape", "dtype"?, "max_new_tokens"?}
                                       -> {"rid": int}
    GET  /requests/<rid>/tokens        -> {"tokens": [...], "done"}
    GET  /healthz                      -> {"ok", "slots", occupancy}

VideoQAServer routes: ``POST /qa`` (``prompt_ids``, ``frames_b64``,
``shape``, ``dtype``?, ``max_new_tokens``?) and ``GET /qa/<rid>/tokens``.

Features and tokens are drained incrementally (the ``poll`` contract): each
GET returns what was produced since the previous one. Errors: an engine
rejection (bad input, overflow, unknown stream or request) is a 400 with the
message; a dead engine actor is a 503 on every route; an unknown route is a
404.
"""

from __future__ import annotations

import base64
import json
import queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from streamformer_tpu_torch.lm_serving import DecodeEngine
from streamformer_tpu_torch.models.encoder import StreamformerEncoder
from streamformer_tpu_torch.serving import StreamingEngine

__all__ = ["StreamingServer", "DecodeServer", "VideoQAServer"]


class _EngineActor:
    """Single-threaded executor that owns an engine: every call runs on one
    worker thread.

    ``has_work`` decides whether ``engine.tick()`` would make progress; it
    must have no false positives, or the actor spins on no-op ticks."""

    def __init__(self, engine, has_work: Callable[[], bool]):
        self._engine = engine
        self._has_work = has_work
        self._q: "queue.Queue" = queue.Queue()
        self._stop = object()
        self._fatal: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            try:
                # tick while work is queued; block when idle
                item = self._q.get(timeout=0.0 if self._has_work() else None)
            except queue.Empty:
                try:
                    self._engine.tick()
                except Exception as e:  # engine broken: every later call gets a 503
                    self._fatal = e
                    return
                continue
            if item is self._stop:
                return
            fn, args, out = item
            try:
                out["result"] = fn(self._engine, *args)
            except Exception as e:  # surfaced to the HTTP caller as a 400
                out["error"] = e
            out["event"].set()

    def call(self, fn: Callable, *args) -> Any:
        out: dict = {"event": threading.Event()}
        self._q.put((fn, args, out))
        # never wait on a dead actor: a tick() crash becomes an HTTP error,
        # not a hung connection
        while not out["event"].wait(timeout=1.0):
            if not self._thread.is_alive():
                raise _ActorDied(f"engine actor died: {self._fatal!r}")
        if "error" in out:
            raise out["error"]
        return out["result"]

    def shutdown(self):
        self._q.put(self._stop)
        self._thread.join(timeout=10)


class _ActorDied(RuntimeError):
    """The engine thread crashed: the server is down (503)."""


class _JSONHandler(BaseHTTPRequestHandler):
    """JSON plumbing for the handler."""

    def log_message(self, *a):  # quiet; deployments hook their own logging
        pass

    def _json(self, code: int, payload: dict) -> bool:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)
        return True  # responded; _guarded takes None for "no route"

    def _body(self) -> dict:
        n = int(self.headers.get("Content-Length") or 0)
        return json.loads(self.rfile.read(n) or b"{}")

    def _guarded(self, fn):
        """Run a route body: an engine rejection -> 400; a dead actor -> 503
        (server down, so retry and failover keyed on 5xx work); fn returning
        None -> 404."""
        try:
            if fn() is None:
                self._json(404, {"error": f"no route {self.path}"})
        except _ActorDied as e:
            self._json(503, {"ok": False, "error": str(e)})
        except Exception as e:
            self._json(400, {"error": str(e)})


class _HTTPServerBase:
    """start()/stop() scaffolding."""

    _actor: Optional[_EngineActor]

    def __init__(self, host: str, port: int):
        self._actor = None
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._host, self.port = host, port
        self._serve_thread: Optional[threading.Thread] = None

    def _start_http(self, handler_cls):
        self._httpd = ThreadingHTTPServer((self._host, self.port), handler_cls)
        self.port = self._httpd.server_address[1]
        self._serve_thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._serve_thread.start()
        return self

    def _healthz_payload(self, slots: int, stats_op) -> dict:
        stats = self._actor.call(stats_op)
        return {"ok": True, "slots": slots, **stats}

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._actor is not None:
            self._actor.shutdown()


class StreamingServer(_HTTPServerBase):
    """Serve streaming encode over HTTP.

    >>> srv = StreamingServer(model, slots=8, port=0).start()  # srv.port: the bound port
    >>> ... HTTP traffic ...
    >>> srv.stop()
    """

    def __init__(
        self,
        model: StreamformerEncoder,
        slots: int = 8,
        host: str = "127.0.0.1",
        port: int = 0,
        **engine_kw,
    ):
        super().__init__(host, port)
        # the linear cache by default, not the engine's "auto" (the ring):
        # independent HTTP clients feed in bursts between ticks, and a
        # momentarily starved ring slot is an error, while the linear cache
        # holds it losslessly. Pass mode="ring" only for always-fed traffic.
        engine_kw.setdefault("mode", "linear")
        self._engine = StreamingEngine(model, slots=slots, **engine_kw)

    # -- engine ops (run on the actor thread) ------------------------------
    @staticmethod
    def _op_open(e):
        return e.open()

    @staticmethod
    def _op_feed(e, sid, frames):
        e.feed(sid, frames)
        return True

    @staticmethod
    def _op_close(e, sid):
        e.close(sid)
        return True

    @staticmethod
    def _op_poll(e, sid):
        return e.poll(sid)

    @staticmethod
    def _op_stats(e):
        return {
            "active_streams": e.active_streams(),
            "slots_occupied": sum(s is not None for s in e._slot_sid),
        }

    def start(self):
        # the work predicate lives on the engine, next to the scheduling it
        # mirrors; the server never re-encodes admission rules
        self._actor = _EngineActor(self._engine, self._engine.has_work)
        server = self

        class Handler(_JSONHandler):
            def _route(self) -> Tuple[str, Optional[int], str]:
                parts = [p for p in self.path.split("/") if p]
                if parts == ["healthz"]:
                    return "healthz", None, ""
                if parts and parts[0] == "streams":
                    if len(parts) == 1:
                        return "streams", None, ""
                    try:
                        sid = int(parts[1])
                    except ValueError:  # a non-numeric id is a 404, not a dropped connection
                        return "", None, ""
                    return "streams", sid, parts[2] if len(parts) > 2 else ""
                return "", None, ""

            def do_GET(self):
                kind, sid, leaf = self._route()

                def run():
                    if kind == "healthz":
                        return self._json(200, server._healthz_payload(
                            server._engine.slots, server._op_stats))
                    if kind == "streams" and sid is not None and leaf == "features":
                        feats, done = server._actor.call(server._op_poll, sid)
                        return self._json(200, {"features": np.asarray(feats).tolist(),
                                                "done": bool(done)})
                    return None  # 404

                self._guarded(run)

            def do_POST(self):
                kind, sid, leaf = self._route()

                def run():
                    if kind == "streams" and sid is None:
                        return self._json(200, {"sid": server._actor.call(server._op_open)})
                    if kind == "streams" and sid is not None:
                        if leaf == "frames":
                            b = self._body()
                            raw = base64.b64decode(b["frames_b64"])
                            arr = np.frombuffer(
                                raw, dtype=np.dtype(b.get("dtype", "float32"))
                            ).reshape(b["shape"])
                            server._actor.call(server._op_feed, sid, arr)
                            return self._json(200, {"ok": True})
                        if leaf == "close":
                            server._actor.call(server._op_close, sid)
                            return self._json(200, {"ok": True})
                    return None  # 404

                self._guarded(run)

        return self._start_http(Handler)


class DecodeServer(_HTTPServerBase):
    """Serve generation (``lm_serving.DecodeEngine`` over a
    ``LanguageModel``) over HTTP, on the same one-actor design as
    ``StreamingServer``."""

    _PREFIX = "requests"

    def __init__(self, model, host: str = "127.0.0.1", port: int = 0, **engine_kw):
        super().__init__(host, port)
        self._engine = DecodeEngine(model, **engine_kw)

    @staticmethod
    def _op_open(e, emb, max_new):
        return e.open(emb, max_new_tokens=max_new)

    @staticmethod
    def _op_poll(e, rid):
        return e.poll(rid)

    @staticmethod
    def _op_stats(e):
        return {"slots_occupied": sum(s is not None for s in e._slot_sid),
                "pending": len(e._pending)}

    def _post_open(self, body: dict) -> int:
        """Parse a submission on the HTTP thread and admit it on the actor;
        device work belongs in the actor op. Subclasses override."""
        raw = base64.b64decode(body["embeds_b64"])
        emb = np.frombuffer(raw, dtype=np.dtype(body.get("dtype", "float32"))).reshape(body["shape"])
        return self._actor.call(self._op_open, emb, body.get("max_new_tokens"))

    def start(self):
        self._actor = _EngineActor(self._engine, self._engine.has_work)
        server = self

        class Handler(_JSONHandler):
            def do_POST(self):
                parts = [p for p in self.path.split("/") if p]

                def run():
                    if parts == [server._PREFIX]:
                        return self._json(200, {"rid": server._post_open(self._body())})
                    return None  # 404

                self._guarded(run)

            def do_GET(self):
                parts = [p for p in self.path.split("/") if p]

                def run():
                    if parts == ["healthz"]:
                        return self._json(200, server._healthz_payload(server._engine.slots,
                                                                       server._op_stats))
                    if len(parts) == 3 and parts[0] == server._PREFIX and parts[2] == "tokens":
                        try:
                            rid = int(parts[1])
                        except ValueError:  # a non-numeric id is a 404
                            return None
                        toks, done = server._actor.call(server._op_poll, rid)
                        return self._json(200, {"tokens": [int(t) for t in toks],
                                                "done": bool(done)})
                    return None  # 404

                self._guarded(run)

        return self._start_http(Handler)


class VideoQAServer(DecodeServer):
    """VideoQA as a service: video frames and a question in, tokens out.

    ``prompt_ids`` are the tokenizer's ids with ``IMAGE_TOKEN_INDEX``
    placeholders; frames are base64 of raw float32 (T, C, H, W), already
    preprocessed. The server runs the vision tower, the projector and the
    splice (``LlavaQwenModel.prompt_embeds``) and admits the request into
    the ``DecodeEngine``. All device work, the frames' upload and the
    tower's encode included, runs in the actor op on the one engine thread.

    The tower must not stream: a streaming tower holds one session's
    context, which independent concurrent requests would share (and a
    linear-cache tower would refuse all traffic once its capacity filled)."""

    _PREFIX = "qa"

    def __init__(self, model, host: str = "127.0.0.1", port: int = 0, **engine_kw):
        if getattr(model.tower, "streaming_mode", False):
            raise ValueError(
                "VideoQAServer requires a non-streaming tower "
                "(TimesformerVisionTower(..., streaming_mode=False)): streaming towers hold "
                "per-session context that would leak across independent HTTP requests"
            )
        _HTTPServerBase.__init__(self, host, port)
        self._model = model  # downstream.videoqa.LlavaQwenModel
        self._engine = DecodeEngine(model.lm, **engine_kw)

    def _op_ask(self, e, prompt_ids, frames, max_new):
        emb = self._model.prompt_embeds(prompt_ids, torch.from_numpy(frames.copy())[None])
        return e.open(emb, max_new_tokens=max_new)

    def _post_open(self, body: dict) -> int:
        raw = base64.b64decode(body["frames_b64"])
        frames = np.frombuffer(raw, dtype=np.dtype(body.get("dtype", "float32"))).reshape(
            body["shape"])
        ids = np.asarray(body["prompt_ids"], np.int64)
        return self._actor.call(self._op_ask, ids, frames, body.get("max_new_tokens"))
