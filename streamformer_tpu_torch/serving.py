"""Continuous-batching streaming-encode serving engine on PyTorch.

Port of the JAX package's ``serving.py`` (the reference). ``slots``
concurrent streams advance together, each at its own position in the ragged
per-stream cache (``encoder.init_cache(per_stream_len=True)``); a finished
or closed stream frees its slot for the next queued one.

Semantics, as in the JAX package:

* ``open()`` admits a stream (FIFO into the next free slot);
  ``feed(sid, frames)`` enqueues host frames; ``poll(sid)`` drains the
  pooled features produced so far; ``close(sid)`` marks end-of-stream, and
  the slot is recycled once its frames are served.
* ``tick()`` advances every occupied slot that has a frame by one frame
  (latency mode: kernel D on the card). ``tick(frames=k)`` advances each
  slot by up to k of its own frames (throughput mode: kernel E, one call per
  chunk of ``ops.append_frame_cap(C)`` frames, or of ``num_frames`` where
  not one frame of E's whole-table plan fits, linear cache only; a mixed
  float cache too, whose chunks equal its t=1 steps bit for bit). On an
  int8 cache, and on the ring, it is t=1 steps (kernel G, or D), as the JAX
  engine's scan, but only as many as the fullest slot has frames (the scan
  runs k to bound its compiles; an eager step has none to bound); step i
  holds the slots that have fewer than i + 1 frames.
* A starved slot of the linear cache is HELD: it runs a dummy frame whose
  output is discarded and whose append is rolled back (``len`` unchanged),
  so the stream resumes where it paused. The ring cannot hold (its
  wrap-around write would evict in-window history), so in ring mode a
  starved open stream is an error: feed it every tick or close it.

A tick never waits on the device. The host keeps mirrors of what is staged
and consumed (``_wr``, ``_rd``) and decides everything from them; the
per-slot operands (``admit``, ``active`` or ``navail``) go to the device
only when their pattern changes, from pinned memory without a sync. Frames
are staged at ``feed`` time into a per-slot device ring, ``uint8`` and
normalized on the device if asked, and a tick gathers each slot's frames
there at its device-resident read pointer. Outputs stay on the device until
``poll``, whose one bulk copy is the engine's only device-to-host read.
All device work runs on the caller's thread, under ``torch.no_grad()``.

Over a device mesh (``mesh=``, JAX ``serving.py``'s data-parallel slots) the
engine is SPMD, as under ``torchrun``: every rank makes the same calls and
runs the same admission table over all ``slots`` (FIFO, the same grants),
while each holds the device state of its contiguous share of the slots
along ``mesh_axis`` only (cache rows, staging ring, read pointers, stash)
and runs each tick's step on them. The model is replicated, as the JAX
engine's ``device_put(params, repl)`` places it. A steady tick issues no
collective; ``poll(sid)`` broadcasts the owner's features over the mesh
axis, so every rank returns the same array.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from streamformer_tpu_torch.models import encoder
from streamformer_tpu_torch.ops import attention as ops
from streamformer_tpu_torch.parallel import mesh as mesh_lib


class StreamingEngine:
    """Slot-based continuous-batching server for streaming encode.

    ``model`` is a ``StreamformerEncoder``; the engine runs on its device.
    ``collect='pooled'`` keeps the (t, D) pooled features of each stream;
    ``collect=None`` discards outputs (cache building only). ``mesh`` (a
    ``DeviceMesh``, ``parallel.mesh.make_mesh``) shares the slots out over
    its ``mesh_axis``: ``slots`` must divide over it.
    """

    def __init__(
        self,
        model: encoder.StreamformerEncoder,
        slots: int = 8,
        capacity: Optional[int] = None,
        mode: str = "auto",
        collect: Optional[str] = "pooled",
        stage_depth: Optional[int] = None,
        stage_dtype: Optional[str] = None,
        normalize: Optional[Tuple] = None,
        mesh=None,
        mesh_axis: str = "data",
    ):
        if mesh is not None and model.parallel is not None:
            raise ValueError(
                "a model cut by shard_encoder: the engine's model is replicated over the "
                "mesh, as the JAX engine places it (device_put(params, repl)); pass the "
                "whole model and shard the slots")
        # this rank's slots: [lo, lo + local) of the mesh axis's share
        self._lo, self._local, self._group = mesh_lib.slot_share(mesh, mesh_axis, slots)
        self._share = slice(self._lo, self._lo + self._local)
        cfg = model.cfg
        capacity = capacity or cfg.cache_capacity
        if mode == "auto":
            mode = encoder.auto_cache_mode(cfg)
        if mode not in ("linear", "ring"):
            raise ValueError(f"mode {mode!r}: 'auto', 'linear' or 'ring'")
        if stage_dtype not in (None, "uint8"):
            raise ValueError(f"stage_dtype {stage_dtype!r}: None or 'uint8'")
        if normalize is not None and stage_dtype != "uint8":
            raise ValueError("normalize applies to uint8 staging (float feeds pre-normalize)")
        self.cfg = cfg.replace(cache_mode=mode, cache_capacity=capacity)
        self.model = model
        self.slots = slots
        self.mode = mode
        self.collect = collect
        dev = self._dev = model.device
        self._dt = encoder.compute_dtype(self.cfg)
        local = self._local
        self._cache = encoder.init_cache(self.cfg, local, capacity=capacity,
                                         per_stream_len=True, device=dev)
        # kernel E appends float planes only: an int8 tick is t=1 steps
        self._quantized = "k_scale" in self._cache["layers"][0]
        self.forwards = 0  # streaming_forward calls: t=1 steps and kernel-E chunks
        # per-slot device staging ring: feed() writes clips here in bulk, a
        # tick reads frame stage[s, rd[s] % depth]. depth >= capacity, so a
        # linear stream always fits; ring streams that outrun it wait in the
        # host queue and are staged as the ring drains.
        self._stage_depth = int(stage_depth or capacity)
        self._stage_u8 = stage_dtype == "uint8"
        # a device tensor, so that x / 255 is a true division (a Python
        # scalar divisor becomes a multiply by its reciprocal on the card,
        # one fp32 ulp off the host preprocess that a float feed applies)
        self._u8_scale = torch.tensor(255.0, device=dev)
        self._norm = None
        if normalize is not None:
            mean, std = (torch.tensor(v, dtype=torch.float32, device=dev).view(1, 1, -1, 1, 1)
                         for v in normalize)
            self._norm = (mean, std)
        c, hw = cfg.num_channels, cfg.image_size
        self._stage = torch.zeros((local, self._stage_depth, c, hw, hw),
                                  dtype=torch.uint8 if self._stage_u8 else self._dt, device=dev)
        self._slot_index = torch.arange(local, device=dev)
        self._rd_dev = torch.zeros(local, dtype=torch.int64, device=dev)  # device read ptrs
        self._wr = [0] * slots  # absolute frames staged per slot (host)
        self._rd = [0] * slots  # absolute frames consumed per slot (host mirror)
        self._slot_sid: List[Optional[int]] = [None] * slots
        self._queues: Dict[int, deque] = {}
        self._closed: set = set()
        self._results: Dict[int, list] = {}
        self._served: Dict[int, int] = {}
        self._polled: Dict[int, int] = {}  # features handed out per stream
        self._sid_slot: Dict[int, int] = {}  # the slot a stream was granted
        self._fed: Dict[int, int] = {}  # total frames fed per stream
        self._pending: deque = deque()  # sids waiting for a slot
        self._admit_next: set = set()  # slots granted since the last tick
        self._next_sid = 0
        # device outputs, demuxed at poll time so a tick never syncs; tick()
        # drains past _stash_limit so a caller that never polls cannot grow
        # device memory without bound
        self._stash: List[Tuple[torch.Tensor, int, List[Optional[int]], np.ndarray]] = []
        self._stash_limit = 256
        # device copies of the per-slot tick operands, re-sent only when the
        # host pattern changes (steady state: no admits, constant counts)
        self._flags_key: Optional[bytes] = None
        self._admit_dev = torch.zeros(local, dtype=torch.bool, device=dev)
        self._count_dev = torch.zeros(local, dtype=torch.bool, device=dev)  # active or navail
        self._no_admit = torch.zeros(local, dtype=torch.bool, device=dev)

    def _mine(self, s: int) -> bool:
        """Whether slot ``s``'s device state lives on this rank."""
        return self._lo <= s < self._lo + self._local

    # -- device side -------------------------------------------------------
    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device. On the card the copy is
        queued from pinned memory and does not wait for the device."""
        host = torch.from_numpy(np.ascontiguousarray(arr))
        if self._dev.type == "cuda":
            return host.pin_memory().to(self._dev, non_blocking=True)
        return host.to(self._dev, copy=True)

    def _normalize(self, frames: torch.Tensor) -> torch.Tensor:
        """uint8 staging: (x / 255 - mean) / std in fp32 on the device, then
        the compute dtype; float staging is already in the compute dtype."""
        if not self._stage_u8:
            return frames
        f = frames.float() / self._u8_scale
        if self._norm is not None:
            f = (f - self._norm[0]) / self._norm[1]
        return f.to(self._dt)

    def _step(self, admit: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
        """One t=1 tick of every slot: admitted slots restart (read pointer
        and ``len`` to 0), inactive slots hold (their append is rolled
        back). Returns the pooled outputs (slots, 1, D)."""
        rd = torch.where(admit, 0, self._rd_dev)
        frames = self._stage[self._slot_index, rd % self._stage_depth][:, None]
        encoder.reset_streams(self._cache, admit)
        out, _ = encoder.streaming_forward(self.model, self._normalize(frames), self._cache,
                                           cfg=self.cfg)
        self.forwards += 1
        self._cache["len"].sub_((~active).to(torch.int32))
        self._rd_dev = torch.where(active, rd + 1, rd)
        return out["pooler_output"]

    def _step_append(self, k: int, admit: torch.Tensor, navail: torch.Tensor) -> torch.Tensor:
        """A k-frame tick on the linear cache: slot s takes its own navail[s]
        staged frames through kernel E, one call per chunk of ``_chunk()``
        frames (chunk i+1 sees chunk i through the cache). Returns
        (slots, k, D); row s is valid up to navail[s]."""
        rd = torch.where(admit, 0, self._rd_dev)
        encoder.reset_streams(self._cache, admit)
        cap = self._chunk()
        outs = []
        for ci in range(0, k, cap):
            kk = min(cap, k - ci)
            idx = (rd[:, None] + ci + torch.arange(kk, device=self._dev)) % self._stage_depth
            frames = self._normalize(self._stage[self._slot_index[:, None], idx])
            valid = (navail - ci).clamp(0, kk).to(torch.int32)
            out, _ = encoder.streaming_forward(self.model, frames, self._cache,
                                               new_valid=valid, cfg=self.cfg)
            self.forwards += 1
            outs.append(out["pooler_output"])
        self._rd_dev = rd + navail
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)

    def _chunk(self) -> int:
        """Frames per kernel-E call: what E's whole-table body takes at this
        capacity (its tiled body, which takes any, where not one frame's
        plan fits), and at most ``cfg.num_frames``, since
        ``streaming_forward`` stretches the time-embedding table over a call
        of more frames than the trained ones, and a chunk's frames must take
        their positions' own rows."""
        fast = ops.append_frame_cap(self.cfg.cache_capacity)
        return min(fast or self.cfg.num_frames, self.cfg.num_frames)

    @torch.no_grad()
    def _stage_frames(self, s: int, q: deque) -> int:
        """Upload as many of ``q``'s frames as fit in slot ``s``'s staging
        ring, at ring positions (start + i) % depth; returns how many were
        staged (popped from ``q``)."""
        n = min(len(q), self._stage_depth - (self._wr[s] - self._rd[s]))
        if n <= 0:
            return 0
        frames = [q.popleft() for _ in range(n)]
        if self._mine(s):  # another rank's slot: its frames leave the queue all the same
            clip = self._upload(np.stack(frames))
            start = self._wr[s] % self._stage_depth
            idx = (torch.arange(n, device=self._dev) + start) % self._stage_depth
            self._stage[s - self._lo].index_copy_(0, idx, clip.to(self._stage.dtype))
        self._wr[s] += n
        return n

    # -- public API --------------------------------------------------------
    def open(self) -> int:
        """Admit a new stream; returns its id (slot granted now or FIFO)."""
        sid = self._next_sid
        self._next_sid += 1
        self._queues[sid] = deque()
        self._results[sid] = []
        self._served[sid] = 0
        self._polled[sid] = 0
        self._fed[sid] = 0
        self._pending.append(sid)
        return sid

    def feed(self, sid: int, frames) -> None:
        """Enqueue (t, C, H, W) host frames for stream ``sid``: uint8 for a
        uint8-staging engine, else float (rounded to the compute dtype on
        the device).

        In linear mode a stream is bounded by the cache capacity: feeding
        past it raises (the append would have nowhere to land). This host
        check is what keeps kernel E's ``lens + valid <= C``. Ring streams
        are unbounded (sliding window)."""
        if sid not in self._queues or sid in self._closed:
            raise ValueError(f"stream {sid} is not open")
        if self._stage_u8:
            frames = np.asarray(frames)
            if frames.dtype != np.uint8:
                raise TypeError(f"a uint8-staging engine feeds decoded uint8 frames, got "
                                f"{frames.dtype} (normalization happens on the device)")
        else:
            frames = np.asarray(frames, np.float32)
        c, hw = self.cfg.num_channels, self.cfg.image_size
        if frames.ndim != 4 or frames.shape[1:] != (c, hw, hw):
            raise ValueError(f"stream {sid}: frames of shape {frames.shape}, expected "
                             f"(t, {c}, {hw}, {hw})")
        if self.mode == "linear" and self._fed[sid] + len(frames) > self.cfg.cache_capacity:
            raise ValueError(
                f"stream {sid}: {self._fed[sid] + len(frames)} frames exceed the linear "
                f"cache capacity {self.cfg.cache_capacity}; use mode='ring' (sliding "
                "window) for unbounded streams"
            )
        self._fed[sid] += len(frames)
        self._queues[sid].extend(frames)
        # stage at ingest time, so the tick itself uploads nothing; granting
        # is eager so a stream opened after others finished stages on its
        # first feed, not after the next tick reclaims the slot
        self._grant_slots()
        if sid in self._slot_sid:
            s = self._slot_sid.index(sid)
            self._stage_frames(s, self._queues[sid])

    def close(self, sid: int) -> None:
        """End-of-stream: frames already fed are still served."""
        self._closed.add(sid)

    def active_streams(self) -> int:
        return len(self._pending) + sum(s is not None for s in self._slot_sid)

    def _grant_slots(self) -> None:
        """Retire drained closed streams and grant free slots to feedable
        pending streams (strict FIFO: the head blocks until it can feed). A
        granted slot's cache reset happens on the next tick (``admit``)."""
        for s in range(self.slots):
            if s in self._admit_next:
                continue  # freshly granted; its admit tick has not run yet
            sid = self._slot_sid[s]
            if sid is not None and (
                sid not in self._queues  # reclaimed by poll()
                or (sid in self._closed and not self._queues[sid] and self._wr[s] == self._rd[s])
            ):
                self._slot_sid[s] = None
            while self._slot_sid[s] is None and self._pending:
                head = self._pending[0]
                if head not in self._queues or (head in self._closed and not self._queues[head]):
                    self._pending.popleft()  # reclaimed, or nothing to serve
                    continue
                if self._queues[head]:
                    self._slot_sid[s] = self._pending.popleft()
                    self._sid_slot[head] = s
                    self._admit_next.add(s)
                    # the new stream stages from ring position 0; the tick
                    # resets the slot's device read pointer on admit
                    self._wr[s] = self._rd[s] = 0
                    self._stage_frames(s, self._queues[head])
                break

    def _send_flags(self, key: bytes, admit: np.ndarray, counts: np.ndarray) -> None:
        """This rank's slice of the per-slot operands, sent when they change."""
        if key != self._flags_key:
            self._flags_key = key
            self._admit_dev = self._upload(admit[self._share])
            self._count_dev = self._upload(counts[..., self._share])

    @torch.no_grad()
    def tick(self, frames: int = 1) -> bool:
        """Advance every feedable slot by up to ``frames`` staged frames;
        returns False when there was nothing to do.

        ``frames=1`` is the latency mode. ``frames=k>1`` is the throughput
        mode: in linear mode each slot takes its own count (0..k; holds fill
        the difference) through kernel E, or on an int8 cache as t=1 steps,
        as many as the fullest slot has frames, step i holding the slots
        with fewer than i + 1 frames; in ring mode, which cannot hold, every
        occupied slot takes the same min-over-slots count, as that many t=1
        steps. Decided on the host mirrors alone: no device read."""
        self._grant_slots()
        admit = np.zeros(self.slots, bool)
        for s in self._admit_next:
            admit[s] = True
        self._admit_next.clear()

        avail = np.zeros(self.slots, np.int64)
        fed_sids: List[Optional[int]] = [None] * self.slots
        for s in range(self.slots):
            sid = self._slot_sid[s]
            if sid is None:
                continue
            if self._queues[sid]:
                # overflow drain: frames queued on the host are staged as
                # the ring frees
                self._stage_frames(s, self._queues[sid])
            avail[s] = self._wr[s] - self._rd[s]
            if avail[s] > 0:
                fed_sids[s] = sid
            elif self.mode == "ring" and sid not in self._closed:
                raise RuntimeError(
                    f"stream {sid} starved a ring-mode slot: the sliding-window cache "
                    "cannot hold (its wrap-around write would evict in-window history); "
                    "feed() it every tick or close() it"
                )
        if not avail.any() and not admit.any():
            return False

        k = max(1, int(frames))
        if k > 1 and self.mode == "ring":
            # every occupied slot consumes exactly k: no ring holds
            k = min(k, min(int(a) for a in avail[avail > 0])) if avail.any() else 1
        navail = np.minimum(avail, k).astype(np.int32)
        if k == 1 or self.mode == "ring" or self._quantized:
            # one step per frame of the fullest slot (one for an admit-only
            # tick); step i's mask, row i, holds the slots without an i-th frame
            k = max(1, int(navail.max()))
            active = navail[None] > np.arange(k)[:, None]
            self._send_flags(b"step" + admit.tobytes() + active.tobytes(), admit, active)
            steps = [self._step(self._admit_dev if i == 0 else self._no_admit, self._count_dev[i])
                     for i in range(k)]
            pooled = steps[0] if k == 1 else torch.cat(steps, dim=1)
        else:
            self._send_flags(b"append" + admit.tobytes() + navail.tobytes(), admit, navail)
            pooled = self._step_append(k, self._admit_dev, self._count_dev)
        for s in range(self.slots):
            self._rd[s] += int(navail[s])
        if self.collect:
            self._stash.append((pooled, k, fed_sids[self._share], navail[self._share]))
            if len(self._stash) >= self._stash_limit:
                self._drain_stash()  # bound device-resident outputs
        for s, sid in enumerate(fed_sids):
            if sid is not None:
                self._served[sid] += int(navail[s])
        return True

    def _drain_stash(self) -> None:
        if not self._stash:
            return
        entries, self._stash = self._stash, []
        # one bulk copy for every stashed tick: entry i is (slots, n_i, D),
        # row s valid for its first navail[s] columns
        block = torch.cat([e[0] for e in entries], dim=1).float().cpu().numpy()
        off = 0
        for _, n, sids, navail in entries:
            for s, sid in enumerate(sids):
                if sid is not None and sid in self._results:
                    self._results[sid].extend(block[s, off:off + int(navail[s])])
            off += n

    def poll(self, sid: int) -> Tuple[np.ndarray, bool]:
        """(new (t, D) float32 features since the last poll, stream finished?).

        Per-stream bookkeeping is reclaimed on the poll that observes
        completion, so a long-lived engine stays O(live streams); a
        reclaimed id keeps answering (empty, True)."""
        if not 0 <= sid < self._next_sid:
            raise ValueError(f"unknown stream {sid}")
        empty = np.zeros((0, self.cfg.hidden_size), np.float32)
        if sid not in self._queues:  # reclaimed: finished earlier
            return empty, True
        self._drain_stash()
        out = self._results[sid]
        feats = np.stack(out) if out else empty
        self._results[sid] = []
        if self._group is not None and self.collect:
            feats = self._from_owner(sid, feats)
        # staged frames leave the host queue at feed time, so completion is
        # "every frame ever fed has been served", not an empty queue
        done = (sid in self._closed and not self._queues[sid]
                and self._served[sid] == self._fed[sid])
        if done:
            for d in (self._queues, self._results, self._served, self._polled, self._fed,
                      self._sid_slot):
                d.pop(sid, None)
            self._closed.discard(sid)
            if sid in self._pending:  # closed empty before ever admitted
                self._pending.remove(sid)
        return feats, done

    def _from_owner(self, sid: int, feats: np.ndarray) -> np.ndarray:
        """The features of ``sid`` from the rank that served its slot,
        broadcast over the mesh axis (every rank knows how many: the host
        tables are the same on every rank)."""
        rows = self._served[sid] - self._polled[sid]
        self._polled[sid] = self._served[sid]
        if not rows:
            return feats
        owner = self._sid_slot[sid] // self._local
        nccl = dist.get_backend(self._group) == "nccl"
        buf = torch.from_numpy(np.ascontiguousarray(feats, np.float32)) if self._mine(
            self._sid_slot[sid]) else torch.empty(rows, self.cfg.hidden_size)
        buf = buf.to(self._dev) if nccl else buf
        dist.broadcast(buf, src=dist.get_global_rank(self._group, owner), group=self._group)
        return buf.cpu().numpy()

    def has_work(self) -> bool:
        """True iff tick() would feed a frame: the engine's own admission
        rules, for actors and servers that must never spin on no-op ticks."""
        if any(sid is not None and (self._wr[s] > self._rd[s] or self._queues.get(sid))
               for s, sid in enumerate(self._slot_sid)):
            return True
        slot_free = any(
            sid is None or sid not in self._queues
            or (sid in self._closed and not self._queues[sid] and self._wr[s] == self._rd[s])
            for s, sid in enumerate(self._slot_sid)
        )
        if not slot_free:
            return False
        for h in self._pending:  # the effective FIFO head decides admission
            if h not in self._queues or (h in self._closed and not self._queues[h]):
                continue
            return bool(self._queues[h])
        return False

    def run_until_idle(self, max_ticks: int = 1_000_000, frames: int = 1) -> int:
        """Tick until every stream drains; returns the ticks run. ``frames``
        goes to tick() (throughput mode for k > 1)."""
        n = 0
        while n < max_ticks and self.tick(frames=frames):
            n += 1
        return n
