"""Continuous-batching LM decode engine on PyTorch (VideoQA's server side).

Port of the JAX package's ``lm_serving.py`` (the reference). ``slots``
concurrent requests advance through one ragged decode step a tick, each at
its own depth (the cache's ``len`` is per row), and a finished request frees
its slot for the next queued prompt at once.

* Ingest: ``open_tokens`` takes token ids, embedded on the device in the
  prefill; ``open`` takes (L, D) embeddings (VideoQA's spliced prompts). A
  tensor on the engine's device stays there; a host array starts its upload
  at ``open`` (pinned, without waiting for the device).
* Prefill: the prompt is cut into bucket-padded chunks at ``open``. A chunk
  runs against a batch-1 copy of its slot's row with ``lb`` rows of zero
  headroom, so that the padded append never reaches the capacity edge (where
  the append would clamp and move the chunk over valid rows); only the first
  ``capacity`` rows go back. ``len[slot]`` advances by the chunk's true
  length, and the next token is drawn from the vocab head applied to ONE
  hidden row, never the (lb, V) logits. Pad rows land past the frontier,
  masked until overwritten.
* Interleaved admission: at most ``prefill_chunks_per_tick`` chunks a tick
  (default 1; None admits eagerly), so a burst of opens never stalls the
  decoding slots. Each stream's tokens depend on its own row (greedy) or its
  (seed, sid, n) draws (sampled), not on the schedule.
* Decode: one ragged step for all slots; an idle slot decodes a dummy token
  whose row is rolled back (the ``len - 1`` hold). ``decode_steps_per_tick
  = k`` runs k steps in one tick, and drops to 1-step ticks whenever an
  active slot is within k of its budget or of the capacity.
* Finish: EOS, the request's budget, or the cache's capacity.

A steady tick never waits on the device: the host keeps mirrors of each
slot's length and count, tokens stay on the device and feed the next step,
the per-slot operands go to the device only when the slot map changes, and
the tokens drain to the results in one bulk copy at ``poll`` (or every
``eos_interval`` ticks when an EOS id is set, trimmed at the first EOS).

Sampling (``temperature > 0``) is Gumbel-max over the tempered logits,
truncated by ``top_k`` and by ``top_p`` with the JAX engine's nucleus rule.
The JAX engine keys a draw by threefry ``fold_in(fold_in(seed, sid), n)``,
which torch cannot reproduce; here each uniform is a counter-based hash of
(seed, sid, n, vocab index) (``encoder._mix32``, the hash of
``encoder.Draws``). So a request's tokens are reproducible and independent
of its slot and of the tick schedule, and follow the truncated tempered
softmax; they are not the JAX engine's tokens.

Over a device mesh (``mesh=``, JAX ``lm_serving.py``'s data-parallel slots)
the engine is SPMD, as under ``torchrun``: every rank makes the same calls
and keeps the same host tables over all ``slots``, while the slot axis of
the KV cache, ``len`` and the per-slot operands is cut over ``mesh_axis``
(each rank holds a contiguous share, prefills the requests granted to it
and decodes its slots). The LM is taken as given: replicated, as the JAX
engine places it, or cut by ``parallel.sharding.shard_lm`` over the mesh's
``model`` dim (its step is then the tensor-parallel forward, its cache the
rank's kv-heads, and greedy and Gumbel-max picks reduce over the vocab
shards). A drain gathers every rank's tokens over the mesh axis, so every
rank delivers the same tokens and finishes the same requests.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

import torch.distributed as dist

from streamformer_tpu_torch.models import encoder
from streamformer_tpu_torch.models import language_model as LM
from streamformer_tpu_torch.parallel import mesh as mesh_lib
from streamformer_tpu_torch.parallel import sharding

__all__ = ["DecodeEngine"]


def gumbel_uniforms(seed: int, sids: torch.Tensor, counts: torch.Tensor,
                    vocab: int, start: int = 0) -> torch.Tensor:
    """(S, V) fp32 uniforms in (0, 1) on steps of 2**-24, a hash of (seed,
    sid, n, vocab index) for each row's (sid, n) and the vocab indices
    start .. start + V - 1 (a vocab shard's): the same on any device, in any
    batch, on any shard."""
    m32, mix = encoder._M32, encoder._mix32
    key = mix(mix(seed & m32) ^ ((seed >> 32) & m32))
    row = mix(((sids.long() * 0x2545F491) & m32) ^ key)
    row = mix(((counts.long() * 0x9E3779B9) & m32) ^ row)  # (S,)
    elem = (torch.arange(start, start + vocab, dtype=torch.int64, device=sids.device)
            * 0x85EBCA6B) & m32
    bits = mix((row[:, None] + elem[None]) & m32)
    return ((bits >> 8).float() + 0.5) * 2.0**-24


def truncate_logits(logits: torch.Tensor, temperature: float, top_k: Optional[int],
                    top_p: Optional[float]) -> torch.Tensor:
    """(S, V) logits / temperature in fp32, entries outside the top k and
    outside the nucleus set to -inf. The nucleus is the smallest prefix of
    the sorted tokens whose mass reaches ``top_p`` (the first token to cross
    it stays in), the JAX engine's rule."""
    lg = logits.float() / temperature
    if top_k is not None:
        kth = torch.topk(lg, top_k, dim=-1).values[:, -1:]
        lg = lg.masked_fill(lg < kth, -float("inf"))
    if top_p is not None:
        srt = torch.sort(lg, dim=-1, descending=True).values
        probs = torch.softmax(srt, dim=-1)
        cut = ((probs.cumsum(-1) - probs) < top_p).sum(-1, keepdim=True)  # number kept
        thresh = srt.gather(-1, (cut - 1).clamp_min(0))
        lg = lg.masked_fill(lg < thresh, -float("inf"))
    return lg


class DecodeEngine:
    """Slot-based continuous-batching generation over a ``LanguageModel``;
    the engine runs on the model's device.

    ``temperature=0`` (default) decodes greedily. ``eos_interval``: with an
    ``eos_token_id``, how many ticks may pass between EOS checks; above 1
    the engine stays on the sync-free path (EOS found at the periodic drain,
    output trimmed at the first EOS, at most ``eos_interval - 1`` wasted
    steps a stream), 1 checks every token. ``cache_dtype``: None, "int8" or
    "int4" (``language_model.init_cache``). ``decode_steps_per_tick=k``
    runs k decode steps a tick; it needs the sync-free path. ``mesh`` (a
    ``DeviceMesh``) cuts the slots over its ``mesh_axis``: ``slots`` must
    divide over it."""

    def __init__(
        self,
        model: LM.LanguageModel,
        slots: int = 8,
        capacity: int = 512,
        max_new_tokens: int = 128,
        eos_token_id: Optional[int] = None,
        prefill_buckets: Sequence[int] = (32, 64, 128, 256),
        temperature: float = 0.0,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        seed: int = 0,
        cache_dtype: Optional[str] = None,
        eos_interval: int = 8,
        mesh=None,
        mesh_axis: str = "data",
        prefill_chunks_per_tick: Optional[int] = 1,
        decode_steps_per_tick: int = 1,
    ):
        # this rank's slots: [lo, lo + local) of the mesh axis's share
        self._lo, self._local, self._group = mesh_lib.slot_share(mesh, mesh_axis, slots)
        self._share = slice(self._lo, self._lo + self._local)
        self.model = model
        self.cfg = model.cfg
        self._dev = model.device
        self.slots = slots
        self.capacity = capacity
        self.max_new_tokens = max_new_tokens
        self.eos_token_id = eos_token_id
        self.temperature = float(temperature)
        self.top_k = top_k
        self.top_p = top_p
        self.seed = int(seed)
        self.cache_dtype = cache_dtype
        self.buckets = sorted(b for b in prefill_buckets if b <= capacity)
        if not self.buckets:
            raise ValueError(f"no prefill bucket of {tuple(prefill_buckets)} fits the capacity "
                             f"{capacity}")
        self.prefill_chunks_per_tick = prefill_chunks_per_tick
        self.decode_steps_per_tick = max(1, int(decode_steps_per_tick))
        self.eos_interval = max(1, int(eos_interval))
        self._sync_free = eos_token_id is None or self.eos_interval > 1
        if self.decode_steps_per_tick > 1 and not self._sync_free:
            raise ValueError("decode_steps_per_tick > 1 needs the sync-free path "
                             "(eos_interval > 1 or no eos_token_id)")
        local = self._local
        self._cache = LM.init_cache(self.cfg, local, capacity, per_stream_len=True,
                                    cache_dtype=cache_dtype, device=self._dev,
                                    kv_heads=LM.local_kv_heads(model))
        # host bookkeeping, with mirrors of each slot's cache length and
        # count of drawn tokens, so that a tick never reads the device
        self._slot_sid: List[Optional[int]] = [None] * slots
        self._last_tok = np.zeros(slots, np.int64)
        self._host_len = np.zeros(slots, np.int64)
        self._host_gen = np.zeros(slots, np.int64)
        # pending: (sid, [(bucket, device chunk, true length), ...], true length, tokens?)
        self._pending: deque = deque()
        self._inflight: Optional[dict] = None  # a partly prefilled admission
        self._results: Dict[int, list] = {}
        self._done: set = set()
        self._budget: Dict[int, int] = {}
        self._next_sid = 0
        self._last_tok_dev = torch.zeros(local, dtype=torch.int64, device=self._dev)
        # device copies of this rank's per-slot operands, sent again only when
        # the slot map changes; the counts advance on the device
        self._occupancy: Tuple[Optional[int], ...] = tuple([None] * slots)
        self._active_dev = torch.zeros(local, dtype=torch.bool, device=self._dev)
        self._sids_dev = torch.zeros(local, dtype=torch.int64, device=self._dev)
        self._counts_dev = torch.zeros(local, dtype=torch.int64, device=self._dev)
        # drawn tokens not yet on the host: ((k, S_local) tokens, slot -> sid
        # map) a tick, or ((1,) token, (sid, slot)) a completed admission
        self._stash: List[Tuple[torch.Tensor, object]] = []
        self._stash_limit = 512
        self._ticks_since_drain = 0
        self._eos_trimmed: set = set()
        self.stats = {"prefill_chunks": {}, "decode_dispatches": 0, "decode_steps": 0,
                      "decode_by_k": {}, "admits": 0, "prefill_positions": 0}

    # -- device programs ------------------------------------------------------
    def _select(self, logits: torch.Tensor, sids: torch.Tensor,
                counts: torch.Tensor) -> torch.Tensor:
        """(S, V) logits -> (S,) tokens: argmax, or a Gumbel-max draw keyed
        by (seed, sid, n). Logits of a vocab-sharded head are this rank's
        slice (``lm_logits(..., gather=False)``): the pick is reduced over
        the shards, each uniform keyed by its global vocab index, so the
        tokens are the unsharded engine's; top-k and top-p gather the whole
        vocab first."""
        par, offset = LM.vocab_shard(self.model)
        if par is not None and self.temperature > 0.0 and (self.top_k or self.top_p):
            logits, par, offset = sharding.all_gather(logits, par.group, dim=-1), None, 0
        if self.temperature <= 0.0:
            return sharding.sharded_argmax(logits, par, offset)
        lg = truncate_logits(logits, self.temperature, self.top_k, self.top_p)
        u = gumbel_uniforms(self.seed, sids, counts, lg.shape[-1], offset)
        return sharding.sharded_argmax(lg - torch.log(-torch.log(u)), par, offset)

    def _decode_step(self, toks: torch.Tensor) -> torch.Tensor:
        """One ragged step of every slot: (S,) tokens in, (S,) drawn tokens
        out; idle slots' rows are rolled back, active slots' counts advance."""
        emb = LM.embed_tokens(self.model, toks)[:, None]
        out, cache = LM.forward(self.model, emb, cache=self._cache, logits=False)
        cache["len"] = torch.where(self._active_dev, cache["len"], cache["len"] - 1)
        self._cache = cache
        logits = LM.lm_logits(self.model, out["last_hidden_state"][:, -1], gather=False)
        ntok = self._select(logits, self._sids_dev, self._counts_dev)
        self._counts_dev += self._active_dev.long()
        return ntok

    def _prefill_chunk(self, payload: torch.Tensor, tokens: bool, slot: int, pos0: int,
                       true_lc: int, sid: int) -> torch.Tensor:
        """One prefill chunk of a slot: its row with ``lb`` rows of zero
        headroom, the chunk appended at ``pos0``, the first ``capacity`` rows
        written back, ``len[slot] = pos0 + true_lc``; returns the (1,) token
        drawn from hidden row ``true_lc - 1`` (draw n = 0). A slot of another
        rank's share: nothing runs here, and the token is a placeholder 0."""
        if not self._lo <= slot < self._lo + self._local:
            return torch.zeros(1, dtype=torch.int64, device=self._dev)
        slot -= self._lo
        emb = LM.embed_tokens(self.model, payload) if tokens else payload  # (1, lb, D)
        lb, cap = emb.shape[1], self.capacity
        view = {"layers": [{name: torch.cat([plane[slot:slot + 1],
                                             plane.new_zeros((1, lb) + plane.shape[2:])], 1)
                            for name, plane in layer.items()}
                           for layer in self._cache["layers"]],
                "len": torch.full((1,), pos0, dtype=torch.int64, device=self._dev)}
        out, view = LM.forward(self.model, emb, cache=view, logits=False)
        h = out["last_hidden_state"][:, true_lc - 1]  # (1, D)
        sid_t = torch.full((1,), sid, dtype=torch.int64, device=self._dev)
        tok = self._select(LM.lm_logits(self.model, h, gather=False), sid_t,
                           torch.zeros_like(sid_t))
        for big, small in zip(self._cache["layers"], view["layers"]):
            for name, plane in big.items():
                plane[slot:slot + 1].copy_(small[name][:, :cap])
        self._cache["len"][slot] = pos0 + true_lc
        # the drawn token is also the slot's next decode input
        self._last_tok_dev[slot] = tok[0]
        return tok

    # -- ingest ---------------------------------------------------------------
    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        host = torch.from_numpy(np.ascontiguousarray(arr))
        if self._dev.type == "cuda":
            return host.pin_memory().to(self._dev, non_blocking=True)
        return host.to(self._dev, copy=True)

    def _chunkify(self, payload, tokens: bool) -> List[tuple]:
        """Cut a prompt into bucket-padded device chunks at ``open``: a host
        payload starts uploading here; a device payload is padded there."""
        lmax = self.buckets[-1]
        n = payload.shape[0]
        dt = encoder.compute_dtype(self.cfg)
        chunks = []
        pos = 0
        while pos < n:
            lc = min(n - pos, lmax)
            lb = next(b for b in self.buckets if b >= lc)
            piece = payload[pos:pos + lc]
            if tokens:
                padded = np.zeros((1, lb), np.int64)
                padded[0, :lc] = piece
                dev = self._upload(padded)
            elif torch.is_tensor(piece):
                dev = torch.zeros((1, lb) + tuple(piece.shape[1:]), dtype=dt, device=self._dev)
                dev[0, :lc] = piece
            else:
                # host embeddings go up in the model's dtype (half of fp32's
                # bytes under bf16; the forward casts anyway)
                padded = np.zeros((1, lb) + piece.shape[1:], np.float32)
                padded[0, :lc] = piece
                dev = self._upload(padded).to(dt)
            chunks.append((lb, dev, lc))
            pos += lc
        return chunks

    # -- public API -----------------------------------------------------------
    def open(self, prompt_embeds, max_new_tokens: Optional[int] = None) -> int:
        """Queue a request of (L, D) prompt embeddings (token embeddings, with
        vision features spliced in for VideoQA). A tensor on the engine's
        device stays there; anything else is a host array that starts
        uploading now."""
        if torch.is_tensor(prompt_embeds):
            emb = prompt_embeds.to(self._dev)
        else:
            emb = np.asarray(prompt_embeds, np.float32)
        if emb.ndim != 2 or emb.shape[0] == 0:
            raise ValueError(f"prompt_embeds must be (L>=1, D), got {tuple(emb.shape)}")
        if emb.shape[1] != self.cfg.hidden_size:
            raise ValueError(f"prompt_embeds width {emb.shape[1]} is not the model's hidden size "
                             f"{self.cfg.hidden_size}")
        return self._enqueue(emb, tokens=False, max_new_tokens=max_new_tokens)

    def open_tokens(self, token_ids, max_new_tokens: Optional[int] = None) -> int:
        """Queue a request of (L,) token ids, embedded on the device in the
        prefill (L integers cross to the card, not L x D floats)."""
        ids = np.asarray(token_ids, np.int64)
        if ids.ndim != 1 or len(ids) == 0:
            raise ValueError(f"token_ids must be (L>=1,), got {ids.shape}")
        if ids.min() < 0 or ids.max() >= self.cfg.vocab_size:
            raise ValueError(f"token ids must lie in [0, {self.cfg.vocab_size})")
        return self._enqueue(ids, tokens=True, max_new_tokens=max_new_tokens)

    def _enqueue(self, payload, tokens: bool, max_new_tokens: Optional[int]) -> int:
        n = payload.shape[0]
        if n > self.capacity:
            raise ValueError(
                f"prompt length {n} exceeds the cache capacity {self.capacity} (long prompts "
                "prefill in chunks, but the whole prompt must fit the cache)"
            )
        budget = self.max_new_tokens if max_new_tokens is None else max_new_tokens
        if budget < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {budget} (the prefill itself "
                             "produces the first token)")
        sid = self._next_sid
        self._next_sid += 1
        self._results[sid] = []
        self._budget[sid] = budget
        self._pending.append((sid, self._chunkify(payload, tokens), n, tokens))
        return sid

    # -- admission -----------------------------------------------------------
    def _advance_prefill(self, max_chunks: Optional[int]) -> int:
        """Run up to ``max_chunks`` prefill chunks (None: no bound), starting,
        continuing and finishing admissions in FIFO order. Returns the number
        of admissions completed."""
        finished = issued = 0
        while max_chunks is None or issued < max_chunks:
            if self._inflight is None:
                if not self._pending:
                    break
                s = next((i for i in range(self.slots) if self._slot_sid[i] is None), None)
                if s is None:
                    break
                sid, chunks, true_len, tokens = self._pending.popleft()
                self._inflight = {"sid": sid, "slot": s, "chunks": list(chunks),
                                  "true_len": true_len, "tokens": tokens, "pos": 0}
            inf = self._inflight
            lb, dev, lc = inf["chunks"].pop(0)
            tok = self._prefill_chunk(dev, inf["tokens"], inf["slot"], inf["pos"], lc,
                                      inf["sid"])
            inf["pos"] += lc
            issued += 1
            self.stats["prefill_chunks"][lb] = self.stats["prefill_chunks"].get(lb, 0) + 1
            self.stats["prefill_positions"] += lc
            if inf["chunks"]:
                continue  # the prompt's next chunk on a later tick
            s, sid = inf["slot"], inf["sid"]
            self._inflight = None
            self._slot_sid[s] = sid
            self._host_len[s] = inf["true_len"]
            self._host_gen[s] = 1  # the prefill's token was draw n = 0
            self.stats["admits"] += 1
            finished += 1
            if self._sync_free:
                self._stash.append((tok, (sid, s)))
                self._bookkeep(s)
            else:
                t = int(self._gather(tok)[s // self._local, 0])  # the EOS check: sync here
                self._last_tok[s] = t
                self._emit(s, t)
        return finished

    def _emit(self, s: int, tok: int) -> None:
        sid = self._slot_sid[s]
        self._results[sid].append(tok)
        self._budget[sid] -= 1
        eos = self.eos_token_id is not None and tok == self.eos_token_id
        if eos or self._budget[sid] <= 0:
            self._done.add(sid)
            self._slot_sid[s] = None

    def _bookkeep(self, s: int, n: int = 1) -> None:
        """Count-based finish on the sync-free path (the values are still on
        the device)."""
        sid = self._slot_sid[s]
        self._budget[sid] -= n
        if self._budget[sid] <= 0:
            self._done.add(sid)
            self._slot_sid[s] = None

    def _drain_stash(self) -> None:
        """Every stashed token to the host in ONE copy, then delivered."""
        if not self._stash:
            return
        self._ticks_since_drain = 0
        entries, self._stash = self._stash, []
        ranks = self._gather(torch.cat([e[0].reshape(-1) for e in entries]))
        off = 0
        for arr, m in entries:
            n = arr.numel()
            if isinstance(m, tuple):  # an admission's token, on the rank of its slot
                sid, slot = m
                self._deliver(sid, int(ranks[slot // self._local, off]))
            else:  # a tick's (k, S) tokens, each rank's share; m maps slot -> sid
                k = n // self._local
                v = ranks[:, off:off + n].reshape(-1, k, self._local).transpose(1, 0, 2)
                v = v.reshape(k, self.slots)
                for r in range(k):
                    for s, sid in enumerate(m):
                        if sid is not None:
                            self._deliver(sid, int(v[r, s]))
            off += n

    def _gather(self, flat: torch.Tensor) -> np.ndarray:
        """Every rank's ``flat`` (1-D, the same length on every rank) over
        the mesh axis, as rows in rank order on the host; (1, L) in one
        process."""
        if self._group is None:
            return flat.cpu().numpy()[None]
        nccl = dist.get_backend(self._group) == "nccl"
        out = sharding.all_gather((flat if nccl else flat.cpu())[None], self._group)
        return out.cpu().numpy()

    def _deliver(self, sid: int, tok: int) -> None:
        """Append one drained token to its stream, finishing it at EOS; tokens
        decoded after a seen EOS (the lazy check's overshoot) are dropped, and
        the stream's slot is reclaimed unless a count-based finish already
        recycled it."""
        if sid in self._eos_trimmed or sid not in self._results:
            return
        self._results[sid].append(tok)
        if self.eos_token_id is not None and tok == self.eos_token_id:
            self._eos_trimmed.add(sid)
            self._done.add(sid)
            for s in range(self.slots):
                if self._slot_sid[s] == sid:
                    self._slot_sid[s] = None

    @torch.no_grad()
    def tick(self) -> bool:
        """Retire capacity-full slots, advance admissions by a bounded number
        of prefill chunks, then decode every occupied slot (k steps when the
        schedule allows). Returns False when idle."""
        # the capacity guard first (a full row cannot take another token: its
        # append would clamp onto the last row), so that admission can use
        # the freed slot in this same tick
        for s in range(self.slots):
            if self._slot_sid[s] is not None and self._host_len[s] >= self.capacity:
                self._done.add(self._slot_sid[s])
                self._slot_sid[s] = None
        admitted = self._advance_prefill(self.prefill_chunks_per_tick)
        progressed = admitted > 0 or self._inflight is not None
        # a prompt of exactly the capacity is admitted full: its prefill token
        # is its only output, and the guard above retires it next tick
        active_slots = [s for s in range(self.slots)
                        if self._slot_sid[s] is not None and self._host_len[s] < self.capacity]
        if not active_slots:
            return progressed
        k = self.decode_steps_per_tick
        if k > 1:
            room = min(min(self._budget[self._slot_sid[s]] for s in active_slots),
                       min(self.capacity - int(self._host_len[s]) for s in active_slots))
            if room < k:
                k = 1
        occupancy = tuple(self._slot_sid)
        if occupancy != self._occupancy:
            self._occupancy = occupancy
            active = np.zeros(self.slots, bool)
            active[active_slots] = True
            sids = np.asarray([sid if sid is not None else 0 for sid in self._slot_sid], np.int64)
            self._active_dev = self._upload(active[self._share])
            self._sids_dev = self._upload(sids[self._share])
            self._counts_dev = self._upload(self._host_gen[self._share].copy())
        toks = self._last_tok_dev if self._sync_free else self._upload(self._last_tok[self._share])
        seq = []
        for _ in range(k):
            toks = self._decode_step(toks)
            seq.append(toks)
        seq = torch.stack(seq)  # (k, S_local)
        self.stats["decode_dispatches"] += 1
        self.stats["decode_steps"] += k
        self.stats["decode_by_k"][k] = self.stats["decode_by_k"].get(k, 0) + 1
        if self._sync_free:
            # the tokens feed the next step and drain to the results in bulk
            self._last_tok_dev = toks
            self._stash.append((seq, [self._slot_sid[s] if s in active_slots else None
                                      for s in range(self.slots)]))
            for s in active_slots:
                self._host_len[s] += k
                self._host_gen[s] += k
                self._bookkeep(s, k)
            self._ticks_since_drain += 1
            if (len(self._stash) >= self._stash_limit
                    or (self.eos_token_id is not None
                        and self._ticks_since_drain >= self.eos_interval)):
                self._drain_stash()
        else:
            row = self._gather(seq[-1]).reshape(-1)  # every slot's token
            for s in active_slots:
                self._host_len[s] += 1
                self._host_gen[s] += 1
                self._last_tok[s] = row[s]
                self._emit(s, int(row[s]))
        return True

    def poll(self, sid: int) -> Tuple[List[int], bool]:
        """(tokens since the last poll, finished?). A finished request's
        bookkeeping is reclaimed on the poll that sees it; its id then keeps
        answering ([], True)."""
        if not 0 <= sid < self._next_sid:
            raise ValueError(f"unknown request {sid}")
        self._drain_stash()
        if sid not in self._results:
            return [], True
        out = self._results[sid]
        done = sid in self._done
        if done:
            self._results.pop(sid)
            self._budget.pop(sid, None)
            self._done.discard(sid)
            self._eos_trimmed.discard(sid)
        else:
            self._results[sid] = []
        return out, done

    def has_work(self) -> bool:
        """True iff ``tick()`` would make progress: a pending or partly
        prefilled request, or an occupied slot."""
        return (bool(self._pending) or self._inflight is not None
                or any(sid is not None for sid in self._slot_sid))

    def run_until_idle(self, max_ticks: int = 100_000) -> int:
        n = 0
        while n < max_ticks and self.tick():
            n += 1
        return n
