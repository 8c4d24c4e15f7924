"""Multitask batch schedulers: the port's own copy of the JAX package's
``data/samplers.py`` (numpy only; nothing here touches a device).

A rebuild of the reference sampler.py (487 LoC): every batch is drawn from a
single task (the trainer asserts one task per step,
tools/finetune_tools.py:412). Full-video TAL tasks use the fake-batch trick
(one real index + batch_size-1 pad markers) so a batch holds exactly one
untrimmed video while epochs stay aligned via a weight factor of batch_size
(sampler.py:393-397,430-443).

Design difference from the reference: all ranks build the *same* global
schedule from the epoch seed with numpy RNG, then each rank takes its
rank-strided slice — semantically identical cross-rank behavior
(sampler.py:379-386) without torch generators.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

# tasks trained one full video per batch (untrimmed TAL) — sampler.py:392-397
FAKE_BATCH_TASKS = ("THUMOS14", "ActivityNet", "FineAction", "HACS")
PAD_INDEX = -1


@dataclasses.dataclass
class TaskSpec:
    name: str
    length: int
    offset: int  # global index offset within the concatenated dataset


def task_specs_from_lengths(
    names: Sequence[str], lengths: Sequence[int]
) -> List[TaskSpec]:
    specs, off = [], 0
    for n, l in zip(names, lengths):
        specs.append(TaskSpec(n, l, off))
        off += l
    return specs


class BatchTaskUniqueSampler:
    """Single-process: every batch from one task (reference sampler.py:9-53)."""

    def __init__(self, specs: List[TaskSpec], batch_size: int, shuffle: bool = True):
        self.specs = specs
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self) -> Iterator[List[int]]:
        inner = DistributedBatchTaskUniqueSampler(
            self.specs, self.batch_size, num_replicas=1, rank=0, shuffle=self.shuffle
        )
        inner.set_epoch(self.epoch)
        return iter(inner)

    def __len__(self):
        return len(
            DistributedBatchTaskUniqueSampler(
                self.specs, self.batch_size, num_replicas=1, rank=0
            )
        )


class DistributedBatchTaskUniqueSampler:
    """Default multitask scheduler (reference sampler.py:350-487).

    Tasks chosen per batch with probability proportional to remaining samples
    x weight factor; TAL tasks emit fake batches. Epoch-seeded; rank r takes
    stride-num_replicas slices so replicas see disjoint indices.
    """

    def __init__(
        self,
        specs: List[TaskSpec],
        batch_size: int,
        num_replicas: int = 1,
        rank: int = 0,
        shuffle: bool = True,
        fake_batch_tasks: Sequence[str] = FAKE_BATCH_TASKS,
        seed: int = 0,
    ):
        self.specs = {s.name: s for s in specs}
        self.batch_size = batch_size
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.fake_batch_tasks = set(fake_batch_tasks)
        self.epoch = 0
        # the default seed=0 reproduces the reference exactly (it seeds
        # with the epoch ALONE, sampler.py:87-88 — every --seed sees the
        # same data order); pass the run seed to decorrelate schedules
        # across multi-seed experiments
        self.seed = seed

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _rng(self) -> np.random.Generator:
        return np.random.default_rng(
            self.epoch if self.seed == 0 else (self.seed, self.epoch)
        )

    def _schedule(self) -> List[List[int]]:
        """Global schedule, identical on every rank; entries are per-rank
        batches for `self.rank`."""
        g = self._rng()
        perms: Dict[str, np.ndarray] = {}
        for name, s in self.specs.items():
            idx = np.arange(s.offset, s.offset + s.length)
            if self.shuffle:
                idx = idx[g.permutation(s.length)]
            perms[name] = idx

        cursor = {n: 0 for n in self.specs}
        available = [n for n, s in self.specs.items() if s.length > 0]
        weights = {
            n: (self.batch_size if n in self.fake_batch_tasks else 1)
            for n in self.specs
        }
        batches: List[List[int]] = []
        while available:
            w = np.array(
                [
                    weights[n] * (len(perms[n]) - cursor[n])
                    for n in available
                ],
                dtype=np.float64,
            )
            if w.sum() <= 0:
                break
            task = available[int(g.choice(len(available), p=w / w.sum()))]
            fake = task in self.fake_batch_tasks
            per_rank = 1 if fake else self.batch_size
            need = per_rank * self.num_replicas
            if cursor[task] + need > len(perms[task]):
                available.remove(task)
                continue
            chunk = perms[task][cursor[task] : cursor[task] + need]
            cursor[task] += need
            mine = chunk[self.rank :: self.num_replicas]
            if fake:
                batch = [int(mine[0])] + [PAD_INDEX] * (self.batch_size - 1)
            else:
                batch = [int(i) for i in mine]
            batches.append(batch)
            if cursor[task] + need > len(perms[task]):
                available.remove(task)
        return batches

    def __iter__(self) -> Iterator[List[int]]:
        return iter(self._schedule())

    def __len__(self):
        return len(self._schedule())


class DistributedBatchTaskSequentialSampler(DistributedBatchTaskUniqueSampler):
    """Tasks consumed in fixed declaration order (reference sampler.py:56-176)."""

    def _schedule(self) -> List[List[int]]:
        g = self._rng()
        batches: List[List[int]] = []
        for name, s in self.specs.items():
            idx = np.arange(s.offset, s.offset + s.length)
            if self.shuffle:
                idx = idx[g.permutation(s.length)]
            fake = name in self.fake_batch_tasks
            per_rank = 1 if fake else self.batch_size
            need = per_rank * self.num_replicas
            for start in range(0, len(idx) - need + 1, need):
                chunk = idx[start : start + need]
                mine = chunk[self.rank :: self.num_replicas]
                if fake:
                    batches.append(
                        [int(mine[0])] + [PAD_INDEX] * (self.batch_size - 1)
                    )
                else:
                    batches.append([int(i) for i in mine])
        return batches


class DistributedBatchTaskBalancedSampler(DistributedBatchTaskUniqueSampler):
    """Size-scaled round-robin interleave (reference sampler.py:179-347):
    every round emits ``scale_factor`` consecutive batches per task
    (scale = task_size / smallest task), so ONE ROUND — ``accum_steps``
    batches, not an arbitrary window — sees every task. The reference
    pairs this with ``update_freq = accum_steps`` ("the accumulation step
    is 176/16 = 11" in its docstring); read :attr:`accum_steps` after
    construction to configure the trainer the same way."""

    @property
    def accum_steps(self) -> int:
        """Batches per balanced round = the accumulation window the
        schedule is balanced over (sum of per-task scale factors)."""
        lens = {n: s.length for n, s in self.specs.items()}
        per = {
            n: (1 if n in self.fake_batch_tasks else self.batch_size)
            * self.num_replicas
            for n in lens
        }
        counts = {n: lens[n] // per[n] for n in lens if lens[n] >= per[n]}
        if not counts:
            return 1
        m = min(counts.values())
        return sum(max(1, round(c / m)) for c in counts.values())

    def _schedule(self) -> List[List[int]]:
        g = self._rng()
        per_task: Dict[str, List[List[int]]] = {}
        for name, s in self.specs.items():
            idx = np.arange(s.offset, s.offset + s.length)
            if self.shuffle:
                idx = idx[g.permutation(s.length)]
            fake = name in self.fake_batch_tasks
            per_rank = 1 if fake else self.batch_size
            need = per_rank * self.num_replicas
            bl = []
            for start in range(0, len(idx) - need + 1, need):
                chunk = idx[start : start + need]
                mine = chunk[self.rank :: self.num_replicas]
                if fake:
                    bl.append([int(mine[0])] + [PAD_INDEX] * (self.batch_size - 1))
                else:
                    bl.append([int(i) for i in mine])
            if bl:
                per_task[name] = bl

        if not per_task:
            return []
        # interleave: each accumulation window draws tasks round-robin scaled
        # by task size (reference rearrangement, sampler.py:302-337)
        min_len = min(len(b) for b in per_task.values())
        ratios = {n: max(1, round(len(b) / min_len)) for n, b in per_task.items()}
        cursors = {n: 0 for n in per_task}
        out: List[List[int]] = []
        exhausted = set()
        while len(exhausted) < len(per_task):
            for n, bl in per_task.items():
                if n in exhausted:
                    continue
                take = min(ratios[n], len(bl) - cursors[n])
                out.extend(bl[cursors[n] : cursors[n] + take])
                cursors[n] += take
                if cursors[n] >= len(bl):
                    exhausted.add(n)
        return out
