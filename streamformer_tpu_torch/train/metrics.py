"""Logging and metering for the trainer: the port's own copy of the JAX
package's ``train/metrics.py`` (nothing here touches a device).

The values logged are already global: over many processes the trainer
hands over the data group's mean loss, and only rank 0 prints
(``MetricLogger(quiet=True)`` elsewhere) and writes ``log.txt``.
``TensorboardLogger`` stays optional: ``tensorboardX`` is imported when one
is made, not with this module.
"""

from __future__ import annotations

import datetime
import json
import os
import time
from collections import defaultdict, deque
from typing import Dict, Optional


class SmoothedValue:
    """Windowed median/avg meter."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self):
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self):
        return sum(self.deque) / max(len(self.deque), 1)

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def max(self):
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(
            median=self.median,
            avg=self.avg,
            global_avg=self.global_avg,
            max=self.max,
            value=self.value,
        )


class MetricLogger:
    """Iteration logger with ETA."""

    def __init__(self, delimiter: str = "  ", quiet: bool = False):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter
        self.quiet = quiet  # count and time, print nothing (a process other than rank 0)

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self):
        return self.delimiter.join(f"{k}: {m}" for k, m in self.meters.items())

    def log_every(self, iterable, print_freq: int, header: str = ""):
        i = 0
        start = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        total = len(iterable) if hasattr(iterable, "__len__") else None
        end = time.time()
        for obj in iterable:
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0 and not self.quiet:
                if total:
                    eta = iter_time.global_avg * (total - i)
                    eta_str = str(datetime.timedelta(seconds=int(eta)))
                    print(
                        f"{header} [{i}/{total}] eta: {eta_str} {self} "
                        f"time: {iter_time}"
                    )
                else:
                    print(f"{header} [{i}] {self} time: {iter_time}")
            i += 1
            end = time.time()
        elapsed = str(datetime.timedelta(seconds=int(time.time() - start)))
        if not self.quiet:
            print(f"{header} Total time: {elapsed}")


class TensorboardLogger:
    """tensorboardX writer with loss/ and opt/ namespaces."""

    def __init__(self, log_dir: str):
        from tensorboardX import SummaryWriter

        os.makedirs(log_dir, exist_ok=True)
        self.writer = SummaryWriter(logdir=log_dir)
        self.step = 0

    def set_step(self, step: Optional[int] = None):
        self.step = step if step is not None else self.step + 1

    def update(self, head: str = "scalar", step: Optional[int] = None, **kwargs):
        for k, v in kwargs.items():
            if v is None:
                continue
            self.writer.add_scalar(
                f"{head}/{k}", float(v), self.step if step is None else step
            )

    def flush(self):
        self.writer.flush()


def write_log_line(output_dir: str, stats: Dict):
    """Append ``stats`` as one JSON line to ``output_dir/log.txt``; rank 0
    only once ``torch.distributed`` is initialised."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_rank() != 0:
        return
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "log.txt"), "a") as f:
        f.write(json.dumps(stats) + "\n")
