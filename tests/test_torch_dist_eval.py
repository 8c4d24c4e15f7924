"""``train/run.py --distributed --mp 2 --eval_freq 1`` on two gloo ranks:
every rank runs the sharded model's eval forward (its collectives need
them all), so the run completes without a hang; rank 0 alone logs the
``eval_<task>_<metric>`` lines, and the training lines equal those of the
same two-rank run without ``--eval_freq`` bit for bit. The data are
in-memory clips of a classification, a retrieval and a grounding task."""

import json
import os
import socket
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RANK = r'''
import sys
import numpy as np
sys.modules["transformers"] = None  # the hash tokenizer, without a slow lookup
from streamformer_tpu_torch.data.datasets import MultiTaskDataset
from streamformer_tpu_torch.train import run

rank, out, ports = int(sys.argv[1]), sys.argv[2], sys.argv[3:5]


class Task:
    def __init__(self, name, n, seed, extra):
        self.task_name, self.extra = name, extra
        self.frames = np.random.default_rng(seed).integers(0, 256, (n, 4, 40, 40, 3), np.uint8)

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, i):
        return {"task_name": self.task_name,
                "task_input": {"frames": self.frames[i], **self.extra(i)}}


def grounding(i):
    return {"caption": f"a person does thing {i}",
            "label": (np.arange(4) >= i % 3).astype(np.float32),
            "meta": {"times": np.arange(4) * 0.5, "gt": (0.5 * (i % 3), 1.5)}}


train = MultiTaskDataset([Task("Kinetics", 4, 1, lambda i: {"label": np.int64(i % 2)}),
                          Task("CharadesSTA", 4, 2, grounding)])
evals = MultiTaskDataset([Task("Kinetics", 3, 3, lambda i: {"label": np.int64(i % 2)}),
                          Task("TaskRetrieval", 3, 4, lambda i: {"caption": f"clip {i} of three"}),
                          Task("CharadesSTA", 3, 5, grounding)])
mtc = {"Kinetics": {"label2id": {"a": 0, "b": 1}}, "CharadesSTA": {"label2id": None}}
run.build_datasets = lambda args: (train, evals, mtc)
for name, port, extra in (("eval", ports[0], ["--eval_freq", "1"]), ("plain", ports[1], [])):
    run.main(["--metadata", "(in memory)", "--output_dir", f"{out}/{name}", "--device", "cpu",
              "--epochs", "2", "--batch_size", "2", "--input_size", "32", "--num_frames", "4",
              "--hidden_size", "32", "--num_layers", "1", "--num_heads", "2",
              "--intermediate_size", "64", "--text_layers", "1", "--num_workers", "2",
              "--lr", "1e-3", "--warmup_steps", "1", "--seed", "3", "--mp", "2",
              "--distributed", "--coordinator_address", f"localhost:{port}",
              "--num_processes", "2", "--process_id", str(rank), *extra])
'''


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return str(s.getsockname()[1])


def test_two_rank_tensor_parallel_run_validates_without_a_hang(tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", PYTHONPATH=ROOT,
               STREAMFORMER_ALLOW_HASH_TOKENIZER="1")
    ports = [_free_port(), _free_port()]
    procs = [subprocess.Popen([sys.executable, "-c", RANK, str(r), str(tmp_path), *ports], env=env,
                              cwd=str(tmp_path), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(f"--- rank {r}\n{log[-3000:]}"
                                                         for r, log in enumerate(logs))
    assert "epoch 1 eval:" in logs[0] and "eval:" not in logs[1]
    lines = {}
    for name in ("eval", "plain"):
        with open(tmp_path / name / "log.txt") as f:
            lines[name] = [json.loads(line) for line in f]
    evals = [r for r in lines["eval"] if "eval_Kinetics_top1" in r]
    assert [r["epoch"] for r in evals] == [0, 1]
    assert all(np.isfinite(r["eval_TaskRetrieval_v2t_R@1"])
               and np.isfinite(r["eval_CharadesSTA_mIoU"]) for r in evals)
    trained = [r for r in lines["eval"] if "loss" in r]
    assert len(trained) == len(lines["plain"]) == 2
    for a, b in zip(trained, lines["plain"]):
        assert {k: v for k, v in a.items() if k != "epoch_time"} == \
            {k: v for k, v in b.items() if k != "epoch_time"}
