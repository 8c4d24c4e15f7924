"""``python -m streamformer_tpu_torch.train.run --distributed`` on two gloo
ranks, on the cv2-written videos ``tests/test_torch_train_run.py`` feeds the
one-process CLI: an epoch at data=2 equals the one-process epoch on the
global batch (batch 2 a rank, 4 in one process), and its checkpoint resumes
at model=2 (tensor parallel) as it resumes in one process.

The ranks (``tests/_torch_dist_worker.py``, case "cli") start once for the
module and run ``run.main`` as ``torchrun`` ranks would. SGD (momentum
0.9, decoupled decay, clip 1.0). The CLI computes in bf16 over fp32
masters (``--bf16`` is on, as in the JAX package's CLI, with no switch to
turn it off), and another batch split or a row-parallel product rounds
the bf16 products differently: the parameters are held within 1e-5, the
momenta (the gradients) within 2**-8 of their global norm (in fp32 the
same runs agree to 1e-6 of each leaf's largest momentum).
"""

import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

import _torch_dist_worker as worker
from streamformer_tpu_torch.train import checkpoint, run

ARGV = ["--metadata", None, "--device", "cpu", "--batch_size", "2", "--input_size", "32",
        "--num_frames", "4", "--hidden_size", "32", "--num_layers", "1", "--num_heads", "2",
        "--intermediate_size", "64", "--text_layers", "1", "--num_workers", "2", "--lr", "1e-3",
        "--warmup_steps", "1", "--clip_grad", "1.0", "--seed", "3", "--opt", "sgd"]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these tensors are tiny, and the 6-worker run
    oversubscribes the cores with each worker's default thread pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _write_video(path, n=12, h=48, w=64, seed=0):
    import cv2

    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10, (w, h))
    rng = np.random.default_rng(seed)
    for _ in range(n):
        vw.write(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    vw.release()


def _metadata(root):
    """A classification task (4 clips) and a grounding task (4 clips)."""
    vids = []
    for i in range(8):
        p = os.path.join(root, f"v{i}.avi")
        _write_video(p, seed=i)
        vids.append(p)
    cls = os.path.join(root, "cls.csv")
    with open(cls, "w") as f:
        for i, v in enumerate(vids[:4]):
            f.write(f"{v} {i % 2}\n")
    grd = os.path.join(root, "grd.json")
    with open(grd, "w") as f:
        json.dump([{"video": v, "start": 0.2, "end": 0.8, "duration": 1.2,
                    "sentence": f"a person does thing {i}"} for i, v in enumerate(vids[4:])], f)
    meta = {"datasets": {
        "Kinetics": {"train": {"data_path": cls, "num_frames": 4, "short_side_size": 48}},
        "TaskGrounding": {"train": {"data_path": grd, "num_frames": 4, "short_side_size": 48}},
    }}
    path = os.path.join(root, "meta.yaml")
    with open(path, "w") as f:
        json.dump(meta, f)  # JSON is YAML
    return path


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dist_cli"))
    argv = list(ARGV)
    argv[1] = _metadata(root)
    dirs = [os.path.join(root, "dp2"), os.path.join(root, "mp2")]
    torch.save({"argv": argv, "dirs": dirs, "port": worker.free_port()},
               os.path.join(root, "cli_inputs.pt"))
    worker.launch("cli", 2, root)
    return {"root": root, "argv": argv, "dirs": dirs}


@pytest.fixture
def hash_tokenizer(monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)


def _flat(out, epoch):
    return checkpoint._load_flat(os.path.join(out, f"checkpoint-{epoch}"))


def _close(got, want):
    assert set(got) == set(want)
    moments = [k for k in want if k.endswith("/momentum_buffer")]
    for k in want:
        if k not in moments:
            assert float((got[k].float() - want[k].float()).abs().max()) <= 1e-5, k
    err = sum(float((got[k] - want[k]).square().sum()) for k in moments) ** 0.5
    size = sum(float(want[k].square().sum()) for k in moments) ** 0.5
    assert err <= 2.0**-8 * size, (err, size)


def test_an_epoch_at_two_data_ranks_equals_one_process(case, hash_tokenizer):
    one = os.path.join(case["root"], "one")
    argv = list(case["argv"])
    argv[argv.index("--batch_size") + 1] = "4"  # the global batch of two ranks of 2
    run.main(argv + ["--output_dir", one, "--epochs", "1"])
    dp2 = case["dirs"][0]
    _close(_flat(dp2, 0), _flat(one, 0))
    with open(os.path.join(dp2, "log.txt")) as f:
        lines = [json.loads(line) for line in f]
    assert len(lines) == 1 and lines[0]["epoch"] == 0  # rank 0 alone logs
    with open(os.path.join(dp2, "args.json")) as f:
        assert json.load(f)["distributed"] is True
    assert sorted(d for d in os.listdir(dp2) if d.startswith("checkpoint")) == ["checkpoint-0"]


def test_the_checkpoint_resumes_tensor_parallel_as_in_one_process(case, hash_tokenizer):
    """The data=2 checkpoint of epoch 0, resumed for epoch 1 at model=2 and
    in one process: the same parameters and SGD momenta."""
    alone = os.path.join(case["root"], "alone")
    os.makedirs(alone)
    shutil.copytree(os.path.join(case["dirs"][0], "checkpoint-0"),
                    os.path.join(alone, "checkpoint-0"))
    run.main(case["argv"] + ["--output_dir", alone, "--epochs", "2"])
    got, want = _flat(case["dirs"][1], 1), _flat(alone, 1)
    assert int(got["meta/epoch"]) == 1 and int(got["meta/step"]) == int(want["meta/step"]) == 6
    _close(got, want)


def test_cli_refuses_a_mesh_larger_than_the_job(case, hash_tokenizer):
    with pytest.raises(ValueError, match="world size 1"):
        run.main(case["argv"] + ["--output_dir", os.path.join(case["root"], "x"), "--mp", "2"])


def test_init_distributed_asks_for_a_card_and_falls_back_to_nothing(monkeypatch):
    """``init_distributed`` defaults to NCCL on ``cuda:LOCAL_RANK``: without
    a card it raises rather than join over gloo on the CPU."""
    import torch.distributed as dist

    from streamformer_tpu_torch.parallel import mesh

    if torch.cuda.is_available():
        pytest.skip("a card is here: the default would join NCCL")
    for var, value in (("RANK", "0"), ("WORLD_SIZE", "1"), ("MASTER_ADDR", "localhost"),
                       ("MASTER_PORT", str(worker.free_port())), ("LOCAL_RANK", "0")):
        monkeypatch.setenv(var, value)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.init_distributed()
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="--num_processes"):
        mesh.init_distributed("localhost:1", device="cpu")
