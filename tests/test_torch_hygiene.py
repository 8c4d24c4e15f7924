"""The PyTorch port stands alone: no file of ``streamformer_tpu_torch/`` nor
``chip_smoke.py`` imports JAX, a library built on it (optax, orbax, flax) or
the JAX package (``streamformer_tpu`` and its submodules;
``streamformer_tpu_torch`` is the port itself)."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "streamformer_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "optax", "orbax", "flax", "streamformer_tpu")
# the subprocesses run on one intra-op thread: their tensors are tiny, and the
# 6-worker run oversubscribes the cores with each process's default thread pool
ONE_THREAD = dict(os.environ, OMP_NUM_THREADS="1")


def _forbidden(module: str) -> bool:
    return any(module == name or module.startswith(name + ".") for name in FORBIDDEN)


def _imports(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_the_matcher_tells_the_packages_apart():
    assert _forbidden("jax.numpy") and _forbidden("streamformer_tpu.models")
    assert _forbidden("streamformer_tpu") and _forbidden("optax") and _forbidden("orbax.checkpoint")
    assert not _forbidden("streamformer_tpu_torch.ops") and not _forbidden("jaxtyping")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imports(tree) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_runs_with_jax_unimportable():
    """Import every module of the port and run a CPU step, an int8 one
    (int8 weights, int8 cache), the OAD extractor and the vision tower, with
    ``jax`` and ``streamformer_tpu`` blocked from import."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = sys.modules['streamformer_tpu'] = None\n"
        "import torch\n"
        "import streamformer_tpu_torch.checkpoint, streamformer_tpu_torch.ops.build\n"
        "import streamformer_tpu_torch.serving, streamformer_tpu_torch.server\n"
        "from streamformer_tpu_torch.extract import oad\n"
        "from streamformer_tpu_torch.downstream.vision_tower import TimesformerVisionTower\n"
        "from streamformer_tpu_torch.ops import quant\n"
        "from streamformer_tpu_torch.config import StreamformerConfig\n"
        "from streamformer_tpu_torch.models.encoder import StreamformerEncoder\n"
        "cfg = StreamformerConfig(image_size=32, num_frames=2, hidden_size=32, num_hidden_layers=1,"
        " num_attention_heads=2, intermediate_size=64, dtype='float32')\n"
        "m = StreamformerEncoder(cfg, device='cpu')\n"
        "out, cache = m.stream(torch.zeros(1, 1, 3, 32, 32), m.init_cache(1, capacity=2))\n"
        "assert out['pooler_output'].shape == (1, 1, 32)\n"
        "q = quant.quantize_encoder(StreamformerEncoder(cfg.replace(cache_dtype='int8'), device='cpu'),"
        " min_elements=0)\n"
        "cache = q.init_cache(1, capacity=2)\n"
        "out, cache = q.stream(torch.zeros(1, 1, 3, 32, 32), cache)\n"
        "assert cache['layers'][0]['k'].dtype == torch.int8 and int(cache['len']) == 1\n"
        "assert torch.isfinite(out['pooler_output']).all()\n"
        "import numpy as np\n"
        "frames = np.zeros((3, 40, 50, 3), np.uint8)\n"
        "px = oad.preprocess_frames(frames, 32, device='cpu')\n"
        "assert oad.extract_features_streaming(m, px, chunk=2, capacity=2).shape == (3, 32)\n"
        "tower = TimesformerVisionTower(m, streaming_mode=True)\n"
        "assert tower(px[None, :2]).shape == (1, 2, 4, 32)\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=ONE_THREAD, check=True,
                   timeout=120)


def test_training_path_runs_without_jax_optax_or_transformers():
    """Two trainer micro-steps and an optimizer update on the CPU with
    ``jax``, ``optax``, ``transformers`` and ``tensorboardX`` blocked from
    import: the training path needs none of them (the hash tokenizer stands
    in behind its environment variable)."""
    code = (
        "import os, sys\n"
        "for name in ('jax', 'optax', 'orbax', 'transformers', 'tensorboardX', 'streamformer_tpu'):\n"
        "    sys.modules[name] = None\n"
        "os.environ['STREAMFORMER_ALLOW_HASH_TOKENIZER'] = '1'\n"
        "import torch\n"
        "from streamformer_tpu_torch.config import StreamformerConfig\n"
        "from streamformer_tpu_torch.models.multitask import MultitaskModel\n"
        "from streamformer_tpu_torch.models.text_encoder import SiglipTextConfig\n"
        "from streamformer_tpu_torch.train import metrics, optim\n"
        "from streamformer_tpu_torch.train.trainer import MultitaskTrainer, TrainState\n"
        "cfg = StreamformerConfig(image_size=32, num_frames=2, hidden_size=32, num_hidden_layers=1,"
        " num_attention_heads=2, intermediate_size=64, dtype='float32')\n"
        "text = SiglipTextConfig(vocab_size=64, hidden_size=32, num_hidden_layers=1,"
        " num_attention_heads=2, intermediate_size=64, max_position_embeddings=8)\n"
        "model = MultitaskModel(cfg, {'Kinetics': {'label2id': {'run': 0, 'jump': 1}}}, text,"
        " device='cpu')\n"
        "model.prepare_for_multi_tasks()\n"
        "tx = optim.create_optimizer(model, optim.cosine_lr_schedule(1e-3, 1e-5, 1, 2),"
        " clip_grad=1.0, layer_decay=0.75, num_layers=1)\n"
        "trainer = MultitaskTrainer(model, tx, update_freq=2)\n"
        "batch = {'pixel_values': torch.randn(2, 2, 3, 32, 32), 'task_input': {"
        "'label_embeddings': model.label_embeddings['Kinetics'], 'label': torch.tensor([0, 1])}}\n"
        "state, stats = trainer.train_one_epoch(TrainState.create(model, tx),"
        " iter([('Kinetics', batch)] * 2), 0, torch.Generator().manual_seed(0))\n"
        "assert state.step == 1 and stats['loss'] > 0\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=ONE_THREAD, check=True,
                   timeout=120)


def test_data_path_imports_without_decoders_or_parsers():
    """Every module of the data path and the training entry point imports
    with ``cv2``, ``yaml``, ``pandas`` and ``tensorboardX`` blocked (they are
    imported where a file is decoded or parsed, or a writer made), as well
    as JAX and the JAX package; a batch is then augmented on the CPU."""
    code = (
        "import sys\n"
        "for name in ('jax', 'optax', 'orbax', 'streamformer_tpu', 'cv2', 'yaml', 'pandas',"
        " 'tensorboardX'):\n"
        "    sys.modules[name] = None\n"
        "import torch\n"
        "from streamformer_tpu_torch.data import (build, checker, collate, datasets, rand_augment,"
        " random_erasing, samplers, seg_datasets, transforms, video_io)\n"
        "from streamformer_tpu_torch.train import checkpoint, run\n"
        "from streamformer_tpu_torch.checkpoint import siglip_init\n"
        "clips = torch.randint(0, 256, (2, 2, 40, 48, 3), dtype=torch.uint8)\n"
        "out = collate.make_train_augment(32)(clips, 0, 0, [3, 7])\n"
        "assert out.shape == (2, 2, 3, 32, 32) and torch.isfinite(out).all()\n"
        "assert run.get_args(['--metadata', 'm.yaml', '--device', 'cpu']).device == 'cpu'\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=ONE_THREAD, check=True,
                   timeout=120)


def test_downstream_training_runs_without_jax_optax_or_transformers():
    """The VideoQA and action-recognition CLIs' training functions, handed
    in-memory clips, with ``jax``, ``optax``, ``transformers``, ``cv2`` and
    ``tensorboardX`` blocked from import: a stage-1 epoch, a DPO epoch, the
    greedy samples and an AR epoch with mixup, the EMA and validation on the
    CPU."""
    code = (
        "import os, sys, tempfile\n"
        "for name in ('jax', 'optax', 'orbax', 'transformers', 'tensorboardX', 'cv2',"
        " 'streamformer_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import numpy as np, torch\n"
        "from streamformer_tpu_torch.downstream import ar_run, videoqa_run\n"
        "out = tempfile.mkdtemp()\n"
        "tiny = ['--hidden_size', '32', '--num_layers', '1', '--num_heads', '4',"
        " '--intermediate_size', '64', '--input_size', '32', '--num_frames', '2',"
        " '--device', 'cpu']\n"
        "lm = ['--lm_hidden', '32', '--lm_layers', '1', '--lm_heads', '4', '--lm_kv_heads', '2',"
        " '--lm_intermediate', '64', '--lm_vocab', '64', '--max_len', '16']\n"
        "clip = lambda path, mode='train': torch.zeros(1, 2, 3, 32, 32)\n"
        "sft = [{'video': 'a', 'conversations': [{'from': 'human', 'value': '<image> what'},"
        " {'from': 'gpt', 'value': 'this'}]}]\n"
        "dpo = [{'video': 'a', 'prompt': '<image> what', 'chosen': 'a', 'rejected': 'b'}]\n"
        "for rows, extra in ((sft, ['--stage', '1']), (dpo, ['--stage', '3', '--dpo'])):\n"
        "    args = videoqa_run.get_args(['--data', 'x', '--output_dir', out] + extra + tiny + lm)\n"
        "    model = videoqa_run.build_model(args)\n"
        "    tok = videoqa_run.load_tokenizer(args, args.lm_vocab)\n"
        "    hist = videoqa_run.train(args, rows, clip, model, tok)\n"
        "    assert np.isfinite(hist[0]['loss'])\n"
        "assert len(videoqa_run.greedy_samples(args, model, tok, rows, clip)) == 1\n"
        "class Clips:\n"
        "    def __len__(self):\n"
        "        return 4\n"
        "    def __getitem__(self, i):\n"
        "        return {'task_input': {'frames': np.full((2, 40, 40, 3), 50 * i, np.uint8),"
        " 'label': i % 2}}\n"
        "args = ar_run.get_args(['--anno_train', 'x', '--num_classes', '2', '--batch_size', '2',"
        " '--epochs', '1', '--model_ema', '--num_workers', '1', '--output_dir', out] + tiny)\n"
        "res = ar_run.train(args, Clips(), Clips())\n"
        "assert np.isfinite(res['history'][0]['loss']) and 'top1_ema' in res['history'][0]\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=ONE_THREAD, check=True,
                   timeout=120)


def test_oad_and_ovis_train_without_jax_optax_or_cv2():
    """The OAD and OVIS CLIs' training functions on the CPU with ``jax``,
    ``optax``, ``cv2`` and ``tensorboardX`` blocked from import: an OAD
    epoch of one step on feature dumps written here, and one OVIS step on
    an in-memory clip."""
    code = (
        "import os, sys, tempfile\n"
        "for name in ('jax', 'optax', 'orbax', 'tensorboardX', 'cv2', 'streamformer_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import numpy as np\n"
        "from streamformer_tpu_torch.downstream import oad_run, ovis_run\n"
        "root = tempfile.mkdtemp()\n"
        "for sub in ('feat', 'tgt'):\n"
        "    os.makedirs(os.path.join(root, sub))\n"
        "rng = np.random.default_rng(0)\n"
        "np.save(os.path.join(root, 'feat', 'v.npy'), rng.standard_normal((24, 8)).astype(np.float32))\n"
        "np.save(os.path.join(root, 'tgt', 'v.npy'), np.eye(3, dtype=np.float32)[rng.integers(0, 3, 24)])\n"
        "open(os.path.join(root, 'list.txt'), 'w').write('v\\n')\n"
        "args = oad_run.get_args(['--feature_root', os.path.join(root, 'feat'), '--target_root',"
        " os.path.join(root, 'tgt'), '--train_list', os.path.join(root, 'list.txt'),"
        " '--num_classes', '3', '--feature_dim', '8', '--hidden', '16', '--long_memory_num_samples',"
        " '8', '--work_memory_num_samples', '4', '--batch_size', '4', '--epochs', '1',"
        " '--steps_per_epoch', '1', '--output_dir', os.path.join(root, 'oad'), '--device', 'cpu'])\n"
        "hist = oad_run.train(args, *oad_run.build_datasets(args, oad_run.config_of(args)))\n"
        "assert np.isfinite(hist[0]['loss'])\n"
        "args = ovis_run.get_args(['--anno', 'x', '--num_classes', '3', '--num_queries', '4',"
        " '--hidden_size', '32', '--num_layers', '1', '--num_heads', '4', '--intermediate_size',"
        " '64', '--input_size', '32', '--epochs', '1', '--output_dir', os.path.join(root, 'ovis'),"
        " '--device', 'cpu'])\n"
        "mt = np.full((2, 32, 32), -1); mt[:, 4:20, 4:20] = 0\n"
        "clip = {'frames': np.zeros((2, 32, 32, 3), np.uint8), 'mask_target': mt,"
        " 'selected_classes': np.array([2])}\n"
        "_, hist = ovis_run.train(args, [clip])\n"
        "assert np.isfinite(hist[0]['loss'])\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=ONE_THREAD, check=True,
                   timeout=120)
