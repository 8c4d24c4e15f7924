"""VideoQA stage-wise training and batch generation-eval CLI on PyTorch.

Port of the JAX package's ``downstream/videoqa_run.py`` (the reference's
``llava/train/train.py`` with ``scripts/train/stage{1,2,3}*.sh``; the eval
mode mirrors ``llava/eval/model_vqa.py``'s I/O), with the same flags, plus
``--device`` (``cuda`` unless named) and ``--bf16`` (bf16 compute over fp32
master weights for the tower and the LM; the JAX CLI trains fp32).

Data: LLaVA-format JSON, ``[{"video": path, "conversations": [{"from":
"human", "value": "<image>\\nQ..."}, {"from": "gpt", "value": "A..."}]}]``;
with ``--dpo``, ``{video, prompt, chosen, rejected}`` rows. Each row is one
step: its prompt tokens with the ``<image>`` placeholder, the answer tokens
as labels, the placeholder expanded into one vision token a frame by the
splice plan on the device.

Usage:
    python -m streamformer_tpu_torch.downstream.videoqa_run \\
        --data llava_video.json --video_root videos/ --stage 1 \\
        --model_path /ckpt/streamformer --lm_path /ckpt/qwen2

Batch generation-eval (question file -> answers JSONL in the reference
schema; generation through the continuous-batching ``DecodeEngine``):
    python -m streamformer_tpu_torch.downstream.videoqa_run \\
        --eval --data questions.json --answers_file answers.jsonl \\
        --ckpt output/videoqa --num_chunks 8 --chunk_idx 0

``train`` and ``run_eval`` take the rows and a ``load_video(path, mode)``
callable, so a caller can hand them clips from memory.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
import uuid

import numpy as np
import torch

IMAGE_PLACEHOLDER = "<image>"


def get_args(argv=None):
    p = argparse.ArgumentParser("StreamFormer VideoQA (PyTorch)")
    p.add_argument("--data", required=True, help="LLaVA-format JSON")
    p.add_argument("--video_root", default="")
    p.add_argument("--output_dir", default="output/videoqa")
    p.add_argument("--stage", type=int, default=1, choices=[1, 2, 3])
    p.add_argument("--dpo", action="store_true",
                   help="DPO preference training (reference train_dpo.py): --data rows are "
                   "{video, prompt, chosen, rejected}; the stage policy still controls "
                   "trainability and lrs")
    p.add_argument("--dpo_beta", type=float, default=0.1)
    p.add_argument("--dpo_alpha", type=float, default=1.0)
    p.add_argument("--dpo_gamma", type=float, default=1.0,
                   help="weight of the auxiliary SFT-CE term on chosen")
    p.add_argument("--eval", action="store_true",
                   help="batch generation-eval: --data is a question JSON/JSONL, answers "
                   "written as JSONL (reference llava/eval/model_vqa.py I/O)")
    p.add_argument("--answers_file", default=None,
                   help="eval output JSONL (default output_dir/answers.jsonl)")
    p.add_argument("--ckpt", default=None,
                   help="restore {tower, projector, lm} from a training checkpoint dir "
                   "before eval")
    p.add_argument("--max_new_tokens", type=int, default=64)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top_p", type=float, default=None)
    p.add_argument("--extra_prompt", default="")
    p.add_argument("--num_chunks", type=int, default=1,
                   help="shard the question list across jobs (reference get_chunk)")
    p.add_argument("--chunk_idx", type=int, default=0)
    p.add_argument("--engine_slots", type=int, default=8)
    p.add_argument("--model_path", default=None, help="HF backbone dir")
    p.add_argument("--lm_path", default=None,
                   help="HF Qwen2/Llama dir (safetensors) for the LM")
    p.add_argument("--tokenizer", default=None,
                   help="HF tokenizer dir; default = word-hash (smoke only)")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--num_frames", type=int, default=16)
    p.add_argument("--input_size", type=int, default=224)
    p.add_argument("--max_len", type=int, default=256)
    p.add_argument("--steps_per_epoch", type=int, default=0)
    p.add_argument("--eval_samples", type=int, default=2,
                   help="greedy-decode this many samples after training")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 compute over fp32 master weights (tower and LM)")
    # tiny-model overrides (smoke tests)
    p.add_argument("--hidden_size", type=int, default=768)
    p.add_argument("--num_layers", type=int, default=12)
    p.add_argument("--num_heads", type=int, default=12)
    p.add_argument("--intermediate_size", type=int, default=3072)
    p.add_argument("--lm_hidden", type=int, default=896)
    p.add_argument("--lm_layers", type=int, default=24)
    p.add_argument("--lm_heads", type=int, default=14)
    p.add_argument("--lm_kv_heads", type=int, default=2)
    p.add_argument("--lm_intermediate", type=int, default=4864)
    p.add_argument("--lm_vocab", type=int, default=151936)
    return p.parse_args(argv)


class _HashTok:
    """Deterministic word-hash tokenizer (smoke runs without a local HF
    tokenizer; real runs pass --tokenizer)."""

    def __init__(self, vocab):
        self.vocab = vocab
        self.eos_token_id = 2

    def encode(self, text):
        from streamformer_tpu_torch.utils.hash_tok import hash_word_id

        return [hash_word_id(w, self.vocab, reserved=3) for w in text.split()]


def split_chunks(lst, n, k):
    """Ceil-sized chunk k of n (reference llava/eval/model_vqa.py:23-31
    split_list/get_chunk): shards the question list across jobs."""
    size = math.ceil(len(lst) / n) if lst else 1
    return lst[k * size:(k + 1) * size]


def build_sample(row, tok, image_token_index):
    """conversations -> (input_ids with placeholder, labels on gpt turns)."""
    ids, labels = [], []
    for turn in row["conversations"]:
        text = turn["value"]
        if turn["from"] == "human":
            parts = text.split(IMAGE_PLACEHOLDER)
            for pi, part in enumerate(parts):
                t = tok.encode(part.strip()) if part.strip() else []
                ids += t
                labels += [-100] * len(t)
                if pi < len(parts) - 1:
                    ids.append(image_token_index)
                    labels.append(-100)
        else:
            t = tok.encode(text.strip()) + [tok.eos_token_id]
            ids += t
            labels += t
    return np.asarray(ids, np.int64), np.asarray(labels, np.int64)


def load_rows(path):
    """A JSON array or JSONL file of rows."""
    with open(path) as f:
        head = f.read(64)
        f.seek(0)
        # pretty-printed JSON arrays open with whitespace: still JSON, not JSONL
        if head.lstrip()[:1] == "[":
            return json.load(f)
        return [json.loads(ln) for ln in f if ln.strip()]


def make_video_loader(args, device):
    """``load_video(path, mode)`` -> (1, T, C, H, W) float32 on ``device``:
    cv2 decode, TSN sparse sampling, resize to ``input_size`` and
    normalize(0.5)."""
    from streamformer_tpu_torch.data import transforms as T
    from streamformer_tpu_torch.data import video_io

    def load_video(path, mode="train"):
        vr = video_io.VideoReader(os.path.join(args.video_root, path))
        idx = video_io.sparse_sample_indices(len(vr), args.num_frames, mode)
        frames = vr.get_batch(idx)
        vr.close()
        x = T.resize(torch.as_tensor(frames, device=device), (args.input_size, args.input_size))
        return T.to_model_input(T.normalize(x))[None]

    return load_video


def load_tokenizer(args, vocab):
    if args.tokenizer:
        from transformers import AutoTokenizer

        return AutoTokenizer.from_pretrained(args.tokenizer, local_files_only=True)
    return _HashTok(vocab)


def build_model(args, device=None, serving: bool = False):
    """The ``VideoQAModel``: the tower (``--model_path`` or seeded, streaming
    over ``num_frames`` of context when it serves), the projector (seeded)
    and the LM (``--lm_path`` or seeded), on ``device`` (``cuda`` unless
    named). The tower and the LM hold fp32 masters that train, or with
    ``serving`` the serving modules' weights in the compute dtype, which
    fp32 weights (a training checkpoint's) are cast to once, as they load."""
    from streamformer_tpu_torch.checkpoint import hf_import
    from streamformer_tpu_torch.config import StreamformerConfig
    from streamformer_tpu_torch.downstream import videoqa as VQ
    from streamformer_tpu_torch.models import encoder
    from streamformer_tpu_torch.models import language_model as LM

    dev = encoder.resolve_device(device if device is not None else args.device)
    dtype = "bfloat16" if args.bf16 else "float32"
    cfg = StreamformerConfig(
        num_frames=args.num_frames, image_size=args.input_size, hidden_size=args.hidden_size,
        num_hidden_layers=args.num_layers, num_attention_heads=args.num_heads,
        intermediate_size=args.intermediate_size, dtype=dtype, streaming_mode=True,
        context_length=args.num_frames)
    tower = encoder.StreamformerEncoder(cfg, device=dev, trainable=not serving,
                                        generator=torch.Generator().manual_seed(args.seed))
    if args.model_path:
        # fp32 weights, so that masters keep every bit of the checkpoint
        loaded = hf_import.from_pretrained(args.model_path, cfg.replace(dtype="float32"),
                                           device=dev)
        tower.load_state_dict(loaded.state_dict())
        del loaded
    lm_cfg = LM.LMConfig(
        vocab_size=args.lm_vocab, hidden_size=args.lm_hidden,
        intermediate_size=args.lm_intermediate, num_hidden_layers=args.lm_layers,
        num_attention_heads=args.lm_heads, num_key_value_heads=args.lm_kv_heads,
        tie_word_embeddings=True, dtype=dtype)
    lm = LM.LanguageModel(lm_cfg, device=dev, trainable=not serving,
                          generator=torch.Generator(device=dev).manual_seed(args.seed + 1))
    if args.lm_path:
        sd = {}
        for fn in sorted(os.listdir(args.lm_path)):
            if fn.endswith(".safetensors"):
                sd.update(hf_import.load_checkpoint_file(os.path.join(args.lm_path, fn)))
        lm.load_state_dict(LM.convert_hf_state_dict(sd, lm_cfg))
    proj = VQ.init_mm_projector(cfg.hidden_size, lm_cfg.hidden_size, device=dev,
                                generator=torch.Generator(device=dev).manual_seed(args.seed + 2))
    return VQ.VideoQAModel(tower, proj, lm)


def _turns(row):
    """A row's conversation; a DPO row's is its prompt."""
    return row.get("conversations") or [{"from": "human", "value": row["prompt"]}]


def train(args, rows, load_video, model, tok):
    """Train ``model`` (a ``VideoQAModel``) on ``rows``, one row a step in the
    order of ``default_rng(seed + epoch).permutation``; after each epoch a
    line of ``log.txt`` and ``checkpoint-<epoch>``. Returns the per-epoch
    stats."""
    from streamformer_tpu_torch.downstream import videoqa as VQ
    from streamformer_tpu_torch.train import checkpoint as ckpt_lib
    from streamformer_tpu_torch.train import metrics as metrics_lib

    os.makedirs(args.output_dir, exist_ok=True)
    dev = model.device
    if args.dpo:
        ref = VQ.reference_copy(model)
        opt, step = VQ.make_videoqa_dpo_step(model, ref, stage=args.stage, beta=args.dpo_beta,
                                             dpo_alpha=args.dpo_alpha, gamma=args.dpo_gamma)
    else:
        opt, step = VQ.make_videoqa_train_step(model, args.stage)

    def batch_of(conv):
        ids, labels = build_sample({"conversations": conv}, tok, VQ.IMAGE_TOKEN_INDEX)
        return VQ.make_batch(ids, labels, args.num_frames, args.max_len, device=dev)

    history = []
    for epoch in range(args.epochs):
        t0 = time.time()
        losses, reward_accs = [], []
        order = np.random.default_rng(args.seed + epoch).permutation(len(rows))
        for si, ri in enumerate(order):
            row = rows[int(ri)]
            px = load_video(row["video"])
            if args.dpo:
                human = {"from": "human", "value": row["prompt"]}
                batch = {"pixel_values": px,
                         "chosen": batch_of([human, {"from": "gpt", "value": row["chosen"]}]),
                         "rejected": batch_of([human, {"from": "gpt", "value": row["rejected"]}])}
                loss, m = step(batch)
                reward_accs.append(float(m["reward_accuracy"]))
            else:
                batch = batch_of(row["conversations"])
                batch["pixel_values"] = px
                loss = step(batch)
            losses.append(float(loss))
            if args.steps_per_epoch and si + 1 >= args.steps_per_epoch:
                break
        stats = {"epoch": epoch, "stage": args.stage, "loss": float(np.mean(losses)),
                 "epoch_time": time.time() - t0}
        if args.dpo and reward_accs:
            stats["dpo"] = True
            stats["reward_accuracy"] = float(np.mean(reward_accs))
        print(json.dumps(stats))
        metrics_lib.write_log_line(args.output_dir, stats)
        ckpt_lib.save_checkpoint(args.output_dir, epoch, model, opt)
        history.append(stats)
    return history


@torch.no_grad()
def run_eval(args, model, tok, rows, load_video):
    """Batch generation-eval (reference llava/eval/model_vqa.py eval_model,
    :86-221): question rows -> answers JSONL in the reference schema
    (dataset, sample_id, prompt, pred_response, gt_response, shortuuid,
    model_id, question_type), so the official scorers read it unchanged. Up
    to ``--engine_slots`` questions share each decode step of the
    ``DecodeEngine``; the tower streams each question's frames on a fresh
    linear cache. A later human turn of a row re-opens on [the earlier
    prompt, the generated answer, the new turn] (reference model_vqa.py:
    165-218), the video encoded once. Returns the answers file's path."""
    from streamformer_tpu_torch.downstream import videoqa as VQ
    from streamformer_tpu_torch.downstream.vision_tower import TimesformerVisionTower
    from streamformer_tpu_torch.lm_serving import DecodeEngine
    from streamformer_tpu_torch.models import language_model as LM

    model.requires_grad_(False)
    rows = split_chunks(rows, args.num_chunks, args.chunk_idx)
    answers_file = args.answers_file or os.path.join(args.output_dir, "answers.jsonl")
    os.makedirs(os.path.dirname(answers_file) or ".", exist_ok=True)
    tower = TimesformerVisionTower(model.tower)
    vqa = VQ.LlavaQwenModel(tower=tower, lm=model.lm, projector=model.projector)

    def question_of(row, turn):
        """Prompt text and ids of the human turn at conversation index 2 *
        turn; only the first turn carries the placeholder."""
        qs = row["conversations"][2 * turn]["value"]
        if args.extra_prompt:
            qs = args.extra_prompt + qs
        if turn == 0 and IMAGE_PLACEHOLDER not in qs:
            qs = IMAGE_PLACEHOLDER + "\n" + qs  # reference DEFAULT_IMAGE_TOKEN
        if turn > 0:
            qs = qs.replace(IMAGE_PLACEHOLDER, "").strip()
        ids, _ = build_sample({"conversations": [{"from": "human", "value": qs}]}, tok,
                              VQ.IMAGE_TOKEN_INDEX)
        return qs, ids

    def n_turns(row):
        return max(1, (len(row.get("conversations", [])) + 1) // 2)

    staged = []
    max_prompt = 1
    for i, row in enumerate(rows):
        qs, ids = question_of(row, 0)
        n_ph = int((ids == VQ.IMAGE_TOKEN_INDEX).sum())
        # spliced length: a placeholder expands to T frame tokens; a
        # multi-turn row accumulates every turn's prompt and answer
        total = len(ids) - n_ph + n_ph * args.num_frames
        for t in range(1, n_turns(row)):
            total += args.max_new_tokens + len(question_of(row, t)[1])
        max_prompt = max(max_prompt, total)
        staged.append((i, row, qs, ids))

    cap = max(64, -(-(max_prompt + args.max_new_tokens) // 64) * 64)
    eng = DecodeEngine(model.lm, slots=args.engine_slots, capacity=cap,
                       max_new_tokens=args.max_new_tokens,
                       eos_token_id=getattr(tok, "eos_token_id", None),
                       temperature=args.temperature, top_p=args.top_p, seed=args.seed)
    model_id = os.path.basename((args.ckpt or args.model_path or "streamformer").rstrip("/"))

    def text_embeds(ids):
        ids = np.asarray(ids, np.int64)
        safe = torch.from_numpy(np.where(ids == VQ.IMAGE_TOKEN_INDEX, 0, ids))
        return LM.embed_tokens(model.lm, safe).float()

    live = {}  # sid -> [row index, row, turn, prompt text, tokens, prompt embeds]
    qpos = written = 0
    with open(answers_file, "w") as out_f:
        while qpos < len(staged) or live:
            while qpos < len(staged) and len(live) < args.engine_slots:
                i, row, qs, ids = staged[qpos]
                qpos += 1
                tower.clear_cache()  # a fresh stream a question
                emb = vqa.prompt_embeds(ids, load_video(row["video"], mode="validation"))
                live[eng.open(emb)] = [i, row, 0, qs, [], emb]
            eng.tick()
            for sid in list(live):
                toks, done = eng.poll(sid)
                st = live[sid]
                st[4].extend(int(t) for t in toks)
                if not done:
                    continue
                del live[sid]
                i, row, turn, qs, acc, emb = st
                text = (tok.decode(acc, skip_special_tokens=True).strip()
                        if hasattr(tok, "decode") else "")
                meta = row.get("metadata") or {}
                conv = row.get("conversations", [])
                gt_idx = 2 * turn + 1
                out_f.write(json.dumps({
                    "dataset": meta.get("dataset"),
                    "sample_id": row.get("sample_id", i),
                    "prompt": qs,
                    "pred_response": text,
                    "pred_token_ids": acc,  # the hash tokenizer has no decode
                    "gt_response": conv[gt_idx]["value"] if len(conv) > gt_idx else None,
                    "shortuuid": uuid.uuid4().hex[:22],
                    "model_id": model_id,
                    "question_type": meta.get("question_type"),
                }) + "\n")
                out_f.flush()
                written += 1
                if turn + 1 < n_turns(row):
                    nqs, nids = question_of(row, turn + 1)
                    new_emb = torch.cat([emb, text_embeds(acc).to(emb.device),
                                         text_embeds(nids).to(emb.device)], dim=0)
                    live[eng.open(new_emb)] = [i, row, turn + 1, nqs, [], new_emb]
    print(json.dumps({"eval": True, "answers_file": answers_file, "num_questions": len(staged),
                      "num_answers": written}))
    return answers_file


@torch.no_grad()
def greedy_samples(args, model, tok, rows, load_video):
    """Greedy answers (16 tokens) to the first ``--eval_samples`` rows on the
    streaming tower (reference llava/eval video path)."""
    from streamformer_tpu_torch.downstream import videoqa as VQ
    from streamformer_tpu_torch.downstream.vision_tower import TimesformerVisionTower

    tower = TimesformerVisionTower(model.tower)
    vqa = VQ.LlavaQwenModel(tower=tower, lm=model.lm, projector=model.projector)
    answers = []
    for row in rows[:args.eval_samples]:
        ids, _ = build_sample({"conversations": _turns(row)}, tok, VQ.IMAGE_TOKEN_INDEX)
        tower.clear_cache()
        ans = vqa.generate(ids, load_video(row["video"]), max_new_tokens=16,
                           eos_token_id=tok.eos_token_id)
        answers.append(ans[0].tolist())
        print(json.dumps({"video": row["video"], "answer_token_ids": answers[-1]}))
    return answers


def main(argv=None):
    args = get_args(argv)
    from streamformer_tpu_torch.train import checkpoint as ckpt_lib

    os.makedirs(args.output_dir, exist_ok=True)
    model = build_model(args, serving=args.eval)
    tok = load_tokenizer(args, args.lm_vocab)
    rows = load_rows(args.data)
    load_video = make_video_loader(args, model.device)
    if args.eval:
        if args.ckpt and ckpt_lib.auto_resume(args.ckpt, model) is None:
            raise SystemExit(f"no checkpoint-* under {args.ckpt}")
        run_eval(args, model, tok, rows, load_video)
        return
    train(args, rows, load_video, model, tok)
    if args.eval_samples:
        greedy_samples(args, model, tok, rows, load_video)


if __name__ == "__main__":
    main()
