"""VideoQA (LLaVA-style) on PyTorch: the inference half.

Port of the JAX package's ``downstream/videoqa.py`` (the reference, itself a
rebuild of the reference LLaVA-NeXT fork's ``llava_arch.py``):

* the ``mlp2x_gelu`` projector (exact GELU), vision features into the LM's
  embedding space, in fp32 as the JAX package's fp32 tree computes it;
* the splice: each ``IMAGE_TOKEN_INDEX`` placeholder of a prompt expands
  into the block of projected vision tokens, with the attention mask and the
  labels (-100 over vision tokens); on the host
  (``splice_multimodal_inputs``) or as a gather plan
  (``build_splice_plan`` / ``apply_splice_plan``);
* ``LlavaStreamModel`` (a pluggable LM) and ``LlavaQwenModel`` (the port's
  ``LanguageModel``): the vision tower (``downstream.vision_tower``; a
  streaming tower keeps its temporal cache across calls), one token per
  frame (``frame_mean``), the projector, the splice and the LM;
* multiple-choice scoring by option log-likelihood (VideoMME-style);
* training: ``VideoQAModel`` holds the tower, the projector and the LM in
  one module (one optimizer, one checkpoint); ``stage_policy`` (the
  reference's three stages), ``make_videoqa_train_step`` (the LM loss over
  the spliced sequence) and ``make_videoqa_dpo_step`` (sigmoid DPO against a
  frozen reference copy, plus an SFT term on the chosen answer).

The optimizer is optax's ``multi_transform`` of the JAX package, number for
number: each trained part is clipped by its own global norm (1.0) and steps
AdamW at its stage's lr (b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4 on
every parameter); a frozen part takes no step and runs without grad (the
tower under ``torch.no_grad`` in stages 1-2; in stage 1 the gradient still
flows through the frozen LM into the projector).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from streamformer_tpu_torch.models import encoder
from streamformer_tpu_torch.models import language_model as LM
from streamformer_tpu_torch.train import optim

IMAGE_TOKEN_INDEX = -200  # the reference llava constant


class MMProjector(nn.Module):
    """The ``mlp2x_gelu`` projector: fc1 (vision -> LM width), exact GELU,
    fc2; fp32 weights."""

    def __init__(self, vision_dim: int, lm_dim: int, device=None):
        super().__init__()
        self.fc1 = nn.Linear(vision_dim, lm_dim, device=device)
        self.fc2 = nn.Linear(lm_dim, lm_dim, device=device)


@torch.no_grad()
def init_mm_projector(vision_dim: int, lm_dim: int, *, device=None,
                      generator: Optional[torch.Generator] = None) -> MMProjector:
    """The projector with the JAX package's initialisation (normal 0.02
    kernels, zero biases), drawn from ``generator``, on ``cuda`` unless
    ``device`` names another."""
    p = MMProjector(vision_dim, lm_dim, device=encoder.resolve_device(device))
    for fc in (p.fc1, p.fc2):
        fc.weight.normal_(0.0, 0.02, generator=generator)
        fc.bias.zero_()
    return p.requires_grad_(False)


def mm_projector(p: MMProjector, x: torch.Tensor) -> torch.Tensor:
    """(..., vision_dim) -> fp32 (..., lm_dim): products in fp32, the bias
    added after each, as the JAX package's ``x @ kernel + bias``."""
    y = F.linear(x.float(), p.fc1.weight) + p.fc1.bias
    y = F.gelu(y)
    return F.linear(y, p.fc2.weight) + p.fc2.bias


def splice_multimodal_inputs(input_ids: np.ndarray, text_embeds: np.ndarray,
                             image_features: np.ndarray, labels: Optional[np.ndarray] = None,
                             max_len: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Host-side splice (the reference's
    ``prepare_inputs_labels_for_multimodal``): each placeholder expands into
    the whole vision block, whose labels are -100; cut or padded to
    ``max_len``. Returns ``inputs_embeds``, ``attention_mask`` and, with
    labels, ``labels``."""
    img_pos = np.where(input_ids == IMAGE_TOKEN_INDEX)[0]
    pieces, label_pieces = [], []
    prev = 0
    for pos in img_pos:
        pieces.append(text_embeds[prev:pos])
        pieces.append(image_features)
        if labels is not None:
            label_pieces.append(labels[prev:pos])
            label_pieces.append(np.full(len(image_features), -100, np.int64))
        prev = pos + 1
    pieces.append(text_embeds[prev:])
    if labels is not None:
        label_pieces.append(labels[prev:])
    embeds = np.concatenate(pieces, axis=0)
    lab = np.concatenate(label_pieces) if labels is not None else None
    mask = np.ones(len(embeds), bool)
    if max_len is not None:
        pad = max_len - len(embeds)
        if pad < 0:
            embeds, mask = embeds[:max_len], mask[:max_len]
            if lab is not None:
                lab = lab[:max_len]
        elif pad > 0:
            embeds = np.concatenate([embeds, np.zeros((pad, embeds.shape[1]), embeds.dtype)])
            mask = np.concatenate([mask, np.zeros(pad, bool)])
            if lab is not None:
                lab = np.concatenate([lab, np.full(pad, -100, np.int64)])
    out = {"inputs_embeds": embeds, "attention_mask": mask}
    if lab is not None:
        out["labels"] = lab
    return out


def build_splice_plan(input_ids: np.ndarray, num_image_tokens: int, max_len: int,
                      labels: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
    """The splice as gather indices, so that it runs on the device and stays
    differentiable in both the text embeddings and the vision tokens.
    Returns (max_len,) arrays: ``text_idx``, ``img_idx``, ``use_img``,
    ``attention_mask`` and ``labels``."""
    text_idx = np.zeros(max_len, np.int64)
    img_idx = np.zeros(max_len, np.int64)
    use_img = np.zeros(max_len, bool)
    mask = np.zeros(max_len, bool)
    lab = np.full(max_len, -100, np.int64)
    o = 0
    for i, tok in enumerate(input_ids):
        if tok == IMAGE_TOKEN_INDEX:
            for j in range(num_image_tokens):
                if o >= max_len:
                    break
                img_idx[o] = j
                use_img[o] = True
                mask[o] = True
                o += 1
        else:
            if o >= max_len:
                break
            text_idx[o] = i
            mask[o] = True
            if labels is not None:
                lab[o] = labels[i]
            o += 1
    return {"text_idx": text_idx, "img_idx": img_idx, "use_img": use_img,
            "attention_mask": mask, "labels": lab}


def apply_splice_plan(plan: Dict[str, torch.Tensor], text_embeds: torch.Tensor,
                      image_feats: torch.Tensor) -> torch.Tensor:
    """(B, L_text, D) text and (B, T_img, D) vision tokens -> (B, max_len, D)
    embeddings; ``plan`` holds (B, max_len) tensors of ``build_splice_plan``.
    The result has the two inputs' promoted dtype."""
    d = text_embeds.shape[-1]
    t_sel = text_embeds.gather(1, plan["text_idx"][..., None].expand(-1, -1, d))
    i_sel = image_feats.gather(1, plan["img_idx"][..., None].expand(-1, -1, d))
    return torch.where(plan["use_img"][..., None], i_sel, t_sel)


def _encode(tower, projector: MMProjector, pixel_values, pool_vision: str) -> torch.Tensor:
    """(B, T, C, H, W) -> (B, T_ctx [* N], lm_dim) fp32 vision tokens: the
    tower's patch features, one token a frame (``frame_mean``) or every
    patch, through the projector."""
    feats = tower.forward(pixel_values)  # (B, t, N, D)
    b, t, n, d = feats.shape
    feats = feats.mean(dim=2) if pool_vision == "frame_mean" else feats.reshape(b, t * n, d)
    return mm_projector(projector, feats)


@dataclasses.dataclass
class LlavaStreamModel:
    """Vision tower, projector and a pluggable LM: ``embed_tokens(ids) ->
    (L, D)`` and ``lm_forward(embeds, mask) -> logits``."""

    tower: Any  # downstream.vision_tower.TimesformerVisionTower
    projector: MMProjector
    embed_tokens: Callable[[torch.Tensor], torch.Tensor]
    lm_forward: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    pool_vision: str = "frame_mean"

    def encode_video(self, pixel_values) -> torch.Tensor:
        return _encode(self.tower, self.projector, pixel_values, self.pool_vision)

    def forward(self, input_ids: np.ndarray, pixel_values, labels=None,
                max_len: Optional[int] = None):
        img = self.encode_video(pixel_values)[0].float().cpu().numpy()
        safe = np.where(input_ids == IMAGE_TOKEN_INDEX, 0, input_ids)
        text = self.embed_tokens(torch.as_tensor(safe)).float().cpu().numpy()
        spliced = splice_multimodal_inputs(input_ids, text, img, labels, max_len)
        logits = self.lm_forward(torch.from_numpy(spliced["inputs_embeds"])[None],
                                 torch.from_numpy(spliced["attention_mask"])[None])
        return logits, spliced


@dataclasses.dataclass
class LlavaQwenModel:
    """Tower, projector and the port's ``LanguageModel``, as the reference's
    LlavaQwen (``llava_qwen.py`` and ``llava_arch.py``); all on the LM's
    device."""

    tower: Any  # downstream.vision_tower.TimesformerVisionTower, streaming or full clip
    lm: LM.LanguageModel
    projector: MMProjector
    pool_vision: str = "frame_mean"

    @property
    def lm_cfg(self) -> LM.LMConfig:
        return self.lm.cfg

    def encode_video(self, pixel_values) -> torch.Tensor:
        return _encode(self.tower, self.projector, pixel_values, self.pool_vision)

    def _spliced(self, input_ids: np.ndarray, img: torch.Tensor, max_len: int,
                 labels: Optional[np.ndarray] = None):
        """(1, max_len, D) spliced embeddings and the plan's tensors."""
        ids = np.asarray(input_ids, np.int64)
        text_ok = ids != IMAGE_TOKEN_INDEX
        if ((ids[text_ok] < 0) | (ids[text_ok] >= self.lm_cfg.vocab_size)).any():
            raise ValueError(f"prompt ids must be IMAGE_TOKEN_INDEX ({IMAGE_TOKEN_INDEX}) or lie "
                             f"in [0, {self.lm_cfg.vocab_size})")
        dev = self.lm.device
        plan = build_splice_plan(ids, int(img.shape[1]), max_len, labels)
        plan = {k: torch.from_numpy(v)[None].to(dev) for k, v in plan.items()}
        text = LM.embed_tokens(self.lm, torch.from_numpy(np.where(text_ok, ids, 0)))[None]
        return apply_splice_plan(plan, text, img.to(dev)), plan

    @torch.no_grad()
    def forward(self, input_ids: np.ndarray, pixel_values, labels: Optional[np.ndarray] = None,
                max_len: int = 128):
        """(1, max_len, V) fp32 logits of the spliced prompt, and the LM loss
        over ``labels`` (None without)."""
        embeds, plan = self._spliced(input_ids, self.encode_video(pixel_values), max_len, labels)
        out, _ = LM.forward(self.lm, embeds, attention_mask=plan["attention_mask"].long())
        loss = None
        if labels is not None:
            lab = torch.where(plan["attention_mask"], plan["labels"],
                              torch.full_like(plan["labels"], -100))
            loss = LM.lm_loss(out["logits"], lab)
        return out["logits"], loss

    @torch.no_grad()
    def prompt_embeds(self, input_ids: np.ndarray, pixel_values) -> torch.Tensor:
        """The exact-length (L_spliced, D) prompt, vision tokens at every
        placeholder: what ``DecodeEngine.open`` takes and ``generate``
        decodes from. ``pixel_values=None`` reuses a streaming tower's held
        context."""
        img = self.encode_video(pixel_values)
        ids = np.asarray(input_ids, np.int64)
        n_ph = int((ids == IMAGE_TOKEN_INDEX).sum())
        plen = len(ids) - n_ph + n_ph * int(img.shape[1])
        return self._spliced(ids, img, plen)[0][0]

    def generate(self, input_ids: np.ndarray, pixel_values, max_new_tokens: int = 16,
                 eos_token_id: Optional[int] = None) -> np.ndarray:
        """Greedy answer (1, <= max_new_tokens): a streaming tower consumes
        the new frames first, appending to its stream."""
        embeds = self.prompt_embeds(input_ids, pixel_values)[None]
        return LM.greedy_generate(self.lm, embeds, max_new_tokens=max_new_tokens,
                                  eos_token_id=eos_token_id,
                                  capacity=embeds.shape[1] + max_new_tokens)


@torch.no_grad()
def score_option_loglik(model: LlavaQwenModel, prompt_ids: np.ndarray, option_ids: np.ndarray,
                        pixel_values) -> float:
    """Mean log-likelihood of ``option_ids`` continuing the prompt, the
    multiple-choice score of VideoMME-style evaluations."""
    ids = np.concatenate([prompt_ids, option_ids])
    labels = np.concatenate([np.full(len(prompt_ids), -100, np.int64), option_ids])
    img = model.encode_video(pixel_values)
    n_ph = int((ids == IMAGE_TOKEN_INDEX).sum())
    total = len(ids) - n_ph + n_ph * int(img.shape[1])
    embeds, plan = model._spliced(ids, img, total, labels)
    out, _ = LM.forward(model.lm, embeds, attention_mask=plan["attention_mask"].long())
    lab = torch.where(plan["attention_mask"], plan["labels"], torch.full_like(plan["labels"], -100))
    return -float(LM.lm_loss(out["logits"], lab))


def evaluate_multiple_choice(model: LlavaQwenModel, rows) -> Dict[str, float]:
    """Accuracy by option log-likelihood over rows of ``pixel_values``,
    ``prompt_ids``, ``options`` (id arrays) and ``answer``; a streaming
    tower's cache is cleared before each option."""
    correct = 0
    for row in rows:
        scores = []
        for opt in row["options"]:
            if hasattr(model.tower, "clear_cache"):
                model.tower.clear_cache()
            scores.append(score_option_loglik(model, row["prompt_ids"], np.asarray(opt),
                                              row["pixel_values"]))
        correct += int(int(np.argmax(scores)) == int(row["answer"]))
    return {"accuracy": correct / max(len(rows), 1), "n": len(rows)}


def stage_policy(stage: int) -> Dict[str, Any]:
    """Trainable parts and their lrs a stage (the reference's
    ``scripts/train/stage{1,2,3}*.sh``): 1 trains the projector (1e-3);
    2 the projector and the LM (2e-5); 3 also the tower, at 2e-6."""
    if stage == 1:
        return {"train": {"projector"}, "lr": {"projector": 1e-3}}
    if stage == 2:
        return {"train": {"projector", "lm"}, "lr": {"projector": 2e-5, "lm": 2e-5}}
    return {"train": {"projector", "lm", "vision_tower"},
            "lr": {"projector": 2e-5, "lm": 2e-5, "vision_tower": 2e-6}}


# the module's parts under the policy's names
PARTS = {"tower": "vision_tower", "projector": "projector", "lm": "lm"}
ADAMW_WEIGHT_DECAY = 1e-4  # optax.adamw's default, on every leaf
CLIP_GRAD = 1.0  # each part's global-norm clip, the JAX steps' clip_grad default


class VideoQAModel(nn.Module):
    """The trained model: ``tower`` (a ``StreamformerEncoder``), ``projector``
    and ``lm`` under one module, so that one optimizer and
    ``train.checkpoint.save_checkpoint`` see all three. Build the tower and
    the LM with ``trainable=True`` to train them (fp32 masters under the
    compute dtype)."""

    def __init__(self, tower: encoder.StreamformerEncoder, projector: MMProjector,
                 lm: LM.LanguageModel):
        super().__init__()
        self.tower, self.projector, self.lm = tower, projector, lm

    @property
    def device(self) -> torch.device:
        return self.lm.device


def reference_copy(model: VideoQAModel) -> VideoQAModel:
    """A frozen copy of ``model``'s current weights: DPO's reference policy."""
    return copy.deepcopy(model).requires_grad_(False)


def make_optimizer(model: VideoQAModel, stage: int) -> optim.ScheduledOptimizer:
    """Set each part's ``requires_grad`` by the stage and return AdamW over
    the trained parts, one parameter group a part at its lr, each clipped
    by its own norm (optax's ``multi_transform`` of ``clip_by_global_norm``
    and ``adamw`` a part, ``set_to_zero`` for the frozen ones)."""
    pol = stage_policy(stage)
    groups = []
    for part, name in PARTS.items():
        module = getattr(model, part)
        trained = name in pol["train"]
        module.requires_grad_(trained)
        if trained:
            groups.append(dict(params=list(module.parameters()), lr_scale=pol["lr"][name],
                               decayed=True, weight_decay=0.0,
                               base_weight_decay=ADAMW_WEIGHT_DECAY))
    inner = torch.optim.AdamW(groups, lr=0.0, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)
    return optim.ScheduledOptimizer(inner, lambda count: 1.0, None, CLIP_GRAD,
                                    decoupled_sgd_decay=False, clip_each_group=True)


def make_batch(input_ids: np.ndarray, labels: Optional[np.ndarray], num_image_tokens: int,
               max_len: int, device=None) -> Dict[str, torch.Tensor]:
    """One row's training fields as (1, ...) tensors on ``device``: the
    splice plan (``build_splice_plan``), and ``text_ids``, the ids with each
    placeholder replaced by 0."""
    ids = np.asarray(input_ids, np.int64)
    plan = build_splice_plan(ids, num_image_tokens, max_len, labels)
    plan["text_ids"] = np.where(ids == IMAGE_TOKEN_INDEX, 0, ids)
    return {k: torch.from_numpy(v)[None].to(device) for k, v in plan.items()}


def encode_for_training(model: VideoQAModel, pixel_values: torch.Tensor) -> torch.Tensor:
    """(B, T, C, H, W) -> (B, T, lm_dim) fp32: the full clip's patch features
    averaged over each frame's patches, through the projector. The tower
    records no graph unless it trains."""
    tower = model.tower
    with torch.set_grad_enabled(torch.is_grad_enabled() and any(
            p.requires_grad for p in tower.parameters())):
        feats = encoder.model_forward(tower, pixel_values.to(tower.device))["last_hidden_state"]
        feats = feats.mean(dim=2)
    return mm_projector(model.projector, feats)


def _logits_and_labels(model: VideoQAModel, img: torch.Tensor, sub: Dict[str, torch.Tensor]
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The LM's fp32 logits over one spliced response, and its labels with
    the padding at -100."""
    text = LM.embed_tokens(model.lm, sub["text_ids"])
    embeds = apply_splice_plan(sub, text, img.to(text.device))
    out, _ = LM.forward(model.lm, embeds, attention_mask=sub["attention_mask"].long())
    lab = torch.where(sub["attention_mask"], sub["labels"], torch.full_like(sub["labels"], -100))
    return out["logits"], lab


def videoqa_loss(model: VideoQAModel, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The LM loss of the spliced sequence (``pixel_values``, ``text_ids``,
    the splice plan, ``attention_mask`` and ``labels``)."""
    img = encode_for_training(model, batch["pixel_values"])
    return LM.lm_loss(*_logits_and_labels(model, img, batch))


def make_videoqa_train_step(model: VideoQAModel, stage: int):
    """The stage-wise training step: returns (optimizer, step); ``step(batch)``
    updates ``model`` in place and returns the loss (a 0-d tensor on the
    device)."""
    opt = make_optimizer(model, stage)

    def step(batch):
        opt.zero_grad()
        loss = videoqa_loss(model, batch)
        loss.backward()
        opt.step()
        return loss.detach()

    return opt, step


def sequence_logps(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """(B,) summed next-token log-probabilities over the label tokens (-100
    ignored): trl's ``get_batch_logps`` with ``average_log_prob=False``."""
    shift_logits = logits[:, :-1].float()
    shift_labels = labels[:, 1:].to(logits.device)
    valid = shift_labels != -100
    safe = torch.where(valid, shift_labels, torch.zeros_like(shift_labels))
    tok = torch.log_softmax(shift_logits, dim=-1).gather(-1, safe[..., None])[..., 0]
    return (tok * valid).sum(-1)


def dpo_loss(policy_chosen_lp: torch.Tensor, policy_rejected_lp: torch.Tensor,
             ref_chosen_lp: torch.Tensor, ref_rejected_lp: torch.Tensor, beta: float = 0.1,
             label_smoothing: float = 0.0):
    """Sigmoid DPO (trl's ``loss_type='sigmoid'``, the LLaVA DPO recipe's):
    per-pair losses and the chosen and rejected rewards."""
    logits = (policy_chosen_lp - policy_rejected_lp) - (ref_chosen_lp - ref_rejected_lp)
    losses = (-F.logsigmoid(beta * logits) * (1 - label_smoothing)
              - F.logsigmoid(-beta * logits) * label_smoothing)
    chosen = beta * (policy_chosen_lp - ref_chosen_lp)
    rejected = beta * (policy_rejected_lp - ref_rejected_lp)
    return losses, chosen, rejected


def make_videoqa_dpo_step(model: VideoQAModel, ref_model: VideoQAModel, stage: int = 3,
                          beta: float = 0.1, dpo_alpha: float = 1.0, gamma: float = 1.0):
    """The DPO step (the reference's ``train_dpo.py`` over trl's
    ``DPOTrainer``): ``loss = dpo_alpha * mean(-logsigmoid(beta * delta)) +
    gamma * CE(chosen)``, the baseline log-ratios from ``ref_model`` (a
    ``reference_copy``, run without grad). Trainability and lrs follow
    ``stage_policy(stage)``. Batches: ``{"pixel_values", "chosen": sub,
    "rejected": sub}``, each sub a ``make_batch`` of its response. Returns
    (optimizer, step); ``step(batch)`` returns (loss, metrics) as 0-d
    tensors: ``rewards_chosen``, ``rewards_rejected``, ``reward_margin``,
    ``reward_accuracy`` and ``sft_loss``."""
    opt = make_optimizer(model, stage)

    def pair_logps(m, img, batch):
        logits_c, lab_c = _logits_and_labels(m, img, batch["chosen"])
        rejected = sequence_logps(*_logits_and_labels(m, img, batch["rejected"]))
        return sequence_logps(logits_c, lab_c), rejected, logits_c, lab_c

    def step(batch):
        opt.zero_grad()
        with torch.no_grad():
            rc, rr, _, _ = pair_logps(ref_model, encode_for_training(
                ref_model, batch["pixel_values"]), batch)
        pc, pr, logits_c, lab_c = pair_logps(model, encode_for_training(
            model, batch["pixel_values"]), batch)
        losses, cr, rj = dpo_loss(pc, pr, rc, rr, beta)
        sft = LM.lm_loss(logits_c, lab_c)
        loss = dpo_alpha * losses.mean() + gamma * sft
        loss.backward()
        opt.step()
        cr, rj = cr.detach(), rj.detach()
        metrics = {"rewards_chosen": cr.mean(), "rewards_rejected": rj.mean(),
                   "reward_margin": (cr - rj).mean(), "reward_accuracy": (cr > rj).float().mean(),
                   "sft_loss": sft.detach()}
        return loss.detach(), metrics

    return opt, step
