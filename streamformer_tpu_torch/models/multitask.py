"""Multitask model: backbone + frozen text tower + task heads.

Port of the JAX package's ``models/multitask.py``. ``MultitaskModel`` is an
``nn.Module`` that owns what the JAX package keeps in its parameter tree
(``backbone``, ``text``, ``logit_scale``, ``logit_bias``) together with the
config, the task registry, the tokenizer and the static text-derived state
(the prompt-ensembled label tables built once by
``prepare_for_multi_tasks``). ``loss_fn`` is the training objective of one
task per batch, the task picked by its name.

The backbone is the trainer's encoder (``StreamformerEncoder(...,
trainable=True)``: fp32 master parameters under ``cfg.dtype`` compute); the
text tower is frozen and its outputs are detached, so its gradients are not
merely zero but absent.

Task name -> head, as in the JAX package: Kinetics/SSV2 -> classification;
*Grounding/TaskLocalization -> universal localization;
THUMOS14/ActivityNet/FineAction/HACS -> naive (windowed) localization;
MSRVTT/WebVid/TaskRetrieval -> retrieval; CharadesSTA/QVHighlights/... ->
grounding; YoutubeVIS/LVVIS/COCOPseudoVIS/TaskVIS -> VIS;
MEVIS/ReferYoutubeVOS/RefCOCOPseudo/TaskReferVOS -> ReferVOS.
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from streamformer_tpu_torch.config import StreamformerConfig
from streamformer_tpu_torch.models import encoder, heads, text_encoder
from streamformer_tpu_torch.utils.hash_tok import hash_word_id

CLASSIFICATION_TASKS = {"SSV2", "Kinetics"}
UNIVERSAL_LOCALIZATION_TASKS = {
    "THUMOS14Grounding",
    "ActivityNetGrounding",
    "FineActionGrounding",
    "HACSGrounding",
    "TaskLocalization",
}
NAIVE_LOCALIZATION_TASKS = {"THUMOS14", "ActivityNet", "FineAction", "HACS"}
RETRIEVAL_TASKS = {"MSRVTT", "WebVid", "TaskRetrieval"}
GROUNDING_TASKS = {
    "CharadesSTA",
    "QVHighlights",
    "TaCoS",
    "TVSum",
    "ActivityNetCaptions",
    "DiDeMo",
    "QuerYD",
    "TaskGrounding",
}
VIS_TASKS = {"YoutubeVIS", "LVVIS", "COCOPseudoVIS", "TaskVIS"}
REFERVOS_TASKS = {"MEVIS", "ReferYoutubeVOS", "RefCOCOPseudo", "TaskReferVOS"}

_KINDS = (
    (CLASSIFICATION_TASKS, "classification"),
    (UNIVERSAL_LOCALIZATION_TASKS, "universal_localization"),
    (NAIVE_LOCALIZATION_TASKS, "naive_localization"),
    (RETRIEVAL_TASKS, "retrieval"),
    (GROUNDING_TASKS, "grounding"),
    (VIS_TASKS, "vis"),
    (REFERVOS_TASKS, "refervos"),
)


def head_type_for_task(task: str) -> str:
    for tasks, kind in _KINDS:
        if task in tasks:
            return kind
    raise NotImplementedError(f"Task type {task} not implemented")


class _HashTokenizer:
    """Deterministic offline stand-in: lower-cased words hashed into the
    vocab. NOT the SigLIP sentencepiece; only for environments without the
    tokenizer's files."""

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size

    def __call__(self, texts, padding="max_length", truncation=True, max_length=64,
                 return_tensors="np"):
        ids = np.ones((len(texts), max_length), np.int32)  # 1 = pad
        for r, t in enumerate(texts):
            for c, w in enumerate(t.lower().split()[: max_length - 1]):
                ids[r, c] = hash_word_id(w, self.vocab_size, reserved=2)
        return {"input_ids": ids}


class MultitaskModel(nn.Module):
    """Backbone, frozen text tower, ``logit_scale`` (log 10) and
    ``logit_bias`` (-2), on ``cuda`` unless ``device`` names another device.
    Weights are drawn from ``generator`` (a CPU generator; a fresh default
    one otherwise), the backbone's first, then the text tower's."""

    def __init__(
        self,
        cfg: StreamformerConfig,
        multi_task_config: Optional[Dict[str, Dict]] = None,
        text_cfg: Optional[text_encoder.SiglipTextConfig] = None,
        *,
        generator: Optional[torch.Generator] = None,
        grounding_head: str = "default",  # "default" | "contrastive"
        device=None,
    ):
        super().__init__()
        if grounding_head not in ("default", "contrastive"):
            raise ValueError(f"grounding_head {grounding_head!r}: 'default' or 'contrastive'")
        dev = encoder.resolve_device(device)
        self.grounding_head = grounding_head
        self.cfg = cfg
        self.text_cfg = text_cfg or text_encoder.SiglipTextConfig(hidden_size=cfg.hidden_size)
        self.multi_task_config = multi_task_config or {}
        self.task_types = list(self.multi_task_config.keys())
        self.backbone = encoder.StreamformerEncoder(cfg, device=dev, generator=generator,
                                                    trainable=True)
        self.text = text_encoder.SiglipTextEncoder(self.text_cfg, device=dev, generator=generator)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(10.0), device=dev))
        self.logit_bias = nn.Parameter(torch.tensor(-2.0, device=dev))
        self._tokenizer = None
        # static per-task state built by prepare_for_multi_tasks
        self.label_embeddings: Dict[str, Any] = {}

    @property
    def device(self) -> torch.device:
        return self.logit_scale.device

    # ------------------------------------------------------------------
    # text tower utilities (host-side tokenization, device encode)
    # ------------------------------------------------------------------

    @property
    def tokenizer(self):
        if self._tokenizer is None:
            name = os.environ.get("STREAMFORMER_TOKENIZER", "google/siglip-base-patch16-224")
            try:
                from transformers import AutoTokenizer

                # local files only: fail fast instead of waiting on a hub
                self._tokenizer = AutoTokenizer.from_pretrained(name, local_files_only=True)
            except (ImportError, OSError, ValueError) as e:  # no package, no files, no such tokenizer
                # The word-hash stand-in gives meaningless label and caption
                # embeddings: training on it silently would be a garbage run,
                # so it must be asked for (tests and dry runs set the variable).
                if os.environ.get("STREAMFORMER_ALLOW_HASH_TOKENIZER") != "1":
                    raise RuntimeError(
                        f"SigLIP tokenizer '{name}' is not available locally "
                        f"({type(e).__name__}: {e}). Point the env var "
                        "STREAMFORMER_TOKENIZER at a local tokenizer directory, or set "
                        "STREAMFORMER_ALLOW_HASH_TOKENIZER=1 to use a deterministic hash "
                        "tokenizer (tests and dry runs only, NOT valid for real training)."
                    ) from e
                self._tokenizer = _HashTokenizer(self.text_cfg.vocab_size)
        return self._tokenizer

    def tokenize(self, texts: List[str], max_length: int = 64) -> np.ndarray:
        """(len(texts), L) int32 ids, padded to min(max_length, the text
        tower's position table)."""
        max_length = min(max_length, self.text_cfg.max_position_embeddings)
        out = self.tokenizer(texts, padding="max_length", truncation=True,
                             max_length=max_length, return_tensors="np")
        return np.asarray(out["input_ids"]).astype(np.int32)

    def _text_embeds(self, ids) -> torch.Tensor:
        with torch.no_grad():
            return text_encoder.forward(self.text, ids)["pooler_output"]

    def encode_texts(self, texts: List[str]) -> torch.Tensor:
        """(len(texts), D) pooled text embeddings from the tower's current
        weights, without a gradient."""
        return self._text_embeds(self.tokenize(texts))

    def encode_label_prompts(self, labels: List[str], templates: List[str]) -> torch.Tensor:
        """Prompt-ensembled label embeddings: per label, the mean of the
        normalized template embeddings."""
        embeds = []
        for label in labels:
            e = self.encode_texts([t.format(label) for t in templates])
            embeds.append((e / e.norm(dim=-1, keepdim=True)).mean(dim=0))
        return torch.stack(embeds)

    def prepare_for_multi_tasks(self) -> None:
        """Precompute the label embedding tables of every configured task."""
        for task, tcfg in self.multi_task_config.items():
            kind = head_type_for_task(task)
            label2id = tcfg.get("label2id")
            if kind == "classification":
                self.label_embeddings[task] = self.encode_label_prompts(
                    list(label2id.keys()), heads.VIDEO_TEMPLATES)
            elif kind in ("universal_localization", "vis"):
                # per-dataset tables; the collate layer pads them to a common L
                templates = (heads.VIDEO_TEMPLATES if kind == "universal_localization"
                             else heads.SCENE_TEMPLATES)
                self.label_embeddings[task] = {
                    ds: self.encode_label_prompts(list(ds_label2id.keys()), templates)
                    for ds, ds_label2id in label2id.items()
                }
            elif kind == "naive_localization":
                prompts = [f"A photo of a {label} person." for label in label2id.keys()]
                self.label_embeddings[task] = self.encode_texts(prompts)
            # retrieval / grounding / refervos encode captions per batch

    # ------------------------------------------------------------------
    # forward paths
    # ------------------------------------------------------------------

    def backbone_forward(self, pixel_values, generator: Optional[torch.Generator] = None,
                         deterministic: bool = True) -> Dict[str, torch.Tensor]:
        return encoder.model_forward(self.backbone, torch.as_tensor(pixel_values),
                                     generator=generator, deterministic=deterministic)

    def _on_device(self, task_input: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device) for k, v in task_input.items()}

    def loss_fn(
        self,
        task_name: str,
        pixel_values,  # (B, T, C, H, W)
        task_input: Dict[str, Any],
        generator: Optional[torch.Generator] = None,
        deterministic: bool = True,
        group=None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One task's training objective: ``(loss, logits)``. ``task_input``
        is the fixed schema the collate layer produces (tensors or numpy
        arrays, moved to the model's device here); caption embeddings come
        from the frozen tower without a gradient. ``generator`` and
        ``deterministic`` are the backbone's (``encoder.model_forward``);
        ``group`` is the process group of the contrastive heads (None: one
        process)."""
        kind = head_type_for_task(task_name)
        out = self.backbone_forward(pixel_values, generator=generator,
                                    deterministic=deterministic)
        pooler, last = out["pooler_output"], out["last_hidden_state"]
        scale, bias = self.logit_scale, self.logit_bias
        ti = self._on_device(task_input)

        if kind == "classification":
            return heads.classification_head(pooler, ti["label_embeddings"], ti["label"],
                                             scale, bias)
        if kind == "retrieval":
            return heads.retrieval_head(pooler, self._text_embeds(ti["caption_ids"]), scale,
                                        bias, group=group)
        if kind == "grounding":
            text = self._text_embeds(ti["caption_ids"])
            if self.grounding_head == "contrastive":
                return heads.grounding_contrastive_head(pooler, text, ti["label"], scale, bias,
                                                        group=group)
            return heads.grounding_head(pooler, text, ti["label"], scale, bias)
        if kind == "universal_localization":
            return heads.universal_localization_head(pooler, ti["label_embeddings"],
                                                     ti["class_mask"], ti["label"], scale, bias)
        if kind == "naive_localization":
            return heads.naive_localization_head(pooler, ti["label_embeddings"],
                                                 ti["target_labels"], scale, bias)
        proj = heads.dense_projection_params(self.backbone.head)
        if kind == "vis":
            return heads.vis_segmentation_head(last, proj, ti["label_embeddings"],
                                               ti["class_mask"], ti["mask_target"], scale, bias)
        return heads.refervos_contrastive_head(last, proj, self._text_embeds(ti["caption_ids"]),
                                               ti["mask_target"], scale, bias, group=group)

    # ------------------------------------------------------------------
    # published inference APIs
    # ------------------------------------------------------------------

    def forward_features(self, pixel_values, pooling_method: str = "mean") -> torch.Tensor:
        """(B, D) features, or (B, T, D) with ``"no_pooling"``; ``"last"``
        is the causal summary frame."""
        pooler = self.backbone_forward(pixel_values)["pooler_output"]
        if pooling_method == "mean":
            return pooler.mean(dim=1)
        if pooling_method == "no_pooling":
            return pooler
        return pooler[:, -1]

    @torch.no_grad()
    def extract_feature(self, pixel_values: torch.Tensor, window_size: int = 384) -> torch.Tensor:
        """Chunked long-video encode, without a gradient: pixel_values
        (B, total_T, C, H, W) is zero-padded to a multiple of the window,
        encoded window by window in clips of ``cfg.num_frames``, and the
        per-frame features concatenated: (B, total_T, D)."""
        b, total = pixel_values.shape[:2]
        tf = self.cfg.num_frames
        pad = (-total) % window_size
        if pad:
            zeros = pixel_values.new_zeros((b, pad) + tuple(pixel_values.shape[2:]))
            pixel_values = torch.cat([pixel_values, zeros], dim=1)
        feats = []
        for i in range(0, pixel_values.shape[1], window_size):
            win = pixel_values[:, i:i + window_size]
            clips = win.reshape((-1, tf) + tuple(win.shape[2:]))
            pooled = self.backbone_forward(clips)["pooler_output"]
            feats.append(pooled.reshape(b, window_size, -1))
        return torch.cat(feats, dim=1)[:, :total]
