"""OVIS (open-vocabulary video instance segmentation, CTVIS-style) CLI on
PyTorch.

Port of the JAX package's ``downstream/ovis_run.py`` (the reference's
``downstream/OVIS/train_ctvis.py`` and the CTVIS meta-architecture), with
the same flags, plus ``--device`` (``cuda`` unless named): the ViT-Adapter
FPN over the frozen StreamFormer backbone, the Mask2Former segmentor,
training in two phases a step (the adapter and segmentor run once without
a graph for the per-frame Hungarian matching on the host, then again under
the gradient for the loss on those matches, plus the CTVIS contrastive
loss; the frozen backbone's features are computed once for both),
then per-video tracking, a YTVIS results JSON and the in-repo AP
(``eval.ytvis``).

Usage:
    python -m streamformer_tpu_torch.downstream.ovis_run \\
        --anno ytvis/train.json --video_root ytvis/frames \\
        --num_classes 40 --model_path /ckpt/streamformer

``train`` takes the samples (``task_input`` dicts of
``data.seg_datasets.VISDataset``: ``frames`` (T, H, W, 3) uint8,
``mask_target`` (T, H', W') class indices, ``selected_classes``) and
``run_inference`` a ``load_frame(path)``, so a caller can hand in clips and
frames from memory.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from streamformer_tpu_torch.data.transforms import pinned_to


def get_args(argv=None):
    p = argparse.ArgumentParser("StreamFormer OVIS segmentor (PyTorch)")
    p.add_argument("--d2_config", default=None,
                   help="detectron2-style CTVIS/Mask2Former YAML (_BASE_ chains resolved); its "
                   "MODEL/SOLVER/INPUT keys seed the defaults, explicit flags still win")
    p.add_argument("--anno", required=True, help="VISDataset annotation JSON")
    p.add_argument("--video_root", default="")
    p.add_argument("--val_anno", default=None)
    p.add_argument("--tracker", default=None, choices=["SimpleTracker", "HungarianTracker"],
                   help="inference tracker; default the d2-config TRACKER_NAME or "
                   "HungarianTracker")
    p.add_argument("--eval_only", action="store_true",
                   help="skip training; run tracker inference + YTVIS AP on --val_anno (or --anno)")
    p.add_argument("--output_dir", default="output/ovis")
    p.add_argument("--model_path", default=None, help="HF backbone dir")
    p.add_argument("--num_classes", type=int, default=None)
    p.add_argument("--num_queries", type=int, default=None)
    p.add_argument("--epochs", type=int, default=12)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--weight_decay", type=float, default=None)
    p.add_argument("--num_frames", type=int, default=2)
    p.add_argument("--input_size", type=int, default=224)
    p.add_argument("--steps_per_epoch", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    # tiny-model overrides for smoke runs
    p.add_argument("--hidden_size", type=int, default=768)
    p.add_argument("--num_layers", type=int, default=12)
    p.add_argument("--num_heads", type=int, default=12)
    p.add_argument("--intermediate_size", type=int, default=3072)
    return p.parse_args(argv)


@dataclasses.dataclass
class OVISModel:
    """The frozen backbone, the trained parts (``params``: ``adapter`` and
    ``segmentor``, the JAX package's parameter tree) and their configs."""

    backbone: nn.Module
    params: nn.ModuleDict
    seg_cfg: object
    extras: Dict

    @property
    def device(self) -> torch.device:
        return self.params["adapter"].level_embed.device

    def backbone_features(self, pixel_values: torch.Tensor):
        from streamformer_tpu_torch.models import adapter as ADP

        return ADP.backbone_features(self.params["adapter"], self.backbone, pixel_values)

    def forward(self, pixel_values: torch.Tensor, feats=None) -> Dict:
        """pixel_values (B, T, 3, H, W) in [-1, 1] -> the segmentor's
        outputs, leading dim B*T; ``feats`` the clip's backbone features if
        already computed."""
        from streamformer_tpu_torch.downstream import segmentor as SEG
        from streamformer_tpu_torch.models import adapter as ADP

        fpn = ADP.adapter_forward(self.params["adapter"], self.backbone, pixel_values, feats=feats)
        return SEG.segmentor_forward(self.params["segmentor"], fpn, self.seg_cfg)


def resolve_config(args):
    """Fill the flags a d2-config supplies; returns (SegmentorConfig or
    None, extras)."""
    from streamformer_tpu_torch.downstream import segmentor as SEG

    d2_seg, extras = None, {}
    if args.d2_config:
        d2_seg, extras = SEG.config_from_detectron2_yaml(args.d2_config)
    if args.num_classes is None:
        args.num_classes = d2_seg.num_classes if d2_seg else None
    if args.num_classes is None:
        raise SystemExit("--num_classes (or --d2_config) is required")
    if args.num_queries is None:
        args.num_queries = d2_seg.num_queries if d2_seg else 100
    if args.lr is None:
        args.lr = extras.get("base_lr", 1e-4)
    if args.weight_decay is None:
        args.weight_decay = extras.get("weight_decay", 0.05)
    if args.model_path is None and extras.get("backbone_pretrained"):
        if os.path.isdir(extras["backbone_pretrained"]):
            args.model_path = extras["backbone_pretrained"]
    return d2_seg, extras


def build_model(args, device=None) -> OVISModel:
    """The frozen fp32 backbone (``--model_path`` at its trained resolution,
    its position table resized to ``--input_size`` in ``embed``, or seeded),
    the adapter (``default_interaction_indexes``, a deformable head a
    backbone head) and the segmentor (``hidden_dim`` min(hidden, 256)),
    drawn from ``--seed + 1``, on ``device`` (``cuda`` unless named)."""
    from streamformer_tpu_torch.checkpoint.hf_import import from_pretrained
    from streamformer_tpu_torch.config import StreamformerConfig
    from streamformer_tpu_torch.downstream import segmentor as SEG
    from streamformer_tpu_torch.models import adapter as ADP
    from streamformer_tpu_torch.models import encoder

    d2_seg, extras = resolve_config(args)
    dev = encoder.resolve_device(device if device is not None else args.device)
    if args.model_path:
        cfg = StreamformerConfig.from_pretrained(args.model_path).replace(
            num_frames=args.num_frames, dtype="float32")
        backbone = from_pretrained(args.model_path, cfg, device=dev)
    else:
        cfg = StreamformerConfig(num_frames=args.num_frames, image_size=args.input_size,
                                 hidden_size=args.hidden_size, num_hidden_layers=args.num_layers,
                                 num_attention_heads=args.num_heads,
                                 intermediate_size=args.intermediate_size, dtype="float32")
        backbone = encoder.StreamformerEncoder(cfg, device=dev,
                                               generator=torch.Generator().manual_seed(args.seed))
    backbone.requires_grad_(False)
    seg_cfg = dataclasses.replace(d2_seg if d2_seg is not None else SEG.SegmentorConfig(),
                                  num_classes=args.num_classes, num_queries=args.num_queries,
                                  hidden_dim=min(cfg.hidden_size, 256), in_dim=cfg.hidden_size)
    g = torch.Generator().manual_seed(args.seed + 1)
    adapter = ADP.Adapter(cfg, deform_num_heads=cfg.num_attention_heads,
                          interaction_indexes=ADP.default_interaction_indexes(
                              cfg.num_hidden_layers), device=dev, generator=g)
    segmentor = SEG.Segmentor(seg_cfg, device=dev, generator=g)
    return OVISModel(backbone, nn.ModuleDict({"adapter": adapter, "segmentor": segmentor}),
                     seg_cfg, extras)


def make_optimizer(params: nn.Module, lr: float, weight_decay: float):
    """``optax.adamw(lr, weight_decay=wd)`` over the adapter and the
    segmentor."""
    from streamformer_tpu_torch.train import optim

    return optim.adamw_every_leaf(params, lr, weight_decay)


def to_pixels(frames: np.ndarray, device) -> torch.Tensor:
    """(T, H, W, 3) uint8 -> (1, T, 3, H, W) float32 in [-1, 1] on
    ``device`` (the uint8 frames copied, then converted there)."""
    x = pinned_to(frames, device)
    return (x.permute(0, 3, 1, 2).float() / 127.5 - 1.0)[None]


def targets_of(task_input: Dict):
    """The clip's instances, one per class index present in
    ``mask_target``: (instance class indices, gt classes (T, G) -1 where
    absent, gt masks (T, G, H', W') float32), or None without one."""
    sel = np.asarray(task_input["selected_classes"])
    mt = np.asarray(task_input["mask_target"])  # (T, H', W') class index
    inst = [c for c in np.unique(mt) if c >= 0]
    if not inst:
        return None
    nf, g = mt.shape[0], len(inst)
    gt_cls = np.full((nf, g), -1, np.int64)
    gms = np.zeros((nf, g) + mt.shape[1:], np.float32)
    for t in range(nf):
        for gi, c in enumerate(inst):
            m = mt[t] == c
            if m.any():
                gt_cls[t, gi] = int(sel[c]) if c < len(sel) else int(c)
                gms[t, gi] = m
    return np.asarray(inst), gt_cls, gms


def match(out: Dict, gt_cls: np.ndarray, gms: np.ndarray, inst: np.ndarray, seg_cfg):
    """Per-frame Hungarian matching on the host: (the matches (qi, index in
    the padded gt row) a frame, the query ids (T, Q), -1 unmatched)."""
    from streamformer_tpu_torch.downstream import segmentor as SEG

    logits = out["pred_logits"].float().cpu().numpy()
    masks = out["pred_masks"].float().cpu().numpy()
    nf = gt_cls.shape[0]
    matches = []
    ids = np.full((nf, seg_cfg.num_queries), -1, np.int64)
    for t in range(nf):
        valid = gt_cls[t] >= 0
        qi, gi = SEG.hungarian_match(logits[t], masks[t], gt_cls[t][valid], gms[t][valid],
                                     seg_cfg)
        vidx = np.flatnonzero(valid)
        matches.append((qi, vidx[gi]))
        ids[t, qi] = inst[vidx[gi]]
    return matches, ids


def loss_of(model: OVISModel, px, matches, gt_cls, gms, ids, feats=None) -> torch.Tensor:
    """The per-frame set loss (each of the clip's T frames one image of the
    B*T batch) plus the CTVIS contrastive loss on the matched embeddings."""
    from streamformer_tpu_torch.downstream import ctvis_plugin as CL
    from streamformer_tpu_torch.downstream import segmentor as SEG

    out = model.forward(px, feats)
    loss = SEG.criterion(out, matches, gt_cls, gms, model.seg_cfg)
    if ids.shape[0] >= 2:
        loss = loss + CL.cl_loss_from_config(out["embeddings"], ids, model.extras)
    return loss


def train_step(model: OVISModel, opt, task_input: Dict) -> Optional[torch.Tensor]:
    """One clip: the matching forward without a graph, the host matching,
    the loss forward and backward, an AdamW update; the frozen backbone runs
    once for both forwards. Returns the loss (a 0-d tensor on the device),
    or None for a clip without instances."""
    tgt = targets_of(task_input)
    if tgt is None:
        return None
    inst, gt_cls_np, gms_np = tgt
    dev = model.device
    px = to_pixels(task_input["frames"], dev)
    feats = model.backbone_features(px)
    with torch.no_grad():
        out = model.forward(px, feats)
    matches, ids = match(out, gt_cls_np, gms_np, inst, model.seg_cfg)
    gt_cls = torch.from_numpy(gt_cls_np).to(dev, non_blocking=True)
    gms = torch.from_numpy(gms_np).to(dev, non_blocking=True)
    opt.zero_grad()
    loss = loss_of(model, px, matches, gt_cls, gms, torch.from_numpy(ids).to(dev), feats)
    loss.backward()
    opt.step()
    return loss.detach()


def train(args, samples, model: Optional[OVISModel] = None):
    """Train for ``--epochs`` on ``samples`` (a sequence of ``task_input``
    dicts), one clip a step in a seeded permutation (``--steps_per_epoch``
    at most); each epoch writes a line of ``log.txt`` and
    ``checkpoint-<epoch>`` of the adapter and segmentor. Returns (the model,
    the epochs' stats)."""
    from streamformer_tpu_torch.train import checkpoint as ckpt_lib
    from streamformer_tpu_torch.train import metrics as metrics_lib

    os.makedirs(args.output_dir, exist_ok=True)
    model = build_model(args) if model is None else model
    opt = make_optimizer(model.params, args.lr, args.weight_decay)
    rng = np.random.default_rng(args.seed)
    history = []
    for epoch in range(args.epochs):
        t0 = time.time()
        losses = []
        for si, idx in enumerate(rng.permutation(len(samples))):
            loss = train_step(model, opt, samples[int(idx)])
            if loss is not None:
                losses.append(loss)
            if args.steps_per_epoch and si + 1 >= args.steps_per_epoch:
                break
        stats = {"epoch": epoch, "loss": float(torch.stack(losses).mean()),
                 "epoch_time": time.time() - t0}
        print(json.dumps(stats))
        metrics_lib.write_log_line(args.output_dir, stats)
        ckpt_lib.save_checkpoint(args.output_dir, epoch, model.params, opt)
        history.append(stats)
    return model, history


def load_frame_cv2(path: str, size: int) -> np.ndarray:
    """A frame file as RGB uint8 resized to size x size (cv2, as the JAX
    package reads it)."""
    import cv2

    img = cv2.imread(path)
    if img is None:
        raise IOError(path)
    return cv2.resize(cv2.cvtColor(img, cv2.COLOR_BGR2RGB), (size, size))


def _resize_nearest(masks: np.ndarray, h: int, w: int) -> np.ndarray:
    """(N, h0, w0) -> (N, h, w) by cv2's INTER_NEAREST rule,
    floor(i * (1 / (out / in)))."""
    h0, w0 = masks.shape[1:]
    yi = np.minimum(np.floor(np.arange(h) * (1.0 / (h / h0))).astype(int), h0 - 1)
    xi = np.minimum(np.floor(np.arange(w) * (1.0 / (w / w0))).astype(int), w0 - 1)
    return masks[:, yi][:, :, xi]


@torch.no_grad()
def run_inference(args, model: OVISModel, load_frame: Optional[Callable] = None, ds=None):
    """Per-video tracker inference -> ``results.json`` and the YTVIS AP
    (``eval.json``) in ``--output_dir``.

    Per frame the segmentor's detections (frames sampled like the train
    loader, a linspace over the video, each run alone), then per video
    select -> mask NMS -> track (the ctvis HungarianTracker.inference
    loop), masks back at the video's resolution by nearest. ``load_frame``
    (path -> RGB uint8 at ``--input_size``) defaults to cv2; ``ds`` to the
    VISDataset of ``--val_anno`` (or ``--anno``). The tracker is
    ``--tracker``, else the d2-config TRACKER_NAME, else
    HungarianTracker."""
    from streamformer_tpu_torch.data.seg_datasets import VISDataset, polygons_to_mask, rle_to_mask
    from streamformer_tpu_torch.downstream import segmentor as SEG
    from streamformer_tpu_torch.eval import ytvis as YT

    if load_frame is None:
        def load_frame(path):
            return load_frame_cv2(path, args.input_size)
    if ds is None:
        ds = VISDataset(args.val_anno or args.anno, prefix=args.video_root,
                        dataset_name="YoutubeVIS", num_frames=args.num_frames,
                        crop_size=args.input_size, mask_size=(args.input_size, args.input_size))
    extras = model.extras
    name = args.tracker or extras.get("tracker_name") or "HungarianTracker"
    tracker = SEG.tracker_from_extras(extras, name=name)

    results, gt_rows = [], []
    for vid in ds.ids:
        video = ds.videos[vid]
        names = video["file_names"]
        h, w = video["height"], video["width"]
        idx = np.linspace(0, len(names) - 1, args.num_frames).astype(int)
        outs = [model.forward(to_pixels(load_frame(os.path.join(args.video_root, names[int(i)]))
                                        [None], model.device)) for i in idx]
        frame_outs = SEG.track_video(
            torch.cat([o["pred_logits"] for o in outs]).cpu().numpy(),
            torch.cat([o["pred_masks"] for o in outs]).float().cpu().numpy(),
            torch.cat([o["embeddings"] for o in outs]).cpu().numpy(), tracker,
            inference_select_thr=extras.get("inference_select_thr", 0.01),
            mask_nms_thr=extras.get("mask_nms_thr", 0.6))
        for fo in frame_outs:
            if len(fo["masks"]):
                fo["masks"] = _resize_nearest(fo["masks"], h, w)
        results.extend(YT.collect_video_result(vid, frame_outs))
        for a in ds.annos.get(vid, []):
            segs = []
            for i in idx:
                seg = a["segmentations"][int(i)]
                if seg is None:
                    segs.append(None)
                elif isinstance(seg, dict):
                    segs.append(YT.mask_to_rle(rle_to_mask(seg, h, w)))
                else:
                    segs.append(YT.mask_to_rle(polygons_to_mask(seg, h, w)))
            gt_rows.append({"id": len(gt_rows), "video_id": vid,
                            "category_id": a["category_id"], "segmentations": segs})

    os.makedirs(args.output_dir, exist_ok=True)
    YT.write_results(results, os.path.join(args.output_dir, "results.json"))
    metrics = YT.evaluate_ytvis(results, gt_rows) if gt_rows else {}
    line = {"tracker": name, "num_videos": len(ds.ids),
            **{k: v for k, v in metrics.items() if k != "per_class"}}
    print(json.dumps(line))
    with open(os.path.join(args.output_dir, "eval.json"), "w") as f:
        json.dump(line, f)
    return line


class _TaskInputs:
    """A VISDataset's items' ``task_input`` dicts, by index."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        return self.ds[i]["task_input"]


def main(argv=None):
    from streamformer_tpu_torch.data.seg_datasets import VISDataset

    args = get_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)
    model = build_model(args)
    if args.eval_only:
        run_inference(args, model)
        return
    ds = VISDataset(args.anno, prefix=args.video_root, dataset_name="YoutubeVIS",
                    num_frames=args.num_frames, crop_size=args.input_size,
                    mask_size=(args.input_size, args.input_size))
    train(args, _TaskInputs(ds), model)
    if args.val_anno:
        run_inference(args, model)


if __name__ == "__main__":
    main()
