"""Pre-flight data validation CLI: the port's own copy of the JAX
package's ``data/checker.py`` (reference: the VideoQA suite's
playground/data_checker.py, 364 LoC — existence checks, structure checks,
per-source stats, and filtered copies of LLaVA-style data lists).

Two input kinds, unified in one tool:

* ``--metadata meta.yaml`` — the multitask training metadata consumed by
  ``data/build.py``. Every task block is built, media paths are
  existence-checked without decoding (fast), and ``--probe N`` additionally
  decodes N random samples per task through the real ``get_item`` (bypassing
  the _RetryDataset resample so corruption fails LOUD here instead of being
  silently resampled during training, reference kinetics_sparse.py:313-315).
* ``--data list.json|.jsonl|.yaml`` — a LLaVA-format VideoQA conversation
  list ([{"video"|"image", "conversations": [...]}, ...], the format
  videoqa_run.py trains on). Ops mirror the reference checker:
  ``check`` (media existence + conversation structure), ``stat``
  (per-source counts), ``filter`` (write a cleaned copy without
  missing-media rows, reference filter_data :191-246).

Exit code is non-zero when problems were found, so the tool gates launch
scripts / CI. Run:
    python -m streamformer_tpu_torch.data.checker --metadata meta.yaml --probe 2
    python -m streamformer_tpu_torch.data.checker --data llava_video.json \
        --video_root videos/ --op filter --out cleaned.json
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
from collections import Counter
from typing import Any, Dict, List, Optional, Tuple


def _load_list(path: str) -> List[Dict[str, Any]]:
    """LLaVA-style data list from .json / .jsonl / .yaml (the yaml form is
    a {datasets: [{json_path, sampling_strategy}, ...]} manifest whose
    member lists are loaded and concatenated, like the reference loader)."""
    if path.endswith(".jsonl"):
        with open(path) as f:
            return [json.loads(l) for l in f if l.strip()]
    if path.endswith(".json"):
        with open(path) as f:
            return json.load(f)
    if path.endswith((".yaml", ".yml")):
        import yaml

        with open(path) as f:
            manifest = yaml.safe_load(f)
        rows: List[Dict[str, Any]] = []
        for entry in manifest.get("datasets", []):
            rows.extend(_load_list(entry["json_path"]))
        return rows
    raise ValueError(f"Unsupported data list format: {path}")


def _media_paths(row: Dict[str, Any], image_root: str, video_root: str):
    """All media files a row references, resolved against the roots."""
    out = []
    if "image" in row:
        imgs = row["image"] if isinstance(row["image"], list) else [row["image"]]
        out += [os.path.join(image_root, i) for i in imgs]
    if "video" in row:
        out.append(os.path.join(video_root, row["video"]))
    return out


def _structure_problems(row: Dict[str, Any]) -> List[str]:
    """Conversation-structure checks (reference check_item_structure): turns
    must alternate human/gpt starting with human; at most one media
    placeholder, and only in the first human turn."""
    probs = []
    conv = row.get("conversations")
    if not conv:
        return ["no conversations"]
    for i, turn in enumerate(conv):
        want = "human" if i % 2 == 0 else "gpt"
        if turn.get("from") != want:
            probs.append(f"turn {i} from={turn.get('from')!r}, want {want!r}")
    n_ph = sum(
        t.get("value", "").count("<image>") + t.get("value", "").count("<video>")
        for t in conv
    )
    if n_ph > 1:
        probs.append(f"{n_ph} media placeholders (want <= 1)")
    later = sum(
        t.get("value", "").count("<image>") + t.get("value", "").count("<video>")
        for t in conv[1:]
    )
    if later:
        probs.append("media placeholder outside the first turn")
    return probs


def check_data_list(
    rows: List[Dict[str, Any]],
    image_root: str = "",
    video_root: str = "",
    op: str = "check",
    out_path: Optional[str] = None,
) -> Tuple[int, List[Dict[str, Any]]]:
    """Returns (n_problems, kept_rows). ``filter`` keeps only rows whose
    media all exist (structure problems are reported, not dropped — matching
    the reference, which filters on existence)."""
    n_problems = 0
    kept = []
    sources = Counter()
    for i, row in enumerate(rows):
        src = row.get("data_source") or row.get("id", "unknown")
        if isinstance(src, str) and "/" in src:
            # aggregate sub-splits ("k710/split1", "k710/split2") under the
            # dataset prefix for the per-source stat table
            src = src.split("/")[0]
        sources[src] += 1
        missing = [p for p in _media_paths(row, image_root, video_root)
                   if not os.path.exists(p)]
        for p in missing:
            print(f"WARNING: row {i}: missing media {p}")
        probs = _structure_problems(row) if op != "stat" else []
        for p in probs:
            print(f"WARNING: row {i}: {p}")
        n_problems += len(missing) + len(probs)
        if not missing:
            kept.append(row)
    if op == "stat":
        text_only = sum(
            1 for r in rows if "image" not in r and "video" not in r
        )
        print(f"rows: {len(rows)}  text-only: {text_only}")
        for src, n in sources.most_common():
            print(f"  {src}: {n}")
    if op == "filter":
        assert out_path, "--op filter requires --out"
        with open(out_path, "w") as f:
            json.dump(kept, f)
        print(f"kept {len(kept)}/{len(rows)} rows -> {out_path}")
    return n_problems, kept


def _dataset_media(ds) -> List[str]:
    """Media paths of one task dataset, without decoding anything."""
    if hasattr(ds, "rows"):  # TAL / grounding / localization JSON rows
        return [os.path.join(getattr(ds, "prefix", ""), r["video"])
                for r in ds.rows]
    samples = getattr(ds, "samples", None)
    if samples is None:
        return []
    if hasattr(samples, "iloc"):  # retrieval DataFrame with per-row roots
        dd = getattr(ds, "data_dict", {}) or {}
        roots = dd.get("root_dir", {})
        return [
            os.path.join(roots.get(r.get("dataset", "MSRVTT"), ""),
                         str(r["video"]))
            for _, r in samples.iterrows()
        ]
    prefix = getattr(ds, "prefix", "")
    return [os.path.join(prefix, str(s)) for s in samples]


def check_metadata(metadata: str, probe: int = 0, seed: int = 0) -> int:
    """Existence-check every task block of a multitask metadata YAML and
    optionally decode ``probe`` random samples per task. Returns the number
    of problems found."""
    from streamformer_tpu_torch.data.build import build_multi_task_dataset

    train, evals, mtc = build_multi_task_dataset(metadata)
    n_problems = 0
    rng = random.Random(seed)
    unions = [("train", train)] + ([("validation", evals)] if evals else [])
    for mode, union in unions:
        for ds in union.datasets:
            # unwrap the balance-replication proxy
            inner = getattr(ds, "ds", ds)
            name = getattr(inner, "task_name", type(inner).__name__)
            paths = _dataset_media(inner)
            missing = [p for p in paths if not os.path.exists(p)]
            for p in missing[:20]:
                print(f"WARNING: {name}/{mode}: missing media {p}")
            if len(missing) > 20:
                print(f"WARNING: {name}/{mode}: ... {len(missing) - 20} more")
            n_problems += len(missing)
            print(f"{name}/{mode}: {len(inner)} samples, "
                  f"{len(paths)} media files, {len(missing)} missing")
            for _ in range(probe):
                idx = rng.randrange(len(inner))
                try:
                    # get_item directly: no _RetryDataset resampling, so a
                    # corrupt file fails here instead of silently at train
                    item = inner.get_item(idx)
                    fr = item["task_input"].get("frames")
                    shape = None if fr is None else tuple(fr.shape)
                    print(f"  probe {name}[{idx}]: ok frames={shape}")
                except Exception as e:
                    print(f"WARNING: {name}[{idx}]: decode failed: {e}")
                    n_problems += 1
    return n_problems


def main(argv=None):
    p = argparse.ArgumentParser("streamformer-tpu data checker")
    p.add_argument("--metadata", help="multitask metadata YAML (build.py schema)")
    p.add_argument("--probe", type=int, default=0,
                   help="decode N random samples per task via get_item")
    p.add_argument("--data", help="LLaVA-format VideoQA list (.json/.jsonl/.yaml)")
    p.add_argument("--image_root", default="")
    p.add_argument("--video_root", default="")
    p.add_argument("--op", default="check", choices=["check", "stat", "filter"])
    p.add_argument("--out", help="output path for --op filter")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    n_problems = 0
    if args.metadata:
        n_problems += check_metadata(args.metadata, probe=args.probe,
                                     seed=args.seed)
    if args.data:
        rows = _load_list(args.data)
        n, _ = check_data_list(rows, args.image_root, args.video_root,
                               op=args.op, out_path=args.out)
        n_problems += n
    if not args.metadata and not args.data:
        p.error("give --metadata and/or --data")
    print(f"total problems: {n_problems}")
    return 1 if n_problems else 0


if __name__ == "__main__":
    sys.exit(main())
