"""Interleave-benchmark answer scorer (reference
downstream/VideoQA/llava/eval/evaluate_interleave.py:1-338): the port's own
copy of the JAX package's ``eval/interleave.py``, which imports no JAX
(``tests/test_torch_videoqa_train.py`` holds the two equal).

Scores a ``result.jsonl`` of {sample_id, dataset, question_type,
gt_response, pred_response} rows:

* open-ended    -> summary-level ROUGE-L f (union-LCS over unique words,
                   the py-rouge ``rouge-l`` semantics the reference calls)
* multi-choice  -> exact match after normalization, with the reference's
                   "X: answer" single-letter extraction rule
* category buckets (spot-the-diff / image-edit / storytelling / cloze /
  text-rich VQA / multi-image VQA / puzzle / nlrv2 / qbench) averaged
  across their member datasets.

Original implementation: the LCS table/backtrack is iterative (the
reference's recursive reconstruction overflows Python's stack on long
answers) and needs neither the ``rouge`` package nor sklearn (whose
TfidfVectorizer import in the reference is dead code).
"""

from __future__ import annotations

import argparse
import json
import os
import re
from typing import Dict, Iterable, List, Sequence, Tuple

# ---------------------------------------------------------------------------
# answer normalization (reference Eval.process / processPunctuation)

_PERIOD_RE = re.compile(r"(?!<=\d)(\.)(?!\d)")
_COMMA_NUM_RE = re.compile(r"(\d)(\,)(\d)")
_PUNCT = [
    ";", r"/", "[", "]", '"', "{", "}", "(", ")", "=", "+", "\\", "_",
    "-", ">", "<", "@", "`", ",", "?", "!",
]


def normalize_answer(answer: str) -> str:
    out = answer.replace("\n", " ").replace("\t", " ").strip()
    for p in _PUNCT:
        if (p + " " in out or " " + p in out) or _COMMA_NUM_RE.search(out):
            out = out.replace(p, "")
        else:
            out = out.replace(p, " ")
    out = _PERIOD_RE.sub("", out)
    out = out.strip("'").strip('"').strip(")").strip("(")
    return out.strip().lower()


# ---------------------------------------------------------------------------
# summary-level ROUGE-L (union-LCS over unique words)


def _sentences(text: str) -> List[List[str]]:
    """Split on '.', normalize whitespace, drop empties; -> word lists."""
    return [
        s.split() for s in (" ".join(p.split()) for p in text.split("."))
        if s
    ]


def _lcs_words(ref: Sequence[str], hyp: Sequence[str]) -> set:
    """Unique words on one longest common subsequence of ref/hyp
    (iterative DP + backtrack; ties follow the ref-first convention the
    py-rouge reconstruction uses, though the UNION of unique words is
    tie-insensitive for scoring)."""
    n, m = len(ref), len(hyp)
    if n == 0 or m == 0:
        return set()
    prev = [0] * (m + 1)
    table = [prev]
    for i in range(1, n + 1):
        cur = [0] * (m + 1)
        ri = ref[i - 1]
        for j in range(1, m + 1):
            if ri == hyp[j - 1]:
                cur[j] = prev[j - 1] + 1
            else:
                cur[j] = prev[j] if prev[j] >= cur[j - 1] else cur[j - 1]
        table.append(cur)
        prev = cur
    out = set()
    i, j = n, m
    while i > 0 and j > 0:
        if ref[i - 1] == hyp[j - 1]:
            out.add(ref[i - 1])
            i -= 1
            j -= 1
        elif table[i - 1][j] > table[i][j - 1]:
            i -= 1
        else:
            j -= 1
    return out


def rouge_l_f(pred: str, ref: str) -> float:
    """Summary-level ROUGE-L f of pred vs ref (py-rouge 'rouge-l'['f']):
    per reference sentence, union the unique-word LCS against every pred
    sentence into a running union; recall/precision divide the union's
    growth by the UNIQUE word counts of ref/pred."""
    ref_sents, pred_sents = _sentences(ref), _sentences(pred)
    if not ref_sents or not pred_sents:
        return 0.0
    m = len({w for s in ref_sents for w in s})
    n = len({w for s in pred_sents for w in s})
    union: set = set()
    llcs = 0
    for rs in ref_sents:
        before = len(union)
        for ps in pred_sents:
            union |= _lcs_words(rs, ps)
        llcs += len(union) - before
    r_lcs, p_lcs = llcs / m, llcs / n
    return 2.0 * p_lcs * r_lcs / (p_lcs + r_lcs + 1e-8)


# ---------------------------------------------------------------------------
# per-question-type scorers (reference Eval.evaluate_*)


def score_open_ended(preds: Iterable[Dict]) -> Tuple[Dict, List[Dict]]:
    scores, eval_list = [], []
    for res in preds:
        gt = normalize_answer(res["gt_response"])
        pr = normalize_answer(res["pred_response"])
        if gt == "":
            continue
        s = 0.0 if pr == "" else rouge_l_f(pr[:512], gt)
        scores.append(s)
        eval_list.append(
            {"id": str(res["sample_id"]), "score": str(round(s, 3))}
        )
    mean = sum(scores) / len(scores) if scores else 0.0
    return {"Rouge-L f": mean}, eval_list


def _extract_choice(pred: str) -> str:
    """'b: the left image' -> 'b' (reference judge_multi_choice)."""
    if ":" in pred:
        for part in (p.strip() for p in pred.split(":")):
            if len(part) == 1 and part in "abcdefgh":
                return part
    return pred


def score_multichoice(preds: Iterable[Dict]) -> Tuple[Dict, List[Dict]]:
    correct, total, eval_list = 0, 0, []
    for res in preds:
        gt = normalize_answer(res["gt_response"])
        pr = _extract_choice(normalize_answer(res["pred_response"]))
        s = int(pr == gt)
        correct += s
        total += 1
        eval_list.append({"id": str(res["sample_id"]), "score": str(s)})
    return {"Accuracy": correct / max(total, 1)}, eval_list


# ---------------------------------------------------------------------------
# dataset -> category buckets (reference module-level tables)

CATEGORIES: Dict[str, List[str]] = {
    "spot_the_diff": ["Spot-the-Diff", "Birds-to-Words", "CLEVR-Change"],
    "image_edit_instruct": ["IEdit", "HQ-Edit", "MagicBrush"],
    "visual_story_telling": ["AESOP", "FlintstonesSV", "PororoSV", "VIST"],
    "visual_cloze": ["COMICS_Dialogue", "RecipeQA_VisualCloze"],
    "text_rich_vqa": ["WebQA", "TQA", "OCR-VQA", "DocVQA"],
    "multi_image_vqa": [
        "MIT-States_StateCoherence", "MIT-States_PropertyCoherence",
        "VISION", "RecipeQA_ImageCoherence",
    ],
    "puzzle": ["RAVEN"],
    "nlrv2": ["NLVR2_Mantis"],
    "qbench": ["QBench"],
}


def score_results(
    rows: Iterable[Dict],
) -> Tuple[Dict[str, Dict], Dict[str, List[Dict]], Dict[str, float]]:
    """rows -> (per-dataset metrics, per-dataset detail, category means)."""
    by_ds: Dict[str, List[Dict]] = {}
    for r in rows:
        by_ds.setdefault(r["dataset"], []).append(r)

    per_ds: Dict[str, Dict] = {}
    detail: Dict[str, List[Dict]] = {}
    for ds, preds in by_ds.items():
        qt = preds[0].get("question_type", "open-ended")
        if qt == "open-ended":
            per_ds[ds], detail[ds] = score_open_ended(preds)
        elif qt == "multi-choice" or ds == "nlrv2":
            per_ds[ds], detail[ds] = score_multichoice(preds)
        else:
            raise ValueError(f"unsupported question_type {qt!r} ({ds})")

    cats: Dict[str, float] = {}
    for cat, members in CATEGORIES.items():
        vals = [
            next(iter(per_ds[ds].values()))
            for ds in per_ds
            if ds in members
        ]
        if vals:
            cats[cat] = sum(vals) / len(vals)
    return per_ds, detail, cats


def main(argv=None):
    ap = argparse.ArgumentParser("interleave answer scorer")
    ap.add_argument("--result-dir", required=True,
                    help="dir holding result.jsonl (videoqa_run --eval "
                         "output merged across chunks)")
    args = ap.parse_args(argv)

    path = os.path.join(args.result_dir, "result.jsonl")
    if not os.path.exists(path):
        print("No prediction file found")
        return 0
    with open(path) as f:
        rows = [json.loads(line) for line in f if line.strip()]

    per_ds, detail, cats = score_results(rows)
    for ds, metrics in per_ds.items():
        print(f"{ds}:  {metrics}")
    with open(os.path.join(args.result_dir, "eval_dataset.json"), "w") as f:
        json.dump(per_ds, f, indent=4)
    with open(
        os.path.join(args.result_dir, "eval_dataset_details.json"), "w"
    ) as f:
        json.dump(detail, f, indent=4)
    for cat, score in cats.items():
        print(f"{cat}:  {100 * score:.2f}")
    with open(os.path.join(args.result_dir, "eval_category.json"), "w") as f:
        json.dump(cats, f, indent=4)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
