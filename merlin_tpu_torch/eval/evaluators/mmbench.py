"""MMBench rule-based evaluator (a copy of
``merlin_tpu/eval/evaluators/mmbench.py``; reference
utils/evaluation_tools/mmbench_evaluator.py rebuilt, no xlsx dependency).

Option-letter inference from free text (token/punctuation heuristics),
letter-vs-option-text fallback, and the circular-eval rule: a question
counts as correct only if every circular-shifted sub-question (index
offsets of 1e6) is answered correctly.
"""

from __future__ import annotations

import string
from typing import Dict, List, Optional, Sequence, Union

CHOICE_KEYS = "ABCD"


def build_choices(item: Dict) -> Dict[str, str]:
    out = {}
    for ch in CHOICE_KEYS:
        val = item.get(ch)
        if val is not None and val == val and str(val) != "nan":
            out[ch] = str(val)
    return out


def can_infer_option(answer: str, num_choice: int = 5) -> Union[str, bool]:
    """Infer the chosen letter from free text (mmbench_evaluator.py:101-130)."""
    choices = string.ascii_uppercase[:num_choice]
    if "Failed to obtain answer via API" in answer:
        return False

    splits = [x.strip() for x in answer.split()]

    def count(prefix="", suffix=""):
        return sum(1 for c in choices if prefix + c + suffix in splits)

    if count() == 1:
        for ch in choices:
            if "A" in splits and len(splits) > 3:
                # 'A' is likely an article in a full sentence
                break
            if ch in splits:
                return ch
    tups = [("", "."), ("", ","), ("", ":"), ("", ")"), ("", ")."),
            ("(", ")"), ("(", ")."), (":", ""), (":", ","), (":", "."),
            (":", ")"), (":", ").")]
    for prefix, suffix in tups:
        if count(prefix, suffix) == 1:
            for ch in choices:
                if prefix + ch + suffix in splits:
                    return ch
    return False


def can_infer_text(answer: str, choices: Dict[str, str]) -> Union[str, bool]:
    """Match the option text itself inside the answer (:132-144)."""
    answer = answer.lower()
    cands = [k for k, v in choices.items() if str(v).lower() in answer]
    return cands[0] if len(cands) == 1 else False


def can_infer(answer: str, choices: Dict[str, str]) -> Union[str, bool]:
    return can_infer_option(answer) or can_infer_text(answer, choices)


def eval_sub_data(sub_items: Sequence[Dict], answer_map: Dict) -> int:
    """All circular shifts of one question must be right (:156-178)."""
    preds, gts = [], []
    for item in sub_items:
        gts.append(answer_map[int(item["index"])])
        preds.append(can_infer(str(item["prediction"]), build_choices(item)))
        if preds[-1] and gts[-1] != preds[-1]:
            return 0
    for item, pred, gt in zip(sub_items, preds, gts):
        if pred:
            continue
        # letter not inferable: require the gt letter inside the raw text
        # (mmbench_evaluator.py:170-176)
        if gt not in str(item["prediction"]):
            return 0
    return 1


def eval_result(predictions: Sequence[Dict], meta: Sequence[Dict]
                ) -> Dict[str, object]:
    """predictions: rows with index/prediction/A..D[/category/l2-category].
    meta: rows with index/answer/category/l2-category/split.
    Returns {'overall': acc, 'l2': {...}, 'leaf': {...}, 'per_index': {...}}.
    """
    # answer_map keyed by FULL index: circular shifts rotate the options, so
    # each sub-question has its own gt letter (mmbench_evaluator.py:203)
    answer_map = {int(m["index"]): m["answer"] for m in meta}
    cate_map = {int(m["index"]) % int(1e6): m.get("category", "na")
                for m in meta}
    l2_map = {int(m["index"]) % int(1e6):
              m.get("l2-category", m.get("l2_category", "na")) for m in meta}

    by_main: Dict[int, List[Dict]] = {}
    for row in predictions:
        main = int(row["index"]) % int(1e6)
        by_main.setdefault(main, []).append(row)

    per_index: Dict[int, int] = {}
    hit = tot = 0
    cat_stats: Dict[str, List[int]] = {}
    l2_stats: Dict[str, List[int]] = {}
    for main, rows in sorted(by_main.items()):
        if not all(int(r["index"]) in answer_map for r in rows):
            continue
        ret = eval_sub_data(sorted(rows, key=lambda r: int(r["index"])),
                            answer_map)
        per_index[main] = ret
        hit += ret
        tot += 1
        cat_stats.setdefault(cate_map.get(main, "na"), []).append(ret)
        l2_stats.setdefault(l2_map.get(main, "na"), []).append(ret)

    acc = lambda xs: sum(xs) / len(xs) if xs else 0.0
    return {
        "overall": hit / max(tot, 1),
        "l2": {k: acc(v) for k, v in sorted(l2_stats.items())},
        "leaf": {k: acc(v) for k, v in sorted(cat_stats.items())},
        "per_index": per_index,
    }
