"""MMBench harness (counterpart of ``merlin_tpu/eval/mmbench.py``; reference
engine/eval/eval_mmbench.py rebuilt).

Reads the official TSV (base64 images, circular-shift sub-questions at
index offsets of 1e6), builds option-letter MCQ prompts with hint + CN/EN
answer instruction, decodes (beam-5 or greedy/sampled), writes predictions
as JSON and xlsx, then runs the rule-based circular evaluator.

The JAX package reads the TSV with ``pandas.read_table``; the port does not
depend on pandas, so :func:`load_tsv` reads it with the standard library's
``csv`` module and repeats the per-column type inference of pandas's C
parser that reaches the prompt and the records (trap C31): a numeric
option column with an empty cell reads ``4.0``, ``1e3`` reads ``1000.0``,
and ``None``/``NA``/``nan``/... read NaN, which ends the option list.
"""

from __future__ import annotations

import base64
import csv
import io
import json
import math
import os
import re
import sys
from typing import Dict, List, Optional, Union

import torch

from merlin_tpu_torch.eval.evaluators.mmbench import eval_result
from merlin_tpu_torch.eval.runner import EvalConfig, EvalModel

ALL_OPTIONS = ["A", "B", "C", "D"]
PROMPT_EN = "Answer with the option's letter from the given choices directly."
PROMPT_CN = "请直接回答选项字母。"

# pandas's default NA strings (``pandas._libs.parsers.STR_NA_VALUES``)
NA_STRINGS = frozenset((
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"))
BOOLS = {"True": True, "TRUE": True, "true": True,
         "False": False, "FALSE": False, "false": False}
_WS = "[ \t\n\v\f\r]*"
_INT = re.compile(_WS + r"[+-]?[0-9]+" + _WS + r"\Z")
_FLOAT = re.compile(_WS + r"([+-]?)([0-9]*)(?:\.([0-9]*))?"
                    r"(?:[eE]([+-]?[0-9]{1,17}))?" + _WS + r"\Z")
_INF = {"inf": math.inf, "+inf": math.inf, "infinity": math.inf,
        "+infinity": math.inf, "-inf": -math.inf, "-infinity": -math.inf}
_POW10 = [float(f"1e{i}") for i in range(309)]


def parse_float(text: str) -> Optional[float]:
    """A cell as pandas's default float converter reads it (the C parser's
    ``precise_xstrtod``: at most 17 significant digits summed in doubles,
    then one multiply or divide by a power of ten), or None where it reads
    no number. ``float()`` differs from it in the last bit of some values."""
    if text.lower() in _INF:
        return _INF[text.lower()]
    m = _FLOAT.match(text)
    if m is None or not (m.group(2) or m.group(3)):
        return None
    sign, whole, frac, exp = m.group(1), m.group(2), m.group(3) or "", \
        m.group(4)
    number, n, exponent = 0.0, 0, 0
    for ch in whole:
        if n < 17:
            number = number * 10.0 + (ord(ch) - 48)
            n += 1
        else:
            exponent += 1
    for ch in frac[:max(17 - n, 0)]:
        number = number * 10.0 + (ord(ch) - 48)
        n += 1
        exponent -= 1
    if sign == "-":
        number = -number
    exponent += int(exp or 0)
    if exponent > 308:
        return math.copysign(math.inf, number) if number else 0.0
    if exponent > 0:
        return number * _POW10[exponent]
    if exponent < -616:
        return 0.0
    if exponent < -308:
        return number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def infer_column(cells: List[Optional[str]]) -> list:
    """One column's cells (None for NA) as ``read_table`` types them: all
    ints -> int; numbers, or ints with NA -> float; booleans -> bool; else
    str. NA reads ``float("nan")`` in every kind."""
    nan = float("nan")
    present = [c for c in cells if c is not None]
    if len(present) == len(cells) and all(_INT.match(c) for c in present):
        return [int(c) for c in cells]
    floats = [parse_float(c) for c in present]
    if all(f is not None for f in floats):
        it = iter(floats)
        return [nan if c is None else next(it) for c in cells]
    if all(c in BOOLS for c in present):
        return [nan if c is None else BOOLS[c] for c in cells]
    return [nan if c is None else c for c in cells]


def load_tsv(path: str) -> List[Dict]:
    """The TSV's rows as ``pandas.read_table(path).to_dict("records")``
    gives them: a header row, tab-separated cells, ``"``-quoted cells that
    may hold tabs, quotes and newlines, blank lines skipped, short rows
    filled with NA, and each column typed by :func:`infer_column`."""
    # a base64 640x480 JPEG is longer than csv's default 131072-character
    # field limit
    csv.field_size_limit(min(sys.maxsize, 2 ** 31 - 1))
    with open(path, newline="", encoding="utf-8-sig") as f:
        rows = [r for r in csv.reader(f, delimiter="\t", quotechar='"')
                if r and not (len(r) == 1 and not r[0].strip(" \t\n\v\f\r"))]
    if not rows:
        raise ValueError(f"{path}: no header row")
    header, body = rows[0], rows[1:]
    for i, r in enumerate(body):
        if len(r) > len(header):
            raise ValueError(f"{path}: data row {i} has {len(r)} fields, "
                             f"the header {len(header)}")
    columns = [infer_column([
        r[j] if j < len(r) and r[j] not in NA_STRINGS else None
        for r in body]) for j in range(len(header))]
    return [dict(zip(header, vals)) for vals in zip(*columns)]


def is_none(value) -> bool:
    if value is None:
        return True
    if isinstance(value, float) and math.isnan(value):
        return True
    return isinstance(value, str) and value.lower() in ("nan", "none", "")


def get_options(row: Dict) -> List[str]:
    out = []
    for opt in ALL_OPTIONS:
        if is_none(row.get(opt)):
            break
        out.append(str(row[opt]))
    return out


def build_question(row: Dict, language: str = "en") -> str:
    question = str(row["question"])
    if not is_none(row.get("hint")):
        question = str(row["hint"]) + "\n" + question
    for letter, option in zip(ALL_OPTIONS, get_options(row)):
        question += f"\n{letter}. {option}"
    question += "\n" + (PROMPT_CN if language == "cn" else PROMPT_EN)
    return question


def decode_b64_image(data: str):
    from PIL import Image

    return Image.open(io.BytesIO(base64.b64decode(data))).convert("RGB")


def run(bundle, eval_file: str, output_path: str,
        eval_cfg: Optional[EvalConfig] = None, *, limit: int = 0,
        score: bool = True, batch_size: int = 1,
        device: Union[str, torch.device] = "cuda") -> Dict:
    language = "cn" if "cn" in eval_file.lower() else "en"
    eval_cfg = eval_cfg or EvalConfig(num_beams=5, max_new_tokens=64,
                                      language=language)
    model = EvalModel(bundle, eval_cfg, device=device)

    rows = load_tsv(eval_file)
    if limit:
        rows = rows[:limit]
    predictions = []
    for start in range(0, len(rows), max(batch_size, 1)):
        chunk = rows[start: start + max(batch_size, 1)]
        questions = [build_question(r, language) for r in chunk]
        images = [[decode_b64_image(r["image"])] for r in chunk]
        if batch_size > 1:
            answers = model.ask_batch(questions, images)
        else:
            answers = [model.ask(q, im) for q, im in zip(questions, images)]
        for row, answer in zip(chunk, answers):
            rec = {"index": int(row["index"]),
                   "question": str(row["question"]), "prediction": answer}
            for opt in ALL_OPTIONS:
                if not is_none(row.get(opt)):
                    rec[opt] = str(row[opt])
            predictions.append(rec)

    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    with open(output_path, "w") as f:
        json.dump(predictions, f, indent=1, ensure_ascii=False)
    # MMBench submission format: the reference ships an .xlsx
    # (eval_mmbench.py:173 via openpyxl); written here dependency-free
    if output_path.endswith(".json"):
        from merlin_tpu_torch.utils.xlsx import write_records_xlsx

        write_records_xlsx(output_path[:-5] + ".xlsx", predictions)

    if not score or "answer" not in rows[0]:
        return {"predictions": output_path}
    # full index kept: circular shifts rotate options so each sub-question
    # carries its own gt letter
    meta = [{"index": int(r["index"]), "answer": str(r["answer"]),
             "category": r.get("category", "na"),
             "l2-category": r.get("l2-category", "na")}
            for r in rows]
    results = eval_result(predictions, meta)
    with open(output_path.replace(".json", "_scores.json"), "w") as f:
        json.dump({k: v for k, v in results.items() if k != "per_index"},
                  f, indent=1)
    return results
