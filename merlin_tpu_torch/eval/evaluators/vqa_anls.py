"""Multi-task VQA metric engine (a copy of
``merlin_tpu/eval/evaluators/vqa_anls.py``; reference
utils/evaluation_tools/vqa_annls_evaluator.py rebuilt).

Implements the EvalAI-style answer normalization (contractions, digit
words, article/punctuation stripping) and the per-task metrics:
  * VQA accuracy — min(#matching human answers / 3, 1), averaged over
    leave-one-out subsets of the 10 annotators
  * ANLS (DocVQA/InfographicVQA/ST-VQA) — 1 - normalized Levenshtein,
    thresholded at 0.5, max over ground-truth answers
  * exact match
  * relaxed accuracy (ChartQA/PointQA) — numeric within 5% else exact
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence

CONTRACTIONS = {
    "aint": "ain't", "arent": "aren't", "cant": "can't",
    "couldve": "could've", "couldnt": "couldn't", "didnt": "didn't",
    "doesnt": "doesn't", "dont": "don't", "hadnt": "hadn't",
    "hasnt": "hasn't", "havent": "haven't", "hed": "he'd",
    "hes": "he's", "howd": "how'd", "howll": "how'll", "hows": "how's",
    "id": "i'd", "im": "i'm", "ive": "i've", "isnt": "isn't",
    "itd": "it'd", "itll": "it'll", "lets": "let's", "maam": "ma'am",
    "mightve": "might've", "mustve": "must've", "neednt": "needn't",
    "oclock": "o'clock", "shant": "shan't", "shed": "she'd",
    "shes": "she's", "shouldve": "should've", "shouldnt": "shouldn't",
    "somebodyd": "somebody'd", "somebodyll": "somebody'll",
    "somebodys": "somebody's", "someoned": "someone'd",
    "someonell": "someone'll", "someones": "someone's",
    "somethingd": "something'd", "somethingll": "something'll",
    "thats": "that's", "thered": "there'd", "therere": "there're",
    "theres": "there's", "theyd": "they'd", "theyll": "they'll",
    "theyre": "they're", "theyve": "they've", "twas": "'twas",
    "wasnt": "wasn't", "wed": "we'd", "weve": "we've", "werent": "weren't",
    "whatll": "what'll", "whatre": "what're", "whats": "what's",
    "whatve": "what've", "whens": "when's", "whered": "where'd",
    "wheres": "where's", "whereve": "where've", "whod": "who'd",
    "wholl": "who'll", "whos": "who's", "whove": "who've",
    "whyll": "why'll", "whyre": "why're", "whys": "why's",
    "wont": "won't", "wouldve": "would've", "wouldnt": "wouldn't",
    "yall": "y'all", "youd": "you'd", "youll": "you'll",
    "youre": "you're", "youve": "you've",
}
DIGIT_MAP = {"none": "0", "zero": "0", "one": "1", "two": "2",
             "three": "3", "four": "4", "five": "5", "six": "6",
             "seven": "7", "eight": "8", "nine": "9", "ten": "10"}
ARTICLES = {"a", "an", "the"}
PUNCT = list(";/[]\"{}()=+\\_-><@`,?!") + ["'"]
PERIOD_STRIP = re.compile(r"(?!<=\d)(\.)(?!\d)")
COMMA_STRIP = re.compile(r"(\d)(,)(\d)")


def process_punctuation(text: str) -> str:
    out = text
    for p in PUNCT:
        if (p + " " in text or " " + p in text) or \
                re.search(COMMA_STRIP, text) is not None:
            out = out.replace(p, "")
        else:
            out = out.replace(p, " ")
    return PERIOD_STRIP.sub("", out, re.UNICODE)


def process_digit_article(text: str) -> str:
    out = []
    for word in text.lower().split():
        word = DIGIT_MAP.get(word, word)
        if word not in ARTICLES:
            out.append(word)
    for i, word in enumerate(out):
        out[i] = CONTRACTIONS.get(word, word)
    return " ".join(out)


def normalize_answer(text: str) -> str:
    text = text.replace("\n", " ").replace("\t", " ").strip()
    return process_digit_article(process_punctuation(text))


def vqa_accuracy(prediction: str, gt_answers: Sequence[str]) -> float:
    """3-of-10 human-consensus accuracy, leave-one-out averaged."""
    pred = normalize_answer(prediction)
    answers = [normalize_answer(a) for a in gt_answers]
    if len(answers) == 1:
        return float(pred == answers[0])
    accs = []
    for i in range(len(answers)):
        others = answers[:i] + answers[i + 1:]
        matches = sum(1 for a in others if a == pred)
        accs.append(min(1.0, matches / 3.0))
    return sum(accs) / len(accs)


def levenshtein(s1: str, s2: str) -> int:
    if len(s1) < len(s2):
        s1, s2 = s2, s1
    if not s2:
        return len(s1)
    prev = list(range(len(s2) + 1))
    for i, c1 in enumerate(s1):
        cur = [i + 1]
        for j, c2 in enumerate(s2):
            cur.append(min(prev[j + 1] + 1, cur[j] + 1,
                           prev[j] + (c1 != c2)))
        prev = cur
    return prev[-1]


def anls_score(prediction: str, gt_answers: Sequence[str],
               threshold: float = 0.5) -> float:
    """1 - NL distance if similarity >= threshold else 0; max over gts."""
    pred = " ".join(prediction.strip().lower().split())
    best = 0.0
    for gt in gt_answers:
        gt = " ".join(str(gt).strip().lower().split())
        if not gt and not pred:
            best = max(best, 1.0)
            continue
        dist = levenshtein(pred, gt)
        sim = 1.0 - dist / max(len(pred), len(gt), 1)
        best = max(best, sim if sim >= threshold else 0.0)
    return best


def exact_match(prediction: str, gt_answers: Sequence[str]) -> float:
    pred = normalize_answer(prediction)
    return float(any(normalize_answer(str(g)) == pred for g in gt_answers))


def relaxed_accuracy(prediction: str, gt: str, tolerance: float = 0.05
                     ) -> float:
    """ChartQA/PointQA: numeric within 5% relative error, else exact."""
    def to_float(x):
        try:
            return float(str(x).strip().rstrip("%"))
        except ValueError:
            return None

    p, g = to_float(prediction), to_float(gt)
    if p is not None and g is not None:
        if g == 0:
            return float(p == 0)
        return float(abs(p - g) / abs(g) <= tolerance)
    return float(str(prediction).strip().lower() == str(gt).strip().lower())


TASK_METRICS = {
    "VQA": "vqa", "VQAv2": "vqa", "GQA": "vqa", "OKVQA": "vqa",
    "TextVQA": "vqa",
    "DocVQA": "anls", "InfographicVQA": "anls", "ST-VQA": "anls",
    "ChartQA": "relaxed", "PointQA": "relaxed",
}


class VQAEval:
    """Batch scorer: dispatches the task's metric
    (vqa_annls_evaluator.py:264-460 behavior)."""

    def __init__(self, datatype: str = "DocVQA"):
        self.datatype = datatype
        self.metric = TASK_METRICS.get(datatype, "anls")

    def score(self, predictions: Dict[str, str],
              ground_truths: Dict[str, Sequence[str]]) -> Dict[str, float]:
        per_q = {}
        for qid, pred in predictions.items():
            gts = ground_truths.get(qid)
            if gts is None:
                continue
            gts = [gts] if isinstance(gts, str) else list(gts)
            if self.metric == "vqa":
                per_q[qid] = vqa_accuracy(pred, gts)
            elif self.metric == "anls":
                per_q[qid] = anls_score(pred, gts)
            elif self.metric == "relaxed":
                per_q[qid] = max(relaxed_accuracy(pred, g) for g in gts)
            else:
                per_q[qid] = exact_match(pred, gts)
        overall = sum(per_q.values()) / max(len(per_q), 1)
        return {"overall": overall, "per_question": per_q, "n": len(per_q)}
