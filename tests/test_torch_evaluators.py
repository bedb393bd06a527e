"""The port's evaluators against the JAX package's, on seeded inputs:

  * the MMBench rule evaluator: option and text inference, the circular
    rule and ``eval_result`` over random predictions;
  * the LLM-judge evaluator: its prompt, a stub judge, a judge that raises
    (``time.sleep`` patched in both packages: the same retries and waits)
    and the ``random.Random(2680)`` fallback re-seeded on every call;
  * ``vqa_anls``: normalization, Levenshtein, ANLS, exact match, relaxed
    accuracy and ``VQAEval`` for every datatype.
"""

import random
import time

import numpy as np
import pytest

from merlin_tpu.eval.evaluators import mmbench as j_mmb
from merlin_tpu.eval.evaluators import mmbench_llm as j_llm
from merlin_tpu.eval.evaluators import vqa_anls as j_vqa

from merlin_tpu_torch.eval.evaluators import mmbench as t_mmb
from merlin_tpu_torch.eval.evaluators import mmbench_llm as t_llm
from merlin_tpu_torch.eval.evaluators import vqa_anls as t_vqa

ANSWERS = ["B", "The answer is (C).", "D.", "A dog runs in the field today",
           "maybe B or C", "(A)", "A: cat", "it looks like a dog to me",
           "a cat and a dog", "C, the fish", "E", "", "Failed to obtain "
           "answer via API B", "answer: D).", "nothing fits", "b", "A."]
CHOICES = {"A": "cat", "B": "dog", "C": "fish", "D": "bird"}


@pytest.mark.parametrize("answer", ANSWERS)
def test_option_and_text_inference_match_jax(answer):
    for n in (2, 4, 5):
        assert t_mmb.can_infer_option(answer, n) == \
            j_mmb.can_infer_option(answer, n)
    for choices in (CHOICES, {"A": "cat", "B": "fish"}, {}):
        assert t_mmb.can_infer_text(answer, dict(choices)) == \
            j_mmb.can_infer_text(answer, dict(choices))
        assert t_mmb.can_infer(answer, dict(choices)) == \
            j_mmb.can_infer(answer, dict(choices))


@pytest.mark.parametrize("item", [
    {"A": "x", "B": float("nan"), "C": None, "D": "nan"},
    {"A": 1.0, "B": 2, "C": "three"}, {}],
    ids=["nan-none", "numbers", "empty"])
def test_build_choices_matches_jax(item):
    assert t_mmb.build_choices(item) == j_mmb.build_choices(item)


def random_predictions(seed, n_main=12):
    """Rows and meta for ``n_main`` questions, each with 1-3 circular
    shifts, random answers from ``ANSWERS`` and categories; question 3's
    second shift has no meta row, so the question is skipped."""
    rng = random.Random(seed)
    preds, meta = [], []
    for main in range(1, n_main + 1):
        for shift in range(2 if main == 3 else rng.randint(1, 3)):
            index = main + shift * 10 ** 6
            row = {"index": index, "prediction": rng.choice(ANSWERS),
                   **{k: v for k, v in CHOICES.items()
                      if rng.random() < 0.9}}
            preds.append(row)
            if (main, shift) != (3, 1):
                meta.append({"index": index, "answer": rng.choice("ABCD"),
                             "category": f"cat{main % 3}",
                             "l2-category": f"l2{main % 2}"})
    rng.shuffle(preds)
    return preds, meta


@pytest.mark.parametrize("seed", range(4))
def test_rule_eval_result_matches_jax(seed):
    preds, meta = random_predictions(seed)
    got = t_mmb.eval_result(preds, meta)
    assert got == j_mmb.eval_result(preds, meta)
    assert 3 not in got["per_index"]
    rows = sorted((r for r in preds if r["index"] % 10 ** 6 == 1),
                  key=lambda r: r["index"])
    answer_map = {m["index"]: m["answer"] for m in meta}
    assert t_mmb.eval_sub_data(rows, answer_map) == \
        j_mmb.eval_sub_data(rows, answer_map)


def test_extraction_prompt_matches_jax():
    item = {"question": "what animal?", "prediction": "a dog I think",
            **CHOICES}
    assert t_llm.build_extraction_prompt(item) == \
        j_llm.build_extraction_prompt(item)


@pytest.fixture
def sleeps(monkeypatch):
    """``time.sleep`` (both packages' judge loops call it), recorded."""
    waits = []
    monkeypatch.setattr(time, "sleep", waits.append)
    return waits


def _judge(reply, calls):
    def judge(prompt):
        calls.append(prompt)
        if isinstance(reply, Exception):
            raise reply
        return reply
    return judge


@pytest.mark.parametrize("reply", ["B", " C because", "E", "zzz",
                                   RuntimeError("judge down")],
                         ids=["letter", "lead", "none-fits", "junk",
                              "raises"])
def test_judge_extraction_matches_jax(sleeps, reply):
    """An uninferable prediction goes to the judge; a reply without a
    letter, or a judge that raises on every try, ends at the seeded random
    choice. Both packages call the judge as often and wait as long."""
    item = {"question": "q", "prediction": "nothing fits here", **CHOICES}
    jcalls, tcalls = [], []
    want = j_llm.extract_answer_from_item(item, _judge(reply, jcalls))
    jwaits = list(sleeps)
    got = t_llm.extract_answer_from_item(item, _judge(reply, tcalls))
    assert got == want and tcalls == jcalls
    assert sleeps[len(jwaits):] == jwaits
    assert len(tcalls) == (3 if reply == "zzz" or
                           isinstance(reply, Exception) else 1)
    assert jwaits == ([1, 2, 4] if isinstance(reply, Exception) else [])


def test_random_fallback_is_reseeded_every_call():
    """No judge: the choice comes from ``random.Random(2680)`` made afresh
    for each item, so it does not move with the global random state."""
    item = {"prediction": "unclear", **CHOICES}
    random.seed(1)
    first = t_llm.extract_answer_from_item(item)
    random.seed(2)
    assert t_llm.extract_answer_from_item(item) == first == \
        j_llm.extract_answer_from_item(item) == \
        random.Random(2680).choice(list(CHOICES))
    assert t_llm.extract_answer_from_item({"prediction": "x"}) == \
        j_llm.extract_answer_from_item({"prediction": "x"}) == "E"
    rng = random.Random(5)
    assert t_llm.extract_answer_from_item(item, rng=rng) == \
        j_llm.extract_answer_from_item(item, rng=random.Random(5))


@pytest.mark.parametrize("seed", range(3))
def test_llm_eval_result_matches_jax(sleeps, seed):
    preds, meta = random_predictions(seed + 10)
    jcalls, tcalls = [], []
    want = j_llm.eval_result(preds, meta, _judge("C", jcalls))
    got = t_llm.eval_result(preds, meta, _judge("C", tcalls))
    assert got == want and tcalls == jcalls
    assert t_llm.eval_result(preds, meta) == j_llm.eval_result(preds, meta)


# ---------------------------------------------------------------------------
# vqa_anls
# ---------------------------------------------------------------------------

TEXTS = ["The Cat!", "two dogs", "dont", "It's 3,000 dollars.", "yes",
         "no", "Ten o'clock", "a-b/c", "  hello\tworld\n", "$42", "42",
         "104", "100", "5%", "blue", "None", "x.y", "3.14", "e.g. this",
         "the answer", "(a) answer", "answer; the other", ""]


@pytest.mark.parametrize("text", TEXTS)
def test_normalization_matches_jax(text):
    assert t_vqa.normalize_answer(text) == j_vqa.normalize_answer(text)
    assert t_vqa.process_punctuation(text) == \
        j_vqa.process_punctuation(text)
    assert t_vqa.process_digit_article(text) == \
        j_vqa.process_digit_article(text)


def _random_cases(seed, n=40):
    rng = np.random.default_rng(seed)
    preds = {f"q{i}": str(rng.choice(TEXTS)) for i in range(n)}
    gts = {}
    for i in range(n):
        k = int(rng.integers(1, 11))
        gts[f"q{i}"] = [str(t) for t in rng.choice(TEXTS, size=k)]
    gts["q0"] = gts["q0"][0]           # a single string
    del gts["q1"]                      # a question without ground truth
    return preds, gts


@pytest.mark.parametrize("seed", range(3))
def test_metrics_match_jax(seed):
    preds, gts = _random_cases(seed)
    for qid, pred in preds.items():
        g = gts.get(qid)
        if g is None:
            continue
        g = [g] if isinstance(g, str) else g
        assert t_vqa.vqa_accuracy(pred, g) == j_vqa.vqa_accuracy(pred, g)
        assert t_vqa.anls_score(pred, g) == j_vqa.anls_score(pred, g)
        assert t_vqa.exact_match(pred, g) == j_vqa.exact_match(pred, g)
        for one in g:
            assert t_vqa.relaxed_accuracy(pred, one) == \
                j_vqa.relaxed_accuracy(pred, one)
            assert t_vqa.levenshtein(pred, one) == \
                j_vqa.levenshtein(pred, one)


@pytest.mark.parametrize("datatype", sorted(j_vqa.TASK_METRICS) + ["Other"])
def test_vqaeval_matches_jax(datatype):
    assert t_vqa.TASK_METRICS == j_vqa.TASK_METRICS
    for seed in range(2):
        preds, gts = _random_cases(seed)
        got = t_vqa.VQAEval(datatype).score(preds, gts)
        assert got == j_vqa.VQAEval(datatype).score(preds, gts)
        assert got["n"] == len(preds) - 1 and "q1" not in got["per_question"]
