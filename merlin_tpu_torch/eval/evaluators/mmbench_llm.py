"""MMBench evaluator with LLM answer extraction (a copy of
``merlin_tpu/eval/evaluators/mmbench_llm.py``; reference
utils/evaluation_tools/mmbench_openai_evaluator.py rebuilt).

When the rule heuristics can't infer the chosen letter, the reference asks
ChatGPT to extract it, with retries (OpenAIWrapper:24-79,
extract_answer_from_item:256-291). Here the judge client is pluggable:
pass any ``callable(prompt) -> str`` — an OpenAI client, a local model
served by this package itself, or nothing (pure-rule fallback, offline-safe).
"""

from __future__ import annotations

import random
import time
from typing import Callable, Dict, Optional, Sequence

from merlin_tpu_torch.eval.evaluators.mmbench import (
    build_choices, can_infer, eval_result as rule_eval_result)


def build_extraction_prompt(item: Dict) -> str:
    """The answer-extraction prompt (mmbench_openai_evaluator.py:186
    behavior): question + options + the model's free-form answer."""
    choices = build_choices(item)
    options = "\n".join(f"{k}. {v}" for k, v in choices.items())
    return (
        "You are an AI assistant who will help me to match an answer with "
        "several options of a single-choice question. You are provided with "
        "a question, several options, and an answer, and you need to find "
        "which option is most similar to the answer. If the meaning of all "
        "options are significantly different from the answer, output E. "
        "Your should output a single uppercase character in A, B, C, D "
        "(if they are valid options), and E.\n"
        f"Question: {item.get('question', '')}\n"
        f"Options:\n{options}\n"
        f"Answer: {item.get('prediction', '')}\n"
        "Your output: ")


def make_openai_judge(model: str = "gpt-3.5-turbo",
                      api_key: Optional[str] = None) -> Callable[[str], str]:
    """Judge backed by the OpenAI API (requires the openai package + key;
    gated so offline environments never import it)."""
    import openai  # noqa: deferred; absent in offline envs

    client = openai.OpenAI(api_key=api_key)

    def judge(prompt: str) -> str:
        resp = client.chat.completions.create(
            model=model, messages=[{"role": "user", "content": prompt}],
            temperature=0.0, max_tokens=10)
        return resp.choices[0].message.content or ""

    return judge


def extract_answer_from_item(item: Dict,
                             judge: Optional[Callable[[str], str]] = None,
                             *, retries: int = 3,
                             rng: Optional[random.Random] = None) -> str:
    """Rule inference first; LLM extraction with retries when ambiguous;
    random choice as the final fallback (reference :256-291)."""
    choices = build_choices(item)
    ret = can_infer(str(item.get("prediction", "")), choices)
    if ret:
        return ret
    if judge is not None:
        prompt = build_extraction_prompt(item)
        for attempt in range(retries):
            try:
                out = judge(prompt).strip()
            except Exception:
                time.sleep(min(2 ** attempt, 10))
                continue
            for ch in "ABCDE":
                if ch in out.split() or out.startswith(ch):
                    return ch
    rng = rng or random.Random(2680)  # reference seed (:183)
    return rng.choice(list(choices) or ["E"])


def eval_result(predictions: Sequence[Dict], meta: Sequence[Dict],
                judge: Optional[Callable[[str], str]] = None) -> Dict:
    """Circular evaluation where non-inferable predictions are first
    resolved by the judge."""
    resolved = []
    for row in predictions:
        row = dict(row)
        if not can_infer(str(row.get("prediction", "")), build_choices(row)):
            row["prediction"] = extract_answer_from_item(row, judge)
        resolved.append(row)
    return rule_eval_result(resolved, meta)
