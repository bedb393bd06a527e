"""The port's eval CLI (``merlin_tpu_torch.engine.eval.main``) against JAX's
``merlin_tpu.engine.eval.main`` on the CPU: ``--tiny --device cpu``, the same
tiny weights (JAX's init, copied into the port's bundle after its own
``init_or_load_params`` ran on the device asked for), tokenizers primed
alike (C20) and the same input files, for every file benchmark, the box
REPL on stdin, and ``--num-chunks``/``--merge-chunks``. The CLI samples
unless it runs beam search or ``--speculative``; those two give tokens
that must match exactly (C6), and a sampled run must repeat itself (C32).
The answer budget (1024 tokens in both CLIs) is cut to 8 in both, here
only. Then ``python -m merlin_tpu_torch.engine.eval`` in a subprocess.
"""

import functools
import io
import json
import logging
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from merlin_tpu.engine import eval as j_eval
from merlin_tpu.eval import runner as j_runner

from merlin_tpu_torch.engine import eval as t_eval
from merlin_tpu_torch.eval import runner as t_runner
from merlin_tpu_torch.models.bridge import params_from_flax

from test_torch_eval_harnesses import (
    MMB_QUESTIONS, OPEN_QUESTIONS, PRIME_TEXTS, mmbench_rows, noise_image,
    prime, write_tsv)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_NEW = 8


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _loggers():
    """Both CLIs set their package's logger up (its own stream handler, no
    propagation); put it back, so the root logger (caplog) sees the
    packages' records in this worker's later tests."""
    saved = [(lg, lg.level, lg.propagate, list(lg.handlers))
             for lg in map(logging.getLogger, ("merlin_tpu",
                                               "merlin_tpu_torch"))]
    yield
    for lg, level, propagate, handlers in saved:
        lg.handlers[:] = handlers
        lg.propagate = propagate
        lg.setLevel(level)


@pytest.fixture
def clis(monkeypatch):
    """Both CLIs on the same tiny weights with primed tokenizers and an
    8-token answer budget; the port's device argument recorded."""
    devices = []
    flax = {}
    j_build, t_build = j_eval.build_model_tokenizer, t_eval.build_model_tokenizer
    j_init, t_init = j_eval.init_or_load_params, t_eval.init_or_load_params

    def build(real, *a, **kw):
        bundle = real(*a, **kw)
        prime(bundle.tokenizer, bundle.tokenizer, PRIME_TEXTS + MMB_QUESTIONS)
        return bundle

    def j_load(bundle, **kw):
        flax["params"] = j_init(bundle, rng=jax.random.key(0), **kw)
        return flax["params"]

    def t_load(bundle, *, device, **kw):
        devices.append(device)
        t_init(bundle, device=device, **kw)
        bundle.model.load_state_dict(
            params_from_flax(jax.device_get(flax["params"])), strict=True,
            assign=True)
        bundle.params = bundle.model.state_dict()
        return bundle.params

    monkeypatch.setattr(j_eval, "build_model_tokenizer",
                        functools.partial(build, j_build))
    monkeypatch.setattr(t_eval, "build_model_tokenizer",
                        functools.partial(build, t_build))
    monkeypatch.setattr(j_eval, "init_or_load_params", j_load)
    monkeypatch.setattr(t_eval, "init_or_load_params", t_load)
    monkeypatch.setattr(j_eval, "EvalConfig", functools.partial(
        j_runner.EvalConfig, max_new_tokens=MAX_NEW))
    monkeypatch.setattr(t_eval, "EvalConfig", functools.partial(
        t_runner.EvalConfig, max_new_tokens=MAX_NEW))

    def run(argv):
        """JAX's main, then the port's, on ``argv`` with ``--tiny``; each
        writes under its own output name (``{out}`` in argv)."""
        want = j_eval.main([a.format(out="j") for a in argv] + ["--tiny"])
        got = t_eval.main([a.format(out="t") for a in argv]
                          + ["--tiny", "--device", "cpu"])
        assert devices[-1] == "cpu"
        return got, want
    return run


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("inputs")
    rng = np.random.default_rng(21)
    write_tsv(root / "mmbench_dev_en.tsv", mmbench_rows(rng))
    (root / "images").mkdir()
    for name in ("a.jpg", "b.png"):
        noise_image(rng, 40, 28).save(root / "images" / name)
    (root / "mmvet.json").write_text(json.dumps({
        "q0": {"imagename": "a.jpg", "question": OPEN_QUESTIONS[0]},
        "q1": {"imagename": "b.png", "question": OPEN_QUESTIONS[1]}}))
    (root / "docvqa.json").write_text(json.dumps({"data": [
        {"questionId": 1, "question": OPEN_QUESTIONS[2], "image": "a.jpg",
         "answers": ["42"]},
        {"questionId": 2, "question": OPEN_QUESTIONS[3], "image": "b.png",
         "answers": ["may 10", "10 may"]}]}))
    for v in range(3):
        vdir = root / "videos" / f"vid-{v}"
        (vdir / "img").mkdir(parents=True)
        for i in range(3):
            noise_image(rng, 48, 32).save(vdir / "img" / f"{i:08d}.jpg")
        (vdir / "groundtruth.txt").write_text(
            "4,4,16,12\n6,5,16,12\n8,6,16,12\n")
    return root


def _read(path):
    with open(path) as f:
        return f.read()


@pytest.mark.parametrize("mode", [["--use_beam_search", "True"],
                                  ["--speculative", "2"]],
                         ids=["beam5", "speculative2"])
@pytest.mark.parametrize("bench", ["mmbench", "mmvet", "docvqa"])
def test_file_benchmarks_match_jax(clis, inputs, tmp_path, bench, mode):
    files = {"mmbench": ["--eval_file", str(inputs / "mmbench_dev_en.tsv"),
                         "--limit", "4"],
             "mmvet": ["--eval_file", str(inputs / "mmvet.json"),
                       "--eval_image_dir", str(inputs / "images")],
             "docvqa": ["--eval_file", str(inputs / "docvqa.json"),
                        "--eval_image_dir", str(inputs / "images")]}
    got, want = clis(["--benchmark", bench, *files[bench], *mode,
                      "--eval_output", str(tmp_path / "{out}.json")])
    assert got == want
    for suffix in ("", "_scores"):
        path = tmp_path / f"t{suffix}.json"
        if bench != "mmvet" or not suffix:
            assert _read(path) == _read(tmp_path / f"j{suffix}.json")
    answers = json.loads(_read(tmp_path / "t.json"))
    texts = [a["prediction"] for a in answers] if bench == "mmbench" \
        else list(answers.values())
    assert any(texts) and len(texts) == (4 if bench == "mmbench" else 2)


def test_limit_and_single_match_jax(clis, inputs, tmp_path):
    got, want = clis(["--benchmark", "mmvet", "--limit", "1",
                      "--eval_file", str(inputs / "mmvet.json"),
                      "--eval_image_dir", str(inputs / "images"),
                      "--speculative", "2",
                      "--eval_output", str(tmp_path / "{out}.json")])
    assert got == want and list(got) == ["q0"]
    got, want = clis(["--benchmark", "single", "--speculative", "2",
                      "--image", str(inputs / "images" / "a.jpg"),
                      "--question", OPEN_QUESTIONS[1]])
    assert got == want and got


def test_sampled_runs_repeat(clis, inputs, tmp_path):
    """The CLI's default decode samples: the port's two runs agree (C32);
    JAX's run writes the same files, of other sampled words."""
    argv = ["--benchmark", "docvqa", "--eval_file",
            str(inputs / "docvqa.json"), "--eval_image_dir",
            str(inputs / "images")]
    clis(argv + ["--eval_output", str(tmp_path / "{out}.json")])
    t_eval.main(argv + ["--tiny", "--device", "cpu", "--eval_output",
                        str(tmp_path / "t2.json")])
    first = json.loads(_read(tmp_path / "t.json"))
    assert json.loads(_read(tmp_path / "t2.json")) == first
    assert list(first) == list(json.loads(_read(tmp_path / "j.json")))


def test_box_repl_reads_stdin_as_jax(clis, inputs, monkeypatch, capsys):
    line = f"{inputs / 'images' / 'a.jpg'} ; {OPEN_QUESTIONS[0]}\nquit\n"
    outs = []
    for run in ("jax", "torch"):
        monkeypatch.setattr(sys, "stdin", io.StringIO(line))
        if run == "jax":
            assert j_eval.main(["--benchmark", "box", "--tiny",
                                "--speculative", "2"]) is None
        else:
            assert t_eval.main(["--benchmark", "box", "--tiny", "--device",
                                "cpu", "--speculative", "2"]) is None
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and outs[1].strip()


def test_chunked_tracking_and_merge_match_jax(clis, inputs, tmp_path):
    base = ["--benchmark", "tracking", "--speculative", "2",
            "--eval_image_dir", str(inputs / "videos")]
    serial, want = clis(base + ["--eval_output", str(tmp_path / "{out}")])
    assert serial == want and serial["videos"] == 3
    for idx in range(2):
        clis(base + ["--num-chunks", "2", "--chunk-idx", str(idx),
                     "--eval_output", str(tmp_path / "{out}_chunks")])
    merge = ["--benchmark", "tracking", "--merge-chunks", "--eval_output"]
    got = t_eval.main(merge + [str(tmp_path / "t_chunks")])
    assert got == j_eval.main(merge + [str(tmp_path / "j_chunks")])
    assert got["videos"] == 3 and got["mean_iou"] == serial["mean_iou"]
    assert got["success_auc"] == serial["success_auc"]
    for name in sorted(os.listdir(tmp_path / "t_chunks")):
        with open(tmp_path / "t_chunks" / name, "rb") as f, \
                open(tmp_path / "j_chunks" / name, "rb") as g:
            assert pickle.load(f) == pickle.load(g)


def test_python_m_entry_point(inputs, tmp_path):
    """``python -m merlin_tpu_torch.engine.eval`` in a subprocess: the tiny
    model on the CPU over DocVQA."""
    env = dict(os.environ, PYTHONPATH=ROOT, HF_HUB_OFFLINE="1",
               TRANSFORMERS_OFFLINE="1")
    out = tmp_path / "doc.json"
    cmd = [sys.executable, "-m", "merlin_tpu_torch.engine.eval",
           "--benchmark", "docvqa", "--tiny", "--device", "cpu",
           "--speculative", "2", "--eval_file", str(inputs / "docvqa.json"),
           "--eval_image_dir", str(inputs / "images"), "--eval_output",
           str(out)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                          cwd=tmp_path, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "docvqa result" in proc.stderr
    assert list(json.loads(_read(out))) == ["1", "2"]
    assert json.loads(_read(tmp_path / "doc_scores.json"))["n"] == 2
