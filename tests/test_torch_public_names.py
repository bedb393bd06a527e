"""The port's public names and launch recipes against the JAX package's.

  * ``merlin_tpu_torch.build_model_tokenizer`` and ``merlin_tpu_torch.train``
    (the package's entry points, imported on first call as in
    ``merlin_tpu/__init__.py``): the tiny bundle's config field by field as
    JAX's, and the call reaching ``engine.train.train``;
  * ``utils.profiling``: ``trace`` writes a trace file on the CPU with an
    ``annotate`` span in it, and refuses to trace the card where there is
    none; ``StepTimer`` and ``train_step_flops`` against JAX's, the one
    stated difference being the peak the utilization is taken against (one
    H100's dense bf16 989e12 where JAX takes a v5e's 197e12);
  * ``keyword_hit`` / ``truncate_at_keywords`` (``generate/decode.py``)
    on ``tests/test_generate.py``'s cases and more, and
    ``make_replace_token`` (``data/packing.py``), against JAX's;
  * the port's recipes, ``playground/merlin_torch/clip-large+conv+
    vicuna-v15-7b/*.sh``: every command parses through the port's parsers
    field for field as the JAX recipe's command parses through JAX's (the
    port's ``--device`` aside), torchrun with a process a card where JAX
    shards over 8 with ``--mesh_fsdp 8``.
"""

import argparse
import dataclasses
import json
import os
import pathlib
import re
import shlex
import subprocess
import sys

import jax.numpy as jnp
import pytest
import torch

import merlin_tpu
from merlin_tpu.data.packing import make_replace_token as j_make_replace_token
from merlin_tpu.generate.decode import keyword_hit as j_keyword_hit
from merlin_tpu.generate.decode import (
    truncate_at_keywords as j_truncate_at_keywords)
from merlin_tpu.train.arguments import parse_args as j_parse_args
from merlin_tpu.utils import profiling as j_profiling

import merlin_tpu_torch
from merlin_tpu_torch.data.packing import make_replace_token
from merlin_tpu_torch.generate.decode import keyword_hit, truncate_at_keywords
from merlin_tpu_torch.train.arguments import parse_args
from merlin_tpu_torch.utils import profiling

ROOT = pathlib.Path(__file__).resolve().parents[1]
RECIPE = "clip-large+conv+vicuna-v15-7b"


def _same(jval, tval, where):
    """Every field of JAX's dataclass (recursively) equal in the port's;
    dtypes by name."""
    if dataclasses.is_dataclass(jval):
        for f in dataclasses.fields(jval):
            _same(getattr(jval, f.name), getattr(tval, f.name),
                  f"{where}.{f.name}")
    elif where.endswith(".dtype"):
        assert jnp.dtype(jval).name == str(tval).replace("torch.", ""), where
    else:
        assert jval == tval, (where, jval, tval)


# ---------------------------------------------------------------------------
# the package's entry points
# ---------------------------------------------------------------------------

def test_entry_points_import_nothing_until_called():
    """``import merlin_tpu_torch`` leaves the builder and the training
    engine unimported, as ``import merlin_tpu`` does."""
    code = ("import sys, merlin_tpu_torch as m; "
            "print(callable(m.build_model_tokenizer), callable(m.train), "
            "'merlin_tpu_torch.models.builder' in sys.modules, "
            "'merlin_tpu_torch.engine.train' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.split() == ["True", "True", "False", "False"]


def test_build_model_tokenizer_gives_jax_config():
    jb = merlin_tpu.build_model_tokenizer(*j_parse_args([]), tiny=True)
    tb = merlin_tpu_torch.build_model_tokenizer(*parse_args([]), tiny=True)
    _same(jb.config, tb.config, "config")
    assert tb.orig_vocab_size == jb.orig_vocab_size
    assert all(p.device.type == "meta" for p in tb.model.parameters())


def test_train_reaches_engine_train():
    """``merlin_tpu_torch.train`` calls ``engine.train.train`` with what it
    was given. Importing a training module then binds the name to the
    ``train`` package, as ``import merlin_tpu.train.arguments`` does in
    JAX's package."""
    code = ("import types, merlin_tpu_torch as m; entry = m.train; "
            "import merlin_tpu_torch.engine.train as e; "
            "e.train = lambda *a, **k: ('entry', a, k); "
            "print(entry(['--output_dir', 'x'], tiny=True, device='cpu')); "
            "print(isinstance(m.train, types.ModuleType))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.splitlines() == [
        "('entry', (['--output_dir', 'x'],), {'tiny': True, 'device': "
        "'cpu'})", "True"]
    assert isinstance(merlin_tpu.train, type(sys))


# ---------------------------------------------------------------------------
# utils/profiling
# ---------------------------------------------------------------------------

def test_trace_writes_a_cpu_trace_with_annotate_spans(tmp_path):
    with profiling.trace(str(tmp_path), device="cpu") as prof:
        with profiling.annotate("merlin-step"):
            torch.ones(64, 64).matmul(torch.ones(64, 64))
    assert prof is not None
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "merlin-step" in names
    assert any(n and "mm" in n for n in names)


def test_trace_on_the_card_refuses_without_one(tmp_path, monkeypatch):
    """The card's trace does not fall back to tracing the host alone."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with profiling.trace(str(tmp_path)):
            pass
    assert not list(tmp_path.glob("*.json"))


class _Clock:
    def __init__(self, times):
        self.times = list(times)

    def __call__(self):
        return self.times.pop(0)


@pytest.mark.parametrize("tokens,flops", [(0, 0.0), (4096, 0.0),
                                          (4096, 3.2e15)])
def test_step_timer_matches_jax(monkeypatch, tokens, flops):
    """Both timers over the same clock: equal stats at the same peak, and
    at the default peaks the utilization differs by 197e12 / 989e12 only."""
    ticks = [0.0, 1.5, 2.75, 4.5, 5.0, 7.25]
    runs = {}
    for name, mod, kw in (("jax", j_profiling, {}),
                          ("port", profiling, {}),
                          ("port_at_jax_peak", profiling,
                           {"peak_flops": 197e12})):
        monkeypatch.setattr(mod.time, "perf_counter", _Clock(ticks))
        timer = mod.StepTimer(tokens_per_step=tokens, flops_per_step=flops,
                              window=3, **kw)
        runs[name] = [timer.tick() for _ in ticks]
    assert runs["port_at_jax_peak"] == runs["jax"]
    assert profiling.PEAK_BF16_FLOPS == 989e12
    for got, want in zip(runs["port"], runs["jax"]):
        assert set(got) == set(want)
        for key in want:
            if key == "mfu":
                assert got[key] == pytest.approx(want[key] * 197e12 / 989e12,
                                                 rel=1e-12)
            else:
                assert got[key] == want[key]


@pytest.mark.parametrize("remat", [True, False])
def test_train_step_flops_matches_jax(remat):
    for n, t in ((7_000_000_000, 4096), (1, 1), (123_456, 2048)):
        assert profiling.train_step_flops(n, t, remat=remat) == \
            j_profiling.train_step_flops(n, t, remat=remat)


# ---------------------------------------------------------------------------
# generate/decode and data/packing helpers
# ---------------------------------------------------------------------------

KEYWORDS = [
    ("hello </s> world", ["</s>"]),          # tests/test_generate.py's
    ("hello", ["</s>"]),
    ("answer###rest", ["###"]),
    ("a ### b </s> c", ["</s>", "###"]),
    ("a </s> b ### c", ["###", "</s>"]),
    ("no stop", []),
    ("empty kw", ["", "kw"]),
    ("", ["###"]),
    ("###", ["###"]),
]


@pytest.mark.parametrize("text,keywords", KEYWORDS)
def test_keyword_helpers_match_jax(text, keywords):
    assert keyword_hit(text, keywords) == j_keyword_hit(text, keywords)
    assert truncate_at_keywords(text, keywords) == \
        j_truncate_at_keywords(text, keywords)


@pytest.mark.parametrize("n,start_end", [(0, False), (1, True), (64, False),
                                         (256, True)])
def test_make_replace_token_matches_jax(n, start_end):
    assert make_replace_token(n, start_end) == \
        j_make_replace_token(n, start_end)


# ---------------------------------------------------------------------------
# the launch recipes
# ---------------------------------------------------------------------------

class _Stop(Exception):
    """Raised where a command line's entry point would build its model."""


def _commands(path):
    """A recipe's module commands: (launcher tokens, module, flags), the
    defaults of its ``${VAR:-default}`` variables substituted and the
    trailing ``"$@"`` and ``&`` left out."""
    text = path.read_text().replace("\\\n", " ")
    env = dict(re.findall(r"^(\w+)=\$\{\w+:-([^}]*)\}", text, re.M))
    out = []
    for line in text.splitlines():
        if line.lstrip().startswith("#") or " -m " not in line:
            continue
        toks = shlex.split(line)
        i = toks.index("-m")
        flags = [re.sub(r"\$(\w+)", lambda m: env[m.group(1)], t)
                 for t in toks[i + 2:] if t not in ("$@", "&")]
        out.append((toks[:i], toks[i + 1], flags))
    return out


def _argparse_results(monkeypatch):
    """Every namespace an ArgumentParser returns from here on, in order."""
    seen = []
    known = argparse.ArgumentParser.parse_known_args

    def record(self, args=None, namespace=None):
        out = known(self, args, namespace)
        seen.append(dict(vars(out[0])))
        return out

    monkeypatch.setattr(argparse.ArgumentParser, "parse_known_args", record)
    return seen


def _stop(*args, **kwargs):
    raise _Stop(args, kwargs)


def _parse(module, flags, monkeypatch):
    """What ``python -m module flags`` parses before it builds anything:
    (its own argparse namespaces, the model/data/training arguments)."""
    from merlin_tpu.engine import eval as j_eval
    from merlin_tpu.models import builder as j_builder
    from merlin_tpu.serve import controller as j_controller
    from merlin_tpu.serve import web as j_web

    from merlin_tpu_torch.engine import eval as t_eval
    from merlin_tpu_torch.serve import controller as t_controller
    from merlin_tpu_torch.serve import web as t_web
    from merlin_tpu_torch.serve import worker as t_worker

    pkg, name = module.split(".", 1)
    port = pkg == "merlin_tpu_torch"
    if name == "engine.train":
        return [], (parse_args if port else j_parse_args)(flags)
    if name == "serve.worker" and port:
        args, *mdt = t_worker.parse_worker_args(flags)
        return [vars(args)], tuple(mdt)
    seen = _argparse_results(monkeypatch)
    monkeypatch.setattr(sys, "argv", [module] + flags)
    if name == "serve.worker":
        from merlin_tpu.serve import worker as j_worker

        monkeypatch.setattr(j_builder, "build_model_tokenizer", _stop)
        main = j_worker.main
    elif name == "engine.eval":
        mod = t_eval if port else j_eval
        monkeypatch.setattr(mod, "build_model_tokenizer", _stop)
        main = lambda: mod.main(flags)  # noqa: E731
    else:
        mod = {("serve.controller", False): j_controller,
               ("serve.controller", True): t_controller,
               ("serve.web", False): j_web, ("serve.web", True): t_web}[
                   (name, port)]
        monkeypatch.setattr(mod, "serve", _stop)
        main = mod.main
    with pytest.raises(_Stop) as stop:
        main()
    args = stop.value.args[0]
    mdt = args[:3] if name in ("serve.worker", "engine.eval") else ()
    # the worker's parse_args of its rest is JAX's train.arguments: its
    # namespaces are the dataclasses', compared through them
    return seen[:1], mdt


@pytest.mark.parametrize("script", ["pretrain.sh", "sft.sh", "eval.sh",
                                    "serve.sh"])
def test_recipe_parses_as_jax(script, monkeypatch):
    jax_cmds = _commands(ROOT / "playground" / "merlin" / RECIPE / script)
    port_path = ROOT / "playground" / "merlin_torch" / RECIPE / script
    assert os.access(port_path, os.X_OK)
    port_cmds = _commands(port_path)
    assert len(port_cmds) == len(jax_cmds) > 0
    for (jl, jm, jf), (tl, tm, tf) in zip(jax_cmds, port_cmds):
        assert tm == jm.replace("merlin_tpu.", "merlin_tpu_torch.", 1)
        fsdp = jf[jf.index("--mesh_fsdp") + 1] if "--mesh_fsdp" in jf \
            else None
        if fsdp is not None:
            # a process a card where JAX shards over the chips of a host
            assert tl == ["torchrun", "--nproc_per_node", fsdp]
        else:
            assert tl == jl == ["python"]
        with monkeypatch.context() as m:
            j_ns, j_mdt = _parse(jm, jf, m)
        with monkeypatch.context() as m:
            t_ns, t_mdt = _parse(tm, tf, m)
        assert len(j_ns) == len(t_ns)
        for jn, tn in zip(j_ns, t_ns):
            assert {k: v for k, v in tn.items() if k != "device"} == jn
            if "device" in tn:
                assert tn["device"] == "cuda"
        assert len(j_mdt) == len(t_mdt)
        for i, (jd, td) in enumerate(zip(j_mdt, t_mdt)):
            _same(jd, td, f"{tm}[{i}]")
