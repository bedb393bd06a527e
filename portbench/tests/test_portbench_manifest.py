"""The manifest: what it refuses, how a cell finds its files by name, that
a cell, a mix, a configuration, a decoder family and a metric are added by
new files and entries alone, and that nothing the benchmark runs loads JAX
or the JAX package."""

from __future__ import annotations

import copy
import json
import shutil
import subprocess
import sys

import pytest
import torch

from conftest import ROOT, tiny_traffic
from portbench import manifest

# a decoder family of new files alone: a dense decoder whose head size is
# given, not derived from the hidden size, with grouped kv heads
TOY_FAMILY = '''"""A dense decoder with a given head size and grouped kv heads."""
from pathlib import Path

from portbench import manifest
from portbench.families import dense

served_logits = manifest.load_module(
    Path(__file__).resolve().parents[1] / "reference" / "toy_gqa.py"
).served_logits
groups = dense.groups
prefill_flops, decode_flops = dense.prefill_flops, dense.decode_flops
attention_flops, kv_bytes = dense.attention_flops, dense.kv_bytes
decode_rows_bytes = dense.decode_rows_bytes


def widths(config):
    return dict(dense.widths(config), head_dim=config["head_dim"])


def build_lm(config, lm, dtype):
    from merlin_tpu_torch.models.decoder import DecoderConfig

    return DecoderConfig(
        vocab_size=lm["vocab_size"], hidden_size=lm["hidden_size"],
        intermediate_size=lm["intermediate_size"],
        num_layers=lm["num_hidden_layers"], num_heads=lm["num_heads"],
        num_kv_heads=lm["num_kv_heads"], head_dim=lm["head_dim"],
        max_position_embeddings=config["build"]["model_max_length"],
        positional=lm["positional"], rope_theta=lm["rope_theta"],
        norm_eps=lm["rms_norm_eps"], normhead=lm["normhead"], dtype=dtype)
'''
TOY_REFERENCE = '''"""Plain f32 reference of the toy family: the dense decoder's, which
takes the head size and the kv heads from the widths."""
from portbench.reference.model import served_logits  # noqa: F401
'''
TOY_WIDTHS = {"hidden_size": 64, "intermediate_size": 128,
              "num_hidden_layers": 2, "num_attention_heads": 4,
              "num_key_value_heads": 2, "head_dim": 32, "vocab_size": 1500,
              "normhead": False}


def test_the_manifest_loads_and_each_cell_finds_its_files():
    m = manifest.load()
    assert m["command"] == ["python3", "portbench/run.py"]
    for w in m["workloads"]:
        cell = manifest.cell(m, w["name"])
        assert cell["driver"].exists()
        assert cell["config"]["name"] == w["config"]
        assert {x["name"] for x in cell["end_to_end"]} >= {"setup_s"}
        assert len(cell["end_to_end"]) >= 2 and cell["per_layer"]
        readers = manifest.readers(cell["end_to_end"] + cell["per_layer"])
        assert all(callable(f) for f in readers.values())
    for c in m["configs"]:
        with open(ROOT / c["file"]) as f:
            assert json.load(f)["source"] == c["source"]


@pytest.mark.parametrize("path,value", [
    (("workloads", 0, "name"), "bad name"),
    (("workloads", 0, "traffic"), "a/b"),
    (("end_to_end", 0, "unit"), "tokens per second"),
    (("end_to_end", 0, "unit"), "µs"),
    (("per_layer", 0, "name"), "café"),
    (("configs", 0, "reduced"), ["num layers"]),
    (("end_to_end", 0, "better"), "more"),
])
def test_names_and_units_outside_the_alphabet_are_refused(path, value):
    m = copy.deepcopy(manifest.load())
    node = m
    for key in path[:-1]:
        node = node[key]
    node[path[-1]] = value
    with pytest.raises(manifest.ManifestError):
        manifest.validate(m)


def test_a_metric_named_twice_or_an_unknown_cell_is_refused():
    m = copy.deepcopy(manifest.load())
    m["per_layer"].append(dict(m["per_layer"][0]))
    with pytest.raises(manifest.ManifestError):
        manifest.validate(m)
    m = copy.deepcopy(manifest.load())
    m["per_layer"][0]["workloads"] = ["no-such-cell"]
    with pytest.raises(manifest.ManifestError):
        manifest.validate(m)


def test_a_family_outside_the_alphabet_or_without_a_file_is_refused(
        tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    m = manifest.load()
    work = m["workloads"][0]
    path = tmp_path / next(c["file"] for c in m["configs"]
                           if c["name"] == work["config"])
    config = json.loads(path.read_text())
    assert manifest.cell(m, work["name"], root=tmp_path)["family"] \
        .__file__ == str(tmp_path / "portbench" / "families" / "dense.py")
    for family in ("../drivers/closed_loop", "dense.py", "no-such-family"):
        path.write_text(json.dumps(dict(config, family=family)))
        with pytest.raises(manifest.ManifestError):
            manifest.cell(m, work["name"], root=tmp_path)


def test_a_new_cell_mix_config_and_metric_take_new_files_only(
        tmp_path, narrow_port, monkeypatch):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    m = manifest.load()
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    new = tmp_path / "portbench"
    cfg = json.loads((new / "configs" / "merlin-baichuan2-7b.json")
                     .read_text())
    cfg["name"] = "merlin-baichuan2-7b-int8pages"
    cfg["pages"] = "int8"
    (new / "configs" / "merlin-baichuan2-7b-int8pages.json").write_text(
        json.dumps(cfg))
    mix = json.loads((new / "traffic" / "closed-32-long-decode.json")
                     .read_text())
    mix["clients"] = 16
    (new / "traffic" / "closed-16-long-decode.json").write_text(
        json.dumps(mix))
    (new / "metrics" / "launches_per_step.py").write_text(
        "def read(rec):\n    return 1.0\n")
    m["configs"].append(dict(m["configs"][0], name=cfg["name"],
                             file="portbench/configs/"
                                  "merlin-baichuan2-7b-int8pages.json"))
    m["workloads"].append({"name": "baichuan2-7b.int8pages",
                           "config": cfg["name"],
                           "traffic": "closed-16-long-decode", "chips": 1,
                           "why": "16 clients over int8 pages"})
    m["per_layer"].append({"name": "launches_per_step.int8pages",
                           "unit": "launches", "better": "lower",
                           "source": "program_counter", "layer": "kernels",
                           "moves": "output_tok_s",
                           "workloads": ["baichuan2-7b.int8pages"]})
    m["end_to_end"][0]["workloads"].append("baichuan2-7b.int8pages")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    loaded = manifest.load(tmp_path / "BENCHMARK.json")
    cell = manifest.cell(loaded, "baichuan2-7b.int8pages", root=tmp_path)
    assert cell["config"]["pages"] == "int8"
    assert cell["traffic"]["clients"] == 16
    assert cell["driver"] == new / "drivers" / "closed_loop.py"
    readers = manifest.readers(cell["per_layer"], root=tmp_path)
    assert readers["launches_per_step.int8pages"](None) == 1.0

    # a decoder family, its reference and a configuration naming it, with
    # bf16 leaves: run on the CPU through the harness's own path
    (new / "families" / "toy_gqa.py").write_text(TOY_FAMILY)
    (new / "reference" / "toy_gqa.py").write_text(TOY_REFERENCE)
    toy = json.loads((new / "configs" / "merlin-baichuan2-7b.json")
                     .read_text())
    toy.update(TOY_WIDTHS, name="toy-gqa", family="toy_gqa",
               weights="bf16")
    (new / "configs" / "toy-gqa.json").write_text(json.dumps(toy))
    m["configs"].append(dict(m["configs"][0], name="toy-gqa",
                             file="portbench/configs/toy-gqa.json"))
    m["workloads"].append({"name": "toy-gqa.decode", "config": "toy-gqa",
                           "traffic": "closed-32-long-decode", "chips": 1,
                           "why": "a decoder family of new files"})
    m["end_to_end"][0]["workloads"].append("toy-gqa.decode")
    m["per_layer"].append({"name": "mfu.toy", "unit": "%",
                           "better": "higher", "source": "host_clock",
                           "layer": "whole step", "moves": "output_tok_s",
                           "workloads": ["toy-gqa.decode"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    cell = manifest.cell(manifest.load(tmp_path / "BENCHMARK.json"),
                         "toy-gqa.decode", root=tmp_path)
    assert cell["family"].__file__ == str(new / "families" / "toy_gqa.py")
    assert cell["family"].widths(cell["config"])["head_dim"] == 32
    cell["traffic"] = tiny_traffic("closed-32-long-decode")

    from portbench import run, serving

    leaf_dtypes = set()
    real_build = serving.build_model

    def build_model(family, config, seed, device):
        model = real_build(family, config, seed, device)
        leaf_dtypes.update(p.dtype for p in model.parameters())
        return model
    monkeypatch.setattr(serving, "build_model", build_model)
    for trace in (False, True):
        result = run.run_cell(cell, 3_000_000_017, 2.0, trace, "cpu")
        assert result["correct"] and result["failed"] == 0, result
        assert result["attempted"] > 0
        kind = "mfu.toy" if trace else "output_tok_s"
        assert result["metrics"][kind]["value"] > 0, result
    assert leaf_dtypes == {torch.bfloat16}

    # the files already there are unchanged
    for rel, data in before.items():
        assert (tmp_path / rel).read_bytes() == data


WIDTH_KEYS = ("hidden_size", "intermediate_size", "num_attention_heads",
              "num_key_value_heads", "num_heads", "num_kv_heads", "head_dim")


def test_only_the_families_and_their_references_name_a_decoders_widths():
    """A new decoder is new files under ``families/`` and ``reference/``:
    no other module of the harness reads a decoder's widths."""
    base = ROOT / "portbench"
    for path in sorted(base.rglob("*.py")):
        rel = path.relative_to(base)
        if rel.parts[0] in ("families", "reference", "tests"):
            continue
        text = path.read_text()
        named = [k for k in WIDTH_KEYS if f'"{k}"' in text]
        assert not named, (str(rel), named)


# every module of the decoder families and of the references, as they are
# in the tree
FAMILIES_AND_REFERENCES = """
import importlib, pathlib
for sub in ("families", "reference"):
    for p in sorted(pathlib.Path("portbench", sub).glob("*.py")):
        importlib.import_module(f"portbench.{sub}.{p.stem}"
                                if p.stem != "__init__" else
                                f"portbench.{sub}")
"""
IMPORTS = """
import sys
sys.argv = ["x"]
from portbench import run, controls, sweep, check, serving, trace
from portbench.drivers import closed_loop, open_loop
""" + FAMILIES_AND_REFERENCES + """
import merlin_tpu_torch.serve.engine, merlin_tpu_torch.models.builder
print(run.forbidden_modules())
"""


def test_nothing_the_benchmark_runs_loads_jax_or_the_jax_package():
    out = subprocess.run([sys.executable, "-c", IMPORTS], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_check_compares_whole_top_level_names():
    code = ("import sys, types; from portbench import run; "
            "sys.modules['merlin_tpu_torch_x'] = types.ModuleType('m'); "
            "print(run.forbidden_modules()); "
            "sys.modules['merlin_tpu.models'] = types.ModuleType('m'); "
            "print(run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.stdout.split() == ["[]", "['merlin_tpu']"], out.stderr


def test_the_reference_imports_nothing_of_the_program():
    """Nor do the decoder families, which the check loads."""
    code = ("import sys; import portbench.weights, portbench.check"
            + FAMILIES_AND_REFERENCES
            + "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'merlin_tpu_torch', 'merlin_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.stdout.strip() == "[]", out.stderr
