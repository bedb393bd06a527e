"""The manifest: what it refuses, how a cell finds its files by name, that
a cell, a mix, a configuration and a metric are added by new files and
entries alone, and that nothing the benchmark runs loads JAX or the JAX
package."""

from __future__ import annotations

import copy
import json
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT
from portbench import manifest


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


def test_a_new_cell_mix_config_and_metric_take_new_files_only(tmp_path):
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
    # the files already there are unchanged
    for rel, data in before.items():
        assert (tmp_path / rel).read_bytes() == data


IMPORTS = """
import sys
sys.argv = ["x"]
from portbench import run, controls, sweep, check, serving, trace
from portbench.drivers import closed_loop, open_loop
from portbench.reference import model
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
    code = ("import sys; import portbench.reference.model, "
            "portbench.weights, portbench.check; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'merlin_tpu_torch', 'merlin_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.stdout.strip() == "[]", out.stderr
