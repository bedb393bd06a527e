"""The benchmark's manifest (``BENCHMARK.json`` at the checkout's root) and
the files it names.

Everything that belongs to one configuration, traffic mix or metric sits in
a file of its own, found by the name the manifest gives it:

  * a configuration: ``configs/<name>.json`` (the ``file`` of its entry),
    whose ``family`` (``dense`` where it names none) names
    ``families/<family>.py``, the decoder family;
  * a traffic mix: ``traffic/<traffic>.json``, whose ``driver`` names
    ``drivers/<driver>.py``;
  * a metric (end-to-end or per-layer): ``metrics/<name>.py`` or, where no
    such file exists, ``metrics/<stem>.py`` with ``stem`` the part of the
    name before its first dot (``ttft_p90_ms`` and ``idle_share.decode``
    read with ``metrics/idle_share.py``). A reader module has one function,
    ``read(record) -> float | None``.

A later cell, mix, configuration or metric is added by new files and new
manifest entries alone. Names and units outside the manifest's alphabet are
refused here, before anything runs.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Any, Dict, List

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


class ManifestError(ValueError):
    pass


def _name(value, what: str) -> str:
    if not isinstance(value, str) or not NAME.fullmatch(value):
        raise ManifestError(f"{what}: {value!r} is not a name (letters, "
                            "digits, _ . -; at most 64, not starting with "
                            ". or -)")
    return value


def _line(value, what: str) -> str:
    if (not isinstance(value, str) or not 1 <= len(value) <= 200
            or "\n" in value or "\t" in value):
        raise ManifestError(f"{what}: 1 to 200 characters on one line")
    return value


def validate(m: Dict[str, Any]) -> Dict[str, Any]:
    """Refuse a manifest whose keys, names, units or references are not
    what the harness reads."""
    if set(m) != KEYS:
        raise ManifestError(f"manifest keys {sorted(m)}, want {sorted(KEYS)}")
    configs = {}
    for c in m["configs"]:
        configs[_name(c["name"], "config")] = c
        _line(c["source"], f"{c['name']}.source")
        for key in c["reduced"]:
            _name(key, f"{c['name']}.reduced")
    cells = set()
    for w in m["workloads"]:
        _name(w["name"], "workload")
        _name(w["traffic"], f"{w['name']}.traffic")
        if w["config"] not in configs:
            raise ManifestError(f"{w['name']}: unknown config {w['config']}")
        if w["chips"] not in (1, 4):
            raise ManifestError(f"{w['name']}: chips must be 1 or 4")
        _line(w["why"], f"{w['name']}.why")
        cells.add(w["name"])
    seen = set()
    for kind in ("end_to_end", "per_layer"):
        for metric in m[kind]:
            name = _name(metric["name"], kind)
            if name in seen:
                raise ManifestError(f"metric {name} named twice")
            seen.add(name)
            if not UNIT.fullmatch(metric["unit"]):
                raise ManifestError(f"{name}: unit {metric['unit']!r}")
            if metric["better"] not in ("lower", "higher"):
                raise ManifestError(f"{name}: better is lower or higher")
            unknown = set(metric.get("workloads", ())) - cells
            if unknown:
                raise ManifestError(f"{name}: unknown cells {sorted(unknown)}")
            if kind == "per_layer":
                _line(metric["layer"], f"{name}.layer")
    return m


def load(path: Path = CHECKOUT / "BENCHMARK.json") -> Dict[str, Any]:
    with open(path) as f:
        return validate(json.load(f))


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(m: Dict[str, Any], name: str, root: Path = CHECKOUT
         ) -> Dict[str, Any]:
    """Everything one cell runs with: its manifest entry, its configuration
    and traffic files, its decoder family's module, its driver's path and
    its metrics of each kind."""
    work = next((w for w in m["workloads"] if w["name"] == name), None)
    if work is None:
        raise ManifestError(f"no workload {name!r} in the manifest")
    centry = next(c for c in m["configs"] if c["name"] == work["config"])
    with open(root / centry["file"]) as f:
        config = json.load(f)
    with open(root / "portbench" / "traffic" / f"{work['traffic']}.json") as f:
        traffic = json.load(f)
    driver = root / "portbench" / "drivers" / f"{_name(traffic['driver'], 'driver')}.py"
    family = _name(config.get("family", "dense"), f"{centry['name']}.family")
    return {
        "workload": work, "config": config, "traffic": traffic,
        "family": load_module(root / "portbench" / "families"
                              / f"{family}.py"),
        "driver": driver,
        "end_to_end": [x for x in m["end_to_end"] if _applies(x, name)],
        "per_layer": [x for x in m["per_layer"] if _applies(x, name)],
    }


def reader_path(metric: str, root: Path = CHECKOUT) -> Path:
    base = root / "portbench" / "metrics"
    own = base / f"{metric}.py"
    return own if own.exists() else base / f"{metric.split('.')[0]}.py"


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "portbench_" + re.sub(r"\W", "_", path.stem), path)
    if spec is None or not path.exists():
        raise ManifestError(f"no module at {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def readers(metrics: List[Dict[str, Any]], root: Path = CHECKOUT):
    """name -> read function of each metric."""
    return {m["name"]: load_module(reader_path(m["name"], root)).read
            for m in metrics}
