"""A whole run of each serving cell on the CPU at narrow widths: the
harness's look for a card is skipped, the rest of a run is driven, and a
timed path broken underneath makes ``correct`` come out false."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from conftest import ROOT, tiny_cell

CELLS = [("baichuan2-7b.decode", "merlin-baichuan2-7b",
          "closed-32-long-decode"),
         ("baichuan-13b-int8.prefill", "merlin-baichuan-13b-int8",
          "open-poisson-long-prompt")]
SEED = 3_000_000_017          # more than 32 signed bits hold


def cell_for(name, config, traffic, **over):
    from portbench import manifest

    m = manifest.load()
    cell = manifest.cell(m, name)
    cell.update(tiny_cell(config, traffic, **over))
    return cell


@pytest.mark.parametrize("name,config,traffic", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_a_run_prints_its_metrics_and_is_correct(narrow_port, name, config,
                                                 traffic, trace):
    from portbench import run

    cell = cell_for(name, config, traffic)
    result = run.run_cell(cell, SEED, 2.0, trace, "cpu")
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    kind = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in cell[kind]}
    # a CPU run has no device trace: those readers find nothing to read
    device_only = {m["name"] for m in cell[kind]
                   if m["source"] == "device_trace"}
    assert names - device_only <= set(result["metrics"]) <= names
    assert list(result)[-1] == "checks"
    json.dumps(result)
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def _altered_token(monkeypatch):
    from merlin_tpu_torch.serve import engine

    real = engine.ServingEngine._pick

    def pick(self, logits, temps, sample):
        out = real(self, logits, temps, sample)
        return (out + 1) % logits.shape[-1]
    monkeypatch.setattr(engine.ServingEngine, "_pick", pick)


def _state_unchanged(monkeypatch):
    """Decode steps that leave the cache's lengths where they were."""
    from merlin_tpu_torch.serve import engine

    real = engine.ServingEngine._decode_one

    def decode(self, tokens, active, temps, sample):
        lengths = self.cache["lengths"]
        out = real(self, tokens, active, temps, sample)
        self.cache["lengths"] = lengths
        return out
    monkeypatch.setattr(engine.ServingEngine, "_decode_one", decode)


def _half_batch(monkeypatch):
    """Decode steps that serve half of the slots (the even ones) and hand
    the others their previous token."""
    from merlin_tpu_torch.serve import engine

    real = engine.ServingEngine._decode_one

    def decode(self, tokens, active, temps, sample):
        out = real(self, tokens, active, temps, sample)
        odd = torch.arange(out.shape[0], device=out.device) % 2 == 1
        return torch.where(odd, tokens, out)
    monkeypatch.setattr(engine.ServingEngine, "_decode_one", decode)


@pytest.mark.parametrize("name,config,traffic", CELLS)
@pytest.mark.parametrize("fault", [_altered_token, _state_unchanged,
                                   _half_batch])
def test_a_broken_timed_path_is_not_correct(narrow_port, monkeypatch, name,
                                            config, traffic, fault):
    from portbench import run

    fault(monkeypatch)
    # every finished request is compared: a fault in some slots only
    # cannot hide behind the sample
    result = run.run_cell(cell_for(name, config, traffic, check_sample=1000),
                          SEED, 2.0, False, "cpu")
    assert not result["correct"], result["checks"]


def _dropped_request(monkeypatch):
    """The first request handed to the engine is never served (as if the
    engine lost it), and nothing reports it."""
    from merlin_tpu_torch.serve import engine

    real = engine.ServingEngine.submit
    dropped = []

    def submit(self, input_ids, **kw):
        req = real(self, input_ids, **kw)
        if not dropped:
            with self._lock:
                self._queue.remove(req)
            dropped.append(req)
        return req
    monkeypatch.setattr(engine.ServingEngine, "submit", submit)


@pytest.mark.parametrize("name,config,traffic", CELLS)
def test_a_request_never_served_is_not_correct(narrow_port, monkeypatch,
                                               name, config, traffic):
    from portbench import run

    cell = cell_for(name, config, traffic, grace_s=2.0)
    # the warm-up's requests go first, unharmed
    from portbench import serving
    real_warm_up = serving.warm_up

    def warm_up(engine, lengths, vocab):
        real_warm_up(engine, lengths, vocab)
        _dropped_request(monkeypatch)
    monkeypatch.setattr(serving, "warm_up", warm_up)
    result = run.run_cell(cell, SEED, 4.0, False, "cpu")
    assert not result["correct"], result["checks"]
    assert result["failed"] >= 1, result


def test_without_a_card_a_run_exits_nonzero_and_prints_nothing():
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "baichuan2-7b.decode", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    if torch.cuda.is_available():
        pytest.skip("a card is here: the refusal is for machines without")
    assert proc.returncode == 3
    assert proc.stdout == ""


@pytest.mark.parametrize("name,config,traffic", CELLS)
def test_the_control_reads_far_above_the_program(narrow_port, name, config,
                                                 traffic):
    from portbench import controls

    cell = cell_for(name, config, traffic)
    r = controls.readings(cell, SEED, 2.0, 3, "cpu")
    assert r["program_correct"], r
    assert set(r["controls"]) == set(cell["config"]["controls"])
    for c in r["controls"].values():
        # the verdict of a run, at the configuration's own limit
        assert not c["correct"], r
        assert c["gap"] > cell["config"]["gap_limit"] >= r["program_gap"]
        assert c["gap"] >= 3 * r["program_gap"], r
