"""Fixtures of the benchmark's CPU tests: narrow configurations that take
the serving cells' path (the port's entry points, patched to narrow widths
and a narrow tower), and traffic scaled to a CPU."""

from __future__ import annotations

import copy
import dataclasses
import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_LM = {
    "hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
    "num_attention_heads": 4, "vocab_size": 1500, "rms_norm_eps": 1e-6,
    "mm_tokens": 3,
}


def tiny_config(name: str) -> dict:
    """A cell's configuration file with the decoder narrowed."""
    with open(ROOT / "portbench" / "configs" / f"{name}.json") as f:
        config = json.load(f)
    config.update(TINY_LM)
    return config


@pytest.fixture(autouse=True)
def few_threads():
    """Test workers share the machine's cores: two threads each."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def narrow_port(monkeypatch):
    """The port's entry points give the narrow decoder and tower."""
    from merlin_tpu_torch.models import families, vision_builder
    from merlin_tpu_torch.models.vit import tiny_vit

    real = families.config_from_name

    def narrow(name, **kw):
        cfg = real(name, **kw)
        return dataclasses.replace(
            cfg, hidden_size=64, intermediate_size=128, num_layers=2,
            num_heads=4, max_position_embeddings=512)

    monkeypatch.setattr(families, "config_from_name", narrow)
    monkeypatch.setattr(vision_builder, "default_vision_config",
                        lambda kind, size, dtype=torch.bfloat16:
                        tiny_vit(dtype=dtype))


def tiny_traffic(name: str, **over) -> dict:
    """A traffic file scaled to a CPU: 4 slots of 256 tokens, pages of
    16, short prompts and answers."""
    with open(ROOT / "portbench" / "traffic" / f"{name}.json") as f:
        traffic = json.load(f)
    traffic = copy.deepcopy(traffic)
    traffic["engine"].update(slots=4, max_len=256, page_size=16,
                             prompt_bucket=16, pipeline=2)
    traffic["prompt_len"].update(low=20, high=60)
    traffic["output_len"].update(low=8, high=16)
    if "first_wave_output_len" in traffic:
        traffic["first_wave_output_len"].update(low=1, high=16)
        traffic.update(clients=4, pool=32)
    if "rate" in traffic:
        traffic.update(rate=8.0, lead_in_s=0.25, block=2, grace_s=60.0)
    traffic.update(check_sample=3, check_min_tokens=10, trace_seconds=0.5)
    traffic.update(over)
    return traffic


def tiny_cell(config: str, traffic: str, **over) -> dict:
    t = tiny_traffic(traffic, **over)
    return {"config": tiny_config(config), "traffic": t,
            "driver": ROOT / "portbench" / "drivers" / f"{t['driver']}.py"}
