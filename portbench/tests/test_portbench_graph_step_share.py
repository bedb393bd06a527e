"""``graph_step_share``'s reader on synthetic records and span stores: the
share of busy steps whose decode issue replayed the program's captured
decode step."""

from __future__ import annotations

import pytest

from merlin_tpu_torch.utils import profiling
from portbench import manifest, spans
from portbench.record import Record

NS = 1_000_000_000


def _span(name, a, b, parent=None):
    return profiling.Span(name, int(a * NS), int(b * NS), parent, None, 1)


class _Store:
    def __init__(self, records):
        self.snap = profiling.SpanSnapshot(records, 0)

    def spans(self):
        return self.snap


def _steps(times, issued):
    """Busy steps of 100 ms at ``times``, each a decode issue whose layer
    stack is a replay of the captured step ("replay"), the eager layers
    with the program's eager-chunk mark ("eager"), or the eager layers of
    a program that marks neither (None)."""
    steps, records = [], []
    for t, how in zip(times, issued):
        steps.append((t, t + 0.1, 32))
        records += [_span("merlin.engine.decode", t + 0.01, t + 0.02,
                          "merlin.engine.step"),
                    _span("merlin.decoder.layers", t + 0.011, t + 0.019,
                          "merlin.engine.decode")]
        if how == "replay":
            records.append(_span("merlin.engine.graph_replay", t + 0.012,
                                 t + 0.018, "merlin.decoder.layers"))
        elif how == "eager":
            records.append(_span("merlin.engine.eager_chunk", t + 0.0195,
                                 t + 0.0195, "merlin.engine.decode"))
    return steps, sorted(records, key=lambda s: s.end_ns)


@pytest.mark.parametrize("metric", ["graph_step_share.decode",
                                    "graph_step_share.prefill"])
@pytest.mark.parametrize("issued, share", [
    (["replay"] * 4, 100.0),
    (["replay", "eager", "eager", "replay"], 50.0),
    (["eager"] * 4, 0.0),
    ([None] * 4, None)])
def test_graph_step_share(monkeypatch, metric, issued, share):
    steps, records = _steps([11.0, 12.0, 13.0, 14.0], issued)
    monkeypatch.setattr(spans, "_PROFILING", _Store(records))
    rec = Record(lm={"num_hidden_layers": 4}, page_bytes=2.0,
                 window=(10.0, 20.0), requests=[], steps=steps)
    read = manifest.load_module(manifest.reader_path(metric)).read
    assert read(rec) == (share if share is None else pytest.approx(share))
    # a checkout of the program without a span store reads nothing
    monkeypatch.setattr(spans, "_PROFILING", None)
    assert read(rec) is None
