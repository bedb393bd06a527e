"""The readers of the program's spans (``portbench/spans.py`` and the
metrics that read it) on synthetic records and span stores; the map from
the store's clock into a traced stretch's, under a CPU profiler; and which
reader sets turn the program's spans on."""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import pytest

from conftest import ROOT

from merlin_tpu_torch.utils import profiling
from portbench import manifest, spans
from portbench.record import Record, Trace

NS = 1_000_000_000


def _span(name, a, b, parent=None, req=None, thread=1):
    return profiling.Span(name, int(a * NS), int(b * NS), parent, req, thread)


class _Store:
    def __init__(self, records, dropped=0):
        self.snap = profiling.SpanSnapshot(records, dropped)

    def spans(self):
        return self.snap


@pytest.fixture
def store(monkeypatch):
    def put(records, dropped=0):
        monkeypatch.setattr(spans, "_PROFILING", _Store(records, dropped))
    return put


def _reader(name):
    return manifest.load_module(manifest.reader_path(name)).read


def _record(steps, window=(10.0, 20.0), perturbed=None, layers=4,
            trace=None):
    return Record(lm={"num_hidden_layers": layers}, page_bytes=2.0,
                  window=window, requests=[], steps=steps,
                  perturbed=perturbed, trace=trace)


def _decode_steps(times, n=32):
    """Busy steps of 100 ms at ``times``, each with a 60-ms decode issue
    (whose layers take 40 ms), a 2-ms read-back and, every other step, a
    3-ms first-token read-back."""
    steps, records = [], []
    for k, t in enumerate(times):
        steps.append((t, t + 0.1, n))
        records += [
            _span("merlin.engine.step", t, t + 0.1),
            _span("merlin.engine.decode", t + 0.01, t + 0.07,
                  "merlin.engine.step"),
            _span("merlin.decoder.layers", t + 0.02, t + 0.06,
                  "merlin.engine.decode"),
            _span("merlin.engine.readback", t + 0.08, t + 0.082,
                  "merlin.engine.drain")]
        if k % 2:
            records.append(_span("merlin.engine.first_token", t + 0.003,
                                 t + 0.006, "merlin.engine.admit"))
    return steps, records


def test_step_readers(store):
    steps, records = _decode_steps([11.0, 12.0, 13.0, 14.0])
    # a prefill's layers (not the decode's) are not the decode's issue
    records.append(_span("merlin.decoder.layers", 11.0, 11.005,
                         "merlin.engine.prefill"))
    store(sorted(records, key=lambda s: s.end_ns))
    rec = _record(steps)
    assert _reader("host_issue_ms.decode")(rec) == pytest.approx(60.0)
    assert _reader("layer_issue_us.decode")(rec) == pytest.approx(1e4)
    assert _reader("sync_wait_ms.decode")(rec) == pytest.approx(3.5)


def test_step_readers_read_the_quiet_window_only(store):
    steps, records = _decode_steps([11.0, 12.0, 15.0, 16.0])
    _, extra = _decode_steps([15.0, 16.0])
    # the profiled part (14.5-16.5) doubles the host's issue; not read
    records = [r for r in records if r.start_ns < 14 * NS] + [
        r._replace(end_ns=r.end_ns + (r.end_ns - r.start_ns))
        if r.name == "merlin.engine.decode" else r for r in extra]
    store(sorted(records, key=lambda s: s.end_ns))
    rec = _record(steps, perturbed=(14.5, 16.5))
    assert rec.quiet() == [(10.0, 14.5), (16.5, 20.0)]
    assert _reader("host_issue_ms.decode")(rec) == pytest.approx(60.0)


def test_readers_read_nothing_from_a_wrapped_store(store):
    steps, records = _decode_steps([11.0, 12.0])
    rec = _record(steps)
    store(records, dropped=3)             # its oldest kept span is in it
    for name in ("host_issue_ms.decode", "layer_issue_us.decode",
                 "sync_wait_ms.decode", "queue_wait_p50_ms.prefill",
                 "admit_ms_p50.prefill"):
        assert _reader(name)(rec) is None, name
    # wrapped, but only past spans that closed before the window
    store([_span("merlin.x", 1.0, 2.0)] + records, dropped=3)
    assert _reader("host_issue_ms.decode")(rec) == pytest.approx(60.0)


def test_readers_without_a_store_read_nothing(store, monkeypatch):
    monkeypatch.setattr(spans, "_PROFILING", None)
    steps, _ = _decode_steps([11.0])
    assert _reader("host_issue_ms.decode")(_record(steps)) is None


def _lives(submits, starts, inserts, reads):
    recs = [_span("merlin.engine.submit", t, t, req=r) for r, t in submits]
    recs += [_span("merlin.engine.prefill", a, a + 0.05,
                   "merlin.engine.admit", r) for r, a in starts]
    recs += [_span("merlin.engine.insert", a - 0.002, a,
                   "merlin.engine.admit", r) for r, a in inserts]
    recs += [_span("merlin.engine.first_token", a, b, "merlin.engine.admit")
             for a, b in reads]
    return sorted(recs, key=lambda s: s.end_ns)


def test_admission_readers(store):
    store(_lives(
        # req 0 waits 100 ms, req 1 200 ms, req 2 300 ms (and is
        # preempted: a second prefill and insert later are not read)
        submits=[(0, 11.0), (1, 11.1), (2, 12.0)],
        starts=[(0, 11.1), (1, 11.3), (2, 12.3), (2, 13.0)],
        inserts=[(0, 11.16), (1, 11.36), (2, 12.36), (2, 13.06)],
        # each token returns with the first read-back after its insert
        reads=[(11.17, 11.25), (11.37, 11.5), (12.37, 12.45),
               (13.07, 13.1)]))
    rec = _record([])
    assert _reader("queue_wait_p50_ms.prefill")(rec) == pytest.approx(200.0)
    # admissions 150, 200 and 150 ms
    assert _reader("admit_ms_p50.prefill")(rec) == pytest.approx(150.0)


def test_admission_readers_read_the_quiet_window_only(store):
    store(_lives(
        submits=[(0, 11.0), (1, 13.9), (2, 15.0), (3, 9.0)],
        starts=[(0, 11.1), (1, 14.1), (2, 15.5), (3, 10.5)],
        inserts=[(0, 11.16), (1, 14.16), (2, 15.56), (3, 10.56)],
        reads=[(11.17, 11.2), (14.17, 14.2), (15.57, 15.6),
               (10.57, 10.6)]))
    # req 1 lives into the profiled part, req 2 inside it, and req 3 was
    # submitted before the window: only req 0 is read
    rec = _record([], perturbed=(14.0, 16.0))
    assert _reader("queue_wait_p50_ms.prefill")(rec) == pytest.approx(100.0)
    assert _reader("admit_ms_p50.prefill")(rec) == pytest.approx(100.0)
    store([])
    assert _reader("queue_wait_p50_ms.prefill")(rec) is None


def _trace(device, host_span=(14.0, 17.0), offset=5e6):
    """A stretch of 3 s whose clock (us) runs ``offset`` ahead of the
    host's."""
    span = tuple(t * 1e6 + offset for t in host_span)
    return Trace(device=device, host=[], span=span, host_span=host_span)


def test_idle_in_issue_share(store):
    off = 5e6
    # the device busy 14.0-14.5 and 15.0-15.5 s: idle 2 s of 3
    device = [("k", 14.0e6 + off, 0.5e6), ("k", 15.0e6 + off, 0.5e6)]
    # the host issues 14.4-14.8 (0.3 s idle in it) and 16.0-16.5 (0.5 s)
    records = [_span("merlin.engine.decode", 14.4, 14.8),
               _span("merlin.engine.decode", 16.0, 16.5),
               _span("merlin.engine.readback", 14.5, 15.0)]
    store(records)
    rec = _record([], trace=_trace(device))
    assert _reader("idle_in_issue_share.decode")(rec) == pytest.approx(40.0)
    assert _reader("idle_in_issue_share.decode")(
        _record([], trace=_trace([]))) is None
    store(records, dropped=1)             # wrapped past the stretch
    assert _reader("idle_in_issue_share.decode")(rec) is None


def test_the_stores_clock_maps_onto_the_profilers(monkeypatch):
    """Under a CPU profiler, each span's store stamps, mapped into the
    trace's clock, sit where its ``record_function`` copy does, which
    brackets them by the profiler's own cost on either side: no drift over
    the stretch, and a shift of well under a millisecond."""
    from portbench.trace import Tracer

    profiling.enable_spans()
    tracer = Tracer(True, 0.0, 0.5)
    tracer.tick(time.perf_counter())
    names = [f"merlin.t{i}" for i in range(40)]
    for name in names:
        with profiling.annotate(name):
            sum(range(2000))
        time.sleep(0.01)
    while tracer.perturbed is None:
        tracer.tick(time.perf_counter())
    trace = tracer.result
    copies = {name: (start, start + dur) for name, start, dur in trace.host
              if name.startswith("merlin.t")}
    assert set(copies) == set(names)
    shifts = []
    for s in profiling.spans().records:
        if s.name in copies:
            a, b = copies[s.name]
            mapped = (spans.to_trace(trace, s.start_ns / NS)
                      + spans.to_trace(trace, s.end_ns / NS))
            shifts.append(mapped / 2 - (a + b) / 2)
    assert len(shifts) == len(names)
    # microseconds
    assert abs(statistics.median(shifts)) < 1000.0, shifts
    first, last = shifts[:10], shifts[-10:]
    assert abs(statistics.median(last) - statistics.median(first)) < 200.0


def _recording_after_loading(kind, cell):
    code = (
        "import sys; sys.path.insert(0, '.')\n"
        "from portbench import manifest\n"
        f"c = manifest.cell(manifest.load(), {cell!r})\n"
        f"manifest.readers(c[{kind!r}])\n"
        "from merlin_tpu_torch.utils import profiling\n"
        "print(profiling._recording)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().lower())


@pytest.mark.parametrize("cell", ["baichuan2-7b.decode",
                                  "baichuan-13b-int8.prefill"])
def test_traced_readers_turn_spans_on_and_untraced_do_not(cell):
    assert _recording_after_loading("per_layer", cell) is True
    assert _recording_after_loading("end_to_end", cell) is False
