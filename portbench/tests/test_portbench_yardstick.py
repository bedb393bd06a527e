"""The yardstick's arithmetic and the dense family's work counts on
hand-worked shapes, and the readers on records and traces built by hand."""

from __future__ import annotations

import pytest

from portbench import manifest, trace, yardstick
from portbench.families import dense
from portbench.record import Record, Req, Trace

LM = {"hidden_size": 8, "num_heads": 2, "num_kv_heads": 2, "head_dim": 4,
      "intermediate_size": 16, "num_hidden_layers": 3, "vocab_size": 100,
      "normhead": False}


def reader(name):
    return manifest.load_module(manifest.reader_path(name)).read


def test_operation_and_byte_counts():
    # q, k, v, o: 4 x 8 x 8; gate, up, down: 3 x 8 x 16
    assert dense.layer_matmul_params(LM) == 4 * 64 + 3 * 128
    # 5 tokens through 3 layers, the head on 1 of them
    assert dense.token_flops(LM, 5, 1) == 2 * (3 * 640 * 5 + 800)
    assert yardstick.causal_pairs(4) == 10
    # q.k and p.v: 2 heads x 4 dims x 2 products x 2 FLOPs, 3 layers
    assert dense.pair_flops(LM, 10) == 4 * 2 * 4 * 3 * 10
    # a prompt of 4 tokens: 10 causal pairs
    assert dense.attention_flops(LM, 4) == dense.pair_flops(LM, 10)
    assert dense.prefill_flops(LM, 4) == \
        dense.token_flops(LM, 4, 1) + dense.pair_flops(LM, 10)
    assert dense.decode_flops(LM, 7) == \
        dense.token_flops(LM, 1, 1) + dense.pair_flops(LM, 7)
    # K and V, 3 layers, 2 heads of 4 values: bf16, and int8 + f32 scale
    assert dense.kv_bytes(LM, 10, 2) == 2 * 3 * 2 * 8 * 10
    assert dense.kv_bytes(LM, 10, 1) == 2 * 3 * 2 * (4 + 4) * 10
    # q and output rows of one decode token, bf16, 3 layers
    assert dense.decode_rows_bytes(LM) == 2 * 2 * 4 * 2 * 3
    assert yardstick.bound_s(989e12, 0) == pytest.approx(1.0)
    assert yardstick.bound_s(0, 3.35e12) == pytest.approx(1.0)


def record(**kw):
    base = dict(lm=LM, family=dense, page_bytes=2, window=(0.0, 10.0),
                requests=[], steps=[])
    base.update(kw)
    return Record(**base)


def test_latency_and_rate_readers():
    reqs = [Req(prompt_len=4, max_new=3, due=d, submitted=d + 0.001,
                first=d + f, last=d + f + 0.2, done=True,
                tokens=[1, 2, 3], token_times=[d + f, d + f + 0.1,
                                               d + f + 0.2])
            for d, f in ((1.0, 0.1), (2.0, 0.2), (3.0, 0.3), (20.0, 9.0))]
    rec = record(requests=reqs)
    # requests due in the window: 0.1, 0.2, 0.3 s to their first token
    assert reader("ttft_p90_ms")(rec) == pytest.approx(280.0)
    assert reader("ttft_p50_ms")(rec) == pytest.approx(200.0)
    assert reader("tpot_p90_ms")(rec) == pytest.approx(100.0)
    assert reader("tpot_p90_ms.prefill")(rec) == pytest.approx(100.0)
    assert reader("sched_lag_p90_ms")(rec) == pytest.approx(1.0)
    assert reader("output_tok_s")(rec) == pytest.approx(9 / 10.0)


def test_mfu_counts_prefills_and_decode_steps():
    req = Req(prompt_len=4, max_new=3, first=1.0, done=True,
              tokens=[1, 2, 3], token_times=[1.0, 2.0, 3.0])
    rec = record(requests=[req])
    work = dense.prefill_flops(LM, 4) + dense.decode_flops(LM, 5) \
        + dense.decode_flops(LM, 6)
    assert reader("mfu.decode")(rec) == pytest.approx(
        100 * work / (10 * 989e12))
    # a traced run: only the part the profiler left alone counts
    rec.perturbed = (1.5, 2.5)
    work = dense.prefill_flops(LM, 4) + dense.decode_flops(LM, 6)
    assert reader("mfu.decode")(rec) == pytest.approx(
        100 * work / (9 * 989e12))


def test_step_readers_skip_idle_steps():
    rec = record(steps=[(1.0, 1.1, 4), (2.0, 2.3, 2), (3.0, 3.0005, 0)])
    assert reader("engine_step_wall_ms.decode")(rec) == pytest.approx(200.0)
    assert reader("slots_active_mean.decode")(rec) == pytest.approx(3.0)


def test_pages_share_over_the_window_the_profiler_left_alone():
    rec = record(pages_reserved=100,
                 pages_used=[(-0.5, 90), (2.0, 10), (4.0, 30), (6.0, 50),
                             (11.0, 90)])
    # after the steps that end in the window: 10, 30, 50 of 100
    assert reader("pages_used_share.decode")(rec) == pytest.approx(30.0)
    rec.perturbed = (3.0, 5.0)
    assert reader("pages_used_share.prefill")(rec) == pytest.approx(30.0)
    rec.perturbed = (5.0, 7.0)
    assert reader("pages_used_share.decode")(rec) == pytest.approx(20.0)
    assert reader("pages_used_share.decode")(record()) is None


def test_a_closed_loop_request_that_never_finishes_fails():
    from portbench import run

    # busy steps of 0.1 s; a pipeline of 2: (max_new + 4) steps allowed
    steps = [(0.1 * i, 0.1 * i + 0.1, 4) for i in range(100)]
    reqs = [Req(prompt_len=4, max_new=10, submitted=-1.0),      # first wave
            Req(prompt_len=4, max_new=10, submitted=8.5),       # in time
            Req(prompt_len=4, max_new=10, submitted=8.7),       # still due
            Req(prompt_len=4, max_new=10, submitted=1.0, done=True),
            Req(prompt_len=4, max_new=3, submitted=2.0, error="rejected")]
    rec = record(requests=reqs, steps=steps)
    failed = run.failures(rec, reqs, pipeline=2)
    assert [reqs.index(r) for r in failed] == [0, 1, 4]
    # a traced run: the profiled stretch is allowed on top
    rec.perturbed = (3.0, 4.0)
    assert [reqs.index(r) for r in run.failures(rec, reqs, 2)] == [0, 4]
    # an open loop's request due by the close and never done fails, also
    # one due in the lead-in, before the window opened
    late = [Req(prompt_len=4, max_new=10, due=d, submitted=d)
            for d in (9.9, -2.0)]
    assert run.failures(record(requests=late), late, 2) == late


def synthetic_trace():
    device = [("paged_rows_kernel<128>", 100.0, 10.0),
              ("nvjet_gemm", 105.0, 20.0),       # overlaps: busy 100-125
              ("direct_copy_kernel_cuda", 150.0, 10.0),
              ("paged_rows_kernel<128>", 190.0, 10.0),
              ("outside", 300.0, 5.0)]
    host = [("portbench.step", 90.0, 120.0),
            ("cudaStreamSynchronize", 126.0, 20.0)]
    return Trace(device=device, host=host, span=(90.0, 210.0),
                 host_span=(0.0, 10.0))


def test_trace_reductions():
    tr = synthetic_trace()
    assert trace.busy_intervals(tr.device, tr.span) == [
        (100.0, 125.0), (150.0, 160.0), (190.0, 200.0)]
    assert trace.busy_us(tr) == 45.0
    assert trace.family_us(tr, yardstick.GEMM_KEYS + yardstick.CAST_KEYS) \
        == 30.0
    assert trace.top_ops(tr)[0] == ["paged_rows_kernel<128>", 20e-6]
    gaps = trace.idle_gaps(tr)
    assert gaps[0] == ["portbench.step / python between operations",
                       pytest.approx(30e-6)]
    assert gaps[1] == ["portbench.step / cudaStreamSynchronize",
                       pytest.approx(25e-6)]
    rec = record(trace=tr)
    assert reader("idle_share.decode")(rec) == pytest.approx(
        100 * (1 - 45 / 120))


def test_paged_roofline_from_the_traffic_record():
    lm = dict(LM, num_hidden_layers=1)
    req = Req(prompt_len=10, max_new=3, first=1.0, done=True,
              tokens=[1, 2, 3], token_times=[1.0, 2.0, 3.0])
    tr = synthetic_trace()
    rec = record(lm=lm, requests=[req], trace=tr,
                 steps=[(1.5, 1.6, 1), (2.5, 2.6, 1)])
    # two decode tokens over 11 and 12 keys, two steps: one step's need
    rows = 2 * 2 * 4 * 2
    need = (dense.kv_bytes(lm, 11, 2) + dense.kv_bytes(lm, 12, 2)
            + 2 * rows) / 2
    # B3: 2 launches of 10 us, a launch a step (one layer)
    assert reader("paged_decode_roofline.decode")(rec) == pytest.approx(
        100 * need / 3.35e12 / 10e-6)
