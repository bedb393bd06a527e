"""The traffic generators: the same seed gives the same requests; every
seed gives the same lengths and gaps in each block, in its own order."""

from __future__ import annotations

import json

import numpy as np
import pytest

from conftest import ROOT
from portbench import serving
from portbench.drivers import closed_loop, open_loop

BIG = 2 ** 40 + 12345     # seeds run past 32 signed bits


def traffic(name):
    with open(ROOT / "portbench" / "traffic" / f"{name}.json") as f:
        return json.load(f)


def flat(reqs):
    return [(r.prompt_len, r.max_new, round(r.due, 9), r.ids.tolist())
            for r in reqs]


@pytest.mark.parametrize("seed", [7, BIG])
def test_closed_loop_requests_repeat_from_a_seed(seed):
    t = traffic("closed-32-long-decode")
    a = closed_loop.requests(t, seed, 125696)
    b = closed_loop.requests(t, seed, 125696)
    assert [flat(x) for x in a] == [flat(x) for x in b]
    wave, pool = a
    assert len(wave) == t["clients"] and len(pool) == t["pool"] - t["clients"]
    assert all(256 <= r.prompt_len <= 1024 for r in pool)
    assert all(384 <= r.max_new <= 768 for r in pool)
    assert all(1 <= r.max_new <= 768 for r in wave)


def test_closed_loop_seeds_share_lengths_in_each_block():
    t = traffic("closed-32-long-decode")
    (w1, p1), (w2, p2) = (closed_loop.requests(t, s, 125696)
                          for s in (7, BIG))
    block = t["block"]
    assert sorted(r.max_new for r in w1) == sorted(r.max_new for r in w2)
    for i in range(0, 128, block):
        for key in ("prompt_len", "max_new"):
            assert sorted(getattr(r, key) for r in p1[i:i + block]) == \
                sorted(getattr(r, key) for r in p2[i:i + block])
    assert [r.prompt_len for r in p1] != [r.prompt_len for r in p2]
    assert not np.array_equal(p1[0].ids[:8], p2[0].ids[:8])


@pytest.mark.parametrize("seed", [7, BIG])
def test_open_loop_schedule_repeats_and_fills_the_window_alike(seed):
    t = traffic("open-poisson-long-prompt")
    a = open_loop.schedule(t, seed, 50, 64000)
    assert flat(a) == flat(open_loop.schedule(t, seed, 50, 64000))
    other = open_loop.schedule(t, seed + 1, 50, 64000)
    lead = t["lead_in_s"]

    def window(reqs):
        return [r for r in reqs if lead <= r.due <= lead + 50]
    for reqs in (a, other):
        w = window(reqs)
        assert len(w) == round(t["rate"] * 50)
    assert sorted(r.prompt_len for r in window(a)) == \
        sorted(r.prompt_len for r in window(other))
    assert sorted(r.max_new for r in window(a)) == \
        sorted(r.max_new for r in window(other))
    assert [r.due for r in a] != [r.due for r in other]
    gaps = np.diff([0.0] + [r.due for r in a])
    assert gaps.min() > 0 and abs(gaps.mean() - 1 / t["rate"]) < 0.01


def test_stratified_blocks_hold_the_quantiles():
    rng = np.random.default_rng(0)
    x = serving.stratified(rng, 25, 10, lambda q: q)
    assert len(x) == 25
    assert sorted(x[:10]) == pytest.approx((np.arange(10) + 0.5) / 10)
    assert sorted(x[10:20]) == pytest.approx((np.arange(10) + 0.5) / 10)
    uni = serving.quantile_fn({"dist": "uniform", "low": 16, "high": 64})
    log = serving.quantile_fn({"dist": "loguniform", "low": 256,
                               "high": 1024})
    assert uni(np.array([0.0, 0.999])).tolist() == [16, 64]
    assert log(np.array([0.0, 0.5, 1.0])).tolist() == [256, 512, 1024]
