"""The dense family held to the numbers the harness gave before decoder
families existed, when ``check.lm_widths``, ``weights.lm_groups``, the
yardstick's counts and ``reference.model.served_logits`` were called
directly (computed with those functions, and pinned here): the groups at
published widths, three groups' draws and the reference's logits at the
tests' narrow widths, the work counts at three lengths, and the three
readers that count work, on one hand-built record with a fake trace. Every
number is compared exactly; a tensor by the SHA-256 of its bytes."""

from __future__ import annotations

import hashlib
import json
import math

import numpy as np
import pytest

from conftest import ROOT, tiny_config
from portbench import manifest, weights
from portbench.record import Record, Req, Trace

SEED = 3_000_000_017
DRAWN = ("lm.embed", "lm.layer1", "lm.head")
READERS = ("mfu.decode", "paged_decode_roofline.decode",
           "flash_fwd_roofline.prefill")
CONFIGS = ("merlin-baichuan2-7b", "merlin-baichuan-13b-int8")

# fmt: off
PINNED = {'merlin-baichuan2-7b': {'widths': {'hidden_size': 4096,
                                    'intermediate_size': 11008,
                                    'num_hidden_layers': 32,
                                    'num_heads': 32,
                                    'num_kv_heads': 32,
                                    'head_dim': 128,
                                    'vocab_size': 125699,
                                    'rms_norm_eps': 1e-06,
                                    'positional': 'rope',
                                    'rope_theta': 10000.0,
                                    'normhead': True},
                         'groups': {'n': 34,
                                    'params': 7505997824,
                                    'sha256': '082f01d2299f9b2aa824fa5c0c98f4a4feea9065acde3e3b93acd02c878dc4bb'},
                         'counts': {1: {'prefill_flops': 13982261248.0,
                                        'decode_flops': 13982261248.0,
                                        'attention_flops': 524288.0,
                                        'kv_bytes_2': 524288.0,
                                        'kv_bytes_1': 270336.0},
                                    777: {'prefill_flops': 10223209701376.0,
                                          'decode_flops': 14389108736.0,
                                          'attention_flops': 158467620864.0,
                                          'kv_bytes_2': 407371776.0,
                                          'kv_bytes_1': 210051072.0},
                                    2048: {'prefill_flops': 27626796244992.0,
                                           'decode_flops': 15055478784.0,
                                           'attention_flops': 1100048498688.0,
                                           'kv_bytes_2': 1073741824.0,
                                           'kv_bytes_1': 553648128.0}},
                         'decode_rows_bytes': 524288,
                         'readers': {'mfu.decode': 0.4192649481887968,
                                     'paged_decode_roofline.decode': 51.73384559421952,
                                     'flash_fwd_roofline.prefill': 19.132600305846402},
                         'draws': {'lm.embed': '594aefc321dc9d668b4f408fda9d72c6713279e1abfedb924f35ae9775785380',
                                   'lm.layer1': '089821e52aa37a333b71343b336f49ccd6f1aefe3cee80e0b45e78a258ee0910',
                                   'lm.head': '6137ac2ebb53d2bbda1efb06d324c47f848f45fbec2f6d9f97e6543b5a40949c'},
                         'served_logits': {'f32': [((14, 1503),
                                                    'd235126df8516761eae17c852415af3d681fb2d4670bb202acd6d8fb7e70ebbb'),
                                                   ((13, 1503),
                                                    'ccd0e621d5d1d00bc0de554407470e3b24a9df06575efa899fe1c2a3aa46a5d8')],
                                           'fp8': [((14, 1503),
                                                    '5d1525235b1b6751db7c03900e4e57b0be88e5e1ec187b5d0d59f8dea9041029'),
                                                   ((13, 1503),
                                                    '7a37400eaf4175100f6a89e7412f577cfb78b6f56b17a3c120e525717a097505')]}},
 'merlin-baichuan-13b-int8': {'widths': {'hidden_size': 5120,
                                         'intermediate_size': 13696,
                                         'num_hidden_layers': 40,
                                         'num_heads': 40,
                                         'num_kv_heads': 40,
                                         'head_dim': 128,
                                         'vocab_size': 64003,
                                         'rms_norm_eps': 1e-06,
                                         'positional': 'alibi',
                                         'rope_theta': 10000.0,
                                         'normhead': False},
                              'groups': {'n': 42,
                                         'params': 13264931840,
                                         'sha256': 'd3d0450b5d896a88fa4e7e493b5980eb2e7368c831c9444ebf69a4a6dae3c18a'},
                              'counts': {1: {'prefill_flops': 25874462720.0,
                                             'decode_flops': 25874462720.0,
                                             'attention_flops': 819200.0,
                                             'kv_bytes_2': 819200.0,
                                             'kv_bytes_1': 422400.0},
                                         777: {'prefill_flops': 19842843473920.0,
                                               'decode_flops': 26510161920.0,
                                               'attention_flops': 247605657600.0,
                                               'kv_bytes_2': 636518400.0,
                                               'kv_bytes_1': 328204800.0},
                                         2048: {'prefill_flops': 53366462904320.0,
                                                'decode_flops': 27551365120.0,
                                                'attention_flops': 1718825779200.0,
                                                'kv_bytes_2': 1677721600.0,
                                                'kv_bytes_1': 865075200.0}},
                              'decode_rows_bytes': 819200,
                              'readers': {'mfu.decode': 0.8116813307340748,
                                          'paged_decode_roofline.decode': 33.361547212741755,
                                          'flash_fwd_roofline.prefill': 29.894687977885006},
                              'draws': {'lm.embed': '594aefc321dc9d668b4f408fda9d72c6713279e1abfedb924f35ae9775785380',
                                        'lm.layer1': '089821e52aa37a333b71343b336f49ccd6f1aefe3cee80e0b45e78a258ee0910',
                                        'lm.head': 'b9902b6f3921a5555652d0140be4e7520132df9ca907e605ad7c2c205b7e2670'},
                              'served_logits': {'int8': [((14, 1503),
                                                          '003821e4f1807171b5186833a0f0e13ec376daabf62ab2f1f2ac2646e41c17ea'),
                                                         ((13, 1503),
                                                          'd07eb563a8c70bd7bf2b88168a8f21935eba6aa7fa7f80d3936dd37721ecf2f7')],
                                                'int4': [((14, 1503),
                                                          'c1e8e2a1b227103d805480dd68a1aca10584b965cd99676c9e6a215f88e5c16d'),
                                                         ((13, 1503),
                                                          'd0454b70e42d82849089f47b2fd70c98d1814a905f8048f4681bf456469088d9')],
                                                'fp8': [((14, 1503),
                                                         '476dad691f07e5a8eef5874609d7e941e2479c809d543b9226b1f8c99865f288'),
                                                        ((13, 1503),
                                                         '023c4f73b7681dfd2c2d8d9305b0943c4f54eae4565486afd8b11a5a9201225d')]}}}
# fmt: on


def published(name):
    with open(ROOT / "portbench" / "configs" / f"{name}.json") as f:
        return json.load(f)


def family_of(name):
    """The family the manifest's cell of configuration ``name`` runs."""
    m = manifest.load()
    work = next(w for w in m["workloads"] if w["config"] == name)
    return manifest.cell(m, work["name"])["family"]


def tensor_digest(named):
    h = hashlib.sha256()
    for name, t in named:
        h.update(name.encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(str(t.dtype).encode())
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def hand_record(lm, family, page_bytes):
    """Three requests of 300, 1000 and 1800 prompt tokens, twelve busy
    steps, and a trace of two steps' B3 launches and three B2 launches."""
    reqs = []
    for k, (p, n) in enumerate(((300, 4), (1000, 5), (1800, 6))):
        first = 1.0 + k
        times = [first + 0.05 * j for j in range(n)]
        reqs.append(Req(prompt_len=p, max_new=n, first=first, done=True,
                        tokens=list(range(1, n + 1)), token_times=times))
    steps = [(1.0 + 0.5 * i, 1.1 + 0.5 * i, 2) for i in range(12)]
    device = [("paged_rows_kernel<128>", 100.0 + 20.0 * i, 10.0 + i % 3)
              for i in range(2 * lm["num_hidden_layers"])]
    device += [("flash_attention_fwd_kernel<128>", 5e5 + 1e4 * i,
                2000.0 + i) for i in range(3)]
    device += [("nvjet_gemm", 9e5, 50.0)]
    tr = Trace(device=device, host=[], span=(0.0, 1e7),
               host_span=(0.0, 10.0))
    return Record(lm=lm, family=family, page_bytes=page_bytes,
                  window=(0.0, 10.0), requests=reqs, steps=steps, trace=tr)


@pytest.mark.parametrize("name", CONFIGS)
def test_groups_at_published_widths(name):
    family, want = family_of(name), PINNED[name]
    lm = family.widths(published(name))
    assert lm == want["widths"]
    groups = family.groups(lm)
    canon = json.dumps([[g, [[n, list(s), i] for n, s, i in leaves]]
                        for g, leaves in groups.items()])
    assert len(groups) == want["groups"]["n"]
    assert sum(math.prod(s) for leaves in groups.values()
               for _, s, _ in leaves) == want["groups"]["params"]
    assert hashlib.sha256(canon.encode()).hexdigest() == \
        want["groups"]["sha256"]


@pytest.mark.parametrize("name", CONFIGS)
def test_draws_and_reference_logits_at_narrow_widths(name):
    family, want = family_of(name), PINNED[name]
    config = tiny_config(name)
    lm = family.widths(config)
    groups = family.groups(lm)
    for g in DRAWN:
        w = weights.make_group(SEED, g, groups[g], "cpu")
        assert tensor_digest([(n, w[n]) for n, _, _ in groups[g]]) == \
            want["draws"][g], g

    def group(g):
        return weights.make_group(SEED, g, groups[g], "cpu")
    rng = np.random.default_rng(5)
    seqs = [{"ids": rng.integers(0, lm["vocab_size"], size=30),
             "prompt_len": 17},
            {"ids": rng.integers(0, lm["vocab_size"], size=21),
             "prompt_len": 9}]
    precisions = [config["precision"], *config["controls"]]
    logits = family.served_logits(lm, group, seqs, precisions,
                                  config["pages"] == "int8", "cpu")
    got = {p: [(tuple(r.shape), tensor_digest([("rows", r)]))
               for r in rows] for p, rows in zip(precisions, logits)}
    assert got == want["served_logits"]


@pytest.mark.parametrize("name", CONFIGS)
def test_work_counts_at_three_lengths(name):
    family, want = family_of(name), PINNED[name]
    lm = family.widths(published(name))
    for n, counts in want["counts"].items():
        assert family.prefill_flops(lm, n) == counts["prefill_flops"], n
        assert family.decode_flops(lm, n) == counts["decode_flops"], n
        assert family.attention_flops(lm, n) == counts["attention_flops"], n
        assert family.kv_bytes(lm, n, 2) == counts["kv_bytes_2"], n
        assert family.kv_bytes(lm, n, 1) == counts["kv_bytes_1"], n
    assert family.decode_rows_bytes(lm) == want["decode_rows_bytes"]


@pytest.mark.parametrize("name", CONFIGS)
def test_work_count_readers_on_a_hand_built_record(name):
    family, want = family_of(name), PINNED[name]
    config = published(name)
    rec = hand_record(family.widths(config), family,
                      {"bf16": 2, "int8": 1}[config["pages"]])
    for metric in READERS:
        read = manifest.load_module(manifest.reader_path(metric)).read
        assert read(rec) == want["readers"][metric], metric
