"""The port's data cursor against the JAX package on the CPU
(``tests/test_data_resume.py``'s cases): ``ResumableSampleStream``'s
continuation after ``set_state`` equals the uninterrupted stream and JAX's,
a state JAX wrote loads into the port, the dataset-level and batch-level
cursors; and C35, the sampler position the port's cursor adds (JAX's
resumed run repeats the sampler's order from its start).
"""

import json

import numpy as np
import pytest

from merlin_tpu.data import builder as j_builder
from merlin_tpu.data import collator as j_collator
from merlin_tpu.data import registry as j_registry
from merlin_tpu.data import shards as j_shards
from merlin_tpu.data import webdatasets as j_web
from merlin_tpu.models.builder import (
    _tiny_tokenizer_with_mm_tokens as j_tiny_tok)

from merlin_tpu_torch.data import builder as t_builder
from merlin_tpu_torch.data import collator as t_collator
from merlin_tpu_torch.data import registry as t_registry
from merlin_tpu_torch.data import shards as t_shards
from merlin_tpu_torch.data import webdatasets as t_web
from merlin_tpu_torch.models.builder import (
    _tiny_tokenizer_with_mm_tokens as t_tiny_tok)

from test_data_resume import _make_tagged_shard
from test_torch_data_pipeline import assert_samples_equal


@pytest.fixture()
def shard_set(tmp_path):
    paths = []
    for t in "abcd":
        p = tmp_path / f"{t}.tar"
        _make_tagged_shard(p, t, n=10)
        paths.append(str(p))
    return paths


def _keys(stream, n):
    return [next(stream)["__key__"] for _ in range(n)]


def _roundtrip(state):
    return json.loads(json.dumps(state))


@pytest.mark.parametrize("buf,head", [(8, 17), (4, 3), (16, 41)])
def test_stream_resume_exact(shard_set, buf, head):
    ref = t_shards.ResumableSampleStream(shard_set, sample_buffer=buf)
    jref = j_shards.ResumableSampleStream(shard_set, sample_buffer=buf)
    assert _keys(ref, head) == _keys(jref, head)
    state = _roundtrip(ref.get_state())
    assert state == _roundtrip(jref.get_state())
    expected = _keys(ref, 15)
    assert expected == _keys(jref, 15)

    fresh = t_shards.ResumableSampleStream(shard_set, sample_buffer=buf)
    fresh.set_state(state)
    assert _keys(fresh, 15) == expected


def test_state_written_by_jax_loads_into_the_port(shard_set):
    jref = j_shards.ResumableSampleStream(shard_set, sample_buffer=8)
    _ = _keys(jref, 23)
    state = _roundtrip(jref.get_state())
    expected = _keys(jref, 20)
    port = t_shards.ResumableSampleStream(shard_set, sample_buffer=8)
    port.set_state(state)
    assert _keys(port, 20) == expected
    assert _roundtrip(port.get_state()) == _roundtrip(jref.get_state())


def test_stream_resume_mid_shard_cursor(shard_set):
    stream = t_shards.ResumableSampleStream(shard_set, sample_buffer=4)
    _ = _keys(stream, 3)
    st = stream.get_state()
    assert st["shard_pos"] >= 0
    assert 0 < st["raw_idx"] <= 10 or st["shard_pos"] > 0
    assert len(st["buffer"]) == 4


def test_stream_matches_nonresumable(shard_set, monkeypatch):
    monkeypatch.setenv("MERLIN_NATIVE_LOADER", "0")
    a = t_shards.ResumableSampleStream(shard_set, sample_buffer=8)
    b = iter(t_shards.shard_sample_stream(shard_set, sample_buffer=8,
                                          use_native=False))
    keys = _keys(a, 30)
    assert keys == _keys(b, 30)
    assert keys == _keys(iter(j_shards.shard_sample_stream(
        shard_set, sample_buffer=8, use_native=False)), 30)


def _pair_ds(web, registry, tok, ids, shard_set, merge_round=2, size=40):
    spec = registry.WebdataSpec(path=shard_set[0].replace("a.tar", "*.tar"),
                                size=size, merge_round=merge_round)
    return web.PairWebDataset(
        "synthetic", tok, ids,
        web.MultimodalCfg(image_token_len=2, image_size=16),
        model_max_length=128, spec=spec, resumable=True)


def test_dataset_resume_identical_next_batch(shard_set):
    """Save the cursor, rebuild the dataset, restore: the next packed
    sample is identical, and equal to JAX's."""
    out = {}
    for name, tiny, web, registry in (("jax", j_tiny_tok, j_web, j_registry),
                                      ("torch", t_tiny_tok, t_web,
                                       t_registry)):
        tok, ids, _ = tiny(256)
        ds = _pair_ds(web, registry, tok, ids, shard_set)
        for _ in range(5):
            _ = ds[0]
        state = _roundtrip(ds.data_state())
        expected = ds[0]
        # the same tokenizer: its ids are assigned lazily, and it is not
        # part of the stream cursor
        ds2 = _pair_ds(web, registry, tok, ids, shard_set)
        ds2.load_data_state(state)
        out[name] = (state, expected, ds2[0])
    state, expected, got = out["torch"]
    assert_samples_equal(got, expected)
    assert state == out["jax"][0]
    assert_samples_equal(got, out["jax"][2])


def test_batch_iterator_tags_state(shard_set):
    """Batches carry the cursor taken after their samples: the streams'
    state (JAX's tag) and the indices drawn."""
    tags = {}
    for name, tiny, web, registry, builder, collator in (
            ("jax", j_tiny_tok, j_web, j_registry, j_builder, j_collator),
            ("torch", t_tiny_tok, t_web, t_registry, t_builder,
             t_collator)):
        tok, ids, _ = tiny(256)
        ds = _pair_ds(web, registry, tok, ids, shard_set, merge_round=1)
        col = collator.Collator(pad_id=tok.pad_token_id, max_length=64,
                                image_size=16)
        it = builder.batch_iterator(ds, col, batch_size=2)
        tags[name] = [next(it) for _ in range(3)]
    for got, want in zip(tags["torch"], tags["jax"]):
        g, w = dict(got), dict(want)
        gs, ws = g.pop("__data_state__"), w.pop("__data_state__")
        assert_samples_equal(g, w)
        assert _roundtrip(gs["streams"]) == _roundtrip(ws)
    states = [b["__data_state__"] for b in tags["torch"]]
    assert [s["indices"] for s in states] == [2, 4, 6]
    assert states[0]["streams"] != states[1]["streams"]


def test_batch_iterator_start_skips_indices():
    """``start`` skips that many sampler indices, so a map-style dataset
    continues where the cursor left it."""
    class Echo:
        def __len__(self):
            return 5

        def __getitem__(self, i):
            return dict(input_ids=np.full(3, i, np.int32),
                        labels=np.full(3, i, np.int32),
                        segment_ids=np.zeros(3, np.int32),
                        images=np.zeros((1, 4, 4, 3), np.uint8),
                        num_images=1)

    col = t_collator.Collator(pad_id=0, max_length=4, image_size=4)
    first = t_builder.batch_iterator(Echo(), col, batch_size=2)
    rows = [next(first)["input_ids"][:, 0].tolist() for _ in range(4)]
    assert rows == [[0, 1], [2, 3], [4, 0], [1, 2]]
    later = t_builder.batch_iterator(Echo(), col, batch_size=2, start=4)
    batch = next(later)
    assert batch["input_ids"][:, 0].tolist() == [4, 0]
    assert batch["__data_state__"] == {"indices": 6}


def _concat(web, registry, builder, conv_mod, tok, ids, shard_set, ann):
    registry.register("conversation", "synthetic_resume_conv",
                      registry.ConversationSpec(annotations=ann))
    cfg = web.MultimodalCfg(image_token_len=2, image_size=16)
    return builder.ConcatDataset([
        conv_mod.ConversationDataset("synthetic_resume_conv", tok, ids, cfg,
                                     model_max_length=128),
        _pair_ds(web, registry, tok, ids, shard_set, merge_round=2,
                 size=16)])


def test_c35_sampler_position_resumes_exactly(shard_set, tmp_path):
    """C35: a conversation set and a stream behind the modality sampler.
    Resumed after 3 batches, the port's next batch is the 4th of an
    uninterrupted run; JAX's cursor holds the stream only, so its sampler
    starts over and its next batch is not."""
    from merlin_tpu.data import conversation_dataset as j_conv
    from merlin_tpu.data import sampler as j_sampler
    from merlin_tpu_torch.data import conversation_dataset as t_conv
    from merlin_tpu_torch.data import sampler as t_sampler

    ann = tmp_path / "conv.json"
    ann.write_text(json.dumps([
        {"conversations": [{"from": "human", "value": f"question {i}"},
                           {"from": "gpt", "value": f"answer {i}"}]}
        for i in range(8)]))
    fourth = {}
    for name, tiny, web, registry, builder, conv_mod, samp, col_mod in (
            ("jax", j_tiny_tok, j_web, j_registry, j_builder, j_conv,
             j_sampler, j_collator),
            ("torch", t_tiny_tok, t_web, t_registry, t_builder, t_conv,
             t_sampler, t_collator)):
        tok, ids, _ = tiny(128)

        def pipeline(state=None):
            ds = _concat(web, registry, builder, conv_mod, tok, ids,
                         shard_set, str(ann))
            sampler = samp.LengthGroupedSampler(
                1, 1, ds.modality_lengths, group_by_modality=True, seed=3)
            col = col_mod.Collator(pad_id=tok.pad_token_id, max_length=128,
                                   max_images=2, image_size=16)
            kw = {}
            if state is not None and name == "torch":
                kw["start"] = t_builder.resume_data(ds, state)
            elif state is not None:
                ds.load_data_state(state)
            return builder.batch_iterator(ds, col, batch_size=2,
                                          sampler=sampler, **kw)

        run = pipeline()
        batches = [next(run) for _ in range(4)]
        state = _roundtrip(batches[2]["__data_state__"])
        resumed = next(pipeline(state))
        fourth[name] = (batches[3], resumed)
    for name, (want, got) in fourth.items():
        same = all(np.array_equal(got[k], want[k]) for k in
                   ("input_ids", "labels", "images"))
        assert same == (name == "torch"), name
    assert_samples_equal(
        {k: v for k, v in fourth["torch"][1].items() if k[0] != "_"},
        {k: v for k, v in fourth["jax"][0].items() if k[0] != "_"})
