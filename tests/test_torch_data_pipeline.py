"""The port's data pipeline against the JAX package on the CPU: the 16 cases
of ``tests/test_data_pipeline.py``, each run through JAX's function and the
port's on the same seeded inputs (tar shards, JSON, JPEGs written here),
with the outputs array-equal (the pipeline is integer and uint8 throughout,
so the tolerance is exact), and the JAX test's own assertions held on the
port's side; then the BLIP augmentations under ``random.Random(0)``.

Each package gets its own ``TinyTokenizer`` and both see the same texts in
the same order, so their lazily assigned ids agree. The native tar loader
is switched off here (``MERLIN_NATIVE_LOADER=0``): its two threads race,
so its order is not repeatable; ``test_torch_native_loader.py`` holds it.
"""

import json
import random

import numpy as np
import pytest
import torch
from PIL import Image

from merlin_tpu.data import augment as j_augment
from merlin_tpu.data import collator as j_collator
from merlin_tpu.data import conversation_dataset as j_conv
from merlin_tpu.data import packing as j_packing
from merlin_tpu.data import registry as j_registry
from merlin_tpu.data import sampler as j_sampler
from merlin_tpu.data import shards as j_shards
from merlin_tpu.data import webdatasets as j_web
from merlin_tpu.models.builder import (
    _tiny_tokenizer_with_mm_tokens as j_tiny_tok)
from merlin_tpu.utils.conversation import conv_vicuna_v1 as j_vicuna

from merlin_tpu_torch.data import augment as t_augment
from merlin_tpu_torch.data import collator as t_collator
from merlin_tpu_torch.data import conversation_dataset as t_conv
from merlin_tpu_torch.data import packing as t_packing
from merlin_tpu_torch.data import registry as t_registry
from merlin_tpu_torch.data import sampler as t_sampler
from merlin_tpu_torch.data import shards as t_shards
from merlin_tpu_torch.data import webdatasets as t_web
from merlin_tpu_torch.models.builder import (
    _tiny_tokenizer_with_mm_tokens as t_tiny_tok)
from merlin_tpu_torch.utils.constants import IGNORE_INDEX
from merlin_tpu_torch.utils.conversation import conv_vicuna_v1 as t_vicuna

from test_data_pipeline import (
    _make_interleave_shard, _make_interpair_shard, _make_pair_shard)

PACKAGES = {"jax": (j_tiny_tok, j_packing, j_web, j_registry),
            "torch": (t_tiny_tok, t_packing, t_web, t_registry)}


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    monkeypatch.setenv("MERLIN_NATIVE_LOADER", "0")
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def assert_samples_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def both(fn):
    """fn(tokenizer, special_ids, packing, webdatasets, registry) run for
    JAX then for the port; returns (jax result, port result)."""
    out = {}
    for name, (tiny, packing, web, registry) in PACKAGES.items():
        tok, ids, _ = tiny(256)
        out[name] = fn(tok, ids, packing, web, registry)
    return out["jax"], out["torch"]


def test_infinite_shard_list_deterministic():
    shards = [f"s{i}" for i in range(5)]
    a = [s for s, _ in zip(t_shards.infinite_shard_list(shards, 7),
                           range(12))]
    b = [s for s, _ in zip(j_shards.infinite_shard_list(shards, 7),
                           range(12))]
    assert a == b
    assert set(a[:5]) == set(shards)


def test_buffer_shuffle_preserves_multiset():
    items = list(range(100))
    out = list(t_shards.buffer_shuffle(iter(items), bufsize=10, seed=1))
    assert out == list(j_shards.buffer_shuffle(iter(items), bufsize=10,
                                               seed=1))
    assert sorted(out) == items and out != items


def test_tar_to_samples(tmp_path):
    shard = tmp_path / "a.tar"
    _make_pair_shard(shard, n=5)
    got = list(t_shards.tar_to_samples(iter([str(shard)])))
    want = list(j_shards.tar_to_samples(iter([str(shard)])))
    assert got == want and len(got) == 5
    assert all("jpg" in s and "txt" in s for s in got)


def test_pair_packer_golden():
    def run(tok, ids, packing, web, registry):
        packer = packing.PairPacker(tok, ids, image_token_len=2,
                                    use_im_start_end=True,
                                    model_max_length=256)
        return tok, packer.pack([(None, "a cat"), ("describe <image>",
                                                   "a dog")])

    (_, jp), (tok, packed) = both(run)
    for f in ("input_ids", "labels", "segment_ids", "num_images_used",
              "num_pairs_used"):
        np.testing.assert_array_equal(getattr(packed, f), getattr(jp, f))
    assert tok.decode(packed.input_ids).split().count("<im_patch>") == 4
    kept = [tok._inv[i] for i in
            packed.input_ids[packed.labels != IGNORE_INDEX].tolist()]
    assert "cat" in kept and "dog" in kept and "describe" not in kept
    assert "<im_patch>" not in kept and "<im_start>" not in kept
    assert kept.count("</s>") == 2
    assert set(packed.segment_ids.tolist()) == {0, 1}
    assert packed.num_images_used == 2


def test_pair_packer_overflow_clips_images():
    long_caption = " ".join(f"w{i}" for i in range(30))

    def run(tok, ids, packing, web, registry):
        packer = packing.PairPacker(tok, ids, image_token_len=2,
                                    use_im_start_end=True,
                                    model_max_length=16)
        return packer.pack([(None, "short"), (None, long_caption)])

    jp, packed = both(run)
    np.testing.assert_array_equal(packed.input_ids, jp.input_ids)
    np.testing.assert_array_equal(packed.labels, jp.labels)
    assert packed.num_pairs_used == jp.num_pairs_used == 1
    assert packed.num_images_used == jp.num_images_used == 1
    assert len(packed.input_ids) <= 16


@pytest.mark.parametrize("resumable", [False, True],
                         ids=["stream", "resumable"])
def test_pair_webdataset_end_to_end(tmp_path, resumable):
    shard = tmp_path / "pair.tar"
    _make_pair_shard(shard, n=8)

    def run(tok, ids, packing, web, registry):
        spec = registry.WebdataSpec(path=str(shard), size=8, merge_round=2)
        ds = web.PairWebDataset(
            "synthetic", tok, ids,
            web.MultimodalCfg(image_token_len=2, image_size=16),
            model_max_length=128, spec=spec, resumable=resumable)
        return ids, len(ds), [ds[0] for _ in range(4)]

    (_, jn, jsamples), (ids, n, samples) = both(run)
    assert n == jn == 4
    for got, want in zip(samples, jsamples):
        assert_samples_equal(got, want)
    assert samples[0]["images"].shape[1:] == (16, 16, 3)
    assert samples[0]["num_images"] == 2
    assert (samples[0]["input_ids"] == ids.image_patch).sum() == 4


@pytest.mark.parametrize("resumable", [False, True],
                         ids=["stream", "resumable"])
def test_interpair_end_to_end(tmp_path, resumable):
    shard = tmp_path / "inter.tar"
    _make_interpair_shard(shard, n=4)

    def run(tok, ids, packing, web, registry):
        spec = registry.WebdataSpec(path=str(shard), size=4, merge_round=2)
        ds = web.InterPairWebDataset(
            "synthetic", tok, ids,
            web.MultimodalCfg(image_token_len=2, image_size=16),
            model_max_length=512, spec=spec, resumable=resumable)
        return ids, [ds[0] for _ in range(3)]

    (_, jsamples), (ids, samples) = both(run)
    for got, want in zip(samples, jsamples):
        assert_samples_equal(got, want)
    assert samples[0]["num_images"] == 4
    assert (samples[0]["input_ids"] == ids.image_patch).sum() == 8


def test_conversation_masking_golden():
    texts = {}
    for name, vicuna in (("jax", j_vicuna), ("torch", t_vicuna)):
        conv = vicuna.copy()
        conv.append_message("USER", "what is this")
        conv.append_message("ASSISTANT", "a red cat")
        conv.append_message("USER", "and now")
        conv.append_message("ASSISTANT", "a blue dog")
        texts[name] = conv.get_prompt()
    assert texts["jax"] == texts["torch"]

    def run(tok, ids, packing, web, registry):
        mask = (t_conv if web is t_web else j_conv).mask_conversation_targets
        enc = np.asarray(tok.encode(texts["torch"]), np.int32)
        return tok, enc, mask(texts["torch"], enc, tok,
                              pad_id=tok.pad_token_id, instruction_offset=-1)

    (_, jenc, jlab), (tok, enc, labels) = both(run)
    np.testing.assert_array_equal(enc, jenc)
    np.testing.assert_array_equal(labels, jlab)
    kept = [tok._inv[i] for i in enc[labels != IGNORE_INDEX].tolist()]
    assert kept == ["a", "red", "cat", "</s>", "a", "blue", "dog", "</s>"]


def _conv_images(tmp_path):
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    Image.new("RGB", (32, 24), (10, 200, 30)).save(img_dir / "img0.jpg")
    ann = [
        {"image": "img0.jpg",
         "conversations": [
             {"from": "human", "value": "<image>\nwhere is the <box> ?"},
             {"from": "gpt", "value": "at <box>"}],
         "boxes": [[2, 2, 10, 10], [5, 5, 10, 10]]},
        {"conversations": [
            {"from": "human", "value": "hello"},
            {"from": "gpt", "value": "hi there"}]},
    ]
    ann_path = tmp_path / "ann.json"
    ann_path.write_text(json.dumps(ann))
    return str(ann_path), str(img_dir)


def test_conversation_dataset_end_to_end(tmp_path):
    ann_path, img_dir = _conv_images(tmp_path)

    def run(tok, ids, packing, web, registry):
        registry.register("conversation", "synthetic_conv",
                          registry.ConversationSpec(annotations=ann_path,
                                                    images=img_dir))
        mod = t_conv if web is t_web else j_conv
        ds = mod.ConversationDataset(
            "synthetic_conv", tok, ids,
            web.MultimodalCfg(image_token_len=2, image_size=16),
            model_max_length=128, instruction_offset=-1)
        return tok, ids, ds, [ds[0], ds[1], ds[0]]

    (_, _, jds, jsamples), (tok, ids, ds, samples) = both(run)
    for got, want in zip(samples, jsamples):
        assert_samples_equal(got, want)
    assert ds.modality_lengths == jds.modality_lengths
    assert ds.lengths == jds.lengths
    assert len(ds) == 2
    s0, s1 = samples[:2]
    assert s0["num_images"] == 1
    assert (s0["input_ids"] == ids.image_patch).sum() == 2
    assert "[" in tok.decode(s0["input_ids"])
    assert s1["num_images"] == 1 and s1["images"].sum() == 0
    assert ds.modality_lengths[0] > 0 > ds.modality_lengths[1]


def test_collator_static_shapes():
    mk = lambda n, k: dict(
        input_ids=np.arange(4, 4 + n, dtype=np.int32),
        labels=np.arange(4, 4 + n, dtype=np.int32),
        segment_ids=np.arange(n, dtype=np.int32) // 3,
        images=np.full((k, 8, 8, 3), k, np.uint8), num_images=k)
    samples = [mk(5, 1), mk(9, 2), mk(0, 1)]
    for packing_segments in (False, True):
        kw = dict(pad_id=0, max_length=32, max_images=3, image_size=8,
                  use_packing_segments=packing_segments)
        batch = t_collator.Collator(**kw)(samples)
        assert_samples_equal(batch, j_collator.Collator(**kw)(samples))
        assert batch["input_ids"].shape == (3, 32)
        assert batch["images"].shape == (3, 3, 8, 8, 3)
        assert batch["attention_mask"][0].sum() == 5
        assert batch["segment_ids"][1, :9].min() == 1
        assert batch["segment_ids"][1, 9:].max() == 0
        # the fully padded row holds no segment at all
        assert batch["segment_ids"][2].max() == 0
        # "+1 segment": the packed pairs' ids, shifted off padding's 0
        assert batch["segment_ids"][1, 8] == (3 if packing_segments else 1)


def test_modality_sampler_separates():
    lengths = [10, 20, -5, -8, 30, -2, 15, -9]
    idx = t_sampler.get_modality_length_grouped_indices(
        lengths, batch_size=2, world_size=1, rng=np.random.default_rng(0))
    assert idx == j_sampler.get_modality_length_grouped_indices(
        lengths, batch_size=2, world_size=1, rng=np.random.default_rng(0))
    assert sorted(idx) == list(range(8))
    first = [lengths[i] > 0 for i in idx[:2]]
    assert all(first) or not any(first)


def test_split_to_even_chunks_balanced():
    lengths = [10, 10, 1, 1]
    chunks = t_sampler.split_to_even_chunks([0, 1, 2, 3], lengths, 2)
    assert chunks == j_sampler.split_to_even_chunks([0, 1, 2, 3], lengths, 2)
    assert [sum(abs(lengths[i]) for i in c) for c in chunks] == [11, 11]
    assert t_sampler.split_to_even_chunks([0, 1, 2], lengths, 2) == \
        [[0, 2], [1]]


def test_length_grouped_sampler_epochs_differ():
    lengths = [5, -6, 7, 8, -9, 10, 11, 12, 3, -4]
    for modality in (False, True):
        kw = dict(group_by_modality=modality, seed=5)
        s = t_sampler.LengthGroupedSampler(2, 2, lengths, **kw)
        j = j_sampler.LengthGroupedSampler(2, 2, lengths, **kw)
        a = list(iter(s))
        assert a == list(iter(j))
        s.set_epoch(1)
        j.set_epoch(1)
        b = list(iter(s))
        assert b == list(iter(j))
        assert sorted(a) == sorted(b) == list(range(10)) and a != b


@pytest.mark.parametrize("resumable", [False, True],
                         ids=["stream", "resumable"])
def test_interleave_end_to_end(tmp_path, resumable):
    shard = tmp_path / "inter.tar"
    _make_interleave_shard(shard)

    def run(tok, ids, packing, web, registry):
        spec = registry.WebdataSpec(path=str(shard), size=4, merge_round=1)
        ds = web.InterleaveWebDataset(
            "synthetic", tok, ids,
            web.MultimodalCfg(image_token_len=2, image_size=16),
            model_max_length=128, spec=spec, resumable=resumable)
        return tok, ids, [ds[0] for _ in range(3)]

    (_, _, jsamples), (tok, ids, samples) = both(run)
    for got, want in zip(samples, jsamples):
        assert_samples_equal(got, want)
    sample = samples[0]
    assert sample["num_images"] == 1
    assert (sample["input_ids"] == ids.image_patch).sum() == 2
    text = tok.decode(sample["input_ids"])
    assert text.index("first") < text.index("<im_start>") < \
        text.index("second")
    kept = [tok._inv[i] for i in
            sample["input_ids"][sample["labels"] != IGNORE_INDEX].tolist()]
    assert "paragraph" in kept and "<im_patch>" not in kept


def test_conversation_merge_round(tmp_path):
    ann = [{"conversations": [
        {"from": "human", "value": f"q{i}"},
        {"from": "gpt", "value": f"a{i}"}]} for i in range(4)]
    ann_path = tmp_path / "merge.json"
    ann_path.write_text(json.dumps(ann))

    def run(tok, ids, packing, web, registry):
        registry.register("conversation", "synthetic_merge",
                          registry.ConversationSpec(
                              annotations=str(ann_path), images="",
                              merge_round=2))
        mod = t_conv if web is t_web else j_conv
        ds = mod.ConversationDataset(
            "synthetic_merge", tok, ids,
            web.MultimodalCfg(image_token_len=2, image_size=16),
            model_max_length=128, instruction_offset=-1)
        return tok, len(ds), [ds[0], ds[1]]

    (_, jn, jsamples), (tok, n, samples) = both(run)
    for got, want in zip(samples, jsamples):
        assert_samples_equal(got, want)
    assert n == jn == 2
    text = tok.decode(samples[0]["input_ids"])
    assert "q0" in text and "a0" in text and "q1" in text and "a1" in text


def test_split_by_host_and_worker():
    shards = [f"s{i}" for i in range(12)]
    hosts = []
    for h in range(3):
        got = list(t_shards.split_by_host(iter(shards), process_index=h,
                                          process_count=3))
        assert got == list(j_shards.split_by_host(
            iter(shards), process_index=h, process_count=3))
        hosts.append(got)
    assert sorted(sum(hosts, [])) == sorted(shards)
    assert not (set(hosts[0]) & set(hosts[1]))
    workers = [list(t_shards.split_by_worker(iter(hosts[0]), worker_id=w,
                                             num_workers=2))
               for w in range(2)]
    assert workers == [list(j_shards.split_by_worker(
        iter(hosts[0]), worker_id=w, num_workers=2)) for w in range(2)]
    assert sorted(sum(workers, [])) == sorted(hosts[0])
    # no process group: every shard is this process's, as JAX's one host
    assert list(t_shards.split_by_host(iter(shards))) == shards
    assert t_shards.process_index_count() == (0, 1)


def test_registry_defaults_equal_jax():
    """The recipes' names, sizes and merge rounds, the det_/track_ double
    registration, and MERLIN_DATA_ROOT under the paths."""
    for family in j_registry.FAMILIES:
        assert t_registry.names(family) == j_registry.names(family) or \
            set(j_registry.names(family)) <= set(t_registry.names(family))
        for name in j_registry.names(family):
            if name.startswith("synthetic"):
                continue
            got, want = (t_registry.get_spec(family, name),
                         j_registry.get_spec(family, name))
            assert type(got).__name__ == type(want).__name__
            assert vars(got) == vars(want), (family, name)
    for name in ("det_5m_v1_en_4merge", "track_1m_v2_2merge"):
        assert t_registry.get_spec("interpair", name) is \
            t_registry.get_spec("pair", name)
    assert t_registry.get_spec("pair", "laion2b_10m_6merge").merge_round == 6
    assert t_registry.parse_dataset_flag("a+b++c") == ["a", "b", "c"]
    with pytest.raises(KeyError, match="not registered"):
        t_registry.get_spec("pair", "no_such_set")


@pytest.mark.parametrize("ops", [None, ["Rotate", "ShearX", "TranslateY",
                                        "Solarize", "Equalize"]],
                         ids=["all_ops", "geometric"])
def test_augment_equals_jax(ops):
    """``RandomAugment`` and the BLIP transforms, under ``random.Random(0)``
    (the ops draw their sign from the global ``random``, seeded alike)."""
    rs = np.random.RandomState(0)
    img = Image.fromarray(rs.randint(0, 256, (40, 60, 3), dtype=np.uint8))
    outs = {}
    for name, mod in (("jax", j_augment), ("torch", t_augment)):
        random.seed(0)
        aug = mod.RandomAugment(3, 7, ops=ops, rng=random.Random(0))
        a = np.asarray(aug(img.copy()))
        random.seed(0)
        b = mod.blip_train_transform(img, image_size=32,
                                     rng=random.Random(1))
        c = mod.blip_eval_transform(img, image_size=32)
        outs[name] = (a, b, c)
    for got, want in zip(outs["torch"], outs["jax"]):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert outs["torch"][1].shape == (32, 32, 3)
    assert list(t_augment.AUGMENT_OPS) == list(j_augment.AUGMENT_OPS)
