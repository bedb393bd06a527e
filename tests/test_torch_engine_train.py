"""The port's training entry point on the CPU, against the JAX package's
data path: ``train(argv, tiny=True, device="cpu")`` over synthetic tar
shards and a conversation JSON takes 3 steps, writes a checkpoint with the
data cursor, and resumes to step 4. The batches its ``Trainer`` received
(captured here by wrapping ``batch_iterator``) equal, array for array, the
batches of JAX's ``build_dataloader`` + ``batch_iterator`` from the same
command line, the resumed run's first batch included (the port's cursor
carries the sampler position, C35). Both tokenizers are primed with every
word of the data first: a ``TinyTokenizer`` numbers words in the order it
meets them, and a resumed run meets them in another order.

Also C33 (the -2 instruction offset with the ``TinyTokenizer`` trains on
each ``ASSISTANT:``, in both packages), C34 (a failing sample raises in the
consumer within a timeout, where JAX's consumer blocks) and the module's
command line.
"""

import io
import json
import logging
import os
import subprocess
import sys
import tarfile
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from merlin_tpu.data import builder as j_builder
from merlin_tpu.data import registry as j_registry
from merlin_tpu.models import builder as j_models
from merlin_tpu.train import arguments as j_args

from merlin_tpu_torch.data import builder as t_builder
from merlin_tpu_torch.data import registry as t_registry
from merlin_tpu_torch.engine import train as t_engine
from merlin_tpu_torch.utils.constants import IGNORE_INDEX
from merlin_tpu_torch.utils.conversation import conv_vicuna_v1 as t_vicuna

from test_data_pipeline import _make_interpair_shard

TRACK_TEXT = ("Given image0 and image1 , track image0:<Id1>[100, 100, 200, "
              "200]</Id1> in image1. <Id1>[110, 105, 210, 205]</Id1>")
# every word the data holds, in one fixed order ("<image>" splits words as a
# space does)
PRIME = " ".join([t_vicuna.system, "USER: ASSISTANT:", TRACK_TEXT,
                  "a synthetic caption number question answer"]
                 + [str(i) for i in range(64)])


@pytest.fixture(autouse=True)
def _one_thread_and_loggers(monkeypatch):
    """torch at one thread; the native loader off (its threads race); the
    package logger restored after ``setup_logger`` stops its propagation
    (later tests of this worker read records through the root logger)."""
    monkeypatch.setenv("MERLIN_NATIVE_LOADER", "0")
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    pkg = logging.getLogger("merlin_tpu_torch")
    saved = (pkg.handlers[:], pkg.propagate, pkg.level)
    yield
    for h in pkg.handlers:
        if h not in saved[0]:
            h.close()
    pkg.handlers[:], pkg.propagate, pkg.level = saved
    torch.set_num_threads(prev)


def _make_pair_shard(path, n=32):
    with tarfile.open(path, "w") as tf:
        for i in range(n):
            buf = io.BytesIO()
            rs = np.random.RandomState(i)
            Image.fromarray(rs.randint(0, 256, (20, 24, 3), dtype=np.uint8)
                            ).save(buf, format="JPEG")
            for ext, data in (("jpg", buf.getvalue()),
                              ("txt", f"a synthetic caption number {i}"
                                      .encode())):
                info = tarfile.TarInfo(f"{i:06d}.{ext}")
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))


@pytest.fixture()
def recipe(tmp_path):
    """Pair and tracking shards and a conversation set, registered under
    the same names in both packages; the command line."""
    _make_pair_shard(tmp_path / "pairs.tar")
    _make_interpair_shard(str(tmp_path / "track.tar"), n=12)
    (tmp_path / "conv.json").write_text(json.dumps([
        {"conversations": [{"from": "human", "value": f"question {i}"},
                           {"from": "gpt", "value": f"answer {i}"}]}
        for i in range(8)]))
    for reg in (t_registry, j_registry):
        reg.register("pair", "synthetic_e2e_pair", reg.WebdataSpec(
            path=str(tmp_path / "pairs.tar"), size=32, merge_round=2))
        reg.register("interpair", "synthetic_e2e_track", reg.WebdataSpec(
            path=str(tmp_path / "track.tar"), size=12, merge_round=2))
        reg.register("conversation", "synthetic_e2e_conv",
                     reg.ConversationSpec(
                         annotations=str(tmp_path / "conv.json")))
    return [
        "--pair_datasets", "synthetic_e2e_pair",
        "--interpair_datasets", "synthetic_e2e_track",
        "--conversation_datasets", "synthetic_e2e_conv",
        "--group_by_modality_length", "True",
        "--output_dir", str(tmp_path / "out"),
        "--num_train_steps", "3",
        "--per_device_train_batch_size", "1",
        "--gradient_accumulation_steps", "2",
        "--model_max_length", "64",
        "--max_images", "4",
        "--learning_rate", "1e-3",
        "--warmup_ratio", "0.0",
        "--gradient_checkpointing", "False",
        "--save_steps", "0",
        "--logging_steps", "1",
    ]


def _with_steps(argv, n):
    argv = list(argv)
    argv[argv.index("--num_train_steps") + 1] = str(n)
    return argv


def _port_run(monkeypatch, argv):
    """``train()`` with the Trainer's batches recorded and the tokenizer
    primed; returns (metrics, batches)."""
    seen = []
    real_iter = t_engine.batch_iterator
    real_build = t_engine.build_model_tokenizer

    def recording(*a, **kw):
        for batch in real_iter(*a, **kw):
            seen.append(batch)
            yield batch

    def primed(*a, **kw):
        bundle = real_build(*a, **kw)
        bundle.tokenizer.encode(PRIME)
        return bundle

    monkeypatch.setattr(t_engine, "batch_iterator", recording)
    monkeypatch.setattr(t_engine, "build_model_tokenizer", primed)
    metrics = t_engine.train(argv, tiny=True, device="cpu")
    return metrics, seen


def _jax_batches(argv, n):
    """JAX's ``build_dataloader`` + ``batch_iterator`` from the same command
    line, at the port's global batch (per-device x accumulation)."""
    model_args, data_args, training_args = j_args.parse_args(argv)
    bundle = j_models.build_model_tokenizer(model_args, data_args,
                                            training_args, tiny=True)
    bundle.tokenizer.encode(PRIME)
    data = j_builder.build_dataloader(bundle.tokenizer, bundle.special_ids,
                                      data_args, training_args,
                                      process_index=0, process_count=1)
    it = j_builder.batch_iterator(
        data["train_dataset"], data["collator"],
        batch_size=(training_args.per_device_train_batch_size
                    * training_args.gradient_accumulation_steps),
        sampler=data["sampler"])
    return [next(it) for _ in range(n)]


def _assert_batch_equal(got, want):
    keys = [k for k in want if not k.startswith("__")]
    assert sorted(k for k in got if not k.startswith("__")) == sorted(keys)
    for k in keys:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_train_three_steps_then_resume_to_four(recipe, monkeypatch):
    metrics, seen = _port_run(monkeypatch, recipe)
    assert np.isfinite(metrics["loss"]) and np.isfinite(metrics["grad_norm"])
    out = recipe[recipe.index("--output_dir") + 1]
    assert sorted(os.listdir(out))[0] == "checkpoint-3"
    want = _jax_batches(recipe, 4)
    for got, ref in zip(seen[:3], want[:3]):
        _assert_batch_equal(got, ref)
        assert got["input_ids"].shape == (2, 64)
        assert got["images"].shape == (2, 4, 16, 16, 3)
    # the checkpoint holds the cursor of the 3rd batch, the last consumed
    with open(os.path.join(out, "checkpoint-3", "data_state.json")) as f:
        state = json.load(f)
    assert state["step"] == 3 and state["datasets"]["indices"] == 6
    assert state["datasets"]["streams"] == json.loads(json.dumps(
        want[2]["__data_state__"]))

    metrics4, resumed = _port_run(monkeypatch, _with_steps(recipe, 4))
    assert np.isfinite(metrics4["loss"])
    assert sorted(d for d in os.listdir(out) if d.startswith("checkpoint")) \
        == ["checkpoint-3", "checkpoint-4"]
    with open(os.path.join(out, "checkpoint-4", "data_state.json")) as f:
        assert json.load(f)["step"] == 4
    # one step: the resumed run's first batch is the uninterrupted 4th
    _assert_batch_equal(resumed[0], want[3])


def test_families_mix_and_image_blocks(recipe):
    """A fresh pipeline's first 4 batches draw from every family (the
    modality sampler shuffles them together); each image block is
    <im_start>, image_token_len <im_patch>, <im_end>, never supervised."""
    from merlin_tpu_torch.models.builder import build_model_tokenizer
    from merlin_tpu_torch.train.arguments import parse_args

    m, d, t = parse_args(recipe)
    bundle = build_model_tokenizer(m, d, t, tiny=True)
    tok, ids = bundle.tokenizer, bundle.special_ids
    tok.encode(PRIME)
    data = t_builder.build_dataloader(tok, ids, d, t, process_index=0,
                                      process_count=1)
    it = t_builder.batch_iterator(data["train_dataset"], data["collator"],
                                  batch_size=2, sampler=data["sampler"])
    batches = [next(it) for _ in range(4)]
    families = set()
    for batch in batches:
        for row, lab in zip(batch["input_ids"], batch["labels"]):
            words = tok.decode(row).split()
            families |= {f for f, w in (("pair", "caption"),
                                        ("track", "track"),
                                        ("conversation", "question"))
                         if w in words}
            for s in np.flatnonzero(row == ids.im_start):
                n = next(j for j in range(s + 1, len(row))
                         if row[j] != ids.image_patch) - s - 1
                assert n == d.num_patches and row[s + n + 1] == ids.im_end
            blocks = np.isin(row, [ids.im_start, ids.image_patch,
                                   ids.im_end])
            assert np.all(lab[blocks] == IGNORE_INDEX)
    assert families == {"pair", "track", "conversation"}


def _two_round_conversation(tmp_path, reg):
    ann = tmp_path / "c33.json"
    ann.write_text(json.dumps([{"conversations": [
        {"from": "human", "value": "what is this"},
        {"from": "gpt", "value": "a red cat"},
        {"from": "human", "value": "and now"},
        {"from": "gpt", "value": "a blue dog"}]}]))
    reg.register("conversation", "synthetic_c33",
                 reg.ConversationSpec(annotations=str(ann)))


def test_c33_minus_two_trains_on_assistant_with_tiny_tokenizer(tmp_path):
    """C33, kept for parity: ``build_dataloader`` passes no
    ``instruction_offset``, so a conversation masked for the TinyTokenizer
    at -2 keeps ``ASSISTANT:`` before each answer, in both packages."""
    from merlin_tpu_torch.models.builder import build_model_tokenizer
    from merlin_tpu_torch.train.arguments import parse_args

    argv = ["--conversation_datasets", "synthetic_c33",
            "--model_max_length", "64"]
    kept = {}
    for name, reg, parse, build, data_builder in (
            ("jax", j_registry, j_args.parse_args,
             j_models.build_model_tokenizer, j_builder),
            ("torch", t_registry, parse_args, build_model_tokenizer,
             t_builder)):
        _two_round_conversation(tmp_path, reg)
        m, d, t = parse(argv)
        bundle = build(m, d, t, tiny=True)
        data = data_builder.build_dataloader(
            bundle.tokenizer, bundle.special_ids, d, t, process_index=0,
            process_count=1)
        sample = data["train_dataset"][0]
        kept[name] = [bundle.tokenizer._inv[i] for i in
                      sample["input_ids"][sample["labels"] != IGNORE_INDEX]]
        assert data["train_dataset"].instruction_offset == -2
    assert kept["torch"] == kept["jax"] == [
        "ASSISTANT:", "a", "red", "cat", "</s>",
        "ASSISTANT:", "a", "blue", "dog", "</s>"]


class _Failing:
    """Three good samples, then one that raises."""

    def __init__(self, error):
        self.error = error

    def __len__(self):
        return 8

    def __getitem__(self, i):
        if i == 3:
            raise self.error
        return dict(input_ids=np.full(3, i + 4, np.int32),
                    labels=np.full(3, i + 4, np.int32),
                    segment_ids=np.zeros(3, np.int32),
                    images=np.zeros((1, 4, 4, 3), np.uint8), num_images=1)


def _next_within(it, seconds):
    """``next(it)`` in a daemon thread; returns ("value"|"error"|"blocked",
    payload)."""
    box = {}

    def run():
        try:
            box["value"] = next(it)
        except BaseException as e:
            box["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    if t.is_alive():
        return "blocked", None
    return next(iter(box.items()))


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_c34_producer_errors_reach_the_consumer():
    """C34: a sample that raises reaches the port's consumer, which raises
    it; JAX's producer thread dies and its consumer blocks for ever. A
    producer that runs out ends the port's iteration."""
    from merlin_tpu.data.collator import Collator as JCollator
    from merlin_tpu_torch.data.collator import Collator

    col = Collator(pad_id=0, max_length=4, image_size=4)
    it = t_builder.batch_iterator(_Failing(ValueError("bad sample")), col,
                                  batch_size=2)
    kind, first = _next_within(it, 30)
    assert kind == "value" and first["input_ids"][:, 0].tolist() == [4, 5]
    kind, err = _next_within(it, 30)
    assert kind == "error" and isinstance(err, ValueError)
    assert str(err) == "bad sample"

    ended = t_builder.batch_iterator(_Failing(StopIteration()), col,
                                     batch_size=2)
    assert _next_within(ended, 30)[0] == "value"
    assert _next_within(ended, 30)[0] == "error"      # StopIteration: done

    jit = j_builder.batch_iterator(_Failing(ValueError("bad sample")),
                                   JCollator(pad_id=0, max_length=4,
                                             image_size=4), batch_size=2)
    assert _next_within(jit, 30)[0] == "value"
    assert _next_within(jit, 1.0)[0] == "blocked"


def test_train_defaults_to_the_card():
    import inspect

    assert inspect.signature(t_engine.train).parameters["device"].default \
        == "cuda"


def test_module_command_line():
    """``python -m merlin_tpu_torch.engine.train`` parses the three flag
    groups (``--help`` lists them and exits 0)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", "merlin_tpu_torch.engine.train", "--help"],
        cwd=root, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    for flag in ("--pair_datasets", "--interpair_datasets",
                 "--conversation_datasets", "--group_by_modality_length",
                 "--num_train_steps", "--freeze_lm_model"):
        assert flag in proc.stdout


@pytest.mark.parametrize("model_kw", [{}, dict(freeze_lm_model=True),
                                      dict(freeze_vision_tower=True,
                                           freeze_projector=True)],
                         ids=["all", "frozen_lm", "frozen_tower"])
def test_log_model_parameters_equals_jax(model_kw):
    """The parameter counts the entry point logs, on the tiny bundle."""
    import jax

    from merlin_tpu.utils.logging import log_model_parameters as j_log
    from merlin_tpu_torch.models.builder import (
        build_model_tokenizer, init_or_load_params)
    from merlin_tpu_torch.train import arguments as t_args
    from merlin_tpu_torch.utils.logging import log_model_parameters as t_log

    jb = j_models.build_model_tokenizer(
        j_args.ModelArguments(**model_kw), j_args.DataArguments(),
        j_args.TrainingArguments(), tiny=True)
    j_models.init_or_load_params(jb, rng=jax.random.key(0))
    tb = build_model_tokenizer(
        t_args.ModelArguments(**model_kw), t_args.DataArguments(),
        t_args.TrainingArguments(), tiny=True)
    init_or_load_params(tb, generator=torch.Generator(), device="cpu")
    logger = logging.getLogger("merlin_tpu_torch.test")
    got = t_log(logger, tb.params, tb.trainable_mask)
    assert got == j_log(logger, jb.params, jb.trainable_mask)
    assert 0 < got["trainable"] <= got["total"]


def _params(path):
    return torch.load(os.path.join(path, "model.pt"), weights_only=True)


def test_frozen_params_left_out_of_checkpoints(recipe, monkeypatch):
    """A checkpoint holds what training can change (JAX's holds the whole
    state): the frozen LM stays out of model.pt and frozen.json holds its
    fingerprints; the resumed run's model, frozen tensors included, is the
    first run's model at its end, tensor for tensor."""
    states = []

    class Recording(t_engine.Trainer):
        def maybe_resume(self):
            step = super().maybe_resume()
            states.append(("resumed", step, self._snapshot()))
            return step

        def save_final(self):
            states.append(("final", self.step, self._snapshot()))
            return super().save_final()

        def _snapshot(self):
            return {k: v.clone() for k, v in
                    self.bundle.model.state_dict().items()}

    monkeypatch.setattr(t_engine, "Trainer", Recording)
    frozen = recipe + ["--freeze_lm_model", "True"]
    _port_run(monkeypatch, frozen)
    _port_run(monkeypatch, _with_steps(frozen, 4))
    out = frozen[frozen.index("--output_dir") + 1]
    ck3 = os.path.join(out, "checkpoint-3")
    names = set(_params(ck3))
    with open(os.path.join(ck3, "frozen.json")) as f:
        left_out = json.load(f)
    assert left_out and all(n.startswith("lm.") for n in left_out)
    assert "lm.lm_head.kernel" in left_out
    assert "lm.embed_tokens.embedding" in names      # its row mask trains
    assert not names & set(left_out)
    (_, _, _), (_, step3, trained), (_, resumed_at, resumed), _ = states
    assert step3 == resumed_at == 3
    assert trained.keys() == resumed.keys()
    for name, t in trained.items():
        assert torch.equal(t, resumed[name]), name


def test_restore_refuses_another_base(tmp_path):
    """A checkpoint without its frozen tensors restores only into a model
    whose frozen tensors equal the ones it was saved from."""
    from merlin_tpu_torch.train.checkpoint import (
        restore_checkpoint, save_checkpoint)

    class Opt:
        def __init__(self):
            self.state = {"m": torch.zeros(3)}

        def state_dict(self):
            return self.state

        def load_state_dict(self, state):
            self.state = state

    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.Linear(3, 2))
    model[0].requires_grad_(False)
    path = save_checkpoint(str(tmp_path), 7, model, Opt(),
                           data_state={"step": 7})
    assert set(_params(path)) == {"1.weight", "1.bias"}
    fresh = torch.nn.Sequential(torch.nn.Linear(4, 3),
                                torch.nn.Linear(3, 2))
    fresh[0].load_state_dict(model[0].state_dict())
    step, data_state = restore_checkpoint(path, fresh, Opt())
    assert (step, data_state) == (7, {"step": 7})
    for a, b in zip(fresh.parameters(), model.parameters()):
        assert torch.equal(a, b)
    with torch.no_grad():
        fresh[0].weight[0, 0] += 1e-3
    with pytest.raises(ValueError, match="same base weights"):
        restore_checkpoint(path, fresh, Opt())
