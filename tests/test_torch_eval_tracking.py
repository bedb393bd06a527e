"""The port's tracking, box and demo harnesses against the JAX package's on
the CPU at f32, with the same tiny weights and primed tokenizers:

  * ``tracking.run`` over LaSOT-layout videos (greedy): the summary and
    every per-video pickle, compared as loaded objects; ``chunk_videos``;
    ``merge_chunks`` over chunked runs equals the serial run;
  * ``track_video`` with a scripted model that answers box text and text
    it cannot parse: each prompt carries the box the previous answer left,
    or the last good box;
  * ``draw_boxes`` and ``postprocess``: pixel-equal images;
  * ``run_repl``, ``run_demo`` and ``build_task_query`` with scripted
    input;
  * C32: the sampled decode is seeded, so a sampled ``EvalModel.ask``
    asked twice gives one answer and a sampled tracking run in 2 chunks,
    merged, equals the serial run, as JAX's does.
"""

import glob
import os
import pickle

import numpy as np
import pytest
import torch
from PIL import Image

from merlin_tpu.eval import box_eval as j_box_eval
from merlin_tpu.eval import demo as j_demo
from merlin_tpu.eval import tracking as j_tracking
from merlin_tpu.eval.runner import EvalConfig as JEvalConfig
from merlin_tpu.eval.runner import EvalModel as JEvalModel

from merlin_tpu_torch.eval import box_eval as t_box_eval
from merlin_tpu_torch.eval import demo as t_demo
from merlin_tpu_torch.eval import tracking as t_tracking
from merlin_tpu_torch.eval.runner import EvalConfig, EvalModel

from test_torch_eval_harnesses import PRIME_TEXTS, noise_image, tiny_pair

FRAME_WH = (48, 32)
GT = {"cat-1": ["4,4,16,12", "6,5,16,12", "8,6,16,12", "9,7,15,12"],
      "dog-2": ["20,10,12,14", "21,11,12,14", "19,12,12,13", "18,12,12,13"]}


def _first_prompts():
    """The tracking prompt each video's first box gives (the tiny model's
    answers hold no box, so every frame pair of a video asks with it)."""
    w, h = FRAME_WH
    out = []
    for lines in GT.values():
        x, y, bw, bh = (float(v) for v in lines[0].split(","))
        nb = j_tracking.serialize_norm_box((x, y, x + bw, y + bh), w, h)
        out.append(j_tracking.TRACK_PROMPT.format(*nb))
    return out


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def pair():
    return tiny_pair(texts=PRIME_TEXTS + _first_prompts())


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    root = tmp_path_factory.mktemp("videos")
    rng = np.random.default_rng(11)
    for name, lines in GT.items():
        (root / name / "img").mkdir(parents=True)
        for i in range(len(lines)):
            noise_image(rng, *FRAME_WH).save(root / name / "img" /
                                             f"{i + 1:08d}.jpg")
        (root / name / "groundtruth.txt").write_text("\n".join(lines) + "\n")
    (root / "empty-3").mkdir()                      # no frames: skipped
    (root / "notes.txt").write_text("not a video")
    return str(root)


def _pickles(folder):
    out = {}
    for path in sorted(glob.glob(os.path.join(folder, "*_pred.pkl"))):
        with open(path, "rb") as f:
            out[os.path.basename(path)] = pickle.load(f)
    return out


@pytest.fixture
def answers(monkeypatch):
    """The port's answers, recorded: a comparison of empty answers would
    compare nothing (C20)."""
    seen = []
    ask = EvalModel.ask

    def record(self, *a, **kw):
        seen.append(ask(self, *a, **kw))
        return seen[-1]
    monkeypatch.setattr(EvalModel, "ask", record)
    return seen


@pytest.mark.parametrize("max_frames", [0, 3])
def test_tracking_run_gives_jax_pickles(pair, videos, tmp_path, max_frames,
                                        answers):
    jb, tb = pair
    cfg = dict(max_new_tokens=24)
    want = j_tracking.run(jb, videos, str(tmp_path / "j"),
                          JEvalConfig(**cfg), max_frames=max_frames)
    got = t_tracking.run(tb, videos, str(tmp_path / "t"), EvalConfig(**cfg),
                         max_frames=max_frames, device="cpu")
    assert got == want and got["videos"] == 2
    pk = _pickles(tmp_path / "t")
    assert pk == _pickles(tmp_path / "j")
    assert sorted(pk) == ["cat-1_pred.pkl", "dog-2_pred.pkl"]
    assert all(len(p["boxes"]) == (max_frames or 4) for p in pk.values())
    assert t_tracking.merge_chunks(str(tmp_path / "t")) == \
        j_tracking.merge_chunks(str(tmp_path / "j"))
    assert len(answers) == 2 * ((max_frames or 4) - 1) and any(answers)


def test_tracking_limits_and_chunks_match_jax(pair, videos, tmp_path):
    jb, tb = pair
    vids = [f"v{i}" for i in range(5)]
    for n in (1, 2, 3, 5, 7):
        for i in range(n):
            assert t_tracking.chunk_videos(vids, n, i) == \
                j_tracking.chunk_videos(vids, n, i)
    with pytest.raises(ValueError, match="chunk_idx"):
        t_tracking.chunk_videos(vids, 2, 2)
    cfg = dict(max_new_tokens=8)
    want = j_tracking.run(jb, videos, str(tmp_path / "j"),
                          JEvalConfig(**cfg), max_videos=1, max_frames=2)
    got = t_tracking.run(tb, videos, str(tmp_path / "t"), EvalConfig(**cfg),
                         max_videos=1, max_frames=2, device="cpu")
    assert got == want and got["videos"] == 1
    assert _pickles(tmp_path / "t") == _pickles(tmp_path / "j")


def test_merge_chunks_reads_old_pickles_as_jax(tmp_path):
    """Pickles without ``mean_iou`` (raw ious only), and no pickles."""
    for name, ious in (("a", [0.5, 0.25, 0.0]), ("b", [])):
        with open(tmp_path / f"{name}_pred.pkl", "wb") as f:
            pickle.dump({"boxes": [], "ious": ious}, f)
    assert t_tracking.merge_chunks(str(tmp_path)) == \
        j_tracking.merge_chunks(str(tmp_path))
    empty = str(tmp_path / "none")
    assert t_tracking.merge_chunks(empty) == \
        j_tracking.merge_chunks(empty) == \
        {"videos": 0, "mean_iou": 0.0, "success_auc": 0.0}


class Scripted:
    """Answers from a script, recording each prompt and image count."""

    def __init__(self, answers):
        self.answers = list(answers)
        self.asked = []

    def ask(self, prompt, images):
        self.asked.append((prompt, len(images)))
        return self.answers[len(self.asked) - 1]


SCRIPT = ["it moved to <Id1>[200, 250, 600, 750]</Id1>", "lost it",
          "[1,2,3,4;100, 150, 300, 350] then", "", "[no, box, here, x]"]


def test_track_video_follows_the_answers_as_jax(videos):
    """Frame pair i asks with the box answer i - 1 left: a parsed box, or
    the last good one where the answer holds none."""
    frames, gt = t_tracking.load_lasot_video(os.path.join(videos, "cat-1"))
    assert (frames, gt) == j_tracking.load_lasot_video(
        os.path.join(videos, "cat-1"))
    frames = frames + frames[:2]                   # 6 frames: 5 answers
    tm, jm = Scripted(SCRIPT), Scripted(SCRIPT)
    got = t_tracking.track_video(tm, frames, gt[0], gt, name="cat-1")
    want = j_tracking.track_video(jm, frames, gt[0], gt, name="cat-1")
    assert got.pred_boxes == want.pred_boxes and got.ious == want.ious
    assert (got.mean_iou, got.success_auc()) == \
        (want.mean_iou, want.success_auc())
    assert tm.asked == jm.asked and all(n == 2 for _, n in tm.asked)
    w, h = FRAME_WH
    boxes = [t_tracking.serialize_norm_box(gt[0], w, h), (200, 250, 600, 750),
             (200, 250, 600, 750), (100, 150, 300, 350), (100, 150, 300, 350)]
    for (prompt, _), box in zip(tm.asked, boxes):
        assert prompt.endswith(t_tracking.TRACK_PROMPT.format(*box)[-60:])
        assert "[{:03d}, {:03d}, {:03d}, {:03d}]".format(*box) in prompt
    assert got.pred_boxes[1] == t_tracking.de_norm_box_xyxy(
        [0.2, 0.25, 0.6, 0.75], w, h)
    assert got.pred_boxes[2] == got.pred_boxes[1]      # kept
    assert got.pred_boxes[-1] == got.pred_boxes[-2] == got.pred_boxes[3]
    assert len(got.ious) == 3                           # gt has 4 frames


@pytest.mark.parametrize("text", ["<Id1>[100, 100, 500, 500]</Id1>",
                                  "[1,2,3,4;5,6,7,8] and [9, 9, 9, 9]",
                                  "no box", "[1, 2]"])
def test_parse_predicted_box_matches_jax(text):
    assert t_tracking.parse_predicted_box(text) == \
        j_tracking.parse_predicted_box(text)
    for box, wh in (((64, 48, 320, 240), (640, 480)),
                    ((-5, 3, 700, 200), (640, 480)), ((1, 1, 2, 2), (3, 7))):
        assert t_tracking.serialize_norm_box(box, *wh) == \
            j_tracking.serialize_norm_box(box, *wh)


@pytest.mark.parametrize("labels", [None, ["cat", "dog"]])
def test_draw_boxes_is_pixel_equal(labels):
    rng = np.random.default_rng(12)
    image = noise_image(rng, 120, 90)
    boxes = [[100, 200, 500, 600], [0, 0, 1000, 1000], [900, 50, 1200, 80]]
    for width in (1, 8):
        got = t_box_eval.draw_boxes(image, boxes, labels, width=width)
        want = j_box_eval.draw_boxes(image, boxes, labels, width=width)
        assert np.array_equal(np.asarray(got), np.asarray(want))
        assert not np.array_equal(np.asarray(got), np.asarray(image))
    for text in ("object at [100, 200, 500, 600]", "no boxes here"):
        gt, gd = t_box_eval.postprocess(text, image)
        jt, jd = j_box_eval.postprocess(text, image)
        assert gt == jt and (gd is None) == (jd is None)
        if gd is not None:
            assert np.array_equal(np.asarray(gd), np.asarray(jd))
    assert t_box_eval.postprocess("[1,2,3,4]") == ("[1,2,3,4]", None)
    assert t_box_eval.GOLDEN_CASES == j_box_eval.GOLDEN_CASES


@pytest.fixture
def saved(monkeypatch):
    """PIL saves recorded in memory (both packages save the drawn boxes),
    the temporary directory read as ``/tmp``, where JAX writes."""
    import tempfile

    out = {}
    monkeypatch.setattr(Image.Image, "save",
                        lambda self, path, *a, **k: out.setdefault(
                            path, []).append(np.asarray(self)))
    monkeypatch.setattr(tempfile, "tempdir", "/tmp")
    return out


@pytest.fixture(scope="module")
def frame_files(tmp_path_factory):
    """Two PNG frames on disk, written before ``saved`` patches PIL."""
    root = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(13)
    paths = []
    for i in range(2):
        noise_image(rng, 36, 24).save(root / f"f{i}.png")
        paths.append(str(root / f"f{i}.png"))
    return paths


def _script(lines):
    it = iter(lines)

    def read(prompt):
        try:
            return next(it)
        except StopIteration:
            raise EOFError from None
    return read


def test_run_repl_matches_jax(pair, frame_files):
    jb, tb = pair
    f0, f1 = frame_files
    lines = [f"{f0} ; what is shown here", f"{f0},{f1};describe the picture",
             " ; track the object now", "", "never read"]
    cfg = dict(max_new_tokens=8)
    jout, tout = [], []
    j_box_eval.run_repl(jb, JEvalConfig(**cfg), _script(lines), jout.append)
    t_box_eval.run_repl(tb, EvalConfig(**cfg), _script(lines), tout.append,
                        device="cpu")
    assert tout == jout and len(tout) == 3 and any(tout)
    # EOF ends the loop too
    t_box_eval.run_repl(tb, EvalConfig(**cfg), _script([]), tout.append,
                        device="cpu")


def test_run_repl_draws_the_answers_boxes_as_jax(pair, frame_files, saved,
                                                 monkeypatch):
    jb, tb = pair
    f0, _ = frame_files
    answer = "the dog is at [100, 200, 500, 600]"
    monkeypatch.setattr(JEvalModel, "ask", lambda self, q, im: answer)
    monkeypatch.setattr(EvalModel, "ask", lambda self, q, im: answer)
    jout, tout = [], []
    j_box_eval.run_repl(jb, None, _script([f"{f0};where"]), jout.append)
    jsaved = {k: list(v) for k, v in saved.items()}
    saved.clear()
    t_box_eval.run_repl(tb, None, _script([f"{f0};where"]), tout.append,
                        device="cpu")
    assert tout == jout == [answer, "[boxes drawn -> /tmp/merlin_box_vis.png]"]
    assert list(saved) == list(jsaved) == ["/tmp/merlin_box_vis.png"]
    assert np.array_equal(saved["/tmp/merlin_box_vis.png"][0],
                          jsaved["/tmp/merlin_box_vis.png"][0])


@pytest.mark.parametrize("mode", ["Track", "Detect", "ImgInd"])
@pytest.mark.parametrize("query", ["where is it", "compare <image> to this",
                                   ""])
def test_build_task_query_matches_jax(mode, query):
    for n in (0, 1, 3):
        for start_end in (True, False):
            assert t_demo.build_task_query(query, n, 4, mode, start_end) == \
                j_demo.build_task_query(query, n, 4, mode, start_end)


@pytest.mark.parametrize("mode", ["Track", "ImgInd"])
@pytest.mark.parametrize("beams", [1, 3])
def test_run_demo_matches_jax(pair, frame_files, saved, mode, beams):
    """Turn one with 2 frames, turn two text only (the conversation and
    both frames carried over), a reset, then a third turn; ``max_turns``
    ends it."""
    jb, tb = pair
    f0, f1 = frame_files
    lines = [f"{f0},{f1} ; track the object now", "what is shown here",
             "reset", f"{f1} ; describe the picture", "never read"]
    cfg = dict(max_new_tokens=6, num_beams=beams)
    jout, tout = [], []
    j_demo.run_demo(jb, task_mode=mode, eval_cfg=JEvalConfig(**cfg),
                    input_fn=_script(lines), print_fn=jout.append,
                    max_turns=3)
    t_demo.run_demo(tb, task_mode=mode, eval_cfg=EvalConfig(**cfg),
                    input_fn=_script(lines), print_fn=tout.append,
                    max_turns=3, device="cpu")
    assert tout == jout and len(tout) >= 3
    assert all(t.startswith("ASSISTANT: ") for t in tout if "boxes" not in t)


def test_run_demo_draws_on_the_last_frame_as_jax(pair, frame_files, saved,
                                                 monkeypatch):
    jb, tb = pair
    f0, f1 = frame_files
    answer = "it is at [100, 100, 800, 900]"
    monkeypatch.setattr(JEvalModel, "decode_output", lambda s, t: answer)
    monkeypatch.setattr(EvalModel, "decode_output", lambda s, t: answer)
    jout, tout = [], []
    lines = [f"{f0},{f1} ; track the object now", "quit"]
    j_demo.run_demo(jb, task_mode="Track", input_fn=_script(lines),
                    print_fn=jout.append)
    jsaved = {k: list(v) for k, v in saved.items()}
    saved.clear()
    t_demo.run_demo(tb, task_mode="Track", input_fn=_script(lines),
                    print_fn=tout.append, device="cpu")
    path = "/tmp/merlin_demo_turn0.png"
    assert tout == jout == [f"ASSISTANT: {answer}",
                            f"[boxes drawn -> {path}]"]
    assert np.array_equal(saved[path][0], jsaved[path][0])


# ---------------------------------------------------------------------------
# C32: the sampled decode is seeded
# ---------------------------------------------------------------------------

def test_sampled_ask_gives_one_answer(pair):
    _, tb = pair
    model = EvalModel(tb, EvalConfig(do_sample=True, temperature=1.0,
                                     max_new_tokens=12), device="cpu")
    image = noise_image(np.random.default_rng(14), 30, 20)
    torch.manual_seed(1)
    first = model.ask("what is shown here", [image])
    torch.manual_seed(2)
    assert model.ask("what is shown here", [image]) == first and first
    batch = model.ask_batch(["what is shown here", "describe the picture"],
                            [[image], []])
    assert model.ask_batch(["what is shown here", "describe the picture"],
                           [[image], []]) == batch
    greedy = EvalModel(tb, EvalConfig(max_new_tokens=12), device="cpu")
    assert greedy.ask("what is shown here", [image]) != first


def test_sampled_tracking_chunked_equals_serial(pair, videos, tmp_path,
                                                answers):
    """Tracking's default config samples (temperature 0.2): the chunks,
    merged, give the serial run's summary and pickles."""
    _, tb = pair
    serial = t_tracking.run(tb, videos, str(tmp_path / "serial"),
                            max_frames=3, device="cpu")
    for idx in range(2):
        t_tracking.run(tb, videos, str(tmp_path / "chunked"), max_frames=3,
                       num_chunks=2, chunk_idx=idx, device="cpu")
    merged = t_tracking.merge_chunks(str(tmp_path / "chunked"))
    assert merged == serial and merged["videos"] == 2
    assert _pickles(tmp_path / "chunked") == _pickles(tmp_path / "serial")
    assert answers[:4] == answers[4:] and any(answers)
