"""The port's benchmark harnesses against the JAX package's, on the CPU at
f32 with the same tiny weights, tokenizers primed alike (C20) and the
same input files:

  * MMBench (greedy, 3 beams, batched): the predictions JSON, the xlsx's
    members and the scores file equal JAX's; MM-Vet, DocVQA (every
    ``VQAEval`` datatype) and single-image QA: the same answers and files.
    Tokens are exact under greedy and beam decoding (C6), so every answer
    is compared as text.
  * C31: the port's ``load_tsv`` (the standard library's ``csv``) gives
    ``pandas.read_table(...).to_dict("records")`` on a TSV that holds every
    case where pandas's inference reaches the prompt: numeric options with
    an empty cell, ``1e3``, the NA strings, quoted tabs, quotes and
    newlines, booleans and a 640x480 JPEG's base64 longer than ``csv``'s
    default field limit. This test imports pandas; the port does not.

The other files of the slice import the fixtures from here.
"""

import base64
import csv
import io
import json
import math
import zipfile

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from merlin_tpu.eval import docvqa as j_docvqa
from merlin_tpu.eval import mmbench as j_mmbench
from merlin_tpu.eval import mmvet as j_mmvet
from merlin_tpu.eval import single as j_single
from merlin_tpu.eval.runner import EvalConfig as JEvalConfig
from merlin_tpu.models import builder as j_builder
from merlin_tpu.train.arguments import parse_args as j_parse_args
from merlin_tpu.utils.conversation import conv_templates

from merlin_tpu_torch.eval import docvqa as t_docvqa
from merlin_tpu_torch.eval import mmbench as t_mmbench
from merlin_tpu_torch.eval import mmvet as t_mmvet
from merlin_tpu_torch.eval import single as t_single
from merlin_tpu_torch.eval.runner import EvalConfig
from merlin_tpu_torch.models import builder as t_builder
from merlin_tpu_torch.models.bridge import params_from_flax
from merlin_tpu_torch.train.arguments import parse_args

VOCAB_TINY = 128
MMB_QUESTIONS = ["which shape is drawn", "what colour is the sky",
                 "how many dots"]
MMB_OPTIONS = [("circle", "square", "triangle", "star"),
               ("red", "blue", "green", "grey"),
               ("1", "2", "4", "")]          # numeric, D empty (C31)
OPEN_QUESTIONS = ["what is shown here", "describe the picture",
                  "total amount due", "which date is printed"]
TRACK_WORDS = ("Given image0<image> and image1<image>, track image0:<Id1>"
               "[100, 100, 300, 300]</Id1> in image1.")
# every word a harness prompt of these files holds: primed first, so no
# word is added (out of the tiny vocabulary) while a test runs
PRIME_TEXTS = ([t_mmbench.PROMPT_EN, "A. B. C. D.", "hint: look closely",
                TRACK_WORDS,
                "track the object now"] + MMB_QUESTIONS + OPEN_QUESTIONS
               + [" ".join(o) for o in MMB_OPTIONS])


def prime(jtok, ttok, texts=PRIME_TEXTS, vocab=VOCAB_TINY):
    """Encode one string of distinct words in both tokenizers: the
    template's and the texts' words first, then fillers, so every id up to
    ``vocab`` is a word and an answer decodes to text (C20)."""
    conv = conv_templates["v1"].copy()
    # "<image>" becomes special tokens in a prompt, which split the words
    conv.append_message(conv.roles[0], " ".join(texts).replace("<image>",
                                                               " "))
    conv.append_message(conv.roles[1], None)
    words = list(dict.fromkeys(jtok.tokenize(conv.get_prompt())))
    words = [w for w in words
             if jtok.convert_tokens_to_ids(w) == jtok.unk_token_id]
    free = vocab - len(jtok._vocab)
    assert len(words) <= free, f"{len(words)} words for {free} ids"
    words += [f"w{i}" for i in range(free - len(words))]
    line = " ".join(words)
    assert jtok.encode(line) == ttok.encode(line)
    assert len(jtok._vocab) == len(ttok._vocab) == vocab


def tiny_pair(seed=0, texts=PRIME_TEXTS):
    """The tiny JAX bundle with its params, and the port's bundle holding
    the same params on the CPU, tokenizers primed alike with ``texts``."""
    jb = j_builder.build_model_tokenizer(*j_parse_args([]), tiny=True)
    j_builder.init_or_load_params(jb, rng=jax.random.key(seed))
    tb = t_builder.build_model_tokenizer(*parse_args([]), tiny=True)
    tb.model.load_state_dict(params_from_flax(jax.device_get(jb.params)),
                             strict=True, assign=True)
    tb.params = tb.model.state_dict()
    prime(jb.tokenizer, tb.tokenizer, texts)
    return jb, tb


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def pair():
    return tiny_pair()


def noise_image(rng, w, h) -> Image.Image:
    return Image.fromarray(rng.integers(0, 256, size=(h, w, 3),
                                        dtype=np.uint8))


def jpeg_b64(image) -> str:
    buf = io.BytesIO()
    image.save(buf, format="JPEG", quality=95)
    return base64.b64encode(buf.getvalue()).decode()


def write_tsv(path, rows):
    columns = list(rows[0])
    with open(path, "w", newline="") as f:
        w = csv.writer(f, delimiter="\t", lineterminator="\n")
        w.writerow(columns)
        for r in rows:
            w.writerow(["" if r[c] is None else r[c] for c in columns])


def mmbench_rows(rng, w=40, h=30):
    """3 questions x 2 circular shifts (index i and i + 10^6): the options
    rotate by one and the answer letter with them; question 0 has a hint,
    question 2 numeric options with D empty."""
    rows = []
    for q, (question, opts) in enumerate(zip(MMB_QUESTIONS, MMB_OPTIONS)):
        n = sum(1 for o in opts if o)
        for shift in (0, 1):
            rot = [opts[(j + shift) % n] for j in range(n)] + list(opts[n:])
            rows.append({
                "index": q + 1 + shift * 10 ** 6, "question": question,
                "hint": "hint: look closely" if q == 0 else None,
                "A": rot[0], "B": rot[1], "C": rot[2], "D": rot[3] or None,
                "answer": "ABCD"[(q - shift) % n], "category": f"c{q % 2}",
                "l2-category": "perception",
                "image": jpeg_b64(noise_image(rng, w, h))})
    return rows


def xlsx_members(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in sorted(z.namelist())}


def read_json(path):
    with open(path) as f:
        return json.load(f)


@pytest.mark.parametrize("kind", ["greedy", "beam3", "batched3"])
def test_mmbench_gives_jax_files(pair, tmp_path, kind):
    jb, tb = pair
    tsv = tmp_path / "mmbench_dev_en.tsv"
    write_tsv(tsv, mmbench_rows(np.random.default_rng(1)))
    kw = dict(max_new_tokens=6, num_beams=3 if kind == "beam3" else 1)
    batch = 3 if kind == "batched3" else 1
    want = j_mmbench.run(jb, str(tsv), str(tmp_path / "j" / "mmb.json"),
                         JEvalConfig(**kw), batch_size=batch)
    got = t_mmbench.run(tb, str(tsv), str(tmp_path / "t" / "mmb.json"),
                        EvalConfig(**kw), batch_size=batch, device="cpu")
    assert got == want
    preds = read_json(tmp_path / "t" / "mmb.json")
    assert preds == read_json(tmp_path / "j" / "mmb.json")
    assert len(preds) == 6 and any(p["prediction"] for p in preds)
    assert "D" not in preds[4] and preds[4]["C"] == "4"   # D empty: 3 options
    assert read_json(tmp_path / "t" / "mmb_scores.json") == \
        read_json(tmp_path / "j" / "mmb_scores.json")
    assert xlsx_members(tmp_path / "t" / "mmb.xlsx") == \
        xlsx_members(tmp_path / "j" / "mmb.xlsx")


def write_images(rng, folder, names, size):
    folder.mkdir()
    for name in names:
        noise_image(rng, *size).save(folder / name)


def test_mmvet_gives_jax_answers(pair, tmp_path):
    jb, tb = pair
    rng = np.random.default_rng(2)
    write_images(rng, tmp_path / "images", ["v1_0.jpg", "v1_1.png"], (36, 28))
    qfile = tmp_path / "mmvet.json"
    qfile.write_text(json.dumps({
        "v1_0": {"imagename": "v1_0.jpg", "question": OPEN_QUESTIONS[0]},
        "v1_1": {"imagename": "v1_1.png", "question": OPEN_QUESTIONS[1]}}))
    cfg = dict(max_new_tokens=8)
    want = j_mmvet.run(jb, str(qfile), str(tmp_path / "images"),
                       str(tmp_path / "j.json"), JEvalConfig(**cfg))
    got = t_mmvet.run(tb, str(qfile), str(tmp_path / "images"),
                      str(tmp_path / "t.json"), EvalConfig(**cfg),
                      device="cpu")
    assert got == want and list(got) == ["v1_0", "v1_1"] and all(
        got.values())
    assert (tmp_path / "t.json").read_text() == \
        (tmp_path / "j.json").read_text()
    assert t_mmvet.run(tb, str(qfile), str(tmp_path / "images"),
                       str(tmp_path / "t1.json"), EvalConfig(**cfg),
                       limit=1, device="cpu") == {"v1_0": got["v1_0"]}


@pytest.mark.parametrize("datatype", ["VQAv2", "DocVQA", "ChartQA",
                                      "Other"])
def test_docvqa_gives_jax_scores(pair, tmp_path, datatype):
    """Two items with answers (the second one's answers include the port's
    own prediction, so the score is not trivially 0) and one without; one
    datatype of each metric (``test_torch_evaluators.py`` scores them
    all)."""
    jb, tb = pair
    rng = np.random.default_rng(3)
    write_images(rng, tmp_path / "docs", ["d0.png", "d1.png", "d2.png"],
                 (50, 40))
    items = [{"questionId": 7, "question": OPEN_QUESTIONS[2],
              "image": "d0.png", "answers": ["$42", "42 dollars"]},
             {"question_id": "x8", "question": OPEN_QUESTIONS[3],
              "image": "d1.png", "answers": ["10 may"]},
             {"questionId": 9, "question": OPEN_QUESTIONS[0],
              "image": "d2.png"}]
    cfg = dict(max_new_tokens=6)
    probe = t_docvqa.run(tb, _write(tmp_path / "p.json", {"data": items}),
                         str(tmp_path / "docs"), str(tmp_path / "p_out.json"),
                         EvalConfig(**cfg), datatype=datatype, device="cpu")
    pred = read_json(tmp_path / "p_out.json")["x8"]
    items[1]["answers"].append(pred)
    qfile = _write(tmp_path / "docvqa.json", {"data": items})
    want = j_docvqa.run(jb, qfile, str(tmp_path / "docs"),
                        str(tmp_path / "j.json"), JEvalConfig(**cfg),
                        datatype=datatype)
    got = t_docvqa.run(tb, qfile, str(tmp_path / "docs"),
                       str(tmp_path / "t.json"), EvalConfig(**cfg),
                       datatype=datatype, device="cpu")
    assert got == want and got["n"] == 2 and probe["n"] == 2
    assert got["per_question"]["x8"] > 0
    for name in ("", "_scores"):
        assert (tmp_path / f"t{name}.json").read_text() == \
            (tmp_path / f"j{name}.json").read_text()


def _write(path, obj) -> str:
    path.write_text(json.dumps(obj))
    return str(path)


def test_docvqa_without_answers_returns_the_path(pair, tmp_path):
    jb, tb = pair
    write_images(np.random.default_rng(4), tmp_path / "docs", ["d.png"],
                 (20, 20))
    qfile = _write(tmp_path / "q.json", [{"questionId": 1, "image": "d.png",
                                          "question": OPEN_QUESTIONS[2]}])
    out = str(tmp_path / "t.json")
    got = t_docvqa.run(tb, qfile, str(tmp_path / "docs"), out,
                       EvalConfig(max_new_tokens=4), device="cpu")
    want = j_docvqa.run(jb, qfile, str(tmp_path / "docs"),
                        str(tmp_path / "j.json"), JEvalConfig(max_new_tokens=4))
    assert got == {"predictions": out} and list(want) == ["predictions"]
    assert read_json(out) == read_json(tmp_path / "j.json")
    assert not (tmp_path / "t_scores.json").exists()


@pytest.mark.parametrize("beams", [1, 3])
def test_single_gives_jax_answer(pair, tmp_path, beams):
    jb, tb = pair
    noise_image(np.random.default_rng(5), 30, 44).save(tmp_path / "x.jpg")
    cfg = dict(max_new_tokens=8, num_beams=beams)
    want = j_single.run(jb, str(tmp_path / "x.jpg"), OPEN_QUESTIONS[1],
                        JEvalConfig(**cfg))
    got = t_single.run(tb, str(tmp_path / "x.jpg"), OPEN_QUESTIONS[1],
                       EvalConfig(**cfg), device="cpu")
    assert got == want and got


# ---------------------------------------------------------------------------
# C31: the TSV reader
# ---------------------------------------------------------------------------

C31_COLUMNS = {
    "index": ["1", "2", "1000001", "4", "5"],
    "question": ['"says ""hi"",\tthen\nleaves"', "plain", "NA", "  spaced ",
                 "x"],
    "hint": ["", "None", "a hint", "n/a", "NULL"],
    "A": ["1", "2", "3", "4", "5"],                  # ints
    "B": ["1", "", "3", "4", "5"],                   # ints with NA: floats
    "C": ["1e3", "2.5", "-0.125", ".5", "7."],       # floats
    "D": ["None", "NA", "nan", "NULL", "n/a"],       # all NA
    "E": ['""', "x", "#N/A", "<NA>", "-nan"],
    "bools": ["True", "FALSE", "true", "", "False"],
    "ints_in_text": ['"7"', " 8 ", "+9", "-0", "00012"],
    "mixed": ["4", "x", "5.5", "True", "1e3"],
    "precise": ["4116305.3637413285", "-1.2654214710460525e-09",
                "4.1325979347243595e-23", "1e400", "-1e-700"],
    "huge": ["123456789012345678901234567890", "1", "2", "3", "4"],
    "answer": ["A", "B", "C", "D", "A"],
}


def c31_tsv(tmp_path, image_cell):
    cols = list(C31_COLUMNS) + ["image"]
    lines = ["\t".join(cols)]
    for i in range(5):
        lines.append("\t".join([C31_COLUMNS[c][i] for c in C31_COLUMNS]
                               + [image_cell]))
        if i == 2:
            lines.append("")                         # a blank line
    path = tmp_path / "c31.tsv"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _same_value(got, want):
    if isinstance(want, float) and math.isnan(want):
        return isinstance(got, float) and math.isnan(got)
    if isinstance(want, float) and want == 0:
        return type(got) is float and math.copysign(1, got) == \
            math.copysign(1, want)
    return type(got) is type(want) and got == want


@pytest.fixture(scope="module")
def big_jpeg():
    """A 640x480 noise JPEG: its base64 is longer than the csv module's
    default 131072-character field limit."""
    cell = jpeg_b64(noise_image(np.random.default_rng(6), 640, 480))
    assert len(cell) > 131072
    return cell


def test_load_tsv_gives_pandas_records(tmp_path, big_jpeg):
    import pandas as pd

    path = c31_tsv(tmp_path, big_jpeg)
    want = pd.read_table(path).to_dict("records")
    got = t_mmbench.load_tsv(path)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for key in w:
            assert _same_value(g[key], w[key]), (key, g[key], w[key])
    assert got[0]["question"] == 'says "hi",\tthen\nleaves'
    assert got[1]["B"] != got[1]["B"] and got[0]["B"] == 1.0
    assert got[0]["C"] == 1000.0 and got[0]["image"] == big_jpeg


def test_load_tsv_refuses_a_long_row(tmp_path):
    path = tmp_path / "bad.tsv"
    path.write_text("a\tb\n1\t2\t3\n")
    with pytest.raises(ValueError, match="3 fields"):
        t_mmbench.load_tsv(str(path))


@pytest.mark.parametrize("row", range(5))
def test_c31_prompts_match_jax(tmp_path, big_jpeg, row):
    """The prompt each package builds from its own reader's records: the
    numeric options read ``1.0``, ``1000.0``; an NA option ends the list."""
    path = c31_tsv(tmp_path, big_jpeg)
    jrows, trows = j_mmbench.load_tsv(path), t_mmbench.load_tsv(path)
    for lang in ("en", "cn"):
        assert t_mmbench.build_question(trows[row], lang) == \
            j_mmbench.build_question(jrows[row], lang)
    assert t_mmbench.get_options(trows[row]) == \
        j_mmbench.get_options(jrows[row])
    assert t_mmbench.decode_b64_image(trows[row]["image"]).size == (640, 480)


@pytest.mark.parametrize("text", [
    "0", "-3", "1.5", "1e3", "1E-3", "+.5", "7.", "  2.25 ", "inf", "-Infinity",
    "1e400", "-1e400", "0e400", "1e-400", "-1e-700", "4.9e-324",
    "123456789012345678901234567890", "0.12345678901234567890123",
    "4116305.3637413285", "1.7976931348623157e308", "1e", "1.5e+", "e5",
    ".", "-", "1_000", "0x10", "١٢", "1,5", "nan", "NAN"])
def test_parse_float_is_pandas_float_reader(text):
    """Each text in a column beside an int: pandas types the column float
    (or int) where it reads a number, and leaves it str where it does not;
    ``parse_float`` must give the same float, or None."""
    import pandas as pd

    want = pd.read_table(io.StringIO(f"x\n{text}\n1\n"),
                         keep_default_na=False)["x"].tolist()[0]
    got = t_mmbench.parse_float(text)
    if isinstance(want, str):
        assert got is None
    else:
        assert _same_value(got, float(want)), (got, want)
