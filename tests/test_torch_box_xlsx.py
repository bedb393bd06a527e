"""The port's copies of ``data/box.py`` and ``utils/xlsx.py`` against the
JAX package's, on seeded inputs: every ``data/box`` function, and the
xlsx writer's files compared member by member (the zip's own bytes hold
timestamps) and read back alike."""

import random
import zipfile

import numpy as np
import pytest

from merlin_tpu.data import box as j_box
from merlin_tpu.utils import xlsx as j_xlsx

from merlin_tpu_torch.data import box as t_box
from merlin_tpu_torch.utils import xlsx as t_xlsx


def _boxes(rng, n, scale=1.0):
    xy = rng.uniform(-5, 90, size=(n, 2)) * scale
    wh = rng.uniform(0, 60, size=(n, 2)) * scale
    return np.concatenate([xy, wh], axis=1)


@pytest.mark.parametrize("aspect", ["resize", "pad"])
@pytest.mark.parametrize("path", ["coco/x.jpg", "OpenImages/y.jpg"])
@pytest.mark.parametrize("seed", range(3))
def test_serialize_boxes_matches_jax(aspect, path, seed):
    rng = np.random.default_rng(seed)
    openimages = "OpenImages" in path
    boxes = [rng.uniform(0, 1, size=(3, 4)) if openimages else
             _boxes(rng, 3), rng.uniform(0, 1, size=4) if openimages else
             _boxes(rng, 1)[0]]
    wh = [(int(rng.integers(20, 900)), int(rng.integers(20, 900)))
          for _ in boxes]
    got = t_box.serialize_boxes(boxes, wh, path, aspect)
    assert got == j_box.serialize_boxes(boxes, wh, path, aspect)
    assert len(got) == 4


def test_serialize_boxes_refuses_an_unknown_aspect():
    for mod in (j_box, t_box):
        with pytest.raises(ValueError, match="unsupported"):
            mod.serialize_boxes([np.zeros((1, 4))], [(4, 4)], "", "keep")


@pytest.mark.parametrize("box", [[0.1, 0.2, 0.3, 0.4], [0, 0, 1, 1],
                                 [0.0005, 0.9999, 0.123456, 0.5]])
def test_serialize_box_matches_jax(box):
    assert t_box.serialize_box(box) == j_box.serialize_box(box)


@pytest.mark.parametrize("text", [
    "the object is at [100, 200, 300, 400] moving to [110,210,310,410]",
    "[1,2,3,4;5,6,7,8]", "no boxes here [1, 2] nope",
    "<Id1>[012, 034, 500, 600]</Id1> and <Id2>[1.5,2.,.5,7]</Id2>",
    "[1,2,3,4;5,6,7]", "[,,,]", "[1,2,3,4][5,6,7,8]", "<Id 3> <Id12>x",
    ""])
def test_extract_boxes_and_ids_match_jax(text):
    assert t_box.extract_boxes(text) == j_box.extract_boxes(text)
    assert t_box.extract_ids(text) == j_box.extract_ids(text)


@pytest.mark.parametrize("seed", range(3))
def test_box_geometry_matches_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        w, h = int(rng.integers(1, 2000)), int(rng.integers(1, 2000))
        box = [float(v) for v in rng.uniform(-0.2, 1.3, size=4)]
        pix = [float(v) for v in rng.uniform(-50, 2100, size=4)]
        assert t_box.de_norm_box_xyxy(box, w, h) == \
            j_box.de_norm_box_xyxy(box, w, h)
        assert t_box.norm_box_xyxy(pix, w, h) == \
            j_box.norm_box_xyxy(pix, w, h)
        a, b = sorted(pix[:2]) + sorted(pix[2:]), [float(v) for v in
                                                   rng.uniform(0, 900, 4)]
        assert t_box.box_iou_xyxy(a, b) == j_box.box_iou_xyxy(a, b)
    assert t_box.box_iou_xyxy((0, 0, 0, 0), (0, 0, 0, 0)) == 0.0


@pytest.mark.parametrize("limit", [0, 3, 10, 20])
def test_shuffle_and_sample_matches_jax(limit):
    boxes = [[i, i, i + 1, i + 1] for i in range(10)]
    assert t_box.shuffle_and_sample_boxes(boxes, limit, random.Random(7)) \
        == j_box.shuffle_and_sample_boxes(boxes, limit, random.Random(7))
    random.seed(3)
    got = t_box.shuffle_and_sample_boxes(boxes, limit)
    random.seed(3)
    assert got == j_box.shuffle_and_sample_boxes(boxes, limit)


# ---------------------------------------------------------------------------
# xlsx
# ---------------------------------------------------------------------------

def test_col_names_match_jax():
    for i in list(range(0, 800)) + [16383]:
        assert t_xlsx._col_name(i) == j_xlsx._col_name(i)


def _members(path):
    with zipfile.ZipFile(path) as z:
        assert z.testzip() is None
        return [(i.filename, i.compress_type, z.read(i.filename))
                for i in z.infolist()]


RECORDS = [
    {"index": 1, "question": "What <is> this & that?", "prediction": "A",
     "A": "cat", "B": "dog"},
    {"index": 1000002, "question": "中文题目", "prediction": "B is right",
     "A": 4.0, "C": True, "D": None},
    {"index": 3, "question": 'quote " and \' and\ttab\nnewline',
     "prediction": "", "E": 2.5e10, "A": -0.5},
]


@pytest.mark.parametrize("columns", [None, ["index", "prediction", "Z"]],
                         ids=["first-seen", "given"])
def test_records_xlsx_members_match_jax(tmp_path, columns):
    jp, tp = str(tmp_path / "j.xlsx"), str(tmp_path / "t.xlsx")
    j_xlsx.write_records_xlsx(jp, RECORDS, columns)
    t_xlsx.write_records_xlsx(tp, RECORDS, columns)
    assert _members(tp) == _members(jp)
    assert t_xlsx.read_xlsx(tp) == j_xlsx.read_xlsx(jp)


@pytest.mark.parametrize("header", [None, ["k", "v", "w"]])
def test_write_xlsx_members_match_jax(tmp_path, header):
    rows = [["a", 1.5, None], ["b", None, 7], [False, "x&y", 1e-7], []]
    jp, tp = str(tmp_path / "j.xlsx"), str(tmp_path / "t.xlsx")
    j_xlsx.write_xlsx(jp, rows, header=header)
    t_xlsx.write_xlsx(tp, rows, header=header)
    assert _members(tp) == _members(jp)
    assert t_xlsx.read_xlsx(tp) == j_xlsx.read_xlsx(jp)


def test_read_xlsx_of_an_empty_sheet(tmp_path):
    path = str(tmp_path / "e.xlsx")
    t_xlsx.write_xlsx(path, [])
    assert t_xlsx.read_xlsx(path) == j_xlsx.read_xlsx(path) == []
