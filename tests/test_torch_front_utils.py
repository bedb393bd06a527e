"""The port's copies of the front end's utilities against the JAX
package's, on the same inputs: the constants and ``image_placeholder``;
every conversation template's prompt for a multi-turn, multi-image
conversation, and ``copy()``; the ``TinyTokenizer`` over one sequence of
calls; ``resize_embeddings_mean_init``; ``preprocess_pil`` in all four
aspect modes; the chunk protocol; the moderation gate.
"""

import io

import numpy as np
import pytest
import torch
from PIL import Image

from merlin_tpu.data import images as j_images
from merlin_tpu.serve import protocol as j_protocol
from merlin_tpu.utils import constants as j_constants
from merlin_tpu.utils import conversation as j_conversation
from merlin_tpu.utils import tokenizer as j_tokenizer

from merlin_tpu_torch.data import images as t_images
from merlin_tpu_torch.serve import protocol as t_protocol
from merlin_tpu_torch.utils import constants as t_constants
from merlin_tpu_torch.utils import conversation as t_conversation
from merlin_tpu_torch.utils import logging as t_logging
from merlin_tpu_torch.utils import mm_utils as t_mm_utils
from merlin_tpu_torch.utils import tokenizer as t_tokenizer


def test_constants_equal_jax():
    names = [n for n in dir(j_constants) if n.isupper()]
    assert len(names) == 16
    for name in names:
        assert getattr(t_constants, name) == getattr(j_constants, name), name
    for n, start_end in ((256, True), (4, False), (1, True)):
        assert t_constants.image_placeholder(n, start_end) == \
            j_constants.image_placeholder(n, start_end)
    assert t_constants.image_placeholder() == j_constants.image_placeholder()


def _frame(seed, size=(40, 30)):
    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 256, size=size[::-1] + (3,),
                                        dtype=np.uint8))


def _converse(module, name):
    conv = module.conv_templates[name].copy()
    img = (_frame(0),)
    conv.append_message(conv.roles[0], ("<image>\nWhat is in the frames?",
                                        img[0], "Default"))
    conv.append_message(conv.roles[1], "A cat.")
    conv.append_message(conv.roles[0], "<image>\nAnd here? <image>")
    conv.append_message(conv.roles[1], "Two dogs.")
    conv.append_message(conv.roles[0], "Where are they?")
    conv.append_message(conv.roles[1], None)
    return conv


@pytest.mark.parametrize("name", sorted(j_conversation.conv_templates))
def test_every_template_renders_like_jax(name):
    want = _converse(j_conversation, name)
    got = _converse(t_conversation, name)
    assert got.get_prompt() == want.get_prompt()
    assert got.dict() == want.dict()
    assert got.to_chatbot() == want.to_chatbot()
    assert got.get_images() == want.get_images()
    copy = got.copy()
    copy.append_message(copy.roles[0], "more")
    assert len(copy.messages) == len(got.messages) + 1
    assert got.get_prompt() == want.get_prompt()
    assert t_conversation.conv_templates[name].messages == []


def test_default_conversation_is_vicuna_v1():
    assert t_conversation.default_conversation.version == \
        j_conversation.default_conversation.version == "v1"
    assert [s.name for s in t_conversation.SeparatorStyle] == \
        [s.name for s in j_conversation.SeparatorStyle]


def _drive_tokenizer(module):
    """One sequence of calls; returns everything it observed."""
    tok = module.TinyTokenizer(model_max_length=16)
    seen = [tok.add_tokens(module.MM_SPECIAL_TOKENS, special_tokens=True),
            tok.add_tokens(module.BOX_SPECIAL_TOKENS + ["<im_patch>"])]
    text = ("USER: <im_start><im_patch><im_patch><im_end>\nhello world "
            "hello </s> <box> again")
    seen.append(tok.encode(text))
    seen.append(tok.encode("new words here", add_special_tokens=False))
    seen.append(tok.tokenize(text))
    out = tok(["a b c d e f g h i j k l m n o p q r s", "x y"],
              truncation=True)
    seen.append(out["input_ids"])
    seen.append(tok("a b", return_tensors="np")["input_ids"].tolist())
    ids = seen[2] + [999]
    seen += [tok.decode(ids), tok.decode(ids, skip_special_tokens=True),
             tok.batch_decode([seen[3], seen[2]], skip_special_tokens=True),
             len(tok), tok.pad_token_id, tok.bos_token_id, tok.eos_token_id,
             tok.unk_token_id, tok.convert_tokens_to_ids("<box_end>"),
             tok.convert_tokens_to_ids("never-seen")]
    return seen


def test_tiny_tokenizer_matches_jax():
    assert t_tokenizer.MM_SPECIAL_TOKENS == j_tokenizer.MM_SPECIAL_TOKENS
    assert t_tokenizer.BOX_SPECIAL_TOKENS == j_tokenizer.BOX_SPECIAL_TOKENS
    assert _drive_tokenizer(t_tokenizer) == _drive_tokenizer(j_tokenizer)


def test_resize_embeddings_mean_init_matches_jax():
    emb = np.random.default_rng(0).normal(size=(10, 6)).astype(np.float32)
    want = j_tokenizer.resize_embeddings_mean_init(emb, 13)
    got = t_tokenizer.resize_embeddings_mean_init(torch.from_numpy(emb), 13)
    assert got.shape == (13, 6)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    same = t_tokenizer.resize_embeddings_mean_init(torch.from_numpy(emb), 8)
    assert same.shape == (10, 6)


@pytest.mark.parametrize("mode", ["resize", "pad", "keep", "none"])
def test_preprocess_pil_is_byte_equal(mode):
    for size in ((40, 30), (30, 52)):
        img = _frame(1, size)
        want = j_images.preprocess_pil(img, 16, mode)
        got = t_images.preprocess_pil(img, 16, mode)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        t_images.preprocess_pil(img, 16, "stretch")


def test_image_loading_matches_jax(tmp_path):
    buf = io.BytesIO()
    _frame(2).save(buf, format="PNG")
    path = tmp_path / "frame.png"
    path.write_bytes(buf.getvalue())
    for src in (buf.getvalue(), str(path)):
        np.testing.assert_array_equal(
            np.asarray(t_images.load_image(src)),
            np.asarray(j_images.load_image(src)))
    np.testing.assert_array_equal(
        np.asarray(t_mm_utils.load_image(str(path))),
        np.asarray(j_images.load_image(str(path))))
    np.testing.assert_array_equal(
        t_images.load_and_preprocess(str(path), 16),
        j_images.load_and_preprocess(str(path), 16))
    np.testing.assert_array_equal(
        t_images.load_and_preprocess(str(tmp_path / "missing.png"), 16),
        t_images.zero_image(16))


def test_chunk_protocol_gives_equal_bytes():
    payloads = [{"text": "héllo </s>", "error_code": 0},
                {"text": "", "error_code": int(t_protocol.ErrorCode.TIMEOUT)}]
    for p in payloads:
        assert t_protocol.pack_chunk(p) == j_protocol.pack_chunk(p)
    stream = io.BytesIO(b"".join(t_protocol.pack_chunk(p) for p in payloads))
    assert list(t_protocol.iter_chunks(stream)) == payloads
    assert [int(e) for e in t_protocol.ErrorCode] == \
        [int(e) for e in j_protocol.ErrorCode]
    assert t_protocol.WorkerStatus(["m"]).__dict__ == \
        j_protocol.WorkerStatus(["m"]).__dict__


def test_moderation_fails_open_without_a_key(monkeypatch):
    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    assert t_mm_utils.violates_moderation("anything") is False
    assert t_mm_utils.pretty_print_semaphore(None) == "None"


def test_logger_rate_limits(caplog):
    logger = t_logging.setup_logger(name="merlin_tpu_torch.test_front")
    logger.propagate = True
    try:
        for _ in range(5):
            t_logging.log_every_n(logger, "front utils every 3", n=3)
        assert caplog.text.count("front utils every 3") == 2
    finally:
        logger.propagate = False
