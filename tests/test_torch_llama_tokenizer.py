"""The port's ``LlamaLikeTokenizer`` and the SFT label mask against the JAX
package on the CPU: encodes, decodes and the vocabulary equal JAX's on the
same texts; the ``-2`` instruction offset keeps exactly the assistant
responses (+ EOS) and ``-1``/``-3`` break that, as in
``tests/test_llama_masking.py``, with each mask array-equal to JAX's; and
the pair packer's BOS de-duplication.
"""

import numpy as np
import pytest

from merlin_tpu.data.conversation_dataset import (
    mask_conversation_targets as j_mask)
from merlin_tpu.data.packing import PairPacker as JPairPacker
from merlin_tpu.utils import tokenizer as j_tokenizer
from merlin_tpu.utils.conversation import conv_vicuna_v1 as j_vicuna

from merlin_tpu_torch.data.conversation_dataset import (
    mask_conversation_targets as t_mask)
from merlin_tpu_torch.data.packing import PairPacker as TPairPacker
from merlin_tpu_torch.utils import tokenizer as t_tokenizer
from merlin_tpu_torch.utils.constants import (
    DEFAULT_IM_END_TOKEN, DEFAULT_IM_PATCH_TOKEN, DEFAULT_IM_START_TOKEN,
    IGNORE_INDEX)
from merlin_tpu_torch.utils.conversation import conv_vicuna_v1

Q1 = "What color is the sky during a clear day"
A1 = "The sky appears blue because of Rayleigh scattering of sunlight."
Q2 = "And at sunset"
A2 = "It shifts to red and orange as the light path lengthens."
CORPUS = [conv_vicuna_v1.system, "USER", "ASSISTANT", Q1, A1, Q2, A2]
MM_TOKENS = [DEFAULT_IM_PATCH_TOKEN, DEFAULT_IM_START_TOKEN,
             DEFAULT_IM_END_TOKEN]


def _render(pairs):
    conv = conv_vicuna_v1.copy()
    for q, a in pairs:
        conv.append_message(conv.roles[0], q)
        conv.append_message(conv.roles[1], a)
    return conv.get_prompt()


def _toks(corpus=CORPUS, mm=False, max_len=2048):
    out = []
    for mod in (j_tokenizer, t_tokenizer):
        tok = mod.LlamaLikeTokenizer(corpus, model_max_length=max_len)
        if mm:
            tok.add_tokens(MM_TOKENS)
        out.append(tok)
    return out


def _ids_and_labels(tok, mask, conversation, offset):
    ids = np.asarray(tok(conversation, truncation=True,
                         max_length=tok.model_max_length)["input_ids"][0],
                     np.int32)
    labels = mask(conversation, ids, tok, pad_id=tok.pad_token_id,
                  instruction_offset=offset, keep_bos=True)
    return ids, labels


def test_vicuna_template_equals_jax():
    conv = j_vicuna.copy()
    for q, a in [(Q1, A1), (Q2, A2)]:
        conv.append_message(conv.roles[0], q)
        conv.append_message(conv.roles[1], a)
    assert _render([(Q1, A1), (Q2, A2)]) == conv.get_prompt()


@pytest.mark.parametrize("legacy", [True, False], ids=["legacy", "new"])
def test_encodes_equal_jax(legacy):
    """Every encode, in one sequence of calls (unknown characters are
    learnt as they come), the special-token split, truncation, decodes and
    the ids of the HF surface."""
    jt = j_tokenizer.LlamaLikeTokenizer(CORPUS, legacy=legacy)
    tt = t_tokenizer.LlamaLikeTokenizer(CORPUS, legacy=legacy)
    texts = [_render([(Q1, A1), (Q2, A2)]), Q1 + "</s>" + A1,
             " leading space", "ünïcödé + symbols #42!", "",
             DEFAULT_IM_START_TOKEN + " x"]
    for t in (jt, tt):
        assert t.add_tokens(MM_TOKENS) == 3
    for text in texts:
        for special in (True, False):
            got = tt.encode(text, add_special_tokens=special)
            assert got == jt.encode(text, add_special_tokens=special)
            assert tt.decode(got) == jt.decode(got)
            assert tt.decode(got, skip_special_tokens=True) == \
                jt.decode(got, skip_special_tokens=True)
    batch = tt(texts[:2], truncation=True, max_length=7)["input_ids"]
    assert batch == jt(texts[:2], truncation=True, max_length=7)["input_ids"]
    assert all(len(x) <= 7 for x in batch)
    np.testing.assert_array_equal(
        tt(Q1, return_tensors="np")["input_ids"],
        jt(Q1, return_tensors="np")["input_ids"])
    assert tt._vocab == jt._vocab
    assert len(tt) == len(jt)
    for name in ("pad_token_id", "bos_token_id", "eos_token_id",
                 "unk_token_id"):
        assert getattr(tt, name) == getattr(jt, name)
    assert (tt.unk_token_id, tt.bos_token_id, tt.eos_token_id) == (0, 1, 2)
    for token in MM_TOKENS + ["never-seen"]:
        assert tt.convert_tokens_to_ids(token) == \
            jt.convert_tokens_to_ids(token)


def test_llama_round_cursor_exact():
    """Per-round lengths tile the whole encoding: the sample survives the
    mismatch guard and the last </s> is supervised."""
    jt, tt = _toks()
    conversation = _render([(Q1, A1), (Q2, A2)])
    jids, jlab = _ids_and_labels(jt, j_mask, conversation, -2)
    ids, labels = _ids_and_labels(tt, t_mask, conversation, -2)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(labels, jlab)
    assert not np.all(labels == IGNORE_INDEX)
    assert labels[-1] == tt.eos_token_id


def test_llama_masking_unmasks_exactly_the_responses():
    jt, tt = _toks()
    conversation = _render([(Q1, A1), (Q2, A2)])
    _, jlab = _ids_and_labels(jt, j_mask, conversation, -2)
    ids, labels = _ids_and_labels(tt, t_mask, conversation, -2)
    np.testing.assert_array_equal(labels, jlab)
    assert tt.decode(ids[labels != IGNORE_INDEX]) == f" {A1}</s> {A2}</s>"
    masked = tt.decode(ids[labels == IGNORE_INDEX])
    assert A1.split()[2] not in masked
    assert Q1.split()[1] in masked


@pytest.mark.parametrize("bad_offset", [-1, -3])
def test_llama_masking_off_by_one_fails(bad_offset):
    jt, tt = _toks()
    conversation = _render([(Q1, A1), (Q2, A2)])
    _, jlab = _ids_and_labels(jt, j_mask, conversation, bad_offset)
    ids, labels = _ids_and_labels(tt, t_mask, conversation, bad_offset)
    np.testing.assert_array_equal(labels, jlab)
    assert tt.decode(ids[labels != IGNORE_INDEX]) != f" {A1}</s> {A2}</s>"


def test_llama_single_round_with_image_tokens():
    jt, tt = _toks([conv_vicuna_v1.system, "USER", "ASSISTANT", Q1, A1],
                   mm=True)
    q = (DEFAULT_IM_START_TOKEN + DEFAULT_IM_PATCH_TOKEN * 4
         + DEFAULT_IM_END_TOKEN + " " + Q1)
    conversation = _render([(q, A1)])
    jids, jlab = _ids_and_labels(jt, j_mask, conversation, -2)
    ids, labels = _ids_and_labels(tt, t_mask, conversation, -2)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(labels, jlab)
    assert tt.decode(ids[labels != IGNORE_INDEX]) == f" {A1}</s>"
    patch_id = tt.convert_tokens_to_ids(DEFAULT_IM_PATCH_TOKEN)
    assert np.all(labels[ids == patch_id] == IGNORE_INDEX)


def test_packing_bos_dedup_with_llama_tokenizer():
    """Prompt and text both encode with BOS; the packer strips the text's,
    so each packed pair carries exactly one."""
    jt, tt = _toks(["describe the image", "a photo of a cat",
                    "another caption here"], mm=True, max_len=128)
    packed = {}
    for tok, mod, packer_cls in ((jt, j_tokenizer, JPairPacker),
                                 (tt, t_tokenizer, TPairPacker)):
        sids = mod.SpecialIds(
            pad=tok.pad_token_id, bos=tok.bos_token_id,
            eos=tok.eos_token_id, unk=tok.unk_token_id,
            image_patch=tok.convert_tokens_to_ids(DEFAULT_IM_PATCH_TOKEN),
            im_start=tok.convert_tokens_to_ids(DEFAULT_IM_START_TOKEN),
            im_end=tok.convert_tokens_to_ids(DEFAULT_IM_END_TOKEN))
        packer = packer_cls(tok, sids, image_token_len=4,
                            model_max_length=128)
        packed[mod] = packer.pack([("describe the image", "a photo of a cat"),
                                   (None, "another caption here")])
    sample = packed[t_tokenizer]
    for f in ("input_ids", "labels", "segment_ids"):
        np.testing.assert_array_equal(getattr(sample, f),
                                      getattr(packed[j_tokenizer], f))
    ids, segs = sample.input_ids, sample.segment_ids
    for s in np.unique(segs):
        seg_ids = ids[segs == s]
        assert int((seg_ids == tt.bos_token_id).sum()) == 1, s
        assert seg_ids[0] == tt.bos_token_id
