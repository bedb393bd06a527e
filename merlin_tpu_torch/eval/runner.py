"""Shared eval-model runner: prompt assembly, image preprocessing and
decoding (counterpart of ``merlin_tpu/eval/runner.py``).

Every harness builds a Vicuna-v1 prompt whose images are
``<im_start><im_patch>*N<im_end>`` blocks, decodes it greedily, sampled
(``Generator``), by beam search (``num_beams > 1``, ``BeamSearch``) or by
prompt-lookup speculative windows (``speculative=k``,
``SpeculativeGenerator``), and strips the output. ``device`` reaches every
generator.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from merlin_tpu_torch.data.images import preprocess_pil
from merlin_tpu_torch.generate.beam import BeamSearch
from merlin_tpu_torch.generate.decode import GenerateConfig, Generator
from merlin_tpu_torch.generate.speculative import SpeculativeGenerator
from merlin_tpu_torch.utils import constants as C
from merlin_tpu_torch.utils.conversation import conv_templates


@dataclasses.dataclass
class EvalConfig:
    temperature: float = 1.0
    do_sample: bool = False
    num_beams: int = 1
    max_new_tokens: int = 1024
    conv_template: str = "v1"
    image_aspect_ratio: str = "resize"
    language: str = "en"
    # greedy-exact prompt-lookup speculative decoding with k-token drafts
    # (generate/speculative.py); 0 = off. Greedy single-beam only
    speculative: int = 0


class EvalModel:
    """bundle (model with its weights + tokenizer) -> ask(question, images)
    -> text."""

    def __init__(self, bundle, eval_cfg: EvalConfig = EvalConfig(), *,
                 device: Union[str, torch.device] = "cuda"):
        self.bundle = bundle
        self.cfg = eval_cfg
        self.tokenizer = bundle.tokenizer
        gen_cfg = GenerateConfig(
            max_new_tokens=eval_cfg.max_new_tokens,
            do_sample=eval_cfg.do_sample, temperature=eval_cfg.temperature,
            num_beams=eval_cfg.num_beams,
            eos_id=self.tokenizer.eos_token_id,
            pad_id=self.tokenizer.pad_token_id)
        if eval_cfg.num_beams > 1:
            self._engine = BeamSearch(bundle.model, gen_cfg, device=device)
        elif eval_cfg.speculative and not eval_cfg.do_sample:
            spec = SpeculativeGenerator(bundle.model, gen_cfg,
                                        draft_len=eval_cfg.speculative,
                                        device=device)
            # the Generator's (ids, ...) -> (b, T) tokens surface: drop the
            # window counts; greedy, so the random generator is unused
            self._engine = (lambda *a, generator=None, **kw:
                            spec(*a, **kw)[0])
        else:
            self._engine = Generator(bundle.model, gen_cfg, device=device)

    # ------------------------------------------------------------------
    def build_prompt(self, question: str, num_images: int = 1) -> str:
        """``<image>`` occurrences (or a prepended block) become patch runs;
        returns the full conversation prompt ending at 'ASSISTANT:'."""
        placeholder = C.image_placeholder(
            self.bundle.config.image_token_len,
            self.bundle.config.use_im_start_end)
        if C.DEFAULT_IMAGE_TOKEN in question:
            qs = question.replace(C.DEFAULT_IMAGE_TOKEN, placeholder)
        elif num_images > 0:
            qs = placeholder + "\n" + question
        else:
            qs = question
        conv = conv_templates[self.cfg.conv_template].copy()
        conv.append_message(conv.roles[0], qs)
        conv.append_message(conv.roles[1], None)
        return conv.get_prompt()

    def preprocess_images(self, images: Sequence) -> Optional[np.ndarray]:
        """PIL images or uint8 (S, S, 3) arrays -> (1, n, S, S, 3) uint8.
        Arrays are taken as they are, with no PIL."""
        if not images:
            return None
        out = []
        for img in images:
            if isinstance(img, np.ndarray):
                out.append(img)
            else:
                out.append(preprocess_pil(
                    img, self.bundle.config.vit.image_size,
                    self.cfg.image_aspect_ratio))
        return np.stack(out)[None].astype(np.uint8)

    def decode_output(self, tokens: np.ndarray) -> str:
        """Strip pads, the EOS tail and surrounding whitespace."""
        eos = self.tokenizer.eos_token_id
        pad = self.tokenizer.pad_token_id
        keep = []
        for t in np.asarray(tokens).reshape(-1).tolist():
            if t == eos:
                break
            if t != pad:
                keep.append(int(t))
        text = self.tokenizer.decode(keep, skip_special_tokens=True).strip()
        if text.endswith(C.DEFAULT_EOS_TOKEN):
            text = text[: -len(C.DEFAULT_EOS_TOKEN)].strip()
        return text

    def _encode(self, prompt: str) -> np.ndarray:
        enc = self.tokenizer(prompt)["input_ids"]
        return np.asarray(enc[0] if enc and isinstance(enc[0], list)
                          else enc, np.int32)

    def _run(self, ids, images, generator, **kwargs) -> np.ndarray:
        if images is not None:
            kwargs["images"] = images
        if isinstance(self._engine, BeamSearch):
            return self._engine(ids, **kwargs)
        return self._engine(ids, generator=generator, **kwargs)

    def ask_batch(self, questions: Sequence[str],
                  images_per_question: Sequence[Sequence] = (),
                  generator: Optional[torch.Generator] = None) -> List[str]:
        """Batched QA: the prompts are right-padded to one length and every
        row gets the same number of image slots (zero images fill the
        rest); one prefill and decode serve the batch."""
        if not images_per_question:
            images_per_question = [()] * len(questions)
        enc_list = [self._encode(self.build_prompt(q, num_images=len(imgs)))
                    for q, imgs in zip(questions, images_per_question)]
        max_len = max(len(e) for e in enc_list)
        pad = self.tokenizer.pad_token_id
        ids = np.full((len(enc_list), max_len), pad, np.int32)
        mask = np.zeros((len(enc_list), max_len), bool)
        for i, e in enumerate(enc_list):
            ids[i, : len(e)] = e
            mask[i, : len(e)] = True

        max_imgs = max((len(im) for im in images_per_question), default=0)
        imgs_arr = None
        if max_imgs:
            size = self.bundle.config.vit.image_size
            imgs_arr = np.zeros(
                (len(enc_list), max_imgs, size, size, 3), np.uint8)
            for i, imgs in enumerate(images_per_question):
                got = self.preprocess_images(imgs)
                if got is not None:
                    imgs_arr[i, : got.shape[1]] = got[0]
        out = self._run(ids, imgs_arr, generator, attention_mask=mask)
        return [self.decode_output(row) for row in out]

    def ask(self, question: str, images: Sequence = (),
            generator: Optional[torch.Generator] = None) -> str:
        ids = self._encode(self.build_prompt(question,
                                             num_images=len(images)))[None]
        out = self._run(ids, self.preprocess_images(images), generator)
        return self.decode_output(out[0])
