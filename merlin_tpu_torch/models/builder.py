"""The model bundle and the freeze matrix (counterpart of the training part
of ``merlin_tpu/models/builder.py``).

:class:`ModelBundle` carries what the trainer needs beside the module: its
config, the vocabulary size before the multimodal tokens were added, and the
freeze matrix from :func:`_freeze_masks` (``builder.py:129-160``): which
parameter paths train, and which embedding rows may move while a frozen LM
keeps the rest of its table. ``build_model_tokenizer`` and the checkpoint
loaders come with the tokenizer and converter copies.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
from torch import nn

from merlin_tpu_torch.models.mmgpt import MMGPTConfig


@dataclasses.dataclass
class ModelBundle:
    model: nn.Module                       # MMGPT, holding its parameters
    config: MMGPTConfig
    orig_vocab_size: int                   # rows before special tokens
    trainable_mask: Optional[Callable[[Tuple[str, ...]], bool]] = None
    embed_row_trainable: Optional[np.ndarray] = None  # per-row float mask


def _freeze_masks(model_args, cfg: MMGPTConfig, orig_vocab: int):
    """Reference freeze matrix -> (path -> trainable, embedding row mask).

    A path is a parameter name split at '.', the flax path the port keeps
    (``vision_tower.vit.layers_3.q_proj.kernel``). The last ViT layer never
    trains; a frozen LM keeps only its new-token embedding rows trainable
    when ``tune_im_start_end`` (base_mmgpt.py:78-97)."""
    last_layer = f"layers_{cfg.vit.num_layers - 1}"

    def trainable(path: Tuple[str, ...]) -> bool:
        if path[0] == "vision_tower":
            if last_layer in path:
                return False  # always-detached last ViT layer
            return not model_args.freeze_vision_tower
        if path[0] == "projector":
            return not model_args.freeze_projector
        if model_args.freeze_lm_model:
            # embeddings handled by the row mask; everything else frozen
            return "embed_tokens" in path and model_args.tune_im_start_end
        return True

    row_mask = None
    if model_args.freeze_lm_model and model_args.tune_im_start_end:
        row_mask = np.zeros((cfg.lm.vocab_size,), np.float32)
        row_mask[orig_vocab:] = 1.0
        # tokenizers that place the new tokens at low ids
        for tid in (cfg.image_patch_id, cfg.im_start_id, cfg.im_end_id):
            if 0 <= tid < cfg.lm.vocab_size:
                row_mask[tid] = 1.0
    return trainable, row_mask


def make_bundle(model: nn.Module, model_args,
                orig_vocab_size: int) -> ModelBundle:
    """Bundle an MMGPT with the freeze matrix ``model_args`` asks for."""
    trainable, row_mask = _freeze_masks(model_args, model.cfg,
                                        orig_vocab_size)
    return ModelBundle(model=model, config=model.cfg,
                       orig_vocab_size=orig_vocab_size,
                       trainable_mask=trainable,
                       embed_row_trainable=row_mask)
