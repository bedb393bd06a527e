"""Flag system: the reference's three dataclass groups (a copy of
``merlin_tpu/train/arguments.py``).

The fields are the JAX package's, so one command line parses into either
package. The port's trainer runs on one card: the mesh fields are read by
no code of the port yet (parallelism is a later slice), and LoRA and
``scan_layers`` are refused where they would be read. Parse from a command
line with :func:`parse_args` (``transformers.HfArgumentParser`` when it is
installed, plain argparse otherwise).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional


@dataclass
class ModelArguments:
    model_name_or_path: str = "lmsys/vicuna-7b-v1.5"
    vision_tower: Optional[str] = "openai/clip-vit-large-patch14"
    pretrain_model: Optional[str] = None
    projector: str = "conv"                     # mlp|conv|qwen|sam|resampler
    conv_stride: int = 2
    mm_vision_select_layer: int = -2
    mm_vision_select_feature: str = "patch"
    mm_use_im_start_end: bool = True
    freeze_lm_model: bool = False
    freeze_vision_tower: bool = False
    freeze_projector: bool = False
    tune_im_start_end: bool = True              # keep new-token rows trainable
    version: str = "v1"                         # conversation template
    # nn.scan the LM layer stack: one compiled block regardless of depth
    # (training compiles AND the scanned paged-decode serving path).
    # Checkpoints convert into the stacked layout at load. Note: LLRD's
    # per-depth lr scaling does not apply to a scanned stack.
    scan_layers: bool = False


@dataclass
class DataArguments:
    # one string of '+'-separated registry names per family
    conversation_datasets: Optional[str] = None
    pair_datasets: Optional[str] = None
    pair_token_datasets: Optional[str] = None
    interpair_datasets: Optional[str] = None
    interleave_datasets: Optional[str] = None
    image_size: int = 448
    image_aspect_ratio: str = "resize"          # keep|pad|resize|none
    num_patches: int = 256
    box_limit: int = 30
    # fixed image slots per sample in a batch (static shapes; samples with
    # more images are clipped, fewer pad with zero images)
    max_images: int = 8
    is_multimodal: bool = True
    use_beam_search: bool = False
    # eval
    eval_file: Optional[str] = None
    eval_image_dir: Optional[str] = None
    eval_output: Optional[str] = None


@dataclass
class TrainingArguments:
    output_dir: str = "output"
    per_device_train_batch_size: int = 1
    gradient_accumulation_steps: int = 8
    learning_rate: float = 5e-5
    adam_beta1: float = 0.9
    adam_beta2: float = 0.95
    adam_epsilon: float = 1e-8
    weight_decay: float = 0.05
    max_grad_norm: float = 1.0
    warmup_ratio: float = 0.01
    lr_scheduler_type: str = "cosine"
    num_train_steps: int = 10000
    max_steps: int = -1                          # overrides num_train_steps
    model_max_length: int = 2048
    gradient_checkpointing: bool = True
    bf16: bool = True
    seed: int = 3407
    # layer-wise lr decay (reference llrd_utils.py)
    llrd: bool = False                           # ViT 0.9^depth
    llm_llrd: bool = False                       # LLM 0.931^depth
    # data/loader
    group_by_modality_length: bool = False
    dataloader_num_workers: int = 4
    # checkpointing
    save_steps: int = 500
    save_total_limit: int = 2
    logging_steps: int = 1
    resume_from_checkpoint: Optional[str] = None
    # lora
    lora_enable: bool = False
    lora_r: int = 64
    lora_alpha: int = 16
    lora_dropout: float = 0.05
    # mesh / parallelism (TPU-specific)
    mesh_data: int = -1
    mesh_fsdp: int = 1
    mesh_seq: int = 1
    mesh_tensor: int = 1
    dcn_data_parallelism: int = 1
    # segment-aware packing (reference packs WITHOUT attention separation;
    # turning this on gives proper block-diagonal masking)
    packing_segment_mask: bool = False


def parse_args(argv: Optional[List[str]] = None):
    """CLI -> (ModelArguments, DataArguments, TrainingArguments)."""
    try:
        from transformers import HfArgumentParser

        parser = HfArgumentParser(
            (ModelArguments, DataArguments, TrainingArguments))
        return parser.parse_args_into_dataclasses(args=argv)
    except ImportError:
        import argparse

        parser = argparse.ArgumentParser()
        for cls in (ModelArguments, DataArguments, TrainingArguments):
            for f in dataclasses.fields(cls):
                kw = dict(default=f.default)
                if f.type in ("bool", bool):
                    kw["type"] = lambda s: s.lower() in ("1", "true", "yes")
                elif f.type in ("int", int):
                    kw["type"] = int
                elif f.type in ("float", float):
                    kw["type"] = float
                parser.add_argument(f"--{f.name}", **kw)
        ns = parser.parse_args(argv)
        pick = lambda cls: cls(**{f.name: getattr(ns, f.name)
                                  for f in dataclasses.fields(cls)})
        return (pick(ModelArguments), pick(DataArguments),
                pick(TrainingArguments))
