"""Training entry point (counterpart of ``merlin_tpu/engine/train.py``), on
one card.

    python -m merlin_tpu_torch.engine.train \
        --model_name_or_path lmsys/vicuna-7b-v1.5 \
        --pair_datasets laion2b_10m_6merge \
        --interpair_datasets track_1m_v2_2merge+det_5m_v1_en_4merge \
        --output_dir output/pretrain ...

Flow: parse the three dataclass flag groups -> logger -> model+tokenizer ->
parameters on the device (init or checkpoint) -> dataloader -> Trainer ->
auto-resume from the newest checkpoint-* (parameters, optimizer and the
data cursor, loaded before the first batch is drawn) -> train -> final
save.

The process index is ``torch.distributed``'s rank when a process group is
initialized, else 0 of 1. The global batch is
``per_device_train_batch_size x gradient_accumulation_steps`` on the one
card (JAX multiplies by its local device count too).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

from merlin_tpu_torch.data.builder import (
    batch_iterator, build_dataloader, resume_data)
from merlin_tpu_torch.data.shards import process_index_count
from merlin_tpu_torch.models.builder import (
    build_model_tokenizer, init_or_load_params)
from merlin_tpu_torch.train.arguments import parse_args
from merlin_tpu_torch.train.trainer import Trainer
from merlin_tpu_torch.utils.logging import log_model_parameters, setup_logger


def train(argv: Optional[Sequence[str]] = None, *, tiny: bool = False,
          device="cuda"):
    """Train from the command line ``argv`` (``sys.argv`` when None) on
    ``device``; returns the last step's metrics."""
    model_args, data_args, training_args = parse_args(argv)
    rank, world = process_index_count()
    logger = setup_logger(training_args.output_dir, rank)
    logger.info("device: %s (process %d of %d)", device, rank, world)

    bundle = build_model_tokenizer(model_args, data_args, training_args,
                                   tiny=tiny)
    init_or_load_params(
        bundle,
        lm_checkpoint=model_args.model_name_or_path
        if os.path.isdir(model_args.model_name_or_path) else None,
        vision_checkpoint=model_args.vision_tower
        if model_args.vision_tower and os.path.isdir(model_args.vision_tower)
        else None,
        composite_checkpoint=model_args.pretrain_model, device=device)
    log_model_parameters(logger, bundle.params, bundle.trainable_mask)

    data = build_dataloader(bundle.tokenizer, bundle.special_ids, data_args,
                            training_args, process_index=rank,
                            process_count=world)
    global_batch = (training_args.per_device_train_batch_size
                    * training_args.gradient_accumulation_steps)

    trainer = Trainer(bundle, training_args, device=device)
    trainer.init_state()
    start = 0
    if trainer.maybe_resume():
        # the exact data cursor, before the producer thread draws a sample
        state = getattr(trainer, "_resumed_data_state", None) or {}
        start = resume_data(data["train_dataset"], state.get("datasets"))

    batches = batch_iterator(
        data["train_dataset"], data["collator"], batch_size=global_batch,
        sampler=data["sampler"], start=start)
    metrics = trainer.train(batches)
    trainer.save_final()
    logger.info("done: %s", metrics)
    return metrics


if __name__ == "__main__":
    train()
