"""Trainer: the loop around the training step (counterpart of
``merlin_tpu/train/trainer.py``), on one card.

Responsibilities: the freeze matrix (frozen parameters stop requiring
gradients), the optimizer and its state, the host -> device batch feed
(prefetched two batches ahead), step timing and loss logging, checkpoint
save / rotate / auto-resume (with the data-iterator state), and the final
save. There is no mesh: parallelism is a later slice.
"""

from __future__ import annotations

import collections
import logging
import time
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from merlin_tpu_torch.train.checkpoint import (
    latest_checkpoint, restore_checkpoint, save_checkpoint)
from merlin_tpu_torch.train.optimizer import build_optimizer
from merlin_tpu_torch.train.step import (
    make_train_step, stack_microbatches, stop_frozen_params)
from merlin_tpu_torch.utils.profiling import StepTimer, train_step_flops

logger = logging.getLogger("merlin_tpu_torch.train")


class Trainer:
    """Trains ``bundle.model``, whose parameters already lie on ``device``
    (e.g. from ``init_params(requires_grad=True, dtype=torch.float32)``)."""

    def __init__(self, bundle, training_args, *, device="cuda"):
        if training_args.lora_enable:
            raise NotImplementedError("LoRA is not ported yet")
        self.bundle = bundle
        self.args = training_args
        self.device = torch.device(device)
        model = bundle.model
        if bundle.trainable_mask is not None:
            stop_frozen_params(model, bundle.trainable_mask)
        self.optimizer, self.schedule = build_optimizer(
            training_args, model.named_parameters(),
            n_vit_layers=bundle.config.vit.num_layers,
            n_llm_layers=bundle.config.lm.num_layers,
            trainable_fn=bundle.trainable_mask,
            embed_row_mask=bundle.embed_row_trainable)
        self._train_step = make_train_step(
            model, self.optimizer,
            use_packing_segments=training_args.packing_segment_mask)
        self.step = 0
        self._consumed_data_state = None

    def init_state(self) -> Dict:
        """Zero Adam moments for the trainable parameters, step 0."""
        self.optimizer.init_state()
        self.step = 0
        return self.optimizer.state_dict()

    def maybe_resume(self) -> int:
        """Resume from ``resume_from_checkpoint`` or the newest
        checkpoint-* dir in ``output_dir``; returns the step (0 if none)."""
        path = self.args.resume_from_checkpoint or latest_checkpoint(
            self.args.output_dir)
        if not path:
            return 0
        self.step, data_state = restore_checkpoint(
            path, self.bundle.model, self.optimizer)
        logger.info("resumed from %s at step %d", path, self.step)
        self._resumed_data_state = data_state
        return self.step

    def train(self, batches: Iterator[Dict[str, np.ndarray]], *,
              num_steps: Optional[int] = None,
              log_fn=None) -> Dict[str, float]:
        """Run steps up to ``num_steps`` (``max_steps``, else
        ``num_train_steps``). Each host batch holds accum * micro rows."""
        args = self.args
        total = num_steps or (args.max_steps if args.max_steps > 0
                              else args.num_train_steps)
        accum = max(args.gradient_accumulation_steps, 1)
        last_metrics: Dict[str, float] = {}
        n_params = sum(p.numel() for p in self.bundle.model.parameters())
        tokens_per_step = (args.per_device_train_batch_size * accum
                           * args.model_max_length)
        timer = StepTimer(
            tokens_per_step=tokens_per_step,
            flops_per_step=train_step_flops(
                n_params, tokens_per_step, args.gradient_checkpointing))

        feed = self._device_prefetch(batches, accum)
        t0 = time.perf_counter()
        for step in range(self.step, total):
            metrics = self._train_step(next(feed))
            self.step = step + 1
            if args.logging_steps and (step + 1) % args.logging_steps == 0:
                metrics = {k: float(v) for k, v in metrics.items()}
                dt = time.perf_counter() - t0
                t0 = time.perf_counter()
                metrics["lr"] = float(np.float32(self.schedule(step)))
                metrics["step_time_s"] = dt / args.logging_steps
                metrics.update(timer.tick())
                last_metrics = metrics
                logger.info("step %d: %s", step + 1, " ".join(
                    f"{k}={v:.4g}" for k, v in metrics.items()))
                if log_fn:
                    log_fn(step + 1, metrics)
            if args.save_steps and (step + 1) % args.save_steps == 0:
                save_checkpoint(args.output_dir, step + 1, self.bundle.model,
                                self.optimizer,
                                data_state=self._data_state(step + 1),
                                save_total_limit=args.save_total_limit)
        return last_metrics

    def _data_state(self, step: int) -> Dict:
        """seed + step, and the stream cursor of the last consumed batch
        when the pipeline attaches one."""
        out = {"step": step, "seed": self.args.seed}
        if self._consumed_data_state is not None:
            out["datasets"] = self._consumed_data_state
        return out

    def _device_prefetch(self, batches, accum: int, depth: int = 2):
        """Stack microbatches and copy them to the device ``depth`` batches
        ahead (pinned host memory, non-blocking on a card), so the copy
        overlaps the step before. A batch's resume cursor
        (``__data_state__``) is recorded when the batch is yielded, so a
        checkpoint never runs ahead of what was consumed."""
        queue = collections.deque()
        pin = self.device.type == "cuda"

        def put(x):
            t = torch.as_tensor(x)
            if pin:
                t = t.pin_memory()
            return t.to(self.device, non_blocking=True)

        def pop(entry):
            batch, state = entry
            if state is not None:
                self._consumed_data_state = state
            return batch

        for batch in batches:
            batch = dict(batch)
            state = batch.pop("__data_state__", None)
            batch = stack_microbatches(batch, accum)
            queue.append(({k: put(v) for k, v in batch.items()}, state))
            if len(queue) >= depth:
                yield pop(queue.popleft())
        while queue:
            yield pop(queue.popleft())

    def save_final(self) -> str:
        return save_checkpoint(
            self.args.output_dir, self.step, self.bundle.model,
            self.optimizer, data_state=self._data_state(self.step),
            save_total_limit=0)
