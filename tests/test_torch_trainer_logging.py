"""The port's ``Trainer`` logs one step's time and the throughput of the
steps it ran when it logs every ``logging_steps`` > 1 steps: the step is
replaced by a stub that advances a fake clock by one second, so each log
must read ``step_time_s`` 1, ``tokens_per_sec`` the tokens of one step and
``mfu`` one step's FLOPs a second against the peak."""

import types

import pytest
import torch

from merlin_tpu_torch.models import builder
from merlin_tpu_torch.train import arguments
from merlin_tpu_torch.train import trainer as trainer_mod
from merlin_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("logging_steps", [1, 3])
def test_logged_throughput_is_per_step(monkeypatch, logging_steps):
    targs = arguments.TrainingArguments(
        gradient_checkpointing=False, model_max_length=24,
        per_device_train_batch_size=1, gradient_accumulation_steps=2,
        logging_steps=logging_steps, save_steps=0, max_steps=4)
    bundle = builder.build_model_tokenizer(
        arguments.ModelArguments(), arguments.DataArguments(image_size=16),
        targs, tiny=True)
    builder.init_or_load_params(
        bundle, generator=torch.Generator().manual_seed(0), device="cpu")
    trainer = trainer_mod.Trainer(bundle, targs, device="cpu")
    trainer.init_state()

    clock = types.SimpleNamespace(now=0.0)
    fake_time = types.SimpleNamespace(perf_counter=lambda: clock.now)
    monkeypatch.setattr(trainer_mod, "time", fake_time)
    monkeypatch.setattr(profiling, "time", fake_time)

    def one_second_step(batch):
        clock.now += 1.0
        return {"loss": torch.tensor(1.0)}
    trainer._train_step = one_second_step
    trainer._device_prefetch = lambda batches, accum: batches

    logs = []
    steps = 4 * logging_steps
    trainer.train(iter(range(steps)), num_steps=steps,
                  log_fn=lambda step, m: logs.append(m))
    assert len(logs) == 4
    tokens = 2 * 24                        # rows of a step x sequence
    n_params = sum(p.numel() for p in bundle.model.parameters())
    flops = profiling.train_step_flops(n_params, tokens, False)
    for m in logs:
        assert m["step_time_s"] == pytest.approx(1.0)
    # the timer reads from its second tick on
    for m in logs[1:]:
        assert m["tokens_per_sec"] == pytest.approx(tokens)
        assert m["mfu"] == pytest.approx(flops / profiling.PEAK_BF16_FLOPS)
