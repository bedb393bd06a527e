"""Training with ``--bf16 False``, the port's ``Trainer`` against the JAX
package's ``make_train_step`` on the CPU: the ``tiny=True`` bundle built
from ``TrainingArguments(bf16=False)`` in both packages, the same flax
parameters bridged into the port, 2 steps at gradient accumulation 2 with
remat, LLRD and clipping (the recipe's optimizer). Loss, ``grad_norm`` and
``update_norm`` per step and every parameter after the run.

On the card the same steps run the f32 kernels: B2 and the f32 backward
(B10 + B11) in the LM, B12 and B13 in the tower (``chip_smoke.py`` phase
F4). f32 on both sides: metrics to 1e-5 relative; parameters to 1e-3 of
the summed learning rate (Adam carries an element's rounding difference
into its update at full size), key biases to 3 times it (their exact
gradient is 0, C14).
"""

import jax
import numpy as np
import pytest
import torch

from merlin_tpu.models.builder import build_model_tokenizer, init_or_load_params
from merlin_tpu.train import arguments as jargs
from merlin_tpu.train.optimizer import build_optimizer as j_build_optimizer
from merlin_tpu.train.step import TrainState, make_train_step
from merlin_tpu.train.step import stack_microbatches as j_stack

from merlin_tpu_torch.models import builder as t_builder
from merlin_tpu_torch.models.bridge import params_from_flax
from merlin_tpu_torch.models.builder import make_bundle
from merlin_tpu_torch.train import arguments as targs_mod
from merlin_tpu_torch.train.trainer import Trainer

TOL = 1e-5
PARAM_TOL = 1e-3
STEPS, ACCUM = 2, 2
TRAIN_KW = dict(bf16=False, gradient_checkpointing=True,
                model_max_length=24, max_steps=3, learning_rate=1e-2,
                warmup_ratio=0.34, gradient_accumulation_steps=ACCUM,
                per_device_train_batch_size=1, logging_steps=1, save_steps=0,
                llrd=True, llm_llrd=True, weight_decay=0.05,
                max_grad_norm=1.0)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _batches(cfg, n, seed=0, rows=ACCUM, seq=24):
    """Collator-format batches: one image block a row, labels -100 over
    the prompt, the last row's tail padded."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(7, 120, size=(rows, seq)).astype(np.int32)
        tok = cfg.image_token_len
        ids[:, 1] = cfg.im_start_id
        ids[:, 2:2 + tok] = cfg.image_patch_id
        ids[:, 2 + tok] = cfg.im_end_id
        labels = ids.copy()
        labels[:, :3 + tok] = -100
        mask = np.ones((rows, seq), np.int32)
        mask[-1, seq - 5:] = 0
        labels[mask == 0] = -100
        ids[mask == 0] = 0
        out.append(dict(input_ids=ids, labels=labels, attention_mask=mask,
                        segment_ids=mask.copy(),
                        images=rng.integers(0, 256, size=(rows, 1, 16, 16, 3),
                                            dtype=np.uint8)))
    return out


def test_trainer_at_bf16_false_matches_jax_train_step():
    data_kw = dict(image_size=16)
    jbundle = build_model_tokenizer(
        jargs.ModelArguments(), jargs.DataArguments(**data_kw),
        jargs.TrainingArguments(**TRAIN_KW), tiny=True)
    init_or_load_params(jbundle, rng=jax.random.key(5))
    targs = targs_mod.TrainingArguments(**TRAIN_KW)
    assert targs.bf16 is False
    tbundle = t_builder.build_model_tokenizer(
        targs_mod.ModelArguments(), targs_mod.DataArguments(**data_kw),
        targs, tiny=True)
    assert tbundle.config.lm.dtype == torch.float32
    assert tbundle.config.vit.dtype == torch.float32
    model = tbundle.model
    model.load_state_dict(params_from_flax(
        jax.tree.map(np.asarray, jbundle.params)), strict=True, assign=True)
    batches = _batches(jbundle.config, STEPS)

    cfg = jbundle.config
    tx, schedule = j_build_optimizer(
        jargs.TrainingArguments(**TRAIN_KW), n_vit_layers=cfg.vit.num_layers,
        n_llm_layers=cfg.lm.num_layers, trainable_fn=jbundle.trainable_mask,
        embed_row_mask=jbundle.embed_row_trainable)
    step_fn = make_train_step(jbundle.model, tx, donate=False,
                              trainable_fn=jbundle.trainable_mask)
    state = TrainState.create(jbundle.params, tx)
    want = []
    for b in batches:
        state, m = step_fn(state, j_stack(b, ACCUM))
        want.append({k: float(v) for k, v in m.items()})
    want_params = params_from_flax(jax.tree.map(np.asarray, state.params))

    bundle = make_bundle(model, targs_mod.ModelArguments(),
                         jbundle.orig_vocab_size)
    trainer = Trainer(bundle, targs, device="cpu")
    trainer.init_state()
    seen = []
    trainer.train(iter([dict(b) for b in batches]), num_steps=STEPS,
                  log_fn=lambda step, m: seen.append(m))
    assert trainer.step == STEPS and len(seen) == STEPS
    for i, (got, w) in enumerate(zip(seen, want)):
        for key in ("loss", "grad_norm", "update_norm"):
            np.testing.assert_allclose(got[key], w[key], rtol=TOL,
                                       atol=1e-12, err_msg=f"{key} step {i}")
    lrs = sum(float(schedule(i)) for i in range(STEPS))
    assert lrs > 0
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32, name
        bound = (3 if name.endswith("k_proj.bias") else PARAM_TOL) * lrs
        assert (p.detach() - want_params[name]).abs().max() <= bound, name
