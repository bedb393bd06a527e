"""The whole training slice against the JAX package on the CPU: the JAX
``make_train_step`` on the ``tiny=True`` bundle and the port's ``Trainer``
on the same parameters and batches, 3 steps at gradient accumulation 2
(remat on, uint8 images normalized in the step, right padding in the
attention mask). Loss, ``grad_norm`` and ``update_norm`` per step, and
every parameter after the run; frozen parameters unchanged. Then the
port's checkpoints: round trip, rotation, and a resumed run that lands on
the same parameters as an uninterrupted one.

f32 on both sides: metrics agree to 1e-5 relative. Adam scales each
element's update to ~lr whatever its gradient's size, so an element whose
gradient is small carries the frameworks' rounding difference into its
update at full size: parameters are held to 1e-3 of the summed learning
rate, the most any element can move (seen: 7.3e-5). A key bias is the
extreme case: its gradient is zero in exact arithmetic (softmax ignores a
per-query constant), so both frameworks hold rounding noise, which Adam
turns into updates of ~lr; it is held to 3 times the summed lr.
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

from merlin_tpu_torch.models.bridge import params_from_flax
from merlin_tpu_torch.models.builder import make_bundle
from merlin_tpu_torch.models.families import tiny
from merlin_tpu_torch.models.mmgpt import MMGPT, MMGPTConfig
from merlin_tpu_torch.models.vit import tiny_vit
from merlin_tpu_torch.train import arguments as targs_mod
from merlin_tpu_torch.train.checkpoint import list_checkpoints
from merlin_tpu_torch.train.trainer import Trainer

TOL = 1e-5
PARAM_TOL = 1e-3
STEPS, ACCUM = 3, 2
TRAIN_KW = dict(gradient_checkpointing=True, model_max_length=24,
                max_steps=4, learning_rate=1e-2, warmup_ratio=0.25,
                gradient_accumulation_steps=ACCUM,
                per_device_train_batch_size=1, logging_steps=1, save_steps=0,
                llrd=True, llm_llrd=True, weight_decay=0.05,
                max_grad_norm=1.0)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax_bundle(model_kw):
    bundle = build_model_tokenizer(
        jargs.ModelArguments(**model_kw), jargs.DataArguments(image_size=16),
        jargs.TrainingArguments(**TRAIN_KW), tiny=True)
    init_or_load_params(bundle, rng=jax.random.key(3))
    return bundle


def _port_model(jbundle):
    """The port's MMGPT with the JAX bundle's geometry and parameters."""
    c = jbundle.config
    cfg = MMGPTConfig(lm=tiny(remat=c.lm.remat), vit=tiny_vit(),
                      projector=c.projector, conv_stride=c.conv_stride,
                      select_layer=c.select_layer,
                      image_patch_id=c.image_patch_id,
                      im_start_id=c.im_start_id, im_end_id=c.im_end_id)
    model = MMGPT(cfg)
    model.load_state_dict(params_from_flax(
        jax.tree.map(np.asarray, jbundle.params)), strict=True)
    return model


def _batches(cfg, n, seed=0, rows=ACCUM, seq=24):
    """n host batches in the collator's format: one image block per row,
    labels -100 over the prompt, the last rows padded."""
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


def _port_trainer(model, model_kw, orig_vocab, **kw):
    bundle = make_bundle(model, targs_mod.ModelArguments(**model_kw),
                         orig_vocab)
    trainer = Trainer(bundle, targs_mod.TrainingArguments(**{**TRAIN_KW, **kw}),
                      device="cpu")
    trainer.init_state()
    return trainer


def _train(trainer, batches):
    seen = []
    trainer.train(iter([dict(b) for b in batches]), num_steps=trainer.step
                  + len(batches), log_fn=lambda step, m: seen.append(m))
    return seen


FREEZE = {"nothing_frozen": {},
          "frozen_lm_new_rows": dict(freeze_lm_model=True,
                                     tune_im_start_end=True)}


@pytest.mark.parametrize("case", sorted(FREEZE))
def test_trainer_matches_jax_train_step(case):
    model_kw = FREEZE[case]
    jbundle = _jax_bundle(model_kw)
    batches = _batches(jbundle.config, STEPS)
    n_vit, n_llm = jbundle.config.vit.num_layers, jbundle.config.lm.num_layers

    targs = jargs.TrainingArguments(**TRAIN_KW)
    tx, schedule = j_build_optimizer(
        targs, n_vit_layers=n_vit, n_llm_layers=n_llm,
        trainable_fn=jbundle.trainable_mask,
        embed_row_mask=jbundle.embed_row_trainable)
    step_fn = make_train_step(jbundle.model, tx, donate=False,
                              trainable_fn=jbundle.trainable_mask)
    state = TrainState.create(jbundle.params, tx)
    want = []
    for b in batches:
        state, m = step_fn(state, j_stack(b, ACCUM))
        want.append({k: float(v) for k, v in m.items()})
    want_params = params_from_flax(jax.tree.map(np.asarray, state.params))

    model = _port_model(jbundle)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    trainer = _port_trainer(model, model_kw, jbundle.orig_vocab_size)
    seen = _train(trainer, batches)
    assert trainer.step == STEPS and len(seen) == STEPS
    for i, (got, w) in enumerate(zip(seen, want)):
        for key in ("loss", "grad_norm", "update_norm"):
            np.testing.assert_allclose(got[key], w[key], rtol=TOL,
                                       atol=1e-12, err_msg=f"{key} step {i}")
        np.testing.assert_allclose(got["lr"], float(schedule(i)), rtol=1e-6)
    assert seen[0]["update_norm"] == 0.0             # lr 0 at count 0

    lrs = sum(float(schedule(i)) for i in range(STEPS))
    trainable = trainer.optimizer.params
    for name, p in model.named_parameters():
        got, w = p.detach(), want_params[name]
        if name not in trainable:                    # frozen: bit-identical
            assert torch.equal(got, before[name]), name
            continue
        bound = (3 if name.endswith("k_proj.bias") else PARAM_TOL) * lrs
        assert (got - w).abs().max() <= bound, name
    if model_kw:
        emb = model.lm.embed_tokens.embedding.detach()
        was = before["lm.embed_tokens.embedding"]
        rows = torch.from_numpy(jbundle.embed_row_trainable).bool()
        assert torch.equal(emb[~rows], was[~rows])
        special = [jbundle.config.im_start_id, jbundle.config.im_end_id]
        assert (emb[special] != was[special]).any(-1).all()
        assert "lm.layers_0.attn.q_proj.kernel" not in trainable


def _fresh_port_model(seed=0):
    torch.manual_seed(seed)
    cfg = MMGPTConfig(lm=tiny(remat=True), vit=tiny_vit(), image_patch_id=4,
                      im_start_id=5, im_end_id=6)
    return MMGPT(cfg)


def test_checkpoint_round_trip_rotation_and_resume(tmp_path):
    """Train 3 steps straight; train 2 steps saving every step (limit 2:
    checkpoint-1 rotates out), then resume a fresh model and optimizer from
    the newest checkpoint and take step 3: bit-identical parameters and
    Adam state, and the data cursor the last consumed batch carried."""
    batches = _batches(_fresh_port_model().cfg, STEPS, seed=1)
    for i, b in enumerate(batches):
        b["__data_state__"] = {"cursor": i + 1}

    straight = _port_trainer(_fresh_port_model(), {}, 125)
    _train(straight, batches)

    out = str(tmp_path / "run")
    first = _port_trainer(_fresh_port_model(), {}, 125, output_dir=out,
                          save_steps=1, save_total_limit=2)
    _train(first, batches[:2])
    assert [s for s, _ in list_checkpoints(out)] == [1, 2]
    assert first.save_final().endswith("checkpoint-2")  # no rotation
    assert [s for s, _ in list_checkpoints(out)] == [1, 2]

    resumed = _port_trainer(_fresh_port_model(seed=9), {}, 125,
                            output_dir=out, save_steps=1, save_total_limit=2)
    assert resumed.maybe_resume() == 2
    assert resumed._resumed_data_state == {"step": 2, "seed": 3407,
                                           "datasets": {"cursor": 2}}
    _train(resumed, batches[2:])
    assert resumed.step == STEPS
    assert [s for s, _ in list_checkpoints(out)] == [2, 3]
    for (name, a), (_, b) in zip(straight.bundle.model.named_parameters(),
                                 resumed.bundle.model.named_parameters()):
        assert torch.equal(a, b), name
    for n in straight.optimizer.mu:
        assert torch.equal(straight.optimizer.mu[n], resumed.optimizer.mu[n])
        assert torch.equal(straight.optimizer.nu[n], resumed.optimizer.nu[n])
    assert resumed.optimizer.count == straight.optimizer.count == STEPS


def test_maybe_resume_without_checkpoint_starts_fresh(tmp_path):
    trainer = _port_trainer(_fresh_port_model(), {}, 125,
                            output_dir=str(tmp_path / "empty"))
    assert trainer.maybe_resume() == 0 and trainer.step == 0


def test_trainer_refuses_lora():
    with pytest.raises(NotImplementedError, match="LoRA"):
        _port_trainer(_fresh_port_model(), {}, 125, lora_enable=True)
