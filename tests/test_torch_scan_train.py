"""Training a ``scan_layers`` model through the port, against the JAX
package on the CPU.

  * The port's ``Trainer`` on the ``tiny=True`` bundle built with
    ``scan_layers`` (stacked LM, remat) against JAX's ``make_train_step``
    without a mesh on the same parameters and batches: 3 steps at
    accumulation 2; loss, ``grad_norm``, ``update_norm``, every parameter
    and both Adam moments.
  * Trap C36, shown in both packages: JAX's decay mask exempts rank <= 1
    leaves, and a stacked norm scale is (L, hidden), so a scanned model
    decays its norm scales where a loop model does not; its layer-wise LR
    decay matches ``layers_<i>`` only, so a scanned LM gets none. The port
    keeps both for parity.
  * Checkpoints of a stacked model: save, restore and resume land on the
    straight run's parameters and moments, with the frozen stacked LM
    checked by its fingerprints.

Tolerances as in ``test_torch_trainer.py`` (moments: 1e-4 of each
tensor's largest element): metrics 1e-5 relative,
parameters 1e-3 of the summed learning rate (Adam moves an element by ~lr
whatever its gradient, so rounding differences move it at full size; a
key bias, whose exact gradient is zero, 3 times that).
"""

import jax
import numpy as np
import optax
import pytest
import torch

from merlin_tpu.models.builder import build_model_tokenizer, init_or_load_params
from merlin_tpu.train import arguments as jargs
from merlin_tpu.train import optimizer as j_optimizer
from merlin_tpu.train.optimizer import build_optimizer as j_build_optimizer
from merlin_tpu.train.step import TrainState, make_train_step
from merlin_tpu.train.step import stack_microbatches as j_stack

from merlin_tpu_torch.models.bridge import params_from_flax
from merlin_tpu_torch.models.builder import make_bundle
from merlin_tpu_torch.models.families import tiny
from merlin_tpu_torch.models.mmgpt import MMGPT, MMGPTConfig
from merlin_tpu_torch.models.vit import tiny_vit
from merlin_tpu_torch.train import arguments as targs_mod
from merlin_tpu_torch.train import optimizer as t_optimizer
from merlin_tpu_torch.train.checkpoint import list_checkpoints
from merlin_tpu_torch.train.trainer import Trainer

from test_torch_trainer import PARAM_TOL, TOL, TRAIN_KW, _batches

STEPS, ACCUM = 3, 2
MOMENT_TOL = 1e-4   # of the moment's largest element: the frameworks sum
                    # gradients in another order, and elements near 0 carry
                    # that difference at their own size
SCAN = dict(scan_layers=True)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax_bundle(**model_kw):
    bundle = build_model_tokenizer(
        jargs.ModelArguments(**SCAN, **model_kw),
        jargs.DataArguments(image_size=16),
        jargs.TrainingArguments(**TRAIN_KW), tiny=True)
    init_or_load_params(bundle, rng=jax.random.key(3))
    return bundle


def _port_model(jbundle):
    c = jbundle.config
    assert c.lm.scan_layers
    cfg = MMGPTConfig(lm=tiny(remat=c.lm.remat, scan_layers=True),
                      vit=tiny_vit(), projector=c.projector,
                      conv_stride=c.conv_stride, select_layer=c.select_layer,
                      image_patch_id=c.image_patch_id,
                      im_start_id=c.im_start_id, im_end_id=c.im_end_id)
    model = MMGPT(cfg)
    model.load_state_dict(params_from_flax(
        jax.tree.map(np.asarray, jbundle.params)), strict=True)
    return model


def _trainer(model, orig_vocab, model_kw=None, **kw):
    bundle = make_bundle(model, targs_mod.ModelArguments(
        **SCAN, **(model_kw or {})), orig_vocab)
    trainer = Trainer(bundle, targs_mod.TrainingArguments(**{**TRAIN_KW,
                                                             **kw}),
                      device="cpu")
    trainer.init_state()
    return trainer


def _train(trainer, batches):
    seen = []
    trainer.train(iter([dict(b) for b in batches]),
                  num_steps=trainer.step + len(batches),
                  log_fn=lambda step, m: seen.append(m))
    return seen


def test_scanned_trainer_matches_jax_train_step():
    jbundle = _jax_bundle()
    batches = _batches(jbundle.config, STEPS)
    targs = jargs.TrainingArguments(**TRAIN_KW)
    tx, schedule = j_build_optimizer(
        targs, n_vit_layers=jbundle.config.vit.num_layers,
        n_llm_layers=jbundle.config.lm.num_layers,
        trainable_fn=jbundle.trainable_mask)
    step_fn = make_train_step(jbundle.model, tx, donate=False,
                              trainable_fn=jbundle.trainable_mask)
    state = TrainState.create(jbundle.params, tx)
    want = []
    for b in batches:
        state, m = step_fn(state, j_stack(b, ACCUM))
        want.append({k: float(v) for k, v in m.items()})
    want_params = params_from_flax(jax.tree.map(np.asarray, state.params))

    model = _port_model(jbundle)
    assert model.lm.layers.block.input_norm.scale.shape[0] == \
        jbundle.config.lm.num_layers
    trainer = _trainer(model, jbundle.orig_vocab_size)
    seen = _train(trainer, batches)
    assert trainer.step == STEPS
    for i, (got, w) in enumerate(zip(seen, want)):
        for key in ("loss", "grad_norm", "update_norm"):
            np.testing.assert_allclose(got[key], w[key], rtol=TOL,
                                       atol=1e-12, err_msg=f"{key} step {i}")
    lrs = sum(float(schedule(i)) for i in range(STEPS))
    for name, p in model.named_parameters():
        bound = (3 if name.endswith("k_proj.bias") else PARAM_TOL) * lrs
        assert (p.detach() - want_params[name]).abs().max() <= bound, name
    opt = trainer.optimizer
    assert opt.count == STEPS
    for moment in ("mu", "nu"):
        jm = params_from_flax(jax.tree.map(
            np.asarray, optax.tree_utils.tree_get(state.opt_state, moment)))
        for name, t in getattr(opt, moment).items():
            w = jm[name].numpy()
            if name.endswith("k_proj.bias"):
                # an exact zero gradient: both hold rounding noise only
                assert max(float(t.abs().max()), float(np.abs(w).max())) \
                    < 1e-9, name
                continue
            np.testing.assert_allclose(
                t.numpy(), w, rtol=MOMENT_TOL,
                atol=MOMENT_TOL * float(np.abs(w).max()),
                err_msg=f"{moment} {name}")


def test_c36_stacked_norms_decay_and_lm_has_no_llrd():
    """Both packages: a stacked norm scale is decayed (a loop one is not),
    and no LM leaf of a scanned model gets a depth-wise LR scale."""
    jbundle = _jax_bundle()
    jmask = params_from_flax(jax.tree.map(
        lambda x: np.asarray(x), j_optimizer.weight_decay_mask(
            jbundle.params)))
    norm = "lm.layers.block.input_norm.scale"
    assert bool(jmask[norm].item()) is True
    jloop = build_model_tokenizer(
        jargs.ModelArguments(), jargs.DataArguments(image_size=16),
        jargs.TrainingArguments(**TRAIN_KW), tiny=True)
    init_or_load_params(jloop, rng=jax.random.key(3))
    loop_mask = params_from_flax(jax.tree.map(
        lambda x: np.asarray(x), j_optimizer.weight_decay_mask(
            jloop.params)))
    assert bool(loop_mask["lm.layers_0.input_norm.scale"].item()) is False

    model = _port_model(jbundle)
    opt = _trainer(model, jbundle.orig_vocab_size).optimizer
    assert opt.decay[norm] is True
    assert opt.decay["lm.final_norm.scale"] is False
    for name in opt.params:
        assert opt.decay[name] == bool(jmask[name].item()), name
    kw = dict(llrd=True, llm_llrd=True, n_vit_layers=2, n_llm_layers=2)
    for name in opt.params:
        path = tuple(name.split("."))
        want = j_optimizer.lr_scale_for_path(path, **kw)
        assert t_optimizer.lr_scale_for_path(path, **kw) == want
        assert opt.scale[name] == want, name
        if path[0] == "lm":
            assert want == 1.0, name
    # the loop LM's layers do get their depth scale, in both
    loop_path = ("lm", "layers_0", "attn", "q_proj", "kernel")
    assert t_optimizer.lr_scale_for_path(loop_path, **kw) == \
        j_optimizer.lr_scale_for_path(loop_path, **kw) == 0.931


def _fresh_scanned(seed=0):
    torch.manual_seed(seed)
    cfg = MMGPTConfig(lm=tiny(remat=True, scan_layers=True), vit=tiny_vit(),
                      image_patch_id=4, im_start_id=5, im_end_id=6)
    return MMGPT(cfg)


def test_stacked_checkpoint_save_restore_resume(tmp_path):
    """A scanned model with its LM frozen (the stacked leaves become
    fingerprints) and the tower and projector training: 3 steps straight
    equal 2 steps saved, restored into a fresh model, and a third step.
    A frozen stacked leaf that changed is refused on restore."""
    frozen = dict(freeze_lm_model=True, tune_im_start_end=True)
    batches = _batches(_fresh_scanned().cfg, STEPS, seed=1)
    straight = _trainer(_fresh_scanned(), 125, frozen)
    _train(straight, batches)

    out = str(tmp_path / "run")
    first = _trainer(_fresh_scanned(), 125, frozen, output_dir=out,
                     save_steps=1, save_total_limit=2)
    _train(first, batches[:2])
    assert [s for s, _ in list_checkpoints(out)] == [1, 2]
    saved = torch.load(f"{out}/checkpoint-2/model.pt", weights_only=True)
    assert "lm.layers.block.attn.q_proj.kernel" not in saved
    assert "vision_tower.vit.layers_0.mlp.fc1.kernel" in saved

    resumed = _trainer(_fresh_scanned(), 125, frozen, output_dir=out,
                       save_steps=1, save_total_limit=2)
    assert resumed.maybe_resume() == 2
    _train(resumed, batches[2:])
    for (name, a), (_, b) in zip(straight.bundle.model.named_parameters(),
                                 resumed.bundle.model.named_parameters()):
        assert torch.equal(a, b), name
    for n in straight.optimizer.mu:
        assert torch.equal(straight.optimizer.mu[n], resumed.optimizer.mu[n])
        assert torch.equal(straight.optimizer.nu[n], resumed.optimizer.nu[n])

    other = _trainer(_fresh_scanned(seed=5), 125, frozen, output_dir=out)
    with pytest.raises(ValueError, match="lm.layers.block"):
        other.maybe_resume()
