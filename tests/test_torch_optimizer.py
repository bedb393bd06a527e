"""The port's optimizer (``merlin_tpu_torch.train.optimizer``) against the
JAX package's optax chain (``build_optimizer``) on the CPU, over 3 updates
of the same parameters and gradients: clip by the global norm, Adam (eps
outside the sqrt), the decay mask, LLRD, the schedule read at the count
before its increment (lr 0 on the first update of a warmup), the freeze
labels and the embedding row mask.

f32 on both sides; the two differ in the order of a few f32 operations and
in the schedule's arithmetic (f64 in the port, f32 in optax): parameters
and Adam moments agree to 1e-6 of each tensor's largest value (seen:
~1e-7), norms to 1e-5 relative.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from merlin_tpu.train.optimizer import build_optimizer as j_build
from merlin_tpu.train.optimizer import make_lr_schedule as j_schedule

from merlin_tpu_torch.train.optimizer import (
    build_optimizer, decays, lr_scale_for_path, make_lr_schedule, path_names)

VOCAB, ORIG_VOCAB = 12, 9
SHAPES = {
    "vision_tower.vit.embeddings.patch_embedding.kernel": (2, 2, 3, 8),
    "vision_tower.vit.layers_0.q_proj.kernel": (8, 8),
    "vision_tower.vit.layers_0.q_proj.bias": (8,),
    "vision_tower.vit.layers_1.fc1.kernel": (8, 16),     # last layer: frozen
    "vision_tower.vit.pre_norm.scale": (8,),
    "projector.conv.kernel": (3, 3, 8, 6),
    "projector.conv.bias": (6,),
    "lm.embed_tokens.embedding": (VOCAB, 6),
    "lm.layers_0.attn.q_proj.kernel": (6, 6),
    "lm.layers_1.mlp.up_proj.kernel": (6, 10),
    "lm.layers_1.input_norm.scale": (6,),
    "lm.final_norm.scale": (6,),
}
PARAM_TOL = 1e-6


def _args(**kw):
    base = dict(max_steps=8, num_train_steps=100, warmup_ratio=0.25,
                learning_rate=1e-2, lr_scheduler_type="cosine", llrd=True,
                llm_llrd=True, adam_beta1=0.9, adam_beta2=0.95,
                adam_epsilon=1e-8, weight_decay=0.05, max_grad_norm=1.0)
    base.update(kw)
    return SimpleNamespace(**base)


def _nest(flat):
    tree = {}
    for name, x in flat.items():
        node = tree
        *head, leaf = name.split(".")
        for key in head:
            node = node.setdefault(key, {})
        node[leaf] = x
    return tree


def _flat(tree, prefix=()):
    out = {}
    for key, x in tree.items():
        if isinstance(x, dict):
            out.update(_flat(x, prefix + (key,)))
        else:
            out[".".join(prefix + (key,))] = np.asarray(x)
    return out


def _frozen_lm(path):
    """freeze_lm_model with tune_im_start_end, the last ViT layer frozen."""
    if "layers_1" in path and path[0] == "vision_tower":
        return False
    return path[0] != "lm" or "embed_tokens" in path


def _row_mask():
    mask = np.zeros((VOCAB,), np.float32)
    mask[ORIG_VOCAB:] = 1.0
    mask[2] = 1.0                               # a new token at a low id
    return mask


CASES = {
    # warmup 2 of 8, clipping on every update (grad norm ~ 30 > 1)
    "cosine_llrd_clipped": dict(args=_args(), grad_scale=1.0),
    # a clipped norm of ~3e-4: an epsilon in the clip (torch's
    # clip_grad_norm_ adds 1e-6) would move the moments by 0.3%
    "cosine_small_grads_clipped": dict(args=_args(max_grad_norm=1e-4),
                                       grad_scale=1e-5),
    # linear decay, no clip, LLM LLRD only
    "linear_no_clip": dict(args=_args(lr_scheduler_type="linear", llrd=False,
                                      max_grad_norm=1e3), grad_scale=0.1),
    # constant lr, heavy decay, frozen LM whose new-token rows train
    "constant_frozen_lm_rows": dict(
        args=_args(lr_scheduler_type="constant", weight_decay=0.5),
        grad_scale=1.0, trainable=_frozen_lm, row_mask=_row_mask()),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimizer_matches_optax_chain(case):
    c = CASES[case]
    args, trainable, row_mask = c["args"], c.get("trainable"), c.get(
        "row_mask")
    rng = np.random.default_rng(0)
    init = {n: rng.normal(size=s).astype(np.float32) for n, s in SHAPES.items()}
    grads = [{n: (c["grad_scale"] * rng.normal(size=s)).astype(np.float32)
              for n, s in SHAPES.items()} for _ in range(3)]

    tx, _ = j_build(args, n_vit_layers=2, n_llm_layers=2,
                    trainable_fn=trainable, embed_row_mask=row_mask)
    jparams = jax.tree.map(jnp.asarray, _nest(init))
    jstate = tx.init(jparams)

    tparams = {n: torch.from_numpy(x.copy()) for n, x in init.items()}
    opt, _ = build_optimizer(args, tparams.items(), n_vit_layers=2,
                             n_llm_layers=2, trainable_fn=trainable,
                             embed_row_mask=row_mask)
    opt.init_state()
    trained = set(opt.params)
    if trainable is not None:
        assert trained == {n for n in SHAPES if trainable(path_names(n))}

    for g in grads:
        jg = jax.tree.map(jnp.asarray, _nest(g))
        updates, jstate = tx.update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        metrics = opt.step({n: torch.from_numpy(g[n].copy())
                            for n in trained})
        want_norm = float(optax.global_norm(
            {n: x for n, x in _flat(jg).items() if n in trained}))
        np.testing.assert_allclose(float(metrics["grad_norm"]), want_norm,
                                   rtol=1e-5)
        np.testing.assert_allclose(float(metrics["update_norm"]),
                                   float(optax.global_norm(updates)),
                                   rtol=1e-5, atol=1e-12)
        for name, w in _flat(jparams).items():
            _assert_close(tparams[name].numpy(), w, name)
        for moment in ("mu", "nu"):
            want = _flat(optax.tree_utils.tree_get(jstate, moment))
            for name in trained:
                _assert_close(getattr(opt, moment)[name].numpy(), want[name],
                              f"{moment} {name}")
    # frozen parameters never moved and hold no Adam state
    for name in set(SHAPES) - trained:
        np.testing.assert_array_equal(tparams[name].numpy(), init[name])
        assert name not in opt.mu and name not in opt.nu
    if row_mask is not None:
        emb = "lm.embed_tokens.embedding"
        keep = row_mask == 0
        np.testing.assert_array_equal(tparams[emb].numpy()[keep],
                                      init[emb][keep])
        assert (tparams[emb].numpy()[~keep] != init[emb][~keep]).all()
        # Adam's moments of the masked rows still saw their gradients
        assert np.abs(opt.mu[emb].numpy()[keep]).min() > 0


def _assert_close(got, want, name):
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, atol=PARAM_TOL,
                               rtol=0, err_msg=name)


@pytest.mark.parametrize("budget", [1, 50, 1 << 29])
def test_update_is_the_same_in_runs_of_tensors(budget, monkeypatch):
    """The update is computed over runs of at most ``budget`` elements (one
    tensor a run at 1); every split gives the one-run result bit for bit."""
    from merlin_tpu_torch.train import optimizer as topt

    runs = list(topt._chunks([s for s in (60, 10, 30, 80, 5)], budget))
    assert runs[0][0] == 0 and runs[-1][1] == 5
    assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))

    def train(chunk):
        monkeypatch.setattr(topt, "_CHUNK_ELEMENTS", chunk)
        rng = np.random.default_rng(1)
        params = {n: torch.from_numpy(rng.normal(size=s).astype(np.float32))
                  for n, s in SHAPES.items()}
        opt, _ = build_optimizer(_args(), params.items(), n_vit_layers=2,
                                 n_llm_layers=2, embed_row_mask=_row_mask())
        opt.init_state()
        for _ in range(3):
            opt.step({n: torch.from_numpy(rng.normal(size=s).astype(
                np.float32)) for n, s in SHAPES.items()})
        return params

    want, got = train(1 << 29), train(budget)
    for name in SHAPES:
        assert torch.equal(got[name], want[name]), name


def test_first_update_is_zero_under_warmup():
    """The schedule is read at the count before its increment: a warmup
    from 0 gives lr 0, so the first update is zero (decay included)."""
    tparams = {n: torch.ones(s) for n, s in SHAPES.items()}
    opt, schedule = build_optimizer(_args(weight_decay=0.5), tparams.items(),
                                    n_vit_layers=2, n_llm_layers=2)
    opt.init_state()
    metrics = opt.step({n: torch.ones(s) for n, s in SHAPES.items()})
    assert schedule(0) == 0.0 and float(metrics["update_norm"]) == 0.0
    assert all(bool((p == 1).all()) for p in tparams.values())
    metrics = opt.step({n: torch.ones(s) for n, s in SHAPES.items()})
    assert float(metrics["update_norm"]) > 0


@pytest.mark.parametrize("kind,max_steps,warmup_ratio", [
    ("cosine", 8, 0.25), ("cosine", 1, 0.01), ("cosine", 20, 0.5),
    ("linear", 8, 0.25), ("linear", 1, 0.01), ("constant", 8, 0.25)])
def test_schedule_matches_optax(kind, max_steps, warmup_ratio):
    args = _args(lr_scheduler_type=kind, max_steps=max_steps,
                 warmup_ratio=warmup_ratio)
    mine, theirs = make_lr_schedule(args), j_schedule(args)
    for count in range(max_steps + 3):
        np.testing.assert_allclose(mine(count), float(theirs(count)),
                                   rtol=1e-6, atol=1e-12, err_msg=str(count))


def test_path_rules_match_jax():
    """LLRD scales and the decay mask per path, the same as the JAX
    package's for every parameter of the table above."""
    from merlin_tpu.train.optimizer import lr_scale_for_path as j_scale
    from merlin_tpu.train.optimizer import weight_decay_mask

    j_decay = _flat(weight_decay_mask(_nest(
        {n: np.zeros(s) for n, s in SHAPES.items()})))
    for name, shape in SHAPES.items():
        path = path_names(name)
        for llrd, llm_llrd in ((True, True), (False, True), (True, False)):
            kw = dict(llrd=llrd, llm_llrd=llm_llrd, n_vit_layers=24,
                      n_llm_layers=32)
            assert lr_scale_for_path(path, **kw) == j_scale(path, **kw)
        assert decays(path, torch.zeros(shape)) == bool(j_decay[name])
