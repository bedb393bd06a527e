"""The port's functional LoRA (``merlin_tpu_torch.train.lora``) against the
JAX package's on the CPU, on the ``tiny=True`` bundle.

  * The two tests of ``tests/test_towers_lora.py:102,121`` on the port:
    the targets (LM projections only, no head) and the zero-init identity;
    Adam over the factors lowers the loss and moves only them.
  * ``merge_lora`` and ``make_lora_loss_fn`` on JAX's factors carried
    across (b drawn non-zero, so both factors get a gradient): the merged
    kernels, the loss and every factor's gradient against
    ``jax.value_and_grad``. f32: loss 1e-5 relative, merged kernels 1e-6,
    gradients 1e-4 of each factor's largest.
  * The port's own ``init_lora_params``: shapes, b zero, a ~ N(0, 1) / r.
  * ``split_lora_state`` against JAX's.
  * The ``Trainer`` still refuses ``lora_enable`` (trap C30).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from merlin_tpu.models import builder as j_builder
from merlin_tpu.train import lora as j_lora
from merlin_tpu.train.arguments import (
    DataArguments, ModelArguments, TrainingArguments)

from merlin_tpu_torch.models import builder as t_builder
from merlin_tpu_torch.models.bridge import params_from_flax
from merlin_tpu_torch.train import arguments as t_arguments
from merlin_tpu_torch.train.lora import (
    DEFAULT_TARGET_RE, find_lora_targets, init_lora_params,
    make_lora_loss_fn, merge_lora, split_lora_state)
from merlin_tpu_torch.train.trainer import Trainer

from test_torch_trainer import _batches

RANK, ALPHA = 2, 8.0


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _port_bundle():
    bundle = t_builder.build_model_tokenizer(*t_arguments.parse_args(
        ["--image_size", "16", "--model_max_length", "64",
         "--gradient_checkpointing", "False"]), tiny=True)
    t_builder.init_or_load_params(bundle, device="cpu")
    bundle.model.eval()
    return bundle


@pytest.fixture(scope="module")
def pair():
    """JAX's tiny bundle and the port's on the same parameters."""
    jb = j_builder.build_model_tokenizer(
        ModelArguments(), DataArguments(image_size=16),
        TrainingArguments(gradient_checkpointing=False, model_max_length=64),
        tiny=True)
    j_builder.init_or_load_params(jb)
    tb = _port_bundle()
    tb.model.load_state_dict(params_from_flax(jax.device_get(jb.params)),
                             strict=True)
    tb.params = tb.model.state_dict()
    return jb, tb


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_lora_targets_and_zero_init_identity():
    bundle = _port_bundle()
    targets = find_lora_targets(bundle.params)
    assert any("attn.q_proj.kernel" in t for t in targets)
    assert all(t.startswith("lm.") for t in targets)
    assert not any("lm_head" in t for t in targets)
    lora = init_lora_params(bundle.params, rank=4)
    merged = merge_lora(bundle.params, lora, rank=4, alpha=16)
    q0 = "lm.layers_0.attn.q_proj.kernel"
    assert torch.equal(merged[q0], bundle.params[q0])


def test_lora_training_moves_only_factors():
    bundle = _port_bundle()
    base = {n: t.clone() for n, t in bundle.params.items()}
    lora = init_lora_params(bundle.params, rank=RANK)
    loss_fn = make_lora_loss_fn(bundle.model, bundle.params, rank=RANK,
                                alpha=ALPHA)
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(4, 90, size=(2, 12)))
    batch = dict(input_ids=ids, labels=ids,
                 segment_ids=torch.ones_like(ids),
                 attention_mask=torch.ones_like(ids))
    factors = [t.requires_grad_() for e in lora.values() for t in e.values()]
    opt = torch.optim.Adam(factors, lr=1e-2)
    with torch.no_grad():
        loss0 = float(loss_fn(lora, batch))
    for _ in range(5):
        opt.zero_grad()
        loss_fn(lora, batch).backward()
        opt.step()
    with torch.no_grad():
        loss1 = float(loss_fn(lora, batch))
    assert loss1 < loss0
    assert lora[sorted(lora)[0]]["b"].abs().max() > 0
    for name, t in bundle.model.state_dict().items():
        assert torch.equal(t, base[name]), name
        assert not t.requires_grad or t.grad is None, name


def test_targets_match_jax(pair):
    jb, tb = pair
    want = [t.replace("/", ".") for t in j_lora.find_lora_targets(jb.params)]
    assert find_lora_targets(tb.params) == want
    assert DEFAULT_TARGET_RE.pattern.replace("\\.", "/") == \
        j_lora.DEFAULT_TARGET_RE.pattern


def _jax_factors(jb):
    """JAX's factors, b drawn non-zero so that a gets a gradient too."""
    lora = j_lora.init_lora_params(jb.params, rank=RANK,
                                   rng=jax.random.key(4))
    rng = np.random.default_rng(2)
    return {k: {"a": np.asarray(v["a"]),
                "b": 0.1 * rng.normal(size=v["b"].shape).astype(np.float32)}
            for k, v in lora.items()}


def test_merge_loss_and_factor_grads_match_jax(pair):
    jb, tb = pair
    jlora = _jax_factors(jb)
    tlora = {k.replace("/", "."): {n: torch.from_numpy(x.copy())
                                   for n, x in v.items()}
             for k, v in jlora.items()}
    jmerged = params_from_flax(jax.device_get(merge_lora_jax(jb, jlora)))
    tmerged = merge_lora(tb.params, tlora, rank=RANK, alpha=ALPHA)
    assert sorted(jmerged) == sorted(tmerged)
    for name, t in tmerged.items():
        np.testing.assert_allclose(t.numpy(), jmerged[name].numpy(),
                                   atol=1e-6, err_msg=name)

    batch = _batches(tb.config, 1, seed=3)[0]
    jloss_fn = j_lora.make_lora_loss_fn(jb.model, jb.params, rank=RANK,
                                        alpha=ALPHA)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jl, jg = jax.value_and_grad(jloss_fn)(
        jax.tree.map(jnp.asarray, jlora), jbatch)

    for entry in tlora.values():
        for t in entry.values():
            t.requires_grad_()
    loss_fn = make_lora_loss_fn(tb.model, tb.params, rank=RANK, alpha=ALPHA)
    tl = loss_fn(tlora, _torch_batch(batch))
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    for name, entry in jg.items():
        for factor, g in entry.items():
            g = np.asarray(g)
            got = tlora[name.replace("/", ".")][factor].grad.numpy()
            np.testing.assert_allclose(
                got, g, rtol=1e-4, atol=1e-4 * float(np.abs(g).max()),
                err_msg=f"{name} {factor}")
    for name, p in tb.model.named_parameters():
        assert p.grad is None, name


def merge_lora_jax(jb, jlora):
    return j_lora.merge_lora(jb.params, jax.tree.map(jnp.asarray, jlora),
                             rank=RANK, alpha=ALPHA)


def test_init_lora_params_statistics(pair):
    _, tb = pair
    gen = torch.Generator().manual_seed(0)
    lora = init_lora_params(tb.params, rank=16, generator=gen)
    assert sorted(lora) == find_lora_targets(tb.params)
    a = torch.cat([e["a"].reshape(-1) for e in lora.values()])
    for name, entry in lora.items():
        leaf = tb.params[name]
        assert entry["a"].shape == (leaf.shape[0], 16)
        assert entry["b"].shape == (16, leaf[0].numel())
        assert entry["a"].dtype == entry["b"].dtype == torch.float32
        assert not entry["b"].any()
    assert abs(float(a.mean())) < 0.05 / 16
    assert abs(float(a.std()) * 16 - 1.0) < 0.05
    again = init_lora_params(tb.params, rank=16,
                             generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(lora[k]["a"], again[k]["a"]) for k in lora)


def test_split_lora_state_matches_jax(pair):
    jb, tb = pair
    jlora = j_lora.init_lora_params(jb.params, rank=RANK)
    j_state, j_rest = j_lora.split_lora_state(jb.params, jlora)
    lora = init_lora_params(tb.params, rank=RANK)
    state, rest = split_lora_state(tb.params, lora)
    assert state == lora and state is not lora
    want = params_from_flax(jax.device_get(j_rest["projector"]))
    assert sorted(rest["projector"]) == sorted(want)
    for name, t in rest["projector"].items():
        assert torch.equal(t, want[name]), name
    assert split_lora_state({"lm.x": torch.zeros(1)}, {})[1] == {
        "projector": None}


def test_trainer_keeps_refusing_lora(pair):
    """C30: JAX's trainer drops ``lora_enable``; the port's Trainer refuses
    it rather than train without the factors."""
    _, tb = pair
    with pytest.raises(NotImplementedError, match="lora_enable"):
        Trainer(tb, t_arguments.TrainingArguments(lora_enable=True),
                device="cpu")


def test_lora_gradients_hold_under_remat(pair):
    """With remat the backward recomputes each block: it must read the
    merged kernels the forward ran on, not the module's base ones, so the
    factor gradients equal those without remat (b non-zero)."""
    import dataclasses

    from merlin_tpu_torch.models.mmgpt import MMGPT

    jb, tb = pair
    jlora = _jax_factors(jb)
    batch = _torch_batch(_batches(tb.config, 1, seed=3)[0])
    grads = []
    for remat in (False, True):
        cfg = dataclasses.replace(tb.config, lm=dataclasses.replace(
            tb.config.lm, remat=remat))
        model = MMGPT(cfg)
        model.load_state_dict(tb.params, strict=True)
        lora = {k.replace("/", "."): {n: torch.from_numpy(x.copy())
                                      .requires_grad_()
                                      for n, x in v.items()}
                for k, v in jlora.items()}
        make_lora_loss_fn(model, model.state_dict(), rank=RANK,
                          alpha=ALPHA)(lora, batch).backward()
        grads.append({(k, n): t.grad for k, e in lora.items()
                      for n, t in e.items()})
    for key, g in grads[0].items():
        np.testing.assert_allclose(grads[1][key].numpy(), g.numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=str(key))
