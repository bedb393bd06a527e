"""The training slice's model side against the JAX package on the CPU:
``cross_entropy_loss``, the loss and every parameter's gradient of the
decoder (Llama-like; Baichuan2-like with ALiBi, NormHead and z-loss; GQA)
and of the MMGPT with ``labels``, against ``jax.value_and_grad`` of the
same parameters; ``remat`` gives the same gradients; ``DenseGeneral``'s
backward rounds like JAX's transpose of a bf16 ``dot_general``; the int8
path refuses a gradient; ``init_params`` builds trainable parameters.

f32 everywhere except the bf16 DenseGeneral check: the two frameworks
differ only in summation order, so losses and gradients agree to 2e-5
relative to each tensor's largest value (seen: ~1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from merlin_tpu.models.decoder import CausalLM as JLM
from merlin_tpu.models.decoder import cross_entropy_loss as j_ce
from merlin_tpu.models.families import tiny as j_tiny
from merlin_tpu.models.layers import DenseGeneral as JDense
from merlin_tpu.models.mmgpt import MMGPT as JMMGPT
from merlin_tpu.models.mmgpt import MMGPTConfig as JMMGPTConfig
from merlin_tpu.models.vit import tiny_vit as j_tiny_vit

from merlin_tpu_torch.models.bridge import init_params, params_from_flax
from merlin_tpu_torch.models.decoder import (
    CausalLM, cross_entropy_loss, init_kv_cache)
from merlin_tpu_torch.models.families import tiny
from merlin_tpu_torch.models.layers import DenseGeneral, MatmulF32
from merlin_tpu_torch.models.mmgpt import MMGPT, MMGPTConfig
from merlin_tpu_torch.models.vit import tiny_vit

TOL = 2e-5
PATCH, START, END = 100, 101, 102


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.normal(size=x.shape).astype(
            np.float32), params)


def _assert_grads_match(tmodel, jgrads):
    want = params_from_flax(jax.tree.map(np.asarray, jgrads))
    got = {n: p.grad for n, p in tmodel.named_parameters()}
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        # a key bias shifts every score of a row alike, so softmax cancels
        # its gradient: zero in exact arithmetic, rounding noise in both
        # frameworks; it is held to the scale of its kernel's gradient
        ref = want[name[:-len("bias")] + "kernel"] \
            if name.endswith("k_proj.bias") else w
        scale = max(float(ref.abs().max()), 1e-6)
        np.testing.assert_allclose(g.numpy() / scale, w.numpy() / scale,
                                   atol=TOL, rtol=0, err_msg=name)


def _labels(ids, rng):
    labels = ids.copy()
    labels[:, :3] = -100
    labels[rng.random(labels.shape) < 0.2] = -100
    return labels


def test_cross_entropy_loss_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(2, 7, 11)).astype(np.float32) * 3
    labels = _labels(rng.integers(0, 11, size=(2, 7)).astype(np.int32), rng)
    for z in (0.0, 2e-4):
        want, wcount = j_ce(jnp.asarray(logits), jnp.asarray(labels),
                            z_loss_weight=z)
        got, count = cross_entropy_loss(torch.from_numpy(logits),
                                        torch.from_numpy(labels),
                                        z_loss_weight=z)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
        assert int(count) == int(wcount)
    # no valid token: the mean divides by at least one
    none = np.full((2, 7), -100, np.int32)
    got, count = cross_entropy_loss(torch.from_numpy(logits),
                                    torch.from_numpy(none))
    assert got.item() == 0.0 and int(count) == 0


LM_VARIANTS = {
    "llama": {},
    "baichuan2_alibi_normhead_zloss": dict(positional="alibi", normhead=True,
                                           z_loss_weight=2e-4),
    "gqa": dict(num_kv_heads=2),
}


@pytest.mark.parametrize("variant", sorted(LM_VARIANTS))
def test_decoder_loss_and_grads_match_jax(variant):
    kw = LM_VARIANTS[variant]
    jmodel, tmodel = JLM(j_tiny(**kw)), CausalLM(tiny(**kw))
    rng = np.random.default_rng(1)
    ids = rng.integers(1, 120, size=(2, 12)).astype(np.int32)
    labels = _labels(ids, rng)
    seg = np.ones_like(ids)
    seg[1, 9:] = 0                                   # right padding
    params = _perturbed(nn.unbox(jmodel.init(
        jax.random.key(0), jnp.asarray(ids))["params"]), 2)
    z = tmodel.cfg.z_loss_weight

    def jloss(p):
        logits, _ = jmodel.apply({"params": p}, jnp.asarray(ids),
                                 segment_ids=jnp.asarray(seg))
        return j_ce(logits, jnp.asarray(labels), z_loss_weight=z)[0]

    want, jgrads = jax.value_and_grad(jloss)(params)
    tmodel.load_state_dict(params_from_flax(params), strict=True)
    logits, _ = tmodel(torch.from_numpy(ids), segment_ids=torch.from_numpy(seg))
    loss, _ = cross_entropy_loss(logits, torch.from_numpy(labels),
                                 z_loss_weight=z)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=TOL)
    _assert_grads_match(tmodel, jgrads)


def _mm_inputs(tok_len, seed=3):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 90, size=(2, 24)).astype(np.int32)
    ids[:, 1] = START
    ids[:, 2:2 + tok_len] = PATCH
    ids[:, 2 + tok_len] = END
    labels = ids.copy()
    labels[:, :3 + tok_len] = -100
    images = rng.normal(size=(2, 1, 16, 16, 3)).astype(np.float32)
    seg = np.ones_like(ids)
    seg[0, 20:] = 0
    labels[0, 20:] = -100
    return ids, labels, images, seg


def test_mmgpt_loss_and_grads_match_jax():
    """MMGPT(labels=...) shifts the labels left by one and takes the
    decoder's loss; every parameter's gradient, tower and projector
    included, matches jax.value_and_grad."""
    jcfg = JMMGPTConfig(lm=j_tiny(), vit=j_tiny_vit(), image_patch_id=PATCH,
                        im_start_id=START, im_end_id=END)
    tcfg = MMGPTConfig(lm=tiny(), vit=tiny_vit(), image_patch_id=PATCH,
                       im_start_id=START, im_end_id=END)
    jmodel = JMMGPT(jcfg)
    ids, labels, images, seg = _mm_inputs(jcfg.image_token_len)
    params = _perturbed(nn.unbox(jmodel.init(
        jax.random.key(1), jnp.asarray(ids),
        images=jnp.asarray(images))["params"]), 4)

    def jloss(p):
        return jmodel.apply({"params": p}, jnp.asarray(ids),
                            images=jnp.asarray(images),
                            segment_ids=jnp.asarray(seg),
                            labels=jnp.asarray(labels))[2]

    want, jgrads = jax.value_and_grad(jloss)(params)
    tmodel = MMGPT(tcfg)
    tmodel.load_state_dict(params_from_flax(params), strict=True)
    logits, cache, loss = tmodel(torch.from_numpy(ids),
                                 images=torch.from_numpy(images),
                                 segment_ids=torch.from_numpy(seg),
                                 labels=torch.from_numpy(labels))
    assert cache is None and logits.shape == (2, 24, 128)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=TOL)
    _assert_grads_match(tmodel, jgrads)


def test_remat_gives_the_same_gradients():
    """remat recomputes each block in the backward: the same loss and the
    same gradients, bit for bit on the CPU; no-grad forwards and cached
    decoding do not checkpoint."""
    rng = np.random.default_rng(5)
    ids = torch.from_numpy(rng.integers(1, 120, size=(2, 10)))
    labels = torch.from_numpy(_labels(ids.numpy(), rng))
    grads = []
    for remat in (False, True):
        torch.manual_seed(0)
        model = CausalLM(tiny(remat=remat))
        calls = []
        for blk in model.blocks:
            # counted in forward itself: checkpoint's recompute skips hooks
            blk.forward = _counted(blk.forward, calls)
        logits, _ = model(ids)
        loss, _ = cross_entropy_loss(logits, labels)
        loss.backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
        # each block runs once in the forward, and again in the backward
        # under remat
        assert len(calls) == len(model.blocks) * (2 if remat else 1)
        calls.clear()
        with torch.no_grad():
            model(ids)
        model(ids, kv_cache=init_kv_cache(model.cfg, 2, 16, torch.float32,
                                          device="cpu"))
        assert len(calls) == 2 * len(model.blocks)
    for name, g in grads[0].items():
        np.testing.assert_array_equal(grads[1][name].numpy(), g.numpy(),
                                      err_msg=name)


def _counted(forward, calls):
    def run(*args, **kwargs):
        calls.append(1)
        return forward(*args, **kwargs)
    return run


def test_dense_general_bf16_backward_rounds_like_jax():
    """bf16 operands with an f32 result: the gradients come back in the
    operands' dtype, the f32 cotangent contracted with the other operand
    and rounded once, as JAX's transpose rule does (on the CPU; the card
    rounds the cotangent first, trap C13)."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 5, 16)).astype(np.float32)
    w = (0.1 * rng.normal(size=(16, 24))).astype(np.float32)
    g = rng.normal(size=(2, 5, 24)).astype(np.float32)
    jdense = JDense(features=24, dtype=jnp.bfloat16, use_bias=False)
    jx = jnp.asarray(x).astype(jnp.bfloat16)

    def jf(xx, ww):
        return jdense.apply({"params": {"kernel": ww}}, xx)

    _, vjp = jax.vjp(jf, jx, jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(g).astype(jnp.bfloat16))

    tdense = DenseGeneral(16, 24, dtype=torch.bfloat16)
    with torch.no_grad():
        tdense.kernel.copy_(torch.from_numpy(w))
    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    out = tdense(tx)
    assert out.dtype == torch.bfloat16
    out.backward(torch.from_numpy(g).to(torch.bfloat16))
    assert tx.grad.dtype == torch.bfloat16
    assert tdense.kernel.grad.dtype == torch.float32
    np.testing.assert_array_equal(tx.grad.float().numpy(),
                                  np.asarray(jdx.astype(jnp.float32)))
    np.testing.assert_array_equal(tdense.kernel.grad.numpy(),
                                  np.asarray(jdw))

    a = torch.from_numpy(x[0]).to(torch.bfloat16).requires_grad_()
    b = torch.from_numpy(w).to(torch.bfloat16).requires_grad_()
    gf = torch.from_numpy(g[0])
    MatmulF32.apply(a, b).backward(gf)
    np.testing.assert_array_equal(
        a.grad.float().numpy(),
        (gf @ b.detach().float().T).to(torch.bfloat16).float().numpy())
    np.testing.assert_array_equal(
        b.grad.float().numpy(),
        (a.detach().float().T @ gf).to(torch.bfloat16).float().numpy())


def test_int8_dense_general_refuses_a_gradient():
    dense = DenseGeneral(16, 8, weight_q8=True, dtype=torch.float32)
    x = torch.randn(3, 16, requires_grad=True)
    with torch.no_grad():
        assert dense(x).shape == (3, 8)
    with pytest.raises(RuntimeError, match="inference-only"):
        dense(x).sum().backward()


def test_init_params_trainable_f32_for_training():
    model = CausalLM(tiny())
    gen = torch.Generator().manual_seed(0)
    init_params(model, gen, dtype=torch.float32, device="cpu",
                requires_grad=True)
    assert all(p.requires_grad and p.dtype == torch.float32
               for p in model.parameters())
    init_params(model, gen, device="cpu")
    assert not any(p.requires_grad for p in model.parameters())
