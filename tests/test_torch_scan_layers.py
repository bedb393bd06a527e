"""The port's ``scan_layers`` decoder against the JAX package's on the CPU
(mirrors ``tests/test_scan_layers.py``): one flax loop tree, stacked by
JAX's ``stack_layer_params`` and bridged by ``params_from_flax``, runs
through JAX's scanned ``CausalLM`` and the port's. f32 throughout; logits
within 1e-5, the layout round trip exact, greedy tokens equal.

``test_scan_layers_trains_on_sharded_mesh``: the tiny MMGPT with a
scanned LM trained on dp2 x fsdp2 x tp2, the port's ``Trainer`` on an
8-rank CPU gloo group against JAX's ``make_train_step(mesh=)``, with the
tolerances of ``test_torch_mesh_train.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from merlin_tpu.models.convert import stack_layer_params as j_stack
from merlin_tpu.models.decoder import CausalLM as JCausalLM
from merlin_tpu.models.decoder import cross_entropy_loss as j_xent
from merlin_tpu.models.decoder import init_kv_cache as j_init_kv_cache
from merlin_tpu.models.families import tiny as j_tiny

from merlin_tpu_torch.models.bridge import params_from_flax
from merlin_tpu_torch.models.convert import (
    stack_layer_params, unstack_layer_params)
from merlin_tpu_torch.models.decoder import (
    CausalLM, cross_entropy_loss, init_kv_cache)
from merlin_tpu_torch.models.families import tiny

LOGIT_TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _loop_params(ids):
    """JAX's loop tree, every leaf perturbed (norm scales not all 1)."""
    params = nn.unbox(JCausalLM(j_tiny()).init(jax.random.key(0), ids)[
        "params"])
    rng = np.random.default_rng(1)
    return jax.tree.map(lambda x: np.asarray(x) + 0.05 * rng.normal(
        size=x.shape).astype(np.float32), params)


def _ids(shape, seed=0):
    return np.random.default_rng(seed).integers(3, 90, shape).astype(
        np.int32)


def _scan_cfg(cfg, **kw):
    return dataclasses.replace(cfg, scan_layers=True, **kw)


def test_scan_layers_matches_loop():
    ids = _ids((2, 16))
    p_loop = _loop_params(ids)
    p_scan = j_stack(dict(p_loop), j_tiny().num_layers)
    jscan = JCausalLM(_scan_cfg(j_tiny()))
    want, _ = jscan.apply({"params": p_scan}, jnp.asarray(ids))

    scan = CausalLM(_scan_cfg(tiny())).eval()
    scan.load_state_dict(params_from_flax(p_scan), strict=True)
    loop = CausalLM(tiny()).eval()
    loop.load_state_dict(params_from_flax(p_loop), strict=True)
    with torch.no_grad():
        got, _ = scan(torch.from_numpy(ids).long())
        got_loop, _ = loop(torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_TOL)
    np.testing.assert_allclose(got.numpy(), got_loop.numpy(), atol=0)

    # the port's stacking is JAX's, leaf for leaf, and the round trip
    # back to the loop layout is exact
    stacked = stack_layer_params(params_from_flax(p_loop),
                                 tiny().num_layers)
    want_sd = params_from_flax(p_scan)
    assert sorted(stacked) == sorted(want_sd)
    for name, t in stacked.items():
        np.testing.assert_array_equal(t.numpy(), want_sd[name].numpy())
    back = unstack_layer_params(scan.state_dict())
    loop2 = CausalLM(tiny()).eval()
    loop2.load_state_dict(back, strict=True)
    with torch.no_grad():
        got_back, _ = loop2(torch.from_numpy(ids).long())
    np.testing.assert_array_equal(got_back.numpy(), got_loop.numpy())


def test_scan_layers_init_tree_shape():
    """A fresh scanned model holds the stacked tree (JAX's names, a
    leading layer axis, layers drawn apart), and gradients flow through
    the stack under remat: equal to JAX's on the same parameters."""
    cfg = _scan_cfg(tiny(), remat=True)
    model = CausalLM(cfg)
    sd = model.state_dict()
    qk = sd["layers.block.attn.q_proj.kernel"]
    assert qk.shape[0] == cfg.num_layers
    assert not torch.equal(qk[0], qk[1])
    ids = _ids((1, 8))
    jcfg = _scan_cfg(j_tiny(), remat=True)
    jmodel = JCausalLM(jcfg)
    p = nn.unbox(jmodel.init(jax.random.key(0), jnp.asarray(ids))["params"])
    assert sorted(params_from_flax(p)) == sorted(sd)
    for name, t in params_from_flax(p).items():
        assert tuple(sd[name].shape) == tuple(t.shape), name

    def jloss(p):
        logits, _ = jmodel.apply({"params": p}, jnp.asarray(ids))
        return j_xent(logits, jnp.asarray(ids))[0]

    jgrads = params_from_flax(jax.grad(jloss)(p))
    model.load_state_dict(params_from_flax(p), strict=True)
    logits, _ = model(torch.from_numpy(ids).long())
    cross_entropy_loss(logits, torch.from_numpy(ids).long())[0].backward()
    total = 0.0
    for name, param in model.named_parameters():
        np.testing.assert_allclose(param.grad.numpy(), jgrads[name].numpy(),
                                   atol=1e-5, rtol=1e-4, err_msg=name)
        total += float(param.grad.abs().sum())
    assert np.isfinite(total) and total > 0


def test_scan_layers_rejects_unstacked_cache():
    model = CausalLM(_scan_cfg(tiny()))
    cache = init_kv_cache(tiny(), 1, max_len=16, stacked=False,
                          dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="STACKED"):
        model(torch.ones((1, 8), dtype=torch.long), kv_cache=cache)
    # JAX refuses the same cache with the same word
    jmodel = JCausalLM(_scan_cfg(j_tiny()))
    ids = jnp.ones((1, 8), jnp.int32)
    p = nn.unbox(jmodel.init(jax.random.key(0), ids)["params"])
    with pytest.raises(ValueError, match="STACKED"):
        jmodel.apply({"params": p}, ids,
                     kv_cache=j_init_kv_cache(j_tiny(), 1, 16, stacked=False))


def _decode(model, cfg, ids, mask, steps, layout, stacked, torch_side):
    """Prefill a ragged batch, then greedy steps; (b, steps) tokens."""
    b, s = ids.shape
    if torch_side:
        cache = init_kv_cache(cfg, b, max_len=s + steps, layout=layout,
                              stacked=stacked, dtype=torch.float32,
                              page_size=8, device="cpu")
        ids_t, mask_t = torch.from_numpy(ids).long(), torch.from_numpy(mask)
        with torch.no_grad():
            logits, cache = model(ids_t, segment_ids=mask_t,
                                  positions=torch.arange(s).expand(b, s),
                                  kv_cache=cache)
            lengths = mask_t.sum(dim=1)
            toks = [logits[torch.arange(b), lengths - 1].argmax(-1)]
            pos = lengths
            for _ in range(steps - 1):
                if layout == "paged":
                    pos = cache["lengths"]
                logits, cache = model(toks[-1][:, None],
                                      positions=pos[:, None], kv_cache=cache)
                if layout == "dense":
                    pos = pos + 1
                toks.append(logits[:, 0].argmax(-1))
        return torch.stack(toks, 1).numpy()
    jm, params = model
    cache = j_init_kv_cache(cfg, b, max_len=s + steps, layout=layout,
                            stacked=stacked, dtype=jnp.float32, page_size=8)
    logits, cache = jm.apply(
        {"params": params}, jnp.asarray(ids), segment_ids=jnp.asarray(mask),
        positions=jnp.broadcast_to(jnp.arange(s), (b, s)), kv_cache=cache)
    lengths = jnp.asarray(mask).sum(axis=1)
    toks = [jnp.argmax(logits[jnp.arange(b), lengths - 1], -1)]
    pos = lengths
    for _ in range(steps - 1):
        if layout == "paged":
            pos = cache["lengths"]
        logits, cache = jm.apply({"params": params}, toks[-1][:, None],
                                 positions=pos[:, None], kv_cache=cache)
        if layout == "dense":
            pos = pos + 1
        toks.append(jnp.argmax(logits[:, 0], -1))
    return np.stack([np.asarray(t) for t in toks], 1)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_scan_decode_matches_loop(layout):
    """Scanned decode over a stacked cache (paged: one flat pool, page
    tables offset per layer) gives JAX's scanned tokens and the port's
    loop decoder's, prefill and 5 steps over a ragged batch."""
    b, s, steps = 2, 12, 5
    ids = _ids((b, s), seed=1)
    mask = np.ones((b, s), np.int32)
    mask[1, 9:] = 0
    p_loop = _loop_params(ids)
    p_scan = j_stack(dict(p_loop), j_tiny().num_layers)
    scan = CausalLM(_scan_cfg(tiny())).eval()
    scan.load_state_dict(params_from_flax(p_scan), strict=True)
    loop = CausalLM(tiny()).eval()
    loop.load_state_dict(params_from_flax(p_loop), strict=True)

    want = _decode((JCausalLM(_scan_cfg(j_tiny())), p_scan), j_tiny(), ids,
                   mask, steps, layout, True, torch_side=False)
    got = _decode(scan, tiny(), ids, mask, steps, layout, True, True)
    got_loop = _decode(loop, tiny(), ids, mask, steps, layout, False, True)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, got_loop)


def test_flat_pool_is_a_view_and_refuses_a_copy():
    """The paged pool is written in place through its flat view: a
    prefill lands in the stacked tensors the caller holds, and a pool
    that is not contiguous (whose reshape would copy) is refused."""
    cfg = _scan_cfg(tiny())
    model = CausalLM(cfg).eval()
    cache = init_kv_cache(cfg, 2, max_len=16, layout="paged", page_size=8,
                          dtype=torch.float32, device="cpu")
    pages = cache["layers"]["k_pages"]
    assert pages.shape == (cfg.num_layers, 4, 8, cfg.kv_heads
                           * cfg.head_size)
    with torch.no_grad():
        model(torch.ones((2, 8), dtype=torch.long), kv_cache=cache)
    # each layer wrote its own block: layer l's sequence b at page b * 2
    assert bool((pages[:, 0].abs().sum(dim=(1, 2)) > 0).all())
    assert not torch.equal(pages[0, 0], pages[1, 0])
    bad = dict(cache, layers={k: t.transpose(1, 2).contiguous().transpose(
        1, 2) for k, t in cache["layers"].items()})
    with pytest.raises(ValueError, match="contiguous"):
        with torch.no_grad():
            model(torch.ones((2, 1), dtype=torch.long), kv_cache=bad)


def test_scan_layers_trains_on_sharded_mesh(eight_devices):
    """The scanned stack under dp2 x fsdp2 x tp2: its stacked leaves take
    the ("layers", ...) logical axes, so tensor parallelism cuts them one
    dim further in (q_proj's heads at dim 2); two steps land on JAX's
    metrics and parameters."""
    from merlin_tpu.core.mesh import MeshConfig as JMeshConfig
    from merlin_tpu.core.mesh import create_mesh as j_create_mesh

    from merlin_tpu_torch.utils.dist import run_ranks, train_case
    from test_torch_mesh_train import (
        KW, ROWS, SHAPE, STEPS, _close, _jax_run, _lrs)
    from test_torch_scan_train import _jax_bundle, _port_model
    from test_torch_trainer import _batches

    jb = _jax_bundle()
    model = _port_model(jb)
    batches = _batches(jb.config, STEPS, rows=ROWS)
    spec = dict(cfg=model.cfg, state=model.state_dict(), train_kw=KW,
                orig_vocab=jb.orig_vocab_size, batches=batches, shape=SHAPE)
    got = run_ranks(train_case, 8, spec, timeout=240)[0]
    jmesh = j_create_mesh(JMeshConfig(data=2, fsdp=2, tensor=2),
                          devices=eight_devices)
    _close((got["metrics"], got["params"]), _jax_run(jb, batches, jmesh),
           lrs=_lrs())
    assert got["placement_problems"] == []
    assert got["tp_dims"]["lm.layers.block.attn.q_proj.kernel"] == 2
    assert got["tp_dims"]["lm.layers.block.mlp.down_proj.kernel"] == 1
