"""Tensor-parallel serving: the port's ``ServingEngine(mesh=,
param_shardings=)`` on a 2-rank CPU gloo group against the JAX package's
tp2 engines on 2 of the 8 virtual devices and its single-device engine,
token for token (f32 weights; ``tests/test_serving_engine.py:156-200,
381-460``, ``tests/test_engine_speculative.py:116``,
``tests/test_quantized_weights.py:173``):

  * whole-prompt admission over an f32 pool, chunked prefill, an int8
    pool, the ALiBi model (the slopes sliced per rank), int8 weights, and
    the other decoder families: Baichuan's NormHead (its columns cut),
    Phi's parallel block with biases and partial rotary, OPT's learned
    positions with the tied head (the vocabulary-parallel table read
    back as the head);
  * the speculative + chunked engine equal to the plain one on the mesh;
  * the pool's lanes really split (hkv / 2 heads of d, 128 / 2 scale
    lanes), every page back in the pool, the global mesh set while the
    engine runs and restored by ``close()``;
  * trap C11 planted under tp2 (int8 scales laid head == lane): the
    tokens must differ;
  * heads the tensor axis does not divide are refused, with JAX's message.

All port runs share one spawn (the rank function imports torch and the
port only), with its own timeout.
"""

import dataclasses

import numpy as np
import pytest

from merlin_tpu_torch.utils.dist import run_ranks, serve_case

EOS, PAD = 2, 0
BASE = dict(num_slots=2, max_len=64, eos_id=EOS, pad_id=PAD,
            prompt_bucket=16, page_size=16)
PROMPTS = [[5, 17, 33, 41], [7, 9, 11], [23, 29]]
CHUNKED = [[5, 17, 33, 41], list(range(3, 16)), list(range(40, 56))]
SPEC_PROMPTS = [[5, 17, 33, 41, 5, 17, 33], [7, 9, 11, 7, 9],
                [21, 22, 21, 22, 21], [3, 4, 5, 6, 8, 3, 4, 5]]
SPEC = dict(BASE, max_len=128)

FAMILIES = {
    "baichuan": ("alibi", dict(normhead=True)),
    "phi": ("rope", dict(mlp="gelu_new", norm="ln", parallel_block=True,
                         attention_bias=True, lm_head_bias=True,
                         partial_rotary_factor=0.5)),
    "opt": ("learned", dict(mlp="relu", norm="ln", attention_bias=True,
                            tie_word_embeddings=True)),
}

# name -> (engine options, prompts, model: "rope" | "alibi" | "q8" | family)
RUNS = {
    "f32": ({}, PROMPTS, "rope"),
    "chunked": (dict(page_size=8, prefill_chunk=8), CHUNKED, "rope"),
    "int8_pool": (dict(cache_dtype="int8"), PROMPTS[:2], "rope"),
    "alibi": ({}, PROMPTS, "alibi"),
    "q8_weights": ({}, PROMPTS[:2], "q8"),
    "spec_plain": (dict(SPEC, chunk_steps=4), SPEC_PROMPTS, "rope"),
    "spec_chunked": (dict(SPEC, chunk_steps=2, spec_draft=3,
                          prefill_chunk=8), SPEC_PROMPTS, "rope"),
    "baichuan": ({}, PROMPTS[:2], "baichuan"),
    "phi": ({}, PROMPTS[:2], "phi"),
    "opt": ({}, PROMPTS[:2], "opt"),
}


def _jax_engine_kw(kw):
    import jax.numpy as jnp

    kw = dict(BASE, **kw)
    kw["cache_dtype"] = jnp.int8 if kw.get("cache_dtype") == "int8" \
        else jnp.float32
    return kw


@pytest.fixture(scope="module")
def models():
    import jax
    from merlin_tpu.models.convert import quantize_decoder_params_int8
    from merlin_tpu.models.decoder import CausalLM as JCausalLM

    from merlin_tpu_torch.models.bridge import params_from_flax
    from test_torch_int8_model import _models as family_models
    from test_torch_serving_engine import _models

    out = {}
    for kind in ("rope", "alibi"):
        jmodel, params, tmodel = _models(kind)
        out[kind] = (jmodel, params, tmodel.cfg, tmodel.state_dict())
    for kind, (positional, kw) in FAMILIES.items():
        jmodel, params, tmodel = family_models(positional, **kw)
        out[kind] = (jmodel, params, tmodel.cfg, tmodel.state_dict())
    jmodel, params, tmodel = _models("rope")
    qparams = quantize_decoder_params_int8(params)
    qcfg = dataclasses.replace(tmodel.cfg, weight_dtype="int8")
    out["q8"] = (JCausalLM(dataclasses.replace(jmodel.cfg,
                                               weight_dtype="int8")),
                 jax.tree.map(np.asarray, qparams), qcfg,
                 params_from_flax(jax.tree.map(np.asarray, qparams)))
    return out


@pytest.fixture(scope="module")
def port(models):
    runs = {}
    for name, (kw, prompts, kind) in RUNS.items():
        _, _, cfg, state = models[kind]
        runs[name] = dict(BASE, **kw, prompts=prompts, lm_cfg=cfg,
                          state=state, max_new_tokens=6)
    _, _, cfg, state = models["rope"]
    runs["int8_pool_c11"] = dict(runs["int8_pool"], plant="c11")
    odd = dataclasses.replace(cfg, num_heads=2, num_kv_heads=1, head_dim=16)
    from merlin_tpu_torch.models.decoder import CausalLM
    runs["undivisible"] = dict(BASE, lm_cfg=odd,
                               state=CausalLM(odd).state_dict(),
                               expect_error=True)
    return run_ranks(serve_case, 2, dict(lm_cfg=cfg, state=state, runs=runs,
                                         prompts=PROMPTS, max_new_tokens=6),
                     timeout=180)


@pytest.fixture(scope="module")
def jax_tokens(models, eight_devices):
    """name -> (JAX tp2 tokens, JAX single-device tokens); the families
    added here beyond JAX's tp2 tests run single-device only (None)."""
    import jax
    import jax.numpy as jnp
    from flax import linen as nn
    from merlin_tpu.core.mesh import MeshConfig, create_mesh
    from merlin_tpu.core.partitioning import sharding_for_tree
    from merlin_tpu.serve.engine import ServingEngine

    mesh = create_mesh(MeshConfig(data=1, fsdp=1, tensor=2),
                       devices=eight_devices[:2])
    out = {}
    for name, (kw, prompts, kind) in RUNS.items():
        jmodel, params = models[kind][:2]
        abstract = jax.eval_shape(lambda: jmodel.init(
            jax.random.key(0), jnp.ones((1, 4), jnp.int32)))["params"]
        shardings = sharding_for_tree(nn.get_partition_spec(abstract), mesh)
        got = [] if kind not in FAMILIES else [None]
        for mesh_kw in ([dict(mesh=mesh, param_shardings=shardings)]
                        if kind not in FAMILIES else []) + [{}]:
            eng = ServingEngine(jmodel, params, **_jax_engine_kw(kw),
                                **mesh_kw)
            try:
                reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
                eng.run_until_idle()
                got.append([r.generated for r in reqs])
            finally:
                eng.close()
        out[name] = tuple(got)
    return out


@pytest.mark.parametrize("name", sorted(RUNS))
def test_tp2_tokens_equal_jax_tp2_and_single(port, jax_tokens, name):
    tp2, single = jax_tokens[name]
    assert tp2 in (single, None)
    for rank in port:                  # both ranks emit the same tokens
        assert rank[name]["tokens"] == single, name


def test_spec_chunked_equals_plain_on_the_mesh(port):
    assert port[0]["spec_chunked"]["tokens"] == port[0]["spec_plain"]["tokens"]


@pytest.mark.parametrize("name", sorted(RUNS))
def test_pool_lanes_split_and_pages_return(port, models, name):
    cfg = models[RUNS[name][2]][2]
    r = port[0][name]
    assert r["lanes"]["k_pages"] == (cfg.kv_heads // 2 * cfg.head_size,)
    if RUNS[name][0].get("cache_dtype") == "int8":
        assert r["lanes"]["k_scales"] == (64,)
    free0, free1 = r["free_pages"]
    assert free1 == free0
    assert r["global_mesh_set"] and r["global_mesh_after_close"]


def test_c11_head_equals_lane_is_caught_under_tp2(port):
    """int8 scales written at lane == head instead of the strided lane:
    the reads (stride 128 / hkv, locally the same) pick the wrong scales."""
    assert port[0]["int8_pool_c11"]["tokens"] != port[0]["int8_pool"]["tokens"]


def test_undivisible_heads_are_refused(port, models, eight_devices):
    """1 kv head over tensor = 2: both packages refuse, with one message,
    and the port leaves the global mesh as it was."""
    from merlin_tpu.core.mesh import MeshConfig, create_mesh, set_global_mesh
    from merlin_tpu.models.decoder import CausalLM as JCausalLM
    from merlin_tpu.serve.engine import ServingEngine as JServingEngine

    jmodel = models["rope"][0]
    odd = JCausalLM(dataclasses.replace(jmodel.cfg, num_heads=2,
                                        num_kv_heads=1, head_dim=16))
    mesh = create_mesh(MeshConfig(data=1, fsdp=1, tensor=2),
                       devices=eight_devices[:2])
    try:
        with pytest.raises(ValueError) as theirs:
            JServingEngine(odd, {}, mesh=mesh, **_jax_engine_kw({}))
    finally:
        set_global_mesh(None)
    r = port[0]["undivisible"]
    assert r["error"] == str(theirs.value) == \
        "heads (2/1) must divide the tensor axis (2)"
    assert r["global_mesh_after_close"]


def test_dryrun_multichip_serving_cases():
    """The JAX package's dryrun serving cases on the port's tiny bundle
    (``utils.dist.dryrun_multichip``, 2 ranks): tp2 over f32 and int8
    pools, and spec + chunked equal to plain token for token."""
    from merlin_tpu_torch.utils.dist import dryrun_multichip

    res = dryrun_multichip(2, cases=["serve"])["serve"]
    assert res["spec_chunked"]["tokens"] == res["plain"]["tokens"]
    assert all(len(t) == 6 for r in res.values() for t in r["tokens"])
    assert res["int8"]["lanes"]["k_scales"] == (64,)
