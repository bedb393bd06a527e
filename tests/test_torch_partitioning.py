"""The logical axes of the port's parameters and their placements, name by
name, against the JAX package: for the tiny MMGPT with every tower kind,
projector kind and decoder family, with and without ``scan_layers``,

  * ``merlin_tpu_torch.core.partitioning.logical_axes(model)`` equals
    ``nn.get_partition_spec`` of JAX's abstract init (a leaf flax holds
    unannotated: no axes on either side);
  * ``sharding_for_tree`` gives each parameter the placements of JAX's
    ``sharding_for_tree`` on the (2, 2, 1, 2) mesh of the 8 virtual
    devices (a leaf whose axes repeat a name, the convolutions'
    ``conv_hw``, is refused by both);
  * the placements the port uses itself (``strict=False``) replicate those
    refused leaves.

No process group is needed: placements are computed from the axes and the
mesh's dim names. JAX traces ``init`` abstractly (``jax.eval_shape``).
"""

import dataclasses

import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from merlin_tpu_torch.core.mesh import MESH_AXES
from merlin_tpu_torch.core.partitioning import logical_axes, sharding_for_tree

# name -> (tower kind, projector, LM family, scan_layers)
COMBOS = {
    "clip_conv_llama": ("clip", "conv", "llama", False),
    "clip_conv_llama_scan": ("clip", "conv", "llama", True),
    "clip_linear_baichuan": ("clip", "linear", "baichuan", False),
    "clip_linear_baichuan_scan": ("clip", "linear", "baichuan", True),
    "clip_resampler_phi": ("clip", "resampler", "phi", False),
    "metaclip_qwen_opt": ("metaclip", "qwen", "opt", False),
    "metaclip_qwen_opt_scan": ("metaclip", "qwen", "opt", True),
    "qwen_sampler_llama": ("qwen", "qwen_sampler", "llama", False),
    "sam_sam_llama": ("sam", "sam", "llama", False),
    "sam_conv_phi_scan": ("sam", "conv", "phi", True),
}
FAMILIES = {
    "llama": dict(num_kv_heads=2),
    "baichuan": dict(positional="alibi", normhead=True),
    "phi": dict(mlp="gelu_new", norm="ln", parallel_block=True,
                attention_bias=True, lm_head_bias=True,
                partial_rotary_factor=0.5),
    "opt": dict(positional="learned", mlp="relu", norm="ln",
                attention_bias=True, tie_word_embeddings=True),
}


def _configs(combo):
    from merlin_tpu.models import mmgpt as jmm
    from merlin_tpu.models.families import tiny as j_tiny
    from merlin_tpu.models.sam_vit import tiny_sam as j_tiny_sam
    from merlin_tpu.models.vit import tiny_vit as j_tiny_vit

    from merlin_tpu_torch.models import mmgpt as tmm
    from merlin_tpu_torch.models.families import tiny
    from merlin_tpu_torch.models.sam_vit import tiny_sam
    from merlin_tpu_torch.models.vit import tiny_vit

    kind, projector, family, scan = COMBOS[combo]
    lm_kw = dict(FAMILIES[family], scan_layers=scan)
    if kind == "sam":
        jvit, tvit = j_tiny_sam(), tiny_sam()
    else:
        jvit, tvit = j_tiny_vit(), tiny_vit()
    kw = dict(projector=projector, vision_kind=kind, image_patch_id=4,
              im_start_id=5, im_end_id=6)
    return (jmm.MMGPTConfig(lm=j_tiny(**lm_kw), vit=jvit, **kw),
            tmm.MMGPTConfig(lm=tiny(**lm_kw), vit=tvit, **kw))


def _jax_specs(jcfg):
    import jax
    import jax.numpy as jnp
    from flax import linen as nn
    from merlin_tpu.models.mmgpt import MMGPT as JMMGPT

    from merlin_tpu_torch.models.bridge import _flatten

    side = getattr(jcfg.vit, "image_size", None) or jcfg.vit.img_size
    model = JMMGPT(jcfg)
    abstract = jax.eval_shape(lambda: model.init(
        jax.random.key(0), jnp.ones((1, 8), jnp.int32),
        images=jnp.zeros((1, 1, side, side, 3), jnp.float32)))["params"]
    return _flatten(nn.get_partition_spec(abstract), "", {})


@pytest.fixture(scope="module")
def jax_mesh(eight_devices):
    from merlin_tpu.core.mesh import MeshConfig, create_mesh

    return create_mesh(MeshConfig(data=2, fsdp=2, tensor=2),
                       devices=eight_devices)


def _as_spec(placements, ndim):
    """Placements (one per mesh dim) -> mesh axes per tensor dim."""
    dims = [[] for _ in range(ndim)]
    for name, pl in zip(MESH_AXES, placements):
        if isinstance(pl, Shard):
            dims[pl.dim].append(name)
    return tuple(None if not d else d[0] if len(d) == 1 else tuple(d)
                 for d in dims)


@pytest.mark.parametrize("combo", sorted(COMBOS))
def test_logical_axes_and_placements_match_jax(combo, jax_mesh):
    from merlin_tpu.core.partitioning import sharding_for_tree as j_sharding
    from merlin_tpu_torch.models.mmgpt import MMGPT

    jcfg, tcfg = _configs(combo)
    want = _jax_specs(jcfg)
    with torch.device("meta"):
        model = MMGPT(tcfg)
    axes = logical_axes(model)
    assert set(axes) == set(want)
    shapes = dict(model.named_parameters())
    refused = 0
    for name, spec in want.items():
        assert (axes[name] or ()) == tuple(spec), name
        try:
            jspec = j_sharding({"x": spec}, jax_mesh)["x"].spec
        except ValueError:
            refused += 1
            with pytest.raises(ValueError):
                sharding_for_tree({name: axes[name]})
            loose = sharding_for_tree({name: axes[name]}, strict=False)
            assert loose[name] == (Replicate(),) * 4, name
            continue
        got = sharding_for_tree({name: axes[name]})[name]
        ndim = shapes[name].dim()
        padded = tuple(jspec) + (None,) * (ndim - len(tuple(jspec)))
        assert _as_spec(got, ndim) == padded, name
    # every tower kind and the conv projectors carry a refused conv kernel
    assert refused >= 1


def test_scan_layers_lead_with_layers():
    from merlin_tpu_torch.models.families import tiny
    from merlin_tpu_torch.models.decoder import CausalLM

    with torch.device("meta"):
        lm = CausalLM(tiny(scan_layers=True))
    axes = logical_axes(lm)
    assert axes["layers.block.attn.q_proj.kernel"] == (
        "layers", "embed", "heads", "kv")
    assert axes["layers.block.input_norm.scale"] == ("layers", "norm")
    assert axes["embed_tokens.embedding"] == ("vocab", "embed")


def test_int8_weights_carry_the_kernel_axes():
    from merlin_tpu_torch.models.families import tiny
    from merlin_tpu_torch.models.decoder import CausalLM

    with torch.device("meta"):
        lm = CausalLM(dataclasses.replace(tiny(), weight_dtype="int8"))
    axes = logical_axes(lm)
    assert axes["layers_0.attn.o_proj.kernel_q8"] == ("heads", "kv", "embed")
    assert axes["layers_0.attn.o_proj.kernel_scale"] == ("embed",)
    assert axes["lm_head.kernel_scale"] == ("vocab",)
