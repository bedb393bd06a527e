"""The port's CLIP-style towers (MetaCLIP, Qwen-VL), their converters and
the vision configs against the JAX package on the CPU, at tiny widths and
f32 (SAM and the projectors: ``test_torch_sam_resampler.py``).

  * ViT: ``vit_params_from_hf`` with ``interpolate_pos_embedding`` (a tower
    at twice the checkpoint's grid, and a no-op case held also against HF's
    ``CLIPVisionModel``); ``qwen_vit_params_from_torch`` against a torch
    replica of Qwen-VL's tower (per-head interleaved ``in_proj``), and a
    block-packed split that must not match; the ``sincos2d`` positions;
    MetaCLIP-kind and Qwen-kind towers through ``build_vision_tower``.
  * Configs: ``vision_kind_from_name`` / ``default_vision_config`` for each
    kind, field by field; ``image_token_len`` for each projector.

Tolerances: converted leaves exact, except a resized position table (1e-6,
JAX sums its resize in one einsum); outputs 1e-4 against JAX (summation
order through two layers) and the JAX package's own tolerances against HF
or a torch replica.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from merlin_tpu.models import mmgpt as jmm
from merlin_tpu.models import projectors as jp
from merlin_tpu.models import vision_builder as jvb
from merlin_tpu.models import vit as jvit
from merlin_tpu.models.families import tiny as j_tiny_lm

from merlin_tpu_torch.models import mmgpt as tmm
from merlin_tpu_torch.models import projectors as tp
from merlin_tpu_torch.models import vision_builder as tvb
from merlin_tpu_torch.models import vit as tvit
from merlin_tpu_torch.models.bridge import params_from_flax
from merlin_tpu_torch.models.convert import flat_state_dict
from merlin_tpu_torch.models.families import tiny as t_tiny_lm


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _perturbed(params, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: np.asarray(p) + scale * rng.normal(size=p.shape).astype(
            np.float32), params)


def _init(module, seed, *args):
    return _perturbed(fnn.unbox(module.init(
        jax.random.key(0), *(jnp.asarray(a) for a in args))["params"]), seed)


def _pixels(b, size, seed=0):
    return np.random.default_rng(seed).normal(size=(b, size, size, 3)).astype(
        np.float32)


def _hold(tmodule, jmodule, params, *inputs, atol=1e-4, strict=True):
    tmodule.load_state_dict(params_from_flax(params), strict=strict)
    want = np.asarray(jmodule.apply({"params": params},
                                    *(jnp.asarray(x) for x in inputs)))
    with torch.no_grad():
        got = tmodule(*(torch.from_numpy(x) for x in inputs))
    got = got.numpy() if torch.is_tensor(got) else got
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=atol, rtol=atol)
    return got


def _clip_hf(image_size):
    from transformers import CLIPVisionConfig, CLIPVisionModel

    torch.manual_seed(0)
    return CLIPVisionModel(CLIPVisionConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, image_size=image_size, patch_size=4,
        layer_norm_eps=1e-5, hidden_act="quick_gelu")).eval()


# ---------------------------------------------------------------------------
# ViT converters and towers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ckpt_size,size", [(16, 16), (16, 32), (32, 16)],
                         ids=["same-grid", "upscale", "downscale"])
def test_vit_params_from_hf_matches_jax(ckpt_size, size):
    """HF CLIP weights of a ``ckpt_size`` tower into one at ``size``: the
    position table resized (upscale from a 4x4 to an 8x8 grid; downscale,
    antialiased), every other leaf exact; the tower's features against
    JAX's."""
    hf = _clip_hf(ckpt_size)
    jcfg = jvit.tiny_vit(image_size=size)
    tcfg = tvit.tiny_vit(image_size=size)
    want = params_from_flax(jvit.vit_params_from_hf(hf.state_dict(), jcfg))
    got = flat_state_dict(tvit.vit_params_from_hf(hf.state_dict(), tcfg))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        if name == "position_embedding" and ckpt_size != size:
            assert got[name].shape == w.shape == (tcfg.num_positions, 32)
            np.testing.assert_allclose(got[name].numpy(), w.numpy(),
                                       atol=1e-6, rtol=0)
            np.testing.assert_array_equal(got[name][0].numpy(),
                                          w[0].numpy())   # CLS untouched
        else:
            assert torch.equal(got[name], w), name
    pixels = _pixels(2, size)
    jtower = jvit.CLIPVisionTower(jcfg)
    ttower = tvb.build_vision_tower("clip", tcfg)
    tree = {"vit": jvit.vit_params_from_hf(hf.state_dict(), jcfg)}
    # the tower builds only the layers its selection runs
    _hold(ttower, jtower, tree, pixels, strict=False)


def test_vit_params_from_hf_runs_like_hf():
    """At the checkpoint's own grid the converted tower gives HF's
    hidden_states[-2] without the CLS token."""
    hf = _clip_hf(16)
    cfg = tvit.tiny_vit()
    tower = tvb.build_vision_tower("clip", cfg)
    result = tower.load_state_dict(
        {"vit." + k: v for k, v in flat_state_dict(
            tvit.vit_params_from_hf(hf.state_dict(), cfg)).items()},
        strict=False)
    assert not result.missing_keys
    assert all(k.startswith("vit.layers_1.") for k in result.unexpected_keys)
    pixels = _pixels(2, 16, seed=3)
    with torch.no_grad():
        got = tower(torch.from_numpy(pixels)).numpy()
        want = hf(torch.from_numpy(pixels.transpose(0, 3, 1, 2)),
                  output_hidden_states=True).hidden_states[-2][:, 1:].numpy()
    np.testing.assert_allclose(got, want, atol=3e-4, rtol=2e-3)


def test_interpolate_pos_embedding_matches_jax():
    pos = np.random.default_rng(0).normal(size=(1 + 9, 8)).astype(np.float32)
    for n, cls in ((1 + 36, True), (1 + 4, True), (25, False), (10, True)):
        src = pos if cls else pos[1:]
        want = jvit.interpolate_pos_embedding(src, n, cls)
        got = tvit.interpolate_pos_embedding(torch.from_numpy(src), n, cls)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    same = torch.from_numpy(pos)
    assert tvit.interpolate_pos_embedding(same, 10) is same


class _TorchQwenBlock(torch.nn.Module):
    """Qwen-VL's VisualAttention block: ``in_proj`` rows interleaved per
    head as [q_n | k_n | v_n]."""

    def __init__(self, width, heads, mlp):
        super().__init__()
        from collections import OrderedDict
        self.ln_1 = torch.nn.LayerNorm(width, eps=1e-5)
        self.attn = torch.nn.Module()
        self.attn.in_proj = torch.nn.Linear(width, 3 * width)
        self.attn.out_proj = torch.nn.Linear(width, width)
        self.ln_2 = torch.nn.LayerNorm(width, eps=1e-5)
        self.mlp = torch.nn.Sequential(OrderedDict([
            ("c_fc", torch.nn.Linear(width, mlp)),
            ("gelu", torch.nn.GELU()),
            ("c_proj", torch.nn.Linear(mlp, width))]))
        self.heads, self.hd = heads, width // heads

    def forward(self, x):
        b, s, w = x.shape
        h = self.ln_1(x)
        mixed = self.attn.in_proj(h).view(b, s, self.heads, 3 * self.hd)
        q, k, v = mixed.split(self.hd, dim=-1)
        q, k, v = (t.permute(0, 2, 1, 3) for t in (q, k, v))
        p = torch.softmax(q @ k.transpose(-2, -1) / math.sqrt(self.hd), -1)
        o = (p @ v).permute(0, 2, 1, 3).reshape(b, s, w)
        x = x + self.attn.out_proj(o)
        return x + self.mlp(self.ln_2(x))


class _TorchQwenViT(torch.nn.Module):
    def __init__(self, width=16, layers=2, heads=2, mlp=32, patch=4, img=16):
        super().__init__()
        grid = img // patch
        self.conv1 = torch.nn.Conv2d(3, width, patch, patch, bias=False)
        self.positional_embedding = torch.nn.Parameter(
            0.02 * torch.randn(grid * grid, width))
        self.ln_pre = torch.nn.LayerNorm(width, eps=1e-5)
        self.transformer = torch.nn.Module()
        self.transformer.resblocks = torch.nn.ModuleList(
            [_TorchQwenBlock(width, heads, mlp) for _ in range(layers)])

    def forward(self, x):
        x = self.conv1(x).flatten(2).permute(0, 2, 1)
        x = self.ln_pre(x + self.positional_embedding)
        for blk in self.transformer.resblocks:
            x = blk(x)
        return x


def _qwen_cfgs(**kw):
    base = dict(hidden_size=16, num_layers=2, num_heads=2,
                intermediate_size=32, patch_size=4, image_size=16,
                activation="gelu", use_class_token=False,
                pos_embed="learned")
    base.update(kw)
    return (jvit.ViTConfig(dtype=jnp.float32, **base),
            tvit.ViTConfig(dtype=torch.float32, **base))


@pytest.mark.parametrize("prefix", ["", "visual."])
def test_qwen_vit_params_from_torch_matches_jax_and_replica(prefix):
    torch.manual_seed(0)
    tm = _TorchQwenViT().eval()
    sd = {prefix + k: v for k, v in tm.state_dict().items()}
    jcfg, tcfg = _qwen_cfgs()
    jtree = jvit.qwen_vit_params_from_torch(sd, jcfg)
    want = params_from_flax(jtree)
    got = flat_state_dict(tvit.qwen_vit_params_from_torch(sd, tcfg))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert torch.equal(got[name], w), name
    pixels = _pixels(2, 16)
    tower = tvb.build_vision_tower("qwen", tcfg)
    ours = _hold(tower, jvb.build_vision_tower("qwen", jcfg), {"vit": jtree},
                 pixels)
    with torch.no_grad():
        theirs = tm(torch.from_numpy(pixels.transpose(0, 3, 1, 2))).numpy()
    np.testing.assert_allclose(ours, theirs, atol=2e-4, rtol=1e-3)


def test_qwen_in_proj_read_block_packed_does_not_match():
    """The interleave matters: q, k and v split as [all q; all k; all v]
    (the resampler's packing) give another tower."""
    torch.manual_seed(0)
    tm = _TorchQwenViT().eval()
    _, tcfg = _qwen_cfgs()
    tree = tvit.qwen_vit_params_from_torch(tm.state_dict(), tcfg)
    w = tm.state_dict()["transformer.resblocks.0.attn.in_proj.weight"]
    for i, name in enumerate(("q_proj", "k_proj", "v_proj")):
        tree["layers_0"][name]["kernel"] = w[16 * i:16 * (i + 1)].T.reshape(
            16, 2, 8)
    vit = tvit.ViT(tcfg)
    vit.load_state_dict(flat_state_dict(tree), strict=True)
    pixels = torch.from_numpy(_pixels(1, 16))
    with torch.no_grad():
        ours = vit(pixels)[-1].numpy()
        theirs = tm(pixels.permute(0, 3, 1, 2)).numpy()
    assert not np.allclose(ours, theirs, atol=2e-4)


@pytest.mark.parametrize("cls", [False, True], ids=["no-cls", "cls"])
def test_sincos2d_tower_matches_jax(cls):
    """Fixed 2D sin-cos positions for the grid (a zero row for the CLS
    token): no position parameter, and the table is JAX's bit for bit."""
    jcfg, tcfg = _qwen_cfgs(pos_embed="sincos2d", use_class_token=cls)
    jtower = jvit.CLIPVisionTower(jcfg, select_layer=-1,
                                  select_feature="cls_patch")
    pixels = _pixels(2, 16, seed=5)
    params = _init(jtower, 1, pixels)
    assert "position_embedding" not in params["vit"]
    ttower = tvit.CLIPVisionTower(tcfg, select_layer=-1,
                                  select_feature="cls_patch")
    _hold(ttower, jtower, params, pixels)
    np.testing.assert_array_equal(
        tp.sincos_2d_pos_embed(16, 4), jp._sincos_2d_pos_embed(16, 4))


@pytest.mark.parametrize("kind", ["metaclip", "qwen"])
def test_metaclip_and_qwen_kind_towers_match_jax(kind):
    """The kinds' tiny forms: MetaCLIP's gelu tower selected like CLIP;
    Qwen's last hidden state whole, with sin-cos positions and no CLS."""
    if kind == "metaclip":
        kw = dict(activation="gelu", hidden_size=40, num_heads=4,
                  num_layers=3)
    else:
        kw = dict(activation="gelu", use_class_token=False,
                  pos_embed="sincos2d", hidden_size=48, num_heads=4)
    jcfg, tcfg = jvit.tiny_vit(**kw), tvit.tiny_vit(**kw)
    jtower = jvb.build_vision_tower(kind, jcfg)
    pixels = _pixels(2, 16, seed=6)
    params = _init(jtower, 2, pixels)
    got = _hold(tvb.build_vision_tower(kind, tcfg), jtower, params, pixels)
    assert got.shape == (2, 16, kw["hidden_size"])


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def _same_config(jcfg, tcfg):
    assert type(jcfg).__name__ == type(tcfg).__name__
    for f in dataclasses.fields(jcfg):
        jv, tv = getattr(jcfg, f.name), getattr(tcfg, f.name)
        if f.name == "dtype":
            assert str(jnp.dtype(jv)) == str(tv).replace("torch.", "")
        else:
            assert jv == tv, f.name


@pytest.mark.parametrize("name,kind", [
    ("openai/clip-vit-large-patch14", "clip"), ("Qwen-VL-visual", "qwen"),
    ("facebook/sam-vit-base", "sam"), ("metaclip-h14", "metaclip"),
    ("", "clip")])
def test_vision_configs_match_jax(name, kind):
    assert tvb.vision_kind_from_name(name) == jvb.vision_kind_from_name(
        name) == kind
    for size in (224, 448):
        _same_config(jvb.default_vision_config(kind, size),
                     tvb.default_vision_config(kind, size))
        _same_config(jvb.default_vision_config(kind, size, jnp.float32),
                     tvb.default_vision_config(kind, size, torch.float32))


@pytest.mark.parametrize("projector", ["conv", "mlp", "linear", "qwen", "sam",
                                       "qwen_sampler", "resampler"])
@pytest.mark.parametrize("kind", ["clip", "metaclip", "qwen", "sam"])
def test_image_token_len_matches_jax(kind, projector):
    jcfg = jmm.MMGPTConfig(lm=j_tiny_lm(), vit=jvb.default_vision_config(
        kind, 448), projector=projector, vision_kind=kind)
    tcfg = tmm.MMGPTConfig(lm=t_tiny_lm(), vit=tvb.default_vision_config(
        kind, 448), projector=projector, vision_kind=kind)
    assert tcfg.image_token_len == jcfg.image_token_len
    assert tcfg.vision_grid == jcfg.vision_grid

