"""Model + tokenizer factory (counterpart of ``merlin_tpu/models/builder.py``).

  * :func:`build_model_tokenizer`: name-substring LM dispatch with the RoPE
    scaling rewrite, the tokenizer (right padding, pad = unk, the
    multimodal special tokens and the vocabulary grown to hold them), the
    vision tower and projector, the tower geometry written back into the
    data arguments, and the freeze matrix. The module is built on the
    ``meta`` device: no weight exists until :func:`init_or_load_params`.
  * :func:`_freeze_masks`: which parameter paths train, and which embedding
    rows may move while a frozen LM keeps the rest of its table
    (``builder.py:129-160``); :func:`make_bundle` applies it to a module
    built elsewhere.
  * :func:`init_or_load_params`: the parameters on the device, from
    checkpoints (an HF LM, an HF CLIP tower, or a composite MMGPT save
    with its tower and projector under ``model.vision_tower.`` and
    ``model.projector.``) where given, else random with the flax tree's
    names, shapes, dtypes and initializers. Two JAX behaviours are kept on
    purpose: a composite's tower always goes through the CLIP converter
    (trap C25), and ``family`` defaults to "llama" (trap C26).
  * :func:`quantize_bundle_lm_int8`: weight-only int8 for the LM subtree
    only (trap C12: CLIP's MLP shares the ``fc1``/``fc2`` names).
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from merlin_tpu_torch.models.convert import (
    decoder_params_from_hf, drop_prefixes, extract_by_prefix,
    flat_state_dict, load_torch_state_dict, stack_layer_params)
from merlin_tpu_torch.models.families import config_from_name, tiny as tiny_lm
from merlin_tpu_torch.models.mmgpt import MMGPT, MMGPTConfig
from merlin_tpu_torch.models.projectors import (
    default_resampler_heads, resampler_params_from_torch, resampler_pos_init)
from merlin_tpu_torch.models.vision_builder import (
    default_vision_config, vision_kind_from_name)
from merlin_tpu_torch.models.vit import tiny_vit, vit_params_from_hf
from merlin_tpu_torch.utils import constants as C
from merlin_tpu_torch.utils.tokenizer import (
    MM_SPECIAL_TOKENS, SpecialIds, TinyTokenizer, load_tokenizer,
    resize_embeddings_mean_init)

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class ModelBundle:
    model: nn.Module                       # MMGPT, holding its parameters
    config: MMGPTConfig
    orig_vocab_size: int                   # rows before special tokens
    trainable_mask: Optional[Callable[[Tuple[str, ...]], bool]] = None
    embed_row_trainable: Optional[np.ndarray] = None  # per-row float mask
    tokenizer: Any = None
    special_ids: Optional[SpecialIds] = None
    # the model's state_dict once its weights exist (None until init/load)
    params: Optional[Dict[str, torch.Tensor]] = None


def _tiny_tokenizer_with_mm_tokens(model_max_length):
    tok = TinyTokenizer(model_max_length)
    tok.add_tokens(MM_SPECIAL_TOKENS, special_tokens=True)
    ids = SpecialIds(
        pad=tok.pad_token_id, bos=tok.bos_token_id, eos=tok.eos_token_id,
        unk=tok.unk_token_id,
        image_patch=tok.convert_tokens_to_ids(C.DEFAULT_IM_PATCH_TOKEN),
        im_start=tok.convert_tokens_to_ids(C.DEFAULT_IM_START_TOKEN),
        im_end=tok.convert_tokens_to_ids(C.DEFAULT_IM_END_TOKEN))
    return tok, ids, len(MM_SPECIAL_TOKENS)


def build_model_tokenizer(model_args, data_args, training_args,
                          *, tiny: bool = False) -> ModelBundle:
    """The MMGPT definition and its tokenizer. ``tiny=True`` builds the
    test-scale geometry with the :class:`TinyTokenizer`. The module is
    built on the ``meta`` device; call :func:`init_or_load_params` next."""
    dtype = torch.bfloat16 if getattr(training_args, "bf16", True) \
        else torch.float32

    if tiny:
        lm_cfg = tiny_lm(remat=training_args.gradient_checkpointing,
                         scan_layers=getattr(model_args, "scan_layers",
                                             False))
        vit_cfg = tiny_vit()
        vision_kind = "clip"
        tokenizer, ids, num_added = _tiny_tokenizer_with_mm_tokens(
            training_args.model_max_length)
        orig_vocab = lm_cfg.vocab_size - num_added
    else:
        lm_cfg = config_from_name(
            model_args.model_name_or_path,
            model_max_length=training_args.model_max_length,
            dtype=dtype, remat=training_args.gradient_checkpointing)
        if getattr(model_args, "scan_layers", False):
            lm_cfg = dataclasses.replace(lm_cfg, scan_layers=True)
        vision_kind = vision_kind_from_name(model_args.vision_tower or "clip")
        vit_cfg = default_vision_config(vision_kind, data_args.image_size,
                                        dtype=dtype)
        try:
            tokenizer, ids, num_added = load_tokenizer(
                model_args.model_name_or_path,
                model_max_length=training_args.model_max_length)
        except Exception as e:
            # as JAX: any failure to load falls back to the TinyTokenizer
            logger.warning("tokenizer %r did not load (%s: %s); using the "
                           "TinyTokenizer", model_args.model_name_or_path,
                           type(e).__name__, e)
            tokenizer, ids, num_added = _tiny_tokenizer_with_mm_tokens(
                training_args.model_max_length)
        orig_vocab = lm_cfg.vocab_size
        new_vocab = max(lm_cfg.vocab_size, len(tokenizer))
        if num_added:
            new_vocab = max(new_vocab, orig_vocab + num_added)
        lm_cfg = dataclasses.replace(lm_cfg, vocab_size=new_vocab)

    cfg = MMGPTConfig(
        lm=lm_cfg, vit=vit_cfg,
        projector=model_args.projector, conv_stride=model_args.conv_stride,
        vision_kind=vision_kind,
        select_layer=model_args.mm_vision_select_layer,
        select_feature=model_args.mm_vision_select_feature,
        use_im_start_end=model_args.mm_use_im_start_end,
        image_patch_id=ids.image_patch, im_start_id=ids.im_start,
        im_end_id=ids.im_end)

    # the tower geometry goes back into the data arguments
    data_args.num_patches = cfg.image_token_len
    data_args.image_size = getattr(vit_cfg, "image_size",
                                   getattr(vit_cfg, "img_size", 448))

    with torch.device("meta"):
        model = MMGPT(cfg)
    trainable, row_mask = _freeze_masks(model_args, cfg, orig_vocab)
    return ModelBundle(model=model, config=cfg, orig_vocab_size=orig_vocab,
                       trainable_mask=trainable, embed_row_trainable=row_mask,
                       tokenizer=tokenizer, special_ids=ids)


def _freeze_masks(model_args, cfg: MMGPTConfig, orig_vocab: int):
    """Reference freeze matrix -> (path -> trainable, embedding row mask).

    A path is a parameter name split at '.', the flax path the port keeps
    (``vision_tower.vit.layers_3.q_proj.kernel``). The last ViT layer never
    trains; a frozen LM keeps only its new-token embedding rows trainable
    when ``tune_im_start_end`` (base_mmgpt.py:78-97). The SAM encoder has
    no ``num_layers`` (JAX raises there, trap C27): it runs every block,
    so none is held back."""
    last_layer = (f"layers_{cfg.vit.num_layers - 1}"
                  if hasattr(cfg.vit, "num_layers") else None)

    def trainable(path: Tuple[str, ...]) -> bool:
        if path[0] == "vision_tower":
            if last_layer in path:
                return False  # always-detached last ViT layer
            return not model_args.freeze_vision_tower
        if path[0] == "projector":
            return not model_args.freeze_projector
        if model_args.freeze_lm_model:
            # embeddings handled by the row mask; everything else frozen
            return "embed_tokens" in path and model_args.tune_im_start_end
        return True

    row_mask = None
    if model_args.freeze_lm_model and model_args.tune_im_start_end:
        row_mask = np.zeros((cfg.lm.vocab_size,), np.float32)
        row_mask[orig_vocab:] = 1.0
        # tokenizers that place the new tokens at low ids
        for tid in (cfg.image_patch_id, cfg.im_start_id, cfg.im_end_id):
            if 0 <= tid < cfg.lm.vocab_size:
                row_mask[tid] = 1.0
    return trainable, row_mask


def make_bundle(model: nn.Module, model_args,
                orig_vocab_size: int) -> ModelBundle:
    """Bundle an MMGPT with the freeze matrix ``model_args`` asks for."""
    trainable, row_mask = _freeze_masks(model_args, model.cfg,
                                        orig_vocab_size)
    return ModelBundle(model=model, config=model.cfg,
                       orig_vocab_size=orig_vocab_size,
                       trainable_mask=trainable,
                       embed_row_trainable=row_mask)


# flax's initializer for each leaf name of the ported modules
_ONES = ("scale", "kernel_scale")
_ZEROS = ("bias", "kernel_q8", "rel_pos_h", "rel_pos_w")
_NORMAL_002 = ("embedding", "class_embedding", "position_embedding", "proj")
_LECUN = ("kernel", "lm_head_kernel")
_TRUNC_002 = ("query",)


def _flax_like(name: str, shape, dtype: torch.dtype, generator, device):
    """A fresh leaf as flax initializes it: ones, zeros, N(0, 0.02),
    lecun_normal (a normal truncated at 2 std, std sqrt(1 / fan_in) /
    0.8796, fan_in = every axis but the last), truncated_normal(0.02) for
    the resampler's queries, and ``pos_embed``: the resampler's sin-cos
    table, SAM's zeros."""
    leaf = name.rpartition(".")[2]
    out = torch.empty(shape, dtype=dtype, device=device)
    if leaf in _ONES:
        return out.fill_(1)
    if leaf in _ZEROS:
        return out.zero_()
    if leaf in _NORMAL_002:
        return out.normal_(0.0, 0.02, generator=generator)
    if leaf in _LECUN or leaf in _TRUNC_002:
        std = (0.02 if leaf in _TRUNC_002
               else math.sqrt(1.0 / (math.prod(shape) // shape[-1]))) \
            / 0.87962566103423978
        return nn.init.trunc_normal_(out, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)
    if leaf == "pos_embed":
        if len(shape) == 2:
            return out.copy_(resampler_pos_init(*shape))
        return out.zero_()
    raise ValueError(f"no flax initializer known for {name!r}")


def _tower_tree(sd, cfg: MMGPTConfig) -> Dict[str, Any]:
    """A tower's HF CLIP weights as the vision_tower subtree. JAX sends any
    tower kind through the CLIP converter (``builder.py:206-207``, trap
    C25), so a SAM tower fails here and a Qwen one needs CLIP's keys."""
    return {"vit": vit_params_from_hf(sd, cfg.vit)}


def _load_tree(bundle: ModelBundle, **kw) -> Dict[str, torch.Tensor]:
    """The checkpoints' weights as ``state_dict`` entries on ``device``
    (``merlin_tpu/models/builder.py:185-233``). Checkpoints convert into
    the loop layout; a ``scan_layers`` LM stacks it, one leaf at a time
    (``builder.py:191-198``)."""
    out = _load_loop_tree(bundle, **kw)
    if bundle.config.lm.scan_layers:
        out = stack_layer_params(out, bundle.config.lm.num_layers,
                                 prefix="lm.")
    return out


def _load_loop_tree(bundle: ModelBundle, *, lm_checkpoint,
                    vision_checkpoint, composite_checkpoint, family: str,
                    device) -> Dict[str, torch.Tensor]:
    cfg = bundle.config
    tree: Dict[str, Any] = {}
    if composite_checkpoint:
        sd = load_torch_state_dict(composite_checkpoint, device=device)
        tree["lm"] = decoder_params_from_hf(
            drop_prefixes(sd, ("model.vision_tower", "model.projector")),
            cfg.lm, family=family)
        tower_sd = extract_by_prefix(sd, "model.vision_tower.")
        if tower_sd:
            tree["vision_tower"] = _tower_tree(tower_sd, cfg)
        proj_sd = extract_by_prefix(sd, "model.projector.")
        if proj_sd:
            tree["projector"] = _projector_params_from_torch(proj_sd, cfg)
        return flat_state_dict(tree)
    if lm_checkpoint:
        sd = load_torch_state_dict(lm_checkpoint, device=device)
        lm = decoder_params_from_hf(sd, cfg.lm, family=family)
        v = cfg.lm.vocab_size
        emb = lm["embed_tokens"]
        emb["embedding"] = resize_embeddings_mean_init(emb["embedding"], v)
        if not cfg.lm.tie_word_embeddings and "lm_head" in lm:
            head = lm["lm_head"]
            head["kernel"] = resize_embeddings_mean_init(head["kernel"].T,
                                                         v).T
        if "lm_head_kernel" in lm:
            # NormHead (Baichuan2) keeps a bare (H, V) kernel: the new
            # special-token columns are mean-initialized like the rows
            lm["lm_head_kernel"] = resize_embeddings_mean_init(
                lm["lm_head_kernel"].T, v).T
        tree["lm"] = lm
    if vision_checkpoint:
        sd = load_torch_state_dict(vision_checkpoint, device=device)
        tree["vision_tower"] = _tower_tree(sd, cfg)
    return flat_state_dict(tree)


@torch.no_grad()
def init_or_load_params(bundle: ModelBundle, *,
                        generator: Optional[torch.Generator] = None,
                        lm_checkpoint: Optional[str] = None,
                        vision_checkpoint: Optional[str] = None,
                        composite_checkpoint: Optional[str] = None,
                        family: str = "llama",
                        device: Union[str, torch.device] = "cuda"
                        ) -> Dict[str, torch.Tensor]:
    """Materialize the bundle's parameters on ``device`` and return its
    ``state_dict`` (also kept as ``bundle.params``).

    ``composite_checkpoint`` is a whole MMGPT save: the LM (HF ``family``
    keys, "llama" unless told otherwise, as JAX's worker never tells it:
    trap C26) plus ``model.vision_tower.*`` / ``model.projector.*``.
    Otherwise ``lm_checkpoint`` (an HF decoder; the embedding, an untied
    head and a NormHead grown to the vocabulary with mean-initialized
    rows) and ``vision_checkpoint`` (an HF CLIP tower) each replace their
    subtree. Checkpoint tensors arrive in f32 on ``device`` one at a time,
    so the peak is the model plus one leaf. A leaf no checkpoint holds
    takes the flax tree's dtype (f32; int8 for ``kernel_q8``) and
    initializer, drawn in ``named_parameters`` order from ``generator``
    (on ``device``; seed 0 if None). A checkpoint leaf of another shape
    than the model's, or of a name the model lacks, is refused."""
    device = torch.device(device)
    loaded = _load_tree(bundle, lm_checkpoint=lm_checkpoint,
                        vision_checkpoint=vision_checkpoint,
                        composite_checkpoint=composite_checkpoint,
                        family=family, device=device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    model = bundle.model
    params = dict(model.named_parameters())
    # the tower builds only the layers its selection runs; the converter,
    # as JAX's, maps them all
    vit = getattr(model.vision_tower, "vit", None)
    if vit is not None:
        skipped = tuple(f"vision_tower.vit.layers_{i}."
                        for i in range(vit.n_layers, vit.cfg.num_layers))
        loaded = {k: v for k, v in loaded.items()
                  if not k.startswith(skipped)}
    unknown = sorted(set(loaded) - set(params))
    if unknown:
        raise KeyError(f"checkpoint leaves the model does not have: "
                       f"{unknown[:8]}")
    for name, param in params.items():
        owner = model.get_submodule(name.rpartition(".")[0])
        fresh = loaded.pop(name, None)
        if fresh is None:
            dtype = torch.int8 if name.endswith("kernel_q8") \
                else torch.float32
            if ".layers.block." in name:
                # nn.scan initializes each layer's slice on its own: the
                # fan-in is a layer's, not the stack's
                fresh = torch.stack([
                    _flax_like(name, param.shape[1:], dtype, generator,
                               device) for _ in range(param.shape[0])])
            else:
                fresh = _flax_like(name, param.shape, dtype, generator,
                                   device)
        elif fresh.shape != param.shape:
            raise ValueError(f"{name}: checkpoint shape {tuple(fresh.shape)}"
                             f", model {tuple(param.shape)}")
        setattr(owner, name.rpartition(".")[2],
                nn.Parameter(fresh, requires_grad=param.requires_grad))
    bundle.params = model.state_dict()
    return bundle.params


def _projector_params_from_torch(sd, cfg: MMGPTConfig) -> Dict[str, Any]:
    """A reference projector's weights as the projector subtree
    (``merlin_tpu/models/builder.py:241-287``): conv, mlp/linear, the bare
    Qwen matrix, SAM's conv stack + linear, and the Qwen resampler
    (``attn_pool.*`` + ``ln_post`` + ``proj``)."""
    def t(name):
        return sd[name].float()

    hwio = (2, 3, 1, 0)          # torch conv OIHW -> flax HWIO
    if cfg.projector == "conv":
        return {"conv": {"kernel": t("conv.weight").permute(*hwio),
                         "bias": t("conv.bias")}}
    if cfg.projector in ("mlp", "linear"):
        name = "projector" if "projector.weight" in sd else "proj"
        return {"proj": {"kernel": t(name + ".weight").T,
                         "bias": t(name + ".bias")}}
    if cfg.projector == "qwen":
        # nn.Parameter (vision_hidden, lm_hidden), applied as x @ projector
        return {"proj": t("projector")}
    if cfg.projector == "sam":
        return {
            "conv1": {"kernel": t("projector.0.weight").permute(*hwio)},
            "conv2": {"kernel": t("projector.1.weight").permute(*hwio)},
            "proj": {"kernel": t("mlp.weight").T, "bias": t("mlp.bias")},
        }
    if cfg.projector in ("qwen_sampler", "resampler"):
        # the attention width from the packed (3E, E) in_proj; the heads by
        # the reference's rule, as build_projector picks them
        name = ("attn_pool.attn.in_proj_weight"
                if "attn_pool.attn.in_proj_weight" in sd
                else "attn.in_proj_weight")
        dim = sd[name].shape[1]
        return resampler_params_from_torch(
            sd, dim=dim, num_heads=default_resampler_heads(dim))
    raise NotImplementedError(
        f"torch import for projector {cfg.projector!r} not implemented")


@torch.no_grad()
def quantize_bundle_lm_int8(bundle: ModelBundle) -> ModelBundle:
    """Serving-time weight-only quantization of the LM half of a bundle.

    Returns a NEW bundle whose model has ``weight_dtype='int8'`` on the
    decoder: its kernels become int8 with per-output-channel scales, made
    on their device. The vision tower and the projector stay as they are
    and share their tensors with the input bundle (trap C12). Needs
    materialized parameters."""
    from merlin_tpu_torch.models.convert import quantize_decoder_params_int8

    if bundle.params is None:
        raise ValueError("load params before quantizing")
    cfg = dataclasses.replace(bundle.config, lm=dataclasses.replace(
        bundle.config.lm, weight_dtype="int8"))
    with torch.device("meta"):
        model = MMGPT(cfg)
    model.load_state_dict(quantize_decoder_params_int8(
        bundle.model.state_dict(), prefix="lm."), strict=True, assign=True)
    return dataclasses.replace(bundle, model=model, config=cfg,
                               params=model.state_dict())
