"""Checkpoint conversion for the port (counterpart of
``merlin_tpu/models/convert.py``).

  * :func:`load_torch_state_dict` reads an HF checkpoint: one ``.bin`` or
    ``.safetensors`` file, a sharded one through its ``*.index.json``, or a
    directory of such files (``training_args`` skipped). It returns a
    :class:`CheckpointDict`: each tensor is read from its file when it is
    looked up and handed over in f32 on the caller's device (the card by
    default), as JAX's ``_np`` makes every leaf f32. The files are memory
    mapped, so the host never holds the whole checkpoint, and each leaf
    goes to the device on its own, so the device holds the converted model
    plus one leaf.
  * :func:`extract_by_prefix` re-extracts a composite save's tower and
    projector (``model.vision_tower.``, ``model.projector.``) as a view.
  * :func:`decoder_params_from_hf` maps an HF decoder (``llama``,
    ``baichuan`` with its fused ``W_pack``, ``phi``, ``opt``) onto the flax
    param tree the JAX package builds, with tensors as leaves; flatten it
    with :func:`flat_state_dict` for ``load_state_dict``.
  * :func:`stack_layer_params` / :func:`unstack_layer_params`: a loop
    decoder's ``layers_{i}.*`` entries <-> the ``scan_layers`` layout's
    ``layers.block.*`` with a leading layer axis.
  * :func:`quantize_decoder_params_int8`: int8 weight-only quantization of
    a decoder's ``state_dict``, loop or stacked.
"""

from __future__ import annotations

import json
import os
import re
import zipfile
from typing import Any, Callable, Dict, Iterator, Mapping, Union

import torch

Device = Union[str, torch.device]


class CheckpointDict(Mapping):
    """The tensors of a checkpoint by name, each read from its file on
    lookup and returned as a new f32 tensor on ``device``. Nothing is kept
    between lookups: what the caller holds is all that is resident."""

    def __init__(self, where: Dict[str, str], device: Device = "cuda"):
        self._where = where                  # tensor name -> file
        self._files: Dict[str, Any] = {}
        self.device = torch.device(device)

    def _file(self, path: str):
        f = self._files.get(path)
        if f is None:
            f = self._files[path] = _open(path)
        return f

    def __getitem__(self, name: str) -> torch.Tensor:
        path = self._where[name]
        f = self._file(path)
        src = f.get_tensor(name) if path.endswith(".safetensors") \
            else f[name]
        # moved in its stored dtype (a bf16 leaf crosses at half the
        # bytes), then upcast on the device; never an alias of the file
        out = src.to(self.device).float()
        return out.clone() if out.data_ptr() == src.data_ptr() else out

    def __iter__(self) -> Iterator[str]:
        return iter(self._where)

    def __len__(self) -> int:
        return len(self._where)


def _open(path: str):
    """A file's tensors, lazily: safetensors through ``safe_open`` (which
    also reads bf16, where ``safetensors.numpy`` cannot), a torch zip file
    memory-mapped, a legacy pickle loaded whole."""
    if path.endswith(".safetensors"):
        from safetensors import safe_open

        return safe_open(path, framework="pt", device="cpu")
    return torch.load(path, map_location="cpu", weights_only=True,
                      mmap=zipfile.is_zipfile(path))


def _names(path: str):
    f = _open(path)
    return list(f.keys())


def load_torch_state_dict(path: str, device: Device = "cuda"
                          ) -> CheckpointDict:
    """A single or sharded HF checkpoint (file or directory) as a
    :class:`CheckpointDict` on ``device``. Files are taken as
    ``merlin_tpu/models/convert.py:33-59`` takes them: the shards an index
    names, else every ``.bin``/``.safetensors`` file but ``training_args``
    in name order, a later file's tensor replacing an earlier one's."""
    if os.path.isfile(path):
        files = [path]
    else:
        index = [f for f in os.listdir(path) if f.endswith(".index.json")]
        if index:
            with open(os.path.join(path, index[0])) as f:
                shards = sorted(set(json.load(f)["weight_map"].values()))
            files = [os.path.join(path, s) for s in shards]
        else:
            files = [os.path.join(path, f) for f in sorted(os.listdir(path))
                     if f.endswith((".bin", ".safetensors"))
                     and "training_args" not in f]
    where: Dict[str, str] = {}
    for file in files:
        where.update(dict.fromkeys(_names(file), file))
    return CheckpointDict(where, device)


class _View(Mapping):
    """Names of ``source`` picked and renamed by ``rename`` (None drops a
    name); a value is looked up in ``source`` only when asked for."""

    def __init__(self, source: Mapping[str, Any],
                 rename: Callable[[str], Any]):
        self._source = source
        self._names = {}
        for name in source:
            new = rename(name)
            if new is not None:
                self._names[new] = name

    def __getitem__(self, name: str):
        return self._source[self._names[name]]

    def __iter__(self) -> Iterator[str]:
        return iter(self._names)

    def __len__(self) -> int:
        return len(self._names)


def extract_by_prefix(state_dict: Mapping[str, Any],
                      prefix: str) -> Mapping[str, Any]:
    """The entries under ``prefix``, renamed without it (the composite
    re-extraction of ``model.vision_tower.`` and ``model.projector.``)."""
    return _View(state_dict, lambda k: k[len(prefix):]
                 if k.startswith(prefix) else None)


def drop_prefixes(state_dict: Mapping[str, Any],
                  prefixes) -> Mapping[str, Any]:
    """The entries whose names start with none of ``prefixes``."""
    return _View(state_dict, lambda k: None if k.startswith(tuple(prefixes))
                 else k)


def flat_state_dict(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax-named tree of tensors -> ``state_dict`` entries (the path
    joined with '.', as :func:`~merlin_tpu_torch.models.bridge.
    params_from_flax` names them), each contiguous.

    The tree is consumed: each leaf leaves it as its contiguous copy is
    made, so a relayout view (a transposed kernel) and the tensor it views
    are freed one leaf at a time, and the peak stays the model plus one
    leaf."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        for key in list(node):
            val = node.pop(key)
            name = f"{prefix}.{key}" if prefix else str(key)
            if isinstance(val, Mapping):
                walk(val, name)
            else:
                out[name] = val.contiguous()
            del val

    walk(tree, "")
    return out


def _qkv_kernel(w: torch.Tensor, heads: int, head_dim: int) -> torch.Tensor:
    """HF (out=h*d, in) -> (in, h, d)."""
    out_dim, in_dim = w.shape
    return w.T.reshape(in_dim, heads, head_dim)


def _o_kernel(w: torch.Tensor, heads: int, head_dim: int) -> torch.Tensor:
    """HF (out=hidden, in=h*d) -> (h, d, hidden)."""
    out_dim, in_dim = w.shape
    return w.T.reshape(heads, head_dim, out_dim)


def _keyed(sd: Mapping[str, Any]):
    """``key(*names)``: the first of ``names`` the checkpoint holds, in f32
    (JAX's ``_np`` upcasts every leaf; a no-op on a CheckpointDict's)."""
    def key(*cands):
        for c in cands:
            if c in sd:
                return sd[c].float()
        raise KeyError(f"none of {cands} in checkpoint (have {len(sd)} "
                       "keys)")
    return key


def decoder_params_from_hf(state_dict: Mapping[str, Any], cfg, *,
                           family: str = "llama") -> Dict[str, Any]:
    """HF decoder weights -> the CausalLM's flax-named tree
    (``merlin_tpu/models/convert.py:199-329``): 'llama' (Vicuna/Llama),
    'baichuan' (fused ``W_pack`` QKV), 'phi' (``PhiForCausalLM``: biases,
    ``dense``, LayerNorm biases), 'opt' (learned positions,
    ``self_attn_layer_norm``/``final_layer_norm``). The head is
    ``lm_head_kernel`` under NormHead, ``lm_head`` (with its bias where the
    config has one) otherwise, and absent with tied embeddings."""
    h, hkv, d = cfg.num_heads, cfg.kv_heads, cfg.head_size
    key = _keyed(state_dict)
    p: Dict[str, Any] = {}

    if family == "opt":
        base = "model.decoder."
        p["embed_tokens"] = {"embedding": key(base + "embed_tokens.weight")}
        p["embed_positions"] = {
            "embedding": key(base + "embed_positions.weight")}
    else:
        p["embed_tokens"] = {"embedding": key(
            "model.embed_tokens.weight", "transformer.embed_tokens.weight")}

    def qkv(lb, names, bias):
        out = {}
        for name, src, n in zip(("q_proj", "k_proj", "v_proj"), names,
                                (h, hkv, hkv)):
            w = src if torch.is_tensor(src) else key(lb + src + ".weight")
            out[name] = {"kernel": _qkv_kernel(w, n, d)}
            if bias:
                out[name]["bias"] = key(lb + src + ".bias").reshape(n, d)
        return out

    def o(lb, name, bias):
        out = {"kernel": _o_kernel(key(lb + name + ".weight"), h, d)}
        if bias:
            out["bias"] = key(lb + name + ".bias")
        return out

    def gated(lb):
        return {m: {"kernel": key(lb + f"mlp.{m}.weight").T}
                for m in ("gate_proj", "up_proj", "down_proj")}

    def fc(lb, prefix):
        return {m: {"kernel": key(lb + prefix + m + ".weight").T,
                    "bias": key(lb + prefix + m + ".bias")}
                for m in ("fc1", "fc2")}

    def norm(name, bias):
        out = {"scale": key(name + ".weight")}
        if bias:
            out["bias"] = key(name + ".bias")
        return out

    for i in range(cfg.num_layers):
        lp: Dict[str, Any] = {}
        if family == "llama":
            lb = f"model.layers.{i}."
            lp["attn"] = qkv(lb, ("self_attn.q_proj", "self_attn.k_proj",
                                  "self_attn.v_proj"), False)
            lp["attn"]["o_proj"] = o(lb, "self_attn.o_proj", False)
            lp["mlp"] = gated(lb)
            lp["input_norm"] = norm(lb + "input_layernorm", False)
            lp["post_attn_norm"] = norm(lb + "post_attention_layernorm",
                                        False)
        elif family == "baichuan":
            lb = f"model.layers.{i}."
            wpack = key(lb + "self_attn.W_pack.weight")  # (3*hidden, hidden)
            hd = h * d
            lp["attn"] = qkv(lb, (wpack[:hd], wpack[hd:2 * hd],
                                  wpack[2 * hd:]), False)
            del wpack
            lp["attn"]["o_proj"] = o(lb, "self_attn.o_proj", False)
            lp["mlp"] = gated(lb)
            lp["input_norm"] = norm(lb + "input_layernorm", False)
            lp["post_attn_norm"] = norm(lb + "post_attention_layernorm",
                                        False)
        elif family == "phi":
            lb = f"model.layers.{i}."
            lp["attn"] = qkv(lb, ("self_attn.q_proj", "self_attn.k_proj",
                                  "self_attn.v_proj"), True)
            lp["attn"]["o_proj"] = o(lb, "self_attn.dense", True)
            lp["mlp"] = fc(lb, "mlp.")
            lp["input_norm"] = norm(lb + "input_layernorm", True)
        elif family == "opt":
            lb = f"model.decoder.layers.{i}."
            lp["attn"] = qkv(lb, ("self_attn.q_proj", "self_attn.k_proj",
                                  "self_attn.v_proj"), True)
            lp["attn"]["o_proj"] = o(lb, "self_attn.out_proj", True)
            lp["mlp"] = fc(lb, "")
            lp["input_norm"] = norm(lb + "self_attn_layer_norm", True)
            lp["post_attn_norm"] = norm(lb + "final_layer_norm", True)
        else:
            raise ValueError(f"unknown family {family}")
        p[f"layers_{i}"] = lp

    if family in ("llama", "baichuan"):
        p["final_norm"] = norm("model.norm", False)
    elif family == "phi":
        p["final_norm"] = norm("model.final_layernorm", True)
    else:
        p["final_norm"] = norm("model.decoder.final_layer_norm", True)

    if not cfg.tie_word_embeddings:
        w = key("lm_head.weight")
        if cfg.normhead:
            p["lm_head_kernel"] = w.T
        else:
            head = {"kernel": w.T}
            if cfg.lm_head_bias:
                head["bias"] = key("lm_head.bias")
            p["lm_head"] = head
    return p

def stack_layer_params(state_dict: Dict[str, torch.Tensor], num_layers: int,
                       prefix: str = "") -> Dict[str, torch.Tensor]:
    """Loop-decoder entries (``{prefix}layers_{i}.<leaf>``) -> the
    ``scan_layers`` ones (``{prefix}layers.block.<leaf>``, the layers
    stacked on a leading axis), as ``convert.py:69-80`` does to the flax
    tree; the other entries pass through. Pass an MMGPT's whole
    ``state_dict`` with ``prefix="lm."``. The input dict is consumed: each
    layer's leaf leaves it as it is stacked, so the peak is the model plus
    one stacked leaf. Inverse of :func:`unstack_layer_params`."""
    pattern = re.compile(re.escape(prefix) + r"layers_(\d+)\.(.+)$")
    layers = [dict() for _ in range(num_layers)]
    out = {}
    for name in list(state_dict):
        m = pattern.match(name)
        if m is None:
            out[name] = state_dict.pop(name)
        else:
            layers[int(m.group(1))][m.group(2)] = name
    for leaf in layers[0]:
        out[f"{prefix}layers.block.{leaf}"] = torch.stack(
            [state_dict.pop(layer[leaf]) for layer in layers])
    if state_dict:
        raise KeyError(f"layer entries outside layers 0..{num_layers - 1} "
                       f"or not in layer 0: {sorted(state_dict)[:8]}")
    return out


def unstack_layer_params(state_dict: Dict[str, torch.Tensor],
                         prefix: str = "") -> Dict[str, torch.Tensor]:
    """``scan_layers`` entries -> the loop decoder's (``convert.py:83-94``):
    ``{prefix}layers.block.<leaf>`` of (L, ...) becomes L entries
    ``{prefix}layers_{i}.<leaf>``, each a view of its layer's slice."""
    stacked = f"{prefix}layers.block."
    out = {}
    for name, t in state_dict.items():
        if not name.startswith(stacked):
            out[name] = t
            continue
        leaf = name[len(stacked):]
        for i, layer in enumerate(t.unbind(0)):
            out[f"{prefix}layers_{i}.{leaf}"] = layer
    return out


# modules whose kernels quantize for int8 weight-only serving, mapped to the
# number of CONTRACTION (input) axes of their kernel; the remaining trailing
# axes are output channels, one scale each (convert.py:101-103). CLIP's MLP
# uses the names fc1/fc2 too: only the decoder's state is ever quantized.
_Q8_KERNELS = {"q_proj": 1, "k_proj": 1, "v_proj": 1, "o_proj": 2,
               "gate_proj": 1, "up_proj": 1, "down_proj": 1,
               "fc1": 1, "fc2": 1, "lm_head": 1}


@torch.no_grad()
def quantize_decoder_params_int8(state_dict: Dict[str, torch.Tensor],
                                 prefix: str = "") -> Dict[str, torch.Tensor]:
    """A decoder's ``state_dict`` -> the ``weight_dtype="int8"`` one.

    Per-output-channel symmetric absmax quantization (convert.py:130-184):
    each ``<module>.kernel`` of a module named in ``_Q8_KERNELS`` becomes
    ``kernel_q8`` (int8, rint of kernel / scale, clipped to +-127) and
    ``kernel_scale`` (f32 over the output dims: max |kernel| / 127, floored
    at 1e-12). Embeddings, norms and biases pass through as they are.

    A stacked decoder's kernels (``layers.block.*``, a leading layer axis)
    get one scale per layer and output channel, quantized layer by layer
    (``convert.py:138-180``), so the f32 temporary is one layer's kernel.

    Only the entries under ``prefix`` are the decoder's: pass an MMGPT's
    whole ``state_dict`` with ``prefix="lm."`` so that the vision tower
    (whose MLP also has fc1/fc2) passes through untouched, as JAX quantizes
    only the LM subtree (``serve/worker.py:410-413``). Tensors stay on their
    device and are converted one kernel at a time, so the peak is the
    source, its int8 copy and one kernel in f32.
    """
    if not prefix and any(name.startswith("lm.") for name in state_dict):
        raise ValueError("an MMGPT state_dict: pass prefix='lm.' so that the "
                         "vision tower is left alone")
    out = {}
    for name, tensor in state_dict.items():
        module, _, leaf = name.rpartition(".")
        n_contract = _Q8_KERNELS.get(module.rpartition(".")[2])
        if not name.startswith(prefix) or leaf != "kernel" \
                or n_contract is None:
            out[name] = tensor
            continue
        if f"{prefix}layers.block." in f"{module}.":
            pairs = [_quantize(k, n_contract) for k in tensor.unbind(0)]
            q8 = torch.stack([q for q, _ in pairs])
            scale = torch.stack([sc for _, sc in pairs])
        else:
            q8, scale = _quantize(tensor, n_contract)
        out[f"{module}.kernel_q8"] = q8
        out[f"{module}.kernel_scale"] = scale
    return out


def _quantize(kernel: torch.Tensor, n_contract: int):
    """(int8 kernel, f32 scale over the output dims) of one kernel."""
    k = kernel.float()
    axes = tuple(range(n_contract))
    scale = torch.clamp(k.abs().amax(dim=axes, keepdim=True) / 127.0,
                        min=1e-12)
    q8 = torch.clamp(torch.round(k / scale), -127, 127).to(torch.int8)
    return q8, scale.reshape(scale.shape[n_contract:])
