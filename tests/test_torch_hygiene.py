"""Structural checks on the port (``merlin_tpu_torch`` and ``chip_smoke.py``):

  * nothing imports jax, flax, optax or merlin_tpu;
  * the entry points default to the card (``device="cuda"``);
  * the decoder refuses only the options still to be ported
    (``scan_layers``), and builds with int8 weights and with ``remat``;
  * a kernel wrapper, or the attention dispatcher, given a tensor that is
    not on the CPU never reaches the plain version: read from its code (the
    CPU test has no card), and shown at run time with tensors on the meta
    device, which the wrapper refuses before any launch;
  * the tree carries the kernel sources the build compiles.
"""

import ast
import inspect
import pathlib

import pytest
import torch

import merlin_tpu_torch
from merlin_tpu_torch.generate.decode import Generator
from merlin_tpu_torch.models.bridge import init_params
from merlin_tpu_torch.models.decoder import CausalLM, init_kv_cache
from merlin_tpu_torch.models.families import tiny
from merlin_tpu_torch.ops import _build
from merlin_tpu_torch.ops import attention as attn_ops
from merlin_tpu_torch.ops import flash_attention as fa
from merlin_tpu_torch.ops import onepass_attention as oa
from merlin_tpu_torch.ops import paged_attention as pa
from merlin_tpu_torch.ops.image_ops import preprocess_images
from merlin_tpu_torch.serve.engine import ServingEngine
from merlin_tpu_torch.train.trainer import Trainer

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = pathlib.Path(merlin_tpu_torch.__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "merlin_tpu")


def _port_files():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_of_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in FORBIDDEN, f"{path.name} imports {name}"


@pytest.mark.parametrize("fn", [init_params, init_kv_cache,
                                preprocess_images, Generator.__init__,
                                ServingEngine.__init__, Trainer.__init__],
                         ids=lambda f: f.__qualname__)
def test_entry_points_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


@pytest.mark.parametrize("wrapper,plain", [
    (oa.onepass_attention, "onepass_attention_plain"),
    (fa.flash_attention, "flash_attention_plain"),
    (fa.flash_attention_bwd_dq, "flash_attention_bwd_dq_plain"),
    (fa.flash_attention_bwd_dkv, "flash_attention_bwd_dkv_plain"),
    (fa.flash_attention_bwd, "flash_attention_bwd_plain"),
    (oa.onepass_attention_lse, "onepass_attention_lse_plain"),
    (oa.onepass_attention_bwd, "onepass_attention_bwd_plain"),
    (pa.paged_attention_dma, "paged_attention_plain"),
    (pa.paged_attention, "paged_attention_plain"),
    (pa.paged_attention_dma_multi, "paged_attention_multi_plain"),
    (pa.paged_attention_multi_blocked, "paged_attention_multi_plain"),
    (pa.paged_attention_dma_q8, "paged_attention_q8_plain"),
    (pa.paged_attention_quantized, "paged_attention_q8_plain"),
    (pa.paged_attention_dma_multi_q8, "paged_attention_multi_q8_plain"),
    (pa.paged_attention_multi_blocked_q8, "paged_attention_multi_q8_plain")])
def test_wrapper_reaches_plain_only_for_cpu_tensors(wrapper, plain):
    """The plain version is called in exactly one place: the body of the
    wrapper's first statement, ``if q.device.type == "cpu": return ...``.
    No try/except anywhere in the wrapper can swap it in."""
    fn = ast.parse(inspect.getsource(wrapper)).body[0]
    assert not any(isinstance(n, ast.Try) for n in ast.walk(fn))
    calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Name) and n.func.id == plain]
    assert len(calls) == 1
    body = [s for s in fn.body if not (isinstance(s, ast.Expr)
                                       and isinstance(s.value, ast.Constant))]
    guard = next(s for s in body if isinstance(s, ast.If))
    assert ast.unparse(guard.test) == "q.device.type == 'cpu'"
    assert len(guard.body) == 1 and isinstance(guard.body[0], ast.Return)
    assert calls[0] in list(ast.walk(guard.body[0]))
    assert not guard.orelse


def test_dispatcher_sends_plain_only_cpu_or_short_or_wide_calls():
    """``attention()`` calls ``mha_reference`` in one place, guarded by the
    JAX shape rule and the CPU test alone: no dtype term, no flag."""
    fn = ast.parse(inspect.getsource(attn_ops.attention)).body[0]
    assert not any(isinstance(n, ast.Try) for n in ast.walk(fn))
    assert [a.arg for a in fn.args.kwonlyargs] == [
        "causal", "segment_ids_q", "segment_ids_kv", "alibi_slopes", "scale"]
    calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Name) and n.func.id == "mha_reference"]
    assert len(calls) == 1
    guard = next(s for s in fn.body if isinstance(s, ast.If))
    assert ast.unparse(guard.test) == \
        "q.device.type == 'cpu' or sq < 128 or d > 256"
    assert len(guard.body) == 1 and isinstance(guard.body[0], ast.Return)
    assert calls[0] in list(ast.walk(guard.body[0]))
    assert not guard.orelse


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_non_cpu_tensors_are_refused_not_computed_plain(dtype):
    """Tensors on the meta device stand in for CUDA ones: the wrappers and
    the dispatcher's kernel routes refuse them before any launch, whatever
    the dtype, where the plain path would have computed a result."""
    q = torch.empty((1, 130, 2, 64), dtype=dtype, device="meta")
    for call in (lambda: oa.onepass_attention(q, q, q),
                 lambda: fa.flash_attention(q, q, q),
                 lambda: attn_ops.attention(q, q, q, causal=False),
                 lambda: attn_ops.attention(q, q, q, causal=True)):
        before = (oa.onepass_attention.launches, fa.flash_attention.launches)
        with pytest.raises(ValueError, match="CUDA"):
            call()
        assert (oa.onepass_attention.launches,
                fa.flash_attention.launches) == before


BWD_WRAPPERS = (fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv,
                fa.flash_attention_bwd, oa.onepass_attention_lse,
                oa.onepass_attention_bwd)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_backward_wrappers_refuse_non_cpu_tensors(dtype):
    """The training kernels' wrappers (B10-B13, and the fused B10 + B11
    entry) refuse meta tensors before any launch, as the forward ones
    do."""
    q = torch.empty((1, 130, 2, 64), dtype=dtype, device="meta")
    lse = torch.empty((1, 2, 130), dtype=torch.float32, device="meta")
    for call in (lambda: fa.flash_attention_bwd_dq(q, q, q, q, lse, lse),
                 lambda: fa.flash_attention_bwd_dkv(q, q, q, q, lse, lse),
                 lambda: fa.flash_attention_bwd(q, q, q, q, lse, q),
                 lambda: oa.onepass_attention_lse(q, q, q),
                 lambda: oa.onepass_attention_bwd(q, q, q, q, lse, q)):
        before = [w.launches for w in BWD_WRAPPERS]
        with pytest.raises(ValueError, match="CUDA"):
            call()
        assert [w.launches for w in BWD_WRAPPERS] == before


def test_kernel_sources_are_in_the_tree():
    names = {p.name for p in _build.sources()}
    assert {"onepass_attention.cu", "flash_attention.cu",
            "flash_attention_bwd.cu", "paged_attention.cu",
            "attention_core.cuh"} <= names
    for name, argtypes in _build.SIGNATURES.items():
        text = "".join(p.read_text() for p in _build.sources())
        assert f'extern "C" int {name}(' in text
        assert len(argtypes) > 0


PAGED_WRAPPERS = (pa.paged_attention_dma, pa.paged_attention,
                  pa.paged_attention_dma_multi,
                  pa.paged_attention_multi_blocked,
                  pa.paged_attention_dma_q8, pa.paged_attention_quantized,
                  pa.paged_attention_dma_multi_q8,
                  pa.paged_attention_multi_blocked_q8)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_paged_wrappers_refuse_non_cpu_tensors(dtype):
    """Meta tensors stand in for CUDA ones: each paged wrapper, bf16 and
    int8 pages alike, and the window routers, refuse them before any
    launch, whatever q's dtype."""
    pages = torch.empty((9, 16, 4 * 64), dtype=dtype, device="meta")
    lengths = torch.empty((2,), dtype=torch.int32, device="meta")
    tables = torch.empty((2, 4), dtype=torch.int32, device="meta")
    q1 = torch.empty((2, 4, 64), dtype=dtype, device="meta")
    qw = torch.empty((2, 5, 4, 64), dtype=dtype, device="meta")
    calls = [lambda: pa.paged_attention_dma(q1, pages, pages, lengths,
                                            tables),
             lambda: pa.paged_attention(q1, pages, pages, lengths, tables),
             lambda: pa.paged_attention_dma_multi(qw, pages, pages, lengths,
                                                  tables),
             lambda: pa.paged_attention_multi_blocked(qw, pages, pages,
                                                      lengths, tables),
             lambda: pa.paged_window_attention(qw, pages, pages, lengths,
                                               tables)]
    q8 = (torch.empty((9, 16, 4 * 64), dtype=torch.int8, device="meta"),
          torch.empty((9, 16, 128), dtype=torch.float32, device="meta"))
    q8_pages = (q8[0], q8[1], q8[0], q8[1], lengths, tables)
    calls += [lambda: pa.paged_attention_dma_q8(q1, *q8_pages),
              lambda: pa.paged_attention_quantized(q1, *q8_pages),
              lambda: pa.paged_attention_dma_multi_q8(qw, *q8_pages),
              lambda: pa.paged_attention_multi_blocked_q8(qw, *q8_pages),
              lambda: pa.paged_window_attention_q8(qw, *q8_pages)]
    for call in calls:
        before = [w.launches for w in PAGED_WRAPPERS]
        with pytest.raises(ValueError, match="CUDA"):
            call()
        assert [w.launches for w in PAGED_WRAPPERS] == before


@pytest.mark.parametrize("option,refused", [
    (dict(paged_multi_query=True), False),
    (dict(scan_layers=True), True),
    (dict(remat=True), False),
    (dict(weight_dtype="int8"), False)],
    ids=["paged_multi_query", "scan_layers", "remat", "int8_weights"])
def test_decoder_refuses_only_unported_options(option, refused):
    cfg = tiny(**option)
    if refused:
        with pytest.raises(NotImplementedError, match="not ported"):
            CausalLM(cfg)
    else:
        model = CausalLM(cfg)
        assert model.cfg == cfg
        if cfg.weight_dtype == "int8":
            assert model.lm_head.kernel_q8.dtype == torch.int8
