"""Structural checks on the port (``merlin_tpu_torch`` and ``chip_smoke.py``):

  * nothing imports jax, flax, optax or merlin_tpu, and no port module
    names a path of the JAX package or its ``native/`` directory (the port
    builds its own copy of the tar loader);
  * the entry points default to the card (``device="cuda"``), the
    checkpoint reader too, and a checkpoint read for another device never
    lands on the CPU;
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
import re

import pytest
import torch

import merlin_tpu_torch
from merlin_tpu_torch.data import native_loader
from merlin_tpu_torch.engine import eval as eval_cli
from merlin_tpu_torch.engine import train as train_cli
from merlin_tpu_torch.eval import (
    box_eval, demo, docvqa, mmbench, mmvet, single, tracking)
from merlin_tpu_torch.eval.runner import EvalModel
from merlin_tpu_torch.generate.beam import BeamSearch
from merlin_tpu_torch.generate.decode import Generator
from merlin_tpu_torch.generate.speculative import SpeculativeGenerator
from merlin_tpu_torch.models.bridge import init_params
from merlin_tpu_torch.models.builder import init_or_load_params
from merlin_tpu_torch.models.convert import load_torch_state_dict
from merlin_tpu_torch.models.decoder import CausalLM, init_kv_cache
from merlin_tpu_torch.models.families import tiny
from merlin_tpu_torch.ops import _build
from merlin_tpu_torch.ops import attention as attn_ops
from merlin_tpu_torch.ops import flash_attention as fa
from merlin_tpu_torch.ops import onepass_attention as oa
from merlin_tpu_torch.ops import paged_attention as pa
from merlin_tpu_torch.ops.image_ops import preprocess_images
from merlin_tpu_torch.serve import worker as serve_worker
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


def _code_strings(tree):
    """String constants of a module's code, docstrings left out."""
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and \
                    isinstance(first.value, ast.Constant):
                docs.add(id(first.value))
    return [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
            and isinstance(n.value, str) and id(n) not in docs]


JAX_PATH = re.compile(r"(?:^|[^\w/.])(?:merlin_tpu|native)/")


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_names_no_path_of_the_jax_package(path):
    """No string in a port module's code names a ``merlin_tpu/`` path or
    the repository's ``native/`` directory; the one bare "native" is the
    native loader's own directory inside the port."""
    for text in _code_strings(ast.parse(path.read_text())):
        assert not JAX_PATH.search(text), f"{path.name}: {text!r}"
        assert text != "merlin_tpu", path.name
        if text == "native":
            assert path.name == "native_loader.py"


def test_native_loader_builds_from_the_ports_own_copy():
    for p in (native_loader._NATIVE_DIR, native_loader._SOURCE,
              native_loader._SO_PATH):
        assert pathlib.Path(p).resolve().is_relative_to(PKG)
    assert pathlib.Path(native_loader._SOURCE).exists()


@pytest.mark.parametrize("fn", [init_params, init_kv_cache,
                                preprocess_images, Generator.__init__,
                                ServingEngine.__init__, Trainer.__init__,
                                serve_worker.ModelWorker.__init__,
                                serve_worker.serve, EvalModel.__init__,
                                BeamSearch.__init__,
                                SpeculativeGenerator.__init__,
                                init_or_load_params, load_torch_state_dict,
                                train_cli.train],
                         ids=lambda f: f.__qualname__)
def test_entry_points_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


@pytest.mark.parametrize("fn", [mmbench.run, mmvet.run, docvqa.run,
                                single.run, tracking.run, box_eval.run_repl,
                                demo.run_demo],
                         ids=lambda f: f"{f.__module__.rpartition('.')[2]}."
                                       f"{f.__qualname__}")
def test_eval_harnesses_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


@pytest.mark.parametrize("cli,argv", [
    (eval_cli, ["--benchmark", "single", "--tiny"]),
    (demo, ["--tiny"])], ids=["engine.eval", "eval.demo"])
def test_eval_clis_default_to_the_card(monkeypatch, cli, argv):
    """``--device`` left out, the CLI loads the model onto the card."""
    asked = []

    class Stop(Exception):
        pass

    def load(bundle, **kw):
        asked.append(kw["device"])
        raise Stop

    # the demo imports the loader when it runs, the eval CLI when imported
    from merlin_tpu_torch.models import builder
    monkeypatch.setattr(builder if cli is demo else cli,
                        "init_or_load_params", load)
    # the eval CLI's logger setup would stop the package's records reaching
    # the root logger (caplog) in this worker's later tests
    monkeypatch.setattr(eval_cli, "setup_logger", lambda *a: None)
    with pytest.raises(Stop):
        cli.main(argv)
    assert asked == ["cuda"]


def test_checkpoint_reads_land_on_the_device_asked_for(tmp_path):
    """A checkpoint read for a device other than the CPU never hands back a
    CPU tensor: the meta device stands in for the card, and every tensor,
    looked up alone or loaded through ``init_or_load_params`` with a
    checkpoint, lands there (no quiet load to the CPU)."""
    from merlin_tpu_torch.models.builder import build_model_tokenizer
    from merlin_tpu_torch.models.families import tiny as tiny_lm
    from merlin_tpu_torch.train.arguments import parse_args

    lm = tiny_lm()
    sd = {"model.embed_tokens.weight": torch.ones(lm.vocab_size, 32),
          "model.norm.weight": torch.ones(32),
          "lm_head.weight": torch.ones(lm.vocab_size, 32)}
    for i in range(lm.num_layers):
        for name, shape in (("self_attn.q_proj", (32, 32)),
                            ("self_attn.k_proj", (32, 32)),
                            ("self_attn.v_proj", (32, 32)),
                            ("self_attn.o_proj", (32, 32)),
                            ("mlp.gate_proj", (64, 32)),
                            ("mlp.up_proj", (64, 32)),
                            ("mlp.down_proj", (32, 64)),
                            ("input_layernorm", (32,)),
                            ("post_attention_layernorm", (32,))):
            sd[f"model.layers.{i}.{name}.weight"] = torch.ones(shape)
    torch.save(sd, tmp_path / "pytorch_model.bin")
    ck = load_torch_state_dict(str(tmp_path), device="meta")
    assert all(ck[k].device.type == "meta" and ck[k].dtype == torch.float32
               for k in ck)
    bundle = build_model_tokenizer(*parse_args([]), tiny=True)
    params = init_or_load_params(bundle, lm_checkpoint=str(tmp_path),
                                 generator=torch.Generator(), device="meta")
    assert params and all(t.device.type == "meta" for t in params.values())


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
    assert {"attention_fwd.cu", "flash_attention_bwd.cu",
            "paged_attention.cu", "attention_core.cuh", "hopper.cuh"} <= names
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
