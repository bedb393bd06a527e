"""Serving a ``scan_layers`` model through the port, against the JAX
package on the CPU: the ``ServingEngine`` over one stacked paged pool
(``tests/test_serving_engine.py:241``), verify windows over a scanned
decoder (``test_paged_multi_decoder.py:142``), the scanned speculative
engine (``test_engine_speculative.py:98``), the int8 quantizer over a
stacked state (``test_quantized_weights.py:76``), a composite checkpoint
loaded into the stacked layout (``test_composite_checkpoint.py:204``) and
``python -m merlin_tpu_torch.serve.worker --tiny --device cpu
--scan-decode``.

One flax loop tree (every leaf perturbed) is stacked by JAX's
``stack_layer_params`` and bridged by ``params_from_flax``; f32
throughout (trap C6), tokens equal, route counts and free pages equal.
"""

import collections
import dataclasses
import os
import pathlib
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from merlin_tpu.models import builder as j_builder
from merlin_tpu.models.convert import (
    quantize_decoder_params_int8 as j_quantize)
from merlin_tpu.models.convert import stack_layer_params as j_stack
from merlin_tpu.models.decoder import CausalLM as JCausalLM
from merlin_tpu.models.families import tiny as j_tiny
from merlin_tpu.serve.engine import ServingEngine as JServingEngine
from merlin_tpu.train.arguments import (
    DataArguments, ModelArguments, TrainingArguments)

from merlin_tpu_torch.models import builder as t_builder
from merlin_tpu_torch.models.bridge import params_from_flax
from merlin_tpu_torch.models.convert import (
    quantize_decoder_params_int8, stack_layer_params)
from merlin_tpu_torch.models.decoder import CausalLM, init_kv_cache
from merlin_tpu_torch.models.families import tiny
from merlin_tpu_torch.serve import cli as t_cli
from merlin_tpu_torch.serve.engine import ServingEngine
from merlin_tpu_torch.serve.protocol import http_json
from merlin_tpu_torch.train.arguments import parse_args

from test_composite_checkpoint import (
    _clip_tower_sd, _llama_sd, _projector_sd, _write_sharded)

ROOT = pathlib.Path(__file__).resolve().parent.parent
EOS, PAD = 2, 0
BASE = dict(num_slots=2, max_len=64, eos_id=EOS, pad_id=PAD,
            prompt_bucket=16, page_size=16)
PROMPTS = [[5, 17, 33, 41], [7, 9, 11], [21, 22], [3, 4, 5, 6, 8]]
CHUNKED = [[5, 17, 33, 41], [7, 9, 11], list(range(3, 16)),
           list(range(40, 56))]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _models(positional):
    """(JAX scanned model, its stacked params, the port's scanned model,
    the port's loop model) on one perturbed flax loop tree."""
    cfg = j_tiny(positional=positional)
    params = nn.unbox(JCausalLM(cfg).init(
        jax.random.key(0), jnp.ones((1, 4), jnp.int32))["params"])
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.normal(size=x.shape).astype(
            np.float32), params)
    stacked = j_stack(dict(params), cfg.num_layers)
    jscan = JCausalLM(dataclasses.replace(cfg, scan_layers=True))
    tscan = CausalLM(tiny(positional=positional, scan_layers=True)).eval()
    tscan.load_state_dict(params_from_flax(stacked), strict=True)
    tloop = CausalLM(tiny(positional=positional)).eval()
    tloop.load_state_dict(params_from_flax(params), strict=True)
    return jscan, stacked, tscan, tloop


@pytest.fixture(scope="module")
def rope():
    return _models("rope")


@pytest.fixture(scope="module")
def alibi():
    return _models("alibi")


def _serve(engine, prompts, max_new):
    """(tokens per request, calls of each admission route, free pages
    left, free pages at the start)."""
    start = engine.pool.free_pages
    calls = collections.Counter()
    for name in ("_prefill", "_prefill_window", "_preempt_youngest"):
        fn = getattr(engine, name, None)
        if fn is not None:
            setattr(engine, name, lambda *a, _f=fn, _n=name, **k: (
                calls.update([_n]), _f(*a, **k))[1])
    reqs = [engine.submit(p, max_new_tokens=max_new) for p in prompts]
    engine.run_until_idle()
    assert all(r.done and r.error is None for r in reqs)
    return ([r.generated for r in reqs], dict(calls),
            engine.pool.free_pages, start)


CASES = {
    # name: (model, prompts, new tokens, cache dtype, engine options)
    "whole_prompt": ("rope", PROMPTS, 6, "f32", dict(chunk_steps=4)),
    "chunked": ("rope", CHUNKED, 6, "f32",
                dict(page_size=8, prefill_chunk=8)),
    "hybrid": ("rope", [[5, 17, 33, 41], list(range(7, 28))], 6, "f32",
               dict(page_size=8, prefill_chunk=8, prefill_chunk_min=8)),
    "preemption": ("rope", [list(range(5, 45)), list(range(7, 47))], 12,
                   "f32", dict(max_len=64, num_slots=2, chunk_steps=4,
                               page_size=16)),
    "speculative": ("rope", PROMPTS, 8, "f32",
                    dict(spec_draft=3, chunk_steps=2)),
    "speculative_chunked": ("rope", [[5, 17, 33, 41, 5, 17, 33],
                                     list(range(3, 24))], 8, "f32",
                            dict(page_size=8, prefill_chunk=8, spec_draft=2,
                                 chunk_steps=2)),
    "alibi_hybrid": ("alibi", CHUNKED, 6, "f32",
                     dict(page_size=8, prefill_chunk=8,
                          prefill_chunk_min=8)),
    "int8_pages": ("rope", PROMPTS, 6, "int8", dict(chunk_steps=4)),
    "int8_pages_hybrid": ("rope", CHUNKED, 6, "int8",
                          dict(page_size=8, prefill_chunk=8,
                               prefill_chunk_min=8)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_scan_engine_matches_jax(request, case):
    """The engine over a stacked pool: tokens, routes and free pages equal
    JAX's scanned engine's, and the tokens equal the port's loop engine's;
    the pool's free pages return to their start."""
    name, prompts, max_new, dt, kw = CASES[case]
    jscan, stacked, tscan, tloop = request.getfixturevalue(name)
    cfg = dict(BASE, **kw)
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "int8": (jnp.int8, torch.int8)}[dt]
    jengine = JServingEngine(jscan, stacked, cache_dtype=jdt, **cfg)
    tengine = ServingEngine(tscan, cache_dtype=tdt, device="cpu", **cfg)
    assert jengine._stacked and tengine._stacked
    assert tengine.cache["layers"]["k_pages"].shape[0] == 2
    want = _serve(jengine, prompts, max_new)
    got = _serve(tengine, prompts, max_new)
    assert got == want
    assert got[2] == got[3]
    loop = _serve(ServingEngine(tloop, cache_dtype=tdt, device="cpu", **cfg),
                  prompts, max_new)
    assert got[0] == loop[0]


def test_scan_engine_dropped_layer_offset_is_caught(rope, monkeypatch):
    """Without the per-layer page offset every layer reads and writes
    layer 0's pages: the tokens then differ from the loop engine's, so
    the comparison above can see that fault."""
    from merlin_tpu_torch.models import decoder

    _, _, tscan, tloop = rope
    cfg = dict(BASE, chunk_steps=4)
    want = _serve(ServingEngine(tloop, cache_dtype=torch.float32,
                                device="cpu", **cfg), PROMPTS, 6)[0]
    real = decoder.ScannedLayers._layer_caches

    def dropped(self, kv_cache, cache_aux):
        out = real(self, kv_cache, cache_aux)
        if kv_cache is not None and "page_tables" in kv_cache:
            out = [(c, dict(a, page_tables=kv_cache["page_tables"]))
                   for c, a in out]
        return out

    monkeypatch.setattr(decoder.ScannedLayers, "_layer_caches", dropped)
    got = _serve(ServingEngine(tscan, cache_dtype=torch.float32,
                               device="cpu", **cfg), PROMPTS, 6)[0]
    assert got != want


@pytest.mark.parametrize("name", ["rope", "alibi"])
def test_window_over_scanned_decoder(request, name):
    """A verify window over a scanned decoder and shuffled pool pages
    gives JAX's window logits, and the teacher-forced one-token steps'."""
    jscan, stacked, tscan, _ = request.getfixturevalue(name)
    cfg = tscan.cfg
    multi = CausalLM(dataclasses.replace(cfg, paged_multi_query=True))
    multi.load_state_dict(tscan.state_dict())
    jmulti = JCausalLM(dataclasses.replace(jscan.cfg, paged_multi_query=True))
    rng = np.random.default_rng(5)
    b, prompt, window = 2, 8, 3
    ids = rng.integers(3, 90, (b, prompt)).astype(np.int32)
    nxt = rng.integers(3, 90, (b, window)).astype(np.int32)
    perm = rng.permutation(np.arange(1, 8))

    def prefill(model, cache, torch_side):
        seg = np.ones((b, prompt), np.int32)
        pos = np.broadcast_to(np.arange(prompt), (b, prompt))
        if torch_side:
            return model(torch.from_numpy(ids).long(),
                         segment_ids=torch.from_numpy(seg),
                         positions=torch.from_numpy(pos.copy()),
                         kv_cache=cache)[1]
        return model.apply({"params": stacked}, jnp.asarray(ids),
                           segment_ids=jnp.asarray(seg),
                           positions=jnp.asarray(pos), kv_cache=cache)[1]

    def shuffled(cache, torch_side):
        """The same logical cache over permuted physical pages (page 0,
        the trash page, stays)."""
        order = np.concatenate([[0], perm])
        inv = np.argsort(order)
        if torch_side:
            layers = {k: v[:, torch.from_numpy(order)].contiguous()
                      for k, v in cache["layers"].items()}
            tables = torch.from_numpy(inv[cache["page_tables"].numpy()]
                                      .astype(np.int32))
        else:
            layers = {k: v[:, order] for k, v in cache["layers"].items()}
            tables = jnp.asarray(inv[np.asarray(cache["page_tables"])]
                                 .astype(np.int32))
        return dict(cache, layers=layers, page_tables=tables)

    jc = j_builder_init_cache(jscan.cfg, b)
    jc = shuffled(prefill(jscan, jc, False), False)
    pos = np.asarray(jc["lengths"])[:, None] + np.arange(window)
    want, _ = jmulti.apply({"params": stacked}, jnp.asarray(nxt),
                           positions=jnp.asarray(pos), kv_cache=jc)
    with torch.no_grad():
        tc = init_kv_cache(cfg, b, max_len=32, layout="paged", page_size=8,
                           dtype=torch.float32, device="cpu")
        tc = shuffled(prefill(tscan, tc, True), True)
        got, _ = multi(torch.from_numpy(nxt).long(),
                       positions=torch.from_numpy(pos.copy()), kv_cache=tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
        # teacher-forced one-token steps over a fresh copy of the cache
        tc = shuffled(prefill(tscan, init_kv_cache(
            cfg, b, max_len=32, layout="paged", page_size=8,
            dtype=torch.float32, device="cpu"), True), True)
        steps = []
        for t in range(window):
            logits, tc = tscan(torch.from_numpy(nxt[:, t:t + 1]).long(),
                               positions=tc["lengths"][:, None].long(),
                               kv_cache=tc)
            steps.append(logits[:, 0])
    np.testing.assert_allclose(got.numpy(), torch.stack(steps, 1).numpy(),
                               atol=1e-5)


def j_builder_init_cache(cfg, b):
    from merlin_tpu.models.decoder import init_kv_cache as j_init

    return j_init(cfg, b, max_len=32, layout="paged", page_size=8,
                  dtype=jnp.float32)


def test_int8_quantizer_over_stacked_state(rope):
    """The stacked quantizer gives JAX's stacked tree leaf for leaf (one
    scale per layer and channel), equals the loop quantizer's layers
    stacked, and the scanned int8 model's logits equal the loop int8
    model's."""
    _, stacked, tscan, tloop = rope
    want = params_from_flax(j_quantize(jax.tree.map(np.asarray, stacked)))
    got = quantize_decoder_params_int8(tscan.state_dict())
    assert sorted(got) == sorted(want)
    for name, t in got.items():
        assert t.dtype == want[name].dtype, name
        np.testing.assert_array_equal(t.numpy(), want[name].numpy(),
                                      err_msg=name)
    sc = got["layers.block.attn.q_proj.kernel_scale"]
    assert sc.shape[0] == tscan.cfg.num_layers and not torch.equal(sc[0],
                                                                   sc[1])
    loop_q = quantize_decoder_params_int8(tloop.state_dict())
    restacked = stack_layer_params(dict(loop_q), tscan.cfg.num_layers)
    for name, t in got.items():
        assert torch.equal(t, restacked[name]), name
    qscan = CausalLM(dataclasses.replace(tscan.cfg, weight_dtype="int8"))
    qscan.load_state_dict(got, strict=True)
    qloop = CausalLM(dataclasses.replace(tloop.cfg, weight_dtype="int8"))
    qloop.load_state_dict(loop_q, strict=True)
    ids = torch.from_numpy(np.random.default_rng(3).integers(3, 90, (2, 9)))
    with torch.no_grad():
        np.testing.assert_array_equal(qscan(ids)[0].numpy(),
                                      qloop(ids)[0].numpy())


def test_composite_checkpoint_into_stacked_layout(tmp_path):
    """``--scan_layers``: a composite checkpoint converts into the stacked
    ``lm.layers.block.*`` layout at load, equal leaf for leaf to JAX's
    scanned load, with logits equal to the port's loop load."""
    rng = np.random.default_rng(9)
    dargs = DataArguments(image_size=16)
    targs = TrainingArguments(gradient_checkpointing=False,
                              model_max_length=64)
    jb = j_builder.build_model_tokenizer(
        ModelArguments(projector="conv", scan_layers=True), dargs, targs,
        tiny=True)
    argv = ["--projector", "conv", "--image_size", "16",
            "--model_max_length", "64"]
    tb = t_builder.build_model_tokenizer(
        *parse_args(argv + ["--scan_layers", "True"]), tiny=True)
    tloop = t_builder.build_model_tokenizer(*parse_args(argv), tiny=True)
    assert tb.config.lm.scan_layers and not tloop.config.lm.scan_layers
    sd = {}
    sd.update(_llama_sd(jb.config.lm, rng))
    sd.update(_clip_tower_sd(jb.config.vit, rng))
    sd.update(_projector_sd("conv", jb.config, rng))
    ckpt = str(tmp_path / "composite")
    _write_sharded(ckpt, sd)

    jparams = params_from_flax(jax.device_get(
        j_builder.init_or_load_params(jb, composite_checkpoint=ckpt)))
    got = t_builder.init_or_load_params(tb, composite_checkpoint=ckpt,
                                        device="cpu")
    t_builder.init_or_load_params(tloop, composite_checkpoint=ckpt,
                                  device="cpu")
    qk = got["lm.layers.block.attn.q_proj.kernel"]
    assert qk.shape[0] == tb.config.lm.num_layers
    for name, t in got.items():
        assert torch.equal(t, jparams[name]), name
    ids = torch.from_numpy(rng.integers(1, 90, size=(1, 8)))
    with torch.no_grad():
        np.testing.assert_array_equal(tb.model(ids)[0].numpy(),
                                      tloop.model(ids)[0].numpy())


def test_scanned_random_init_draws_each_layer_alone():
    """A scanned bundle's random leaves are drawn per layer with a
    layer's fan-in, as ``nn.scan`` initializes them: each layer's slice
    has the loop layer's spread."""
    argv = ["--image_size", "16", "--model_max_length", "64"]
    tb = t_builder.build_model_tokenizer(
        *parse_args(argv + ["--scan_layers", "True"]), tiny=True)
    loop = t_builder.build_model_tokenizer(*parse_args(argv), tiny=True)
    got = t_builder.init_or_load_params(tb, device="cpu")
    want = t_builder.init_or_load_params(loop, device="cpu")
    k = got["lm.layers.block.mlp.down_proj.kernel"]
    ref = want["lm.layers_0.mlp.down_proj.kernel"]
    assert k.shape == (tb.config.lm.num_layers,) + tuple(ref.shape)
    assert not torch.equal(k[0], k[1])
    for layer in k:
        assert abs(float(layer.std()) / float(ref.std()) - 1) < 0.15
    assert torch.equal(got["lm.layers.block.input_norm.scale"],
                       torch.ones_like(got["lm.layers.block.input_norm."
                                           "scale"]))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_worker_main_scan_decode_answers_on_the_cpu():
    """``--scan-decode`` on the command line: the worker builds the stacked
    LM and its engine answers a request."""
    port = _free_port()
    env = dict(os.environ, HF_HUB_OFFLINE="1", TRANSFORMERS_OFFLINE="1",
               PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(
        [sys.executable, "-m", "merlin_tpu_torch.serve.worker", "--tiny",
         "--device", "cpu", "--host", "127.0.0.1", "--port", str(port),
         "--image_size", "16", "--scan-decode", "--engine",
         "--engine-cache-dtype", "f32"],
        cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE)
    try:
        addr = f"http://127.0.0.1:{port}"
        deadline = time.time() + 120
        while True:
            try:
                status = http_json("POST", addr + "/worker_get_status")
                break
            except OSError:
                assert proc.poll() is None, proc.stderr.read().decode()
                assert time.time() < deadline, "the worker did not start"
                time.sleep(0.5)
        assert status["model_names"] == ["merlin-tpu"]
        chunks = list(t_cli.stream_request(addr, {
            "prompt": "hello there", "temperature": 0.0,
            "max_new_tokens": 3}))
        assert chunks and all(c["error_code"] == 0 for c in chunks)
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        proc.stderr.close()


def test_worker_scan_decode_flag_sets_scan_layers():
    from merlin_tpu_torch.serve.worker import parse_worker_args

    args, margs, _, _ = parse_worker_args(["--scan-decode", "--tiny"])
    assert args.scan_decode and margs.scan_layers
    _, margs, _, _ = parse_worker_args(["--tiny"])
    assert not margs.scan_layers
