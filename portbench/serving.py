"""The system under test, as the serving cells drive it: the port's MMGPT
(CLIP ViT-L/14-448 -> conv projector -> the configuration's decoder) built
by the port's own entry points, with the benchmark's weights, behind the
port's ``ServingEngine``; and the client side of the traffic.

The model is built on the ``meta`` device from the configuration file (the
decoder's configuration from its family's ``build_lm``, see
``portbench/families``), its leaves made on the card from the seed
(``portbench.weights``: f32, or bf16 where the configuration says so) and
handed over with ``load_state_dict(assign=True)``. An int8 configuration is
then quantised by ``quantize_bundle_lm_int8``, as the worker's
``--int8-weights`` does.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Callable, Dict, List

import numpy as np
import torch

from portbench import weights
from portbench.record import Req

PAGE_DTYPES = {"bf16": torch.bfloat16, "int8": torch.int8,
               "f32": torch.float32}


def value_bytes(config: Dict) -> int:
    """Bytes one cached K or V value takes in the configuration's pages."""
    return PAGE_DTYPES[config["pages"]].itemsize


def build_model(family, config: Dict, seed: int, device):
    """The served MMGPT with the seed's weights (f32 leaves, or bf16 where
    the configuration says so; bf16 compute; the LM int8 where the
    configuration says so). ``family`` is the configuration's decoder
    family (``portbench/families``)."""
    from merlin_tpu_torch.models.builder import (
        ModelBundle, quantize_bundle_lm_int8)
    from merlin_tpu_torch.models.mmgpt import MMGPT, MMGPTConfig
    from merlin_tpu_torch.models.vision_builder import default_vision_config

    build = config["build"]
    widths = family.widths(config)
    lm = family.build_lm(config, widths, torch.bfloat16)
    vit = default_vision_config(build["vision_kind"], build["image_size"],
                                dtype=torch.bfloat16)
    v0 = config["vocab_size"]
    cfg = MMGPTConfig(lm=lm, vit=vit, projector=build["projector"],
                      conv_stride=build["conv_stride"],
                      vision_kind=build["vision_kind"],
                      select_layer=build["select_layer"],
                      image_patch_id=v0, im_start_id=v0 + 1, im_end_id=v0 + 2)
    with torch.device("meta"):
        model = MMGPT(cfg)
    groups = family.groups(widths)
    groups["tower"] = [
        (name, tuple(p.shape), weights.init_of(name, p.shape))
        for name, p in model.named_parameters()
        if name.startswith(("vision_tower.", "projector."))]
    dtype = weights.leaf_dtype(config)
    state = {}
    for group, leaves in groups.items():
        state.update(weights.make_group(seed, group, leaves, device, dtype))
    model.load_state_dict(state, strict=True, assign=True)
    del state
    if config["weights"] == "int8":
        bundle = ModelBundle(model=model, config=cfg, orig_vocab_size=v0,
                             params=model.state_dict())
        model = quantize_bundle_lm_int8(bundle).model
        del bundle
        gc.collect()
        torch.cuda.empty_cache() if torch.cuda.is_available() else None
    return model.eval()


def make_engine(model, config: Dict, engine: Dict, device):
    from merlin_tpu_torch.serve.engine import ServingEngine

    # eos -1: every request runs to its drawn length
    return ServingEngine(
        model, num_slots=engine["slots"], max_len=engine["max_len"],
        page_size=engine["page_size"], prompt_bucket=engine["prompt_bucket"],
        cache_dtype=PAGE_DTYPES[config["pages"]],
        chunk_steps=engine["chunk_steps"], pipeline=engine["pipeline"],
        eos_id=-1, pad_id=0, device=device)


def stratified(rng, n: int, block: int,
               quantile: Callable[[np.ndarray], np.ndarray]):
    """``n`` draws in blocks of ``block``: each block holds the same values,
    the distribution at its ``block`` mid-quantiles, in an order drawn from
    ``rng``. Every seed gets the same sizes in every stretch of ``block``
    requests, each seed in its own order."""
    values = quantile((np.arange(block) + 0.5) / block)
    blocks = -(-n // block)
    return np.concatenate([values[rng.permutation(block)]
                           for _ in range(blocks)])[:n]


def seed_rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32,
                                  stream])


def prompt_ids(rng, n: int, vocab: int) -> np.ndarray:
    """Token ids of a text prompt: ordinary vocabulary ids (no special or
    multimodal token)."""
    return rng.integers(10, vocab - 1000, size=n).astype(np.int32)


def submit(engine, req: Req, on_done: Callable[[Req], None] = None) -> Req:
    """Hand ``req`` to the engine as a client of the worker would; its
    tokens are timed as the client sees them."""
    def emit(token, done):
        now = time.perf_counter()
        if token < 0:
            req.error = "rejected by the engine"
        else:
            req.tokens.append(int(token))
            req.token_times.append(now)
            if req.first is None:
                req.first = now
            req.last = now
        if done:
            req.done = True
            if on_done is not None:
                on_done(req)

    req.submitted = time.perf_counter()
    engine.submit(req.ids, max_new_tokens=req.max_new, emit=emit)
    return req


def warm_up(engine, lengths: List[int], vocab: int) -> None:
    """One request per prompt bucket the traffic uses, a few tokens each:
    every prefill shape and the decode step run once before the window."""
    bucket = engine.prompt_bucket
    sizes = sorted({-(-n // bucket) * bucket for n in lengths})
    rng = np.random.default_rng(0)
    reqs = [submit(engine, Req(prompt_len=n, max_new=engine.pipeline + 2,
                               ids=prompt_ids(rng, n, vocab)))
            for n in sizes]
    engine.run_until_idle()
    if any(not r.done or r.error for r in reqs):
        raise RuntimeError("a warm-up request did not finish")


def open_window() -> None:
    """From here on, the device memory's peak is the window's: what the
    deployment holds while it serves (weights, pool, activations), not the
    set-up's transient peak (a model quantised by way of its f32 leaves)."""
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()


def close(engine) -> int:
    """Peak device memory since :func:`open_window`, then the engine and
    the model freed (the reference runs after, and a process's peak never
    falls again)."""
    peak = (torch.cuda.max_memory_allocated()
            if torch.cuda.is_available() else 0)
    engine.close()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return peak


def step_loop(engine, rec, tracer, until: Callable[[float], bool],
              idle_sleep: float = 0.0, opens_at: float = -math.inf) -> None:
    """``ServingEngine.step`` in the benchmark's thread, as the worker's
    ``_engine_loop`` runs it, each call timed and the pages in use read
    after it into ``rec``, until ``until(now)``. The window's memory peak
    starts at ``opens_at``."""
    reserved, opened = rec.pages_reserved, False
    while True:
        now = time.perf_counter()
        if until(now):
            return
        if not opened and now >= opens_at:
            open_window()
            opened = True
        tracer.tick(now)
        with tracer.span("portbench.step"):
            n = engine.step()
        end = time.perf_counter()
        rec.steps.append((now, end, n))
        rec.pages_used.append((end, reserved - engine.pool.free_pages))
        if n == 0 and idle_sleep:
            time.sleep(idle_sleep)


def quantile_fn(spec: Dict) -> Callable[[np.ndarray], np.ndarray]:
    """A traffic file's length distribution as its quantile function over
    whole numbers: ``uniform`` or ``loguniform`` on [low, high]."""
    low, high = spec["low"], spec["high"]
    if spec["dist"] == "uniform":
        return lambda q: (low + np.floor(q * (high - low + 1))).astype(int)
    if spec["dist"] == "loguniform":
        return lambda q: np.rint(np.exp(np.log(low) + q * (
            np.log(high) - np.log(low)))).astype(int)
    raise ValueError(f"unknown distribution {spec['dist']!r}")
