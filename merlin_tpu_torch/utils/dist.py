"""Multi-process coordination (counterpart of ``merlin_tpu/utils/dist.py``).

``jax.distributed.initialize`` becomes ``torch.distributed.
init_process_group`` from the torchrun environment (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``); the rank helpers read the
process group; the cross-rank dataset length agreement becomes an
all-reduce MIN. On a single process every helper degrades as JAX's do on
one host: rank 0 of 1, the MIN of one value, a barrier that returns.

:func:`run_ranks` spawns a group of CPU gloo ranks in fresh processes (a
file rendezvous, a timeout on the group and a deadline on the parent, so a
hang fails instead of waiting forever); :func:`dryrun_multichip` runs the
JAX package's ``__graft_entry__.dryrun_multichip`` cases on such a group.
"""

from __future__ import annotations

import datetime
import functools
import os
import tempfile
import traceback
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

GROUP_TIMEOUT = datetime.timedelta(seconds=60)   # spawned test groups only


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None) -> None:
    """Join the process group torchrun describes (or the one given by
    ``coordinator_address`` "host:port", ``num_processes``,
    ``process_id``). NCCL when a card is visible, else gloo; under NCCL
    the rank's card is ``LOCAL_RANK``. The collectives keep torch's
    timeout (a rank may wait minutes while rank 0 writes a checkpoint).
    Does nothing on a single process or when a group is already up."""
    world = num_processes if num_processes is not None \
        else int(os.environ.get("WORLD_SIZE", "1"))
    if _initialized() or (world <= 1 and not coordinator_address):
        return
    rank = process_id if process_id is not None \
        else int(os.environ.get("RANK", "0"))
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    init_method = (f"tcp://{coordinator_address}" if coordinator_address
                   else "env://")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank)


def get_rank() -> int:
    return dist.get_rank() if _initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if _initialized() else 1


def is_main_process() -> bool:
    return get_rank() == 0


def main_process_only(fn):
    """Decorator: run only on rank 0."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if is_main_process():
            return fn(*args, **kwargs)
        return None
    return wrapper


def _device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def host_allreduce_min(value: int) -> int:
    """Cross-rank MIN agreement (the dataset length every rank can serve)."""
    if get_world_size() == 1:
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64, device=_device())
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return int(t.item())


def barrier(name: str = "barrier") -> None:
    """Cross-rank sync point (``name`` labels it for a reader of a hang)."""
    del name
    if get_world_size() == 1:
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


# ---------------------------------------------------------------------------
# CPU gloo groups in fresh processes
# ---------------------------------------------------------------------------

def _rank_main(fn, rank, world, rdzv, args, queue):
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{rdzv}",
                                rank=rank, world_size=world,
                                timeout=GROUP_TIMEOUT)
        try:
            queue.put((rank, True, fn(rank, world, *args)))
        finally:
            dist.destroy_process_group()
    except Exception:  # noqa: BLE001 - reported to the parent
        queue.put((rank, False, traceback.format_exc()))


def run_ranks(fn: Callable, world: int, *args, timeout: float = 240.0,
              tmpdir: Optional[str] = None) -> List[Any]:
    """Run ``fn(rank, world, *args)`` on ``world`` gloo ranks, each a fresh
    process (``spawn``: ``fn`` must be importable, at a module's top
    level) with one intra-op thread; returns the ranks' results in rank
    order. A rank's exception is raised here with its traceback; past
    ``timeout`` seconds the group is killed and TimeoutError raised."""
    import multiprocessing as mp
    import queue as queue_mod
    import time

    ctx = mp.get_context("spawn")
    own_dir = tmpdir is None
    tmpdir = tmpdir or tempfile.mkdtemp(prefix="merlin_ranks_")
    rdzv = os.path.join(tmpdir, f"rdzv_{os.getpid()}_{time.time_ns()}")
    q = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, rdzv, args, q), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, []
    deadline = time.monotonic() + timeout
    try:
        while len(results) + len(errors) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"{world} ranks of {getattr(fn, '__name__', fn)} did not "
                    f"finish within {timeout} s (done: {sorted(results)})")
            try:
                rank, ok, val = q.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead and q.empty():
                    raise RuntimeError(
                        f"rank process died with exit code "
                        f"{dead[0].exitcode}") from None
                continue
            if ok:
                results[rank] = val
            else:
                errors.append(f"rank {rank}:\n{val}")
                break
        if errors:
            raise RuntimeError("\n".join(errors))
        return [results[r] for r in range(world)]
    finally:
        for p in procs:
            p.join(timeout=5 if not errors else 0.1)
            if p.is_alive():
                p.kill()
                p.join()
        if own_dir:
            import shutil
            shutil.rmtree(tmpdir, ignore_errors=True)


# ---------------------------------------------------------------------------
# The cases of the JAX package's dryrun_multichip, per rank
# ---------------------------------------------------------------------------

def factor_mesh(n: int):
    """n ranks -> (data, fsdp, seq, tensor): tp 2 when n is even, fsdp 2
    when 4 divides n, data the rest (JAX's dryrun factorization)."""
    tp = 2 if n % 2 == 0 else 1
    fsdp = 2 if n % 4 == 0 else 1
    return (n // (tp * fsdp), fsdp, 1, tp)


def train_case(rank: int, world: int, spec: dict) -> dict:
    """One mesh training run: ``spec`` holds the MMGPT config ``cfg`` and
    its ``state``, ``model_kw``/``train_kw`` (the flag groups),
    ``orig_vocab``, the host ``batches`` (node rows), the mesh ``shape``
    (None: built from the ``mesh_*`` flags by ``mesh_from_args``), optionally an
    ``output_dir`` to save the final checkpoint to, a
    ``resume_from_checkpoint`` to start from, and ``plant="per_rank_mean"``
    (the loss averaged per rank, the fault the global loss repairs). Returns the steps' metrics and, from rank 0, the
    full parameters and the placement problems found."""
    del world
    from merlin_tpu_torch.core.mesh import dp_size
    from merlin_tpu_torch.train import step as step_mod

    honest = step_mod.all_reduce_dp
    if spec.get("plant") == "per_rank_mean":
        def per_rank(t, mesh, op=dist.ReduceOp.SUM):
            if t.is_floating_point():
                return honest(t, mesh, op)
            return t * dp_size(mesh)     # each rank divides by its own count
        step_mod.all_reduce_dp = per_rank
    try:
        return _train_case(rank, spec)
    finally:
        step_mod.all_reduce_dp = honest


def _train_case(rank: int, spec: dict) -> dict:
    from merlin_tpu_torch.core import parallel
    from merlin_tpu_torch.core.mesh import MeshConfig, create_mesh
    from merlin_tpu_torch.models.builder import make_bundle
    from merlin_tpu_torch.models.mmgpt import MMGPT
    from merlin_tpu_torch.train import arguments as targs
    from merlin_tpu_torch.train.trainer import Trainer, mesh_from_args

    model = MMGPT(spec["cfg"])
    model.load_state_dict(spec["state"])
    bundle = make_bundle(model, targs.ModelArguments(**spec.get("model_kw", {})),
                         spec["orig_vocab"])
    train_kw = dict(spec["train_kw"])
    for key in ("output_dir", "resume_from_checkpoint"):
        if spec.get(key):
            train_kw[key] = spec[key]
    args = targs.TrainingArguments(**train_kw)
    # with no shape the mesh is built from the mesh_* flags
    mesh = create_mesh(MeshConfig(*spec["shape"])) if spec.get("shape") \
        else mesh_from_args(args, "cpu")
    trainer = Trainer(bundle, args, mesh=mesh, device="cpu")
    trainer.init_state()
    start = trainer.maybe_resume() if spec.get("resume_from_checkpoint") \
        else 0
    seen = []
    trainer.train(iter([dict(b) for b in spec["batches"]]),
                  num_steps=start + len(spec["batches"]),
                  log_fn=lambda s, m: seen.append(m))
    if spec.get("output_dir"):
        trainer.save_final()
    full = {n: trainer.parallel.full_tensor(n, p).detach().numpy()
            for n, p in model.named_parameters()}
    bad = parallel.check_placements(model, trainer.parallel)
    trainer.close()
    return {"metrics": seen, "params": full if rank == 0 else None,
            "placement_problems": bad, "tp_dims": trainer.parallel.tp_dims,
            "mesh_shape": tuple(trainer.mesh.shape), "step": trainer.step}


def serve_case(rank: int, world: int, spec: dict) -> dict:
    """Tensor-parallel serving on a (1, 1, 1, world) mesh: ``spec`` holds a
    decoder config ``lm_cfg`` and its ``state``, the ``prompts`` and their
    ``max_new_tokens``, and ``runs``: name -> ServingEngine keywords (the
    cache dtype as a string), where a run may bring its own ``lm_cfg`` and
    ``state``, ``plant="c11"`` (the int8 scales laid head == lane, trap
    C11) or ``expect_error`` (the engine must refuse it: its message is
    returned). Returns per run the tokens, the free pages before and after,
    the local lane widths of the pool and whether the global mesh was set
    while it ran and restored by ``close()``."""
    del rank
    from merlin_tpu_torch.core.mesh import (
        MeshConfig, create_mesh, get_global_mesh)
    from merlin_tpu_torch.models.decoder import CausalLM
    from merlin_tpu_torch.ops import paged_attention
    from merlin_tpu_torch.serve.engine import ServingEngine

    def head_is_lane(sc, lanes):
        out = sc.new_zeros(sc.shape[:-1] + (lanes,))
        out[..., :sc.shape[-1]] = sc
        return out

    honest = paged_attention._scale_row
    mesh = create_mesh(MeshConfig(1, 1, 1, world))
    out = {}
    for name, run in spec["runs"].items():
        run = dict(run)
        model = CausalLM(run.pop("lm_cfg", spec["lm_cfg"]))
        model.load_state_dict(run.pop("state", spec["state"]))
        model.requires_grad_(False)
        expect_error = run.pop("expect_error", False)
        prompts = run.pop("prompts", spec["prompts"])
        max_new = run.pop("max_new_tokens", spec["max_new_tokens"])
        plant = run.pop("plant", None)
        run["cache_dtype"] = getattr(torch, run.get("cache_dtype", "float32"))
        try:
            engine = ServingEngine(model, mesh=mesh, device="cpu", **run)
        except ValueError as err:
            if not expect_error:
                raise
            out[name] = {"error": str(err),
                         "global_mesh_after_close": get_global_mesh() is None}
            continue
        try:
            if plant == "c11":
                paged_attention._scale_row = head_is_lane
            free0 = engine.pool.free_pages
            layer = engine.cache["layers"]
            layer = layer if isinstance(layer, dict) else layer[0]
            reqs = [engine.submit(p, max_new_tokens=max_new)
                    for p in prompts]
            engine.run_until_idle()
            out[name] = {
                "tokens": [r.generated for r in reqs],
                "free_pages": (free0, engine.pool.free_pages),
                "lanes": {k: tuple(v.shape[-1:]) for k, v in layer.items()},
                "global_mesh_set": get_global_mesh() is mesh,
            }
        finally:
            engine.close()
            paged_attention._scale_row = honest
        out[name]["global_mesh_after_close"] = get_global_mesh() is None
    return out


def dryrun_multichip(n_devices: int, cases: Optional[Sequence[str]] = None,
                     timeout: float = 240.0) -> dict:
    """The JAX package's ``dryrun_multichip`` on ``n_devices`` CPU gloo
    ranks, with the port's tiny bundle (random parameters from a seed):

      * ``"train"``: one training step (accum 2, remat, LLRD) on the
        (dp, fsdp, 1, tp) mesh of :func:`factor_mesh`;
      * ``"seq"``: the same step on the (2, 1, 2, 2) mesh, attention
        through the ring (n divisible by 8);
      * ``"serve"``: tp2 serving on two ranks, f32 and int8 pools, and a
        spec + chunked engine that must equal the plain tp2 engine token
        for token.

    Returns case -> what rank 0 reported; raises if a check fails."""
    from merlin_tpu_torch.models.builder import (
        build_model_tokenizer, init_or_load_params)
    from merlin_tpu_torch.train import arguments as targs

    cases = list(cases or ("train", "seq", "serve"))
    train_kw = dict(gradient_checkpointing=True, model_max_length=32,
                    num_train_steps=2, learning_rate=1e-3, warmup_ratio=0.0,
                    llrd=True, llm_llrd=True, gradient_accumulation_steps=2,
                    bf16=False, logging_steps=1, save_steps=0)
    bundle = build_model_tokenizer(
        targs.ModelArguments(), targs.DataArguments(image_size=16),
        targs.TrainingArguments(**train_kw), tiny=True)
    gen = torch.Generator().manual_seed(0)
    init_or_load_params(bundle, generator=gen, device="cpu")
    cfg = bundle.config
    state = {k: v.detach().clone() for k, v in bundle.model.state_dict().items()}
    shape = factor_mesh(n_devices)
    b, s = 2 * shape[0] * shape[1], 24
    rng = np.random.default_rng(0)
    ids = rng.integers(4, 90, size=(b, s)).astype(np.int32)
    tok = cfg.image_token_len
    ids[:, 1] = cfg.im_start_id
    ids[:, 2:2 + tok] = cfg.image_patch_id
    ids[:, 2 + tok] = cfg.im_end_id
    batch = dict(input_ids=ids, labels=ids.copy(),
                 segment_ids=np.ones((b, s), np.int32),
                 attention_mask=np.ones((b, s), np.int32),
                 images=rng.integers(0, 255, size=(b, 1, 16, 16, 3))
                 .astype(np.uint8))
    spec = dict(cfg=cfg, state=state, orig_vocab=bundle.orig_vocab_size,
                train_kw=train_kw, batches=[batch])
    out = {}
    if "train" in cases:
        res = run_ranks(train_case, n_devices, dict(spec, shape=shape),
                        timeout=timeout)[0]
        loss = res["metrics"][0]["loss"]
        assert np.isfinite(loss), loss
        print(f"dryrun_multichip({n_devices}): mesh={shape} loss={loss:.4f}")
        out["train"] = res
    if "seq" in cases and n_devices % 8 == 0:
        res = run_ranks(train_case, 8, dict(spec, shape=(2, 1, 2, 2)),
                        timeout=timeout)[0]
        loss = res["metrics"][0]["loss"]
        assert np.isfinite(loss), loss
        print(f"dryrun_multichip({n_devices}): seq mesh=(2, 1, 2, 2) "
              f"loss={loss:.4f}")
        out["seq"] = res
    if "serve" in cases and n_devices % 2 == 0:
        lm_state = {k[3:]: v for k, v in state.items() if k.startswith("lm.")}
        base = dict(num_slots=2, max_len=64, eos_id=-1, pad_id=0,
                    prompt_bucket=8, page_size=8)
        runs = {"f32": dict(base, max_len=32),
                "int8": dict(base, max_len=32, cache_dtype="int8"),
                "plain": dict(base, chunk_steps=2),
                "spec_chunked": dict(base, chunk_steps=2, spec_draft=2,
                                     prefill_chunk=8)}
        res = run_ranks(serve_case, 2, dict(
            lm_cfg=cfg.lm, state=lm_state, runs=runs, max_new_tokens=6,
            prompts=[[5, 9, 11, 5, 9]]), timeout=timeout)[0]
        for name, r in res.items():
            assert all(len(t) == 6 for t in r["tokens"]), (name, r)
        assert res["spec_chunked"]["tokens"] == res["plain"]["tokens"], (
            "tp2 spec/plain divergence", res)
        print(f"dryrun_multichip({n_devices}): tp2 serving "
              f"tokens={res['f32']['tokens']} int8={res['int8']['tokens']} "
              f"spec+chunked={res['spec_chunked']['tokens']}")
        out["serve"] = res
    return out
