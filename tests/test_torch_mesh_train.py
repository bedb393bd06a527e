"""Training on a mesh: the port's ``Trainer`` on an 8-rank CPU gloo group
(dp2 x fsdp2 x tp2: FSDP2 HSDP over (data, fsdp), the decoder and the ViT
blocks cut over ``tensor``) against JAX's ``make_train_step(mesh=)`` on
the 8 virtual devices, on the ``tiny=True`` bundle's parameters and the
same global batches (2 steps at accumulation 2; the first step's lr is 0).

  * the dp x fsdp x tp step: loss, ``grad_norm`` and ``update_norm`` to
    1e-5 relative, every parameter within 1e-4 of its leaf's largest
    element (a key bias, whose exact gradient is zero and which Adam moves
    by ~lr on rounding noise alone, within 3 times the summed lr, as in
    ``test_torch_trainer.py``);
  * frozen parameters do not move (the LM frozen but its new rows);
  * the global loss and the global clip, in one run: (data, fsdp) ranks
    with different label counts give JAX's one mean over the global batch
    (averaging per-rank means, planted, does not), and a max norm below
    the gradient's clips by the norm of the whole tree;
  * the Trainer built from the ``mesh_*`` flags;
  * checkpoints: a mesh run's checkpoint resumed on one process, and a
    one-process checkpoint resumed on the mesh; a save gathers one full
    tensor at a time and keeps none of them (the frozen run's checkpoint,
    fingerprints gathered from the mesh, restores on one process);
  * the repaired data split, on a 4-rank tp2 group: before the repair the
    two ranks of a tensor group read different samples, after it the same;
  * the training entry point in a 2-rank group with ``--mesh_tensor 2``
    (as under ``torchrun --nproc_per_node 2``): both ranks train on the
    node's batch of per_device x accum x 2 rows, equal array for array to
    JAX's ``build_dataloader`` + ``batch_iterator`` at that size (JAX's
    host batch on 2 devices), and rank 0 writes the checkpoint.

All mesh runs share one spawn (the rank function imports torch and the
port only); every group has its own timeout.
"""

import numpy as np
import pytest
import torch

from merlin_tpu_torch.utils.dist import run_ranks, train_case

SHAPE = (2, 2, 1, 2)
STEPS, ACCUM, ROWS = 2, 2, 8       # 8 rows a step: 1 a rank a microbatch
LEAF_TOL = 1e-4
METRIC_TOL = 1e-5
KW = dict(gradient_checkpointing=True, model_max_length=24, max_steps=4,
          learning_rate=1e-2, warmup_ratio=0.25,
          gradient_accumulation_steps=ACCUM, per_device_train_batch_size=1,
          logging_steps=1, save_steps=0, llrd=True, llm_llrd=True,
          weight_decay=0.05, max_grad_norm=1.0)
FROZEN = dict(freeze_lm_model=True, tune_im_start_end=True)


def mesh_train_rank(rank, world, specs):
    """Every spec's run; ``saves`` records each checkpoint save's full
    tensors (``ParallelInfo.full_tensor``'s results): how many it
    gathered, the most of the earlier ones alive at a gather, and how many
    were alive when it returned."""
    import weakref

    from merlin_tpu_torch.core.parallel import ParallelInfo
    from merlin_tpu_torch.train import trainer as trainer_mod

    real_full, real_save = ParallelInfo.full_tensor, trainer_mod.save_checkpoint
    saves = []

    def watched_save(*args, **kw):
        refs, seen = [], {"gathered": 0, "most_alive": 0}

        def watched_full(self, *a, **k):
            alive = sum(r() is not None for r in refs)
            seen["most_alive"] = max(seen["most_alive"], alive)
            out = real_full(self, *a, **k)
            refs.append(weakref.ref(out))
            seen["gathered"] += 1
            return out

        ParallelInfo.full_tensor = watched_full
        try:
            return real_save(*args, **kw)
        finally:
            ParallelInfo.full_tensor = real_full
            seen["alive_after"] = sum(r() is not None for r in refs)
            saves.append(seen)

    trainer_mod.save_checkpoint = watched_save
    try:
        out = {name: train_case(rank, world, spec)
               for name, spec in specs.items()}
    finally:
        trainer_mod.save_checkpoint = real_save
    out["saves"] = saves
    return out


def split_rank(rank, world):
    """The data split on a (2, 1, 1, 2) mesh: what each rank trains on,
    by the stream of (rank, world) (the old split) and by the node's
    stream cut to its (data, fsdp) rows (the repair)."""
    from merlin_tpu_torch.core.mesh import MeshConfig, create_mesh
    from merlin_tpu_torch.data.shards import (
        local_world_size, process_index_count, split_by_host)
    from merlin_tpu_torch.train.step import local_rows, row_shards

    mesh = create_mesh(MeshConfig(data=2, fsdp=1, seq=1, tensor=2))
    shards = list(range(32))
    per_rank = 2                    # per_device x accum rows a rank

    old = list(split_by_host(iter(shards), process_index=rank,
                             process_count=world))[:per_rank]
    index, count = process_index_count()
    node = list(split_by_host(iter(shards), process_index=index,
                              process_count=count))
    node_rows = per_rank * local_world_size()
    batch = {"x": torch.tensor(node[:node_rows])[None]}   # (accum 1, rows)
    new = local_rows(batch, *row_shards(mesh))["x"][0].tolist()
    return {"old": old, "new": new, "node": (index, count),
            "local_world": local_world_size(),
            "coord": tuple(mesh.get_coordinate())}


def entry_rank(rank, world, argv, specs, prime):
    """``engine.train.train(argv)`` as torchrun runs it on one node of
    ``world`` ranks (the group is up; the datasets registered here, since a
    spawned rank starts from a fresh import); returns its metrics, the
    batches its Trainer received and the checkpoint directory's files."""
    import os

    from merlin_tpu_torch.data import registry
    from merlin_tpu_torch.engine import train as engine

    os.environ["LOCAL_WORLD_SIZE"] = str(world)
    os.environ["MERLIN_NATIVE_LOADER"] = "0"
    for family, name, kind, kw in specs:
        registry.register(family, name, getattr(registry, kind)(**kw))
    seen = []
    real_iter, real_build = engine.batch_iterator, engine.build_model_tokenizer

    def recording(*a, **kw):
        for batch in real_iter(*a, **kw):
            seen.append(batch)
            yield batch

    def primed(*a, **kw):
        bundle = real_build(*a, **kw)
        bundle.tokenizer.encode(prime)
        return bundle

    engine.batch_iterator, engine.build_model_tokenizer = recording, primed
    metrics = engine.train(argv, tiny=True, device="cpu")
    out = argv[argv.index("--output_dir") + 1]
    return {"metrics": metrics, "batches": seen[:3],
            "files": sorted(os.listdir(os.path.join(out, "checkpoint-3")))}


# ---------------------------------------------------------------------------
# JAX's side and the shared setup (JAX is imported here, not at the top)
# ---------------------------------------------------------------------------

def _uneven(batches):
    """Rows with different label counts: row i keeps 2 + 3 * i labels."""
    out = []
    for b in batches:
        b = {k: v.copy() for k, v in b.items()}
        for i in range(b["labels"].shape[0]):
            keep = 2 + 3 * (i % 4)
            valid = np.flatnonzero(b["labels"][i] != -100)
            b["labels"][i, valid[keep:]] = -100
        out.append(b)
    return out


def _jax_run(jbundle, batches, mesh, **kw):
    import jax
    from merlin_tpu.train import arguments as jargs
    from merlin_tpu.train.optimizer import build_optimizer
    from merlin_tpu.train.step import TrainState, make_train_step
    from merlin_tpu.train.step import stack_microbatches

    targs = jargs.TrainingArguments(**{**KW, **kw})
    tx, _ = build_optimizer(
        targs, n_vit_layers=jbundle.config.vit.num_layers,
        n_llm_layers=jbundle.config.lm.num_layers,
        trainable_fn=jbundle.trainable_mask,
        embed_row_mask=jbundle.embed_row_trainable)
    step_fn = make_train_step(jbundle.model, tx, mesh=mesh, donate=False,
                              trainable_fn=jbundle.trainable_mask)
    with mesh:
        state = TrainState.create(jbundle.params, tx)
        metrics = []
        for b in batches:
            state, m = step_fn(state, stack_microbatches(b, ACCUM))
            metrics.append({k: float(v) for k, v in m.items()})
    import optax
    from merlin_tpu_torch.models.bridge import params_from_flax

    def flat(tree):
        return {k: v.numpy() for k, v in params_from_flax(
            jax.tree.map(np.asarray, tree)).items()}
    nu = flat(optax.tree_utils.tree_get(state.opt_state, "nu"))
    return metrics, flat(state.params), nu


@pytest.fixture(scope="module")
def world(tmp_path_factory, eight_devices):
    import jax
    from merlin_tpu.core.mesh import MeshConfig as JMeshConfig
    from merlin_tpu.core.mesh import create_mesh as j_create_mesh

    from merlin_tpu_torch.models.builder import make_bundle
    from merlin_tpu_torch.train import arguments as targs
    from merlin_tpu_torch.train.trainer import Trainer
    from test_torch_trainer import _batches, _jax_bundle, _port_model

    tmp = tmp_path_factory.mktemp("mesh_train")
    jmesh = j_create_mesh(JMeshConfig(data=2, fsdp=2, tensor=2),
                          devices=eight_devices)
    jb = _jax_bundle({})
    jb_frozen = _jax_bundle(FROZEN)
    model = _port_model(jb)
    cfg = model.cfg
    state = {k: v.clone() for k, v in model.state_dict().items()}
    frozen_state = {k: v.clone()
                    for k, v in _port_model(jb_frozen).state_dict().items()}
    even = _batches(jb.config, STEPS, rows=ROWS)
    uneven = _uneven(_batches(jb.config, STEPS, seed=5, rows=ROWS))
    clip = {**KW, "max_grad_norm": 0.05}

    # a one-process run's checkpoint after step 1, to resume on the mesh
    single = make_bundle(_port_model(jb), targs.ModelArguments(),
                         jb.orig_vocab_size)
    trainer = Trainer(single, targs.TrainingArguments(
        **{**KW, "output_dir": str(tmp / "single")}), device="cpu")
    trainer.init_state()
    trainer.train(iter([dict(even[0])]), num_steps=1)
    one_proc_ckpt = trainer.save_final()

    base = dict(cfg=cfg, state=state, orig_vocab=jb.orig_vocab_size,
                train_kw=KW, batches=even, shape=SHAPE)
    specs = {
        "step": dict(base, output_dir=str(tmp / "mesh")),
        "frozen": dict(base, state=frozen_state, model_kw=FROZEN,
                       output_dir=str(tmp / "mesh_frozen")),
        "uneven_clip": dict(base, batches=uneven, train_kw=clip),
        "uneven_clip_planted": dict(base, batches=uneven, train_kw=clip,
                                    plant="per_rank_mean"),
        "flags": dict(base, shape=None, train_kw={
            **KW, "mesh_data": 2, "mesh_fsdp": 2, "mesh_tensor": 2}),
        "resume_on_mesh": dict(base, batches=even[1:],
                               resume_from_checkpoint=one_proc_ckpt),
    }
    ranks = run_ranks(mesh_train_rank, 8, specs, timeout=300)
    port = ranks[0]
    port["saves_by_rank"] = [r["saves"] for r in ranks]
    jax_ref = {
        "step": _jax_run(jb, even, jmesh),
        "frozen": _jax_run(jb_frozen, even, jmesh),
        "uneven_clip": _jax_run(jb, uneven, jmesh, max_grad_norm=0.05),
    }
    jax.clear_caches()
    return dict(port=port, jax=jax_ref, jb=jb, jb_frozen=jb_frozen,
                state=state, tmp=tmp, even=even)


def _lrs():
    from merlin_tpu_torch.train import arguments as targs
    from merlin_tpu_torch.train.optimizer import make_lr_schedule

    sched = make_lr_schedule(targs.TrainingArguments(**KW))
    return sum(sched(i) for i in range(STEPS))


def _close(got, want, *, lrs, msg=""):
    """Metrics to 1e-5 relative; each parameter element within 1e-4 of its
    leaf's largest, but where JAX's gradient RMS (the root of Adam's second
    moment) is below 1e-6: near Adam's eps (1e-8) the step follows the
    gradient's absolute size, which the ranks' partial sums round
    differently, so such an element, and a key bias (exact gradient 0),
    is held to 3 times the summed lr, Adam's bound on its moves."""
    gm, gp = got
    wm, wp, nu = want
    assert len(gm) == len(wm) == STEPS
    for i, (g, w) in enumerate(zip(gm, wm)):
        for key in ("loss", "grad_norm", "update_norm"):
            np.testing.assert_allclose(g[key], w[key], rtol=METRIC_TOL,
                                       atol=1e-12,
                                       err_msg=f"{msg} {key} step {i}")
    for name, w in wp.items():
        diff = np.abs(gp[name] - w)
        tiny = (np.sqrt(nu[name]) < 1e-6) if name in nu \
            else np.zeros(w.shape, bool)
        if name.endswith("k_proj.bias"):
            tiny[...] = True
        assert diff[~tiny].max(initial=0) <= \
            LEAF_TOL * float(np.abs(w).max()), (msg, name)
        assert diff[tiny].max(initial=0) <= 3 * lrs, (msg, name)


def test_dp_fsdp_tp_step_matches_jax(world):
    r = world["port"]["step"]
    _close((r["metrics"], r["params"]), world["jax"]["step"], lrs=_lrs())
    assert r["placement_problems"] == []
    assert r["metrics"][0]["update_norm"] == 0.0       # lr 0 at count 0
    # the decoder and the ViT blocks are cut over tensor, by the rules
    dims = r["tp_dims"]
    assert dims["lm.layers_0.attn.q_proj.kernel"] == 1
    assert dims["lm.layers_0.attn.o_proj.kernel"] == 0
    assert dims["lm.layers_0.mlp.down_proj.kernel"] == 0
    assert dims["lm.embed_tokens.embedding"] == 0
    assert dims["lm.lm_head.kernel"] == 1
    assert dims["vision_tower.vit.layers_0.q_proj.kernel"] == 1
    assert "projector.conv.kernel" not in dims


def test_frozen_params_do_not_move(world):
    r = world["port"]["frozen"]
    _close((r["metrics"], r["params"]), world["jax"]["frozen"], lrs=_lrs())
    jb = world["jb_frozen"]
    from merlin_tpu_torch.models.bridge import params_from_flax
    import jax

    before = params_from_flax(jax.tree.map(np.asarray, jb.params))
    moved = [n for n, t in before.items()
             if n.startswith("lm.") and n != "lm.embed_tokens.embedding"
             and not np.array_equal(r["params"][n], t.numpy())]
    assert moved == []
    emb, was = r["params"]["lm.embed_tokens.embedding"], \
        before["lm.embed_tokens.embedding"].numpy()
    rows = jb.embed_row_trainable.astype(bool)
    assert np.array_equal(emb[~rows], was[~rows])
    assert (emb[rows] != was[rows]).any()


def test_global_loss_with_uneven_label_counts(world):
    """The ranks hold 2, 5, 8 and 11 labels a microbatch: the port's loss
    is JAX's global mean; averaging per-rank means (planted) is not."""
    r = world["port"]["uneven_clip"]
    _close((r["metrics"], r["params"]), world["jax"]["uneven_clip"],
           lrs=_lrs())
    planted = world["port"]["uneven_clip_planted"]
    want = world["jax"]["uneven_clip"]
    assert abs(planted["metrics"][0]["loss"] - want[0][0]["loss"]) \
        > 1e-3 * want[0][0]["loss"]
    assert not all(np.allclose(planted["params"][n], w, rtol=1e-4,
                               atol=1e-6) for n, w in want[1].items())


def test_clip_active(world):
    """The clip binds (max norm 0.05): the update follows the norm of the
    whole tree, summed over the shards, as JAX's optax.global_norm."""
    r = world["port"]["uneven_clip"]
    assert all(m["grad_norm"] > 0.05 for m in r["metrics"])
    _close((r["metrics"], r["params"]), world["jax"]["uneven_clip"],
           lrs=_lrs())


def test_trainer_builds_mesh_from_flags(world):
    r, ref = world["port"]["flags"], world["port"]["step"]
    assert r["mesh_shape"] == SHAPE
    assert r["placement_problems"] == []
    for g, w in zip(r["metrics"], ref["metrics"]):
        assert g["loss"] == w["loss"]
    for n, t in ref["params"].items():
        np.testing.assert_array_equal(r["params"][n], t, err_msg=n)


def test_mesh_checkpoint_resumes_on_one_process_and_back(world):
    """The mesh run's final checkpoint (written whole by rank 0) loads
    into a one-process Trainer bit for bit; a one-process checkpoint of
    step 1 resumed on the mesh lands on the mesh run's step 2."""
    from merlin_tpu_torch.models.builder import make_bundle
    from merlin_tpu_torch.train import arguments as targs
    from merlin_tpu_torch.train.checkpoint import latest_checkpoint
    from merlin_tpu_torch.train.trainer import Trainer
    from test_torch_trainer import _port_model

    r = world["port"]["step"]
    path = latest_checkpoint(str(world["tmp"] / "mesh"))
    assert path.endswith(f"checkpoint-{STEPS}")
    bundle = make_bundle(_port_model(world["jb"]), targs.ModelArguments(),
                         world["jb"].orig_vocab_size)
    trainer = Trainer(bundle, targs.TrainingArguments(
        **{**KW, "resume_from_checkpoint": path}), device="cpu")
    trainer.init_state()
    assert trainer.maybe_resume() == STEPS
    for n, p in bundle.model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), r["params"][n],
                                      err_msg=n)
    assert trainer.optimizer.count == STEPS
    # and on: a third step runs from the restored moments
    trainer.train(iter([dict(world["even"][0])]), num_steps=STEPS + 1)
    assert trainer.step == STEPS + 1

    back = world["port"]["resume_on_mesh"]
    assert back["step"] == STEPS and len(back["metrics"]) == 1
    np.testing.assert_allclose(back["metrics"][0]["loss"],
                               r["metrics"][1]["loss"], rtol=METRIC_TOL)
    _close(([r["metrics"][0]] + back["metrics"], back["params"]),
           (r["metrics"], r["params"], {}), lrs=_lrs())


def test_mesh_save_holds_one_full_tensor_at_a_time(world):
    """On every rank, each save (the step run's and the frozen run's)
    gathers the full tensors one at a time and keeps none: rank 0 copies
    each to the host at once (on a card, the full parameters and moments
    would not fit beside the sharded state). The frozen run's
    fingerprints, gathered from the mesh, match the one-process model's:
    its checkpoint restores on one process."""
    from merlin_tpu_torch.models.builder import make_bundle
    from merlin_tpu_torch.train import arguments as targs
    from merlin_tpu_torch.train.checkpoint import latest_checkpoint
    from merlin_tpu_torch.train.trainer import Trainer
    from test_torch_trainer import _port_model

    by_rank = world["port"]["saves_by_rank"]
    assert len(by_rank) == 8
    for saves in by_rank:
        assert len(saves) == 2
        for seen in saves:
            assert seen["gathered"] > 0
            assert seen["most_alive"] == 0 and seen["alive_after"] == 0

    r = world["port"]["frozen"]
    path = latest_checkpoint(str(world["tmp"] / "mesh_frozen"))
    bundle = make_bundle(_port_model(world["jb_frozen"]),
                         targs.ModelArguments(**FROZEN),
                         world["jb_frozen"].orig_vocab_size)
    trainer = Trainer(bundle, targs.TrainingArguments(
        **{**KW, "resume_from_checkpoint": path}), device="cpu")
    trainer.init_state()
    assert trainer.maybe_resume() == STEPS
    for n, p in bundle.model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), r["params"][n],
                                      err_msg=n)


def test_rows_the_mesh_does_not_divide_are_refused():
    """JAX's GSPMD would gather a batch the (data, fsdp) shards do not
    divide; the port's step refuses it."""
    from merlin_tpu_torch.train.step import local_rows

    batch = {"input_ids": torch.zeros((2, 6, 4)), "labels": torch.zeros(
        (2, 6, 4))}
    assert local_rows(batch, 3, 2)["input_ids"].shape == (2, 2, 4)
    with pytest.raises(ValueError, match="6 rows do not split over 4"):
        local_rows(batch, 4, 0)


@pytest.fixture(scope="module")
def split():
    return run_ranks(split_rank, 4, timeout=120)


def test_data_split_feeds_a_tensor_group_the_same_rows(split):
    """4 ranks, tp2: ranks (0, 1) and (2, 3) are tensor groups. The old
    split (each rank its own stream) hands the two ranks of a group
    different samples; the repaired one reads the node's stream (node 0
    of 1, 4 local ranks: an 8-row node batch) and hands each rank the rows
    of its (data, fsdp) coordinate."""
    assert [s["coord"][0] for s in split] == [0, 0, 1, 1]
    assert split[0]["old"] != split[1]["old"]              # the fault
    assert all(s["node"] == (0, 1) and s["local_world"] == 4 for s in split)
    assert split[0]["new"] == split[1]["new"]
    assert split[2]["new"] == split[3]["new"]
    assert split[0]["new"] != split[2]["new"]
    assert split[0]["new"] + split[2]["new"] == list(range(8))


def test_entry_point_under_a_tensor_parallel_group(tmp_path):
    """Two ranks of one node, tensor 2: the node reads one stream, its
    batch is 1 x 2 x 2 rows, both ranks hold all of them (one (data, fsdp)
    coordinate), equal to JAX's host batch on two devices; the two ranks'
    losses agree; checkpoint-3 is written whole."""
    import json

    from merlin_tpu.data import builder as j_builder
    from merlin_tpu.data import registry as j_registry
    from merlin_tpu.models import builder as j_models
    from merlin_tpu.train import arguments as j_args
    from test_data_pipeline import _make_interpair_shard
    from test_torch_engine_train import PRIME, _make_pair_shard

    _make_pair_shard(tmp_path / "pairs.tar")
    _make_interpair_shard(str(tmp_path / "track.tar"), n=12)
    (tmp_path / "conv.json").write_text(json.dumps([
        {"conversations": [{"from": "human", "value": f"question {i}"},
                           {"from": "gpt", "value": f"answer {i}"}]}
        for i in range(8)]))
    specs = [("pair", "mesh_e2e_pair", "WebdataSpec",
              dict(path=str(tmp_path / "pairs.tar"), size=32, merge_round=2)),
             ("interpair", "mesh_e2e_track", "WebdataSpec",
              dict(path=str(tmp_path / "track.tar"), size=12, merge_round=2)),
             ("conversation", "mesh_e2e_conv", "ConversationSpec",
              dict(annotations=str(tmp_path / "conv.json")))]
    argv = ["--pair_datasets", "mesh_e2e_pair",
            "--interpair_datasets", "mesh_e2e_track",
            "--conversation_datasets", "mesh_e2e_conv",
            "--group_by_modality_length", "True",
            "--output_dir", str(tmp_path / "out"),
            "--num_train_steps", "3", "--per_device_train_batch_size", "1",
            "--gradient_accumulation_steps", "2", "--model_max_length", "64",
            "--max_images", "4", "--learning_rate", "1e-3",
            "--warmup_ratio", "0.0", "--gradient_checkpointing", "False",
            "--save_steps", "0", "--logging_steps", "1",
            "--mesh_data", "1", "--mesh_tensor", "2"]
    ranks = run_ranks(entry_rank, 2, argv, specs, PRIME, timeout=240)

    for family, name, kind, kw in specs:
        j_registry.register(family, name, getattr(j_registry, kind)(**kw))
    model_args, data_args, training_args = j_args.parse_args(argv)
    bundle = j_models.build_model_tokenizer(model_args, data_args,
                                            training_args, tiny=True)
    bundle.tokenizer.encode(PRIME)
    data = j_builder.build_dataloader(bundle.tokenizer, bundle.special_ids,
                                      data_args, training_args,
                                      process_index=0, process_count=1)
    it = j_builder.batch_iterator(data["train_dataset"], data["collator"],
                                  batch_size=1 * 2 * 2,
                                  sampler=data["sampler"])
    want = [next(it) for _ in range(3)]
    for r in ranks:
        assert len(r["batches"]) == 3
        for got, ref in zip(r["batches"], want):
            keys = [k for k in ref if not k.startswith("__")]
            for k in keys:
                np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
            assert got["input_ids"].shape == (4, 64)
        assert r["files"] == ["data_state.json", "frozen.json", "model.pt",
                              "optimizer.pt"]
    assert np.isfinite(ranks[0]["metrics"]["loss"])
    assert ranks[0]["metrics"]["loss"] == ranks[1]["metrics"]["loss"]
