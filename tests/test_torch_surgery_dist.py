"""Checkpoint surgery and the single-process behaviour of the rank helpers
(``tests/test_surgery_dist.py``'s three cases on the port), the
``make-delta``/``apply-delta`` command line round trip in a subprocess,
and ``interpolate_checkpoint_pos_embed`` against JAX's numerically (f32,
1e-5: both resize with Keys' bicubic, a = -0.5)."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from merlin_tpu_torch.utils.dist import (
    barrier, get_rank, get_world_size, host_allreduce_min, init_distributed,
    is_main_process, main_process_only)
from merlin_tpu_torch.utils.surgery import (
    interpolate_checkpoint_pos_embed, load_params, save_params, tree_add,
    tree_sub)


def test_delta_roundtrip():
    base = {"a": np.ones((2, 2)), "b": {"c": np.full((3,), 2.0)}}
    fine = {"a": np.full((2, 2), 3.0), "b": {"c": np.full((3,), 5.0)}}
    delta = tree_sub(fine, base)
    restored = tree_add(base, delta)
    np.testing.assert_allclose(restored["a"], fine["a"])
    np.testing.assert_allclose(restored["b"]["c"], fine["b"]["c"])
    with pytest.raises(KeyError):
        tree_sub({"a": np.ones(2)}, {"b": np.ones(2)})


@pytest.mark.parametrize("flat", [False, True], ids=["nested", "flat"])
def test_interpolate_checkpoint_pos_embed_matches_jax(flat):
    from merlin_tpu.utils.surgery import (
        interpolate_checkpoint_pos_embed as j_interpolate)

    pos = np.random.default_rng(0).normal(size=(5, 8)).astype(np.float32)
    want = j_interpolate({"vision_tower": {"vit": {
        "position_embedding": pos}}}, 17)
    want = np.asarray(want["vision_tower"]["vit"]["position_embedding"])
    assert want.shape == (17, 8)
    if flat:
        out = interpolate_checkpoint_pos_embed(
            {"vision_tower.vit.position_embedding": torch.from_numpy(pos),
             "lm.x": torch.ones(1)}, 17)
        got = out["vision_tower.vit.position_embedding"]
        assert "lm.x" in out
    else:
        out = interpolate_checkpoint_pos_embed({"vision_tower": {"vit": {
            "position_embedding": pos}}}, 17)
        got = out["vision_tower"]["vit"]["position_embedding"]
    assert tuple(got.shape) == (17, 8)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_init_distributed_keeps_torchs_timeout(monkeypatch):
    """A torchrun group keeps torch's collective timeout: the spawned test
    groups' 60 s would abort a rank that waits while rank 0 writes a large
    checkpoint."""
    from merlin_tpu_torch.utils import dist as mdist

    joined = []
    monkeypatch.setattr(mdist.dist, "init_process_group",
                        lambda *a, **kw: joined.append(kw))
    init_distributed("localhost:1", num_processes=2, process_id=1,
                     backend="gloo")
    assert joined[-1]["world_size"] == 2 and joined[-1]["rank"] == 1
    assert "timeout" not in joined[-1]


def test_dist_helpers_single_host():
    init_distributed()                 # one process: nothing to join
    assert get_rank() == 0
    assert get_world_size() == 1
    assert is_main_process()
    assert host_allreduce_min(42) == 42
    barrier()  # no-op

    calls = []

    @main_process_only
    def record(x):
        calls.append(x)
        return x

    assert record(7) == 7
    assert calls == [7]


def test_make_and_apply_delta_cli(tmp_path):
    rng = np.random.default_rng(1)
    base = {"lm.w": torch.from_numpy(rng.normal(size=(4, 3)).astype(np.float32)),
            "lm.b": torch.zeros(3)}
    fine = {k: v + torch.from_numpy(rng.normal(size=v.shape).astype(
        np.float32)) for k, v in base.items()}
    save_params(str(tmp_path / "base.pt"), base)
    save_params(str(tmp_path / "fine.pt"), fine)
    run = [sys.executable, "-m", "merlin_tpu_torch.utils.surgery"]
    subprocess.run(run + ["make-delta", "--base", str(tmp_path / "base.pt"),
                          "--finetuned", str(tmp_path / "fine.pt"),
                          "--delta", str(tmp_path / "delta.pt")],
                   check=True, timeout=120)
    subprocess.run(run + ["apply-delta", "--base", str(tmp_path / "base.pt"),
                          "--delta", str(tmp_path / "delta.pt"),
                          "--out", str(tmp_path / "out.pt")],
                   check=True, timeout=120)
    delta, out = load_params(str(tmp_path / "delta.pt")), \
        load_params(str(tmp_path / "out.pt"))
    for k in base:
        torch.testing.assert_close(delta[k], fine[k] - base[k], rtol=0,
                                   atol=0)
        torch.testing.assert_close(out[k], base[k] + delta[k], rtol=0, atol=0)
        torch.testing.assert_close(out[k], fine[k], rtol=1e-6, atol=1e-6)


def test_single_device_mesh_and_the_global_mesh(tmp_path):
    """A one-rank group (gloo, in this process, torn down after): the
    (1, 1, 1, 1) mesh, the global mesh set and cleared, and the helpers'
    one-rank behaviour inside a group."""
    import torch.distributed as dist

    from merlin_tpu_torch.core.mesh import (
        MESH_AXES, get_global_mesh, set_global_mesh, single_device_mesh)

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdzv",
                            rank=0, world_size=1)
    try:
        mesh = single_device_mesh()
        assert tuple(mesh.shape) == (1, 1, 1, 1)
        assert tuple(mesh.mesh_dim_names) == MESH_AXES
        set_global_mesh(mesh)
        assert get_global_mesh() is mesh
        assert get_world_size() == 1 and host_allreduce_min(5) == 5
        barrier()
    finally:
        set_global_mesh(None)
        dist.destroy_process_group()
    assert get_global_mesh() is None
