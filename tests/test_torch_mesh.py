"""The port's mesh and logical-axis rules against the JAX package
(``tests/test_mesh.py``'s six cases), a column + row tensor-parallel
product on 4 ranks, and trap C41.

The multi-rank cases run once, in one module fixture, on an 8-rank CPU
gloo group (fresh processes: the rank function below imports torch and
the port only; each group has its own timeout). JAX runs on the 8 virtual
devices of ``conftest.py``, and is imported inside the test bodies. f32
on both sides: the products agree to rtol 1e-4, as JAX's own test.
"""

import numpy as np
import pytest
import torch

from merlin_tpu_torch.core.mesh import MESH_AXES, MeshConfig
from merlin_tpu_torch.core.partitioning import (
    logical_axis_rules, logical_to_mesh_axes, spec_for_logical)
from merlin_tpu_torch.utils.dist import run_ranks


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def mesh_rank(rank, world):
    """Every multi-rank case on one 8-rank group; rank 0's results."""
    from torch.distributed.tensor import DTensor

    from merlin_tpu_torch.core import parallel
    from merlin_tpu_torch.core.mesh import create_mesh
    from merlin_tpu_torch.core.partitioning import shard_logical
    from merlin_tpu_torch.models.layers import SimpleMLP

    out = {}
    mesh = create_mesh(MeshConfig(data=2, fsdp=2, tensor=2))
    out["names"] = tuple(mesh.mesh_dim_names)
    out["shape"] = tuple(mesh.shape)
    out["coord"] = tuple(mesh.get_coordinate())

    x = torch.ones((8, 4, 16))
    sharded = shard_logical(x, ("batch", "act_seq", None), mesh)
    out["shard_local"] = tuple(sharded.to_local().shape)
    out["shard_full_x2"] = (sharded.full_tensor() * 2).numpy()
    out["shard_is_dtensor"] = isinstance(sharded, DTensor)

    # JAX's column+row pair over tensor=8: w1 split by columns, w2 by rows
    tp8 = create_mesh(MeshConfig(data=1, fsdp=1, tensor=8))
    g = tp8.get_group("tensor")
    r = tp8.get_coordinate()[3]
    xv, w1, w2 = _rand((4, 16), 0), _rand((16, 32), 1), _rand((32, 16), 2)
    a = torch.from_numpy(w1).chunk(8, dim=1)[r]
    b = torch.from_numpy(w2).chunk(8, dim=0)[r]
    h = parallel.copy_to_group(torch.from_numpy(xv), g) @ a
    out["tp8"] = parallel.reduce_from_group(h @ b, g).numpy()

    # an MLP's column + row pair on 4-rank tensor groups, forward and
    # backward, through apply_tensor_parallel's cuts; then with the row
    # product left unreduced (planted)
    sub = create_mesh(MeshConfig(data=2, fsdp=1, tensor=4))
    for key, plant in (("tp4", False), ("tp4_planted", True)):
        torch.manual_seed(0)
        mlp = SimpleMLP(16, 32, activation="gelu", dtype=torch.float32)
        full = {n: p.detach().clone() for n, p in mlp.named_parameters()}
        info = parallel.apply_tensor_parallel(mlp, sub)
        if plant:
            mlp.fc2.tp_mode = None
        xin = torch.from_numpy(xv).requires_grad_(True)
        y = mlp(xin)
        y.square().sum().backward()
        out[key] = {
            "modes": (mlp.fc1.tp_mode, mlp.fc2.tp_mode),
            "dims": dict(info.tp_dims), "y": y.detach().numpy(),
            "dx": xin.grad.numpy(),
            "grads": {n: info.full_tensor(n, p.grad).numpy()
                      for n, p in mlp.named_parameters()},
            "full": {n: t.numpy() for n, t in full.items()}}
    # a dim the tensor axis does not divide is refused, not gathered
    try:
        parallel.apply_tensor_parallel(
            SimpleMLP(16, 30, activation="gelu", dtype=torch.float32), sub)
    except ValueError as err:
        out["undivided"] = str(err)
    return out if rank == 0 else None


@pytest.fixture(scope="module")
def ranks():
    return run_ranks(mesh_rank, 8, timeout=180)[0]


def test_mesh_resolve_wildcard():
    from merlin_tpu.core.mesh import MeshConfig as JMeshConfig

    cfg = MeshConfig(data=-1, fsdp=2, tensor=2).resolve(8)
    assert cfg.shape == (2, 2, 1, 2)
    assert cfg.shape == JMeshConfig(data=-1, fsdp=2, tensor=2).resolve(8).shape


@pytest.mark.parametrize("kw,n", [(dict(data=3, fsdp=1, tensor=1), 8),
                                  (dict(data=-1, fsdp=-1), 8),
                                  (dict(data=-1, fsdp=3), 8)])
def test_mesh_resolve_errors(kw, n):
    from merlin_tpu.core.mesh import MeshConfig as JMeshConfig

    with pytest.raises(ValueError) as theirs:
        JMeshConfig(**kw).resolve(n)
    with pytest.raises(ValueError) as ours:
        MeshConfig(**kw).resolve(n)
    assert str(ours.value) == str(theirs.value)


def test_create_mesh_8dev(ranks, eight_devices):
    from merlin_tpu.core.mesh import MESH_AXES as J_AXES
    from merlin_tpu.core.mesh import MeshConfig as JMeshConfig
    from merlin_tpu.core.mesh import create_mesh as j_create_mesh

    jmesh = j_create_mesh(JMeshConfig(data=2, fsdp=2, tensor=2),
                          devices=eight_devices)
    r = ranks
    assert r["names"] == MESH_AXES == tuple(jmesh.axis_names) == J_AXES
    assert r["shape"] == jmesh.devices.shape == (2, 2, 1, 2)
    assert r["coord"] == (0, 0, 0, 0)


def test_create_mesh_needs_a_process_group():
    from merlin_tpu_torch.core.mesh import create_mesh

    with pytest.raises(RuntimeError, match="process group"):
        create_mesh(MeshConfig(1, 1, 1, 1))


@pytest.mark.parametrize("axes", [("batch", None, "embed"), ("embed", "mlp"),
                                  ("norm",), ("vocab", "embed"),
                                  ("layers", "heads", "kv")])
def test_spec_for_logical(axes):
    from merlin_tpu.core.partitioning import spec_for_logical as j_spec

    assert spec_for_logical(axes) == tuple(j_spec(axes))
    assert spec_for_logical(("batch", None, "embed")) == \
        (("data", "fsdp"), None, "fsdp")


def test_shard_logical(ranks, eight_devices):
    import jax
    import jax.numpy as jnp
    from merlin_tpu.core.mesh import MeshConfig as JMeshConfig
    from merlin_tpu.core.mesh import create_mesh as j_create_mesh
    from merlin_tpu.core.partitioning import shard_logical as j_shard

    jmesh = j_create_mesh(JMeshConfig(data=2, fsdp=2, tensor=2),
                          devices=eight_devices)

    @jax.jit
    def f(x):
        return j_shard(x, ("batch", "act_seq", None), jmesh) * 2

    want = f(jnp.ones((8, 4, 16)))
    r = ranks
    np.testing.assert_allclose(r["shard_full_x2"], np.asarray(want))
    assert r["shard_is_dtensor"]
    # the batch dim over (data, fsdp): 8 rows -> 2 a rank, as JAX's shards
    assert r["shard_local"] == want.sharding.shard_shape(want.shape) \
        == (2, 4, 16)


def test_matmul_tp_psum_semantics(ranks):
    """A column+row split over 'tensor' (8 ranks) reproduces the dense
    product (JAX's test: sharded operands under jit)."""
    x, w1, w2 = _rand((4, 16), 0), _rand((16, 32), 1), _rand((32, 16), 2)
    np.testing.assert_allclose(ranks["tp8"], (x @ w1) @ w2, rtol=1e-4,
                               atol=1e-5)


def test_dense_column_row_pair_on_4_ranks(ranks):
    """An MLP cut by the rules: fc1 ("embed", "mlp") is column-parallel,
    fc2 ("mlp", "embed") row-parallel; the output, the input's gradient
    and every weight's gradient equal the uncut MLP's (autograd on one
    process). Leaving the row product unreduced must fail."""
    from merlin_tpu_torch.models.layers import SimpleMLP

    r = ranks["tp4"]
    assert r["modes"] == ("col", "row")
    assert r["dims"] == {"fc1.kernel": 1, "fc1.bias": 0, "fc2.kernel": 0}
    mlp = SimpleMLP(16, 32, activation="gelu", dtype=torch.float32)
    mlp.load_state_dict({n: torch.from_numpy(t)
                         for n, t in r["full"].items()})
    x = torch.from_numpy(_rand((4, 16), 0)).requires_grad_(True)
    y = mlp(x)
    y.square().sum().backward()
    np.testing.assert_allclose(r["y"], y.detach().numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(r["dx"], x.grad.numpy(), rtol=1e-5,
                               atol=1e-5)
    for n, p in mlp.named_parameters():
        np.testing.assert_allclose(r["grads"][n], p.grad.numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=n)
    assert not np.allclose(ranks["tp4_planted"]["y"], y.detach().numpy(),
                           rtol=1e-3, atol=1e-3)


def test_undivided_tensor_dim_is_refused(ranks):
    """JAX's GSPMD would gather an operand the mesh does not divide; the
    port refuses the cut instead."""
    assert ranks["undivided"] == ("fc1.kernel: dim 1 of (16, 30) does not "
                                  "divide the tensor axis (4)")


@pytest.mark.parametrize("overrides,axes,last_wins,first_wins", [
    ([("embed", None)], ("embed", "mlp"), ("fsdp", "tensor"),
     (None, "tensor")),
    (None, ("batch", "embed"), (("data", "fsdp"), "fsdp"), (None, "fsdp")),
], ids=["override_ignored", "mesh_axis_twice"])
def test_c41_spec_for_logical_vs_flax(overrides, axes, last_wins,
                                      first_wins):
    """Trap C41: spec_for_logical reads dict(rules) (the last duplicate
    wins, so a prepended override is ignored, and one mesh axis may serve
    two dims), flax's resolution behind sharding_for_tree takes the first
    match and gives a mesh axis to one dim only. Both packages keep both
    readings."""
    from flax import linen as nn
    from merlin_tpu.core.partitioning import logical_axis_rules as j_rules
    from merlin_tpu.core.partitioning import spec_for_logical as j_spec

    rules = logical_axis_rules(overrides)
    jr = j_rules(overrides)
    assert spec_for_logical(axes, rules) == tuple(j_spec(axes, jr))
    assert spec_for_logical(axes, rules) == last_wins
    assert tuple(nn.logical_to_mesh_axes(axes, jr)) == first_wins
    assert logical_to_mesh_axes(axes, rules) == first_wins


def test_flax_refuses_a_name_on_two_dims():
    from flax import linen as nn

    axes = ("conv_hw", "conv_hw", "conv_in", "conv_out")
    with pytest.raises(ValueError):
        nn.logical_to_mesh_axes(axes, logical_axis_rules())
    with pytest.raises(ValueError, match="more than once"):
        logical_to_mesh_axes(axes)


def test_dryrun_multichip_training_case():
    """The JAX package's dryrun training case on the port's tiny bundle
    (``utils.dist.dryrun_multichip``, 8 ranks: the (2, 2, 1, 2) mesh of its
    factorization, accum 2, remat, LLRD): a finite loss, every trainable
    parameter placed by the rules."""
    from merlin_tpu_torch.utils.dist import dryrun_multichip, factor_mesh

    assert factor_mesh(8) == (2, 2, 1, 2) and factor_mesh(6) == (3, 1, 1, 2)
    res = dryrun_multichip(8, cases=["train"])["train"]
    assert res["mesh_shape"] == (2, 2, 1, 2)
    assert np.isfinite(res["metrics"][0]["loss"])
    assert res["placement_problems"] == []
