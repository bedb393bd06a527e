"""The port's ring attention against the JAX package's
(``tests/test_ring_attention.py``'s five cases): the seq-sharded ring
against JAX's ring on the 8-device CPU mesh and against the dense
reference, forward at atol 2e-5 / rtol 1e-4 as there; the ring's dq, dk
and dv (the backward is the port's own reverse ring) against ``jax.grad``
of the dense reference at the same tolerance (the same function: no row
of these cases is empty); a planted dropped causal offset must
fail; the training step on the seq mesh (2, 1, 2, 2) through the
dispatcher.

The port runs on 8-rank CPU gloo groups (one spawn for all the ring
cases, in fresh processes that import torch and the port only); JAX is
imported in the test bodies.
"""

import numpy as np
import pytest
import torch

from merlin_tpu_torch.core.mesh import MeshConfig
from merlin_tpu_torch.utils.dist import dryrun_multichip, run_ranks

ATOL, RTOL = 2e-5, 1e-4


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _seg(seed, b, s):
    return np.sort(np.random.default_rng(seed).integers(0, 3, size=(b, s)),
                   axis=1).astype(np.int32)


CASES = {
    "causal": dict(shape=(1, 1, 4, 2), bshd=(2, 32, 4, 8), seeds=(0, 1, 2),
                   causal=True),
    "bidirectional": dict(shape=(1, 1, 4, 2), bshd=(2, 32, 4, 8),
                          seeds=(0, 1, 2), causal=False),
    "full_seq_axis": dict(shape=(1, 1, 8, 1), bshd=(1, 64, 2, 8),
                          seeds=(3, 4, 5), causal=True),
    "segment_ids": dict(shape=(1, 1, 4, 2), bshd=(1, 32, 2, 8),
                        seeds=(6, 7, 8), causal=True, seg=9),
    "dropped_offset": dict(shape=(1, 1, 4, 2), bshd=(2, 32, 4, 8),
                           seeds=(0, 1, 2), causal=True, plant=True),
}


def _inputs(case):
    b, s, h, d = case["bshd"]
    q, k, v = (_rand((b, s, h, d), sd) for sd in case["seeds"])
    seg = _seg(case["seg"], b, s) if "seg" in case else None
    w = _rand((b, s, h, d), 99)        # the cotangent: loss = sum(out * w)
    return q, k, v, seg, w


def ring_rank(rank, world):
    """Every ring case on one group: output and dq/dk/dv (rank 0's)."""
    from merlin_tpu_torch.core.mesh import create_mesh
    from merlin_tpu_torch.ops import ring_attention

    out = {}
    honest = ring_attention._offsets
    for name, case in CASES.items():
        mesh = create_mesh(MeshConfig(*case["shape"]))
        if case.get("plant"):
            # the key block's causal offset dropped
            ring_attention._offsets = lambda i, src, n: (i * n, 0)
        q, k, v, seg, w = (None if a is None else torch.from_numpy(a)
                           for a in _inputs(case))
        q, k, v = (t.requires_grad_(True) for t in (q, k, v))
        o = ring_attention.ring_self_attention(
            q, k, v, mesh=mesh, causal=case["causal"], segment_ids=seg)
        (o * w).sum().backward()
        ring_attention._offsets = honest
        out[name] = dict(out=o.detach().numpy(), dq=q.grad.numpy(),
                         dk=k.grad.numpy(), dv=v.grad.numpy())
    # a sequence the seq axis does not divide is refused
    q = torch.zeros((1, 30, 2, 8))
    try:
        ring_attention.ring_self_attention(q, q, q, mesh=mesh)
    except ValueError as err:
        out["undivided"] = str(err)
    return out if rank == 0 else None


@pytest.fixture(scope="module")
def port():
    return run_ranks(ring_rank, 8, timeout=180)[0]


def _jax(case, devices):
    import jax
    import jax.numpy as jnp
    from merlin_tpu.core.mesh import MeshConfig as JMeshConfig
    from merlin_tpu.core.mesh import create_mesh
    from merlin_tpu.ops.attention import mha_reference
    from merlin_tpu.ops.ring_attention import ring_self_attention

    data, fsdp, seq, tensor = case["shape"]
    mesh = create_mesh(JMeshConfig(data=data, fsdp=fsdp, seq=seq,
                                   tensor=tensor), devices=devices)
    q, k, v, seg, w = _inputs(case)
    seg = None if seg is None else jnp.asarray(seg)

    with mesh:
        out = ring_self_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), mesh=mesh,
                                  causal=case["causal"], segment_ids=seg)

    def loss(q_, k_, v_):
        o = mha_reference(q_, k_, v_, causal=case["causal"],
                          segment_ids_q=seg, segment_ids_kv=seg)
        return (o * w).sum(), o

    # every query sees at least itself: no row is empty, where the ring
    # (0) and the reference (the mean of v) would differ (trap C2)
    (_, ref), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                         has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in grads], np.asarray(ref)


@pytest.mark.parametrize("name", ["causal", "bidirectional",
                                  "full_seq_axis", "segment_ids"])
def test_ring_matches_jax_forward_and_backward(port, eight_devices, name):
    out, (dq, dk, dv), ref = _jax(CASES[name], eight_devices)
    got = port[name]
    np.testing.assert_allclose(got["out"], out, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got["out"], ref, atol=ATOL, rtol=RTOL)
    for key, want in (("dq", dq), ("dk", dk), ("dv", dv)):
        np.testing.assert_allclose(got[key], want, atol=ATOL, rtol=RTOL,
                                   err_msg=key)


def test_dropped_causal_offset_is_caught(port, eight_devices):
    out, (dq, _, _), _ = _jax(CASES["dropped_offset"], eight_devices)
    got = port["dropped_offset"]
    assert not np.allclose(got["out"], out, atol=1e-3, rtol=1e-3)
    assert not np.allclose(got["dq"], dq, atol=1e-3, rtol=1e-3)


def test_ring_refuses_an_undivided_sequence(port):
    assert port["undivided"] == \
        "sequence 30 does not split over the seq axis (4)"


def test_train_step_on_seq_sharded_mesh():
    """JAX's last case through the port's dryrun: one training step on the
    (2, 1, 2, 2) mesh, attention through the ring; the loss is finite.
    (``test_torch_mesh_train.py`` holds mesh steps against JAX's.)"""
    res = dryrun_multichip(8, cases=["seq"])
    seq = res["seq"]["metrics"][0]
    assert np.isfinite(seq["loss"]) and np.isfinite(seq["grad_norm"])
    assert res["seq"]["placement_problems"] == []
