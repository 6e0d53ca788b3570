"""Multi-device sharding tests on the 8-device virtual CPU mesh."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from nbody.parallel import make_mesh, make_sharded_step, simulate_sharded
from nbody.ops.forces import pairwise_accel_fast

G, EPS, DT = 6.674e-11, 1e-3, 60.0


def _rand_system(n, seed=0):
    rs = np.random.RandomState(seed)
    q = rs.randn(n, 3)
    v = rs.randn(n, 3) * 1e-3
    m = np.abs(rs.randn(n)) * 1e8
    return q, v, m


def test_mesh_construction():
    mesh = make_mesh({"body": 8})
    assert mesh.devices.shape == (8,)
    mesh2 = make_mesh({"scen": 2, "body": -1})
    assert mesh2.devices.shape == (2, 4)


def test_ring_accel_matches_single_device():
    n = 64
    q, v, m = _rand_system(n)
    mesh = make_mesh({"body": 8})
    step = make_sharded_step(mesh, body_axis="body", G=G, eps=EPS, dt=DT)
    q1, v1 = step(jnp.asarray(q), jnp.asarray(v), jnp.asarray(m))

    a = pairwise_accel_fast(jnp.asarray(q), jnp.asarray(m), G=G, eps=EPS)
    v2 = v + np.asarray(a) * DT
    q2 = q + v2 * DT
    np.testing.assert_allclose(np.asarray(q1), q2, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(v1), v2, rtol=1e-12)


def test_sharded_step_with_scenario_batch():
    n, B = 32, 2
    q, v, m = _rand_system(n)
    qb = np.stack([q, q * 1.1])
    vb = np.stack([v, v])
    mb = np.stack([m, m * 2.0])
    mesh = make_mesh({"scen": 2, "body": 4})
    step = make_sharded_step(mesh, body_axis="body", batch_axes=("scen",),
                             G=G, eps=EPS, dt=DT)
    q1, v1 = step(jnp.asarray(qb), jnp.asarray(vb), jnp.asarray(mb))
    assert q1.shape == (B, n, 3)
    for b in range(B):
        a = pairwise_accel_fast(jnp.asarray(qb[b]), jnp.asarray(mb[b]),
                                G=G, eps=EPS)
        v2 = vb[b] + np.asarray(a) * DT
        q2 = qb[b] + v2 * DT
        np.testing.assert_allclose(np.asarray(q1[b]), q2, rtol=1e-12)


def test_simulate_sharded_runs_multiple_steps():
    n = 64
    q, v, m = _rand_system(n, seed=1)
    mesh = make_mesh({"body": 8})
    qf, vf = simulate_sharded(q, v, m, 10, mesh)
    assert np.isfinite(np.asarray(qf)).all()

    # single-device reference march
    qr, vr = jnp.asarray(q), jnp.asarray(v)
    for _ in range(10):
        a = pairwise_accel_fast(qr, jnp.asarray(m), G=G, eps=EPS)
        vr = vr + a * DT
        qr = qr + vr * DT
    np.testing.assert_allclose(np.asarray(qf), np.asarray(qr), rtol=1e-10)


def test_sharded_determinism():
    """Same input -> identical bits across runs (the property the
    reference's atomicAdd kernel lacks, SURVEY.md §4)."""
    n = 64
    q, v, m = _rand_system(n, seed=2)
    mesh = make_mesh({"body": 8})
    step = make_sharded_step(mesh, body_axis="body", G=G, eps=EPS, dt=DT)
    q1, v1 = step(jnp.asarray(q), jnp.asarray(v), jnp.asarray(m))
    q2, v2 = step(jnp.asarray(q), jnp.asarray(v), jnp.asarray(m))
    assert (np.asarray(q1) == np.asarray(q2)).all()
    assert (np.asarray(v1) == np.asarray(v2)).all()


def test_ring_with_pallas_kernel_interpret():
    """The production ring path (Pallas cross kernel inside shard_map) in
    interpreter mode on the CPU mesh must match the XLA ring path."""
    n = 256
    q, v, m = _rand_system(n, seed=5)
    mesh = make_mesh({"body": 8})
    step_ref = make_sharded_step(mesh, body_axis="body", G=G, eps=EPS, dt=DT)
    step_pl = make_sharded_step(mesh, body_axis="body", G=G, eps=EPS, dt=DT,
                                use_pallas=True, interpret=True)
    import jax.numpy as jnp
    qf = jnp.asarray(q, jnp.float32)
    vf = jnp.asarray(v, jnp.float32)
    mf = jnp.asarray(m, jnp.float32)
    q1, v1 = step_ref(qf, vf, mf)
    q2, v2 = step_pl(qf, vf, mf)
    np.testing.assert_allclose(np.asarray(q1), np.asarray(q2), rtol=3e-5,
                               atol=float(np.abs(np.asarray(q1)).max()) * 1e-6)
