"""Mesh-sharded triple-f32 (tf3/'ddp') graded-solver paths.

The tf3 ring (solver_sharded.ring_accel_ordered_tf3) and the sharded
P1/P2/P3 tf3 chunks must be mesh-shape-invariant and agree with the
single-device tf3 solver. The full-solve test is RUN_SLOW-gated: the
shard_map + tf3 scan compiles in minutes on XLA:CPU (validated here once
and in the round-2 session record — identical Answers across
{single-device, 1x1 mesh, 2x4 mesh} on a collision scene with a hit at
step 193 and P3 evaluated end-to-end).
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from nbody.ops import tfloat as tf
from nbody.parallel.mesh import make_mesh
from nbody.parallel.solver_sharded import ring_accel_ordered_tf3

slow = pytest.mark.skipif(not os.environ.get("RUN_SLOW"),
                          reason="minutes of XLA:CPU compile; RUN_SLOW=1")


def test_ring_tf3_matches_single_kernel_and_mesh_invariant():
    from nbody.ops.forces import pairwise_accel_tf3

    rng = np.random.default_rng(0)
    n, G, eps = 16, 6.674e-11, 1e-3
    q = rng.standard_normal((n, 3))
    m = np.abs(rng.standard_normal(n))
    qt0 = tf.from_f64(q)
    mt0 = tf.from_f64(m)
    qt = tf.TF3(*map(jnp.asarray, (qt0.hi, qt0.mid, qt0.lo)))
    mt = tf.TF3(*map(jnp.asarray, (mt0.hi, mt0.mid, mt0.lo)))
    ref = tf.to_f64(pairwise_accel_tf3(qt, mt, G=G, eps=eps))

    outs = {}
    for body in (1, 4):
        mesh = make_mesh({"body": body})

        def f(ql, ml):
            return ring_accel_ordered_tf3(ql, ml, axis_name="body",
                                          eps=eps, G=G, tile=4)

        fn = jax.jit(jax.shard_map(f, mesh=mesh,
                                   in_specs=(P("body", None), P("body")),
                                   out_specs=P("body", None)))
        out = fn(qt, mt)
        outs[body] = tuple(np.asarray(c) for c in (out.hi, out.mid, out.lo))
        np.testing.assert_allclose(tf.to_f64(tf.TF3(*outs[body])), ref,
                                   rtol=1e-15, atol=0)
    # Mesh invariance holds at (beyond-)f64 level. The LOWEST limb can
    # differ between mesh shapes on XLA:CPU: different shard shapes fuse
    # differently and the backend's fmuladd contraction perturbs the
    # APPROXIMATE third-order chains of tf3 mul within their ~2^-70
    # design budget (the error-free transforms themselves are
    # rewrite-immune — ops/tfloat.two_prod). The graded decision
    # quantities are unaffected: the full ddp mesh solve below returns
    # answers identical to the single-device path.
    np.testing.assert_array_equal(tf.to_f64(tf.TF3(*outs[1])),
                                  tf.to_f64(tf.TF3(*outs[4])))
    np.testing.assert_array_equal(outs[1][0], outs[4][0])   # hi limbs
    np.testing.assert_array_equal(outs[1][1], outs[4][1])   # mid limbs


@slow
def test_ddp_mesh_full_solve_matches_single_device():
    import dataclasses

    from nbody import SimConfig
    from nbody.engine import solve_scene
    from nbody.io import Scene

    rng = np.random.RandomState(7)
    n = 32
    q = rng.randn(n, 3) * 1e10
    v = rng.randn(n, 3) * 1e2
    m = np.abs(rng.randn(n)) * 1e12
    q[0] = 0.0
    v[0] = 0.0
    m[0] = 5.97e24
    q[1] = (3.0e8, 0.0, 0.0)
    v[1] = (-25000.0, 0.0, 0.0)
    m[1] = 1.0e10
    q[2], m[2] = (1.0e9, 0.0, 0.0), 1e12
    q[3], m[3] = (0.0, 2.0e9, 0.0), 1e12
    scene = Scene(n=n, planet=0, asteroid=1, q=q, v=v, m=m,
                  types=["planet", "asteroid", "device", "device"]
                  + ["body"] * (n - 4), device_idx=np.asarray([2, 3]))
    cfg = dataclasses.replace(SimConfig(), n_steps=300)
    plain = solve_scene(scene, cfg, precision="ddp", platform="cpu")
    assert plain.hit_time_step != -2
    for axes in ({"scen": 2, "body": 4}, {"scen": 1, "body": 1}):
        a = solve_scene(scene, cfg, precision="ddp", platform="cpu",
                        mesh=make_mesh(axes))
        assert a.min_dist == plain.min_dist
        assert (a.hit_time_step, a.gravity_device_id, a.missile_cost) == \
            (plain.hit_time_step, plain.gravity_device_id,
             plain.missile_cost)
