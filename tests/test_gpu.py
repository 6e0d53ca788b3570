"""Checks that need the card: the compiled Triton kernel and the IEEE f64
solve on the GPU. They skip on a CPU-only process (the `gpu` fixture,
tests/conftest.py)."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from nbody import SimConfig, solve_scene
from nbody.models.plummer import plummer_scene
from nbody.native import solve_exact
from nbody.ops.pallas_forces import pallas_accel

pytestmark = pytest.mark.gpu

G, EPS = 6.674e-11, 1e-3


def test_compiled_kernel_matches_f64_reference(gpu):
    n = 4096
    q, _, m = plummer_scene(n, seed=0)
    qf = jax.device_put(jnp.asarray(q, jnp.float32), gpu)
    gm = jax.device_put(jnp.asarray(G * m, jnp.float32), gpu)
    a = np.asarray(pallas_accel(qf, gm, eps=EPS), np.float64)
    dq = q[None, :, :] - q[:, None, :]
    d2 = (dq * dq).sum(-1) + EPS * EPS
    ref = ((G * m)[None, :, None] * dq / (d2 * np.sqrt(d2))[..., None]).sum(1)
    assert np.abs(a - ref).max() <= 1e-4 * np.abs(ref).max()
    assert np.linalg.norm(a - ref) <= 1e-5 * np.linalg.norm(ref)


def test_f64_solve_on_gpu_matches_native_core(gpu):
    import chip_smoke

    scene = chip_smoke.collision_scene(64)
    cfg = dataclasses.replace(SimConfig(),
                              n_steps=chip_smoke.GRADED_HORIZON)
    got = solve_scene(scene, cfg, precision="f64", platform="gpu")
    md, hit, dev, cost = solve_exact(scene, cfg, dist3_mode="dsqrt")
    assert (got.hit_time_step, got.gravity_device_id,
            got.missile_cost) == (hit, dev, cost)
    assert abs(got.min_dist - md) <= 1e-12 * md
