import os

import numpy as np
import pytest

import jax.numpy as jnp

from nbody.utils.checkpoint import (CheckpointPolicy, load_checkpoint,
                                        save_checkpoint)
from nbody.utils.profiling import PhaseTimers, pair_interactions
from nbody.utils.rescale import compute_rescale, Rescale
from nbody.io import read_input
from nbody.ops.forces import pairwise_accel


def test_checkpoint_roundtrip(tmp_path):
    q = np.random.randn(16, 3)
    v = np.random.randn(16, 3)
    p = str(tmp_path / "ck.npz")
    save_checkpoint(p, step=1234, q=q, v=v,
                    extra={"min_d2": np.float64(3.5)},
                    meta={"case": "b20"})
    step, q2, v2, extra, meta = load_checkpoint(p)
    assert step == 1234
    np.testing.assert_array_equal(q, q2)
    np.testing.assert_array_equal(v, v2)
    assert extra["min_d2"] == 3.5
    assert meta["case"] == "b20"


def test_checkpoint_policy(tmp_path):
    pol = CheckpointPolicy(str(tmp_path / "ck{step}.npz"), every_steps=10)
    assert pol.maybe_save(5, np.zeros((2, 3)), np.zeros((2, 3))) is None
    path = pol.maybe_save(10, np.zeros((2, 3)), np.zeros((2, 3)))
    assert path and os.path.exists(path)


def test_phase_timers():
    t = PhaseTimers()
    with t.phase("a"):
        pass
    rec = t.report(stream=open(os.devnull, "w"), n=5)
    assert "a" in rec["phases_s"] and rec["n"] == 5
    # step 0 performs no force evaluation: n_steps evaluations per sim
    assert pair_interactions(10, 1, 2) == 10 * 10 * 1 * 2


def test_rescale_is_exact():
    """Power-of-2 rescaling must be an exact fp transform of the force law:
    a'(q', m') == a(q, m) * 2^qe bit-for-bit for the fast formulation."""
    scene = read_input("/root/reference/testcases/b20.in")
    rs = compute_rescale(scene)
    assert rs.length_scale * rs.unscale_length(1.0) == 1.0

    # scaled squared distance stays within float32 range
    qs = scene.q * rs.length_scale
    d2max = ((qs.max(0) - qs.min(0)) ** 2).sum()
    assert d2max < 3e38

    # exactness of the scale-covariance on the fp64 XLA path:
    G, eps = 6.674e-11, 1e-3
    a = pairwise_accel(jnp.asarray(scene.q), jnp.asarray(scene.m),
                       G=G, eps=eps, dist3_mode="dsqrt")
    cfg_scale = 2.0 ** (3 * rs.qe - rs.me)
    a2 = pairwise_accel(jnp.asarray(qs),
                        jnp.asarray(scene.m * rs.mass_scale),
                        G=G * cfg_scale, eps=eps * rs.length_scale,
                        dist3_mode="dsqrt")
    np.testing.assert_array_equal(np.asarray(a) * rs.length_scale,
                                  np.asarray(a2))
