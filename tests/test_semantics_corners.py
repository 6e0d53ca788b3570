"""Semantics corner cases, engine (f64) vs the native byte-golden core.

Each corner pins a decision-rule edge the graded problems depend on
(strict `<` comparisons, step-0 inclusion, arrival/hit ordering — see
native/core.cc:149-212) on a scene CONSTRUCTED to sit on that edge, and
requires the JAX engine and the native spec to agree exactly.
"""

import dataclasses
import os

import numpy as np
import pytest

from nbody import SimConfig
from nbody.engine import solve_scene
from nbody.io import Scene
from nbody.native import solve_exact

_HAS_NATIVE = os.path.exists(
    os.path.join(os.path.dirname(__file__), "..", "native",
                 "libnbody_core.so"))


def _scene(q, v, m, device_idx, planet=0, asteroid=1):
    q = np.asarray(q, np.float64)
    n = q.shape[0]
    types = ["planet" if i == planet else
             "asteroid" if i == asteroid else
             "device" if i in set(int(d) for d in device_idx) else "body"
             for i in range(n)]
    return Scene(n=n, planet=planet, asteroid=asteroid, q=q,
                 v=np.asarray(v, np.float64), m=np.asarray(m, np.float64),
                 types=types, device_idx=np.asarray(device_idx, np.int64))


def _agree(scene, cfg, min_dist_rtol=0.0):
    """Engine (f64, CPU) must match the native spec. min_dist is bit-exact
    by default; pass min_dist_rtol for scenes whose dynamics pass through
    near-singular encounters (there, XLA's j-sum order vs the serial
    fold's differs by ulps that the close pass amplifies — the discrete
    decision answers must still agree exactly)."""
    eng = solve_scene(scene, cfg, precision="f64", platform="cpu")
    if not _HAS_NATIVE:
        return eng, None
    md, hs, dev, cost = solve_exact(scene, cfg,
                                    dist3_mode=cfg.dist3_mode or "dsqrt")
    assert eng.hit_time_step == hs
    assert eng.gravity_device_id == dev
    if min_dist_rtol == 0.0:
        assert eng.min_dist == md        # bit-exact, both IEEE f64 dsqrt
    else:
        assert abs(eng.min_dist - md) <= min_dist_rtol * md
    assert eng.missile_cost == cost
    return eng, (md, hs, dev, cost)


def _base(n=8, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(n, 3) * 1e9
    v = rng.randn(n, 3) * 10.0
    m = np.abs(rng.randn(n)) * 1e10
    q[0] = 0.0
    v[0] = 0.0
    m[0] = 5.97e24
    return q, v, m


def test_hit_at_step_0():
    """Asteroid starts INSIDE the planet radius: hit at step 0, and no
    device can save it (arrival at step 0 is impossible: missile radius is
    0 and comparisons are strict, core.cc:175-176)."""
    q, v, m = _base()
    m[0] = 1e10                           # tame: no singular slingshot
    q[1] = (1e6, 0.0, 0.0)               # < planet_radius = 1e7
    v[1] = (1e4, 0.0, 0.0)               # drifts out; step-0 hit regardless
    m[1] = 1e5
    scene = _scene(q, v, m, device_idx=[2, 3])
    cfg = dataclasses.replace(SimConfig(), n_steps=50, dist3_mode="dsqrt")
    eng, _ = _agree(scene, cfg)
    assert eng.hit_time_step == 0
    assert eng.gravity_device_id == -1
    assert eng.missile_cost == 0.0


def test_asteroid_exactly_at_radius_is_not_a_hit():
    """d == planet_radius exactly: strict `<` must NOT register a hit at
    step 0 (core.cc:181)."""
    q, v, m = _base()
    q[1] = (1e7, 0.0, 0.0)               # exactly planet_radius
    v[1] = (1e7 / 60.0 / 50.0, 0.0, 0.0)  # drifting away
    m[1] = 1.0
    # freeze gravity so the distance stays controlled: massless everything
    m[:] = 0.0
    scene = _scene(q, v, m, device_idx=[2, 3])
    cfg = dataclasses.replace(SimConfig(), n_steps=20, dist3_mode="dsqrt")
    eng, _ = _agree(scene, cfg)
    assert eng.hit_time_step == -2


def test_device_on_top_of_planet_arrives_at_step_1():
    """A device colocated with the planet: no arrival at step 0 (missile
    radius 0, strict <), arrival at step 1 (radius 6e7 >> any drift). The
    arrival must be recorded even though the hit comes much later."""
    q, v, m = _base()
    # y-offset keeps the closest approach well-conditioned (a pass through
    # the exact origin would put min_dist below f64's cancellation floor)
    q[1] = (3.0e8, 1.0e6, 0.0)
    v[1] = (-5.0e6 / 60.0, 0.0, 0.0)     # reaches r<1e7 around step ~58
    m[1] = 1.0
    q[2] = q[0]                           # device exactly on the planet
    v[2] = 0.0
    m[2] = 1e3
    m[0] = 0.0                            # keep trajectories ballistic
    m[3:] = 0.0
    scene = _scene(q, v, m, device_idx=[2, 3])
    cfg = dataclasses.replace(SimConfig(), n_steps=100, dist3_mode="dsqrt")
    eng, _ = _agree(scene, cfg)
    assert eng.hit_time_step != -2
    # destroying the colocated massless device cannot deflect the asteroid
    assert eng.gravity_device_id == -1


def test_arrival_after_hit_cannot_save():
    """A device whose missile arrives AFTER the hit step is ineligible
    even if destroying it would deflect the asteroid (core.cc:197)."""
    q, v, m = _base()
    m[:] = 0.0
    q[1] = (1.2e7, 0.0, 0.0)
    v[1] = (-(1.2e7 - 0.9e7) / (2 * 60.0), 0.0, 0.0)   # hit at step ~2
    q[2] = (6.0e12, 0.0, 0.0)            # arrival ~ step 1e5
    m[2] = 1e20                           # massive: would matter if destroyed
    scene = _scene(q, v, m, device_idx=[2])
    cfg = dataclasses.replace(SimConfig(), n_steps=200, dist3_mode="dsqrt")
    eng, _ = _agree(scene, cfg)
    assert eng.hit_time_step != -2
    assert eng.gravity_device_id == -1


def test_zero_device_scene_all_precisions():
    """No devices: P3 must be skipped cleanly on every precision path,
    including the rescaled representations (dd/f32 run here on the CPU
    backend — the same code path as on the GPU)."""
    q, v, m = _base(n=8, seed=3)
    q[1] = (5.0e8, 0.0, 0.0)
    v[1] = (-1.0e5, 0.0, 0.0)
    m[1] = 1e4
    scene = _scene(q, v, m, device_idx=[])
    cfg = dataclasses.replace(SimConfig(), n_steps=300, dist3_mode="dsqrt")
    eng, _ = _agree(scene, cfg, min_dist_rtol=1e-9)
    for prec, rtol in (("dd", 1e-6), ("f32", 1e-2)):
        a = solve_scene(scene, cfg, precision=prec, platform="cpu")
        assert a.gravity_device_id == -1
        assert a.missile_cost == 0.0
        # approximate paths: discrete answers may shift by a step on a
        # knife-edge but the distance scale must agree at their precision
        assert np.isclose(a.min_dist, eng.min_dist, rtol=rtol), \
            (prec, a.min_dist, eng.min_dist)


def test_arrival_equal_to_hit_step_is_eligible():
    """arr == hit_step devices ARE eligible (core.cc:197 skips only
    arr > hit_step): engineered so the missile arrives exactly at the hit
    step and destroying the device saves the planet."""
    q, v, m = _base()
    m[:] = 0.0
    hit_step = 10
    # asteroid crosses r = 1e7 between steps 9 and 10
    q[1] = (2.0e7, 0.0, 0.0)
    v[1] = (-(2.0e7 - 0.95e7) / (hit_step * 60.0), 0.0, 0.0)
    # a black hole that the asteroid's hit depends on: heavy device pulls
    # the asteroid inward; destroying it keeps the asteroid outside
    q[2] = (1.5e7, -4e6, 0.0)
    m[2] = 5e23
    # missile arrival exactly at hit_step: distance = missile_speed*dt*10
    d = 6.0e7 * hit_step * 0.9999        # just inside at step 10, not 9
    q[3] = (0.0, d, 0.0)
    scene = _scene(q, v, m, device_idx=[2, 3])
    cfg = dataclasses.replace(SimConfig(), n_steps=40, dist3_mode="dsqrt")
    eng, ref = _agree(scene, cfg)
    # the engineered edge itself: whatever the answers are, engine == native
    # (asserted by _agree); sanity: a hit happened near the target step
    assert eng.hit_time_step != -2


def test_fuzz_random_scenes_vs_native():
    """Randomized short-horizon scenes (with black-hole-heavy devices and
    near-miss asteroids) must agree with the native core exactly."""
    if not _HAS_NATIVE:
        pytest.skip("native core not built")
    for seed in range(6):
        rng = np.random.RandomState(100 + seed)
        n = 10
        q = rng.randn(n, 3) * 2e8
        v = rng.randn(n, 3) * 1e3
        m = np.abs(rng.randn(n)) * 10.0 ** rng.uniform(8, 22, n)
        q[0] = 0.0
        v[0] = 0.0
        m[0] = 5.97e24
        q[1] = (2.0e8, 0.0, 0.0)
        v[1] = (-rng.uniform(0.5e5, 3e5), rng.randn() * 1e3,
                rng.randn() * 1e3)
        m[1] = 1e5
        scene = _scene(q, v, m, device_idx=[2, 3, 4])
        cfg = dataclasses.replace(SimConfig(), n_steps=500,
                                  dist3_mode="dsqrt")
        _agree(scene, cfg, min_dist_rtol=1e-9)


def _deflection_scene():
    """A black-hole device pulls the asteroid into the planet; destroying
    it saves the planet (the P3-positive path: winner != -1)."""
    n = 6
    q = np.zeros((n, 3))
    v = np.zeros((n, 3))
    m = np.zeros(n)
    q[1] = (3.0e8, 2.0e7, 0.0)           # would miss at 2e7 > radius
    v[1] = (-1.0e5, 0.0, 0.0)
    m[1] = 1.0
    q[2] = (1.5e8, -1.0e7, 0.0)          # black hole bends it into the hit
    m[2] = 2.0e26
    q[3] = (0.0, 5.0e12, 0.0)            # irrelevant far device
    m[3] = 1.0
    return _scene(q, v, m, device_idx=[2, 3])


def test_p3_winner_saves_planet():
    """Engine == native on a scene where P3 has a SAVING device: the hit
    exists with devices on, and destroying the black-hole device prevents
    it (cost = 1e5 + 1e3*(arr+1)*dt, core.cc:205)."""
    scene = _deflection_scene()
    cfg = dataclasses.replace(SimConfig(), n_steps=5000,
                              dist3_mode="dsqrt", missile_speed=1e6)
    eng, _ = _agree(scene, cfg)
    assert eng.hit_time_step == 48
    assert eng.gravity_device_id == 2
    assert eng.missile_cost == 340000.0


def test_p3_winner_unreachable_when_missile_too_slow():
    """Same scene, but the missile cannot reach the black hole before the
    hit: arrival > hit_step makes it ineligible (core.cc:197) -> no
    savior."""
    scene = _deflection_scene()
    cfg = dataclasses.replace(SimConfig(), n_steps=5000,
                              dist3_mode="dsqrt", missile_speed=1e3)
    # cross-checked against the native core: the C ABI accepts the full
    # physics config (core.h nbody_solve_cfg), including missile_speed
    eng, _ = _agree(scene, cfg)
    assert eng.hit_time_step == 48
    assert eng.gravity_device_id == -1
    assert eng.missile_cost == 0.0


def test_select_winner_tie_breaks_by_body_index():
    """Equal costs (same arrival step) break ties by ORIGINAL body index
    (the reference processes scenarios in (arrival, slot) order and keeps
    the first strictly-cheaper winner, hw5.cu:574-585)."""
    from nbody.engine import select_winner

    q, v, m = _base()
    scene = _scene(q, v, m, device_idx=[5, 3])   # file order: body 5, 3
    cfg = SimConfig()
    arrivals = np.asarray([100, 100], np.int32)
    saved = np.asarray([True, True])
    dev, cost = select_winner(scene, arrivals, saved, cfg)
    assert dev == 3                                # lower body index wins
    assert cost == 100000.0 + 1000.0 * 101 * cfg.dt
    # earlier arrival (cheaper) beats body order
    dev, _ = select_winner(scene, np.asarray([99, 100], np.int32),
                           saved, cfg)
    assert dev == 5
    # nobody saves -> (-1, 0.0)
    dev, cost = select_winner(scene, arrivals,
                              np.asarray([False, False]), cfg)
    assert (dev, cost) == (-1, 0.0)
