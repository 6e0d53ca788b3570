"""Randomized differential fuzz: engine vs the native byte-golden core.

A standing regression net beyond the hand-built edges in
test_semantics_corners.py: ~100 seeded random
scenes, short horizons, every scene solved by both the JAX engine
(precision 'f64', CPU) and the native serial spec (native/core.cc) in the
same dsqrt dist3 mode. Discrete answers (hit step, winning device) must
agree exactly; min_dist/cost to 1e-9 (XLA's j-sum reduction order differs
from the serial fold by ulps, which close encounters amplify — the same
tolerance the verify runbook uses at 600 steps).

Scenes are CONSTRUCTED so the short horizon still exercises the decision
machinery: the asteroid approaches the planet at hit-in-~N-steps speeds
for about half the seeds, devices sit inside missile range so arrivals
and Problem-3 resumes actually occur. Seeds are fixed — a pass is
reproducible, not probabilistic.

The e64 softfloat twin (byte-identical to native BY CONSTRUCTION) runs
under RUN_SLOW=1: XLA:CPU compiles the fused softfloat graphs in minutes
(a CPU-backend pathology — tests/test_e64_solver.py header).
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

N = 16
D = 2
N_STEPS = 240


def _fuzz_scene(seed: int) -> Scene:
    rng = np.random.RandomState(seed)
    q = rng.randn(N, 3) * 10.0 ** rng.uniform(9, 11)
    v = rng.randn(N, 3) * 10.0 ** rng.uniform(2, 4)
    m = np.abs(rng.randn(N)) * 10.0 ** rng.uniform(20, 26, size=N)

    planet, asteroid = 0, 1
    m[planet] = 10.0 ** rng.uniform(24, 26)
    m[asteroid] = 10.0 ** rng.uniform(20, 23)
    q[planet] = rng.randn(3) * 1e9
    # Aim the asteroid at the planet: half the seeds at hit-within-horizon
    # closing speeds, half slower (min-dist-only scenes).
    sep_dir = rng.randn(3)
    sep_dir /= np.linalg.norm(sep_dir)
    dist = 10.0 ** rng.uniform(8.5, 10.5)
    q[asteroid] = q[planet] + sep_dir * dist
    dt = 60.0
    steps_to_close = rng.uniform(30, 400 if seed % 2 else 150)
    speed = dist / (steps_to_close * dt)
    v[asteroid] = -sep_dir * speed
    # lateral velocity sized so the ballistic closest approach lands
    # between "inside the planet" and "a few radii away": some seeds hit,
    # some near-miss (the interesting min_dist regime), some are pulled
    # in or deflected by the devices below.
    lat = rng.randn(3)
    lat -= lat @ sep_dir * sep_dir
    lat /= np.linalg.norm(lat)
    v[asteroid] += lat * speed * (rng.uniform(0.0, 3e7) / dist)
    v[planet] = rng.randn(3) * 1e2

    # Devices near the planet, inside early missile range
    # (missile radius = 6e7 * step), with planet-class masses so
    # destroying one changes the dynamics.
    device_idx = []
    for k in range(D):
        i = 2 + k
        device_idx.append(i)
        ddir = rng.randn(3)
        ddir /= np.linalg.norm(ddir)
        q[i] = q[planet] + ddir * 10.0 ** rng.uniform(8.3, 9.8)
        v[i] = v[planet] + rng.randn(3) * 1e2
        # heavy enough that device gravity moves closest approaches by
        # ~planet radii over the horizon — destroying one can flip a hit
        m[i] = 10.0 ** rng.uniform(25.5, 28)

    types = ["planet", "asteroid"] + ["device"] * D + ["star"] * (N - 2 - D)
    return Scene(n=N, planet=planet, asteroid=asteroid, q=q, v=v, m=m,
                 types=types,
                 device_idx=np.asarray(device_idx, np.int64))


_CFG = dataclasses.replace(SimConfig(), n_steps=N_STEPS, dist3_mode="dsqrt")


@pytest.mark.skipif(not _HAS_NATIVE, reason="native core not built")
@pytest.mark.parametrize("seed", range(100))
def test_fuzz_f64_vs_native(seed):
    scene = _fuzz_scene(seed)
    md, hs, dev, cost = solve_exact(scene, _CFG, dist3_mode="dsqrt")
    eng = solve_scene(scene, _CFG, precision="f64", platform="cpu")
    assert eng.hit_time_step == hs
    assert eng.gravity_device_id == dev
    assert eng.min_dist == pytest.approx(md, rel=1e-9)
    assert eng.missile_cost == pytest.approx(cost, rel=1e-9)


def test_fuzz_coverage():
    """The corpus must actually exercise all three problems: some hits,
    some no-hits, some saved-by-device outcomes (guards against the
    generator drifting into a regime where the fuzz only ever tests P1)."""
    if not _HAS_NATIVE:
        pytest.skip("native core not built")
    outcomes = [solve_exact(_fuzz_scene(s), _CFG, dist3_mode="dsqrt")
                for s in range(100)]
    hits = sum(1 for _, hs, _, _ in outcomes if hs != -2)
    saves = sum(1 for _, _, dev, _ in outcomes if dev != -1)
    assert hits >= 10, f"only {hits}/100 seeds hit"
    assert 100 - hits >= 10, f"only {100 - hits}/100 seeds miss"
    assert saves >= 2, f"only {saves}/100 seeds saved by a device"


@pytest.mark.skipif(os.environ.get("RUN_SLOW") != "1",
                    reason="XLA:CPU softfloat compile takes minutes; "
                           "RUN_SLOW=1 enables")
@pytest.mark.parametrize("seed", [1, 3, 14])
def test_fuzz_e64_vs_native(seed):
    """The softfloat path is byte-identical to native BY CONSTRUCTION —
    the fuzz checks the construction on scenes nobody hand-built."""
    scene = _fuzz_scene(seed)
    md, hs, dev, cost = solve_exact(scene, _CFG, dist3_mode="dsqrt")
    eng = solve_scene(scene, _CFG, precision="e64", platform="cpu")
    assert eng.hit_time_step == hs
    assert eng.gravity_device_id == dev
    assert np.float64(eng.min_dist).view(np.uint64) == \
        np.float64(md).view(np.uint64)
    assert np.float64(eng.missile_cost).view(np.uint64) == \
        np.float64(cost).view(np.uint64)
