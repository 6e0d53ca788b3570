"""Native exact mode through the Python binding (short runs; the full-length
byte-golden validation lives in scripts/run_golden.py --precision exact)."""

import dataclasses
import os
import subprocess

import pytest

from nbody import SimConfig, read_input
from nbody.engine import solve_scene

TESTCASE_DIR = "/root/reference/testcases"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def build_native():
    subprocess.run(["make", "-C", os.path.join(REPO, "native")], check=True,
                   capture_output=True)


def test_exact_matches_oracle_binary(tmp_path):
    scene = read_input(os.path.join(TESTCASE_DIR, "b20.in"))
    cfg = dataclasses.replace(SimConfig(), n_steps=500)
    ans = solve_scene(scene, cfg, precision="exact")

    out = str(tmp_path / "o.out")
    subprocess.run([os.path.join(REPO, "native", "oracle"),
                    os.path.join(TESTCASE_DIR, "b20.in"), out, "500", "pow"],
                   check=True)
    from nbody.io import parse_output, format_output
    with open(out) as f:
        want = f.read()
    assert format_output(*ans.as_tuple()) == want


def test_exact_honors_config_overrides():
    """The C ABI passes the physics constants through (core.h
    nbody_solve_cfg): defaults are byte-identical to the legacy entry, and
    a changed planet_radius changes the native answer (no silent fallback
    to the reference's hard-coded params)."""
    from nbody.native import solve_exact

    scene = read_input(os.path.join(TESTCASE_DIR, "b20.in"))
    cfg = dataclasses.replace(SimConfig(), n_steps=500)
    base = solve_exact(scene, cfg, dist3_mode="pow")

    # a planet radius above the observed minimum distance forces a hit
    big = dataclasses.replace(cfg, planet_radius=2.0 * base[0])
    md, hs, dev, cost = solve_exact(scene, big, dist3_mode="pow")
    assert md == base[0]                    # trajectory untouched
    assert hs != -2 and hs != base[1]       # hit decision responds

    # G=0 turns the dynamics into straight-line drift; replicating the
    # exact iterative update (q += v*dt per step, v unchanged) in host f64
    # must reproduce the native min_dist bit-for-bit
    import numpy as np
    frozen = dataclasses.replace(cfg, G=0.0)
    md0, _, _, _ = solve_exact(scene, frozen, dist3_mode="pow")
    qp = scene.q[scene.planet].astype(np.float64).copy()
    qa = scene.q[scene.asteroid].astype(np.float64).copy()
    vp = scene.v[scene.planet].astype(np.float64)
    va = scene.v[scene.asteroid].astype(np.float64)

    def sqd(a, b):
        dx, dy, dz = a[0] - b[0], a[1] - b[1], a[2] - b[2]
        return dx * dx + dy * dy + dz * dz

    best = sqd(qp, qa)
    for _ in range(cfg.n_steps):
        qp = qp + vp * cfg.dt
        qa = qa + va * cfg.dt
        best = min(best, sqd(qp, qa))
    assert md0 == float(np.sqrt(best))


def test_exact_agrees_with_f64_engine_short():
    """Over a short horizon (before chaos amplifies reduction-order ulps)
    the native core and the JAX f64 path must give the same answers."""
    scene = read_input(os.path.join(TESTCASE_DIR, "b40.in"))
    cfg = dataclasses.replace(SimConfig(), n_steps=300)
    a = solve_scene(scene, cfg, precision="exact")
    b = solve_scene(scene, cfg, precision="f64")
    assert a.hit_time_step == b.hit_time_step
    assert a.gravity_device_id == b.gravity_device_id
    assert abs(a.min_dist - b.min_dist) / a.min_dist < 1e-12
