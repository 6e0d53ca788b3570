"""Unit tests for the direct-summation model vs the serial numpy oracle.

The oracle (tests/oracle_np.py) mirrors the serial spec samples/nbody.cc;
the engine must agree bit-for-bit on CPU f64 for short runs.
"""

import dataclasses
import os

import numpy as np
import pytest

from nbody import SimConfig, read_input
from nbody.engine import solve_scene
from nbody.models.direct_sum import run_problems_12, run_problem_3
from nbody.physics import oscillation_table

from oracle_np import run_steps

TESTCASE_DIR = "/root/reference/testcases"


@pytest.fixture(scope="module")
def b20():
    return read_input(os.path.join(TESTCASE_DIR, "b20.in"))


def _oracle_min_dist(scene, n_steps, devices_on):
    isdev = np.zeros(scene.n, bool)
    isdev[scene.device_idx] = True
    q, v = scene.q.copy(), scene.v.copy()
    mind = np.linalg.norm(q[scene.planet] - q[scene.asteroid])
    for s in range(n_steps):
        q, v, _ = run_steps(q, v, scene.m, isdev, 1,
                            devices_on=devices_on, start_step=s)
        mind = min(mind, np.linalg.norm(q[scene.planet] - q[scene.asteroid]))
    return mind, q, v


def test_p1_matches_oracle_bitexact(b20):
    cfg = dataclasses.replace(SimConfig(), n_steps=50)
    fst = oscillation_table(cfg)
    p12 = run_problems_12(b20, fst, cfg)
    mind, _, _ = _oracle_min_dist(b20, 50, devices_on=False)
    assert p12.min_dist == mind  # bit-exact


def test_p2_trajectory_matches_oracle(b20):
    """The devices-ON trajectory (scenario row 1) is tested two ways:

    1. Snapshot states: with a huge missile speed every device arrives at
       step 1, so q_snaps/v_snaps ARE the devices-ON state after exactly one
       step — compared bit-for-bit against the serial oracle.
    2. Hit detection: an artificial planet_radius placed strictly between
       the two smallest oracle planet-asteroid distances over 40 devices-ON
       steps must reproduce the oracle's first-crossing step exactly.
    """
    isdev = np.zeros(b20.n, bool)
    isdev[b20.device_idx] = True

    # --- 1. bit-exact devices-ON state after one step, via snapshots ---
    cfg1 = dataclasses.replace(SimConfig(), n_steps=3, missile_speed=1e30)
    p12 = run_problems_12(b20, oscillation_table(cfg1), cfg1)
    assert (p12.arrivals == 1).all()
    q1, v1, _ = run_steps(b20.q, b20.v, b20.m, isdev, 1, devices_on=True,
                          start_step=0)
    for k in range(b20.device_cnt):
        np.testing.assert_array_equal(p12.q_snaps[k], q1)
        np.testing.assert_array_equal(p12.v_snaps[k], v1)

    # --- 2. first-crossing step of an artificial radius threshold ---
    n_steps = 40
    q, v = b20.q.copy(), b20.v.copy()
    dists = []
    for s in range(n_steps):
        q, v, _ = run_steps(q, v, b20.m, isdev, 1, devices_on=True,
                            start_step=s)
        dists.append(np.linalg.norm(q[b20.planet] - q[b20.asteroid]))
    dists = np.asarray(dists)
    lo, hi = np.sort(dists)[:2]
    assert hi > lo * (1 + 1e-12)          # threshold placement is meaningful
    thr = 0.5 * (lo + hi)
    expect_step = int(np.argmax(dists < thr)) + 1   # first step under thr
    cfg2 = dataclasses.replace(SimConfig(), n_steps=n_steps,
                               planet_radius=thr)
    p12b = run_problems_12(b20, oscillation_table(cfg2), cfg2)
    assert p12b.hit_time_step == expect_step


def test_arrival_and_snapshot_semantics(b20):
    """Missile arrival steps follow the expanding-sphere rule
    (hw5.cu:270-274) and snapshots equal the devices-on oracle state at the
    arrival step."""
    cfg = dataclasses.replace(SimConfig(), n_steps=400)
    fst = oscillation_table(cfg)
    p12 = run_problems_12(b20, fst, cfg)

    isdev = np.zeros(b20.n, bool)
    isdev[b20.device_idx] = True
    q, v = b20.q.copy(), b20.v.copy()
    arrivals = np.full(b20.device_cnt, -2, dtype=int)
    snaps = {}
    sdt = 1e6 * 60.0
    for s in range(1, 401):
        q, v, _ = run_steps(q, v, b20.m, isdev, 1, devices_on=True,
                            start_step=s - 1)
        for k, d in enumerate(b20.device_idx):
            if arrivals[k] == -2:
                dd = q[b20.planet] - q[d]
                if dd @ dd < (sdt * s) ** 2:
                    arrivals[k] = s
                    snaps[k] = (q.copy(), v.copy())
    assert list(arrivals) == list(p12.arrivals)
    for k, (qs, vs) in snaps.items():
        rel = np.abs(p12.q_snaps[k] - qs) / np.maximum(np.abs(qs), 1.0)
        assert rel.max() < 1e-12


def test_p3_scenario_against_oracle(b20):
    """Force an artificial short config where a hit occurs, then check the
    batched P3 scan agrees with serially-resumed oracle sims."""
    cfg = dataclasses.replace(SimConfig(), n_steps=600)
    fst = oscillation_table(cfg)
    p12 = run_problems_12(b20, fst, cfg)
    saved = run_problem_3(b20, p12, fst, cfg)
    assert saved.shape == (b20.device_cnt,)

    # Oracle: for each device with arrival != -2 and arrival <= hit (if any
    # hit), resume from snapshot with that device dead and check for hits.
    isdev = np.zeros(b20.n, bool)
    isdev[b20.device_idx] = True
    for k, d in enumerate(b20.device_idx):
        arr = int(p12.arrivals[k])
        if arr == -2 or (p12.hit_time_step != -2 and arr > p12.hit_time_step):
            assert not saved[k]
            continue
        q = p12.q_snaps[k].copy()
        v = p12.v_snaps[k].copy()
        hit = False
        dd = q[b20.planet] - q[b20.asteroid]
        if dd @ dd < 1e14:
            hit = True
        qq, vv = q, v
        for s in range(arr + 1, cfg.n_steps + 1):
            qq, vv, h = run_steps(qq, vv, b20.m, isdev, 1, devices_on=True,
                                  start_step=s - 1, dead_device=int(d),
                                  planet=b20.planet, asteroid=b20.asteroid)
            if h != -2:
                hit = True
                break
        expect_saved = (p12.hit_time_step != -2) and not hit
        assert bool(saved[k]) == expect_saved


def test_solve_scene_no_hit_answers(b20):
    cfg = dataclasses.replace(SimConfig(), n_steps=20)
    ans = solve_scene(b20, cfg)
    assert ans.hit_time_step == -2
    assert ans.gravity_device_id == -1
    assert ans.missile_cost == 0.0
    assert ans.min_dist > 0


def test_blocked_force_kernel_matches_unblocked():
    """pairwise_accel_blocked (the large-n HBM-feasible formulation) vs
    the O(n^2)-materializing kernel: same physics, different (still
    deterministic) summation order -> near-ulp agreement, including a
    block size that does not divide n."""
    from nbody.ops.forces import pairwise_accel, pairwise_accel_blocked

    rng = np.random.RandomState(11)
    n = 37
    q = rng.randn(2, n, 3) * 1e9
    m = np.abs(rng.randn(2, n)) * 1e15
    full = np.asarray(pairwise_accel(q, m, G=6.674e-11, eps=1e-3))
    for block in (8, 16, 37):
        blk = np.asarray(pairwise_accel_blocked(q, m, G=6.674e-11,
                                                eps=1e-3, block=block))
        np.testing.assert_allclose(blk, full, rtol=1e-13, atol=0)


def test_p2_early_exit_bitexact():
    """Once the hit is found, the driver drops the devices-on row at a
    chunk boundary (the reference's break, hw5.cu:398-402). Every answer
    must be BIT-identical to the no-early-exit run — in particular the
    P1 row's continuation in the (1, n, 3) batch must reduce in the same
    order XLA used for the (2, n, 3) batch."""
    import dataclasses

    from nbody import SimConfig, read_input
    from nbody.engine import select_winner
    from nbody.models.direct_sum import run_problem_3, run_problems_12
    from nbody.physics import oscillation_table

    scene = read_input("/root/reference/testcases/b20.in")
    # radius forces a mid-run hit (cf. test_solver_sharded technique);
    # huge missile speed gives step-1 arrivals so P3 is exercised
    cfg = dataclasses.replace(SimConfig(), n_steps=400,
                              planet_radius=2.044e14, missile_speed=1e30)
    fst = oscillation_table(cfg)

    ref = run_problems_12(scene, fst, cfg, host_chunk=400)   # no boundary
    assert ref.hit_time_step not in (-2, 400), "setup: need a mid-run hit"
    ee = run_problems_12(scene, fst, cfg, host_chunk=50)     # exits early

    assert ee.min_dist == ref.min_dist                       # bitwise
    assert ee.hit_time_step == ref.hit_time_step
    # arrivals at or before the hit are answer-relevant: must be identical
    # (later ones may be -2 under early exit — both mean "cannot save")
    rel = (ref.arrivals != -2) & (ref.arrivals <= ref.hit_time_step)
    np.testing.assert_array_equal(ee.arrivals[rel], ref.arrivals[rel])
    assert all((a == -2) or (a == b)
               for a, b in zip(ee.arrivals, ref.arrivals))
    np.testing.assert_array_equal(ee.q_snaps[rel], ref.q_snaps[rel])

    saved_ref = run_problem_3(scene, ref, fst, cfg, strategy="batched")
    saved_ee = run_problem_3(scene, ee, fst, cfg, strategy="batched")
    assert select_winner(scene, ee.arrivals, saved_ee, cfg) == \
           select_winner(scene, ref.arrivals, saved_ref, cfg)


def test_p2_early_exit_checkpoint_resume(tmp_path):
    """Preemption AFTER the early-exit switch resumes bit-identically."""
    import dataclasses

    from nbody import SimConfig, read_input
    from nbody.models.direct_sum import run_problems_12
    from nbody.physics import oscillation_table

    scene = read_input("/root/reference/testcases/b20.in")
    cfg = dataclasses.replace(SimConfig(), n_steps=400,
                              planet_radius=2.044e14, missile_speed=1e30)
    fst = oscillation_table(cfg)
    ref = run_problems_12(scene, fst, cfg, host_chunk=50)
    assert ref.hit_time_step != -2

    ck = str(tmp_path / "ee.npz")
    cfg_partial = dataclasses.replace(cfg, n_steps=300)   # "crash" at 300
    run_problems_12(scene, oscillation_table(cfg_partial), cfg_partial,
                    host_chunk=50, checkpoint_path=ck)
    res = run_problems_12(scene, fst, cfg, host_chunk=50,
                          checkpoint_path=ck)
    assert res.min_dist == ref.min_dist
    assert res.hit_time_step == ref.hit_time_step
    np.testing.assert_array_equal(res.arrivals, ref.arrivals)
