"""The graded solver on the mesh: bit-stability across mesh shapes and
agreement with the single-device drivers."""

import dataclasses
import os

import numpy as np
import pytest

from nbody import SimConfig, read_input
from nbody.models.direct_sum import run_problems_12, run_problem_3
from nbody.parallel import make_mesh
from nbody.parallel.solver_sharded import (
    run_problems_12_sharded, run_problem_3_sharded, solve_scene_sharded)
from nbody.physics import oscillation_table
from nbody.utils.padding import pad_scene

TESTCASE_DIR = "/root/reference/testcases"


@pytest.fixture(scope="module")
def b20p():
    """b20 padded to 32 bodies — divisible by every mesh body axis used
    here (1, 2, 4); padding is semantics-exact (tests/test_padding.py)."""
    return pad_scene(read_input(os.path.join(TESTCASE_DIR, "b20.in")),
                     n_target=32, d_target=2)


def _p12(scene, cfg, mesh, tile):
    fst = oscillation_table(cfg)
    return run_problems_12_sharded(scene, fst, cfg, mesh, tile=tile)


def test_p12_bitwise_invariant_across_mesh_shapes(b20p):
    """Same tile size => bit-identical carries on a 1x1, a 2x4 and a 1x8
    mesh — the determinism contract the reference's atomicAdd breaks
    (SURVEY.md §4)."""
    cfg = dataclasses.replace(SimConfig(), n_steps=50)
    results = []
    for axes in ({"scen": 1, "body": 1}, {"scen": 2, "body": 4},
                 {"scen": 1, "body": 8}):
        mesh = make_mesh(axes)
        results.append(_p12(b20p, cfg, mesh, tile=4))
    ref = results[0]
    for r in results[1:]:
        assert r.min_dist == ref.min_dist          # bitwise
        assert r.hit_time_step == ref.hit_time_step
        np.testing.assert_array_equal(r.arrivals, ref.arrivals)
        np.testing.assert_array_equal(r.q_snaps, ref.q_snaps)
        np.testing.assert_array_equal(r.v_snaps, ref.v_snaps)


def test_p12_sharded_matches_plain_driver(b20p):
    """vs models/direct_sum.run_problems_12: identical discrete answers;
    min_dist to reduction-order tolerance (the sharded path sums j in
    fixed tiles, the plain path in one flat reduce)."""
    cfg = dataclasses.replace(SimConfig(), n_steps=50)
    fst = oscillation_table(cfg)
    plain = run_problems_12(b20p, fst, cfg)
    shard = _p12(b20p, cfg, make_mesh({"scen": 2, "body": 4}), tile=8)
    assert shard.hit_time_step == plain.hit_time_step
    np.testing.assert_array_equal(shard.arrivals, plain.arrivals)
    np.testing.assert_allclose(shard.min_dist, plain.min_dist, rtol=1e-12)
    np.testing.assert_allclose(shard.q_snaps, plain.q_snaps, rtol=1e-12,
                               atol=0)


def test_full_sharded_solve_with_p3(b20p):
    """Short-horizon full P1/P2/P3 solve on the mesh: an inflated planet
    radius forces a hit so Problem 3 actually runs; answers must agree
    with the single-device drivers and be mesh-shape invariant."""
    # radius between the 400-step devices-on min distance (~2.041e14) and
    # the initial distance (~2.047e14): guarantees a mid-run hit; the huge
    # missile speed makes every device arrive at step 1 so the resumed P3
    # scenarios genuinely integrate (cf. test_direct_sum's technique)
    cfg = dataclasses.replace(SimConfig(), n_steps=400,
                              planet_radius=2.044e14, missile_speed=1e30)
    fst = oscillation_table(cfg)
    p12 = run_problems_12(b20p, fst, cfg)
    assert p12.hit_time_step != -2, "test setup: no hit"
    saved_plain = run_problem_3(b20p, p12, fst, cfg, strategy="batched")

    meshes = [make_mesh({"scen": 1, "body": 1}),
              make_mesh({"scen": 2, "body": 4})]
    answers = []
    for mesh in meshes:
        ans, p12s = solve_scene_sharded(b20p, cfg, mesh, tile=4)
        saved_shard = run_problem_3_sharded(b20p, p12s, fst, cfg, mesh,
                                            tile=4)
        assert p12s.hit_time_step == p12.hit_time_step
        np.testing.assert_array_equal(saved_shard, saved_plain)
        answers.append(ans)
    a, b = answers
    assert a.min_dist == b.min_dist                # mesh-shape bitwise
    assert (a.hit_time_step, a.gravity_device_id, a.missile_cost) == \
           (b.hit_time_step, b.gravity_device_id, b.missile_cost)
    np.testing.assert_allclose(a.min_dist, float(p12.min_dist), rtol=1e-12)


def test_p2_early_exit_sharded_bitexact(b20p):
    """On a scen=1 mesh the sharded driver drops the devices-on row once
    the hit is known (direct_sum's early exit, hw5.cu:398-402) — answers
    bit-identical to the no-exit run; scen=2 meshes keep the stacked
    chunk (rows live on disjoint devices, nothing to save)."""
    cfg = dataclasses.replace(SimConfig(), n_steps=400,
                              planet_radius=2.044e14, missile_speed=1e30)
    fst = oscillation_table(cfg)
    mesh = make_mesh({"scen": 1, "body": 4})
    ref = run_problems_12_sharded(b20p, fst, cfg, mesh, tile=4,
                                  host_chunk=400)
    assert ref.hit_time_step not in (-2, 400)
    ee = run_problems_12_sharded(b20p, fst, cfg, mesh, tile=4,
                                 host_chunk=50)
    assert ee.min_dist == ref.min_dist
    assert ee.hit_time_step == ref.hit_time_step
    rel = (ref.arrivals != -2) & (ref.arrivals <= ref.hit_time_step)
    np.testing.assert_array_equal(ee.arrivals[rel], ref.arrivals[rel])
    np.testing.assert_array_equal(ee.q_snaps[rel], ref.q_snaps[rel])
    # scen=2: stacked chunks throughout, same answers
    two = run_problems_12_sharded(b20p, fst, cfg,
                                  make_mesh({"scen": 2, "body": 4}),
                                  tile=4, host_chunk=50)
    assert two.min_dist == ref.min_dist
    assert two.hit_time_step == ref.hit_time_step


def test_p2_early_exit_sharded_checkpoint_resume(b20p, tmp_path):
    """Preemption AFTER the sharded early-exit switch resumes
    bit-identically (the checkpoint records the P1-only phase)."""
    cfg = dataclasses.replace(SimConfig(), n_steps=400,
                              planet_radius=2.044e14, missile_speed=1e30)
    fst = oscillation_table(cfg)
    mesh = make_mesh({"scen": 1, "body": 4})
    ref = run_problems_12_sharded(b20p, fst, cfg, mesh, tile=4,
                                  host_chunk=50)
    assert ref.hit_time_step != -2

    ck = str(tmp_path / "ee_s.npz")
    cfg_partial = dataclasses.replace(cfg, n_steps=300)
    run_problems_12_sharded(b20p, oscillation_table(cfg_partial),
                            cfg_partial, mesh, tile=4, host_chunk=50,
                            checkpoint_path=ck)
    res = run_problems_12_sharded(b20p, fst, cfg, mesh, tile=4,
                                  host_chunk=50, checkpoint_path=ck)
    assert res.min_dist == ref.min_dist
    assert res.hit_time_step == ref.hit_time_step
    np.testing.assert_array_equal(res.arrivals, ref.arrivals)
