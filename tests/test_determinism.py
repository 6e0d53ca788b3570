"""Determinism: same input -> identical bits, run to run.

The property the reference lacks (fp64 atomicAdd reduction order,
hw5.cu:211-213, cost it 2/12 golden cases — SURVEY.md §4). Pure-functional
JAX with fixed-order reductions gives it by construction; these tests pin it.
"""

import dataclasses
import os

import numpy as np

from nbody import SimConfig, read_input
from nbody.models.direct_sum import run_problems_12, run_problem_3
from nbody.physics import oscillation_table

TESTCASE_DIR = "/root/reference/testcases"


def test_p12_bitwise_repeatable():
    scene = read_input(os.path.join(TESTCASE_DIR, "b30.in"))
    cfg = dataclasses.replace(SimConfig(), n_steps=300)
    fst = oscillation_table(cfg)
    a = run_problems_12(scene, fst, cfg)
    b = run_problems_12(scene, fst, cfg)
    assert a.min_dist == b.min_dist
    assert a.hit_time_step == b.hit_time_step
    np.testing.assert_array_equal(a.q_snaps, b.q_snaps)
    np.testing.assert_array_equal(a.v_snaps, b.v_snaps)


def test_p3_bitwise_repeatable():
    scene = read_input(os.path.join(TESTCASE_DIR, "b20.in"))
    cfg = dataclasses.replace(SimConfig(), n_steps=600, chunk_steps=100)
    fst = oscillation_table(cfg)
    p12 = run_problems_12(scene, fst, cfg)
    s1 = run_problem_3(scene, p12, fst, cfg)
    s2 = run_problem_3(scene, p12, fst, cfg)
    np.testing.assert_array_equal(s1, s2)


def test_chunk_size_does_not_change_p3():
    """The chunked while_loop (skip-ahead + early exit) must be bit-exact:
    any chunk size gives the same scenario outcomes."""
    scene = read_input(os.path.join(TESTCASE_DIR, "b20.in"))
    fst = oscillation_table(dataclasses.replace(SimConfig(), n_steps=600))
    outcomes = []
    for cs in (37, 100, 600, 2000):
        cfg = dataclasses.replace(SimConfig(), n_steps=600, chunk_steps=cs)
        p12 = run_problems_12(scene, fst, cfg)
        outcomes.append(list(run_problem_3(scene, p12, fst, cfg)))
    assert all(o == outcomes[0] for o in outcomes[1:])


def test_p3_sequential_equals_batched():
    """The dominance-pruned sequential strategy must agree with the batched
    strategy on the winner (and on the saved-flag of every scenario it
    evaluates before stopping)."""
    from nbody.engine import select_winner

    scene = read_input(os.path.join(TESTCASE_DIR, "b20.in"))
    cfg = dataclasses.replace(SimConfig(), n_steps=600, chunk_steps=100)
    fst = oscillation_table(cfg)
    p12 = run_problems_12(scene, fst, cfg)
    a = run_problem_3(scene, p12, fst, cfg, strategy="batched")
    b = run_problem_3(scene, p12, fst, cfg, strategy="sequential")
    assert select_winner(scene, p12.arrivals, a, cfg) == \
        select_winner(scene, p12.arrivals, b, cfg)


def test_dd_pipeline_on_cpu_equals_f64():
    """The dd pipeline (rescale + dsqrt) run on the CPU backend must give
    bit-identical answers to the plain f64 path: power-of-2 rescaling is an
    exact transform and both paths then use the same IEEE arithmetic."""
    from nbody.engine import solve_scene

    scene = read_input(os.path.join(TESTCASE_DIR, "b30.in"))
    cfg = dataclasses.replace(SimConfig(), n_steps=500)
    a = solve_scene(scene, cfg, precision="f64")
    b = solve_scene(scene, cfg, precision="dd", platform="cpu")
    assert b.min_dist == a.min_dist
    assert b.hit_time_step == a.hit_time_step
    assert b.gravity_device_id == a.gravity_device_id
