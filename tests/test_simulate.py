import dataclasses
import os

import numpy as np

from nbody import SimConfig, read_input
from nbody.simulate import simulate
from nbody.utils.checkpoint import save_checkpoint, load_checkpoint

from oracle_np import run_steps

TESTCASE_DIR = "/root/reference/testcases"


def test_simulate_matches_oracle():
    scene = read_input(os.path.join(TESTCASE_DIR, "b20.in"))
    out = simulate(scene, n_steps=40, chunk=16)
    isdev = np.zeros(scene.n, bool)
    isdev[scene.device_idx] = True
    q, v = scene.q.copy(), scene.v.copy()
    for s in range(40):
        q, v, _ = run_steps(q, v, scene.m, isdev, 1, devices_on=True,
                            start_step=s)
    np.testing.assert_allclose(out.q, q, rtol=1e-12)
    assert out.step == 40


def test_simulate_chunking_invariant():
    scene = read_input(os.path.join(TESTCASE_DIR, "b20.in"))
    a = simulate(scene, n_steps=50, chunk=7)
    b = simulate(scene, n_steps=50, chunk=50)
    np.testing.assert_array_equal(a.q, b.q)  # bit-exact across chunkings
    np.testing.assert_array_equal(a.v, b.v)


def test_simulate_checkpoint_resume(tmp_path):
    scene = read_input(os.path.join(TESTCASE_DIR, "b20.in"))
    states = []
    simulate(scene, n_steps=30, chunk=10,
             on_chunk=lambda st: states.append(st))
    assert [s.step for s in states] == [10, 20, 30]

    # persist the 20-step state, resume for 10 more, compare to one-shot
    mid = states[1]
    p = str(tmp_path / "ck.npz")
    save_checkpoint(p, step=mid.step, q=mid.q, v=mid.v)
    step, q, v, _, _ = load_checkpoint(p)
    resumed = dataclasses.replace(scene, q=q, v=v)
    # NB: resuming must continue the global step index (oscillating device
    # masses depend on absolute time), so we march with a shifted table via
    # the oracle for the equivalence check instead:
    isdev = np.zeros(scene.n, bool)
    isdev[scene.device_idx] = True
    qq, vv = q.copy(), v.copy()
    for s in range(step, 30):
        qq, vv, _ = run_steps(qq, vv, scene.m, isdev, 1, devices_on=True,
                              start_step=s)
    np.testing.assert_allclose(states[2].q, qq, rtol=1e-12)


def test_simulate_tf3_matches_f64():
    """The truth-grade tf3 representation through simulate(): trajectories
    agree with f64 to far beyond f64's own rounding over a short horizon
    (and the rescale round-trips exactly)."""
    scene = read_input(os.path.join(TESTCASE_DIR, "b20.in"))
    ref = simulate(scene, n_steps=25, chunk=25, platform="cpu")
    tf3 = simulate(scene, n_steps=25, chunk=25, precision="tf3",
                   platform="cpu")
    np.testing.assert_allclose(tf3.q, ref.q, rtol=1e-13)
    np.testing.assert_allclose(tf3.v, ref.v, rtol=1e-13)


def test_simulate_leapfrog_tf3_matches_f64():
    """Leapfrog through the TF3 representation (the integrator x
    precision matrix): same 2nd-order trajectory as the
    f64 leapfrog to far beyond f64 rounding over a short horizon."""
    scene = read_input(os.path.join(TESTCASE_DIR, "b20.in"))
    ref = simulate(scene, n_steps=25, chunk=25, platform="cpu",
                   integrator="leapfrog")
    tf3 = simulate(scene, n_steps=25, chunk=25, precision="tf3",
                   platform="cpu", integrator="leapfrog")
    np.testing.assert_allclose(tf3.q, ref.q, rtol=1e-13)
    np.testing.assert_allclose(tf3.v, ref.v, rtol=1e-13)
    # and it is genuinely a different integrator than Euler
    eul = simulate(scene, n_steps=25, chunk=25, precision="tf3",
                   platform="cpu")
    assert np.max(np.abs(eul.q - tf3.q)) > 0


def test_simulate_leapfrog_e64_matches_f64():
    """Leapfrog through the bit-exact binary64 softfloat: same 2nd-order
    trajectory as the f64 leapfrog. (Not bit-identity: the f64 leapfrog
    rides the fast rsqrt/tree-reduce kernel while e64 runs the serial
    dsqrt fold — same math, different summation order, so agreement is at
    accumulated-f64-rounding level, not to the bit. Bit-identity of the
    e64 REPRESENTATION itself is pinned by the Euler test below, whose
    f64 twin runs the identical op order.)"""
    import pytest
    if not os.environ.get("RUN_SLOW"):
        pytest.skip("minutes of XLA:CPU compile; RUN_SLOW=1")
    scene = read_input(os.path.join(TESTCASE_DIR, "b20.in"))
    ref = simulate(scene, n_steps=10, chunk=10, platform="cpu",
                   integrator="leapfrog")
    e64 = simulate(scene, n_steps=10, chunk=10, precision="e64",
                   platform="cpu", integrator="leapfrog")
    np.testing.assert_allclose(e64.q, ref.q, rtol=1e-13)
    np.testing.assert_allclose(e64.v, ref.v, rtol=1e-13)


def test_simulate_e64_bit_identical_to_f64():
    """The bit-exact binary64 representation through simulate(): the final
    state must equal the f64 path's BIT FOR BIT."""
    import pytest
    if not os.environ.get("RUN_SLOW"):
        pytest.skip("minutes of XLA:CPU compile; RUN_SLOW=1 (chip_smoke.py"
                    " validates e64 end-to-end on the GPU)")
    scene = read_input(os.path.join(TESTCASE_DIR, "b20.in"))
    ref = simulate(scene, n_steps=10, chunk=10, platform="cpu")
    e64 = simulate(scene, n_steps=10, chunk=10, precision="e64",
                   platform="cpu")
    np.testing.assert_array_equal(e64.q.view(np.uint64),
                                  ref.q.view(np.uint64))
    np.testing.assert_array_equal(e64.v.view(np.uint64),
                                  ref.v.view(np.uint64))
