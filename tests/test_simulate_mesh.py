"""simulate() on the mesh (the precision x mesh x integrator matrix). The chunk scan rides shard_map — bodies on the
ordered ppermute ring (native dtypes / tf3) or force rows split with
replicated state (e64) — with device-mass oscillation and the on_chunk
checkpoint hook intact."""

import dataclasses
import os

import numpy as np
import pytest

from nbody import SimConfig, read_input
from nbody.parallel import make_mesh
from nbody.simulate import simulate

TESTCASE_DIR = "/root/reference/testcases"


@pytest.fixture(scope="module")
def scene():
    return read_input(os.path.join(TESTCASE_DIR, "b20.in"))


@pytest.mark.parametrize("integrator", ["euler", "leapfrog"])
def test_simulate_mesh_matches_single_device_f64(scene, integrator):
    single = simulate(scene, n_steps=40, chunk=16, platform="cpu",
                      integrator=integrator)
    mesh = simulate(scene, n_steps=40, chunk=16, integrator=integrator,
                    mesh=make_mesh({"body": 4}), tile=5)
    np.testing.assert_allclose(mesh.q, single.q, rtol=1e-12)
    np.testing.assert_allclose(mesh.v, single.v, rtol=1e-12)
    assert mesh.step == 40


def test_simulate_mesh_bitwise_invariant_across_shapes(scene):
    """Same tile => bit-identical trajectories on 1-, 2- and 8-shard
    meshes (the ordered-ring contract of parallel/solver_sharded)."""
    runs = [simulate(scene, n_steps=30, chunk=30,
                     mesh=make_mesh({"body": b}), tile=5)
            for b in (1, 2, 4)]
    for r in runs[1:]:
        np.testing.assert_array_equal(r.q, runs[0].q)
        np.testing.assert_array_equal(r.v, runs[0].v)


@pytest.mark.parametrize("integrator", ["euler", "leapfrog"])
def test_simulate_mesh_tf3(scene, integrator):
    """tf3 on the mesh agrees with single-device tf3 far beyond f64
    rounding (same gauged tile kernel, mesh-global mass gauge)."""
    single = simulate(scene, n_steps=20, chunk=20, precision="tf3",
                      platform="cpu", integrator=integrator)
    mesh = simulate(scene, n_steps=20, chunk=20, precision="tf3",
                    mesh=make_mesh({"body": 4}), tile=5,
                    integrator=integrator)
    np.testing.assert_allclose(mesh.q, single.q, rtol=1e-13)
    np.testing.assert_allclose(mesh.v, single.v, rtol=1e-13)


def test_simulate_mesh_f32_and_dd(scene):
    for prec in ("f32", "dd"):
        single = simulate(scene, n_steps=20, chunk=20, precision=prec,
                          platform="cpu")
        mesh = simulate(scene, n_steps=20, chunk=20, precision=prec,
                        mesh=make_mesh({"body": 2}), tile=10)
        rtol = 1e-5 if prec == "f32" else 1e-12
        np.testing.assert_allclose(mesh.q, single.q, rtol=rtol)


def test_simulate_mesh_on_chunk_and_devices_off(scene):
    steps = []
    simulate(scene, n_steps=30, chunk=10, mesh=make_mesh({"body": 2}),
             devices_on=False, on_chunk=lambda st: steps.append(st.step))
    assert steps == [10, 20, 30]


def test_simulate_mesh_e64_bit_identical_to_single_device():
    """The answer-grade softfloat through simulate(mesh=...): BIT-identical
    to the single-device e64 run (the serial per-row fold never
    re-associates; row splitting is exact by construction)."""
    if not os.environ.get("RUN_SLOW"):
        pytest.skip("minutes of XLA:CPU softfloat compile; RUN_SLOW=1")
    full = read_input(os.path.join(TESTCASE_DIR, "b20.in"))
    keep = np.arange(6)
    remap = {int(b): i for i, b in enumerate(keep)}
    scene = dataclasses.replace(
        full, n=6, planet=min(full.planet, 5), asteroid=min(full.asteroid, 4),
        q=full.q[keep], v=full.v[keep], m=full.m[keep],
        types=[full.types[i] for i in keep],
        device_idx=np.asarray([i for i in full.device_idx if i < 6],
                              dtype=np.int64))
    single = simulate(scene, n_steps=8, chunk=8, precision="e64",
                      platform="cpu")
    mesh = simulate(scene, n_steps=8, chunk=8, precision="e64",
                    mesh=make_mesh({"body": 2}))
    np.testing.assert_array_equal(mesh.q.view(np.uint64),
                                  single.q.view(np.uint64))
    np.testing.assert_array_equal(mesh.v.view(np.uint64),
                                  single.v.view(np.uint64))
    # leapfrog cell of the matrix: mesh vs single-device e64 leapfrog
    slf = simulate(scene, n_steps=8, chunk=8, precision="e64",
                   platform="cpu", integrator="leapfrog")
    mlf = simulate(scene, n_steps=8, chunk=8, precision="e64",
                   mesh=make_mesh({"body": 2}), integrator="leapfrog")
    np.testing.assert_array_equal(mlf.q.view(np.uint64),
                                  slf.q.view(np.uint64))


def test_simulate_mesh_f32_kahan(scene):
    """Kahan compensation on the mesh f32 path: (a) compensated runs are bit-identical across mesh shapes for the
    same tile (the compensation is per-body local state riding the same
    ordered-ring arithmetic); (b) against the f64 reference trajectory,
    the compensated mesh run tracks at least as well as the plain one
    and strictly better over a long-horizon drift window — the mesh twin
    of the single-device study (scripts/study_f32_horizon.py)."""
    steps, tile = 600, 5
    runs = [simulate(scene, n_steps=steps, chunk=300, precision="f32",
                     mesh=make_mesh({"body": b}), tile=tile,
                     compensated=True)
            for b in (1, 4)]
    np.testing.assert_array_equal(runs[0].q, runs[1].q)
    np.testing.assert_array_equal(runs[0].v, runs[1].v)

    plain = simulate(scene, n_steps=steps, chunk=300, precision="f32",
                     mesh=make_mesh({"body": 4}), tile=tile,
                     compensated=False)
    ref = simulate(scene, n_steps=steps, chunk=300, platform="cpu")
    scale = np.abs(ref.q).max()
    err_comp = np.abs(runs[1].q - ref.q).max() / scale
    err_plain = np.abs(plain.q - ref.q).max() / scale
    # compensation must never hurt, and over this horizon the plain f32
    # accumulation has measurably drifted (single-device study: plain
    # drifts linearly, compensated holds the representation floor)
    assert err_comp <= err_plain * 1.05
    assert err_comp < 1e-5


def test_simulate_mesh_rejects_compensated_extended():
    import pytest as _pytest
    sc = read_input(os.path.join(TESTCASE_DIR, "b20.in"))
    with _pytest.raises(ValueError, match="compensated"):
        simulate(sc, n_steps=4, chunk=4, precision="tf3",
                 mesh=make_mesh({"body": 2}), tile=5, compensated=True)
