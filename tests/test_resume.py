"""Preemption-safe solve: checkpointed P12 resumes bit-identically."""

import dataclasses
import os

import numpy as np

from nbody import SimConfig, read_input
from nbody.models.direct_sum import run_problems_12
from nbody.physics import oscillation_table

TESTCASE_DIR = "/root/reference/testcases"


def test_p12_checkpoint_resume_bitexact(tmp_path):
    scene = read_input(os.path.join(TESTCASE_DIR, "b30.in"))
    cfg = dataclasses.replace(SimConfig(), n_steps=200)
    fst = oscillation_table(cfg)

    ref = run_problems_12(scene, fst, cfg)

    ck = str(tmp_path / "p12.npz")
    # "crash" after 2 chunks: run only 120 of 200 steps by lying about
    # n_steps, leaving a checkpoint at step 120
    cfg_partial = dataclasses.replace(cfg, n_steps=120)
    run_problems_12(scene, oscillation_table(cfg_partial), cfg_partial,
                    host_chunk=60, checkpoint_path=ck)
    assert os.path.exists(ck)

    # resume with the full config from the same checkpoint file
    res = run_problems_12(scene, fst, cfg, host_chunk=60,
                          checkpoint_path=ck)
    assert res.min_dist == ref.min_dist
    assert res.hit_time_step == ref.hit_time_step
    np.testing.assert_array_equal(res.arrivals, ref.arrivals)
    np.testing.assert_array_equal(res.q_snaps, ref.q_snaps)


def test_p3_checkpoint_resume_bitexact(tmp_path):
    """Kill-and-rerun mid-P3 gives bit-identical saved-masks (the
    reference's snapshot restore, hw5.cu:475-486, extended to
    disk). The inflated radius + missile speed force a hit with eligible
    arrivals so the resumed scenarios genuinely integrate."""
    from nbody.models.direct_sum import run_problem_3

    scene = read_input(os.path.join(TESTCASE_DIR, "b20.in"))
    cfg = dataclasses.replace(SimConfig(), n_steps=400,
                              planet_radius=2.044e14, missile_speed=1e30,
                              chunk_steps=50)
    fst = oscillation_table(cfg)
    p12 = run_problems_12(scene, fst, cfg)
    assert p12.hit_time_step != -2

    ref = run_problem_3(scene, p12, fst, cfg, strategy="batched")

    # "crash" after the first host iteration: host_chunks=1 runs one
    # 50-step chunk per call; interrupt by raising from a wrapped chunker
    ck = str(tmp_path / "solve.npz")
    import nbody.models.direct_sum as ds

    calls = {"n": 0}
    orig = ds._p3_chunks

    def interrupting(*a, **kw):
        calls["n"] += 1
        if calls["n"] > 2:
            raise KeyboardInterrupt("simulated preemption")
        return orig(*a, **kw)

    ds._p3_chunks = interrupting
    try:
        import pytest
        with pytest.raises(KeyboardInterrupt):
            run_problem_3(scene, p12, fst, cfg, strategy="batched",
                          host_chunks=1, checkpoint_path=ck)
    finally:
        ds._p3_chunks = orig
    assert os.path.exists(ck + ".p3.npz")

    res = run_problem_3(scene, p12, fst, cfg, strategy="batched",
                        host_chunks=1, checkpoint_path=ck)
    np.testing.assert_array_equal(res, ref)

    # sequential strategy: per-scenario progress survives too
    ck2 = str(tmp_path / "seq.npz")
    ref_seq = run_problem_3(scene, p12, fst, cfg, strategy="sequential")
    res_seq = run_problem_3(scene, p12, fst, cfg, strategy="sequential",
                            checkpoint_path=ck2)
    np.testing.assert_array_equal(res_seq, ref_seq)
    # rerun resumes from the recorded per-scenario results
    res_seq2 = run_problem_3(scene, p12, fst, cfg, strategy="sequential",
                             checkpoint_path=ck2)
    np.testing.assert_array_equal(res_seq2, ref_seq)


def test_checkpoint_refuses_mismatched_run(tmp_path):
    """Resuming with a different scene or numeric config must fail loudly,
    not silently produce wrong answers."""
    import pytest

    scene = read_input(os.path.join(TESTCASE_DIR, "b30.in"))
    cfg = dataclasses.replace(SimConfig(), n_steps=120)
    fst = oscillation_table(cfg)
    ck = str(tmp_path / "p12.npz")
    run_problems_12(scene, fst, cfg, host_chunk=60, checkpoint_path=ck)

    other_scene = read_input(os.path.join(TESTCASE_DIR, "b20.in"))
    with pytest.raises(ValueError, match="different scene"):
        run_problems_12(other_scene, fst, cfg, host_chunk=60,
                        checkpoint_path=ck)
    with pytest.raises(ValueError, match="different scene"):
        run_problems_12(scene, fst, dataclasses.replace(cfg, eps=2e-3),
                        host_chunk=60, checkpoint_path=ck)
    # a checkpoint beyond the requested horizon is also refused
    with pytest.raises(ValueError, match="beyond"):
        run_problems_12(scene, oscillation_table(cfg, 60),
                        dataclasses.replace(cfg, n_steps=60),
                        host_chunk=60, checkpoint_path=ck)


def _resume_roundtrip(dtype, tmp_path, n_steps=80):
    scene = read_input(os.path.join(TESTCASE_DIR, "b20.in"))
    from nbody.utils.rescale import compute_rescale
    cfg = dataclasses.replace(SimConfig(), n_steps=n_steps)
    if dtype != "e64":
        rs = compute_rescale(scene, eps=cfg.eps, anchor_accel=True, G=cfg.G)
        scene = rs.apply_scene(scene)
        cfg = rs.apply_cfg(cfg)
    fst = oscillation_table(cfg)
    ref = run_problems_12(scene, fst, cfg, dtype=dtype)
    ck = str(tmp_path / "ext.npz")
    cfg_partial = dataclasses.replace(cfg, n_steps=n_steps // 2)
    run_problems_12(scene, oscillation_table(cfg_partial), cfg_partial,
                    host_chunk=n_steps // 4, checkpoint_path=ck,
                    dtype=dtype)
    res = run_problems_12(scene, fst, cfg, host_chunk=n_steps // 4,
                          checkpoint_path=ck, dtype=dtype)
    assert res.min_dist == ref.min_dist
    assert res.hit_time_step == ref.hit_time_step
    np.testing.assert_array_equal(res.arrivals, ref.arrivals)
    np.testing.assert_array_equal(res.q_snaps, ref.q_snaps)


def test_ckpt_resume_tf3grid_bitexact(tmp_path):
    """The TF3 checkpoint pack/unpack round-trip (precision 'ddp') resumes
    bit-identically — gated: minutes of XLA:CPU compile for the tf3 scan."""
    import pytest
    if not os.environ.get("RUN_SLOW"):
        pytest.skip("XLA:CPU tf3 scan compile; RUN_SLOW=1")
    _resume_roundtrip("tf3grid", tmp_path)


def test_ckpt_resume_e64_bitexact(tmp_path):
    """The E64 (packed uint32) checkpoint round-trip resumes
    bit-identically — gated: minutes of XLA:CPU softfloat compile."""
    import pytest
    if not os.environ.get("RUN_SLOW"):
        pytest.skip("XLA:CPU softfloat compile; RUN_SLOW=1")
    _resume_roundtrip("e64", tmp_path, n_steps=16)


def test_ckpt_pack_roundtrip_extended_dtypes():
    """_ckpt_pack/_ckpt_unpack_fn round-trip TF3 and E64 states exactly
    (fast path-level check; the solver-level resumes are RUN_SLOW-gated)."""
    import jax.numpy as jnp

    from nbody.models.direct_sum import _ckpt_pack, _ckpt_unpack_fn
    from nbody.ops import f64emu, tfloat

    rng = np.random.default_rng(8)
    x = rng.standard_normal((4, 3))
    t = tfloat.from_f64(x)
    packed = _ckpt_pack(tfloat.TF3(*map(jnp.asarray, (t.hi, t.mid, t.lo))))
    back = _ckpt_unpack_fn("tf3grid")(packed)
    for a, b in ((back.hi, t.hi), (back.mid, t.mid), (back.lo, t.lo)):
        np.testing.assert_array_equal(np.asarray(a), b)
    e = f64emu.e64_from_f64_tree(x)
    packed = _ckpt_pack(f64emu.E64(jnp.asarray(e.hi), jnp.asarray(e.lo)))
    back = _ckpt_unpack_fn("e64")(packed)
    np.testing.assert_array_equal(np.asarray(back.hi), e.hi)
    np.testing.assert_array_equal(np.asarray(back.lo), e.lo)
    np.testing.assert_array_equal(
        f64emu.to_f64(np.asarray(back.hi), np.asarray(back.lo)), x)


def test_p12_sharded_checkpoint_resume_bitexact(tmp_path):
    """Kill-and-rerun mid-mesh-solve is bit-identical: the sharded P12 checkpoint mirrors the single-device contract and is
    portable across mesh shapes for the same tile."""
    from nbody.parallel import make_mesh
    from nbody.parallel.solver_sharded import run_problems_12_sharded
    from nbody.utils.padding import pad_scene

    scene = pad_scene(read_input(os.path.join(TESTCASE_DIR, "b20.in")),
                      n_target=32, d_target=2)
    cfg = dataclasses.replace(SimConfig(), n_steps=100)
    fst = oscillation_table(cfg)
    mesh = make_mesh({"scen": 2, "body": 4})

    ref = run_problems_12_sharded(scene, fst, cfg, mesh, tile=4)

    ck = str(tmp_path / "p12s.npz")
    cfg_partial = dataclasses.replace(cfg, n_steps=60)
    run_problems_12_sharded(scene, oscillation_table(cfg_partial),
                            cfg_partial, mesh, tile=4, host_chunk=30,
                            checkpoint_path=ck)
    assert os.path.exists(ck)

    # resume on a DIFFERENT mesh shape (same tile): still bit-identical
    mesh2 = make_mesh({"scen": 1, "body": 8})
    res = run_problems_12_sharded(scene, fst, cfg, mesh2, tile=4,
                                  host_chunk=30, checkpoint_path=ck)
    assert res.min_dist == ref.min_dist
    assert res.hit_time_step == ref.hit_time_step
    np.testing.assert_array_equal(res.arrivals, ref.arrivals)
    np.testing.assert_array_equal(res.q_snaps, ref.q_snaps)
    np.testing.assert_array_equal(res.v_snaps, ref.v_snaps)

    # a different tile is a different trajectory: refuse to resume
    import pytest
    with pytest.raises(ValueError, match="refusing to resume"):
        run_problems_12_sharded(scene, fst, cfg, mesh2, tile=8,
                                checkpoint_path=ck)


def test_p3_sharded_checkpoint_resume_bitexact(tmp_path):
    """Mid-P3 preemption on the mesh resumes bit-identically."""
    from nbody.models.direct_sum import run_problems_12
    from nbody.parallel import make_mesh
    from nbody.parallel.solver_sharded import run_problem_3_sharded
    from nbody.utils.padding import pad_scene

    scene = pad_scene(read_input(os.path.join(TESTCASE_DIR, "b20.in")),
                      n_target=32, d_target=2)
    cfg = dataclasses.replace(SimConfig(), n_steps=400,
                              planet_radius=2.044e14, missile_speed=1e30,
                              chunk_steps=50)
    fst = oscillation_table(cfg)
    p12 = run_problems_12(scene, fst, cfg)
    assert p12.hit_time_step != -2
    mesh = make_mesh({"scen": 2, "body": 4})

    ref = run_problem_3_sharded(scene, p12, fst, cfg, mesh, tile=4)

    ck = str(tmp_path / "solve_s.npz")
    import nbody.parallel.solver_sharded as ss

    calls = {"n": 0}
    orig = ss._p3_chunks_sharded

    def interrupting(*a, **kw):
        calls["n"] += 1
        if calls["n"] > 2:
            raise KeyboardInterrupt("simulated preemption")
        return orig(*a, **kw)

    ss._p3_chunks_sharded = interrupting
    try:
        import pytest
        with pytest.raises(KeyboardInterrupt):
            run_problem_3_sharded(scene, p12, fst, cfg, mesh, tile=4,
                                  host_chunks=1, checkpoint_path=ck)
    finally:
        ss._p3_chunks_sharded = orig
    assert os.path.exists(ck + ".p3.npz")

    res = run_problem_3_sharded(scene, p12, fst, cfg, mesh, tile=4,
                                host_chunks=1, checkpoint_path=ck)
    np.testing.assert_array_equal(res, ref)
