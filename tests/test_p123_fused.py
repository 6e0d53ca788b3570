"""Fused P1+P2+P3 scan (direct_sum.run_problems_123) vs the phased path.

The fused scan must be BIT-EXACT equal to run_problems_12 +
run_problem_3: the P3 rows' per-step select-copy from the P2 row is
exactly the snapshot+resume arithmetic (see _p123_chunk docstring).
Checked on fuzz scenes covering hit / no-hit / saved outcomes, plus
checkpoint kill-and-resume on the fused path.
"""

import dataclasses
import os

import numpy as np
import pytest

from nbody import SimConfig
from nbody.engine import solve_scene
from test_fuzz_differential import _fuzz_scene, _CFG


def _answers(scene, cfg, fused: bool, **kw):
    os.environ["NBODY_P123"] = "auto" if fused else "0"
    try:
        return solve_scene(scene, cfg, precision="f64", platform="cpu",
                           **kw)
    finally:
        os.environ.pop("NBODY_P123", None)


# seeds chosen from the fuzz corpus for outcome diversity: hits with
# saves, hits without, early hits, clean misses (test_fuzz_differential's
# coverage test guarantees the corpus has all of these)
@pytest.mark.parametrize("seed", list(range(0, 40)) + [79, 91])
def test_fused_bit_equal_to_phased(seed):
    scene = _fuzz_scene(seed)
    a = _answers(scene, _CFG, fused=True)
    b = _answers(scene, _CFG, fused=False)
    assert a.hit_time_step == b.hit_time_step
    assert a.gravity_device_id == b.gravity_device_id
    assert np.float64(a.min_dist).view(np.uint64) == \
        np.float64(b.min_dist).view(np.uint64)
    assert np.float64(a.missile_cost).view(np.uint64) == \
        np.float64(b.missile_cost).view(np.uint64)


def test_fused_outcomes_span_the_space():
    """At least one compared seed each of: saved (winner != -1), hit but
    not saved, and no hit — otherwise the equality above proves less
    than it claims."""
    outs = [_answers(_fuzz_scene(s), _CFG, fused=True)
            for s in list(range(40)) + [79, 91]]
    assert any(o.gravity_device_id != -1 for o in outs)
    assert any(o.hit_time_step != -2 and o.gravity_device_id == -1
               for o in outs)
    assert any(o.hit_time_step == -2 for o in outs)


def test_fused_checkpoint_resume_bit_identical(tmp_path):
    """Kill-and-rerun on the fused path: resuming from a mid-run
    checkpoint reproduces the uninterrupted answers bit-for-bit."""
    seed = 79                      # a seed whose answer is "saved"
    assert _answers(_fuzz_scene(seed), _CFG,
                    fused=True).gravity_device_id != -1
    scene = _fuzz_scene(seed)
    full = _answers(scene, _CFG, fused=True)

    ck = str(tmp_path / "fused.ck")
    # truncated run: half the horizon writes a checkpoint mid-phase
    half = dataclasses.replace(_CFG, n_steps=_CFG.n_steps // 2)
    os.environ["NBODY_P123"] = "auto"
    try:
        solve_scene(scene, half, precision="f64", platform="cpu",
                    checkpoint_path=ck)
    finally:
        os.environ.pop("NBODY_P123", None)
    assert os.path.exists(ck)
    resumed = _answers(scene, _CFG, fused=True, checkpoint_path=ck)
    assert resumed.hit_time_step == full.hit_time_step
    assert resumed.gravity_device_id == full.gravity_device_id
    assert np.float64(resumed.min_dist).view(np.uint64) == \
        np.float64(full.min_dist).view(np.uint64)
    assert np.float64(resumed.missile_cost).view(np.uint64) == \
        np.float64(full.missile_cost).view(np.uint64)


def test_fused_refuses_phased_checkpoint(tmp_path):
    """A checkpoint written by the phased path must not resume into the
    fused carry (different structure) — fingerprints diverge."""
    scene = _fuzz_scene(1)
    ck = str(tmp_path / "phased.ck")
    half = dataclasses.replace(_CFG, n_steps=_CFG.n_steps // 2)
    _answers(scene, half, fused=False, checkpoint_path=ck)
    assert os.path.exists(ck)
    with pytest.raises(ValueError, match="refusing to resume"):
        _answers(scene, _CFG, fused=True, checkpoint_path=ck)
