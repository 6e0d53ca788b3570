"""Scenario orchestration: the analog of the reference's `main`
(hw5.cu:532-615).

The reference spreads the three problems over two GPUs with std::thread +
mutex work stealing; here the orchestration is a handful of host-side lines
around two batched on-device scans (models/direct_sum.py). Selection of the
winning device happens on host — it is O(device_cnt) scalar work.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .config import SimConfig, DEFAULT_CONFIG
from .io import Scene
from .models.direct_sum import run_problems_12, run_problem_3
from .physics import missile_cost_for_arrival, oscillation_table


@dataclasses.dataclass
class Answers:
    min_dist: float
    hit_time_step: int
    gravity_device_id: int   # original body index of the winning device, or -1
    missile_cost: float

    def as_tuple(self):
        return (self.min_dist, self.hit_time_step, self.gravity_device_id,
                self.missile_cost)


def select_winner(scene: Scene, arrivals: np.ndarray, saved: np.ndarray,
                  cfg: SimConfig):
    """Pick the cheapest saving device.

    Cost is monotone in the arrival step, so min cost == earliest arrival;
    ties broken by file order (the reference processes scenarios sorted by
    (arrival step, slot index) and keeps the first strictly-cheaper winner,
    hw5.cu:574-585 + 512-517 — slot order is device file order). Returns
    (original body index, cost) or (-1, 0.0) as hw5.cu:598-601.
    """
    best = (-1, 0.0)
    best_key = None
    for k in range(scene.device_cnt):
        if not saved[k]:
            continue
        cost = float(missile_cost_for_arrival(cfg, arrivals[k]))
        key = (cost, int(scene.device_idx[k]))
        if best_key is None or key < best_key:
            best_key = key
            best = (int(scene.device_idx[k]), cost)
    return best


def solve_scene(scene: Scene, cfg: SimConfig = DEFAULT_CONFIG, *,
                precision: str = "f64", platform: str | None = None,
                timers=None, checkpoint_path: str | None = None,
                mesh=None, tile: int | None = None) -> Answers:
    """Answer all three problems for a scene (hw5.cu:532-615 end to end).

    precision:
      'exact' — native C++ serial core (libm pow) on the host CPU:
              byte-golden 12/12.
      'f64' — IEEE binary64 XLA scan on JAX's default backend (the GPU
              when present): the main answer path. With the default dsqrt
              dist3 resolution it is byte-golden on all 12 testcases on
              the CPU (results/ACCURACY.md); on the GPU XLA reduces the
              force rows as a tree and may contract mul+add into FMA, so
              answers agree with the native core to ulp-level noise.
              The default.
      'e64' — bit-exact binary64 softfloat built from integer lane ops
              (ops/f64emu.py) running the serial spec's op order —
              byte-identical to the native core BY CONSTRUCTION.
      'ddp' (alias 'dd+') — triple-float32 forces (~2^-70/op,
              ops/tfloat.py) with f64-grid state rounding + exact
              power-of-2 rescaling.
      'tf3' — raw triple-f32 trajectories (closer to the continuum than
              f64 itself); not the graded f64 fixpoint.
      'dd'  — f64 arrays with exact rescaling and the dsqrt dist3 form.
      'f32' — float32 fast path with rescaling; throughput mode.

    mesh: a jax.sharding.Mesh with ('scen', 'body') axes routes the whole
    solve through the sharded drivers (parallel/solver_sharded.py): the
    scenario batch spreads over 'scen' and bodies over a 'body' ppermute
    ring — the multi-chip analog of the reference's 2-GPU scenario
    distribution (hw5.cu:564-588). Supported with every non-native
    precision (f64, dd, f32, ddp, tf3, e64). f64/dd/f32 answers are
    bit-identical across mesh shapes for a fixed force tile size, ddp/tf3
    at (beyond-)f64 level, and e64 is byte-identical across mesh shapes
    unconditionally — the softfloat's serial per-row fold never
    re-associates (solver_sharded docstring).

    tile: force-accumulation j-tile size for the mesh path. The
    determinism contract is "bit-identical across mesh shapes FOR THE SAME
    tile" (solver_sharded.py): pass the same explicit tile to get bitwise
    cross-mesh-shape equality by construction. Default (None) uses each
    shard's full row block (n // body) — fastest, but a DIFFERENT
    summation order per mesh shape, so cross-shape agreement is then only
    ulp-level, not bitwise. Ignored without a mesh.
    """
    from . import backend
    from .utils.rescale import compute_rescale, IDENTITY

    if precision == "exact":
        # Native serial core: byte-golden outputs (see nbody/native.py).
        from .native import solve_exact
        md, hs, dev, cost = solve_exact(
            scene, cfg, dist3_mode=cfg.resolved_dist3("exact"))
        return Answers(min_dist=md, hit_time_step=hs, gravity_device_id=dev,
                       missile_cost=cost)

    if platform is None:
        platform = backend.default_platform_for_precision(precision)
    device = backend.device_for(platform)

    rescale = IDENTITY
    run_scene = scene
    run_cfg = dataclasses.replace(cfg,
                                  dist3_mode=cfg.resolved_dist3(precision))
    dtype: object = np.float64
    fast = False
    if precision == "dd+":
        precision = "ddp"
    if precision == "e64":
        # BIT-EXACT binary64 emulation (integer softfloat, ops/f64emu):
        # the device runs native/core.cc's op sequence with every
        # operation correctly rounded to IEEE binary64 — same answers as
        # the native oracle BY CONSTRUCTION, no rescale needed (the
        # softfloat carries the full 11-bit exponent range).
        if cfg.dist3_mode not in (None, "dsqrt"):
            raise ValueError(
                f"precision 'e64' implements only the dsqrt dist3 form "
                f"(d2 * sqrt(d2)); got dist3_mode={cfg.dist3_mode!r}. The "
                "native core validates dsqrt byte-golden against the pow "
                "goldens (results/ACCURACY.md), so nothing is lost.")
        dtype = "e64"
    elif precision in ("dd", "ddp", "tf3", "f32"):
        # the tf3 modes additionally anchor the acceleration/velocity
        # magnitudes inside the subnormal-flush-safe window (see rescale.py)
        rescale = compute_rescale(scene, eps=run_cfg.eps,
                                  anchor_accel=precision in ("ddp", "tf3"),
                                  G=run_cfg.G)
        run_scene = rescale.apply_scene(scene)
        run_cfg = rescale.apply_cfg(run_cfg)
        if precision == "f32":
            dtype = np.float32
            fast = True
        elif precision == "ddp":
            # NEAR-ANSWER-GRADE: triple-f32 force kernel (~2^-70/op,
            # ops/forces.pairwise_accel_tf3) + f64-GRID state semantics
            # (ops/tfloat.round53). The tf3 force differs from the spec's
            # f64 force by ulps, and the rare state-bit flips that leak
            # through the f64-grid rounding can chaos-amplify on the most
            # sensitive scenes; 'e64' is golden by construction.
            dtype = "tf3grid"
        elif precision == "tf3":
            # TRUTH-GRADE: raw triple-f32 trajectories, closer to the
            # continuum than IEEE f64 itself (validated against a 50-digit
            # decimal referee); NOT the graded semantics.
            dtype = "tf3"
        else:
            # dd: division form with the cheap dsqrt dist3. On hardware
            # with native fp64, 'dd' is f64 arithmetic on the rescaled
            # scene.
            run_cfg = dataclasses.replace(run_cfg, dist3_mode="dsqrt")
    elif precision != "f64":
        raise ValueError(f"unknown precision: {precision}")

    if mesh is not None:
        # e64 on the mesh: the state rides body-REPLICATED and only the
        # O(n^2) force rows split over 'body' (solver_sharded.
        # _p12_chunk_sharded_e64) — answers byte-identical to the
        # single-chip e64 path across mesh shapes BY CONSTRUCTION (the
        # spec's serial per-row fold never re-associates). The mesh twin
        # of the reference spreading the graded scenario over both GPUs
        # (hw5.cu:564-588).
        from .parallel.solver_sharded import (run_problems_12_sharded,
                                              run_problem_3_sharded)
        from .utils.padding import mesh_pad_target, pad_scene
        body = mesh.shape["body"]
        # mesh_pad_target handles the NBODY_MESH_MIN_BUCKET opt-out of the
        # size buckets for tiny-scene mesh runs whose wall is
        # COMPILE, not compute (the CPU-mesh e64 dryrun: an n=128 softfloat
        # mesh chunk takes tens of minutes of XLA:CPU compile, an n=8 one
        # takes ~a minute). Padding is semantics-exact at any size
        # (utils/padding.py header).
        n_target = mesh_pad_target(run_scene.n, body, tile)
        run_scene = pad_scene(run_scene, n_target=n_target)
        if timers is None:
            from .utils.profiling import PhaseTimers
            timers = PhaseTimers()
        fst = oscillation_table(cfg)
        with timers.phase("problem_1_2"):
            p12 = run_problems_12_sharded(run_scene, fst, run_cfg, mesh,
                                          dtype=dtype, fast=fast, tile=tile,
                                          checkpoint_path=checkpoint_path)
        gravity_device_id, missile_cost = -1, 0.0
        if p12.hit_time_step != -2 and scene.device_cnt > 0:
            with timers.phase("problem_3"):
                saved = run_problem_3_sharded(run_scene, p12, fst, run_cfg,
                                              mesh, dtype=dtype, fast=fast,
                                              tile=tile,
                                              checkpoint_path=checkpoint_path)
            gravity_device_id, missile_cost = select_winner(
                scene, p12.arrivals, saved, cfg)
        return Answers(
            min_dist=float(rescale.unscale_length(p12.min_dist)),
            hit_time_step=p12.hit_time_step,
            gravity_device_id=gravity_device_id,
            missile_cost=missile_cost)

    if device.platform != "cpu":
        # Pad to size buckets: one compiled executable per (n, device
        # count) bucket instead of one per scene (semantics-exact, see
        # utils/padding.py).
        from .utils.padding import pad_scene
        run_scene = pad_scene(run_scene)

    if timers is None:
        from .utils.profiling import PhaseTimers
        timers = PhaseTimers()

    fst = oscillation_table(cfg)
    import os as _os
    if (run_scene.device_cnt > 0 and run_scene.n <= 128
            and _os.environ.get("NBODY_P123", "auto") not in ("0", "off")):
        # Overhead-bound sizes: the FUSED P1+P2+P3 scan (direct_sum.
        # run_problems_123) — at n<=128 extra scenario rows cost little
        # next to the fixed per-step overhead, so one pass over the
        # horizon answers everything the phased path needs up to three
        # passes for. Bit-exact vs the phased path by construction
        # (tests/test_p123_fused.py).
        from .models.direct_sum import run_problems_123
        with timers.phase("problems_fused"):
            p123 = run_problems_123(run_scene, fst, run_cfg, device=device,
                                    dtype=dtype, fast=fast,
                                    checkpoint_path=checkpoint_path)
        gravity_device_id, missile_cost = -1, 0.0
        if p123.hit_time_step != -2 and scene.device_cnt > 0:
            gravity_device_id, missile_cost = select_winner(
                scene, p123.arrivals, p123.saved, cfg)
        return Answers(
            min_dist=float(rescale.unscale_length(p123.min_dist)),
            hit_time_step=p123.hit_time_step,
            gravity_device_id=gravity_device_id,
            missile_cost=missile_cost)

    with timers.phase("problem_1_2"):
        p12 = run_problems_12(run_scene, fst, run_cfg, device=device,
                              dtype=dtype, fast=fast,
                              checkpoint_path=checkpoint_path)

    gravity_device_id, missile_cost = -1, 0.0
    if p12.hit_time_step != -2 and scene.device_cnt > 0:
        with timers.phase("problem_3"):
            saved = run_problem_3(run_scene, p12, fst, run_cfg,
                                  device=device, dtype=dtype, fast=fast,
                                  checkpoint_path=checkpoint_path)
        gravity_device_id, missile_cost = select_winner(
            scene, p12.arrivals, saved, cfg)

    return Answers(
        min_dist=float(rescale.unscale_length(p12.min_dist)),
        hit_time_step=p12.hit_time_step,
        gravity_device_id=gravity_device_id,
        missile_cost=missile_cost,
    )
