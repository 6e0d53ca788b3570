"""Direct-summation N-body model: the flagship simulator.

Replaces the reference's scenario runners with batched on-device loops:

  * `run_problems_12` — the analog of `t_problem_12` for BOTH GPUs at
    once (hw5.cu:322-436): Problem 1 (devices off) and Problem 2 (devices on)
    are a stacked batch of 2 scenarios marching in one `lax.scan`. The scan
    carry tracks the running min planet-asteroid distance (replaces the
    <<<1,1>>> kernel calc_sq_min_dist_gpu, hw5.cu:241-252), the first hit
    step (calc_hit_time_step_gpu, hw5.cu:254-263), and per-device missile
    arrival steps + full (q, v) state snapshots (problem3_preprocess_gpu,
    hw5.cu:265-287).

  * `run_problem_3` — the analog of the work-stealing `t_problem_3`
    (hw5.cu:438-530): all device-destruction scenarios run as ONE batched
    chunked while_loop, each scenario masked inactive until its
    missile-arrival step, with exact skip-ahead to the earliest arrival and
    early exit once every eligible scenario is decided. Batching replaces
    the mutex+shared-counter scheduler and the PROBLEM3_BREAK pruning.

Both drivers split the 200001 steps into fixed host-level chunks of device
work (bit-exact: the carry passes through unchanged): the chunk boundaries
are the host's checkpoint points and where the P2 early exit acts. Within a
chunk there are zero host round-trips; the reference needs a D2H sync every
2000 steps (hw5.cu:398-402).

All fp64 comparisons/updates follow the reference's exact semantics: strict
`<` for min/hit/arrival, step-0 inclusion for the min distance and hit check,
arrival impossible at step 0 (missile distance is 0).
"""

from __future__ import annotations

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..config import SimConfig
from ..ops import f64emu, tfloat
from ..ops.f64emu import E64
from ..ops.integrate import symplectic_euler_step
from ..ops.tfloat import TF3

# Steps per host chunk of the P1/P2 and fused drivers (bit-exact for any
# value; see the module docstring).
HOST_CHUNK_STEPS = 25000


def _on_accelerator(device) -> bool:
    return device is not None and getattr(device, "platform", "cpu") != "cpu"


def _guard_finite(*arrays, context: str = "") -> None:
    """Fail loudly if an accelerated (rescaled, f32-range) run overflowed.

    compute_rescale's growth_margin is a heuristic; if a scene's orbits
    expand past it, intermediates go inf -> NaN and every downstream answer
    is garbage. Checked once per host chunk — negligible cost, loud failure.
    """
    ok = True
    for a in arrays:
        if isinstance(a, E64):
            ok = ok & f64emu.is_finite_e(a).all()
            continue
        for leaf in jax.tree.leaves(a):
            ok = ok & jnp.isfinite(leaf).all()
    if not bool(np.asarray(ok)):
        raise FloatingPointError(
            f"non-finite simulation state {context}: the rescaled f32-range "
            "pipeline overflowed — orbital growth exceeded the rescale "
            "window (utils/rescale.py growth_margin). Rerun with a larger "
            "growth_margin or precision='f64'.")


def _solver_fingerprint(scene, cfg: SimConfig, dtype, fast: bool) -> str:
    """Digest of everything that determines the solver carry's meaning;
    resuming a checkpoint written under a different scene/config/precision
    would silently produce wrong answers. n_steps is deliberately excluded:
    the carry at step t is valid for any continuation length >= t (resuming
    a truncated run with the full horizon IS the preemption pattern)."""
    import hashlib
    h = hashlib.sha256()
    for arr in (scene.q, scene.v, scene.m, np.asarray(scene.device_idx)):
        h.update(np.ascontiguousarray(arr).tobytes())
    dtype_name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    h.update(repr((scene.n, scene.planet, scene.asteroid,
                   cfg.dt, cfg.eps, cfg.G, cfg.planet_radius,
                   cfg.missile_speed, cfg.dist3_mode, dtype_name,
                   bool(fast))).encode())
    return h.hexdigest()


def _sq_dist(qa, qb, grid: bool = False):
    """Squared distance with the serial spec's fp64 op order
    (dx*dx + dy*dy + dz*dz, samples/nbody.cc:118-121). Works on plain
    arrays and TF3 triples (operator overloads).

    grid=True (TF3 'ddp' semantics): round every operation to the f64
    grid so the decision quantities (min distance, hit, arrival) follow
    the exact f64 op sequence — see ops/tfloat.round53."""
    if grid and isinstance(qa, TF3):
        r = tfloat.round53
        d = qa - qb
        dx, dy, dz = (r(d[..., k]) for k in range(3))
        return r(r(r(dx * dx) + r(dy * dy)) + r(dz * dz))
    d = qa - qb
    # bind each component once: for TF3 operands `dk * dk` must see the
    # SAME object so tfloat.mul routes to sqr() (fresh objects per indexing
    # would use two_prod3, whose equal cross products XLA CSEs and
    # reassociates into a ~2^-48 square under jit — two_sq3 docstring)
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    return dx * dx + dy * dy + dz * dz


def _select(pred, a, b):
    """jnp.where generalized over the numeric representation."""
    if isinstance(a, TF3):
        return tfloat.where(pred, a, b)
    if isinstance(a, E64):
        return f64emu.where_e(pred, a, b)
    return jnp.where(pred, a, b)


def _minimum(a, b):
    if isinstance(a, TF3):
        return tfloat.minimum(a, b)
    if isinstance(a, E64):
        return f64emu.minimum_e(a, b)
    return jnp.minimum(a, b)


@dataclasses.dataclass
class P12Result:
    min_dist: float            # Problem 1 answer
    hit_time_step: int         # Problem 2 answer (-2 if never)
    arrivals: np.ndarray       # (D,) missile-arrival step per device, -2 if never
    q_snaps: np.ndarray        # (D, n, 3) state snapshot at each arrival
    v_snaps: np.ndarray        # (D, n, 3)
    # full-precision snapshots for the extended-precision ('ddp') path: the
    # f64 views above lose ~19 of the triple's 72 bits, which would
    # re-inject f64-class noise at the P3 resume point
    q_snaps_tf: TF3 | None = None
    v_snaps_tf: TF3 | None = None


def _is_tf_dtype(dtype) -> bool:
    """Both triple-f32 modes: 'tf3grid' (answer-grade f64-grid state
    semantics — precision 'ddp') and 'tf3' (truth-grade raw
    trajectories)."""
    return isinstance(dtype, str) and dtype in ("tf3", "tf3grid")


def _is_grid(dtype) -> bool:
    return isinstance(dtype, str) and dtype == "tf3grid"


def _is_e64(dtype) -> bool:
    """The bit-exact softfloat binary64 path (precision 'e64')."""
    return isinstance(dtype, str) and dtype == "e64"


def _is_ext(dtype) -> bool:
    """Any non-native numeric representation (triple-f32 or softfloat)."""
    return _is_tf_dtype(dtype) or _is_e64(dtype)


def _make_converter(dtype):
    """Host f64 array -> runtime representation (numpy cast, exact TF3
    split, or exact packed-binary64 E64)."""
    if _is_tf_dtype(dtype):
        return lambda a: tfloat.from_f64(np.asarray(a, np.float64))
    if _is_e64(dtype):
        return lambda a: f64emu.e64_from_f64_tree(np.asarray(a, np.float64))
    return lambda a: np.asarray(a, dtype)


def _host_tf(x: TF3) -> TF3:
    return TF3(np.asarray(x.hi), np.asarray(x.mid), np.asarray(x.lo))


def _ckpt_unpack_fn(dtype):
    """Inverse of _ckpt_pack for the given dtype."""
    if _is_tf_dtype(dtype):
        return lambda a: TF3(a[0], a[1], a[2])
    if _is_e64(dtype):
        return lambda a: E64(a[0], a[1])
    return lambda a: a


def _ckpt_pack(x):
    """Checkpoint representation: TF3 -> stacked (3, ...) components;
    E64 -> stacked (2, ...) uint32 components."""
    if isinstance(x, TF3):
        return np.stack([np.asarray(x.hi), np.asarray(x.mid),
                         np.asarray(x.lo)])
    if isinstance(x, E64):
        return np.stack([np.asarray(x.hi), np.asarray(x.lo)])
    return np.asarray(x)


@functools.partial(
    jax.jit,
    static_argnames=("n_steps", "dt", "eps", "G", "planet_radius",
                     "missile_speed", "dist3_mode", "planet", "asteroid",
                     "fast", "f64_grid"),
)
def _p12_chunk(q, v, min_d2, hit, arr, q_snap, v_snap, m0_s, m_half, dev_idx,
               fst_chunk, t0, *, n_steps, dt, eps, G, planet_radius,
               missile_speed, dist3_mode, planet, asteroid, fast=False,
               f64_grid=False):
    """Advance the stacked P1/P2 state over steps (t0, t0+len(fst_chunk)].
    Steps beyond n_steps are masked to the identity, so a ragged final chunk
    is bit-exact. The numeric type of q (plain f64/f32 array or TF3 triple)
    selects the arithmetic throughout."""
    is_tf = isinstance(q, TF3)
    is_e64 = isinstance(q, E64)
    if is_tf:
        pr = tfloat.const(planet_radius)
        r2 = pr * pr
        sdt = tfloat.const(missile_speed * dt)
    elif is_e64:
        # host f64 squares/products are the same fl64 values the spec
        # computes (core.cc:149, 170)
        r2 = f64emu.const_e(float(planet_radius) * float(planet_radius))
        sdt = f64emu.const_e(float(missile_speed) * float(dt))
    else:
        f64 = q.dtype
        r2 = planet_radius * planet_radius
        sdt = missile_speed * dt                              # 6e7, exact

    offs = jnp.arange(1, fst_chunk.shape[0] + 1, dtype=jnp.int32)
    xs = (t0.astype(jnp.int32) + offs, fst_chunk)

    def body(carry, x):
        q, v, min_d2, hit, arr, q_snap, v_snap = carry
        t, fst_t = x
        in_range = t <= jnp.int32(n_steps)
        m_eff = m0_s + m_half * fst_t
        q2, v2 = symplectic_euler_step(q, v, m_eff, G=G, eps=eps, dt=dt,
                                       dist3_mode=dist3_mode, fast=fast,
                                       f64_grid=f64_grid)
        q = _select(in_range, q2, q)
        v = _select(in_range, v2, v)
        # Problem 1: running min on the devices-off scenario.
        d2_pa0 = _sq_dist(q[0, planet], q[0, asteroid], grid=f64_grid)
        min_d2 = _select(in_range, _minimum(min_d2, d2_pa0), min_d2)
        # Problem 3 preprocessing runs before the hit check each step
        # (hw5.cu:396-397); they are independent. Arrival: the expanding
        # missile sphere around the planet's CURRENT position first contains
        # the device (hw5.cu:270-274).
        d2_pd = _sq_dist(q[1, planet], q[1, dev_idx], grid=f64_grid)  # (D,)
        if is_tf:
            tt = t.astype(jnp.float32)                        # t < 2^24: exact
            md = sdt * TF3(tt, jnp.zeros_like(tt), jnp.zeros_like(tt))
            md2 = md * md
            if f64_grid:   # sdt is exact in f64, so md needs no rounding
                md2 = tfloat.round53(md2)
        elif is_e64:
            # md = fl(sdt * step); compare against fl(md * md) (core.cc:175)
            md = sdt * E64(*f64emu.from_i32(t))
            md2 = md * md
        else:
            md = sdt * t.astype(f64)
            md2 = md * md
        arrived = (arr == -2) & (d2_pd < md2) & in_range
        arr = jnp.where(arrived, t, arr)
        sel = arrived[:, None, None]
        q_snap = _select(sel, q[1][None], q_snap)
        v_snap = _select(sel, v[1][None], v_snap)
        # Problem 2: first hit step, guarded like hw5.cu:255.
        d2_pa = _sq_dist(q[1, planet], q[1, asteroid], grid=f64_grid)
        hit = jnp.where((hit == -2) & (d2_pa < r2) & in_range, t, hit)
        return (q, v, min_d2, hit, arr, q_snap, v_snap), None

    carry = (q, v, min_d2, hit, arr, q_snap, v_snap)
    carry, _ = lax.scan(body, carry, xs)
    return carry


def _bcast_row(x, row: int):
    """Row `row` of a leading-batch array/TF3/E64 broadcast to the full
    batch shape (used to mirror the P2 state into pending P3 rows)."""
    if isinstance(x, TF3):
        return TF3(*(jnp.broadcast_to(c[row:row + 1], c.shape)
                     for c in (x.hi, x.mid, x.lo)))
    if isinstance(x, E64):
        return E64(jnp.broadcast_to(x.hi[row:row + 1], x.hi.shape),
                   jnp.broadcast_to(x.lo[row:row + 1], x.lo.shape))
    return jnp.broadcast_to(x[row:row + 1], x.shape)


@functools.partial(
    jax.jit,
    static_argnames=("n_steps", "dt", "eps", "G", "planet_radius",
                     "missile_speed", "dist3_mode",
                     "fast", "f64_grid"),
)
def _p123_chunk(q, v, min_d2, hit, arr, p3_hit, m0_s, m_half, dev_idx,
                fst_chunk, t0, planet, asteroid, *, n_steps, dt, eps, G,
                planet_radius, missile_speed, dist3_mode, fast=False,
                f64_grid=False):
    """FUSED Problems 1+2+3: one scan over rows [P1, P2, P3_0..P3_{D-1}].

    The reference runs Problem 3 as snapshot-and-resume AFTER Problem 2
    (hw5.cu:265-287 snapshots, 438-530 resumes), overlapping only P1 with
    P3 across its two GPUs (hw5.cu:566 vs the late join at :604). Here
    the P3 scenarios march IN THE SAME scan: each P3 row is overwritten
    with the P2 row's state every step until its missile arrives (the
    per-step select IS the snapshot — copying the post-update P2 state at
    the arrival step reproduces problem3_preprocess_gpu's snapshot
    exactly), then evolves with its device's mass zeroed — identical
    arithmetic to the resumed simulation, so answers are bit-exact vs the
    phased path while the whole solve makes ONE pass over the horizon.

    Why: at small n the per-step cost is fixed overhead (launches, loop
    control), so extra scenario rows cost little, while the phased path
    pays that fixed cost 2-3 times over (P12 to the hit, the P1 tail,
    then P3); fused pays it once.

    q, v: (2+D, n, 3); m0_s/m_half: (2+D, n) — row 0 devices-off, row 1
    devices-on, row 2+k devices-on with device k's mass zeroed.
    arr: (D,) arrival steps (-2 pending); p3_hit: (D,) bool.
    """
    is_tf = isinstance(q, TF3)
    is_e64 = isinstance(q, E64)
    if is_tf:
        pr = tfloat.const(planet_radius)
        r2 = pr * pr
        sdt = tfloat.const(missile_speed * dt)
    elif is_e64:
        r2 = f64emu.const_e(float(planet_radius) * float(planet_radius))
        sdt = f64emu.const_e(float(missile_speed) * float(dt))
    else:
        f64 = q.dtype
        r2 = planet_radius * planet_radius
        sdt = missile_speed * dt

    D = arr.shape[0]
    offs = jnp.arange(1, fst_chunk.shape[0] + 1, dtype=jnp.int32)
    xs = (t0.astype(jnp.int32) + offs, fst_chunk)

    def body(carry, x):
        q, v, min_d2, hit, arr, p3_hit = carry
        t, fst_t = x
        in_range = t <= jnp.int32(n_steps)
        pending = arr == -2                     # pre-update arrival state
        m_eff = m0_s + m_half * fst_t
        q2, v2 = symplectic_euler_step(q, v, m_eff, G=G, eps=eps, dt=dt,
                                       dist3_mode=dist3_mode, fast=fast,
                                       f64_grid=f64_grid)
        q = _select(in_range, q2, q)
        v = _select(in_range, v2, v)
        # Problem 1 (row 0): running min.
        d2_pa0 = _sq_dist(q[0, planet], q[0, asteroid], grid=f64_grid)
        min_d2 = _select(in_range, _minimum(min_d2, d2_pa0), min_d2)
        # Arrivals against the P2 row's CURRENT planet (hw5.cu:270-274).
        d2_pd = _sq_dist(q[1, planet], q[1, dev_idx], grid=f64_grid)  # (D,)
        if is_tf:
            tt = t.astype(jnp.float32)
            md = sdt * TF3(tt, jnp.zeros_like(tt), jnp.zeros_like(tt))
            md2 = md * md
            if f64_grid:
                md2 = tfloat.round53(md2)
        elif is_e64:
            md = sdt * E64(*f64emu.from_i32(t))
            md2 = md * md
        else:
            md = sdt * t.astype(f64)
            md2 = md * md
        arrived = pending & (d2_pd < md2) & in_range
        arr = jnp.where(arrived, t, arr)
        # Mirror the P2 state into still-pending AND just-arrived P3 rows
        # (post-update, exactly problem3_preprocess_gpu's snapshot at the
        # arrival step; rows arrived earlier keep their own evolution).
        # (out-of-range steps: q[1] is frozen and pending rows already
        # mirror it, so the copy is a no-op — ragged final chunks exact)
        copy_rows = jnp.concatenate([jnp.zeros((2,), bool), pending])
        q = _select(copy_rows[:, None, None], _bcast_row(q, 1), q)
        v = _select(copy_rows[:, None, None], _bcast_row(v, 1), v)
        # P3 hit checks: from the arrival step onward (at t == arr the
        # state is the fresh snapshot — the resume-step check of
        # missile_cost_gpu, hw5.cu:292-298).
        d2_pa3 = _sq_dist(q[2:, planet], q[2:, asteroid], grid=f64_grid)
        p3_hit = p3_hit | ((arr != -2) & (d2_pa3 < r2) & in_range)
        # Problem 2 hit (row 1), guarded like hw5.cu:255.
        d2_pa = _sq_dist(q[1, planet], q[1, asteroid], grid=f64_grid)
        hit = jnp.where((hit == -2) & (d2_pa < r2) & in_range, t, hit)
        return (q, v, min_d2, hit, arr, p3_hit), None

    carry = (q, v, min_d2, hit, arr, p3_hit)
    carry, _ = lax.scan(body, carry, xs)
    return carry


@functools.partial(
    jax.jit,
    static_argnames=("n_steps", "dt", "eps", "G", "dist3_mode", "planet",
                     "asteroid", "fast", "f64_grid"),
)
def _p1_chunk(q, v, min_d2, fst_chunk, t0, m0_row, m_half_row, *, n_steps,
              dt, eps, G, dist3_mode, planet, asteroid, fast=False,
              f64_grid=False):
    """Devices-off (Problem 1) row alone: the post-hit continuation of
    _p12_chunk once Problem 2's answer is settled (the reference breaks
    out of its devices-on loop at the hit, hw5.cu:398-402; the serial spec
    too, samples/nbody.cc:133-137 / native/core.cc:183). Bit-exact: the
    P1 row's arithmetic is identical to its row inside the stacked chunk
    (the scenario batch is elementwise), only the dead P2 row's work is
    dropped. q/v: (1, n, 3) — the devices-off scenario row."""
    offs = jnp.arange(1, fst_chunk.shape[0] + 1, dtype=jnp.int32)
    xs = (t0.astype(jnp.int32) + offs, fst_chunk)

    def body(carry, x):
        q, v, min_d2 = carry
        t, fst_t = x
        in_range = t <= jnp.int32(n_steps)
        m_eff = m0_row + m_half_row * fst_t
        q2, v2 = symplectic_euler_step(q, v, m_eff, G=G, eps=eps, dt=dt,
                                       dist3_mode=dist3_mode, fast=fast,
                                       f64_grid=f64_grid)
        q = _select(in_range, q2, q)
        v = _select(in_range, v2, v)
        d2_pa0 = _sq_dist(q[0, planet], q[0, asteroid], grid=f64_grid)
        min_d2 = _select(in_range, _minimum(min_d2, d2_pa0), min_d2)
        return (q, v, min_d2), None

    carry, _ = lax.scan(body, (q, v, min_d2), xs)
    return carry


def run_problems_12(scene, fst: np.ndarray, cfg: SimConfig, *, device=None,
                    dtype=np.float64, fast: bool = False,
                    host_chunk: int | None = None,
                    checkpoint_path: str | None = None) -> P12Result:
    """Run Problems 1+2 (and Problem-3 preprocessing) for a Scene.

    `device` commits the computation to a specific backend (jit follows the
    placement of its committed inputs); `dtype`/`fast` select the numeric
    path (see backend.py). `host_chunk` bounds steps per device call
    (default: HOST_CHUNK_STEPS; bit-exact regardless).

    `checkpoint_path`: persist the full solver carry after every chunk and
    resume from it if the file already exists — preemption-safe long runs
    (crash anywhere, rerun the same command, get bit-identical answers).
    """
    n = scene.n
    is_tf = _is_tf_dtype(dtype)
    is_ext = _is_ext(dtype)
    conv = _make_converter(dtype)
    put = functools.partial(jax.device_put, device=device)
    host_dtype = np.float64 if is_ext else dtype
    q0 = np.asarray(scene.q, dtype=host_dtype)
    v0 = np.asarray(scene.v, dtype=host_dtype)
    m0 = np.asarray(scene.m, dtype=host_dtype)
    mask = np.asarray(scene.device_mask(), dtype=host_dtype)
    D = scene.device_cnt

    # Scenario stack: row 0 = devices off (Problem 1, clear_device_m_gpu
    # hw5.cu:217-222), row 1 = devices on (Problem 2).
    m0_s = put(conv(np.stack([m0 * (1.0 - mask), m0])))
    m_half = put(conv(0.5 * np.stack([m0 * (1.0 - mask), m0])
                      * mask[None, :]))
    dev_idx = put(np.asarray(scene.device_idx, dtype=np.int32))
    fstd = np.asarray(fst, dtype=host_dtype)

    # Step-0 checks (loops include step 0: hw5.cu:368/387 run the check
    # kernels before any update).
    d0 = q0[scene.planet] - q0[scene.asteroid]
    d2_0 = d0[0] * d0[0] + d0[1] * d0[1] + d0[2] * d0[2]
    r2 = np.asarray(cfg.planet_radius, dtype=host_dtype) ** 2

    carry = (
        put(conv(np.stack([q0, q0]))),
        put(conv(np.stack([v0, v0]))),
        put(conv(np.asarray(d2_0))),
        put(np.int32(0 if d2_0 < r2 else -2)),
        put(np.full((D,), -2, dtype=np.int32)),
        put(conv(np.zeros((D, n, 3)))),
        put(conv(np.zeros((D, n, 3)))),
    )

    on_accel = _on_accelerator(device)
    if host_chunk is None:
        host_chunk = min(cfg.n_steps, HOST_CHUNK_STEPS)
    t0 = 0
    # P2 early exit (hw5.cu:398-402; native/core.cc:183): once the hit is
    # found, the devices-on row's remaining evolution can only produce
    # arrivals AFTER the hit — all ineligible for Problem 3
    # (run_problem_3's `arrival <= hit` filter) — so at the next chunk
    # boundary the driver drops to the P1-only chunk. Bit-exact for every
    # answer; the only observable difference is that post-hit arrivals
    # report -2 instead of a step > hit (both mean "cannot save").
    hit_h = int(np.asarray(carry[3]))
    p1_carry = None                     # (q, v, min_d2) after the switch
    p2_frozen = None                    # (hit, arr, q_snap, v_snap)
    if checkpoint_path is not None:
        import os
        from ..utils.checkpoint import load_checkpoint, save_checkpoint
        fingerprint = _solver_fingerprint(scene, cfg, dtype, fast)
        if os.path.exists(checkpoint_path):
            step, qc, vc, extra, meta = load_checkpoint(checkpoint_path)
            if meta.get("fingerprint") != fingerprint:
                raise ValueError(
                    f"checkpoint {checkpoint_path} was written for a "
                    "different scene/config/precision — refusing to resume "
                    "(delete it or pass a fresh path)")
            t0 = int(step)
            if t0 > cfg.n_steps:
                raise ValueError(
                    f"checkpoint {checkpoint_path} is at step {t0}, beyond "
                    f"this run's horizon n_steps={cfg.n_steps}")
            unpack = _ckpt_unpack_fn(dtype)
            carry = (put(unpack(qc)), put(unpack(vc)),
                     put(unpack(extra["min_d2"])),
                     put(extra["hit"].astype(np.int32)),
                     put(extra["arr"].astype(np.int32)),
                     put(unpack(extra["q_snap"])),
                     put(unpack(extra["v_snap"])))
            hit_h = int(extra["hit"])
    while t0 < cfg.n_steps:
        if hit_h != -2 and p1_carry is None:
            # switch: freeze the decided P2-row answers, keep only the
            # devices-off row marching
            qd, vd, min_d2, hit, arr, q_snap, v_snap = carry
            p2_frozen = (hit, arr, q_snap, v_snap)
            p1_carry = (qd[0:1], vd[0:1], min_d2)
        hc = host_chunk
        cs = min(hc, cfg.n_steps - t0)
        # reuse compiled signatures: always pass hc-long fst slices (padded
        # at the tail; masked in-kernel)
        fst_chunk = np.zeros(hc, dtype=host_dtype)
        fst_chunk[:cs] = fstd[t0 + 1: t0 + 1 + cs]
        if p1_carry is not None:
            p1_carry = _p1_chunk(
                *p1_carry, put(conv(fst_chunk)), put(np.int32(t0)),
                m0_s[0:1], m_half[0:1],
                n_steps=cfg.n_steps, dt=cfg.dt, eps=cfg.eps, G=cfg.G,
                dist3_mode=cfg.dist3_mode or "dsqrt",
                planet=scene.planet, asteroid=scene.asteroid, fast=fast,
                f64_grid=_is_grid(dtype),
            )
            watch = p1_carry
        else:
            carry = _p12_chunk(
                *carry, m0_s, m_half, dev_idx, put(conv(fst_chunk)),
                put(np.int32(t0)),
                n_steps=cfg.n_steps, dt=cfg.dt, eps=cfg.eps, G=cfg.G,
                planet_radius=cfg.planet_radius,
                missile_speed=cfg.missile_speed,
                dist3_mode=cfg.dist3_mode or "dsqrt",
                planet=scene.planet, asteroid=scene.asteroid, fast=fast,
                f64_grid=_is_grid(dtype),
            )
            watch = carry
        if on_accel:
            _guard_finite(watch[0], watch[2],
                          context=f"in P1/P2 after step {t0 + cs}")
        t0 += cs
        if p1_carry is None:
            hit_h = int(np.asarray(carry[3]))
        if checkpoint_path is not None:
            pack = _ckpt_pack
            if p1_carry is not None:
                qd, vd, min_d2 = p1_carry
                hit, arr, q_snap, v_snap = p2_frozen
            else:
                qd, vd, min_d2, hit, arr, q_snap, v_snap = carry
            save_checkpoint(
                checkpoint_path, step=t0, q=pack(qd), v=pack(vd),
                extra={"min_d2": pack(min_d2),
                       "hit": np.asarray(hit), "arr": np.asarray(arr),
                       "q_snap": pack(q_snap),
                       "v_snap": pack(v_snap)},
                meta={"n_steps": cfg.n_steps, "fingerprint": fingerprint,
                      "phase": "p1" if p1_carry is not None else "p12"})

    if p1_carry is not None:
        _, _, min_d2 = p1_carry
        hit, arr, q_snap, v_snap = p2_frozen
    else:
        _, _, min_d2, hit, arr, q_snap, v_snap = carry
    if is_tf:
        return P12Result(
            min_dist=float(np.sqrt(tfloat.to_f64(min_d2))),
            hit_time_step=int(hit),
            arrivals=np.asarray(arr),
            q_snaps=tfloat.to_f64(q_snap),
            v_snaps=tfloat.to_f64(v_snap),
            q_snaps_tf=_host_tf(q_snap),
            v_snaps_tf=_host_tf(v_snap),
        )
    if _is_e64(dtype):
        # E64 <-> f64 is exact: the f64 snapshots are lossless
        return P12Result(
            min_dist=float(np.sqrt(f64emu.e64_to_f64(min_d2))),
            hit_time_step=int(hit),
            arrivals=np.asarray(arr),
            q_snaps=f64emu.e64_to_f64(q_snap),
            v_snaps=f64emu.e64_to_f64(v_snap),
        )
    return P12Result(
        min_dist=float(np.sqrt(np.asarray(min_d2))),
        hit_time_step=int(hit),
        arrivals=np.asarray(arr),
        q_snaps=np.asarray(q_snap),
        v_snaps=np.asarray(v_snap),
    )


@dataclasses.dataclass
class P123Result:
    min_dist: float
    hit_time_step: int
    arrivals: np.ndarray       # (D,) missile-arrival step per device
    saved: np.ndarray          # (D,) bool: destroying device k saves it


def run_problems_123(scene, fst: np.ndarray, cfg: SimConfig, *, device=None,
                     dtype=np.float64, fast: bool = False,
                     host_chunk: int | None = None,
                     checkpoint_path: str | None = None) -> P123Result:
    """Solve Problems 1, 2 AND 3 in one fused scan (see _p123_chunk).

    The small-n fast path: bit-exact answers equal to
    run_problems_12 + run_problem_3 (tests/test_p123_fused.py), in ONE
    pass over the horizon instead of up to three. Routed by the engine
    for overhead-bound scene sizes (padded n <= 128, where extra
    scenario rows cost little next to the fixed per-step overhead);
    the phased drivers remain the path for compute-bound sizes, where
    running every P3 row the full horizon would cost real work.
    """
    n = scene.n
    is_tf = _is_tf_dtype(dtype)
    is_ext = _is_ext(dtype)
    conv = _make_converter(dtype)
    put = functools.partial(jax.device_put, device=device)
    host_dtype = np.float64 if is_ext else dtype
    q0 = np.asarray(scene.q, dtype=host_dtype)
    v0 = np.asarray(scene.v, dtype=host_dtype)
    m0 = np.asarray(scene.m, dtype=host_dtype)
    mask = np.asarray(scene.device_mask(), dtype=host_dtype)
    D = scene.device_cnt

    # Rows: [P1 devices-off, P2 devices-on, P3_k devices-on minus device k]
    m_rows = [m0 * (1.0 - mask), m0]
    for k in range(D):
        mk = m0.copy()
        mk[int(scene.device_idx[k])] = 0.0
        m_rows.append(mk)
    m0_s_h = np.stack(m_rows)
    m0_s = put(conv(m0_s_h))
    m_half = put(conv(0.5 * m0_s_h * mask[None, :]))
    dev_idx = put(np.asarray(scene.device_idx, dtype=np.int32))
    fstd = np.asarray(fst, dtype=host_dtype)

    d0 = q0[scene.planet] - q0[scene.asteroid]
    d2_0 = d0[0] * d0[0] + d0[1] * d0[1] + d0[2] * d0[2]
    r2 = np.asarray(cfg.planet_radius, dtype=host_dtype) ** 2

    R = 2 + D
    carry = (
        put(conv(np.stack([q0] * R))),
        put(conv(np.stack([v0] * R))),
        put(conv(np.asarray(d2_0))),
        put(np.int32(0 if d2_0 < r2 else -2)),
        put(np.full((D,), -2, dtype=np.int32)),
        put(np.zeros((D,), dtype=bool)),
    )

    on_accel = _on_accelerator(device)
    if host_chunk is None:
        host_chunk = min(cfg.n_steps, HOST_CHUNK_STEPS)
    t0 = 0
    # NO post-decision switch to a P1-only chunk here (run_problems_12
    # has one): at the overhead-bound sizes this path is routed for, the
    # decided rows cost little, while the switch would cost a second
    # compile signature. One signature, one pass.
    if checkpoint_path is not None:
        from ..utils.checkpoint import load_checkpoint, save_checkpoint
        fingerprint = _solver_fingerprint(scene, cfg, dtype, fast) + ":p123"
        if os.path.exists(checkpoint_path):
            step, qc, vc, extra, meta = load_checkpoint(checkpoint_path)
            if meta.get("fingerprint") != fingerprint:
                raise ValueError(
                    f"checkpoint {checkpoint_path} was written for a "
                    "different scene/config/precision/solver phase path — "
                    "refusing to resume (delete it or pass a fresh path)")
            t0 = int(step)
            if t0 > cfg.n_steps:
                raise ValueError(
                    f"checkpoint {checkpoint_path} is at step {t0}, beyond "
                    f"this run's horizon n_steps={cfg.n_steps}")
            unpack = _ckpt_unpack_fn(dtype)
            carry = (put(unpack(qc)), put(unpack(vc)),
                     put(unpack(extra["min_d2"])),
                     put(extra["hit"].astype(np.int32)),
                     put(extra["arr"].astype(np.int32)),
                     put(extra["p3_hit"].astype(bool)))
    while t0 < cfg.n_steps:
        hc = host_chunk
        cs = min(hc, cfg.n_steps - t0)
        fst_chunk = np.zeros(hc, dtype=host_dtype)
        fst_chunk[:cs] = fstd[t0 + 1: t0 + 1 + cs]
        carry = _p123_chunk(
            *carry, m0_s, m_half, dev_idx, put(conv(fst_chunk)),
            put(np.int32(t0)),
            # planet/asteroid ride as TRACED ints (unlike the phased
            # chunks' static args): the graded cases differ ONLY in them
            # once padded to the (n, D) bucket, so tracing them lets all
            # nine 128-bucket cases share ONE compiled executable.
            put(np.int32(scene.planet)), put(np.int32(scene.asteroid)),
            n_steps=cfg.n_steps, dt=cfg.dt, eps=cfg.eps, G=cfg.G,
            planet_radius=cfg.planet_radius,
            missile_speed=cfg.missile_speed,
            dist3_mode=cfg.dist3_mode or "dsqrt", fast=fast,
            f64_grid=_is_grid(dtype),
        )
        if on_accel:
            jax.block_until_ready(carry)
            _guard_finite(carry[0], carry[2],
                          context=f"in fused P1/P2/P3 after step {t0 + cs}")
        t0 += cs
        if checkpoint_path is not None:
            pack = _ckpt_pack
            qd, vd, min_d2, hit, arr, p3_hit = carry
            save_checkpoint(
                checkpoint_path, step=t0, q=pack(qd), v=pack(vd),
                extra={"min_d2": pack(min_d2),
                       "hit": np.asarray(hit), "arr": np.asarray(arr),
                       "p3_hit": np.asarray(p3_hit)},
                meta={"n_steps": cfg.n_steps, "fingerprint": fingerprint,
                      "phase": "p123"})

    _, _, min_d2, hit, arr, p3_hit = carry
    arr_h = np.asarray(arr)
    hit_h = int(hit)
    eligible = (arr_h != -2) & (arr_h <= hit_h) if hit_h != -2 \
        else np.zeros((D,), bool)
    saved = eligible & ~np.asarray(p3_hit)
    if is_tf:
        min_dist = float(np.sqrt(tfloat.to_f64(min_d2)))
    elif _is_e64(dtype):
        min_dist = float(np.sqrt(f64emu.e64_to_f64(min_d2)))
    else:
        min_dist = float(np.sqrt(np.asarray(min_d2)))
    return P123Result(min_dist=min_dist, hit_time_step=hit_h,
                      arrivals=arr_h, saved=saved)


@functools.partial(
    jax.jit,
    static_argnames=("n_steps", "dt", "eps", "G", "planet_radius",
                     "dist3_mode", "planet", "asteroid", "fast",
                     "chunk_steps", "f64_grid"),
)
def _p3_chunks(q, v, hit_flag, c_start, c_limit, arrivals, eligible, m0_scen,
               m_half_scen, fst, *, n_steps, dt, eps, G, planet_radius,
               dist3_mode, planet, asteroid, fast=False, chunk_steps=2000,
               f64_grid=False):
    """Run the batched resumed simulations from chunk c_start up to (at
    most) chunk c_limit: scenario k is frozen until its arrival step, then
    integrates with device k's mass zeroed (destruction takes effect from
    the arrival step onward, hw5.cu:299-308).

    The while_loop exits early once every eligible scenario's planet is hit
    — nothing downstream can change the answer (the batched replacement for
    the reference's PROBLEM3_BREAK dominance pruning, hw5.cu:490-493). The
    early exit and any chunking are bit-exact: they only skip iterations
    that are provably identity on the carry.
    """
    if isinstance(q, TF3):
        pr = tfloat.const(planet_radius)
        r2 = pr * pr
    elif isinstance(q, E64):
        r2 = f64emu.const_e(float(planet_radius) * float(planet_radius))
    else:
        r2 = planet_radius * planet_radius
    cs = int(chunk_steps)

    def step_body(t, carry):
        q, v, hit_flag = carry
        t = t.astype(jnp.int32)
        in_range = t <= jnp.int32(n_steps)
        active = (t > arrivals) & in_range                    # (D,)
        fst_t = fst[jnp.minimum(t, jnp.int32(n_steps))]
        m_eff = m0_scen + m_half_scen * fst_t                 # (D, n)
        q2, v2 = symplectic_euler_step(q, v, m_eff, G=G, eps=eps, dt=dt,
                                       dist3_mode=dist3_mode, fast=fast,
                                       f64_grid=f64_grid)
        sel = active[:, None, None]
        q = _select(sel, q2, q)
        v = _select(sel, v2, v)
        d2_pa = _sq_dist(q[:, planet], q[:, asteroid], grid=f64_grid)
        hit_flag = hit_flag | (active & (d2_pa < r2))
        return q, v, hit_flag

    def chunk_body(carry):
        c, q, v, hit_flag = carry
        t0 = c * cs + 1
        q, v, hit_flag = lax.fori_loop(t0, t0 + cs, step_body,
                                       (q, v, hit_flag))
        return c + 1, q, v, hit_flag

    def chunk_cond(carry):
        c, _, _, hit_flag = carry
        undecided = eligible & ~hit_flag
        return (c < c_limit) & undecided.any()

    init = (c_start.astype(jnp.int32), q, v, hit_flag)
    c, q, v, hit_flag = lax.while_loop(chunk_cond, chunk_body, init)
    return c, q, v, hit_flag


def run_problem_3(scene, p12: P12Result, fst: np.ndarray, cfg: SimConfig, *,
                  device=None, dtype=np.float64, fast: bool = False,
                  host_chunks: int | None = None,
                  strategy: str = "auto",
                  checkpoint_path: str | None = None) -> np.ndarray:
    """Return (D,) bool: True if destroying device k saves the planet.

    Only scenarios with a valid arrival (!= -2) and arrival <= hit step can
    save the planet: destroying a device after the hit cannot undo it. (The
    reference evaluates such late scenarios from their post-hit snapshot and
    can miss the hit entirely — hw5.cu:489-508 only checks from the resume
    step; we fix that by masking them out.)

    strategy:
      'batched'    — all scenarios in one masked batch (latency-friendly).
      'sequential' — one scenario at a time in (arrival, index) order,
                     stopping at the first savior: the missile cost is
                     monotone in the arrival step, so the first saving
                     scenario in that order is the answer and later ones are
                     dominated (the reference's PROBLEM3_BREAK pruning,
                     hw5.cu:574-585, 490-493 — here exact, not speculative).
                     Work is sum of per-scenario active suffixes instead of
                     D x the longest one.
      'auto'       — sequential for large scenes, batched for small.

    checkpoint_path: persist the P3 progress to sidecar files derived from
    this path (`<path>.p3.npz` for the in-flight while_loop carry,
    `<path>.p3progress.json` for per-scenario results under the sequential
    strategy) and resume from them — a preemption mid-P3 no longer
    restarts it (the reference's snapshot-restore idea, hw5.cu:475-486,
    extended to disk).
    """
    D = scene.device_cnt
    if D == 0:
        return np.zeros((0,), dtype=bool)
    eligible = (p12.arrivals != -2) & (p12.arrivals <= p12.hit_time_step)
    if not eligible.any():
        return np.zeros((D,), dtype=bool)

    import json
    import os

    fingerprint = None
    state_path = progress_path = None
    if checkpoint_path is not None:
        fingerprint = _solver_fingerprint(scene, cfg, dtype, fast)
        state_path = checkpoint_path + ".p3.npz"
        progress_path = checkpoint_path + ".p3progress.json"

    if strategy == "auto":
        strategy = "sequential" if scene.n >= 256 else "batched"
    if strategy == "sequential":
        saved = np.zeros((D,), dtype=bool)
        done: dict = {}
        if progress_path is not None and os.path.exists(progress_path):
            with open(progress_path) as f:
                rec = json.load(f)
            if rec.get("fingerprint") != fingerprint:
                raise ValueError(
                    f"P3 progress file {progress_path} was written for a "
                    "different scene/config/precision — refusing to resume")
            done = {int(k): bool(v) for k, v in rec["results"].items()}
        order = sorted(np.nonzero(eligible)[0],
                       key=lambda k: (int(p12.arrivals[k]),
                                      int(scene.device_idx[k])))
        for k in order:
            if int(k) in done:
                saved[k] = done[int(k)]
            else:
                sub = _run_p3_scenarios(
                    scene, p12, fst, cfg, np.asarray([k]), device=device,
                    dtype=dtype, fast=fast, host_chunks=host_chunks,
                    checkpoint_path=state_path, fingerprint=fingerprint)
                saved[k] = bool(sub[0])
                if progress_path is not None:
                    # remove the finished scenario's state file BEFORE
                    # recording it done: the reverse order leaves, on a
                    # crash in between, a stale .p3.npz whose idx belongs
                    # to a scenario the progress file already skips — the
                    # next scenario's resume would then refuse to start
                    if os.path.exists(state_path):
                        os.remove(state_path)   # scenario finished
                    done[int(k)] = bool(saved[k])
                    with open(progress_path, "w") as f:
                        json.dump({"fingerprint": fingerprint,
                                   "results": {str(i): bool(v)
                                               for i, v in done.items()}}, f)
            if saved[k]:
                break  # dominated: later scenarios cost strictly more
        return saved

    idx = np.arange(D)
    return_mask = _run_p3_scenarios(scene, p12, fst, cfg, idx, device=device,
                                    dtype=dtype, fast=fast,
                                    host_chunks=host_chunks,
                                    checkpoint_path=state_path,
                                    fingerprint=fingerprint)
    out = np.zeros((D,), dtype=bool)
    out[idx] = return_mask
    return out & eligible


def _run_p3_scenarios(scene, p12: P12Result, fst: np.ndarray, cfg: SimConfig,
                      idx: np.ndarray, *, device=None, dtype=np.float64,
                      fast: bool = False,
                      host_chunks: int | None = None,
                      checkpoint_path: str | None = None,
                      fingerprint: str | None = None) -> np.ndarray:
    """Run the resumed simulations for the scenario subset `idx` (device
    slots). Returns (len(idx),) bool saved-mask.

    checkpoint_path: persist (chunk index, q, v, hit flags) after each host
    chunk and resume from the file if present — mirrors the P12 checkpoint
    contract (bit-identical answers after a kill-and-rerun)."""
    D = len(idx)
    is_tf = _is_tf_dtype(dtype)
    conv = _make_converter(dtype)
    host_dtype = np.float64 if _is_ext(dtype) else dtype
    eligible = ((p12.arrivals[idx] != -2) &
                (p12.arrivals[idx] <= p12.hit_time_step))

    # Per-scenario masses: device idx[i] destroyed (mass 0) for the whole
    # resumed suffix — every resumed force evaluation happens at t > arrival.
    m0_scen = np.tile(np.asarray(scene.m, dtype=host_dtype)[None, :], (D, 1))
    m0_scen[np.arange(D), np.asarray(scene.device_idx)[idx]] = 0.0
    device_mask = np.asarray(scene.device_mask(), dtype=host_dtype)
    m_half_scen = 0.5 * m0_scen * device_mask[None, :]

    cs = cfg.chunk_steps
    n_chunks = (cfg.n_steps + cs - 1) // cs
    # Freeze ineligible scenarios entirely (arrival pinned past the end) so
    # they are never integrated and never block the early exit; selection
    # masks them out regardless.
    arr_masked = np.where(eligible, p12.arrivals[idx],
                          cfg.n_steps).astype(np.int32)
    # skip-ahead: chunks before the earliest eligible arrival are identity
    c_start = int(max(int(arr_masked.min()), 0) // cs)

    # Hit check at t == arrival with the snapshot state (missile_cost_gpu's
    # test runs at the resume step before any update, hw5.cu:292-298).
    dsnap = (p12.q_snaps[idx][:, scene.planet]
             - p12.q_snaps[idx][:, scene.asteroid])
    hit0 = ((dsnap * dsnap).sum(-1) <
            np.asarray(cfg.planet_radius, dtype=np.float64) ** 2)

    if host_chunks is None:
        host_chunks = n_chunks

    put = functools.partial(jax.device_put, device=device)
    if is_tf:
        # resume from the FULL-precision snapshots (the f64 views would
        # re-inject 2^-53 noise right at the resume point)
        q = put(p12.q_snaps_tf[np.asarray(idx)])
        v = put(p12.v_snaps_tf[np.asarray(idx)])
    elif _is_e64(dtype):
        # f64 snapshots are lossless for the softfloat rep
        q = put(conv(p12.q_snaps[idx]))
        v = put(conv(p12.v_snaps[idx]))
    else:
        q = put(np.asarray(p12.q_snaps[idx], dtype=dtype))
        v = put(np.asarray(p12.v_snaps[idx], dtype=dtype))
    hit_flag = put(hit0)
    eligible_j = put(eligible)
    arr_j = put(arr_masked)
    m0_j = put(conv(m0_scen))
    m_half_j = put(conv(m_half_scen))
    fst_j = put(conv(np.asarray(fst, dtype=host_dtype)))

    c = c_start
    if checkpoint_path is not None:
        import os

        from ..utils.checkpoint import load_checkpoint, save_checkpoint
        idx_key = [int(i) for i in idx]
        if os.path.exists(checkpoint_path):
            step, qc, vc, extra, meta = load_checkpoint(checkpoint_path)
            if (meta.get("fingerprint") != fingerprint
                    or meta.get("idx") != idx_key):
                raise ValueError(
                    f"P3 checkpoint {checkpoint_path} was written for a "
                    "different scene/config/precision/scenario set — "
                    "refusing to resume")
            c = int(step)
            unpack = _ckpt_unpack_fn(dtype)
            q = put(unpack(qc))
            v = put(unpack(vc))
            hit_flag = put(extra["hit_flag"].astype(bool))
    while c < n_chunks:
        hc = host_chunks
        c_j, q, v, hit_flag = _p3_chunks(
            q, v, hit_flag, put(np.int32(c)),
            put(np.int32(min(c + hc, n_chunks))),
            arr_j, eligible_j, m0_j, m_half_j, fst_j,
            n_steps=cfg.n_steps, dt=cfg.dt, eps=cfg.eps, G=cfg.G,
            planet_radius=cfg.planet_radius,
            dist3_mode=cfg.dist3_mode or "dsqrt",
            planet=scene.planet, asteroid=scene.asteroid, fast=fast,
            chunk_steps=cs, f64_grid=_is_grid(dtype),
        )
        c_new = int(c_j)   # materializes the carry (blocks)
        if _on_accelerator(device):
            _guard_finite(q, context=f"in P3 after chunk {c_new}")
        c = c_new
        if checkpoint_path is not None:
            save_checkpoint(checkpoint_path, step=c, q=_ckpt_pack(q),
                            v=_ckpt_pack(v),
                            extra={"hit_flag": np.asarray(hit_flag)},
                            meta={"fingerprint": fingerprint,
                                  "idx": idx_key})
        hits = np.asarray(hit_flag)
        if (hits | ~eligible).all():
            break  # every eligible scenario decided

    saved = eligible & ~np.asarray(hit_flag)
    return saved
