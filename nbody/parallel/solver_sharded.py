"""The graded P1/P2/P3 solver, sharded over a device mesh.

This routes the PRODUCT (the three graded problems, models/direct_sum.py)
through a ('scen', 'body') mesh — the answer to the reference
distributing the graded scenario over its two GPUs (hw5.cu:564-588):

  * 'scen' — scenario parallelism: the stacked P1/P2 pair (devices off/on,
    hw5.cu:352-357 vs 359-364) and the batched P3 device-destruction
    scenarios (hw5.cu:438-530) spread across mesh rows;
  * 'body' — body sharding (the sequence-parallel axis): each device owns
    a row-block of the N x N interaction matrix and j-body tiles rotate
    around a `lax.ppermute` ring (NCCL over NVLink on GPUs;
    parallel/sharded.py pattern).

Determinism contract: force accumulation uses a STATIC j-tile size and
combines per-tile partial sums in ascending global tile order, so answers
are BIT-IDENTICAL across mesh shapes (1x1, 2x4, 1x8, ...) for the same
tile size — the multi-chip correctness claim tests assert. (The reference
fails its own analog of this: its atomicAdd reduction order changes run to
run and flips 2/12 testcases, SURVEY.md §4.) For the triple-f32 dtypes
('tf3'/'tf3grid' — precisions tf3/ddp) the same structure gives
mesh-shape-invariant answers at (beyond-)f64 level; the LOWEST tf3 limb
may differ between mesh shapes on XLA:CPU, whose fmuladd contraction
perturbs the approximate third-order chains within their ~2^-70 budget
(tests/test_solver_sharded_tf3.py pins the exact contract).

Cross-shard data flow: j-tiles ride the ring; the planet / asteroid /
device-slot positions each scenario needs for its min-distance, hit,
missile-arrival and snapshot carries (hw5.cu:241-287) are extracted with
one-hot masked psums over 'body' — exact (a single nonzero term per
reduction), so they are bitwise identical to an unsharded gather.

Every scenario row redundantly maintains ALL carries (its own running
min distance, first hit, arrivals, snapshots); the host reads Problem 1's
answer from the devices-off row and Problem 2/3 inputs from the devices-on
row. This keeps the scenario rows fully independent — zero cross-'scen'
communication in P1/P2.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import SimConfig
from ..models.direct_sum import HOST_CHUNK_STEPS
from ..ops.forces import _dist3, pairwise_accel_e64


def _tile_partial(qi, qj, gmj, *, eps, dist3_mode, fast):
    """Forces on local rows qi from one j-tile, with the SAME per-pair op
    order as the single-device kernels (ops/forces.py): division form for
    the graded f64 path, rsqrt form for the fast path. qi: (ni, 3),
    qj: (T, 3), gmj: (T,)."""
    dq = qj[None, :, :] - qi[:, None, :]              # (ni, T, 3)
    d2 = (dq * dq).sum(-1) + eps * eps
    if fast:
        inv = lax.rsqrt(d2)
        w = gmj[None, :] * (inv * inv * inv)
        return (w[..., None] * dq).sum(1)
    dist3 = _dist3(d2, dist3_mode)
    return ((gmj[None, :, None] * dq) / dist3[..., None]).sum(1)


def ring_accel_ordered(q_local, gm_local, *, axis_name: str, eps: float,
                       tile: int, dist3_mode: str = "dsqrt",
                       fast: bool = False):
    """All-pairs accelerations for this shard's rows with a mesh-shape-
    independent summation order: per-tile partials are buffered and
    combined in ascending GLOBAL tile order, so the result is bit-identical
    on a 1-device and an 8-device mesh (same `tile`). Call inside
    shard_map."""
    k = lax.axis_size(axis_name)
    me = lax.axis_index(axis_name)
    ni = q_local.shape[0]
    if ni % tile != 0:
        raise ValueError(f"local rows {ni} not a multiple of tile {tile}")
    tps = ni // tile                      # tiles per shard
    n_tiles = k * tps
    perm = [(i, (i + 1) % k) for i in range(k)]
    # derive from q_local so the buffer carries its varying-mesh-axes
    # metadata (a plain jnp.zeros would mismatch the scan carry type)
    zrow = jnp.zeros_like(q_local)
    buf = jnp.broadcast_to(zrow[None], (n_tiles,) + zrow.shape)

    def rot(r, carry):
        buf, qj, gmj = carry
        r = jnp.asarray(r, jnp.int32)
        origin = jax.lax.rem(jnp.int32(me) - r + jnp.int32(k),
                             jnp.int32(k))    # block's home shard
        for s in range(tps):
            part = _tile_partial(q_local, qj[s * tile:(s + 1) * tile],
                                 gmj[s * tile:(s + 1) * tile], eps=eps,
                                 dist3_mode=dist3_mode, fast=fast)
            gidx = origin * jnp.int32(tps) + jnp.int32(s)
            buf = lax.dynamic_update_slice(
                buf, part[None],
                (gidx,) + (jnp.int32(0),) * part.ndim)
        qj = lax.ppermute(qj, axis_name, perm)
        gmj = lax.ppermute(gmj, axis_name, perm)
        return buf, qj, gmj

    buf, _, _ = lax.fori_loop(0, k, rot, (buf, q_local, gm_local),
                              unroll=True)
    acc = jnp.zeros_like(q_local)
    for t in range(n_tiles):              # static ascending order
        acc = acc + buf[t]
    return acc


def ring_accel_ordered_tf3(q_local, m_eff_local, *, axis_name: str,
                           eps: float, G: float, tile: int):
    """Triple-f32 twin of ring_accel_ordered: j-tiles of the TF3 state ride
    the ppermute ring; each tile's contribution comes from the gauged tf3
    tile kernel (ops/forces._tf3_accel_tile) and tiles combine with tf3
    adds in ascending GLOBAL tile order — mesh-shape-invariant bits for a
    fixed `tile`, ~(n/tile) * 2^-70-class combination error (far beyond
    f64). The mass gauge is made mesh-global with a pmax so every shard
    lifts G*m identically. Call inside shard_map."""
    import jax.numpy as jnp

    from ..ops import tfloat as tf
    from ..ops.forces import _tf3_accel_tile

    k = lax.axis_size(axis_name)
    me = lax.axis_index(axis_name)
    ni = q_local.shape[-2]
    if ni % tile != 0:
        raise ValueError(f"local rows {ni} not a multiple of tile {tile}")
    tps = ni // tile
    n_tiles = k * tps
    perm = [(i, (i + 1) % k) for i in range(k)]

    # global mass gauge (matches the single-device kernel's, but pmax'd)
    mx = lax.pmax(jnp.max(m_eff_local.hi), axis_name)
    gm_mag = jnp.float32(abs(G)) * mx
    gscale_e = jnp.where(gm_mag > 0,
                         jnp.int32(16) - tf.exp_bits(gm_mag), jnp.int32(0))
    gscale = tf.exp2_i32(gscale_e)
    g0 = tf.const(G, like=m_eff_local.hi)
    g_s = tf.TF3(g0.hi * gscale, g0.mid * gscale, g0.lo * gscale)  # exact
    gm_local = g_s * m_eff_local

    # derive from q_local so the buffers carry its varying-mesh-axes
    # metadata (plain jnp.zeros would mismatch the fori carry type)
    zrow = jnp.zeros_like(q_local.hi)
    buf = tf.TF3(*(jnp.broadcast_to(zrow[None], (n_tiles,) + zrow.shape)
                   for _ in range(3)))

    def rot(r, carry):
        bh, bm, bl, qjh, qjm, qjl, gh, gm_, gl = carry
        r = jnp.asarray(r, jnp.int32)
        origin = jax.lax.rem(jnp.int32(me) - r + jnp.int32(k),
                             jnp.int32(k))
        for s_ in range(tps):
            sl = slice(s_ * tile, (s_ + 1) * tile)
            qj = tf.TF3(qjh[sl], qjm[sl], qjl[sl])
            gmj = tf.TF3(gh[sl], gm_[sl], gl[sl])
            part = _tf3_accel_tile(q_local, qj, gmj, gscale_e, eps)
            gidx = origin * jnp.int32(tps) + jnp.int32(s_)
            idx = (gidx,) + (jnp.int32(0),) * part.hi.ndim
            bh = lax.dynamic_update_slice(bh, part.hi[None], idx)
            bm = lax.dynamic_update_slice(bm, part.mid[None], idx)
            bl = lax.dynamic_update_slice(bl, part.lo[None], idx)
        qjh = lax.ppermute(qjh, axis_name, perm)
        qjm = lax.ppermute(qjm, axis_name, perm)
        qjl = lax.ppermute(qjl, axis_name, perm)
        gh = lax.ppermute(gh, axis_name, perm)
        gm_ = lax.ppermute(gm_, axis_name, perm)
        gl = lax.ppermute(gl, axis_name, perm)
        return bh, bm, bl, qjh, qjm, qjl, gh, gm_, gl

    init = (buf.hi, buf.mid, buf.lo, q_local.hi, q_local.mid, q_local.lo,
            gm_local.hi, gm_local.mid, gm_local.lo)
    bh, bm, bl, *_ = lax.fori_loop(0, k, rot, init, unroll=True)
    acc = tf.zeros(q_local.shape)
    for t in range(n_tiles):              # static ascending order
        acc = tf.add(acc, tf.TF3(bh[t], bm[t], bl[t]))
    return acc


def _extract_rows(q_local, sel_local, axis_name):
    """Gather rows of the body-sharded q (ni, 3) selected by the one-hot
    matrix sel_local (R, ni): exact (one nonzero term per output) psum over
    the body axis. Returns (R, 3) replicated."""
    return lax.psum(sel_local @ q_local, axis_name)


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "n_steps", "dt", "eps", "G", "planet_radius",
                     "missile_speed", "dist3_mode", "fast", "tile"))
def _p12_chunk_sharded(q, v, min_d2, hit, arr, q_snap, v_snap, m0_s, m_half,
                       planet_oh, asteroid_oh, dev_oh, fst_chunk, t0, *,
                       mesh: Mesh, n_steps, dt, eps, G, planet_radius,
                       missile_speed, dist3_mode, fast, tile):
    """Sharded twin of models/direct_sum._p12_chunk: advance the stacked
    (S, n, ...) P1/P2 state over steps (t0, t0 + len(fst_chunk)], every
    carry update bit-matching the single-device semantics (strict `<`,
    step-0 inclusion, guarded first-hit — hw5.cu:241-287)."""
    state_spec = P("scen", "body", None)
    mass_spec = P("scen", "body")
    scen_spec = P("scen")
    snap_spec = P("scen", None, "body", None)
    oh_spec = P("body")
    dev_oh_spec = P(None, "body")

    def local_chunk(q, v, min_d2, hit, arr, q_snap, v_snap, m0_s, m_half,
                    p_oh, a_oh, d_oh, fst_chunk, t0):
        r2 = planet_radius * planet_radius
        sdt = missile_speed * dt
        offs = jnp.arange(1, fst_chunk.shape[0] + 1, dtype=jnp.int32)
        xs = (t0.astype(jnp.int32) + offs, fst_chunk)

        def scen_step(q1, v1, min1, hit1, arr1, qs1, vs1, m0_1, mh_1, t,
                      fst_t):
            # one scenario: q1 (ni, 3), m0_1 (ni,), carries replicated
            in_range = t <= jnp.int32(n_steps)
            m_eff = m0_1 + mh_1 * fst_t
            a = ring_accel_ordered(q1, G * m_eff, axis_name="body", eps=eps,
                                   tile=tile, dist3_mode=dist3_mode,
                                   fast=fast)
            v2 = v1 + a * dt
            q2 = q1 + v2 * dt
            q1 = jnp.where(in_range, q2, q1)
            v1 = jnp.where(in_range, v2, v1)
            rows = _extract_rows(q1, jnp.concatenate(
                [p_oh[None], a_oh[None], d_oh], axis=0), "body")
            qp, qa, qd = rows[0], rows[1], rows[2:]
            dpa = qp - qa
            d2_pa = (dpa[0] * dpa[0] + dpa[1] * dpa[1] + dpa[2] * dpa[2])
            min1 = jnp.where(in_range, jnp.minimum(min1, d2_pa), min1)
            dpd = qp[None, :] - qd                        # (D, 3)
            d2_pd = (dpd[:, 0] * dpd[:, 0] + dpd[:, 1] * dpd[:, 1]
                     + dpd[:, 2] * dpd[:, 2])
            md = sdt * t.astype(q1.dtype)
            arrived = (arr1 == -2) & (d2_pd < md * md) & in_range
            arr1 = jnp.where(arrived, t, arr1)
            sel = arrived[:, None, None]
            qs1 = jnp.where(sel, q1[None], qs1)
            vs1 = jnp.where(sel, v1[None], vs1)
            hit1 = jnp.where((hit1 == -2) & (d2_pa < r2) & in_range, t, hit1)
            return q1, v1, min1, hit1, arr1, qs1, vs1

        def body(carry, x):
            q, v, min_d2, hit, arr, q_snap, v_snap = carry
            t, fst_t = x
            out = jax.vmap(
                scen_step, in_axes=(0, 0, 0, 0, 0, 0, 0, 0, 0, None, None)
            )(q, v, min_d2, hit, arr, q_snap, v_snap, m0_s, m_half, t, fst_t)
            return out, None

        carry = (q, v, min_d2, hit, arr, q_snap, v_snap)
        carry, _ = lax.scan(body, carry, xs)
        return carry

    fn = jax.shard_map(
        local_chunk, mesh=mesh,
        in_specs=(state_spec, state_spec, scen_spec, scen_spec,
                  P("scen", None), snap_spec, snap_spec, mass_spec,
                  mass_spec, oh_spec, oh_spec, dev_oh_spec, P(), P()),
        out_specs=(state_spec, state_spec, scen_spec, scen_spec,
                   P("scen", None), snap_spec, snap_spec))
    return fn(q, v, min_d2, hit, arr, q_snap, v_snap, m0_s, m_half,
              planet_oh, asteroid_oh, dev_oh, fst_chunk, t0)


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "n_steps", "dt", "eps", "G", "planet_radius",
                     "missile_speed", "tile", "grid"))
def _p12_chunk_sharded_tf3(q, v, min_d2, hit, arr, q_snap, v_snap, m0_s,
                           m_half, planet_oh, asteroid_oh, dev_oh,
                           fst_chunk, t0, *, mesh: Mesh, n_steps, dt, eps,
                           G, planet_radius, missile_speed, tile, grid):
    """Triple-f32 twin of _p12_chunk_sharded: the extended-precision
    (tf3 truth-grade / tf3grid 'ddp') graded P1/P2 chunk on the mesh.
    Decision semantics mirror models/direct_sum._p12_chunk's tf branch
    (strict <, step-0 inclusion, guarded first-hit; f64-grid rounding of
    state and decision quantities when grid=True)."""
    from ..models.direct_sum import _sq_dist
    from ..ops import tfloat
    from ..ops.tfloat import TF3

    state_spec = P("scen", "body", None)
    mass_spec = P("scen", "body")
    snap_spec = P("scen", None, "body", None)

    def extract_tf(q1, sel):
        return TF3(lax.psum(sel @ q1.hi, "body"),
                   lax.psum(sel @ q1.mid, "body"),
                   lax.psum(sel @ q1.lo, "body"))

    def local_chunk(q, v, min_d2, hit, arr, q_snap, v_snap, m0_s, m_half,
                    p_oh, a_oh, d_oh, fst_chunk, t0):
        pr = tfloat.const(planet_radius)
        r2 = pr * pr
        sdt = tfloat.const(missile_speed * dt)
        offs = jnp.arange(1, fst_chunk.hi.shape[0] + 1, dtype=jnp.int32)
        xs = (t0.astype(jnp.int32) + offs, fst_chunk.hi, fst_chunk.mid,
              fst_chunk.lo)

        def scen_step(q1, v1, min1, hit1, arr1, qs1, vs1, m0_1, mh_1, t,
                      fst_t):
            in_range = t <= jnp.int32(n_steps)
            m_eff = m0_1 + mh_1 * fst_t
            a = ring_accel_ordered_tf3(q1, m_eff, axis_name="body",
                                       eps=eps, G=G, tile=tile)
            if grid:
                v2 = tfloat.round53(v1 + tfloat.round53(a * dt))
                q2 = tfloat.round53(q1 + tfloat.round53(v2 * dt))
            else:
                v2 = v1 + a * dt
                q2 = q1 + v2 * dt
            q1 = tfloat.where(in_range, q2, q1)
            v1 = tfloat.where(in_range, v2, v1)
            sel = jnp.concatenate([p_oh[None], a_oh[None], d_oh], axis=0)
            rows = extract_tf(q1, sel)
            qp, qa, qd = rows[0], rows[1], rows[2:]
            d2_pa = _sq_dist(qp, qa, grid=grid)
            min1 = tfloat.where(in_range,
                                tfloat.minimum(min1, d2_pa), min1)
            d2_pd = _sq_dist(TF3(qp.hi[None], qp.mid[None], qp.lo[None]),
                             qd, grid=grid)
            tt = t.astype(jnp.float32)               # t < 2^24: exact
            md = sdt * TF3(tt, jnp.zeros_like(tt), jnp.zeros_like(tt))
            md2 = md * md
            if grid:
                md2 = tfloat.round53(md2)
            arrived = (arr1 == -2) & (d2_pd < md2) & in_range
            arr1 = jnp.where(arrived, t, arr1)
            selm = arrived[:, None, None]
            qs1 = tfloat.where(selm, TF3(q1.hi[None], q1.mid[None],
                                         q1.lo[None]), qs1)
            vs1 = tfloat.where(selm, TF3(v1.hi[None], v1.mid[None],
                                         v1.lo[None]), vs1)
            hit1 = jnp.where((hit1 == -2) & (d2_pa < r2) & in_range, t,
                             hit1)
            return q1, v1, min1, hit1, arr1, qs1, vs1

        def body(carry, x):
            q, v, min_d2, hit, arr, q_snap, v_snap = carry
            t, fh, fm, fl = x
            fst_t = TF3(fh, fm, fl)
            out = jax.vmap(
                scen_step, in_axes=(0, 0, 0, 0, 0, 0, 0, 0, 0, None, None)
            )(q, v, min_d2, hit, arr, q_snap, v_snap, m0_s, m_half, t,
              fst_t)
            return out, None

        carry = (q, v, min_d2, hit, arr, q_snap, v_snap)
        carry, _ = lax.scan(body, carry, xs)
        return carry

    fn = jax.shard_map(
        local_chunk, mesh=mesh,
        in_specs=(state_spec, state_spec, P("scen"), P("scen"),
                  P("scen", None), snap_spec, snap_spec, mass_spec,
                  mass_spec, P("body"), P("body"), P(None, "body"), P(),
                  P()),
        out_specs=(state_spec, state_spec, P("scen"), P("scen"),
                   P("scen", None), snap_spec, snap_spec))
    return fn(q, v, min_d2, hit, arr, q_snap, v_snap, m0_s, m_half,
              planet_oh, asteroid_oh, dev_oh, fst_chunk, t0)


def _sharded_fingerprint(scene, cfg, dtype, fast, tile) -> str:
    """Checkpoint fingerprint for the mesh drivers: the single-device
    digest plus the force tile size (the tile fixes the summation order,
    so carries from different tiles are different trajectories). The mesh
    SHAPE is deliberately excluded — resuming on a different mesh shape
    with the same tile is bit-exact (the determinism contract above)."""
    from ..models.direct_sum import _solver_fingerprint
    return _solver_fingerprint(scene, cfg, dtype, fast) + f":tile={tile}"


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "n_steps", "dt", "eps", "G", "planet_radius",
                     "missile_speed", "planet", "asteroid"))
def _p12_chunk_sharded_e64(q, v, min_d2, hit, arr, q_snap, v_snap, m0_s,
                           m_half, dev_idx, fst_chunk, t0, *, mesh: Mesh,
                           n_steps, dt, eps, G, planet_radius,
                           missile_speed, planet, asteroid):
    """BIT-EXACT binary64 (e64 softfloat) P1/P2 chunk on the mesh — the
    multi-chip twin of models/direct_sum._p12_chunk's E64 branch
    (hw5.cu:564-588's 2-GPU graded distribution, answer-grade).

    Sharding design: the graded scenes are tiny (n <= 1024 padded), so the
    state stays REPLICATED over 'body' and only the O(n^2) force work is
    split — each shard folds its i-row block against the full j axis with
    the spec's serial order (row folds are row-independent,
    ops/forces.pairwise_accel_e64 `rows=`), and one all_gather of the
    (n/k, 3) acceleration block reassembles the full field. Answers are
    bit-identical to the single-device path and across mesh shapes BY
    CONSTRUCTION — no tile caveat (unlike the f64 ring's partial-sum
    combination, the serial fold never re-associates)."""
    from ..models.direct_sum import _sq_dist
    from ..ops import f64emu as fe
    from ..ops.f64emu import E64

    def local_chunk(q, v, min_d2, hit, arr, q_snap, v_snap, m0_s, m_half,
                    dev_idx, fst_chunk, t0):
        k = lax.axis_size("body")
        me = lax.axis_index("body")
        n = q.hi.shape[-2]
        ni = n // k
        r2 = fe.const_e(float(planet_radius) * float(planet_radius))
        sdt = fe.const_e(float(missile_speed) * float(dt))
        dtc = fe.const_e(float(dt))
        offs = jnp.arange(1, fst_chunk.hi.shape[0] + 1, dtype=jnp.int32)
        xs = (t0.astype(jnp.int32) + offs, fst_chunk.hi, fst_chunk.lo)

        def scen_step(q1, v1, min1, hit1, arr1, qs1, vs1, m0_1, mh_1, t,
                      fst_t):
            in_range = t <= jnp.int32(n_steps)
            m_eff = m0_1 + mh_1 * fst_t                   # E64 ops
            rows = E64(
                lax.dynamic_slice_in_dim(q1.hi, me * ni, ni, axis=0),
                lax.dynamic_slice_in_dim(q1.lo, me * ni, ni, axis=0))
            a_rows = pairwise_accel_e64(q1, m_eff, G=G, eps=eps, rows=rows)
            a = E64(lax.all_gather(a_rows.hi, "body", axis=0, tiled=True),
                    lax.all_gather(a_rows.lo, "body", axis=0, tiled=True))
            v2 = v1 + a * dtc
            q2 = q1 + v2 * dtc
            q1 = fe.where_e(in_range, q2, q1)
            v1 = fe.where_e(in_range, v2, v1)
            d2_pa = _sq_dist(q1[planet], q1[asteroid])
            min1 = fe.where_e(in_range, fe.minimum_e(min1, d2_pa), min1)
            d2_pd = _sq_dist(q1[planet], q1[dev_idx])     # (D,)
            md = sdt * E64(*fe.from_i32(t))
            md2 = md * md
            arrived = (arr1 == -2) & (d2_pd < md2) & in_range
            arr1 = jnp.where(arrived, t, arr1)
            sel = arrived[:, None, None]
            qs1 = fe.where_e(sel, E64(q1.hi[None], q1.lo[None]), qs1)
            vs1 = fe.where_e(sel, E64(v1.hi[None], v1.lo[None]), vs1)
            hit1 = jnp.where((hit1 == -2) & (d2_pa < r2) & in_range, t,
                             hit1)
            return q1, v1, min1, hit1, arr1, qs1, vs1

        def body(carry, x):
            q, v, min_d2, hit, arr, q_snap, v_snap = carry
            t, fh, fl = x
            out = jax.vmap(
                scen_step,
                in_axes=(0, 0, 0, 0, 0, 0, 0, 0, 0, None, None)
            )(q, v, min_d2, hit, arr, q_snap, v_snap, m0_s, m_half, t,
              E64(fh, fl))
            return out, None

        carry = (q, v, min_d2, hit, arr, q_snap, v_snap)
        carry, _ = lax.scan(body, carry, xs)
        return carry

    srep = P("scen")                     # scen-sharded, body-replicated
    specs = (P("scen", None, None), P("scen", None, None), srep, srep,
             P("scen", None), P("scen", None, None, None),
             P("scen", None, None, None))
    fn = jax.shard_map(
        local_chunk, mesh=mesh,
        in_specs=specs + (P("scen", None), P("scen", None), P(None), P(None),
                          P()),
        out_specs=specs)
    return fn(q, v, min_d2, hit, arr, q_snap, v_snap, m0_s, m_half,
              dev_idx, fst_chunk, t0)


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "n_steps", "dt", "eps", "G", "planet_radius",
                     "planet", "asteroid", "chunk_steps"))
def _p3_chunks_sharded_e64(q, v, hit_flag, undecided_any, c_start, c_limit,
                           arrivals, eligible, m0_scen, m_half_scen, fst, *,
                           mesh: Mesh, n_steps, dt, eps, G, planet_radius,
                           planet, asteroid, chunk_steps):
    """e64 twin of _p3_chunks_sharded: scenarios over 'scen', the force
    row-split over 'body' with replicated state (see
    _p12_chunk_sharded_e64)."""
    from ..models.direct_sum import _sq_dist
    from ..ops import f64emu as fe
    from ..ops.f64emu import E64

    def local_chunks(q, v, hit_flag, undecided_any, c_start, c_limit,
                     arrivals, eligible, m0_scen, m_half_scen, fst):
        k = lax.axis_size("body")
        me = lax.axis_index("body")
        n = q.hi.shape[-2]
        ni = n // k
        r2 = fe.const_e(float(planet_radius) * float(planet_radius))
        dtc = fe.const_e(float(dt))
        cs = int(chunk_steps)

        def scen_step(q1, v1, hit1, arr1, m0_1, mh_1, t):
            active = (t > arr1) & (t <= jnp.int32(n_steps))
            ti = jnp.minimum(t, jnp.int32(n_steps))
            m_eff = m0_1 + mh_1 * E64(fst.hi[ti], fst.lo[ti])
            rows = E64(
                lax.dynamic_slice_in_dim(q1.hi, me * ni, ni, axis=0),
                lax.dynamic_slice_in_dim(q1.lo, me * ni, ni, axis=0))
            a_rows = pairwise_accel_e64(q1, m_eff, G=G, eps=eps, rows=rows)
            a = E64(lax.all_gather(a_rows.hi, "body", axis=0, tiled=True),
                    lax.all_gather(a_rows.lo, "body", axis=0, tiled=True))
            v2 = v1 + a * dtc
            q2 = q1 + v2 * dtc
            q1 = fe.where_e(active, q2, q1)
            v1 = fe.where_e(active, v2, v1)
            d2_pa = _sq_dist(q1[planet], q1[asteroid])
            hit1 = hit1 | (active & (d2_pa < r2))
            return q1, v1, hit1

        def step_body(t, carry):
            q, v, hit_flag = carry
            t = t.astype(jnp.int32)
            return jax.vmap(scen_step, in_axes=(0, 0, 0, 0, 0, 0, None))(
                q, v, hit_flag, arrivals, m0_scen, m_half_scen, t)

        def chunk_body(carry):
            c, q, v, hit_flag, _ = carry
            t0 = c * cs + 1
            q, v, hit_flag = lax.fori_loop(t0, t0 + cs, step_body,
                                           (q, v, hit_flag))
            undec = eligible & ~hit_flag
            any_undec = lax.psum(jnp.sum(undec.astype(jnp.int32)),
                                 "scen") > 0
            return c + 1, q, v, hit_flag, any_undec

        def chunk_cond(carry):
            c, _, _, _, any_undec = carry
            return (c < c_limit) & any_undec

        init = (c_start.astype(jnp.int32), q, v, hit_flag, undecided_any)
        c, q, v, hit_flag, _ = lax.while_loop(chunk_cond, chunk_body, init)
        return c, q, v, hit_flag

    fn = jax.shard_map(
        local_chunks, mesh=mesh,
        in_specs=(P("scen", None, None), P("scen", None, None), P("scen"),
                  P(), P(), P(), P("scen"), P("scen"), P("scen", None),
                  P("scen", None), P(None)),
        out_specs=(P(), P("scen", None, None), P("scen", None, None),
                   P("scen")))
    return fn(q, v, hit_flag, undecided_any, c_start, c_limit, arrivals,
              eligible, m0_scen, m_half_scen, fst)


def run_problems_12_sharded(scene, fst, cfg: SimConfig, mesh: Mesh, *,
                            dtype=np.float64, fast: bool = False,
                            tile: int | None = None,
                            host_chunk: int | None = None,
                            checkpoint_path: str | None = None):
    """Mesh-sharded Problems 1+2 (+ P3 preprocessing). Same contract as
    models/direct_sum.run_problems_12; scene.n must be a multiple of the
    body axis (pad via utils/padding first). Returns a P12Result.

    checkpoint_path: persist the full solver carry after every host chunk
    and resume from it if present (kill-and-rerun mid-mesh-solve is
    bit-identical; mirrors direct_sum.run_problems_12). Checkpoints are
    portable across mesh shapes for the same `tile`."""
    from ..models.direct_sum import (P12Result, _ckpt_pack, _ckpt_unpack_fn,
                                     _host_tf)
    from ..ops import tfloat
    from ..ops.tfloat import TF3

    from ..ops import f64emu

    is_tf = isinstance(dtype, str) and dtype in ("tf3", "tf3grid")
    is_e64 = isinstance(dtype, str) and dtype == "e64"
    host_dtype = np.float64 if (is_tf or is_e64) else dtype
    if is_tf:
        conv = lambda a: tfloat.from_f64(np.asarray(a, np.float64))
    elif is_e64:
        conv = lambda a: f64emu.e64_from_f64_tree(np.asarray(a, np.float64))
    else:
        conv = lambda a: np.asarray(a, dtype)

    n = scene.n
    scen_size = mesh.shape["scen"]
    body_size = mesh.shape["body"]
    if 2 % scen_size != 0:
        raise ValueError("P1/P2 scenario axis (2) must be divisible by "
                         f"mesh 'scen' size {scen_size}")
    if n % body_size != 0:
        raise ValueError(f"n={n} not a multiple of body axis {body_size}")
    tile = tile or (n // body_size)
    D = scene.device_cnt

    q0 = np.asarray(scene.q, host_dtype)
    v0 = np.asarray(scene.v, host_dtype)
    m0 = np.asarray(scene.m, host_dtype)
    mask = np.asarray(scene.device_mask(), host_dtype)
    m0_s = np.stack([m0 * (1.0 - mask), m0])
    m_half = 0.5 * np.stack([m0 * (1.0 - mask), m0]) * mask[None, :]

    oh_dtype = np.float32 if is_tf else dtype   # matmuls against f32 limbs
    Dp = max(D, 1)
    if not is_e64:
        planet_oh = np.zeros(n, oh_dtype)
        planet_oh[scene.planet] = 1.0
        asteroid_oh = np.zeros(n, oh_dtype)
        asteroid_oh[scene.asteroid] = 1.0
        dev_oh = np.zeros((Dp, n), oh_dtype)
        for k in range(D):
            dev_oh[k, scene.device_idx[k]] = 1.0

    d0 = q0[scene.planet] - q0[scene.asteroid]
    d2_0 = d0[0] * d0[0] + d0[1] * d0[1] + d0[2] * d0[2]
    r2 = np.asarray(cfg.planet_radius, host_dtype) ** 2

    def put(x, spec):
        return jax.device_put(x, NamedSharding(mesh, spec))

    # e64 keeps the (tiny, n <= 1024) state REPLICATED over 'body' and
    # splits only the O(n^2) force rows (_p12_chunk_sharded_e64 docstring)
    state_spec = (P("scen", None, None) if is_e64
                  else P("scen", "body", None))
    snap_spec = (P("scen", None, None, None) if is_e64
                 else P("scen", None, "body", None))
    carry = (
        put(conv(np.stack([q0, q0])), state_spec),
        put(conv(np.stack([v0, v0])), state_spec),
        put(conv(np.full((2,), d2_0)), P("scen")),
        put(np.full((2,), 0 if d2_0 < r2 else -2, np.int32), P("scen")),
        put(np.full((2, Dp), -2, np.int32), P("scen", None)),
        put(conv(np.zeros((2, Dp, n, 3))), snap_spec),
        put(conv(np.zeros((2, Dp, n, 3))), snap_spec),
    )
    mass_spec = P("scen", None) if is_e64 else P("scen", "body")
    m0_j = put(conv(m0_s), mass_spec)
    mh_j = put(conv(m_half), mass_spec)
    if is_e64:
        # padded device-slot indices: the dummy slots (>= D) point at body
        # 0; their arrivals/snapshots are dropped by the [:D] slices below
        didx = np.zeros(Dp, np.int32)
        didx[:D] = np.asarray(scene.device_idx, np.int32)
        didx_j = put(didx, P(None))
    else:
        poh = put(planet_oh, P("body"))
        aoh = put(asteroid_oh, P("body"))
        doh = put(dev_oh, P(None, "body"))
    fstd = np.asarray(fst, host_dtype)

    if host_chunk is None:
        # fixed step chunks, as the single-device driver uses
        host_chunk = min(cfg.n_steps, HOST_CHUNK_STEPS)
    t0 = 0
    fingerprint = None
    # P2 early exit (the sharded twin of direct_sum's; hw5.cu:398-402):
    # once the hit is known, the devices-on row is dead weight — but only
    # when the scenario axis is UNSHARDED do the rows share devices, so
    # only then does dropping row 1 buy wall-clock. With scen > 1 the rows
    # run on disjoint device rows in parallel and the stacked chunk is
    # kept (the reference's GPU-1 also idles after its break).
    can_exit_early = scen_size == 1
    frozen = None                      # (hit, arr, q_snap, v_snap) rows
    if is_tf:
        _row0 = lambda a: (TF3(a.hi[0:1], a.mid[0:1], a.lo[0:1])
                           if isinstance(a, TF3) else a[0:1])
    else:
        _row0 = lambda a: a[0:1]
    if checkpoint_path is not None:
        import os

        from ..utils.checkpoint import load_checkpoint
        fingerprint = _sharded_fingerprint(scene, cfg, dtype, fast, tile)
        if os.path.exists(checkpoint_path):
            step, qc, vc, extra, meta = load_checkpoint(checkpoint_path)
            if meta.get("fingerprint") != fingerprint:
                raise ValueError(
                    f"checkpoint {checkpoint_path} was written for a "
                    "different scene/config/precision/tile — refusing to "
                    "resume (delete it or pass a fresh path)")
            t0 = int(step)
            if t0 > cfg.n_steps:
                raise ValueError(
                    f"checkpoint {checkpoint_path} is at step {t0}, beyond "
                    f"this run's horizon n_steps={cfg.n_steps}")
            unpack = _ckpt_unpack_fn(dtype)
            hit2 = extra["hit"].astype(np.int32)
            arr2 = extra["arr"].astype(np.int32)
            qs2, vs2 = unpack(extra["q_snap"]), unpack(extra["v_snap"])
            if meta.get("phase") == "p1":
                # saved after the early-exit switch: q/v/min_d2 are the
                # 1-row devices-off state; hit/arr/snaps the frozen rows
                if scen_size != 1:
                    raise ValueError(
                        "checkpoint was written post-early-exit (P1-only "
                        "phase) and can only resume on a scen=1 mesh")
                frozen = (put(hit2, P("scen")), put(arr2, P("scen", None)),
                          put(qs2, snap_spec),
                          put(vs2, snap_spec))
                carry = (
                    put(unpack(qc), state_spec),
                    put(unpack(vc), state_spec),
                    put(unpack(extra["min_d2"]), P("scen")),
                    put(hit2[0:1], P("scen")),
                    put(arr2[0:1], P("scen", None)),
                    put(_row0(qs2), snap_spec),
                    put(_row0(vs2), snap_spec),
                )
                m0_j, mh_j = _row0(m0_j), _row0(mh_j)
            else:
                carry = (
                    put(unpack(qc), state_spec),
                    put(unpack(vc), state_spec),
                    put(unpack(extra["min_d2"]), P("scen")),
                    put(hit2, P("scen")),
                    put(arr2, P("scen", None)),
                    put(qs2, snap_spec),
                    put(vs2, snap_spec),
                )
    hit_h = int(np.asarray(carry[3] if frozen is None else frozen[0])[1])
    while t0 < cfg.n_steps:
        if can_exit_early and hit_h != -2 and frozen is None:
            qd, vd, min_d2, hit, arr, q_snap, v_snap = carry
            frozen = (hit, arr, q_snap, v_snap)
            carry = tuple(_row0(x) for x in carry)
            m0_j, mh_j = _row0(m0_j), _row0(mh_j)
        cs = min(host_chunk, cfg.n_steps - t0)
        fst_chunk = np.zeros(host_chunk, host_dtype)
        fst_chunk[:cs] = fstd[t0 + 1: t0 + 1 + cs]
        rep = NamedSharding(mesh, P())
        if is_tf:
            carry = _p12_chunk_sharded_tf3(
                *carry, m0_j, mh_j, poh, aoh, doh,
                jax.device_put(conv(fst_chunk), rep),
                jax.device_put(np.int32(t0), rep),
                mesh=mesh, n_steps=cfg.n_steps, dt=cfg.dt, eps=cfg.eps,
                G=cfg.G, planet_radius=cfg.planet_radius,
                missile_speed=cfg.missile_speed, tile=tile,
                grid=(dtype == "tf3grid"))
        elif is_e64:
            carry = _p12_chunk_sharded_e64(
                *carry, m0_j, mh_j, didx_j,
                jax.device_put(conv(fst_chunk), rep),
                jax.device_put(np.int32(t0), rep),
                mesh=mesh, n_steps=cfg.n_steps, dt=cfg.dt, eps=cfg.eps,
                G=cfg.G, planet_radius=cfg.planet_radius,
                missile_speed=cfg.missile_speed,
                planet=scene.planet, asteroid=scene.asteroid)
        else:
            carry = _p12_chunk_sharded(
                *carry, m0_j, mh_j, poh, aoh, doh,
                jax.device_put(fst_chunk, rep),
                jax.device_put(np.int32(t0), rep),
                mesh=mesh, n_steps=cfg.n_steps, dt=cfg.dt, eps=cfg.eps,
                G=cfg.G, planet_radius=cfg.planet_radius,
                missile_speed=cfg.missile_speed,
                dist3_mode=cfg.dist3_mode or "dsqrt", fast=fast, tile=tile)
        t0 += cs
        if can_exit_early and frozen is None:
            hit_h = int(np.asarray(carry[3])[1])
        if checkpoint_path is not None:
            from ..utils.checkpoint import save_checkpoint
            qd, vd, min_d2, hit, arr, q_snap, v_snap = carry
            if frozen is not None:
                hit, arr, q_snap, v_snap = frozen
            save_checkpoint(
                checkpoint_path, step=t0, q=_ckpt_pack(qd), v=_ckpt_pack(vd),
                extra={"min_d2": _ckpt_pack(min_d2),
                       "hit": np.asarray(hit), "arr": np.asarray(arr),
                       "q_snap": _ckpt_pack(q_snap),
                       "v_snap": _ckpt_pack(v_snap)},
                meta={"n_steps": cfg.n_steps, "fingerprint": fingerprint,
                      "phase": "p1" if frozen is not None else "p12"})

    _, _, min_d2, hit, arr, q_snap, v_snap = carry
    if frozen is not None:
        # early-exited: P2/P3 outputs were settled at the switch; only the
        # devices-off row (min_d2) kept marching
        hit, arr, q_snap, v_snap = frozen
    hit = np.asarray(hit)
    arr = np.asarray(arr)
    # Problem 1 answer from the devices-off row; Problem 2/3 state from the
    # devices-on row (hw5.cu: tid 0 vs tid 1 in t_problem_12).
    if is_tf:
        return P12Result(
            min_dist=float(np.sqrt(tfloat.to_f64(min_d2)[0])),
            hit_time_step=int(hit[1]),
            arrivals=arr[1][:D],
            q_snaps=tfloat.to_f64(q_snap)[1][:D],
            v_snaps=tfloat.to_f64(v_snap)[1][:D],
            q_snaps_tf=_host_tf(q_snap)[1, :D],
            v_snaps_tf=_host_tf(v_snap)[1, :D],
        )
    if is_e64:
        # E64 <-> f64 is exact: the f64 views are lossless (direct_sum's
        # single-device e64 return path)
        host_e = lambda x: f64emu.e64_to_f64(
            f64emu.E64(np.asarray(x.hi), np.asarray(x.lo)))
        return P12Result(
            min_dist=float(np.sqrt(host_e(min_d2)[0])),
            hit_time_step=int(hit[1]),
            arrivals=arr[1][:D],
            q_snaps=host_e(q_snap)[1][:D],
            v_snaps=host_e(v_snap)[1][:D],
        )
    min_d2, q_snap, v_snap = (np.asarray(x) for x in
                              (min_d2, q_snap, v_snap))
    return P12Result(
        min_dist=float(np.sqrt(min_d2[0])),
        hit_time_step=int(hit[1]),
        arrivals=arr[1][:D],
        q_snaps=q_snap[1][:D],
        v_snaps=v_snap[1][:D],
    )


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "n_steps", "dt", "eps", "G", "planet_radius",
                     "dist3_mode", "fast", "tile", "chunk_steps"))
def _p3_chunks_sharded(q, v, hit_flag, undecided_any, c_start, c_limit,
                       arrivals, eligible, m0_scen, m_half_scen, planet_oh,
                       asteroid_oh, fst, *, mesh: Mesh, n_steps, dt, eps, G,
                       planet_radius, dist3_mode, fast, tile, chunk_steps):
    """Sharded twin of models/direct_sum._p3_chunks: the batched resumed
    P3 scenarios (hw5.cu:438-530), scenarios over 'scen', bodies over
    'body', with the same frozen-until-arrival masking and all-decided
    early exit."""
    state_spec = P("scen", "body", None)

    def local_chunks(q, v, hit_flag, undecided_any, c_start, c_limit,
                     arrivals, eligible, m0_scen, m_half_scen, p_oh, a_oh,
                     fst):
        r2 = planet_radius * planet_radius
        cs = int(chunk_steps)

        def scen_step(q1, v1, hit1, arr1, m0_1, mh_1, t):
            active = (t > arr1) & (t <= jnp.int32(n_steps))
            fst_t = fst[jnp.minimum(t, jnp.int32(n_steps))]
            m_eff = m0_1 + mh_1 * fst_t
            a = ring_accel_ordered(q1, G * m_eff, axis_name="body", eps=eps,
                                   tile=tile, dist3_mode=dist3_mode,
                                   fast=fast)
            v2 = v1 + a * dt
            q2 = q1 + v2 * dt
            q1 = jnp.where(active, q2, q1)
            v1 = jnp.where(active, v2, v1)
            rows = _extract_rows(q1, jnp.stack([p_oh, a_oh]), "body")
            dpa = rows[0] - rows[1]
            d2_pa = (dpa[0] * dpa[0] + dpa[1] * dpa[1] + dpa[2] * dpa[2])
            hit1 = hit1 | (active & (d2_pa < r2))
            return q1, v1, hit1

        def step_body(t, carry):
            q, v, hit_flag = carry
            t = t.astype(jnp.int32)
            return jax.vmap(scen_step, in_axes=(0, 0, 0, 0, 0, 0, None))(
                q, v, hit_flag, arrivals, m0_scen, m_half_scen, t)

        def chunk_body(carry):
            c, q, v, hit_flag, _ = carry
            t0 = c * cs + 1
            q, v, hit_flag = lax.fori_loop(t0, t0 + cs, step_body,
                                           (q, v, hit_flag))
            undec = eligible & ~hit_flag
            any_undec = lax.psum(jnp.sum(undec.astype(jnp.int32)),
                                 "scen") > 0
            return c + 1, q, v, hit_flag, any_undec

        def chunk_cond(carry):
            c, _, _, _, any_undec = carry
            return (c < c_limit) & any_undec

        init = (c_start.astype(jnp.int32), q, v, hit_flag, undecided_any)
        c, q, v, hit_flag, _ = lax.while_loop(chunk_cond, chunk_body, init)
        return c, q, v, hit_flag

    fn = jax.shard_map(
        local_chunks, mesh=mesh,
        in_specs=(state_spec, state_spec, P("scen"), P(), P(), P(),
                  P("scen"), P("scen"), P("scen", "body"),
                  P("scen", "body"), P("body"), P("body"), P()),
        out_specs=(P(), state_spec, state_spec, P("scen")))
    return fn(q, v, hit_flag, undecided_any, c_start, c_limit, arrivals,
              eligible, m0_scen, m_half_scen, planet_oh, asteroid_oh, fst)


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "n_steps", "dt", "eps", "G", "planet_radius",
                     "tile", "chunk_steps", "grid"))
def _p3_chunks_sharded_tf3(q, v, hit_flag, undecided_any, c_start, c_limit,
                           arrivals, eligible, m0_scen, m_half_scen,
                           planet_oh, asteroid_oh, fst, *, mesh: Mesh,
                           n_steps, dt, eps, G, planet_radius, tile,
                           chunk_steps, grid):
    """Triple-f32 twin of _p3_chunks_sharded (tf3 / tf3grid dtypes)."""
    from ..models.direct_sum import _sq_dist
    from ..ops import tfloat
    from ..ops.tfloat import TF3

    state_spec = P("scen", "body", None)

    def local_chunks(q, v, hit_flag, undecided_any, c_start, c_limit,
                     arrivals, eligible, m0_scen, m_half_scen, p_oh, a_oh,
                     fh, fm, fl):
        pr = tfloat.const(planet_radius)
        r2 = pr * pr
        cs = int(chunk_steps)

        def scen_step(q1, v1, hit1, arr1, m0_1, mh_1, t):
            active = (t > arr1) & (t <= jnp.int32(n_steps))
            ti = jnp.minimum(t, jnp.int32(n_steps))
            fst_t = TF3(fh[ti], fm[ti], fl[ti])
            m_eff = m0_1 + mh_1 * fst_t
            a = ring_accel_ordered_tf3(q1, m_eff, axis_name="body",
                                       eps=eps, G=G, tile=tile)
            if grid:
                v2 = tfloat.round53(v1 + tfloat.round53(a * dt))
                q2 = tfloat.round53(q1 + tfloat.round53(v2 * dt))
            else:
                v2 = v1 + a * dt
                q2 = q1 + v2 * dt
            q1 = tfloat.where(active, q2, q1)
            v1 = tfloat.where(active, v2, v1)
            sel = jnp.stack([p_oh, a_oh])
            rows = TF3(lax.psum(sel @ q1.hi, "body"),
                       lax.psum(sel @ q1.mid, "body"),
                       lax.psum(sel @ q1.lo, "body"))
            d2_pa = _sq_dist(rows[0], rows[1], grid=grid)
            hit1 = hit1 | (active & (d2_pa < r2))
            return q1, v1, hit1

        def step_body(t, carry):
            q, v, hit_flag = carry
            t = t.astype(jnp.int32)
            return jax.vmap(scen_step, in_axes=(0, 0, 0, 0, 0, 0, None))(
                q, v, hit_flag, arrivals, m0_scen, m_half_scen, t)

        def chunk_body(carry):
            c, q, v, hit_flag, _ = carry
            t0 = c * cs + 1
            q, v, hit_flag = lax.fori_loop(t0, t0 + cs, step_body,
                                           (q, v, hit_flag))
            undec = eligible & ~hit_flag
            any_undec = lax.psum(jnp.sum(undec.astype(jnp.int32)),
                                 "scen") > 0
            return c + 1, q, v, hit_flag, any_undec

        def chunk_cond(carry):
            c, _, _, _, any_undec = carry
            return (c < c_limit) & any_undec

        init = (c_start.astype(jnp.int32), q, v, hit_flag, undecided_any)
        c, q, v, hit_flag, _ = lax.while_loop(chunk_cond, chunk_body, init)
        return c, q, v, hit_flag

    fn = jax.shard_map(
        local_chunks, mesh=mesh,
        in_specs=(state_spec, state_spec, P("scen"), P(), P(), P(),
                  P("scen"), P("scen"), P("scen", "body"),
                  P("scen", "body"), P("body"), P("body"), P(), P(), P()),
        out_specs=(P(), state_spec, state_spec, P("scen")))
    return fn(q, v, hit_flag, undecided_any, c_start, c_limit, arrivals,
              eligible, m0_scen, m_half_scen, planet_oh, asteroid_oh,
              fst.hi, fst.mid, fst.lo)


def run_problem_3_sharded(scene, p12, fst, cfg: SimConfig, mesh: Mesh, *,
                          dtype=np.float64, fast: bool = False,
                          tile: int | None = None,
                          host_chunks: int | None = None,
                          checkpoint_path: str | None = None) -> np.ndarray:
    """Mesh-sharded Problem 3: same contract as
    models/direct_sum.run_problem_3 (batched strategy), scenarios padded to
    a multiple of the 'scen' axis with frozen ineligible rows.

    host_chunks bounds `chunk_steps`-step device chunks per call (default:
    everything on CPU meshes, bounded calls on accelerators).
    checkpoint_path: persist (chunk, q, v, hit flags) to `<path>.p3.npz`
    after each host chunk and resume from it — mirrors
    direct_sum._run_p3_scenarios (bit-identical after a kill-and-rerun)."""
    from ..models.direct_sum import _ckpt_pack, _ckpt_unpack_fn
    from ..ops import tfloat
    from ..ops.tfloat import TF3

    D = scene.device_cnt
    if D == 0:
        return np.zeros((0,), dtype=bool)
    eligible = (p12.arrivals != -2) & (p12.arrivals <= p12.hit_time_step)
    if not eligible.any():
        return np.zeros((D,), dtype=bool)

    from ..ops import f64emu

    is_tf = isinstance(dtype, str) and dtype in ("tf3", "tf3grid")
    is_e64 = isinstance(dtype, str) and dtype == "e64"
    host_dtype = np.float64 if (is_tf or is_e64) else dtype
    if is_tf:
        conv = lambda a: tfloat.from_f64(np.asarray(a, np.float64))
    elif is_e64:
        conv = lambda a: f64emu.e64_from_f64_tree(np.asarray(a, np.float64))
    else:
        conv = lambda a: np.asarray(a, dtype)

    n = scene.n
    scen_size = mesh.shape["scen"]
    body_size = mesh.shape["body"]
    tile = tile or (n // body_size)
    Dp = -(-D // scen_size) * scen_size          # pad to scen multiple

    m0_scen = np.tile(np.asarray(scene.m, host_dtype)[None, :], (Dp, 1))
    for k in range(D):
        m0_scen[k, scene.device_idx[k]] = 0.0
    device_mask = np.asarray(scene.device_mask(), host_dtype)
    m_half_scen = 0.5 * m0_scen * device_mask[None, :]

    elig_p = np.zeros(Dp, bool)
    elig_p[:D] = eligible
    cs = cfg.chunk_steps
    n_chunks = (cfg.n_steps + cs - 1) // cs
    arr_masked = np.full(Dp, cfg.n_steps, np.int32)
    arr_masked[:D] = np.where(eligible, p12.arrivals, cfg.n_steps)
    c_start = int(max(int(arr_masked.min()), 0) // cs)

    if is_tf:
        # resume from the FULL-precision snapshots (direct_sum contract)
        z = np.zeros((Dp, n, 3), np.float32)
        qs = TF3(z.copy(), z.copy(), z.copy())
        vs = TF3(z.copy(), z.copy(), z.copy())
        for comp in ("hi", "mid", "lo"):
            getattr(qs, comp)[:D] = getattr(p12.q_snaps_tf, comp)
            getattr(vs, comp)[:D] = getattr(p12.v_snaps_tf, comp)
    elif is_e64:
        # E64 <-> f64 is exact: the f64 snapshots are lossless
        qs = np.zeros((Dp, n, 3), np.float64)
        vs = np.zeros((Dp, n, 3), np.float64)
        qs[:D] = p12.q_snaps
        vs[:D] = p12.v_snaps
        qs, vs = conv(qs), conv(vs)
    else:
        qs = np.zeros((Dp, n, 3), dtype)
        vs = np.zeros((Dp, n, 3), dtype)
        qs[:D] = p12.q_snaps
        vs[:D] = p12.v_snaps
    # host f64 IS correctly-rounded binary64, so this check is bit-exact
    # for the e64 path too (core.cc:149)
    dsnap = (p12.q_snaps[:, scene.planet] - p12.q_snaps[:, scene.asteroid])
    hit0 = np.zeros(Dp, bool)
    hit0[:D] = ((dsnap * dsnap).sum(-1)
                < np.asarray(cfg.planet_radius, np.float64) ** 2)

    if not is_e64:
        oh_dtype = np.float32 if is_tf else dtype
        planet_oh = np.zeros(n, oh_dtype)
        planet_oh[scene.planet] = 1.0
        asteroid_oh = np.zeros(n, oh_dtype)
        asteroid_oh[scene.asteroid] = 1.0

    def put(x, spec):
        return jax.device_put(x, NamedSharding(mesh, spec))

    rep = NamedSharding(mesh, P())
    common = dict(mesh=mesh, n_steps=cfg.n_steps, dt=cfg.dt, eps=cfg.eps,
                  G=cfg.G, planet_radius=cfg.planet_radius, tile=tile,
                  chunk_steps=cs)

    # e64 state is body-replicated (only force rows split; see
    # _p12_chunk_sharded_e64)
    p3_state_spec = (P("scen", None, None) if is_e64
                     else P("scen", "body", None))
    p3_mass_spec = P("scen", None) if is_e64 else P("scen", "body")
    q_j = put(qs, p3_state_spec)
    v_j = put(vs, p3_state_spec)
    hit_j = put(hit0, P("scen"))
    static = (
        put(arr_masked, P("scen")), put(elig_p, P("scen")),
        put(conv(m0_scen), p3_mass_spec),
        put(conv(m_half_scen), p3_mass_spec),
    )
    if not is_e64:
        static = static + (put(planet_oh, P("body")),
                           put(asteroid_oh, P("body")))
    static = static + (jax.device_put(conv(np.asarray(fst, host_dtype)),
                                      rep),)

    if host_chunks is None:
        on_accel = mesh.devices.flat[0].platform != "cpu"
        host_chunks = 30 if on_accel else n_chunks

    c = c_start
    fingerprint = None
    if checkpoint_path is not None:
        import os

        from ..utils.checkpoint import load_checkpoint
        fingerprint = _sharded_fingerprint(scene, cfg, dtype, fast, tile)
        state_path = checkpoint_path + ".p3.npz"
        if os.path.exists(state_path):
            step, qc, vc, extra, meta = load_checkpoint(state_path)
            if meta.get("fingerprint") != fingerprint:
                raise ValueError(
                    f"P3 checkpoint {state_path} was written for a "
                    "different scene/config/precision/tile — refusing to "
                    "resume")
            c = int(step)
            unpack = _ckpt_unpack_fn(dtype)
            q_j = put(unpack(qc), p3_state_spec)
            v_j = put(unpack(vc), p3_state_spec)
            hit_j = put(extra["hit_flag"].astype(bool), P("scen"))

    while c < n_chunks:
        hits_h = np.asarray(hit_j)
        undecided = bool((elig_p & ~hits_h).any())
        if not undecided:
            break
        args = (
            q_j, v_j, hit_j,
            jax.device_put(np.bool_(undecided), rep),
            jax.device_put(np.int32(c), rep),
            jax.device_put(np.int32(min(c + host_chunks, n_chunks)), rep),
        ) + static
        if is_tf:
            c_j, q_j, v_j, hit_j = _p3_chunks_sharded_tf3(
                *args, grid=(dtype == "tf3grid"), **common)
        elif is_e64:
            e64_common = {k_: v_ for k_, v_ in common.items()
                          if k_ != "tile"}
            c_j, q_j, v_j, hit_j = _p3_chunks_sharded_e64(
                *args, planet=scene.planet, asteroid=scene.asteroid,
                **e64_common)
        else:
            c_j, q_j, v_j, hit_j = _p3_chunks_sharded(
                *args, dist3_mode=cfg.dist3_mode or "dsqrt", fast=fast,
                **common)
        c = int(c_j)
        if checkpoint_path is not None:
            from ..utils.checkpoint import save_checkpoint
            save_checkpoint(state_path, step=c, q=_ckpt_pack(q_j),
                            v=_ckpt_pack(v_j),
                            extra={"hit_flag": np.asarray(hit_j)},
                            meta={"fingerprint": fingerprint})
    hits = np.asarray(hit_j)[:D]
    return eligible & ~hits


def solve_scene_sharded(scene, cfg: SimConfig, mesh: Mesh, *,
                        dtype=np.float64, fast: bool = False,
                        tile: int | None = None):
    """End-to-end P1+P2+P3 on a mesh (the sharded twin of
    engine.solve_scene's core, hw5.cu:532-615). The caller is responsible
    for any rescaling (accelerator meshes) and padding to the body axis."""
    from ..engine import Answers, select_winner
    from ..physics import oscillation_table

    fst = oscillation_table(cfg)
    p12 = run_problems_12_sharded(scene, fst, cfg, mesh, dtype=dtype,
                                  fast=fast, tile=tile)
    gravity_device_id, missile_cost = -1, 0.0
    if p12.hit_time_step != -2 and scene.device_cnt > 0:
        saved = run_problem_3_sharded(scene, p12, fst, cfg, mesh,
                                      dtype=dtype, fast=fast, tile=tile)
        gravity_device_id, missile_cost = select_winner(
            scene, p12.arrivals, saved, cfg)
    return Answers(min_dist=float(np.sqrt(np.float64(p12.min_dist) ** 2)),
                   hit_time_step=p12.hit_time_step,
                   gravity_device_id=gravity_device_id,
                   missile_cost=missile_cost), p12
