"""Pairwise softened-gravity accelerations (XLA path).

The XLA answer to the reference's hot kernel `compute_accelerations_gpu`
(hw5.cu:159-215): instead of a 2D CUDA grid with fp64 atomicAdd row
reductions (whose non-deterministic summation order made the reference
disagree with its own goldens on 2/12 cases — SURVEY.md §4), we compute the
full interaction tensor with broadcasting and reduce with a fixed-order
`jnp.sum`. Deterministic by construction: same input → same bits, every run.

a_i = sum_j G * m_j * (q_j - q_i) / (|q_j - q_i|^2 + eps^2)^1.5

The j == i term is exactly zero (softening keeps the denominator finite and
the numerator is 0), and adding 0.0 is an fp identity, so no diagonal mask is
needed — same trick the serial spec's `continue` makes explicit
(samples/nbody.cc:59-60).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax


def _dist3(d2, mode: str):
    if mode == "dsqrt":
        return d2 * jnp.sqrt(d2)
    if mode == "sqrt3":
        return jnp.sqrt(d2 * d2 * d2)
    if mode == "pow":
        return jnp.power(d2, 1.5)
    raise ValueError(f"unknown dist3_mode: {mode}")


def pairwise_accel(q, m_eff, *, G: float, eps: float,
                   dist3_mode: str = "dsqrt"):
    """Exact-order fp64 accelerations (graded path).

    q: (..., n, 3); m_eff: (..., n) effective masses at this step.
    Returns (..., n, 3).

    Per-pair fp64 op order follows samples/nbody.cc:65-72:
      dq = q_j - q_i; d2 = dx*dx + dy*dy + dz*dz + eps*eps;
      term = ((G*m_j) * dq) / dist3.
    """
    # dq[..., i, j, :] = q_j - q_i
    dq = q[..., None, :, :] - q[..., :, None, :]
    d2 = (dq * dq).sum(axis=-1) + (eps * eps)
    dist3 = _dist3(d2, dist3_mode)
    gm = G * m_eff                                      # (..., n) over j
    terms = (gm[..., None, :, None] * dq) / dist3[..., None]
    return terms.sum(axis=-2)                           # reduce over j


def pairwise_accel_tf3(q, m_eff, *, G: float, eps: float,
                       j_tile: int | None = None):
    """Extended-precision (triple-float32, ~2^-64/op) accelerations — the
    extended-precision path (precision 'ddp'). Same physics as pairwise_accel
    (hw5.cu:199-210), rsqrt formulation.

    Flush-safety: XLA flushes f32 subnormals to zero (measured), so a tf3
    value keeps full relative precision only while its ~2^-70-level error
    terms stay normal, i.e. |value| >= ~2^-56. In the engine's rescale
    window d^2 spans ~2^100 across pairs and d^-3 spans ~2^150 — far beyond
    the ~2^90 healthy band, so NO static shift can protect the whole kernel
    (a single 2^32 shift was measured to leave far-pair weights at ~2^-50
    relative error, worse than f64). Every wide-range intermediate therefore
    gets a DYNAMIC exact power-of-two gauge:

      * per-pair: d2 is normalized by its own even exponent e2 to [1, 4);
        rsqrt/cube run entirely in (0.125, 1] — the healthiest band there
        is — and the folded-out factor 2^(-3*e2/2) is re-applied to the
        final per-pair term as one exact exponent-arithmetic scale.
      * per-row (i): each row's terms are anchored so the largest sits at
        ~2^30 before the reduction; terms more than ~105 bits below the
        row max flush to zero — absolute error ~2^-105 of the row's
        acceleration, far beyond f64. The anchor is removed exactly after
        the sum.
      * masses: G*m_j lifted so the largest is ~2^16 (lightest masses
        otherwise sit near the flush boundary), removed in the same final
        unscale.

    Coincident pairs (d2 == eps^2 exactly: the i==j diagonal and zero-mass
    pad bodies at the same point) contribute exactly zero (the numerator dq
    is exactly 0); d2 is replaced by 1 there so the cube stays finite —
    semantics-exact, mirroring the serial spec's `continue`
    (samples/nbody.cc:59-60).

    q: TF3 (..., n, 3); m_eff: TF3 (..., n). Returns TF3 (..., n, 3).
    """
    from . import tfloat as tf

    n = q.shape[-2]
    # Mass gauge: anchor the largest |G*m| at ~2^16 (exact 2^k lift) —
    # global, shared by every j-tile.
    mx = jnp.max(m_eff.hi)
    gm_mag = jnp.float32(abs(G)) * mx
    gscale_e = jnp.where(gm_mag > 0,
                         jnp.int32(16) - tf.exp_bits(gm_mag), jnp.int32(0))
    gscale = tf.exp2_i32(gscale_e)
    g0 = tf.const(G, like=m_eff.hi)
    g_s = tf.TF3(g0.hi * gscale, g0.mid * gscale, g0.lo * gscale)  # exact
    gm = g_s * m_eff

    if j_tile is None:
        j_tile = n if n <= 2048 else 1024
    if n <= j_tile:
        return _tf3_accel_tile(q, q, gm, gscale_e, eps)

    # j-blocked: O(n * j_tile) live memory. Each tile's contribution is
    # computed with the full per-tile gauges and unscaled, then tiles are
    # combined with tf3 adds in fixed ascending order — deterministic;
    # error ~(n/j_tile) * 2^-70 per row, still far beyond f64. (A single
    # tile reproduces the unblocked kernel bit-for-bit.)
    npad = (-n) % j_tile
    if npad:
        padq = [(0, 0)] * (q.ndim - 2) + [(0, npad), (0, 0)]
        padm = [(0, 0)] * (m_eff.ndim - 1) + [(0, npad)]
        pq = lambda a: jnp.pad(a, padq, mode="edge")
        pm = lambda a: jnp.pad(a, padm)               # zero mass -> 0 terms
        qj = tf.TF3(pq(q.hi), pq(q.mid), pq(q.lo))
        gmp = tf.TF3(pm(gm.hi), pm(gm.mid), pm(gm.lo))
    else:
        qj, gmp = q, gm
    nb = (n + npad) // j_tile
    resh = lambda a, extra: jnp.moveaxis(
        a.reshape(a.shape[:a.ndim - 1 - extra] + (nb, j_tile)
                  + a.shape[a.ndim - extra:]), -2 - extra, 0)
    qt = tf.TF3(resh(qj.hi, 1), resh(qj.mid, 1), resh(qj.lo, 1))
    mt = tf.TF3(resh(gmp.hi, 0), resh(gmp.mid, 0), resh(gmp.lo, 0))

    def one_tile(acc, xs):
        qth, qtm, qtl, mth, mtm, mtl = xs
        contrib = _tf3_accel_tile(q, tf.TF3(qth, qtm, qtl),
                                  tf.TF3(mth, mtm, mtl), gscale_e, eps)
        return tf.add(acc, contrib), None

    acc0 = tf.zeros(q.shape)
    acc, _ = lax.scan(one_tile, acc0,
                      (qt.hi, qt.mid, qt.lo, mt.hi, mt.mid, mt.lo))
    return acc


def _tf3_accel_tile(q_i, q_j, gm_j_scaled, gscale_e, eps: float):
    """One j-tile of the tf3 force: accelerations of all q_i rows from the
    q_j tile's bodies (gm_j_scaled = G*m_j lifted by 2^gscale_e). With
    q_j == q_i this IS the original unblocked kernel, op for op."""
    from . import tfloat as tf

    dx = q_j[..., 0][..., None, :] - q_i[..., 0][..., :, None]  # (..., i, j)
    dy = q_j[..., 1][..., None, :] - q_i[..., 1][..., :, None]
    dz = q_j[..., 2][..., None, :] - q_i[..., 2][..., :, None]
    eps2 = tf.const(eps, like=dx.hi) * tf.const(eps, like=dx.hi)
    d2 = dx * dx + dy * dy + dz * dz + eps2
    coincident = tf.eq(d2, eps2)   # |dq|^2 rounds to 0 only for dq == 0
    d2s = tf.where(coincident, tf.const(1.0, like=d2.hi), d2)
    # per-pair even-exponent gauge: d2n = d2 * 2^-e2 in [1, 4)
    e2 = tf.exp_bits(d2s.hi) & jnp.int32(~1)        # round down to even
    d2n = tf.scale_dyn(d2s, tf.exp2_i32(-e2))
    rinvn = tf.rsqrt(d2n)                           # in (0.5, 1]
    rinv3n = (rinvn * rinvn) * rinvn                # in (0.125, 1]
    pe = jnp.int32(-3) * (e2 >> 1)                  # d^-3 = rinv3n * 2^pe
    gm_j = tf.TF3(gm_j_scaled.hi[..., None, :],
                  gm_j_scaled.mid[..., None, :],
                  gm_j_scaled.lo[..., None, :])     # broadcast over i
    w = gm_j * rinv3n                               # (..., i, j), healthy
    comps = []
    for dc in (dx, dy, dz):
        tn = w * dc                                 # term * 2^-pe * gscale
        # row anchor: log2 of each pair's true term is exp_bits(tn.hi) + pe
        # (within 1 bit); anchor the row max at 2^30.
        lt = tf.exp_bits(tn.hi) + pe                # (..., i, j)
        row_l = jnp.max(lt, axis=-1)                # (..., i)
        # Forward anchor applied as two half-exponent multiplies (exactly
        # mirroring the unscale below): a single exp2_i32 factor clamps at
        # 2^127, which would silently scale short any pair whose gauged
        # term sits near the f32 flush floor (desired lift > 127) while the
        # unscale still removes the full anchor — a 2^(lift-127) row error
        # instead of the documented <=2^-105 graceful flush.
        ge = jnp.int32(30) - row_l[..., None] + pe
        tn = tf.scale_dyn(tn, tf.exp2_i32(ge - (ge >> 1)))
        s = tf.sum_binned(tf.scale_dyn(tn, tf.exp2_i32(ge >> 1)), axis=-1)
        # exact unscale: remove the row anchor and the mass gauge. Applied
        # as two half-exponent multiplies so the FACTOR never underflows
        # f32 even for rows whose acceleration sits near (or below) the
        # flush threshold — only the value itself may flush, which is an
        # absolute ~2^-126-class loss, far beyond f64.
        ue = row_l - jnp.int32(30) - gscale_e
        s = tf.scale_dyn(s, tf.exp2_i32(ue - (ue >> 1)))
        comps.append(tf.scale_dyn(s, tf.exp2_i32(ue >> 1)))
    return tf.stack(comps, axis=-1)


def pairwise_accel_blocked(q, m_eff, *, G: float, eps: float,
                           dist3_mode: str = "dsqrt", block: int = 2048):
    """j-blocked variant of `pairwise_accel`: O(n * block) live memory
    instead of the O(n^2) interaction tensor, for large n on accelerators
    (the dd path at N=65536 needs ~100 GB materialized; blocked it needs
    ~1.6 GB). The j-reduction becomes (fixed-order partial sums over
    blocks) + (fixed-order block accumulation) — deterministic, but a
    DIFFERENT rounding order than `pairwise_accel`'s single jnp.sum, so
    the graded f64 CPU path keeps the unblocked kernel (its byte-golden
    record pins that order); dd/f32 are trajectory-grade and unaffected.

    Reference analog: the tiled K5 kernel's shared-memory j-tiles,
    hw5.cu:159-215.
    """
    n = q.shape[-2]
    if n % block != 0:
        # pad j with zero-mass bodies at q[0] (zero-term contributions)
        pad = block - n % block
        padw = [(0, 0)] * (q.ndim - 2) + [(0, pad), (0, 0)]
        q_j = jnp.pad(q, padw, mode="edge")
        m_j = jnp.pad(m_eff, [(0, 0)] * (m_eff.ndim - 1) + [(0, pad)])
    else:
        q_j, m_j = q, m_eff
    nb = q_j.shape[-2] // block
    # (..., nb, block, 3) / (..., nb, block) with the block axis leading
    qb = jnp.moveaxis(
        q_j.reshape(q_j.shape[:-2] + (nb, block, 3)), -3, 0)
    mb = jnp.moveaxis(
        m_j.reshape(m_j.shape[:-1] + (nb, block)), -2, 0)

    def one_block(acc, xs):
        qj, mj = xs
        dq = qj[..., None, :, :] - q[..., :, None, :]   # (..., n, block, 3)
        d2 = (dq * dq).sum(axis=-1) + (eps * eps)
        dist3 = _dist3(d2, dist3_mode)
        gm = G * mj
        terms = (gm[..., None, :, None] * dq) / dist3[..., None]
        return acc + terms.sum(axis=-2), None

    acc0 = jnp.zeros(q.shape, q.dtype)
    acc, _ = lax.scan(one_block, acc0, (qb, mb))
    return acc


def pairwise_accel_e64(q, m_eff, *, G: float, eps: float,
                       fold: str = "serial", j_tile: int | None = None,
                       rows=None):
    """BIT-EXACT binary64 accelerations via the integer softfloat
    (ops/f64emu) — the bit-exact 'e64' path.

    Reproduces native/core.cc:98-110 exactly: per-pair op order
      dx = q[j] - q[i];  d2 = ((dx*dx + dy*dy) + dz*dz) + eps*eps;
      d3 = d2 * sqrt(d2);  term = ((G*m[j]) * dx) / d3
    with every op correctly rounded to binary64, and (fold='serial') the
    j-ascending accumulation order of the serial spec. G*m[j] is hoisted
    out of the i loop — same value bit-for-bit, the spec just recomputes
    it. The j == i term is included instead of skipped: its numerator is
    +-0 so the term is +-0, and accumulating +-0 is an IEEE identity
    (the accumulator can never be -0: it starts +0 and RNE sums of
    nonzeros never produce -0). dist3 is the dsqrt form — measured
    byte-golden against the pow goldens on every testcase.

    The j axis is processed in ascending tiles of `j_tile` (default: whole
    axis up to 2048, then 1024): live memory is O(n * j_tile) instead of
    the O(n^2) interaction tensor, and the serial accumulation order is
    UNCHANGED — tiles ascend and the in-tile fold ascends, so the global
    j order is exactly the spec's.

    fold='tree' replaces the serial j-order with a fixed halving order
    inside each tile (tiles still accumulate in ascending order): still
    deterministic and correctly rounded per op, but not the spec's
    accumulation order (throughput experiments only).

    rows: optional E64 (..., r, 3) — compute accelerations only for these
    i-side positions (q/m_eff stay the j side). The per-row fold is
    row-independent, so splitting rows across calls (or mesh shards, the
    e64 multi-chip path in parallel/solver_sharded) reproduces the full
    computation bit-for-bit.

    q: E64 (..., n, 3); m_eff: E64 (..., n). Returns E64 over rows
    (default: all of q).
    """
    from . import f64emu as fe
    E64 = fe.E64

    n = q.shape[-2]
    if j_tile is None:
        # small tiles: the in-tile fold is fully inlined (compile cost
        # scales with j_tile) and the outer tile scan amortizes the
        # while-loop overhead over the whole tile's pair-term compute.
        # Always leave >= 4 tiles: low trip counts get unrolled back into
        # one straight-line graph, which compiles far slower.
        j_tile = 64 if n > 256 else max(4, (n + 3) // 4)
    # pad j with zero-mass bodies (their terms are +-0: IEEE identity)
    npad = (-n) % j_tile
    qh, ql = q.hi, q.lo
    mh, ml = m_eff.hi, m_eff.lo
    if npad:
        padw = [(0, 0)] * (qh.ndim - 2) + [(0, npad), (0, 0)]
        qh = jnp.pad(qh, padw, mode="edge")
        ql = jnp.pad(ql, padw, mode="edge")
        padm = [(0, 0)] * (mh.ndim - 1) + [(0, npad)]
        mh = jnp.pad(mh, padm)
        ml = jnp.pad(ml, padm)
    nb = (n + npad) // j_tile
    # tile axis leading: (nb, ..., j_tile, [3])
    tile = lambda a, extra: jnp.moveaxis(
        a.reshape(a.shape[:-1 - extra] + (nb, j_tile)
                  + a.shape[a.ndim - extra:]), -2 - extra, 0)
    qth = tile(qh, 1)
    qtl = tile(ql, 1)
    mth = tile(mh, 0)
    mtl = tile(ml, 0)

    # The whole per-pair chain runs in the UNPACKED softfloat domain
    # (fe.add_u/sqr_u/mul_u/_div_core on normalized (s, e, L1, L0) quads):
    # identical bits to the packed ops by construction (fe._round_norm
    # docstring), minus the pack/unpack bit twiddling between consecutive
    # ops. The three axis divisions share one divisor preparation
    # (fe._div_prep — same d3), and squares use the symmetric limb
    # product. The accumulator rides the tile scan as an unpacked quad.
    eps2_u = fe.unpack(*(jnp.asarray(x) for x in
                         fe.from_f64(float(eps) * float(eps))))
    Gc_u = fe.unpack(*(jnp.asarray(x) for x in fe.from_f64(float(G))))
    qi = rows if rows is not None else q
    qi_u = [fe.unpack(qi.hi[..., k][..., :, None],
                      qi.lo[..., k][..., :, None]) for k in range(3)]

    def tile_terms(qth_, qtl_, mth_, mtl_):
        qj = [fe.unpack(qth_[..., k][..., None, :],
                        qtl_[..., k][..., None, :]) for k in range(3)]
        dq = [fe.add_u(*qj[k], *fe.neg_u(*qi_u[k])) for k in range(3)]
        d2 = fe.add_u(*fe.add_u(*fe.add_u(*fe.sqr_u(*dq[0]),
                                          *fe.sqr_u(*dq[1])),
                                *fe.sqr_u(*dq[2])),
                      *eps2_u)
        d3 = fe.mul_u(*d2, *fe.sqrt_u(*d2))
        bm, rb, nbm = fe._div_prep(d3[2], d3[3])
        mt_u = fe.unpack(mth_, mtl_)
        g = fe.mul_u(*Gc_u, *mt_u)
        gmj = tuple(x[..., None, :] for x in g)
        return [fe._div_core(*fe.mul_u(*gmj, *dq[k]), *d3, bm, rb, nbm)
                for k in range(3)]

    def fold_serial(terms, acc):
        # continue the spec's running accumulation THROUGH the tile:
        # acc = (((init + t0) + t1) + ...) — starting from zero and adding
        # the partial afterwards would be a different rounding sequence.
        # The in-tile fold is a PYTHON loop (fully inlined): all three
        # axes advance together per j, and there is no lax.scan here:
        # scan(unroll < length) over a softfloat-add body compiles far
        # slower than the same fold inlined inside the outer tile scan,
        # and a length-n scan fold pays the while-loop overhead per j.
        t3 = [jnp.stack([t[c] for t in terms], axis=-1)
              for c in range(4)]                          # (..., n, T, 3)
        for j in range(t3[0].shape[-2]):
            acc = fe.add_u(*acc, *(x[..., j, :] for x in t3))
        return acc

    def fold_tree(terms, acc):
        t3 = [jnp.stack([t[c] for t in terms], axis=-1)   # (..., n, T, 3)
              for c in range(4)]
        m = t3[0].shape[-2]
        p = 1
        while p < m:
            p *= 2
        if p != m:
            pad = [(0, 0)] * (t3[0].ndim - 2) + [(0, p - m), (0, 0)]
            t3 = [jnp.pad(x, pad) for x in t3]
        cur = tuple(t3)
        while cur[0].shape[-2] > 1:
            h = cur[0].shape[-2] // 2
            cur = fe.add_u(*(x[..., :h, :] for x in cur),
                           *(x[..., h:2 * h, :] for x in cur))
        return fe.add_u(*acc, *(x[..., 0, :] for x in cur))

    folder = fold_serial if fold == "serial" else fold_tree

    def one_tile(acc, xs):
        th, tl, mh_, ml_ = xs
        return folder(tile_terms(th, tl, mh_, ml_), acc), None

    zq = jnp.zeros(qi.shape, jnp.uint32)
    acc0 = (zq, jnp.zeros(qi.shape, jnp.int32), zq, zq)
    if nb == 1:
        acc, _ = one_tile(acc0, (qth[0], qtl[0], mth[0], mtl[0]))
    else:
        acc, _ = lax.scan(one_tile, acc0, (qth, qtl, mth, mtl))
    return E64(*fe.pack_norm(*acc))


def pairwise_accel_e64_T(q, m_eff, *, G: float, eps: float,
                         j_tile: int | None = None):
    """pairwise_accel_e64 in AXIS-FIRST layout: q is E64 (..., 3, n),
    m_eff (..., n); returns E64 (..., 3, n). Bit-identical to the
    axis-last kernel (same op sequence, same j-ascending fold — only the
    array orientation differs, and softfloat ops are elementwise).

    Why it exists (measured, results/ACCURACY.md round 4): with the
    (.., n, 3) layout every fold/integrate softfloat primitive runs on
    arrays whose minor (lane) dimension is 3 — 3 of 128 lanes live, so
    each op touches 32 padded VPU tiles. Putting the n bodies in lanes
    packs them: the serial fold's n add_u per step drop from 32 padded
    tiles to ~1, and the per-pair chain runs (j_tile sublanes, n lanes)
    fully packed instead of (n sublanes, j_tile<=64 of 128 lanes). At the
    graded small-n buckets (n=128) this is the difference between the
    solver being layout-bound and compute-bound.
    """
    from . import f64emu as fe
    E64 = fe.E64

    n = q.shape[-1]
    if j_tile is None:
        j_tile = 64 if n > 256 else max(4, (n + 3) // 4)   # see axis-last
    npad = (-n) % j_tile
    qh, ql = q.hi, q.lo
    mh, ml = m_eff.hi, m_eff.lo
    if npad:
        padw = [(0, 0)] * (qh.ndim - 1) + [(0, npad)]
        qh = jnp.pad(qh, padw, mode="edge")
        ql = jnp.pad(ql, padw, mode="edge")
        mh = jnp.pad(mh, padw)
        ml = jnp.pad(ml, padw)
    nb = (n + npad) // j_tile
    # j-tile axis leading: (nb, ..., [3,] j_tile)
    tile = lambda a: jnp.moveaxis(
        a.reshape(a.shape[:-1] + (nb, j_tile)), -2, 0)
    qth = tile(qh)
    qtl = tile(ql)
    mth = tile(mh)
    mtl = tile(ml)

    eps2_u = fe.unpack(*(jnp.asarray(x) for x in
                         fe.from_f64(float(eps) * float(eps))))
    Gc_u = fe.unpack(*(jnp.asarray(x) for x in fe.from_f64(float(G))))
    # i side: bodies in lanes, one broadcast row per axis — (..., 1, n)
    qi_u = [fe.unpack(q.hi[..., k, None, :], q.lo[..., k, None, :])
            for k in range(3)]

    def tile_terms(qth_, qtl_, mth_, mtl_):
        # j side: tile bodies in sublanes — (..., j_tile, 1)
        qj = [fe.unpack(qth_[..., k, :, None], qtl_[..., k, :, None])
              for k in range(3)]
        dq = [fe.add_u(*qj[k], *fe.neg_u(*qi_u[k])) for k in range(3)]
        d2 = fe.add_u(*fe.add_u(*fe.add_u(*fe.sqr_u(*dq[0]),
                                          *fe.sqr_u(*dq[1])),
                                *fe.sqr_u(*dq[2])),
                      *eps2_u)
        d3 = fe.mul_u(*d2, *fe.sqrt_u(*d2))
        bm, rb, nbm = fe._div_prep(d3[2], d3[3])
        mt_u = fe.unpack(mth_[..., :, None], mtl_[..., :, None])
        gmj = fe.mul_u(*Gc_u, *mt_u)                       # (..., T, 1)
        return [fe._div_core(*fe.mul_u(*gmj, *dq[k]), *d3, bm, rb, nbm)
                for k in range(3)]

    def fold_serial(terms, acc):
        # spec's running j-ascending accumulation, one (.., 3, n)-shaped
        # add per j (3 sublanes, n lanes — the packed orientation)
        t3 = [jnp.stack([t[c] for t in terms], axis=-2)
              for c in range(4)]                           # (..., T, 3, n)
        for j in range(t3[0].shape[-3]):
            acc = fe.add_u(*acc, *(x[..., j, :, :] for x in t3))
        return acc

    def one_tile(acc, xs):
        th, tl, mh_, ml_ = xs
        return fold_serial(tile_terms(th, tl, mh_, ml_), acc), None

    zq = jnp.zeros(q.shape, jnp.uint32)
    acc0 = (zq, jnp.zeros(q.shape, jnp.int32), zq, zq)
    if nb == 1:
        acc, _ = one_tile(acc0, (qth[0], qtl[0], mth[0], mtl[0]))
    else:
        acc, _ = lax.scan(one_tile, acc0, (qth, qtl, mth, mtl))
    return E64(*fe.pack_norm(*acc))


def pairwise_accel_fast(q, m_eff, *, G: float, eps: float):
    """Throughput-oriented variant (fp32/bf16 paths): rsqrt instead of a
    divide, factored as w_ij = (G*m_j) * inv_d^3; a = sum_j w_ij * dq."""
    dq = q[..., None, :, :] - q[..., :, None, :]
    d2 = (dq * dq).sum(axis=-1) + (eps * eps)
    inv_d = lax.rsqrt(d2)
    w = (G * m_eff)[..., None, :] * (inv_d * inv_d * inv_d)
    return (w[..., None] * dq).sum(axis=-2)
