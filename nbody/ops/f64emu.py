"""Bit-exact IEEE binary64 ("e64") arithmetic from int32/uint32 vector ops.

Why this exists: the graded outputs are a robust fixpoint of IEEE-f64
ARITHMETIC, not of the continuum dynamics (ops/tfloat.round53 documents the
measurement: the true trajectory lands 151x off the golden min_dist), and
triple-f32 computes the TRUTH rather than the graded fixpoint. The way to
GUARANTEE the reference's answers independently of how a device rounds or
reduces floats is to reproduce binary64 semantics exactly: this module
implements correctly-rounded (round-to-nearest, ties-to-even) binary64
add/sub/mul/div/sqrt out of uint32 lane ops, so the solver can run the
serial spec (native/core.cc advance(); samples/nbody.cc:57-88;
hw5.cu:199-239) bit-for-bit on the device — the same guarantee as the
native oracle.

Design: values travel as packed IEEE pairs (hi, lo uint32 — exactly the
two halves of the double's bit pattern). Each op unpacks, computes the
EXACT result in integer arithmetic, and rounds once:

  * add/sub — 28-bit limbs (carries fit in uint32): align with a 28-bit
    guard limb + sticky, add/sub magnitudes, renormalize (clz), RNE tail.
  * mul — 14-bit limbs: all 16 partial products are exact in uint32
    (< 2^28) and column sums stay < 2^30, so the 106-bit product is exact;
    top 53 bits + 28 guard bits + sticky feed the shared RNE tail.
  * div — long division in three float32-estimated digits (17+18+18
    bits), each made exact by an integer remainder update and bounded
    corrections; final RNE compares the exact remainder against B/2.
  * sqrt — float32 seed + two exact-residual correction rounds (integer
    square, float32 quotient of the residual), then +-1 integer fix-ups;
    the final RNE compares the residual against R (sqrt ties are
    impossible).

Scope (matches the solver's domain, validated by the native core): normal
numbers and signed zeros. Subnormal inputs are treated as zero, subnormal
results flush to +-0, overflow saturates to the inf pattern; NaN/inf
arithmetic is not modelled — the graded dynamics live in ~1e-3..1e30 and
never produce them.

Everything here is uint32/int32 lane arithmetic — immune by construction
to the float rewrites that break extended-precision float code under XLA
(fmuladd contraction, constant reassociation; see ops/tfloat.two_prod).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

U32 = jnp.uint32
I32 = jnp.int32
F32 = jnp.float32

_M28 = (1 << 28) - 1
_M14 = (1 << 14) - 1
_HALF28 = 1 << 27          # midpoint of a 28-bit guard field


def _u(x):
    return jnp.asarray(x, U32)


def _i(x):
    return jnp.asarray(x, I32)


# ---------------------------------------------------------------------------
# pack / unpack
# ---------------------------------------------------------------------------

def unpack(hi, lo):
    """Packed IEEE -> (sign, biased_exp:int32, L1, L0).

    L1 holds significand bits 28..52 (incl. the implicit bit — 25 bits),
    L0 bits 0..27. e == 0 (zero or subnormal) yields a zero significand."""
    hi = _u(hi)
    lo = _u(lo)
    s = hi >> 31
    e = _i((hi >> 20) & _u(0x7FF))
    normal = e != 0
    l0 = jnp.where(normal, lo & _u(_M28), _u(0))
    l1 = jnp.where(normal,
                   (lo >> 28) | ((hi & _u(0xFFFFF)) << 4) | _u(1 << 24),
                   _u(0))
    return s, e, l1, l0


def pack(s, e, l1, l0):
    """(sign, biased_exp:int32, L1 in [2^24, 2^25), L0) -> packed IEEE.

    e <= 0 flushes to signed zero; e >= 2047 saturates to signed inf."""
    tiny = e <= 0
    huge = e >= 2047
    eu = _u(jnp.clip(e, 0, 2047))
    l1 = jnp.where(tiny | huge, _u(0), l1)
    l0 = jnp.where(tiny | huge, _u(0), l0)
    eu = jnp.where(tiny, _u(0), jnp.where(huge, _u(2047), eu))
    hi = (s << 31) | (eu << 20) | ((l1 >> 4) & _u(0xFFFFF))
    lo = ((l1 & _u(0xF)) << 28) | l0
    return hi, lo


# ---------------------------------------------------------------------------
# shared rounding tail
# ---------------------------------------------------------------------------
#
# The ops below exist in TWO forms: the packed form (uint32 IEEE pairs in,
# pairs out — the stable external interface) and an UNPACKED form (`*_u`,
# normalized (sign, biased_exp, L1, L0) quads in and out). The unpacked
# forms are what the force kernel chains: eliding the pack/unpack bit
# twiddling between consecutive ops saves ~15-20% of the op stream while
# producing, BY CONSTRUCTION, the same bits — `_round_norm` replicates
# pack-then-unpack semantics exactly (tiny -> true zero quad; overflow ->
# the quad unpack() reads from the inf pattern), and each packed op is
# literally pack(op_u(unpack(...))) (fuzz-validated vs host IEEE f64,
# tests/test_f64emu.py).

def _round_norm(s, e, l1, l0, grd, sticky):
    """RNE-round (L1, L0 | grd28 + sticky) to a NORMALIZED unpacked quad.
    L1 in [2^24, 2^25). Tiny results flush to the zero quad; overflow
    saturates to the quad unpack() produces for the inf pattern — exactly
    pack-then-unpack of the packed rounding tail."""
    up = (grd > _u(_HALF28)) | ((grd == _u(_HALF28))
                               & (sticky | ((l0 & _u(1)) != 0)))
    l0 = l0 + up.astype(U32)
    carry = l0 >> 28
    l0 = l0 & _u(_M28)
    l1 = l1 + carry
    ovf = l1 >> 25                      # rounded up to 2^53
    e = e + _i(ovf)
    l1 = jnp.where(ovf != 0, _u(1 << 24), l1)
    tiny = e <= 0
    huge = e >= 2047
    e = jnp.where(tiny, _i(0), jnp.where(huge, _i(2047), e))
    l1 = jnp.where(tiny, _u(0), jnp.where(huge, _u(1 << 24), l1))
    l0 = jnp.where(tiny | huge, _u(0), l0)
    return s, e, l1, l0


def pack_norm(s, e, l1, l0):
    """Normalized unpacked quad (as produced by _round_norm / the *_u ops)
    -> packed IEEE pair. Inverse of unpack on the ops' output domain."""
    eu = _u(e)
    hi = (s << 31) | (eu << 20) | ((l1 >> 4) & _u(0xFFFFF))
    lo = ((l1 & _u(0xF)) << 28) | l0
    return hi, lo


def _round_pack(s, e, l1, l0, grd, sticky):
    """RNE-round (L1, L0 | grd28 + sticky) and pack. L1 in [2^24, 2^25)."""
    return pack_norm(*_round_norm(s, e, l1, l0, grd, sticky))


# ---------------------------------------------------------------------------
# add / sub
# ---------------------------------------------------------------------------

def add_u(sa, ea, a1, a0, sb, eb, b1, b0):
    """Correctly-rounded binary64 a + b on normalized unpacked quads."""
    # order by magnitude: x = larger (ties -> a), y = smaller
    a_ge = (ea > eb) | ((ea == eb) & ((a1 > b1)
                                      | ((a1 == b1) & (a0 >= b0))))
    sx = jnp.where(a_ge, sa, sb)
    ex = jnp.where(a_ge, ea, eb)
    x1 = jnp.where(a_ge, a1, b1)
    x0 = jnp.where(a_ge, a0, b0)
    ey = jnp.where(a_ge, eb, ea)
    y1 = jnp.where(a_ge, b1, a1)
    y0 = jnp.where(a_ge, b0, a0)
    # a zero y must not distort the alignment distance
    ey = jnp.where(ey == 0, ex, ey)

    # align y: shift right by d into (u1, u0, uE) + sticky
    d = _u(jnp.clip(ex - ey, 0, 84))
    w = d // 28
    r = d % 28
    t1 = jnp.where(w == 0, y1, _u(0))
    t0 = jnp.where(w == 0, y0, jnp.where(w == 1, y1, _u(0)))
    tE = jnp.where(w == 1, y0, jnp.where(w == 2, y1, _u(0)))
    drop = jnp.where(w == 2, y0, jnp.where(w == 3, y1 | y0, _u(0)))
    # bits that fall one limb down under the r-shift (r == 0 -> 0: x << 28
    # keeps only bits 28..31 and the mask clears them)
    fall = lambda x: (x << (_u(28) - r)) & _u(_M28)
    u1 = t1 >> r
    u0 = (t0 >> r) | fall(t1)
    uE = (tE >> r) | fall(t0)
    sticky = (drop | fall(tE)) != 0

    eff_sub = sa != sb

    # magnitude add
    s0 = x0 + u0
    add0 = s0 & _u(_M28)
    add1 = x1 + u1 + (s0 >> 28)
    addE = uE

    # magnitude subtract (|x| >= |y| guaranteed); the guard limb borrows.
    # A nonzero sticky means y's true tail is LARGER than the kept uE, so
    # the kept difference must be reduced by one guard-limb ulp ("borrow
    # from sticky"): value = x - (u + uE + tail); we compute
    # x - u - uE - 1 when tail > 0 and note the sticky still flags
    # inexactness below the guard limb (the tail is strictly between 0 and
    # one guard ulp, so the true value sits strictly between the kept
    # difference and +1 ulp of it — RNE with sticky handles it).
    stky_u = sticky.astype(U32)
    totE = uE + stky_u
    subE = (_u(0) - totE) & _u(_M28)
    brE = (totE != 0).astype(U32)
    lt0 = (x0 < u0 + brE).astype(U32)
    sub0 = (x0 - u0 - brE) & _u(_M28)
    sub1 = x1 - u1 - lt0

    r1 = jnp.where(eff_sub, sub1, add1)
    r0 = jnp.where(eff_sub, sub0, add0)
    rE = jnp.where(eff_sub, subE, addE)

    zero_res = ((r1 | r0 | rE) == 0) & ~sticky

    # normalize: msb position p over (r1@56.., r0@28.., rE@0..); target 80
    msb = lambda x: _i(31) - jax.lax.clz(_i(x))
    p = jnp.where(r1 != 0, _i(56) + msb(r1),
                  jnp.where(r0 != 0, _i(28) + msb(r0), msb(rE)))
    sh = _i(80) - p                      # -1 (carry-out) .. 80 (deep cancel)

    # carry case: one right shift; the dropped bit joins sticky
    c_st = sticky | ((rE & _u(1)) != 0)
    cE = (rE >> 1) | ((r0 & _u(1)) << 27)
    c0 = (r0 >> 1) | ((r1 & _u(1)) << 27)
    c1 = r1 >> 1

    # left-shift case (sh in [0, 80]): funnel left. Deep cancellation
    # (sh > 0) can only happen when the alignment shift was 0 or 1, so
    # sticky is then clear and no bits are invented.
    shl = _u(jnp.clip(sh, 0, 80))
    wl = shl // 28
    rl = shl % 28
    g1 = jnp.where(wl == 0, r1, jnp.where(wl == 1, r0, rE))
    g0 = jnp.where(wl == 0, r0, jnp.where(wl == 1, rE, _u(0)))
    gE = jnp.where(wl == 0, rE, _u(0))
    take = lambda x: jnp.where(rl == 0, _u(0), x >> (_u(28) - rl))
    l1n = ((g1 << rl) | take(g0)) & _u((1 << 25) - 1)
    l0n = ((g0 << rl) | take(gE)) & _u(_M28)
    lEn = (gE << rl) & _u(_M28)

    carry_out = sh == -1
    r1f = jnp.where(carry_out, c1, l1n)
    r0f = jnp.where(carry_out, c0, l0n)
    rEf = jnp.where(carry_out, cE, lEn)
    # boolean select via logic ops: Mosaic cannot lower a bool-VALUED
    # jnp.where (same bits; u32/i32 selects are unaffected)
    stf = (carry_out & c_st) | (~carry_out & sticky)
    ef = ex - sh

    s, e, l1, l0 = _round_norm(sx, ef, r1f, r0f, rEf, stf)

    # zero result: +0 for exact cancellation and (+0)+(-0); -0 only for
    # (-0)+(-0) — sa & sb covers all three (cancellation has sa != sb).
    s = jnp.where(zero_res, sa & sb, s)
    e = jnp.where(zero_res, _i(0), e)
    l1 = jnp.where(zero_res, _u(0), l1)
    l0 = jnp.where(zero_res, _u(0), l0)
    return s, e, l1, l0


def add_pos_u(ea, a1, a0, eb, b1, b0):
    """Correctly-rounded binary64 a + b for NONNEGATIVE a, b (sign +0
    only) on normalized unpacked quads — add_u minus the
    effective-subtract machinery. With both signs positive there is no
    cancellation, so the sum's msb sits at bit 80 or 81 of the
    (r1, r0, rE) window and normalization is at most ONE right shift: the
    clz search and the left funnel-shift drop out entirely (~30 of the
    ~110 lane-ops). Bit-identical to add_u(+0, a, +0, b) — fuzz-gated by
    tests/test_f64emu.py::test_add_pos_matches_add.

    Used by the force kernels' d2 chain (sums of squares + eps^2, all
    products of sqr_u whose sign is constructionally +0). Returns the
    full (s, e, l1, l0) quad with s = +0."""
    a_ge = (ea > eb) | ((ea == eb) & ((a1 > b1)
                                      | ((a1 == b1) & (a0 >= b0))))
    ex = jnp.where(a_ge, ea, eb)
    x1 = jnp.where(a_ge, a1, b1)
    x0 = jnp.where(a_ge, a0, b0)
    ey = jnp.where(a_ge, eb, ea)
    y1 = jnp.where(a_ge, b1, a1)
    y0 = jnp.where(a_ge, b0, a0)
    # a zero y must not distort the alignment distance
    ey = jnp.where(ey == 0, ex, ey)

    # align y exactly as add_u does
    d = _u(jnp.clip(ex - ey, 0, 84))
    w = d // 28
    r = d % 28
    t1 = jnp.where(w == 0, y1, _u(0))
    t0 = jnp.where(w == 0, y0, jnp.where(w == 1, y1, _u(0)))
    tE = jnp.where(w == 1, y0, jnp.where(w == 2, y1, _u(0)))
    drop = jnp.where(w == 2, y0, jnp.where(w == 3, y1 | y0, _u(0)))
    fall = lambda x: (x << (_u(28) - r)) & _u(_M28)
    u1 = t1 >> r
    u0 = (t0 >> r) | fall(t1)
    uE = (tE >> r) | fall(t0)
    sticky = (drop | fall(tE)) != 0

    # magnitude add (the only path)
    s0 = x0 + u0
    r0 = s0 & _u(_M28)
    r1 = x1 + u1 + (s0 >> 28)
    rE = uE

    zero_res = ((r1 | r0 | rE) == 0) & ~sticky

    # normalize: msb 80 (in place) or 81 (one right shift)
    carry_out = (r1 >> 25) != 0
    c_st = sticky | ((rE & _u(1)) != 0)
    r1f = jnp.where(carry_out, r1 >> 1, r1)
    r0f = jnp.where(carry_out, (r0 >> 1) | ((r1 & _u(1)) << 27), r0)
    rEf = jnp.where(carry_out, (rE >> 1) | ((r0 & _u(1)) << 27), rE)
    stf = (carry_out & c_st) | (~carry_out & sticky)
    ef = ex + _i(carry_out)

    sz = _u(jnp.zeros_like(r1))
    s, e, l1, l0 = _round_norm(sz, ef, r1f, r0f, rEf, stf)
    e = jnp.where(zero_res, _i(0), e)
    l1 = jnp.where(zero_res, _u(0), l1)
    l0 = jnp.where(zero_res, _u(0), l0)
    return s, e, l1, l0


def add(ah, al, bh, bl):
    """Correctly-rounded binary64 a + b on packed uint32 pairs."""
    return pack_norm(*add_u(*unpack(ah, al), *unpack(bh, bl)))


def neg(hi, lo):
    return _u(hi) ^ _u(0x80000000), _u(lo)


def neg_u(s, e, l1, l0):
    return s ^ _u(1), e, l1, l0


def sub_u(sa, ea, a1, a0, sb, eb, b1, b0):
    return add_u(sa, ea, a1, a0, sb ^ _u(1), eb, b1, b0)


def sub(ah, al, bh, bl):
    nh, nl = neg(bh, bl)
    return add(ah, al, nh, nl)


# ---------------------------------------------------------------------------
# little-endian 14-bit-limb integer helpers (lists of uint32 arrays)
# ---------------------------------------------------------------------------

def _limbs14(l1, l0):
    """(L1 <= 2^26, L0 < 2^28) -> 4 x 14-bit limbs (m3 may hold 12 bits)."""
    return [l0 & _u(_M14), (l0 >> 14) & _u(_M14),
            l1 & _u(_M14), l1 >> 14]


def _f32_u32(x):
    """float32 -> uint32 truncation for x in [0, 2^32) — bit-identical to
    .astype(U32), but lowered through int32 (Mosaic/Pallas has no
    f32 <-> unsigned casts). Values >= 2^31 take the offset branch."""
    big = x >= F32(2147483648.0)
    lo_ = x.astype(I32).astype(U32)
    hi_ = (x - F32(2147483648.0)).astype(I32).astype(U32) + _u(0x80000000)
    return jnp.where(big, hi_, lo_)


def _limb_f32(lims):
    """float32 approximation of a limb integer (little-endian).

    The uint32 -> float32 cast hops through int32 (limbs are < 2^28, so
    the values are identical): Mosaic/Pallas has no unsigned-to-float
    cast, and the int32 form lowers on every backend."""
    cvt = lambda x: x.astype(I32).astype(F32)
    acc = cvt(lims[-1])
    for lm in lims[-2::-1]:
        acc = acc * F32(1 << 14) + cvt(lm)
    return acc


def _limb_mul(a, b, out_len):
    """Exact product of two limb integers (column sums < 2^31 requires
    len(a) * 16384 * len(b)-ish headroom — fine for <= 8x8)."""
    cols = [None] * (len(a) + len(b) - 1)
    for i_ in range(len(a)):
        for j_ in range(len(b)):
            p = a[i_] * b[j_]
            k = i_ + j_
            cols[k] = p if cols[k] is None else cols[k] + p
    out = []
    cur = _u(jnp.zeros_like(a[0]))
    for k in range(out_len):
        if k < len(cols):
            cur = cur + cols[k]
        out.append(cur & _u(_M14))
        cur = cur >> 14
    return out


def _limb_sqr(a, out_len):
    """Exact square of a limb integer: symmetric partial products — 10
    multiplies instead of 16 for 4 limbs (cross terms doubled with a
    shift). Same exact integer as _limb_mul(a, a, out_len): column sums
    stay < 2^31 (worst column: 2 doubled cross products + a diagonal
    < 2^29 + 2^29 + 2^28)."""
    cols = [None] * (2 * len(a) - 1)

    def acc(k, p):
        cols[k] = p if cols[k] is None else cols[k] + p

    for i_ in range(len(a)):
        acc(2 * i_, a[i_] * a[i_])
        for j_ in range(i_ + 1, len(a)):
            acc(i_ + j_, (a[i_] * a[j_]) << 1)
    out = []
    cur = _u(jnp.zeros_like(a[0]))
    for k in range(out_len):
        if k < len(cols):
            cur = cur + cols[k]
        out.append(cur & _u(_M14))
        cur = cur >> 14
    return out


def _limb_shl(a, nbits, out_len):
    """Left shift by a static bit count; exact while it fits out_len."""
    w_, r_ = divmod(nbits, 14)
    z = _u(jnp.zeros_like(a[0]))
    shifted = [z] * w_ + list(a)
    shifted = shifted[:out_len] + [z] * max(0, out_len - len(shifted))
    if r_ == 0:
        return shifted[:out_len]
    out = []
    carry = z
    for lm in shifted[:out_len]:
        v = (lm << r_) | carry
        out.append(v & _u(_M14))
        carry = v >> 14
    return out


def _limb_add(a, b):
    """a + b (mod 2^(14 len a)); b may be shorter."""
    out = []
    carry = _u(jnp.zeros_like(a[0]))
    for k in range(len(a)):
        v = a[k] + carry + (b[k] if k < len(b) else _u(0))
        out.append(v & _u(_M14))
        carry = v >> 14
    return out


def _limb_sub(a, b):
    """a - b (mod 2^(14 len a)); b may be shorter. Two's complement: a
    negative result shows as top limbs of all-ones."""
    out = []
    borrow = _u(jnp.zeros_like(a[0]))
    for k in range(len(a)):
        bk = (b[k] if k < len(b) else _u(0)) + borrow
        lt = (a[k] < bk).astype(U32)
        out.append((a[k] - bk) & _u(_M14))
        borrow = lt
    return out


def _limb_is_neg(a):
    """Sign of a two's-complement limb value (|value| < 2^(14 len - 1))."""
    return (a[-1] >> 13) != 0


def _limb_neg(a):
    z = [_u(jnp.zeros_like(a[0]))] * len(a)
    return _limb_sub(z, a)


def _limb_cmp(a, b):
    """Returns (a > b, a == b) for nonnegative limb values — decided by
    the highest differing limb."""
    gt = jnp.zeros_like(a[0] > a[0])
    eq = jnp.ones_like(gt)
    for k in reversed(range(max(len(a), len(b)))):
        av = a[k] if k < len(a) else _u(0)
        bv = b[k] if k < len(b) else _u(0)
        gt = gt | (eq & (av > bv))
        eq = eq & (av == bv)
    return gt, eq


def _limb_signed_f32(a):
    """float32 of a two's-complement limb value."""
    is_neg = _limb_is_neg(a)
    mag = _limb_f32(_limb_neg(a))
    pos = _limb_f32(a)
    return jnp.where(is_neg, -mag, pos)


# ---------------------------------------------------------------------------
# mul
# ---------------------------------------------------------------------------

def _mul_tail(s, e, d, zero):
    """Shared rounding tail of mul_u/sqr_u: d = 8 x 14-bit limbs of the
    exact 106-bit significand product; e = candidate exponent before the
    top-bit adjustment."""
    # 28-bit words of the exact 106-bit product (14-bit digits pair up)
    w0 = d[0] | (d[1] << 14)
    w1 = d[2] | (d[3] << 14)
    w2 = d[4] | (d[5] << 14)
    w3 = d[6] | (d[7] << 14)
    # product in [2^104, 2^106): top bit is 105 iff w3 bit 21
    top = (w3 >> 21) & _u(1)
    # top 53 bits + 28 guard bits + sticky for either alignment:
    # k = 0 -> top bit 105, k = 1 -> top bit 104
    def extract(k):
        l1_ = ((w3 << (3 + k)) | (w2 >> (25 - k))) & _u((1 << 25) - 1)
        l0_ = ((w2 << (3 + k)) | (w1 >> (25 - k))) & _u(_M28)
        g_ = ((w1 << (3 + k)) | (w0 >> (25 - k))) & _u(_M28)
        st_ = (w0 & _u((1 << (25 - k)) - 1)) != 0
        return l1_, l0_, g_, st_
    x0 = extract(0)
    x1 = extract(1)
    hi_top = top != 0
    pick = lambda a_, b_: jnp.where(hi_top, a_, b_)
    e = e + _i(top)
    # sticky is a bool: select via logic ops (Mosaic cannot lower a
    # bool-valued jnp.where; same bits)
    st = (hi_top & x0[3]) | (~hi_top & x1[3])
    s, e, l1, l0 = _round_norm(s, e, pick(x0[0], x1[0]), pick(x0[1], x1[1]),
                               pick(x0[2], x1[2]), st)
    e = jnp.where(zero, _i(0), e)
    l1 = jnp.where(zero, _u(0), l1)
    l0 = jnp.where(zero, _u(0), l0)
    return s, e, l1, l0


def mul_u(sa, ea, a1, a0, sb, eb, b1, b0):
    """Correctly-rounded binary64 a * b on normalized unpacked quads."""
    s = sa ^ sb
    zero = (ea == 0) | (eb == 0)
    d = _limb_mul(_limbs14(a1, a0), _limbs14(b1, b0), 8)
    return _mul_tail(s, ea + eb - _i(1023), d, zero)


def sqr_u(sa, ea, a1, a0):
    """Correctly-rounded binary64 a * a: identical bits to
    mul_u(a, a) — the symmetric limb product halves the partial-product
    count (exact integers either way)."""
    zero = ea == 0
    d = _limb_sqr(_limbs14(a1, a0), 8)
    return _mul_tail(jnp.zeros_like(sa), ea + ea - _i(1023), d, zero)


def mul(ah, al, bh, bl):
    """Correctly-rounded binary64 a * b on packed uint32 pairs."""
    return pack_norm(*mul_u(*unpack(ah, al), *unpack(bh, bl)))


# ---------------------------------------------------------------------------
# div
# ---------------------------------------------------------------------------

def _hilo_f32(l3, l2, l1, l0):
    """Double-f32 view of a 4-limb value V = H*2^28 + T (H = l3:l2,
    T = l1:l0, each a 28-bit integer): returns (hh, rest) with
    hh + rest*2^-28 == V*2^-28 to ~2^-45 relative — hh is fl(H) and rest
    recovers H's rounding error exactly in the integer domain, plus fl(T)
    (T's own sub-ulp tail, <= 2^-50 of V, is dropped). Pure casts and
    exact power-of-two scalings: FMA contraction cannot touch it."""
    cvt = lambda x: x.astype(I32).astype(F32)
    H = (l3 << 14) | l2
    T = (l1 << 14) | l0
    hh = cvt(H)
    hl = cvt(H.astype(I32) - hh.astype(I32))   # exact: |H - fl(H)| <= 16
    rest = hl * F32(1 << 28) + cvt(T)
    return hh, rest


def _two_prod_nb(a, b):
    """FMA-proof Dekker two_prod with a barrier-FREE Veltkamp split, for
    use INSIDE Pallas kernels: Mosaic has no optimization_barrier
    lowering, and none is needed there — the barrier in tfloat.split
    guards against XLA's HLO algebraic simplifier rewriting
    c - (c - a) -> a, a pass that never sees the inside of a Mosaic
    kernel (and MLIR arith does not reassociate floats without
    fastmath). Same structure as tfloat.two_prod otherwise: exact
    12-bit-half sub-products combined with pure two_sum chains."""
    from .tfloat import two_sum
    ca = F32(4097.0) * a
    ahi = ca - (ca - a)
    alo = a - ahi
    cb = F32(4097.0) * b
    bhi = cb - (cb - b)
    blo = b - bhi
    s1, r1 = two_sum(ahi * bhi, ahi * blo)
    s2, r2 = two_sum(s1, alo * bhi)
    s3, r3 = two_sum(s2, alo * blo)
    return s3, (r1 + r2) + r3


def _div_prep(b1, b0, in_kernel: bool = False):
    """Divisor-only preparation, shared across dividends dividing by the
    SAME divisor (the force kernel's three axis terms / d3) and across the
    digit iterations: limb decomposition, a Newton-refined double-f32
    reciprocal pre-scaled for the 26-bit digit estimates, and the 6-limb
    two's-complement of -B for the combined fix pass.

    in_kernel: inside a Pallas/Mosaic kernel, use the barrier-free
    two_prod (no optimization_barrier lowering exists; see _two_prod_nb).
    """
    bm = _limbs14(b1, b0)
    z = _u(jnp.zeros_like(b1))
    nbm = _limb_neg(bm + [z, z])         # -B over the 6-limb modulus

    # double-f32 reciprocal of B (rel err ~2^-45): f32 seed + one Newton
    # step whose residual e = 1 - B*r0 is computed from the FMA-proof
    # two_prod (tfloat docstring: XLA:CPU contracts mul+add into fmuladd
    # and strips optimization_barrier, so fl(bh*r0)'s rounding cannot be
    # allowed to carry information).
    if in_kernel:
        two_prod = _two_prod_nb
    else:
        from .tfloat import two_prod
    bh, bl = _hilo_f32(bm[3], bm[2], bm[1], bm[0])
    bh = bh * F32(1 << 28)               # exact; bl stays at unit scale
    r0 = F32(1.0) / bh
    p, pe = two_prod(bh, r0)
    e = ((F32(1.0) - p) - pe) - bl * r0
    rl = r0 * e
    # digit scale: ratio = rem*2^26/B with rem = hh*2^28 + rest, so the
    # hh coefficient is rb*2^(28+26) = rb*2^54 and rest's is 2^-28 of it
    rbs_h = r0 * F32(2.0 ** 54)          # exact power-of-two scalings
    rbs_l = rl * F32(2.0 ** 54)
    rbs_h28 = rbs_h * F32(2.0 ** -28)
    return bm, (rbs_h, rbs_l, rbs_h28), nbm


def _div_core(sa, ea, a1, a0, sb, eb, b1, b0, bm, rb, nbm,
              in_kernel: bool = False):
    """Quotient of one dividend against a prepared divisor (see div_u)."""
    s = sa ^ sb
    zero = ea == 0

    # pre-normalize so the quotient is in [1, 2): if A < B double A
    a_lt = (a1 < b1) | ((a1 == b1) & (a0 < b0))
    a1 = jnp.where(a_lt, (a1 << 1) | (a0 >> 27), a1)   # a1 <= 2^26
    a0 = jnp.where(a_lt, (a0 << 1) & _u(_M28), a0)
    e = ea - eb + _i(1023) - _i(a_lt)

    z = _u(jnp.zeros_like(a1))
    rem = _limbs14(a1, a0) + [z, z]      # 6 limbs: value < 2^55

    rbs_h, rbs_l, rbs_h28 = rb

    # two digits of floor(A*2^52 / B): 27 + 26 bits. Each digit is
    # estimated to ~2^-13 absolute from the EXACT 4-limb remainder
    # (rem < 2B <= 2^55 before each shift, so limbs 4-5 are zero) via a
    # double-f32 product against the prepared reciprocal: hh carries the
    # top 28 bits exactly, rest the next ~24, and the FMA-proof two_prod
    # recovers the rounding of hh*rbs_h — the truncated digit is within
    # {-1, 0, +1} of the true floor, exactly the envelope the combined
    # fix pass below restores (same argument as the former f32-estimated
    # 17+18+18 digit scheme; two estimates of ~40 lane-ops replace a
    # third full shl/mul/sub/fix iteration of ~140).
    if in_kernel:
        two_prod = _two_prod_nb
    else:
        from .tfloat import two_prod
    digits = []
    for _ in range(2):
        hh, rest = _hilo_f32(rem[3], rem[2], rem[1], rem[0])
        p, pe = two_prod(hh, rbs_h)
        lo = pe + hh * rbs_l + rest * rbs_h28
        # floor of the unevaluated pair p + lo: a single f32 sum would
        # quantize to ulp(2^27) = 8 and blow the +-1 envelope — instead
        # split p at its own integral floor (exact: p is either integral
        # or < 2^24) and floor the small residual separately
        qi = p.astype(I32)
        frac = (p - qi.astype(F32)) + lo
        fi = frac.astype(I32)
        fi = fi - (fi.astype(F32) > frac).astype(I32)
        qi = qi + fi
        qi = jnp.where(qi < 0, jnp.zeros_like(qi), qi)
        cap = (1 << 27) + 3
        q = jnp.where(qi > cap, _i(cap), qi).astype(U32)
        rem = _limb_shl(rem, 26, 6)
        rem = _limb_sub(rem, _limb_mul([q & _u(_M14), q >> 14], bm, 6))
        # bring rem into [0, B): the digit error is in {-1, 0, +1}, so
        # rem is in (-B, 2B) — the two cases are mutually exclusive and
        # ONE combined pass fixes both: add B when negative, add -B when
        # >= B (fuzz confirms — 0 mismatches).
        neg_ = _limb_is_neg(rem)
        gt, eq = _limb_cmp(rem, bm)
        ge = ~neg_ & (gt | eq)
        q = q - neg_.astype(U32) + ge.astype(U32)
        fix = [jnp.where(neg_, b_, jnp.where(ge, nb_, z))
               for b_, nb_ in zip(bm + [z, z], nbm)]
        rem = _limb_add(rem, fix)
        digits.append(q)

    d0, d1 = digits                      # d0 in [2^26, 2^27), d1 < 2^26
    l0q = (d1 | (d0 << 26)) & _u(_M28)
    l1q = (d0 >> 2) & _u((1 << 25) - 1)
    # RNE from the exact remainder: fraction beyond the lsb is rem/B
    two_rem = _limb_shl(rem, 1, 6)
    gt, eq = _limb_cmp(two_rem, bm)
    grd = jnp.where(gt, _u(_HALF28 + 1),
                    jnp.where(eq, _u(_HALF28), _u(0)))
    s, e, l1, l0 = _round_norm(s, e, l1q, l0q, grd, jnp.zeros_like(gt))
    e = jnp.where(zero, _i(0), e)
    l1 = jnp.where(zero, _u(0), l1)
    l0 = jnp.where(zero, _u(0), l0)
    return s, e, l1, l0


def div_u(sa, ea, a1, a0, sb, eb, b1, b0):
    """Correctly-rounded binary64 a / b on normalized unpacked quads.

    b must be a nonzero normal (the solver divides only by dist3 > 0);
    a may be zero."""
    bm, rb, nbm = _div_prep(b1, b0)
    return _div_core(sa, ea, a1, a0, sb, eb, b1, b0, bm, rb, nbm)


def div(ah, al, bh, bl):
    """Correctly-rounded binary64 a / b on packed uint32 pairs.

    b must be a nonzero normal (the solver divides only by dist3 > 0);
    a may be zero."""
    return pack_norm(*div_u(*unpack(ah, al), *unpack(bh, bl)))


# ---------------------------------------------------------------------------
# sqrt
# ---------------------------------------------------------------------------

def sqrt_u(sa, ea, a1, a0):
    """Correctly-rounded binary64 sqrt(a), a >= 0 (a = 0 -> 0), on
    normalized unpacked quads."""
    zero = ea == 0

    # value = S * 2^u, S in [2^52, 2^53), u = ea - 1075. Make u even.
    u_ = ea - _i(1075)
    odd = (u_ & _i(1)) != 0              # works for negatives (two's compl.)
    S1 = jnp.where(odd, (a1 << 1) | (a0 >> 27), a1)   # <= 2^26
    S0 = jnp.where(odd, (a0 << 1) & _u(_M28), a0)
    u2 = u_ - _i(odd)
    e_res = (u2 >> 1) + _i(1049)         # arithmetic shift: exact halving

    # N = S2 << 52 in [2^104, 2^106) as 8 limbs; R = round(sqrt(N))
    z = _u(jnp.zeros_like(a1))
    s2l = _limbs14(S1, S0)
    N = _limb_shl(s2l + [z, z, z, z], 52, 8)

    # Double-f32 seed: one exact-residual f32 Newton step lands within
    # ~2^8.5 of sqrt(N) — the error the old limb-domain round-1 ended at
    # (~2^9) — so that whole round (small square + _limb_signed_f32 +
    # correct, ~230 lane-ops) drops out. The chain, working at S2 scale
    # (sqrt(N) = sqrt(S2) * 2^26):
    #   S2 = hh*2^28 + rest (+tail <= 1)      [_hilo_f32 exact recovery]
    #   y0 = fl(sqrt(fl(S2)))                 in [2^26, 2^27], ulp <= 2^3
    #   y0^2 EXACTLY as ahi^2 + 2*ahi*alo + alo^2 via the INTEGER-domain
    #     12+12-bit split of m24 = y0*2^-3 (each partial product has
    #     <= 24 significant bits; no optimization_barrier needed, so the
    #     same code is Mosaic- and XLA-safe, and FMA contraction of any
    #     of these mul+adds is value-identical since every product is
    #     exactly representable)
    #   e = S2 - y0^2: hhs - ahi^2 is Sterbenz-exact (operands agree to
    #     2^-9 rel), each later step rounds at the RESULT's ulp <= 2^8,
    #     total |e - (S2 - y0^2)| <= ~2^10
    #   d = e/(2 y0): |d| <= ~2^4; R0 = (y0 + d)*2^26 within
    #     eps_e/4 + truncation + Newton-2nd-order (2^-20 * 2^26 = 2^6)
    #     <= ~2^8.5 of sqrt(N).
    # Per-op rounding differences across backends (f32 sqrt/div ulps)
    # only move R0 within this envelope — the exact fix-up below makes
    # the result bit-identical everywhere regardless.
    hh, rest = _hilo_f32(s2l[3], s2l[2], s2l[1], s2l[0])
    hhs = hh * F32(2.0 ** 28)            # exact power-of-2 scale
    y0 = jnp.sqrt(hhs + rest)
    m24 = _f32_u32(y0 * F32(2.0 ** -3))  # exact: ulp(y0) <= 2^3
    cvt = lambda x: x.astype(I32).astype(F32)
    ahi = cvt((m24 >> 12) << 12) * F32(8.0)
    alo = cvt(m24 & _u(0xFFF)) * F32(8.0)
    e_res2 = (((hhs - ahi * ahi) - F32(2.0) * (ahi * alo))
              - alo * alo) + rest
    qinv = F32(0.5) / y0
    d0c = e_res2 * qinv
    d0neg = d0c < 0
    d0mag = _f32_u32(jnp.abs(d0c) * F32(2.0 ** 26))   # N-scale, < 2^31
    d0l = [d0mag & _u(_M14), (d0mag >> 14) & _u(_M14), d0mag >> 28]
    # seed placement: m24 * 2^29 -> bits 29..52 (limb2 offset 1)
    Ry = [z, z, (m24 & _u(0x1FFF)) << 1, (m24 >> 13) & _u(_M14)]
    R_up0 = _limb_add(Ry, d0l)
    R_dn0 = _limb_sub(Ry, d0l)
    R = [jnp.where(d0neg, d_, u_2) for d_, u_2 in zip(R_dn0, R_up0)]

    half_rf_inv = qinv * F32(2.0 ** -26)   # 1/(2 sqrt(N)) approx

    # one correction round: R += round((N - R^2) / (2R))
    def _correct(c, R):
        cf = _limb_signed_f32(c)
        dcorr = cf * half_rf_inv         # |d| shrinks 2^9 -> ~1
        dneg = dcorr < 0
        dmag = _f32_u32(jnp.abs(dcorr))
        dl = [dmag & _u(_M14), (dmag >> 14) & _u(_M14), dmag >> 28]
        R_up = _limb_add(R, dl)
        R_dn = _limb_sub(R, dl)
        return [jnp.where(dneg, d_, u_2) for d_, u_2 in zip(R_dn, R_up)]

    c = _limb_sub(N, _limb_sqr(R, 8))
    R = _correct(c, R)

    # exact fix-up: make R = floor(sqrt(N)), c = N - R^2 in [0, 2R].
    # After the seed + one correction round R is within ~2 of
    # floor(sqrt(N)) (residual <= 2^10 with a 2^-22-relative f32
    # quotient, plus truncation), so two +-1 passes cover it. Each pass fixes one step in
    # whichever direction is needed — the div fix-pass trick
    # (_div_core): "R too big" (c < 0) and "R too small" (c >= 2R + 1)
    # are mutually exclusive, so one combined pass replaces a
    # down-round + an up-round. Fuzz at 2.4M cases (scripts/fuzz_f64emu)
    # plus the suite's tie cases confirm the envelope.
    c = _limb_sub(N, _limb_sqr(R, 8))
    one = [_u(jnp.ones_like(a1))] + [z] * 3
    for _ in range(2):
        twoR = _limb_shl(R, 1, 8)
        neg_ = _limb_is_neg(c)           # R too big: R -= 1, c += 2R - 1
        thr = _limb_add(twoR, one)       # 2R + 1
        gt, eq = _limb_cmp(c, thr)
        ge = ~neg_ & (gt | eq)           # R too small: R += 1, c -= 2R + 1
        c_dn = _limb_sub(_limb_add(c, twoR), one)
        c_up = _limb_sub(c, thr)
        R_dn = _limb_sub(R, one)
        R_up = _limb_add(R, one)
        c = [jnp.where(neg_, d_, jnp.where(ge, u_2, cc))
             for d_, u_2, cc in zip(c_dn, c_up, c)]
        R = [jnp.where(neg_, d_, jnp.where(ge, u_2, rr))
             for d_, u_2, rr in zip(R_dn, R_up, R)]

    # RNE: round up iff N > (R + 1/2)^2 <=> c > R (ties impossible)
    gt, _eq = _limb_cmp(c, R)
    l0r = R[0] | (R[1] << 14)
    l1r = R[2] | (R[3] << 14)
    grd = jnp.where(gt, _u(_HALF28 + 1), _u(0))
    s, e, l1, l0 = _round_norm(_u(jnp.zeros_like(sa)), e_res,
                               l1r & _u((1 << 25) - 1), l0r & _u(_M28),
                               grd, jnp.zeros_like(gt))
    e = jnp.where(zero, _i(0), e)
    l1 = jnp.where(zero, _u(0), l1)
    l0 = jnp.where(zero, _u(0), l0)
    return s, e, l1, l0


def sqrt(ah, al):
    """Correctly-rounded binary64 sqrt(a), a >= 0 (a = 0 -> 0)."""
    return pack_norm(*sqrt_u(*unpack(ah, al)))


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------

def lt(ah, al, bh, bl):
    """IEEE a < b for packed pairs (zeros compare equal regardless of
    sign; inf/NaN out of scope)."""
    ah, al, bh, bl = _u(ah), _u(al), _u(bh), _u(bl)
    az = ((ah & _u(0x7FFFFFFF)) | al) == 0
    bz = ((bh & _u(0x7FFFFFFF)) | bl) == 0
    sa = ah >> 31
    sb = bh >> 31
    ma = ah & _u(0x7FFFFFFF)
    mb = bh & _u(0x7FFFFFFF)
    mag_lt = (ma < mb) | ((ma == mb) & (al < bl))
    mag_gt = (ma > mb) | ((ma == mb) & (al > bl))
    both_neg = (sa == 1) & (sb == 1)
    res = jnp.where(both_neg, mag_gt,
                    jnp.where((sa == 0) & (sb == 0), mag_lt,
                              (sa == 1) & (sb == 0)))
    return jnp.where(az & bz, False, res)


# ---------------------------------------------------------------------------
# conversions
# ---------------------------------------------------------------------------

def from_f64(x):
    """Host numpy float64 -> packed (hi, lo) uint32 numpy arrays. Exact."""
    u = np.asarray(x, np.float64).view(np.uint64)
    return (u >> 32).astype(np.uint32), (u & 0xFFFFFFFF).astype(np.uint32)


def to_f64(hi, lo):
    """Packed (hi, lo) -> host numpy float64. Exact."""
    u = (np.asarray(hi, np.uint64) << 32) | np.asarray(lo, np.uint64)
    return u.view(np.float64)


def from_i32(t):
    """Traced int32 -> packed pair, exact for |t| < 2^24 (via an exact
    float32 convert and a bit-level f32 -> f64 widening)."""
    f = t.astype(F32)
    bits = _u(jax.lax.bitcast_convert_type(f, jnp.int32))
    s = bits >> 31
    e32 = (bits >> 23) & _u(0xFF)
    m32 = bits & _u(0x7FFFFF)
    zero = e32 == 0
    e64 = e32 + _u(1023 - 127)
    hi = (s << 31) | (e64 << 20) | (m32 >> 3)
    lo = (m32 & _u(7)) << 29
    hi = jnp.where(zero, s << 31, hi)
    lo = jnp.where(zero, _u(0), lo)
    return hi, lo


# ---------------------------------------------------------------------------
# E64: array-like wrapper with binary64 operator semantics
# ---------------------------------------------------------------------------

@jax.tree_util.register_pytree_node_class
class E64:
    """An array of packed binary64 values (hi, lo uint32 components).

    Every overloaded operator is a correctly-rounded IEEE binary64
    operation (the softfloat ops above), so expressions written with E64
    operands reproduce C++ double expressions bit-for-bit — the property
    the answer-grade 'e64' solver path rests on (it runs
    native/core.cc:98-120's op sequence verbatim)."""

    __slots__ = ("hi", "lo")
    __array_priority__ = 100

    def __init__(self, hi, lo):
        self.hi, self.lo = hi, lo

    # -- pytree protocol ----------------------------------------------------
    def tree_flatten(self):
        return (self.hi, self.lo), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    # -- array-ish surface ---------------------------------------------------
    @property
    def shape(self):
        return jnp.shape(self.hi)

    @property
    def ndim(self):
        return jnp.ndim(self.hi)

    def __getitem__(self, idx):
        return E64(self.hi[idx], self.lo[idx])

    def reshape(self, *s):
        return E64(self.hi.reshape(*s), self.lo.reshape(*s))

    def __repr__(self):
        return f"E64(shape={self.shape})"

    # -- arithmetic (correctly-rounded binary64) -----------------------------
    def __neg__(self):
        h, l = neg(self.hi, self.lo)
        return E64(h, l)

    def __add__(self, other):
        o = _as_e64(other)
        return E64(*add(self.hi, self.lo, o.hi, o.lo))

    __radd__ = __add__

    def __sub__(self, other):
        o = _as_e64(other)
        return E64(*sub(self.hi, self.lo, o.hi, o.lo))

    def __rsub__(self, other):
        o = _as_e64(other)
        return E64(*sub(o.hi, o.lo, self.hi, self.lo))

    def __mul__(self, other):
        o = _as_e64(other)
        return E64(*mul(self.hi, self.lo, o.hi, o.lo))

    __rmul__ = __mul__

    def __truediv__(self, other):
        o = _as_e64(other)
        return E64(*div(self.hi, self.lo, o.hi, o.lo))

    # -- IEEE comparisons ----------------------------------------------------
    def __lt__(self, other):
        o = _as_e64(other)
        return lt(self.hi, self.lo, o.hi, o.lo)

    def __gt__(self, other):
        o = _as_e64(other)
        return lt(o.hi, o.lo, self.hi, self.lo)

    def __le__(self, other):
        o = _as_e64(other)
        return ~lt(o.hi, o.lo, self.hi, self.lo)

    def __ge__(self, other):
        o = _as_e64(other)
        return ~lt(self.hi, self.lo, o.hi, o.lo)


def _as_e64(x):
    if isinstance(x, E64):
        return x
    return const_e(x)


def const_e(x) -> E64:
    """Exact E64 of a Python/f64 scalar (or numpy array)."""
    hi, lo = from_f64(np.float64(x))
    return E64(_u(hi), _u(lo))


def sqrt_e(a: E64) -> E64:
    return E64(*sqrt(a.hi, a.lo))


def where_e(pred, a: E64, b: E64) -> E64:
    return E64(jnp.where(pred, a.hi, b.hi), jnp.where(pred, a.lo, b.lo))


def minimum_e(a: E64, b: E64) -> E64:
    """min with the spec's strict-< update (core.cc:159)."""
    return where_e(b < a, b, a)


def zeros_e(shape) -> E64:
    z = jnp.zeros(shape, U32)
    return E64(z, z)


def is_finite_e(a: E64):
    """False where the exponent field saturated to the inf/NaN pattern."""
    return ((_u(a.hi) >> 20) & _u(0x7FF)) != 0x7FF


def e64_from_f64_tree(x) -> E64:
    """Host f64 array -> E64 with numpy components (device_put-ready)."""
    hi, lo = from_f64(x)
    return E64(hi, lo)


def e64_to_f64(a: E64) -> np.ndarray:
    return to_f64(np.asarray(a.hi), np.asarray(a.lo))
