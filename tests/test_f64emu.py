"""Bit-exactness of the e64 softfloat (ops/f64emu) vs host IEEE binary64.

Every op must agree with numpy float64 BIT-FOR-BIT (uint64 view compare) on
random, adversarial, and special-value inputs — this is the property the
bit-exact e64 path rests on (the solver runs native/core.cc semantics
through these ops; a single wrong ulp would chaos-amplify over 200001
steps). The standalone fuzz driver at 200k cases x several seeds measured
0 mismatches in ~13.6M cases; this file keeps a fast regression subset.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from nbody.ops import f64emu as fe

N = 20000


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(1234)


def rand_f64(rng, n, max_exp=300):
    sig = rng.integers(0, 1 << 52, n, dtype=np.uint64)
    exp = rng.integers(1023 - max_exp, 1023 + max_exp, n, dtype=np.uint64)
    s = rng.integers(0, 2, n, dtype=np.uint64)
    return ((s << 63) | (exp << 52) | sig).view(np.float64)


def assert_bitexact(op_emu, op_np, a, b=None):
    ah, al = fe.from_f64(a)
    if b is None:
        rh, rl = jax.jit(op_emu)(jnp.asarray(ah), jnp.asarray(al))
        want = op_np(a)
    else:
        bh, bl = fe.from_f64(b)
        rh, rl = jax.jit(op_emu)(jnp.asarray(ah), jnp.asarray(al),
                                 jnp.asarray(bh), jnp.asarray(bl))
        want = op_np(a, b)
    got = fe.to_f64(np.asarray(rh), np.asarray(rl))
    wu = want.view(np.uint64)
    gu = got.view(np.uint64)
    # out of scope: subnormal / inf / nan reference results
    we = (wu >> 52) & 0x7FF
    inscope = ((we != 0) & (we != 0x7FF)) | ((wu & ((1 << 63) - 1)) == 0)
    bad = (wu != gu) & inscope
    assert not bad.any(), (
        f"{int(bad.sum())} mismatches; first: a={a[bad][0]!r}"
        + (f" b={b[bad][0]!r}" if b is not None else "")
        + f" want={want[bad][0]!r} got={got[bad][0]!r}")


def test_add_random_wide(rng):
    assert_bitexact(fe.add, np.add, rand_f64(rng, N), rand_f64(rng, N))


def test_add_cancellation(rng):
    a = rand_f64(rng, N, 200)
    d = rng.integers(-3, 4, N)
    b = -(a * (2.0 ** d) * (1 + rng.standard_normal(N) * 0.5))
    assert_bitexact(fe.add, np.add, a, b.astype(np.float64))
    assert_bitexact(fe.add, np.add, a, -a)          # exact cancel -> +0


def test_add_half_ulp_ties(rng):
    ea = rng.integers(1000, 1040, N, dtype=np.uint64)
    a = ((ea << 52) | rng.integers(0, 1 << 52, N, dtype=np.uint64)
         ).view(np.float64)
    b = np.ldexp(1.0, ea.astype(np.int64) - 1076 + rng.integers(-2, 3, N))
    assert_bitexact(fe.add, np.add, a, np.where(rng.random(N) < .5, -b, b))


def test_add_pos_matches_add(rng):
    """The sign-free same-sign add (add_pos_u, used by the force kernels'
    d2 chain) is bit-identical to the general add on nonnegative inputs —
    wide exponents, half-ulp rounding ties, carry-out sums, and zeros."""
    def add_pos(ah, al, bh, bl):
        ua = fe.unpack(ah, al)
        ub = fe.unpack(bh, bl)
        return fe.pack_norm(*fe.add_pos_u(ua[1], ua[2], ua[3],
                                          ub[1], ub[2], ub[3]))

    a = np.abs(rand_f64(rng, N))
    b = np.abs(rand_f64(rng, N))
    assert_bitexact(add_pos, np.add, a, b)
    # near-equal exponents force the carry-out (one right shift) path
    c = np.abs(rand_f64(rng, N, 200))
    d = c * (2.0 ** rng.integers(-2, 3, N)) * (1 + 0.5 * rng.random(N))
    assert_bitexact(add_pos, np.add, c, d.astype(np.float64))
    # half-ulp ties
    ea = rng.integers(1000, 1040, N, dtype=np.uint64)
    t = ((ea << 52) | rng.integers(0, 1 << 52, N, dtype=np.uint64)
         ).view(np.float64)
    u = np.ldexp(1.0, ea.astype(np.int64) - 1076 + rng.integers(-2, 3, N))
    assert_bitexact(add_pos, np.add, t, u)
    # zeros on either/both sides
    z = np.array([0.0, 0.0, 1.5, 0.0])
    w = np.array([0.0, 2.5, 0.0, 0.0])
    assert_bitexact(add_pos, np.add, z, w)


def test_add_signed_zeros():
    a = np.array([0.0, -0.0, 0.0, -0.0, 1.5, -0.0])
    b = np.array([0.0, -0.0, -0.0, 0.0, -0.0, 2.5])
    assert_bitexact(fe.add, np.add, a, b)


def test_mul_random(rng):
    a = rand_f64(rng, N, 200)
    b = rand_f64(rng, N, 200)
    assert_bitexact(fe.mul, np.multiply, a, b)
    p2 = np.ldexp(1.0, rng.integers(-40, 40, N))
    assert_bitexact(fe.mul, np.multiply, a, p2)
    assert_bitexact(fe.mul, np.multiply,
                    np.where(rng.random(N) < 0.5, 0.0, a), b)


def test_div_random(rng):
    a = rand_f64(rng, N, 200)
    b = rand_f64(rng, N, 200)
    assert_bitexact(fe.div, np.divide, a, b)
    assert_bitexact(fe.div, np.divide, a, np.ldexp(1.0, rng.integers(-40, 40, N)))
    assert_bitexact(fe.div, np.divide,
                    np.where(rng.random(N) < 0.5, 0.0, a), b)


def test_div_exact_ties(rng):
    # a = (q + 1/2) * b lands exactly between representable quotients
    q = rng.integers(1, 1 << 30, N).astype(np.float64)
    b = rng.integers(1, 1 << 20, N).astype(np.float64)
    assert_bitexact(fe.div, np.divide, (q + 0.5) * b, b)


def test_sqrt(rng):
    a = np.abs(rand_f64(rng, N, 300))
    assert_bitexact(fe.sqrt, np.sqrt, a)
    r = rand_f64(rng, N, 25)
    assert_bitexact(fe.sqrt, np.sqrt, r * r)       # exact squares
    assert_bitexact(fe.sqrt, np.sqrt, np.where(rng.random(N) < .3, 0.0, a))


def test_sqrt_square_neighbours(rng):
    # significand-level perfect squares and their +-1/+-2-ulp neighbours
    # across the full even-exponent range: the inputs whose integer
    # sqrt sits exactly at / next to a representable boundary, where the
    # seed's floor/fix-up envelope is tightest (guards the double-f32
    # Newton seed; standalone fuzz: 600k cases clean)
    r = rng.integers(1 << 26, 1 << 27, N, dtype=np.uint64)
    e2 = rng.integers(-400, 400, N) * 2
    base = np.ldexp(r.astype(np.float64) ** 2, e2)   # r^2 < 2^54 exact
    for off in (0, 1, -1, 2, -2):
        x = (base.view(np.uint64).astype(np.int64) + off) \
            .astype(np.uint64).view(np.float64)
        x = x[np.isfinite(x) & (x > 0)]
        assert_bitexact(fe.sqrt, np.sqrt, x)


def test_lt(rng):
    a = rand_f64(rng, N)
    b = np.where(rng.random(N) < 0.3,
                 a * (1 + 1e-16 * rng.integers(-2, 3, N)), rand_f64(rng, N))
    ah, al = fe.from_f64(a)
    bh, bl = fe.from_f64(b)
    got = np.asarray(jax.jit(fe.lt)(jnp.asarray(ah), jnp.asarray(al),
                                    jnp.asarray(bh), jnp.asarray(bl)))
    np.testing.assert_array_equal(got, a < b)
    # signed zeros compare equal
    z1 = np.array([0.0, -0.0, 0.0, 1.0, -1.0])
    z2 = np.array([-0.0, 0.0, 0.0, -0.0, 0.0])
    ah, al = fe.from_f64(z1)
    bh, bl = fe.from_f64(z2)
    got = np.asarray(fe.lt(jnp.asarray(ah), jnp.asarray(al),
                           jnp.asarray(bh), jnp.asarray(bl)))
    np.testing.assert_array_equal(got, z1 < z2)


def test_roundtrip_conversion(rng):
    a = rand_f64(rng, N)
    hi, lo = fe.from_f64(a)
    np.testing.assert_array_equal(fe.to_f64(hi, lo).view(np.uint64),
                                  a.view(np.uint64))


def test_sqr_matches_mul(rng):
    """sqr_u (symmetric limb product) must be bit-identical to mul(a, a)
    for every input class, including squares that overflow/flush."""
    a = rand_f64(rng, N, 300)
    a = np.where(rng.random(N) < 0.1, 0.0, a)
    ah, al = fe.from_f64(a)
    sq = jax.jit(lambda h, l: fe.pack_norm(*fe.sqr_u(*fe.unpack(h, l))))
    rh, rl = sq(jnp.asarray(ah), jnp.asarray(al))
    mh, ml = jax.jit(fe.mul)(jnp.asarray(ah), jnp.asarray(al),
                             jnp.asarray(ah), jnp.asarray(al))
    np.testing.assert_array_equal(np.asarray(rh), np.asarray(mh))
    np.testing.assert_array_equal(np.asarray(rl), np.asarray(ml))


def test_unpacked_chain_matches_packed(rng):
    """A chained unpacked computation (the force kernel's pattern) must be
    bit-identical to the packed op sequence: pack/unpack elision is a
    pure representation change."""
    a = rand_f64(rng, N, 100)
    b = rand_f64(rng, N, 100)
    c = np.abs(rand_f64(rng, N, 100))
    ah, al = fe.from_f64(a)
    bh, bl = fe.from_f64(b)
    ch, cl = fe.from_f64(c)

    def chain_u(ah, al, bh, bl, ch, cl):
        au, bu, cu = fe.unpack(ah, al), fe.unpack(bh, bl), fe.unpack(ch, cl)
        d = fe.add_u(*au, *fe.neg_u(*bu))            # a - b
        d2 = fe.add_u(*fe.sqr_u(*d), *cu)            # (a-b)^2 + c
        d3 = fe.mul_u(*d2, *fe.sqrt_u(*d2))          # d2 * sqrt(d2)
        bm, rb, nbm = fe._div_prep(d3[2], d3[3])
        t = fe._div_core(*fe.mul_u(*au, *d), *d3, bm, rb, nbm)
        return fe.pack_norm(*t)

    def chain_p(ah, al, bh, bl, ch, cl):
        dh, dl = fe.sub(ah, al, bh, bl)
        sh_, sl_ = fe.mul(dh, dl, dh, dl)
        d2h, d2l = fe.add(sh_, sl_, ch, cl)
        rth, rtl = fe.sqrt(d2h, d2l)
        d3h, d3l = fe.mul(d2h, d2l, rth, rtl)
        nh, nl = fe.mul(ah, al, dh, dl)
        return fe.div(nh, nl, d3h, d3l)

    args = tuple(jnp.asarray(x) for x in (ah, al, bh, bl, ch, cl))
    ru = jax.jit(chain_u)(*args)
    rp = jax.jit(chain_p)(*args)
    np.testing.assert_array_equal(np.asarray(ru[0]), np.asarray(rp[0]))
    np.testing.assert_array_equal(np.asarray(ru[1]), np.asarray(rp[1]))
