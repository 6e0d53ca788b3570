"""Exact-arithmetic validation of the triple-float32 library.

References are computed in exact rational arithmetic (fractions.Fraction)
or 60-digit decimal — no floating-point reference error. The bar: every
tf3 operation must land well below IEEE f64's 2^-53 per-op error, because
that is the noise class the golden outputs tolerate (results/ACCURACY.md).
"""

import decimal
from fractions import Fraction

import numpy as np
import pytest

import jax.numpy as jnp

from nbody.ops import tfloat as tf

RNG = np.random.default_rng(42)


def _rand_vals(n, lo_exp=-7, hi_exp=7, rng=None):
    """Random signed magnitudes 10^[lo_exp, hi_exp].

    Default range is the tf3 HEALTHY WINDOW: XLA flushes f32 subnormals to
    zero (measured on the CPU), so a value keeps all three limbs only for
    |x| >= ~2^-78 and an op result keeps full ~2^-65 relative precision
    only for |result| >= ~2^-56. The engine pins every force-path
    intermediate inside this window via the exact 2^k rescale + mass gauge
    + static shifts (utils/rescale.py, ops/forces.pairwise_accel_tf3).

    Pass `rng` to keep a test's draws independent of test-execution order.
    """
    rng = RNG if rng is None else rng
    mag = 10.0 ** rng.uniform(lo_exp, hi_exp, n)
    sign = rng.choice([-1.0, 1.0], n)
    return (sign * mag).astype(np.float64)


def _tf_to_fraction(a, i):
    return (Fraction(float(np.asarray(a.hi)[i]))
            + Fraction(float(np.asarray(a.mid)[i]))
            + Fraction(float(np.asarray(a.lo)[i])))


def _rel_err_fraction(got: Fraction, want: Fraction) -> float:
    if want == 0:
        return float(abs(got))
    return abs(float((got - want) / want))


def test_two_sum_and_product_transforms():
    """two_sum and the 3-term products are EXACT; 2-term two_prod is exact
    to ~2 ulp(e) ~ 2^-69·|ab| (its documented FMA-proof contract)."""
    a = jnp.asarray(_rand_vals(256, -10, 10), jnp.float32)
    b = jnp.asarray(_rand_vals(256, -10, 10), jnp.float32)
    s, e = tf.two_sum(a, b)
    p, f = tf.two_prod(a, b)
    p3, e3, f3 = tf.two_prod3(a, b)
    q3, g3, h3 = tf.two_sq3(a)
    for i in range(256):
        fa, fb = Fraction(float(a[i])), Fraction(float(b[i]))
        assert Fraction(float(s[i])) + Fraction(float(e[i])) == fa + fb
        got2 = Fraction(float(p[i])) + Fraction(float(f[i]))
        # documented contract: ~2^-24·|e|, worst case ~2^-46·|ab|
        assert _rel_err_fraction(got2, fa * fb) < 2.0 ** -46
        assert (Fraction(float(p3[i])) + Fraction(float(e3[i]))
                + Fraction(float(f3[i]))) == fa * fb
        assert (Fraction(float(q3[i])) + Fraction(float(g3[i]))
                + Fraction(float(h3[i]))) == fa * fa


def test_f64_conversion_exact():
    x = _rand_vals(512)
    t = tf.from_f64(x)
    for i in range(0, 512, 17):
        assert _tf_to_fraction(t, i) == Fraction(x[i])
    np.testing.assert_array_equal(tf.to_f64(t), x)


@pytest.mark.parametrize("op,ref", [
    ("add", lambda a, b: a + b),
    ("sub", lambda a, b: a - b),
    ("mul", lambda a, b: a * b),
])
def test_add_sub_mul_accuracy(op, ref):
    """Per-op relative error must be < 2^-62 (f64 is 2^-53; dd is 2^-48)."""
    n = 256
    rng = np.random.default_rng(1000 + len(op))
    x, y = _rand_vals(n, rng=rng), _rand_vals(n, rng=rng)
    if op == "add":   # exercise cancellation too
        y[:64] = -x[:64] * (1 + rng.uniform(-1e-5, 1e-5, 64))
    a, b = tf.from_f64(x), tf.from_f64(y)
    out = {"add": a + b, "sub": a - b, "mul": a * b}[op]
    worst = 0.0
    for i in range(n):
        want = ref(Fraction(x[i]), Fraction(y[i]))
        worst = max(worst, _rel_err_fraction(_tf_to_fraction(out, i), want))
    assert worst < 2.0 ** -62, f"{op} worst rel err {worst}"


def test_tiny_products_graceful_degradation():
    """Below the healthy window, flushed sub-terms cost ABSOLUTE error
    bounded by the f32 flush threshold (each flushed piece < 2^-126 ~
    1.2e-38, a handful of them) — measured worst ~2e-38 across seeds.
    Irrelevant to any force sum in the engine's rescale window (dominant
    terms are > 1e-20)."""
    rng = np.random.default_rng(77)
    x = _rand_vals(128, -18, -15, rng=rng)
    y = _rand_vals(128, -18, -15, rng=rng)
    out = tf.from_f64(x) * tf.from_f64(y)
    worst_abs = 0.0
    for i in range(128):
        want = Fraction(x[i]) * Fraction(y[i])
        worst_abs = max(worst_abs, abs(float(_tf_to_fraction(out, i) - want)))
    assert worst_abs < 4e-38


def test_recip_div_accuracy():
    n = 256
    rng = np.random.default_rng(88)
    x, y = _rand_vals(n, rng=rng), _rand_vals(n, rng=rng)
    a, b = tf.from_f64(x), tf.from_f64(y)
    r = tf.recip(b)
    q = tf.div(a, b)
    worst_r = worst_q = 0.0
    for i in range(n):
        worst_r = max(worst_r, _rel_err_fraction(
            _tf_to_fraction(r, i), 1 / Fraction(y[i])))
        worst_q = max(worst_q, _rel_err_fraction(
            _tf_to_fraction(q, i), Fraction(x[i]) / Fraction(y[i])))
    assert worst_r < 2.0 ** -60, f"recip worst rel err {worst_r}"
    assert worst_q < 2.0 ** -60, f"div worst rel err {worst_q}"


def _decimal_sqrt(x: float) -> decimal.Decimal:
    with decimal.localcontext() as ctx:
        ctx.prec = 60
        return decimal.Decimal(x).sqrt()


def test_rsqrt_sqrt_accuracy():
    n = 256
    # +-14 decimal: x down to 1e-14 keeps all three input limbs normal
    # (below ~2^-78 the lo limb flushes and rsqrt degrades to ~2^-42 —
    # measured; the engine's rescaled d2 always sits in this window)
    rng = np.random.default_rng(99)
    x = np.abs(_rand_vals(n, -14, 14, rng=rng))
    a = tf.from_f64(x)
    rs, sq = tf.rsqrt(a), tf.sqrt(a)
    worst_rs = worst_sq = 0.0
    with decimal.localcontext() as ctx:
        ctx.prec = 60
        for i in range(n):
            want_sq = _decimal_sqrt(x[i])
            want_rs = 1 / want_sq
            got_rs = (decimal.Decimal(float(np.asarray(rs.hi)[i]))
                      + decimal.Decimal(float(np.asarray(rs.mid)[i]))
                      + decimal.Decimal(float(np.asarray(rs.lo)[i])))
            got_sq = (decimal.Decimal(float(np.asarray(sq.hi)[i]))
                      + decimal.Decimal(float(np.asarray(sq.mid)[i]))
                      + decimal.Decimal(float(np.asarray(sq.lo)[i])))
            worst_rs = max(worst_rs, abs(float((got_rs - want_rs) / want_rs)))
            worst_sq = max(worst_sq, abs(float((got_sq - want_sq) / want_sq)))
    assert worst_rs < 2.0 ** -60, f"rsqrt worst rel err {worst_rs}"
    assert worst_sq < 2.0 ** -60, f"sqrt worst rel err {worst_sq}"


def test_rsqrt_full_precision_under_jit():
    """Regression: XLA's algebraic simplifier reassociates float
    expressions involving LITERAL constants, destroying the error-free
    transforms — a jitted Newton iteration with literal 1.5/0.5 collapsed
    to f32 (2^-24) accuracy while eager reached 2^-65. tf.const wraps its
    limbs in optimization_barrier to prevent this; this test pins the fix
    by running the constant-heavy op (rsqrt) UNDER JIT, where the eager
    unit tests above cannot see the problem."""
    import jax

    rng = np.random.default_rng(123)
    x = rng.uniform(1.0, 4.0, 512)          # the normalized kernel domain
    r = jax.jit(tf.rsqrt)(tf.from_f64(x))
    hi = np.asarray(r.hi, np.float64)
    mid = np.asarray(r.mid, np.float64)
    lo = np.asarray(r.lo, np.float64)
    with decimal.localcontext() as ctx:
        ctx.prec = 60
        worst = 0.0
        for i in range(512):
            want = 1 / decimal.Decimal(x[i]).sqrt()
            got = (decimal.Decimal(hi[i]) + decimal.Decimal(mid[i])
                   + decimal.Decimal(lo[i]))
            worst = max(worst, abs(float((got - want) / want)))
    assert worst < 2.0 ** -60, f"jitted rsqrt worst rel err {worst}"


def test_comparisons_resolve_2pow60_differences():
    a = tf.from_f64(np.asarray([1.0]))
    tiny = tf.const(2.0 ** -60, like=jnp.asarray([1.0], jnp.float32))
    b = a + tiny
    assert bool((b > a)[0]) and bool((a < b)[0])
    assert not bool((a > b)[0])
    assert bool((a <= a)[0]) and bool((a >= a)[0])
    m = tf.minimum(a, b)
    assert _tf_to_fraction(m, 0) == _tf_to_fraction(a, 0)


def test_sum_pairwise_accuracy_and_order():
    n = 1000   # non-power-of-two: exercises the zero padding
    x = _rand_vals(n, -5, 5)
    s = tf.sum_pairwise(tf.from_f64(x), axis=0)
    want = sum(Fraction(v) for v in x)
    got = (Fraction(float(np.asarray(s.hi)))
           + Fraction(float(np.asarray(s.mid)))
           + Fraction(float(np.asarray(s.lo))))
    assert _rel_err_fraction(got, want) < 2.0 ** -58
    # determinism: same bits on a rerun
    s2 = tf.sum_pairwise(tf.from_f64(x), axis=0)
    assert float(s.hi) == float(s2.hi)
    assert float(s.mid) == float(s2.mid)
    assert float(s.lo) == float(s2.lo)


def test_where_and_pytree():
    import jax

    x = _rand_vals(8)
    y = _rand_vals(8)
    a, b = tf.from_f64(x), tf.from_f64(y)
    w = tf.where(jnp.arange(8) % 2 == 0, a, b)
    out = tf.to_f64(w)
    np.testing.assert_array_equal(out[::2], x[::2])
    np.testing.assert_array_equal(out[1::2], y[1::2])

    # TF3 must pass through jit/scan as a pytree
    f = jax.jit(lambda t: t + t)
    doubled = f(tf.TF3(jnp.asarray(a.hi), jnp.asarray(a.mid),
                       jnp.asarray(a.lo)))
    np.testing.assert_allclose(tf.to_f64(doubled), 2 * x, rtol=1e-18)


def test_round53_matches_f64_rounding_exactly():
    """round53 must agree with correctly-rounded IEEE-binary64 (math.fsum of
    the three limbs is exactly rounded) — eager AND under jit. This is the
    primitive the answer-grade 'ddp' path rests on (every state update is
    rounded to the f64 grid; see ops/integrate.symplectic_euler_step)."""
    import math

    import jax

    rng = np.random.default_rng(5)
    n = 20000
    hi = (rng.standard_normal(n) * np.exp2(rng.integers(-30, 30, n))
          ).astype(np.float32)
    mid = (hi * rng.standard_normal(n) * 2.0 ** -25).astype(np.float32)
    lo = (hi * rng.standard_normal(n) * 2.0 ** -49).astype(np.float32)
    t = tf.TF3(jnp.asarray(hi), jnp.asarray(mid), jnp.asarray(lo))
    want = np.array([math.fsum([float(hi[i]), float(mid[i]), float(lo[i])])
                     for i in range(n)])
    for f in (tf.round53, jax.jit(tf.round53)):
        out = tf.to_f64(f(t))
        np.testing.assert_array_equal(out, want)


def test_round53_output_is_on_f64_grid():
    rng = np.random.default_rng(6)
    hi = (rng.standard_normal(256) * np.exp2(rng.integers(-20, 20, 256))
          ).astype(np.float32)
    mid = (hi * rng.standard_normal(256) * 2.0 ** -25).astype(np.float32)
    lo = (hi * rng.standard_normal(256) * 2.0 ** -49).astype(np.float32)
    r = tf.round53(tf.TF3(jnp.asarray(hi), jnp.asarray(mid), jnp.asarray(lo)))
    # exactly representable in f64: converting and splitting back is lossless
    back = tf.from_f64(tf.to_f64(r))
    for i in range(256):
        assert _tf_to_fraction(back, i) == _tf_to_fraction(r, i)


def test_sqr_exact_and_jit_safe():
    """sqr (and the `x * x` spelling, which routes to it) must keep full tf3
    accuracy UNDER JIT. Plain mul(a, a) is rewritten by XLA (CSE of the
    equal cross products changes the rounding sequence — see two_sq); the
    square-safe formulation has nothing to rewrite."""
    import jax

    x = _rand_vals(512, -7, 7, rng=np.random.default_rng(7))
    a = tf.from_f64(x)
    a = tf.TF3(jnp.asarray(a.hi), jnp.asarray(a.mid), jnp.asarray(a.lo))
    for f in (lambda t: t * t, jax.jit(lambda t: t * t),
              tf.sqr, jax.jit(tf.sqr)):
        got = f(a)
        worst = max(
            _rel_err_fraction(_tf_to_fraction(got, i),
                              Fraction(x[i]) * Fraction(x[i]))
            for i in range(512))
        assert worst < 2.0 ** -63, f"sqr worst rel err {worst}"


def test_tf3_force_blocked_matches_unblocked():
    """The j-tiled tf3 force (large-n memory path) agrees with the
    single-tile kernel to tile-combination accuracy (~nb * 2^-70-class),
    including a tile size that does not divide n."""
    import jax

    from nbody.ops.forces import pairwise_accel_tf3

    rng = np.random.default_rng(21)
    n = 41
    q = rng.standard_normal((2, n, 3)).astype(np.float64)
    m = np.abs(rng.standard_normal((2, n))).astype(np.float64)
    qe = tf.from_f64(q)
    me = tf.from_f64(m)
    qe = tf.TF3(*map(jnp.asarray, (qe.hi, qe.mid, qe.lo)))
    me = tf.TF3(*map(jnp.asarray, (me.hi, me.mid, me.lo)))
    full = tf.to_f64(jax.jit(
        lambda a, b: pairwise_accel_tf3(a, b, G=6.674e-11, eps=1e-3))(qe, me))
    for jt in (16, 13):
        blk = tf.to_f64(jax.jit(
            lambda a, b: pairwise_accel_tf3(a, b, G=6.674e-11, eps=1e-3,
                                            j_tile=jt))(qe, me))
        np.testing.assert_allclose(blk, full, rtol=1e-16, atol=0)
