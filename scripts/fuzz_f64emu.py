"""Extended fuzz of ops/f64emu vs host IEEE binary64 (bit-exact).

Covers every op through the packed wrappers (which exercise the unpacked
bodies) across random wide-exponent, cancellation, half-ulp-tie, exact-tie
and zero-mixed distributions. Run after any f64emu change; r2 baseline was
0 mismatches in ~13.6M cases, r3 re-validates the unpacked/combined-fix
refactor at the same scale.

usage: python scripts/fuzz_f64emu.py [cases_per_batch] [batches]
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from nbody.ops import f64emu as fe


def rand_f64(rng, n, max_exp=300):
    sig = rng.integers(0, 1 << 52, n, dtype=np.uint64)
    exp = rng.integers(1023 - max_exp, 1023 + max_exp, n, dtype=np.uint64)
    s = rng.integers(0, 2, n, dtype=np.uint64)
    return ((s << 63) | (exp << 52) | sig).view(np.float64)


def check(name, op_emu, op_np, a, b=None):
    ah, al = fe.from_f64(a)
    if b is None:
        rh, rl = op_emu(jnp.asarray(ah), jnp.asarray(al))
        want = op_np(a)
    else:
        bh, bl = fe.from_f64(b)
        rh, rl = op_emu(jnp.asarray(ah), jnp.asarray(al),
                        jnp.asarray(bh), jnp.asarray(bl))
        want = op_np(a, b)
    got = fe.to_f64(np.asarray(rh), np.asarray(rl))
    wu = want.view(np.uint64)
    gu = got.view(np.uint64)
    we = (wu >> 52) & 0x7FF
    inscope = ((we != 0) & (we != 0x7FF)) | ((wu & ((1 << 63) - 1)) == 0)
    bad = (wu != gu) & inscope
    if bad.any():
        i = np.nonzero(bad)[0][0]
        print(f"FAIL {name}: {int(bad.sum())} mismatches; "
              f"a={a[i]!r}" + (f" b={b[i]!r}" if b is not None else "")
              + f" want={want[i]!r} got={got[i]!r}")
        return int(bad.sum()), int(inscope.sum())
    return 0, int(inscope.sum())


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 200_000
    batches = int(sys.argv[2]) if len(sys.argv) > 2 else 10
    jadd = jax.jit(fe.add)
    jmul = jax.jit(fe.mul)
    jdiv = jax.jit(fe.div)
    jsqrt = jax.jit(fe.sqrt)
    jsqr = jax.jit(lambda h, l: fe.pack_norm(*fe.sqr_u(*fe.unpack(h, l))))
    total = fails = 0
    for seed in range(batches):
        rng = np.random.default_rng(9000 + seed)
        a = rand_f64(rng, n)
        b = rand_f64(rng, n)
        az = np.where(rng.random(n) < 0.05, 0.0, a)
        for name, args in [
            ("add_wide", (jadd, np.add, a, b)),
            ("add_cancel", (jadd, np.add, a,
                            (-(a * 2.0 ** rng.integers(-3, 4, n)
                               * (1 + rng.standard_normal(n) * .5))
                             ).astype(np.float64))),
            ("add_near", (jadd, np.add, a,
                          a * (2.0 ** rng.integers(-55, 3, n))
                          * np.where(rng.random(n) < .5, -1, 1))),
            ("mul", (jmul, np.multiply, rand_f64(rng, n, 200),
                     rand_f64(rng, n, 200))),
            ("mul_pow2", (jmul, np.multiply, rand_f64(rng, n, 200),
                          np.ldexp(1.0, rng.integers(-40, 40, n)))),
            ("mul_zero", (jmul, np.multiply, az, b)),
            ("div", (jdiv, np.divide, rand_f64(rng, n, 200),
                     rand_f64(rng, n, 200))),
            ("div_near1", (jdiv, np.divide, a,
                           (a * (1 + rng.standard_normal(n) * 1e-15)
                            ).astype(np.float64))),
            ("div_ties", (jdiv, np.divide,
                          (rng.integers(1, 1 << 30, n).astype(np.float64)
                           + 0.5)
                          * rng.integers(1, 1 << 20, n).astype(np.float64),
                          rng.integers(1, 1 << 20, n).astype(np.float64))),
            ("div_zero_num", (jdiv, np.divide, az, b)),
            ("sqrt", (jsqrt, np.sqrt, np.abs(rand_f64(rng, n, 300)))),
            ("sqrt_sq", (jsqrt, np.sqrt,
                         (lambda r: (r * r).astype(np.float64))(
                             rand_f64(rng, n, 25)))),
            ("sqr_u", (jsqr, lambda x: x * x, rand_f64(rng, n, 150))),
        ]:
            if len(args) == 4:
                f, g, x, y = args
                nb, ns = check(name, f, g, x, y)
            else:
                f, g, x = args
                nb, ns = check(name, f, g, x)
            fails += nb
            total += ns
    print(f"fuzz done: {fails} mismatches / {total} in-scope cases")
    sys.exit(1 if fails else 0)


if __name__ == "__main__":
    main()
