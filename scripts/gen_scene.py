"""Scene generator: produce testcase-format `.in` files.

The reference ships only fixed testcases; this generates new ones in the
same format (n planet asteroid header + 8-token body lines) for fuzzing,
scaling studies, and regression corpora. Bodies: one planet, one asteroid
aimed loosely at it, a few oscillating devices near the planet, and a
Plummer background of stars (plus optional black holes).

Usage:
  python scripts/gen_scene.py out.in --n 256 [--devices 3] [--seed 0]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def scene_text(n: int, devices: int = 2, black_holes: int = 1,
               seed: int = 0) -> str:
    """The testcase-format text of one seeded scene."""
    from nbody.models.plummer import plummer_scene

    rs = np.random.RandomState(seed)
    # background cluster at graded-case scales
    q, v, m = plummer_scene(n, seed=seed, total_mass=2e33,
                            scale_radius=3e19)
    q += rs.randn(3) * 1e19
    m *= np.exp(rs.randn(n) * 1.5)
    types = ["star"] * n

    # planet + asteroid on a rough collision-ish course
    planet, asteroid = 0, 1
    types[planet] = "planet"
    m[planet] = 5.5e24
    types[asteroid] = "asteroid"
    m[asteroid] = 8.5e22
    sep = rs.randn(3)
    sep *= 2.2e13 / np.linalg.norm(sep)
    q[asteroid] = q[planet] + sep
    v[asteroid] = v[planet] - sep / np.linalg.norm(sep) * 2.4e6 \
        + rs.randn(3) * 2e5

    # devices near the planet
    for i in rs.choice(np.arange(2, n), size=devices, replace=False):
        types[i] = "device"
        m[i] = abs(rs.randn()) * 5e24
        off = rs.randn(3)
        off *= (3e12 + abs(rs.randn()) * 3e13) / np.linalg.norm(off)
        q[i] = q[planet] + off
        v[i] = v[planet] + rs.randn(3) * 1e4
    for i in rs.choice([j for j in range(2, n) if types[j] == "star"],
                       size=black_holes, replace=False):
        types[i] = "black_hole"
        m[i] = abs(rs.randn()) * 4e36

    lines = [f"{n} {planet} {asteroid}"]
    lines += [" ".join("%.16e" % x for x in (*q[i], *v[i], m[i]))
              + f" {types[i]}" for i in range(n)]
    return "\n".join(lines) + "\n"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--devices", type=int, default=2)
    ap.add_argument("--black-holes", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    with open(args.out, "w") as f:
        f.write(scene_text(args.n, args.devices, args.black_holes,
                           args.seed))
    print(f"wrote {args.out}: n={args.n}, devices={args.devices}")


if __name__ == "__main__":
    main()
