"""f32 error-vs-horizon study: plain vs Kahan-compensated accumulation.

Marches a graded scene through simulate() at precision 'f32' with and
without compensated q/v accumulation, against the double-double ('dd')
trajectory as truth, sampling the relative RMS position error at a ladder
of horizons. Writes ONE JSON record (results/f32_horizon.json) and prints
a table.

Usage:  python scripts/study_f32_horizon.py [--case b20] [--steps 200000]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TESTCASE_DIR = "/root/reference/testcases"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--case", default="b20")
    ap.add_argument("--steps", type=int, default=200000)
    ap.add_argument("--out", default="results/f32_horizon.json")
    args = ap.parse_args()

    from nbody import read_input
    from nbody.simulate import simulate

    scene = read_input(os.path.join(TESTCASE_DIR, f"{args.case}.in"))
    # sample at a horizon ladder: on_chunk fires at multiples of `chunk`
    chunk = max(1, args.steps // 20)
    horizons = list(range(chunk, args.steps + 1, chunk))

    def march(precision, compensated=None):
        snaps = {}
        t0 = time.time()
        simulate(scene, n_steps=args.steps, chunk=chunk,
                 precision=precision, compensated=compensated,
                 on_chunk=lambda st: snaps.__setitem__(
                     st.step, (st.q.copy(), st.v.copy())))
        return snaps, time.time() - t0

    truth, t_dd = march("dd")
    plain, t_plain = march("f32", compensated=False)
    comp, t_comp = march("f32", compensated=True)

    import numpy as np

    def rel_rms(a, b):
        scale = np.sqrt(np.mean(b * b))
        return float(np.sqrt(np.mean((a - b) ** 2)) / scale)

    rows = []
    for h in horizons:
        qt = truth[h][0]
        rows.append({
            "steps": h,
            "err_plain": rel_rms(plain[h][0], qt),
            "err_comp": rel_rms(comp[h][0], qt),
        })
        print(f"{h:>8d}  plain {rows[-1]['err_plain']:.3e}   "
              f"kahan {rows[-1]['err_comp']:.3e}", flush=True)

    rec = {
        "case": args.case, "n": scene.n, "steps": args.steps,
        "wall_s": {"dd": t_dd, "f32_plain": t_plain, "f32_kahan": t_comp},
        "rows": rows,
    }
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps({k: rec[k] for k in ("case", "steps", "wall_s")}))


if __name__ == "__main__":
    main()
