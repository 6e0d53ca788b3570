"""fp32 force routes on the GPU: the Triton kernel against XLA.

Times steady-state fp32 steps of a Plummer sphere (compile excluded) for
  * simulate()'s chunk scan with the Triton kernel (ops/pallas_forces.py),
  * the same chunk scan with XLA's fused row reduction
    (ops/forces.pairwise_accel_fast),
  * a scan over XLA's j-blocked force (ops/forces.pairwise_accel_blocked),
and, with --sweep, the kernel's block sizes and launch shape at the
largest N. One JSON line per measurement on stdout and in
chiprun_out/bench_fp32_force.jsonl.

Usage: python scripts/bench_fp32_force.py [--n 16384 65536] [--steps 10]
       [--sweep]
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax import lax  # noqa: E402

G, EPS, DT = 6.674e-11, 1e-3, 60.0


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def time_fn(fn, args, repeats):
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return compile_s, times


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, nargs="+", default=[16384, 65536])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()

    from nbody.models.plummer import plummer_scene
    from nbody.ops.forces import pairwise_accel_blocked
    from nbody.ops.pallas_forces import pallas_accel
    from nbody.simulate import _chunk_scan

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU, found {dev.platform}")
    card_line = card()
    print(card_line, flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    log = open(os.path.join("chiprun_out", "bench_fp32_force.jsonl"), "a")

    def emit(rec):
        rec.update(card=card_line, device_kind=dev.device_kind)
        line = json.dumps(rec)
        print(line, flush=True)
        log.write(line + "\n")

    for n in args.n:
        q, v, m = plummer_scene(n, seed=0)
        f32 = jnp.float32
        qf, vf, mf = (jax.device_put(jnp.asarray(x, f32)) for x in (q, v, m))
        zeros = jnp.zeros_like(qf)
        mh = jnp.zeros_like(mf)
        fst = jnp.zeros((args.steps,), f32)
        pairs = float(n) * n * args.steps

        for route, use_pallas in (("triton", True), ("xla_fused", False)):
            fn = jax.jit(lambda q, v, a, qc, vc, up=use_pallas: _chunk_scan(
                q, v, a, mf, mh, fst, qc, vc, n_sub=args.steps, dt=DT,
                eps=EPS, G=G, fast=True, dist3_mode="dsqrt", use_pallas=up,
                compensated=True))
            c, ts = time_fn(fn, (qf, vf, zeros, zeros, zeros), args.repeats)
            emit({"n": n, "route": route, "steps": args.steps,
                  "compile_s": c, "step_s": [t / args.steps for t in ts],
                  "pairs_per_s": pairs / min(ts)})

        def blocked_run(q, v):
            def body(c, _):
                q, v = c
                a = pairwise_accel_blocked(q, mf, G=G, eps=EPS)
                v = v + a * DT
                return (q + v * DT, v), None
            return lax.scan(body, (q, v), None, length=args.steps)[0]
        c, ts = time_fn(jax.jit(blocked_run), (qf, vf), args.repeats)
        emit({"n": n, "route": "xla_blocked", "steps": args.steps,
              "compile_s": c, "step_s": [t / args.steps for t in ts],
              "pairs_per_s": pairs / min(ts)})

    if args.sweep:
        n = max(args.n)
        q, _, m = plummer_scene(n, seed=0)
        qf = jax.device_put(jnp.asarray(q, jnp.float32))
        gm = jax.device_put(jnp.asarray(G * m, jnp.float32))
        for bi, bj, nw, ns in itertools.product(
                (16, 32, 64, 128), (16, 32, 64), (2, 4, 8), (2, 3)):
            fn = jax.jit(lambda q, bi=bi, bj=bj, nw=nw, ns=ns: pallas_accel(
                q, gm, eps=EPS, block_i=bi, block_j=bj, num_warps=nw,
                num_stages=ns))
            key = [bi, bj, nw, ns]
            try:
                c, ts = time_fn(fn, (qf,), args.repeats)
            except Exception as e:       # a launch shape the card refuses
                emit({"n": n, "sweep": key, "error": str(e)[:200]})
                continue
            emit({"n": n, "sweep": key, "compile_s": c, "force_s": min(ts),
                  "pairs_per_s": float(n) * n / min(ts)})


if __name__ == "__main__":
    main()
