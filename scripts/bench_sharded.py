"""Multi-GPU scaling benchmark: body-sharded ring force step.

On the GPUs of one host this measures the NVLink ring path at scale (N=1M
on four H100s). On a virtual-CPU device grid it still runs (validating the
collective program) and reports the same metric with the platform named.
Prints one JSON line per configuration.

Usage: python scripts/bench_sharded.py [--n 1048576] [--steps 3]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

os.environ.setdefault("NBODY_NO_X64", "1")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--pallas", action="store_true",
                    help="tile the per-shard force with the Triton kernel "
                         "(ops/pallas_forces.py; interpreted on CPU)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from nbody.backend import enable_persistent_compile_cache
    from nbody.parallel import make_mesh, make_sharded_step

    enable_persistent_compile_cache()
    from nbody.models.plummer import plummer_scene
    from jax.sharding import NamedSharding, PartitionSpec as P

    n_dev = len(jax.devices())
    on_cpu = jax.devices()[0].platform == "cpu"
    n = args.n or (8192 * n_dev if not on_cpu else 1024 * n_dev)
    n -= n % n_dev

    q, v, m = plummer_scene(n, seed=0)
    mesh = make_mesh({"body": n_dev})
    step = make_sharded_step(mesh, body_axis="body", G=6.674e-11, eps=1e-3,
                             dt=60.0, use_pallas=args.pallas,
                             interpret=args.pallas and on_cpu)
    sh = NamedSharding(mesh, P("body", None))
    qf = jax.device_put(jnp.asarray(q, jnp.float32), sh)
    vf = jax.device_put(jnp.asarray(v, jnp.float32), sh)
    mf = jax.device_put(jnp.asarray(m, jnp.float32),
                        NamedSharding(mesh, P("body")))

    # warmup/compile
    q1, v1 = step(qf, vf, mf)
    jax.block_until_ready((q1, v1))

    times = []
    for _ in range(3):
        qr, vr = qf, vf
        t0 = time.perf_counter()
        for _ in range(args.steps):
            qr, vr = step(qr, vr, mf)
        jax.block_until_ready((qr, vr))
        times.append(time.perf_counter() - t0)
    elapsed = min(times)

    pairs = float(n) * n * args.steps
    print(json.dumps({
        "metric": (f"sharded_ring_{'pallas' if args.pallas else 'xla'}"
                   f"_fp32_n{n}_dev{n_dev}_pairs_per_sec"),
        "value": pairs / elapsed,
        "unit": "pair-interactions/s",
        "extra": {"n": n, "devices": n_dev, "steps": args.steps,
                  "elapsed_s": elapsed, "repeat_s": times,
                  "platform": jax.devices()[0].platform,
                  "device_kind": jax.devices()[0].device_kind},
    }))


if __name__ == "__main__":
    main()
