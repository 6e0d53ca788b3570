"""Headline benchmark: all-pairs fp32 force+integrate throughput on one GPU.

Workload: a synthetic Plummer sphere, N = 65536, fp32, one GPU; the fp32
force (the Triton kernel, ops/pallas_forces.py) fused with the
symplectic-Euler update, marched under lax.scan entirely on the device.
Needs a GPU: with none it exits non-zero instead of timing anything else.

Prints ONE JSON line:
  {"metric": ..., "value": pairs/s, "unit": "pair-interactions/s",
   "extra": {..., "card": "<nvidia-smi name, power limit>"}}
"""

import json
import os
import subprocess
import sys
import time

os.environ.setdefault("NBODY_NO_X64", "1")  # pure fp32 benchmark

import jax
import jax.numpy as jnp
from jax import lax


def main():
    n = int(os.environ.get("BENCH_N", 65536))
    steps = int(os.environ.get("BENCH_STEPS", 20))
    repeats = int(os.environ.get("BENCH_REPEATS", 3))

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from nbody.backend import enable_persistent_compile_cache
    from nbody.models.plummer import plummer_scene
    from nbody.ops.pallas_forces import pallas_accel

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found {dev.platform!r}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    enable_persistent_compile_cache()

    q, v, m = plummer_scene(n, seed=0)
    G, eps, dt = 6.674e-11, 1e-3, 60.0
    qf = jax.device_put(jnp.asarray(q, jnp.float32), dev)
    vf = jax.device_put(jnp.asarray(v, jnp.float32), dev)
    gm = jax.device_put(jnp.asarray(G * m, jnp.float32), dev)

    @jax.jit
    def run(q, v):
        def one_step(carry, _):
            q, v = carry
            v = v + pallas_accel(q, gm, eps=eps) * dt
            return (q + v * dt, v), None
        (q, v), _ = lax.scan(one_step, (q, v), None, length=steps)
        return q, v

    t0 = time.perf_counter()
    out = jax.block_until_ready(run(qf, vf))          # compile + warm-up
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = jax.block_until_ready(run(qf, vf))
        times.append(time.perf_counter() - t0)
    elapsed = min(times)

    assert bool(jnp.isfinite(out[0]).all()), "non-finite positions"
    pairs_per_sec = float(n) * n * steps / elapsed
    print(json.dumps({
        "metric": f"allpairs_fp32_n{n}_pairs_per_sec",
        "value": pairs_per_sec,
        "unit": "pair-interactions/s",
        "extra": {
            "n": n, "steps": steps, "elapsed_s": elapsed,
            "ms_per_step": 1e3 * elapsed / steps, "compile_s": compile_s,
            "repeat_s": times, "card": card,
            "device_kind": dev.device_kind,
            "device_count": len(jax.devices()),
        },
    }))


if __name__ == "__main__":
    main()
