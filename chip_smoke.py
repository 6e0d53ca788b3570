"""Smoke run of the system's main paths on one GPU.

    python chip_smoke.py               # one GPU: phases 1-6 below
    python chip_smoke.py --four-cards  # four GPUs: the mesh paths only

Everything runs in this one JAX process. Phases (one GPU):
  1. device — the card's name and power limit, JAX version, XLA_FLAGS.
  2. graded, checked — a seeded n=1024 collision scene through the CLI in
     IEEE f64 on the GPU against the native serial core (dsqrt) at the
     same horizon: hit step, winner and cost equal, min_dist within 1e-12.
  3. graded, full horizon — two seeded scenes (n=100: fused route,
     n=1024: phased route) for the full 200001 steps through the CLI.
  4. fp32 throughput — a Plummer sphere at N=65536 through
     simulate(precision="f32"); 1024 sampled force rows against an f64
     reference on the card.
  5. every precision — f64, e64, ddp, tf3, dd, f32 on an n=20 scene for
     50 steps; e64 byte-identical to the native core.
  6. the last stdout line: {"ok": true, "device": {...}}.

With --four-cards only the mesh paths run: the phase-2 scene on two mesh
shapes (bit-identical answers, equal to the single-GPU f64 solve), and
one fp32 ring step at N=1,048,576 against the single-GPU force.

Any failed check raises, so the process exits non-zero and prints no
last line. Scenes are built from seeds; nothing is read from outside the
checkout, and scratch files go to chiprun_out/chip_smoke/.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out", "chip_smoke")

G, EPS, DT = 6.674e-11, 1e-3, 60.0
GRADED_N, GRADED_HORIZON = 1024, 300
F32_N, F32_STEPS = 65536, 10
RING_N = 1 << 20
SAMPLE_ROWS = 1024
PRECISIONS = ("f64", "f32", "dd", "ddp", "tf3", "e64")
MIN_DIST_RTOL = 1e-12
F32_MAX_ABS_RTOL, F32_FRO_RTOL = 1e-4, 1e-5


def last_line(platform: str, kind: str, count: int) -> str:
    """The contract's final stdout line."""
    return json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": count}})


def collision_scene(n: int, seed: int = 7):
    """A planet, an asteroid on a ballistic miss, a massive deflector
    device that bends it into a hit near step 187, and a light device,
    padded out to n bodies with seeded light background bodies. Under the
    native core at a 300-step horizon: P2 hits and destroying device 2
    saves the planet (a P3 winner)."""
    import numpy as np

    from nbody.io import Scene

    rng = np.random.RandomState(seed)
    q = rng.randn(n, 3) * 1e10
    v = rng.randn(n, 3) * 1e2
    m = np.abs(rng.randn(n)) * 1e12
    q[0], v[0], m[0] = 0.0, 0.0, 5.97e24                  # planet
    q[1], v[1], m[1] = (3.0e8, 2.5e7, 0.0), (-25_000.0, 0.0, 0.0), 1.0e10
    q[2], v[2], m[2] = (1.5e8, -3.0e7, 0.0), 0.0, 3.0e25  # deflector
    q[3], v[3], m[3] = (0.0, 2.0e9, 0.0), 0.0, 1e12       # light device
    return Scene(n=n, planet=0, asteroid=1, q=q, v=v, m=m,
                 types=["planet", "asteroid", "device", "device"]
                 + ["body"] * (n - 4), device_idx=np.asarray([2, 3]))


def write_scene(scene, path: str) -> str:
    with open(path, "w") as f:
        f.write(f"{scene.n} {scene.planet} {scene.asteroid}\n")
        for i in range(scene.n):
            vals = (*scene.q[i], *scene.v[i], scene.m[i])
            f.write(" ".join("%.17e" % x for x in vals)
                    + f" {scene.types[i]}\n")
    return path


def gen_scene(n: int, seed: int, path: str) -> str:
    """A scripts/gen_scene.py scene, written to path."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "gen_scene", os.path.join(ROOT, "scripts", "gen_scene.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with open(path, "w") as f:
        f.write(mod.scene_text(n, seed=seed))
    return path


def run_cli(argv):
    """nbody.cli.main in this process; returns its --stats record."""
    from nbody.cli import main as cli_main
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = cli_main(argv + ["--stats"])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"cli {argv} returned {rc}")
    stats = json.loads(err.getvalue().strip().splitlines()[-1])
    stats["call_s"] = wall
    return stats


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)
    print(f"  ok: {what}", flush=True)


def same_answers(a, b) -> bool:
    return (a.min_dist == b.min_dist and a.hit_time_step == b.hit_time_step
            and a.gravity_device_id == b.gravity_device_id
            and a.missile_cost == b.missile_cost)


def phase_device(n_cards: int):
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke needs a GPU; JAX found "
                         f"{dev.platform!r} ({dev.device_kind})")
    if len(jax.devices()) < n_cards:
        raise SystemExit(f"needs {n_cards} GPUs, found {len(jax.devices())}")
    print(card_line(), flush=True)
    print(f"[device] kind={dev.device_kind} count={len(jax.devices())} "
          f"jax={jax.__version__} "
          f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}", flush=True)
    return dev


def phase_graded_checked():
    from nbody import SimConfig, solve_scene
    from nbody.native import solve_exact

    print(f"[graded-checked] n={GRADED_N} horizon={GRADED_HORIZON}",
          flush=True)
    scene = collision_scene(GRADED_N)
    path = write_scene(scene, os.path.join(OUT_DIR, "collision.in"))
    st = run_cli([path, os.path.join(OUT_DIR, "collision_f64.out"),
                  "--precision", "f64", "--platform", "gpu",
                  "--n-steps", str(GRADED_HORIZON)])
    got = st["answers"]
    print(f"  gpu f64: {got} wall={st['wall_s']} "
          f"phases={st['phases_s']}", flush=True)
    cfg = dataclasses.replace(SimConfig(), n_steps=GRADED_HORIZON)
    t0 = time.perf_counter()
    md, hs, dev, cost = solve_exact(scene, cfg, dist3_mode="dsqrt")
    print(f"  native dsqrt: min_dist={md!r} hit={hs} winner={dev} "
          f"cost={cost!r} ({time.perf_counter() - t0:.1f} s)", flush=True)
    check(hs != -2 and dev != -1, "scene gives a P2 hit and a saving winner")
    check((got["hit_time_step"], got["gravity_device_id"],
           got["missile_cost"]) == (hs, dev, cost),
          "GPU f64 hit step, winner and cost equal the native core")
    rel = abs(got["min_dist"] - md) / md
    check(rel <= MIN_DIST_RTOL,
          f"GPU f64 min_dist rel err {rel:.3e} <= {MIN_DIST_RTOL}")
    t0 = time.perf_counter()
    cpu = solve_scene(scene, cfg, precision="f64", platform="cpu")
    gpu = (got["min_dist"], got["hit_time_step"], got["gravity_device_id"],
           got["missile_cost"])
    print(f"  XLA:CPU f64 ({time.perf_counter() - t0:.1f} s): bit-identical "
          f"to GPU f64: {cpu.as_tuple() == gpu}", flush=True)
    return scene


def phase_graded_full():
    import math
    for n, route in ((100, "fused"), (1024, "phased")):
        path = gen_scene(n, seed=1, path=os.path.join(OUT_DIR, f"g{n}.in"))
        st = run_cli([path, os.path.join(OUT_DIR, f"g{n}.out"),
                      "--precision", "f64", "--platform", "gpu"])
        a = st["answers"]
        print(f"[graded-full] n={n} route={route} steps={st['n_steps']} "
              f"wall={st['wall_s']} phases={st['phases_s']} answers={a}",
              flush=True)
        check(math.isfinite(a["min_dist"]) and a["min_dist"] >= 0
              and isinstance(a["hit_time_step"], int)
              and (a["hit_time_step"] == -2 or a["hit_time_step"] >= 0)
              and isinstance(a["gravity_device_id"], int)
              and math.isfinite(a["missile_cost"]),
              f"n={n} full-horizon answers finite and well formed")


def f64_rows_reference(q64, gm64, rows):
    """Plain f64 accelerations of bodies `rows` from every body, on the
    card (rsqrt-free division form, row chunks of 128)."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def chunk(qi):
        dq = q64[None, :, :] - qi[:, None, :]
        d2 = (dq * dq).sum(-1) + EPS * EPS
        w = gm64[None, :] / (d2 * jnp.sqrt(d2))
        return (w[..., None] * dq).sum(1)
    qi = q64[rows]
    return jnp.concatenate([chunk(qi[i:i + 128])
                            for i in range(0, qi.shape[0], 128)])


def check_f32_force(a, a_ref, label: str):
    import numpy as np
    a = np.asarray(a, np.float64)
    a_ref = np.asarray(a_ref, np.float64)
    max_rel = float(np.abs(a - a_ref).max() / np.abs(a_ref).max())
    fro = float(np.linalg.norm(a - a_ref) / np.linalg.norm(a_ref))
    check(max_rel <= F32_MAX_ABS_RTOL and fro <= F32_FRO_RTOL,
          f"{label}: max abs err {max_rel:.3e}*max|a_ref| "
          f"(<= {F32_MAX_ABS_RTOL}), rel Frobenius {fro:.3e} "
          f"(<= {F32_FRO_RTOL})")


def phase_f32(card: str):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from nbody import SimConfig, simulate
    from nbody.io import Scene
    from nbody.models.plummer import plummer_scene
    from nbody.ops.forces import pairwise_accel_fast
    from nbody.ops.pallas_forces import pallas_accel_cross
    from nbody.simulate import _chunk_scan

    n = F32_N
    q, v, m = plummer_scene(n, seed=0)
    scene = Scene(n=n, planet=0, asteroid=1, q=q, v=v, m=m,
                  types=["body"] * n, device_idx=np.zeros((0,), np.int64))
    cfg = SimConfig()
    pairs = float(n) * n * F32_STEPS
    t0 = time.perf_counter()
    simulate(scene, cfg, n_steps=F32_STEPS, chunk=F32_STEPS,
             precision="f32")
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    st = simulate(scene, cfg, n_steps=F32_STEPS, chunk=F32_STEPS,
                  precision="f32")
    wall = time.perf_counter() - t0
    check(bool(np.isfinite(st.q).all() and np.isfinite(st.v).all()),
          f"simulate(f32) N={n} state finite")
    print(f"[f32] simulate N={n} steps={F32_STEPS}: first call {first:.2f} s "
          f"(compile incl.), steady {wall:.4f} s = {pairs / wall:.4e} "
          f"pairs/s end to end | {card}", flush=True)

    # the force alone, each route, as simulate's chunk scan runs it
    f32 = jnp.float32
    qf, vf, mf = (jax.device_put(jnp.asarray(x, f32)) for x in (q, v, m))
    z = jnp.zeros_like(qf)
    mh = jnp.zeros_like(mf)
    fst = jnp.zeros((F32_STEPS,), f32)
    for route, use_pallas in (("triton kernel", True), ("xla", False)):
        fn = jax.jit(lambda q, v, up=use_pallas: _chunk_scan(
            q, v, z, mf, mh, fst, z, z, n_sub=F32_STEPS, dt=DT, eps=EPS,
            G=G, fast=True, dist3_mode="dsqrt", use_pallas=up,
            compensated=True))
        jax.block_until_ready(fn(qf, vf))
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(qf, vf))
            times.append(time.perf_counter() - t0)
        print(f"[f32] {route}: {pairs / min(times):.4e} pairs/s "
              f"({min(times) / F32_STEPS * 1e3:.3f} ms/step, best of 3) "
              f"| {card}", flush=True)

    rows = np.random.RandomState(1).choice(n, SAMPLE_ROWS, replace=False)
    gm = G * m
    a_ref = f64_rows_reference(jnp.asarray(q), jnp.asarray(gm),
                               jnp.asarray(rows))
    a_k = pallas_accel_cross(qf[rows], qf, jnp.asarray(gm, f32), eps=EPS)
    check_f32_force(a_k, a_ref, f"triton kernel vs f64 on {SAMPLE_ROWS} rows")
    a_x = jax.jit(lambda q, m: pairwise_accel_fast(q, m, G=G, eps=EPS)[rows])(
        qf, mf)
    check_f32_force(a_x, a_ref, f"xla fp32 vs f64 on {SAMPLE_ROWS} rows")


def phase_precisions():
    import math

    from nbody import SimConfig, read_input
    from nbody.native import solve_exact

    path = gen_scene(20, seed=3, path=os.path.join(OUT_DIR, "p20.in"))
    steps = 50
    answers = {}
    for prec in PRECISIONS:
        argv = [path, os.path.join(OUT_DIR, f"p20_{prec}.out"),
                "--precision", prec, "--platform", "gpu",
                "--n-steps", str(steps)]
        first = run_cli(argv)
        again = run_cli(argv)
        a = first["answers"]
        answers[prec] = a
        print(f"[precision] {prec}: first {first['call_s']:.2f} s, again "
              f"{again['call_s']:.3f} s (compile ~"
              f"{first['call_s'] - again['call_s']:.2f} s) answers={a}",
              flush=True)
        check(math.isfinite(a["min_dist"]) and math.isfinite(
            a["missile_cost"]) and a == again["answers"],
              f"{prec} answers finite and repeatable")
    cfg = dataclasses.replace(SimConfig(), n_steps=steps)
    md, hs, dev, cost = solve_exact(read_input(path), cfg,
                                    dist3_mode="dsqrt")
    e = answers["e64"]
    check((e["min_dist"], e["hit_time_step"], e["gravity_device_id"],
           e["missile_cost"]) == (md, hs, dev, cost),
          f"e64 byte-identical to the native core (min_dist {md!r})")


def phase_four_cards(card: str):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as P

    from nbody import SimConfig, solve_scene
    from nbody.models.plummer import plummer_scene
    from nbody.ops.pallas_forces import pallas_accel_cross
    from nbody.parallel import make_mesh, make_sharded_step
    from nbody.parallel.sharded import ring_pairwise_accel

    scene = collision_scene(GRADED_N)
    cfg = dataclasses.replace(SimConfig(), n_steps=GRADED_HORIZON)
    t0 = time.perf_counter()
    single = solve_scene(scene, cfg, precision="f64", platform="gpu")
    print(f"[mesh] single GPU f64: {single} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    tile = 128
    got = {}
    for axes in ({"scen": 2, "body": 2}, {"scen": 1, "body": 4}):
        mesh = make_mesh(axes)
        check(len({d.id for d in mesh.devices.flat}) == 4,
              f"mesh {axes} spans four distinct GPUs")
        t0 = time.perf_counter()
        got[str(axes)] = a = solve_scene(scene, cfg, precision="f64",
                                         mesh=mesh, tile=tile)
        print(f"[mesh] {axes} tile={tile}: {a} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    a, b = got.values()
    check(same_answers(a, b), "answers bit-identical across mesh shapes")
    check((a.hit_time_step, a.gravity_device_id, a.missile_cost)
          == (single.hit_time_step, single.gravity_device_id,
              single.missile_cost),
          "mesh discrete answers equal the single-GPU f64 solve")
    rel = abs(a.min_dist - single.min_dist) / single.min_dist
    check(rel <= MIN_DIST_RTOL,
          f"mesh min_dist rel err {rel:.3e} vs single GPU <= {MIN_DIST_RTOL}")

    n = RING_N
    q, v, m = plummer_scene(n, seed=0)
    f32 = jnp.float32
    qf, vf, mf = (jnp.asarray(x, f32) for x in (q, v, m))
    mesh = make_mesh({"body": 4})
    ring = jax.jit(jax.shard_map(
        lambda q, m: ring_pairwise_accel(q, G * m, axis_name="body",
                                         eps=EPS, use_pallas=True),
        mesh=mesh, in_specs=(P("body", None), P("body")),
        out_specs=P("body", None), check_vma=False))
    rows = np.random.RandomState(1).choice(n, SAMPLE_ROWS, replace=False)
    a_ring = np.asarray(ring(qf, mf))[rows]
    a_one = pallas_accel_cross(qf[rows], qf, G * mf, eps=EPS)
    check_f32_force(a_ring, a_one, f"ring (body=4) vs single-GPU force, "
                                   f"N={n}, {SAMPLE_ROWS} rows")
    step = make_sharded_step(mesh, body_axis="body", G=G, eps=EPS, dt=DT,
                             use_pallas=True)
    jax.block_until_ready(step(qf, vf, mf))
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(step(qf, vf, mf))
        times.append(time.perf_counter() - t0)
    print(f"[ring] N={n} body=4 step {min(times):.4f} s (best of 3) = "
          f"{float(n) * n / min(times):.4e} pairs/s | {card}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-GPU mesh paths")
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    import jax

    from nbody.backend import enable_persistent_compile_cache

    n_cards = 4 if args.four_cards else 1
    dev = phase_device(n_cards)
    enable_persistent_compile_cache()
    os.makedirs(OUT_DIR, exist_ok=True)
    card = card_line().splitlines()[0]
    t_start = time.perf_counter()
    phases = ([("four-cards", lambda: phase_four_cards(card))]
              if args.four_cards else
              [("graded-checked", phase_graded_checked),
               ("graded-full", phase_graded_full),
               ("f32", lambda: phase_f32(card)),
               ("precisions", phase_precisions)])
    for name, fn in phases:
        t0 = time.perf_counter()
        fn()
        print(f"[{name}] done in {time.perf_counter() - t0:.1f} s",
              flush=True)
    print(f"[total] {time.perf_counter() - t_start:.1f} s | {card}",
          flush=True)
    print(last_line(dev.platform, dev.device_kind, len(jax.devices())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
