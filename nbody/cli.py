"""Command-line entry point: `python -m nbody <in> <out>`.

Same CLI contract as the reference binary (`./hw5 <in> <out>`,
hw5.cu:532-535), plus runtime flags for what the reference fixes at compile
time (hw5.cu:1-6, 50-54).
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="nbody",
        description="GPU N-body scenario solver (NTHU IPC HW5 capabilities)",
    )
    p.add_argument("input", help="testcase .in file")
    p.add_argument("output", help="3-line .out file to write")
    p.add_argument("--n-steps", type=int, default=None,
                   help="override number of steps (default 200000)")
    p.add_argument("--dist3-mode", choices=["dsqrt", "sqrt3", "pow"],
                   default=None, help="fp64 (d^2)^1.5 evaluation order")
    p.add_argument("--precision",
                   choices=["exact", "f64", "e64", "ddp", "dd+", "tf3",
                            "dd", "f32"],
                   default="f64",
                   help="exact: native serial core on the host CPU, "
                        "byte-golden; f64: IEEE binary64 scan on the GPU "
                        "(the main answer path); e64: bit-exact binary64 "
                        "softfloat (byte-golden by construction); ddp/dd+: "
                        "triple-f32 forces with f64-grid state; tf3: "
                        "truth-grade triple-f32; dd: f64 with exact 2^k "
                        "rescale; f32: fast")
    p.add_argument("--platform", choices=["auto", "cpu", "gpu"], default=None,
                   help="backend for the JAX precisions (default and "
                        "'auto': JAX's default backend; 'gpu' fails when "
                        "no GPU is present)")
    p.add_argument("--stats", action="store_true",
                   help="print a JSON run-stats line to stderr")
    p.add_argument("--checkpoint", default=None, metavar="PATH",
                   help="persist/resume the Problem-1/2 solver state at "
                        "PATH (preemption-safe; resume is bit-exact)")
    p.add_argument("--mesh", default=None, metavar="scen=S,body=B",
                   help="route the solve through the mesh-sharded drivers "
                        "on a ('scen','body') device mesh — the multi-chip "
                        "analog of the reference's 2-GPU distribution "
                        "(hw5.cu:532-615). S*B must not exceed the device "
                        "count; one size may be -1 (inferred). Example: "
                        "--mesh scen=2,body=-1")
    p.add_argument("--tile", type=int, default=None,
                   help="force-accumulation j-tile for the mesh path; the "
                        "same explicit tile gives bit-identical answers "
                        "across mesh shapes (ignored without --mesh)")
    return p


def read_input_header_n(path: str) -> int:
    """Peek the body count from a testcase header (cheap CLI pre-checks).

    Tokenizes exactly like io.read_input (whitespace over the whole stream,
    not line-based), so a header split across lines passes or fails both
    the same way."""
    from .io import SceneFormatError
    with open(path, "r") as f:
        tokens = f.read().split()
    if not tokens:
        raise SceneFormatError(f"{path}: missing header")
    return int(tokens[0])


def parse_mesh_spec(spec: str):
    """'scen=S,body=B' -> {'scen': S, 'body': B} (order preserved)."""
    axes = {}
    for part in spec.split(","):
        if "=" not in part:
            raise ValueError(
                f"--mesh expects comma-separated axis=size pairs "
                f"(e.g. scen=2,body=4); got {spec!r}")
        name, _, size = part.partition("=")
        name = name.strip()
        if name not in ("scen", "body"):
            raise ValueError(
                f"--mesh axis must be 'scen' or 'body'; got {name!r}")
        if name in axes:
            raise ValueError(f"--mesh axis {name!r} given twice")
        axes[name] = int(size)
    for name in ("scen", "body"):
        axes.setdefault(name, 1)
    return axes


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    # Import after arg parsing so `--help` stays instant.
    import dataclasses

    from . import SimConfig, read_input, solve_scene, write_output
    from .backend import enable_persistent_compile_cache

    # On-disk XLA executable cache (JAX_COMPILATION_CACHE_DIR, else
    # <repo>/.jax_cache): each solver signature compiles once per cache.
    enable_persistent_compile_cache()

    cfg = SimConfig()
    overrides = {}
    if args.n_steps is not None:
        overrides["n_steps"] = args.n_steps
    if args.dist3_mode is not None:
        overrides["dist3_mode"] = args.dist3_mode
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)

    from .utils.profiling import PhaseTimers, pair_interactions

    mesh = None
    if args.tile is not None and args.tile < 1:
        raise SystemExit(f"--tile must be a positive row count, "
                         f"got {args.tile}")
    if args.mesh is not None:
        if args.precision == "exact":
            raise SystemExit("--mesh does not apply to the native serial "
                             "core (precision 'exact')")
        from .parallel import make_mesh
        mesh = make_mesh(parse_mesh_spec(args.mesh))
        if args.tile is not None:
            # The engine pads the scene so each shard's row block is a
            # multiple of the tile (engine.py mesh path); an oversized
            # tile silently multiplies the padded problem size. Surface
            # that before minutes of compile/solve.
            from .utils.padding import mesh_pad_target
            body = mesh.shape["body"]
            scene_n = read_input_header_n(args.input)
            # Exactly the engine's computation (same helper), with and
            # without the tile, so the guard and the engine can't disagree
            # (including under NBODY_MESH_MIN_BUCKET).
            natural = mesh_pad_target(scene_n, body, None)
            padded = mesh_pad_target(scene_n, body, args.tile)
            if padded > 2 * natural:
                raise SystemExit(
                    f"--tile {args.tile} would pad the scene from "
                    f"{natural} to {padded} bodies on a body={body} mesh "
                    f"(each shard's rows round up to a tile multiple); "
                    f"pick a tile <= {natural // body} that divides the "
                    f"per-shard rows")

    timers = PhaseTimers()
    t0 = time.perf_counter()
    with timers.phase("read_input"):
        scene = read_input(args.input)
    ans = solve_scene(scene, cfg, precision=args.precision,
                      platform=args.platform, timers=timers,
                      checkpoint_path=args.checkpoint,
                      mesh=mesh, tile=args.tile)
    with timers.phase("write_output"):
        write_output(args.output, *ans.as_tuple())
    elapsed = time.perf_counter() - t0

    if args.stats:
        # Structured observability (the reference only has DEBUG-gated
        # printf timers, hw5.cu:25-29).
        n_sims = 2 + (scene.device_cnt if ans.hit_time_step != -2 else 0)
        pairs = pair_interactions(scene.n, cfg.n_steps, n_sims)
        timers.report(stream=sys.stderr, **{
            "n": scene.n, "device_cnt": scene.device_cnt,
            "n_steps": cfg.n_steps, "precision": args.precision,
            "wall_s": round(elapsed, 3),
            "pair_interactions": pairs,
            "pairs_per_sec": round(pairs / elapsed, 1),
            "answers": {"min_dist": ans.min_dist,
                        "hit_time_step": ans.hit_time_step,
                        "gravity_device_id": ans.gravity_device_id,
                        "missile_cost": ans.missile_cost},
        })
    return 0


if __name__ == "__main__":
    sys.exit(main())
