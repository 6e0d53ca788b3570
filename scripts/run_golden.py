"""Golden testcase harness: run the engine across testcases and compare
against the golden .out files.

Usage:
  python scripts/run_golden.py --testcases DIR --precision exact|f64|dd|f32 \
      [--platform cpu|gpu] [--cases b20,b30,...] [--out results.json]

DIR holds the reference's <case>.in / <case>.out pairs.

Comparison contract per case:
  min_dist    — relative error vs golden (byte-equality implies 0)
  hit_step    — exact integer match
  p3 line     — device id exact + cost relative error
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ALL_CASES = ["b20", "b30", "b40", "b50", "b60", "b70", "b80", "b90",
             "b100", "b200", "b512", "b1024"]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--testcases", required=True, metavar="DIR",
                    help="directory of <case>.in / <case>.out files")
    ap.add_argument("--precision", default="f64",
                    choices=["exact", "f64", "e64", "ddp", "dd+", "tf3",
                             "dd", "f32"])
    ap.add_argument("--cases", default=",".join(ALL_CASES))
    ap.add_argument("--out", default=None)
    ap.add_argument("--dist3-mode", default=None,
                    choices=["pow", "dsqrt", "sqrt3"])
    ap.add_argument("--mesh", default=None, metavar="scen=S,body=B",
                    help="run through the mesh-sharded drivers (CLI --mesh "
                         "syntax) over the chosen platform's devices, e.g. "
                         "four GPUs, or --platform cpu with XLA_FLAGS=--xla_"
                         "force_host_platform_device_count=8 for a virtual "
                         "CPU mesh")
    ap.add_argument("--tile", type=int, default=None,
                    help="mesh force j-tile (see CLI --tile)")
    ap.add_argument("--platform", default=None, choices=["cpu", "gpu"],
                    help="backend for the JAX precisions (default: JAX's "
                         "default backend); 'cpu' is pinned before backend "
                         "init so --mesh uses the virtual CPU devices")
    args = ap.parse_args()

    if args.platform == "cpu":
        import jax
        jax.config.update("jax_platforms", "cpu")

    import dataclasses

    from nbody import read_input, solve_scene, format_output, SimConfig
    from nbody.backend import enable_persistent_compile_cache
    from nbody.io import parse_output

    # one compile per signature across runs (same cache as the CLI)
    enable_persistent_compile_cache()

    cfg = SimConfig()
    if args.dist3_mode:
        cfg = dataclasses.replace(cfg, dist3_mode=args.dist3_mode)

    mesh = None
    if args.mesh is not None:
        from nbody.cli import parse_mesh_spec
        from nbody.parallel import make_mesh
        mesh = make_mesh(parse_mesh_spec(args.mesh))

    results = []
    for case in args.cases.split(","):
        in_path = os.path.join(args.testcases, f"{case}.in")
        gold_path = os.path.join(args.testcases, f"{case}.out")
        scene = read_input(in_path)
        with open(gold_path) as f:
            gold_text = f.read()
        g_min, g_hit, g_dev, g_cost = parse_output(gold_text)

        t0 = time.perf_counter()
        ans = solve_scene(scene, cfg, precision=args.precision,
                          platform=args.platform, mesh=mesh, tile=args.tile)
        wall = time.perf_counter() - t0

        ours = format_output(*ans.as_tuple())
        byte_equal = (ours == gold_text)
        rel_min = abs(ans.min_dist - g_min) / max(abs(g_min), 1e-300)
        rel_cost = (abs(ans.missile_cost - g_cost) / max(abs(g_cost), 1.0))
        rec = {
            "case": case, "n": scene.n, "precision": args.precision,
            "dist3_mode": cfg.resolved_dist3(args.precision),
            **({"mesh": args.mesh, "tile": args.tile}
               if args.mesh is not None else {}),
            "wall_s": round(wall, 2),
            "byte_equal": byte_equal,
            "min_dist_rel_err": rel_min,
            "hit_step_ours": ans.hit_time_step, "hit_step_gold": g_hit,
            "hit_step_match": ans.hit_time_step == g_hit,
            "p3_dev_ours": ans.gravity_device_id, "p3_dev_gold": g_dev,
            "p3_dev_match": ans.gravity_device_id == g_dev,
            "p3_cost_rel_err": rel_cost,
        }
        results.append(rec)
        print(json.dumps(rec), flush=True)

    n_byte = sum(r["byte_equal"] for r in results)
    n_hit = sum(r["hit_step_match"] for r in results)
    n_dev = sum(r["p3_dev_match"] for r in results)
    summary = {
        "precision": args.precision, "cases": len(results),
        **({"mesh": args.mesh, "tile": args.tile}
           if args.mesh is not None else {}),
        "byte_equal": n_byte, "hit_step_match": n_hit,
        "p3_dev_match": n_dev,
        "max_min_dist_rel_err": max(r["min_dist_rel_err"] for r in results),
    }
    print("SUMMARY " + json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"results": results, "summary": summary}, f, indent=1)


if __name__ == "__main__":
    main()
