"""CLI surface tests (fast paths only; full-length runs live in scripts/)."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B20 = "/root/reference/testcases/b20.in"


def _run(args, **kw):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "-m", "nbody", *args],
                          capture_output=True, text=True, cwd=REPO, env=env,
                          **kw)


def test_cli_solves_and_writes(tmp_path):
    out = str(tmp_path / "o.out")
    r = _run([B20, out, "--n-steps", "50", "--stats"])
    assert r.returncode == 0, r.stderr
    lines = open(out).read().strip().split("\n")
    assert len(lines) == 3
    stats = json.loads(r.stderr.strip().split("\n")[-1])
    assert stats["n"] == 20 and stats["n_steps"] == 50
    # small scenes route through the fused P1+P2+P3 scan
    assert ("problems_fused" in stats["phases_s"]
            or "problem_1_2" in stats["phases_s"])


def test_cli_missing_args():
    r = _run([])
    assert r.returncode != 0
    assert "required" in r.stderr


def test_cli_rejects_bad_precision():
    r = _run([B20, "/tmp/x.out", "--precision", "f16"])
    assert r.returncode != 0
    assert "invalid choice" in r.stderr


def test_full_b20_byte_golden(tmp_path):
    """Full-length b20 through the default f64 path must be byte-identical
    to the golden output (~15 s; the full 12-case sweep lives in scripts/)."""
    out = str(tmp_path / "b20.out")
    r = _run([B20, out])
    assert r.returncode == 0, r.stderr
    with open(out) as f, open("/root/reference/testcases/b20.out") as g:
        assert f.read() == g.read()


def test_cli_mesh_routes_sharded(tmp_path):
    """--mesh routes through the sharded drivers on a virtual device grid
    and reproduces the plain-path answers (short horizon)."""
    plain = str(tmp_path / "plain.out")
    r = _run([B20, plain, "--n-steps", "50"])
    assert r.returncode == 0, r.stderr

    out = str(tmp_path / "mesh.out")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=8")
    env.pop("PYTHONPATH", None)
    r = subprocess.run(
        [sys.executable, "-m", "nbody", B20, out, "--n-steps", "50",
         "--mesh", "scen=2,body=-1", "--tile", "4"],
        capture_output=True, text=True, cwd=REPO, env=env)
    assert r.returncode == 0, r.stderr
    # same discrete answers; min_dist agrees to reduction-order tolerance
    # (the mesh path folds j in tiles, the plain path in one flat reduce)
    pl = open(plain).read().split("\n")
    me = open(out).read().split("\n")
    assert pl[1] == me[1]                       # hit step line, exact
    assert pl[2] == me[2]                       # device/cost line, exact
    a, b = float(pl[0]), float(me[0])
    assert abs(a - b) <= 1e-12 * abs(a)


def test_cli_mesh_spec_errors():
    from nbody.cli import parse_mesh_spec
    import pytest
    assert parse_mesh_spec("scen=2,body=4") == {"scen": 2, "body": 4}
    assert parse_mesh_spec("body=8") == {"body": 8, "scen": 1}
    with pytest.raises(ValueError):
        parse_mesh_spec("scen=2,scen=2")
    with pytest.raises(ValueError):
        parse_mesh_spec("rows=2")
    with pytest.raises(ValueError):
        parse_mesh_spec("scen2")


def test_cli_rejects_nonpositive_tile(tmp_path):
    import pytest

    from nbody.cli import main
    with pytest.raises(SystemExit, match="--tile must be"):
        main([B20, str(tmp_path / "o.out"), "--tile", "0",
              "--mesh", "scen=1,body=2", "--precision", "f64",
              "--platform", "cpu"])


def test_cli_rejects_oversized_tile(tmp_path):
    # n=20 buckets to 128; body=2 -> 64 rows/shard; tile=4096 would pad
    # the scene to 8192 bodies -- refused with a friendly message.
    import pytest

    from nbody.cli import main
    with pytest.raises(SystemExit, match="would pad the scene"):
        main([B20, str(tmp_path / "o.out"), "--tile", "4096",
              "--mesh", "scen=1,body=2", "--precision", "f64",
              "--platform", "cpu"])
