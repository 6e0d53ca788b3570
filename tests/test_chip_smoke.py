"""chip_smoke.py's CPU-checkable parts: its scene, its last line, and its
refusal to report anything without a GPU."""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import pytest

import chip_smoke
from nbody import SimConfig
from nbody.native import solve_exact

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_collision_scene_hits_and_saves_under_native_core():
    scene = chip_smoke.collision_scene(chip_smoke.GRADED_N)
    assert scene.n == chip_smoke.GRADED_N and scene.device_cnt == 2
    cfg = dataclasses.replace(SimConfig(),
                              n_steps=chip_smoke.GRADED_HORIZON)
    md, hit, dev, cost = solve_exact(scene, cfg, dist3_mode="dsqrt")
    assert 0 <= hit <= chip_smoke.GRADED_HORIZON
    assert dev == 2 and cost > 0          # the deflector saves the planet
    assert md > 0


def test_last_line_is_exactly_the_contract():
    line = chip_smoke.last_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}')
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}


def test_refuses_without_a_gpu(capsys):
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_fails_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
