"""Device selection and the persistent compile cache (nbody/backend.py)."""

import os

import numpy as np
import pytest

import jax

from nbody import backend

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_config():
    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    yield
    jax.config.update("jax_compilation_cache_dir", saved[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", saved[1])


def _tiny_scene_file(tmp_path):
    rs = np.random.RandomState(0)
    path = tmp_path / "tiny.in"
    with open(path, "w") as f:
        f.write("4 0 1\n")
        for i, t in enumerate(["planet", "asteroid", "device", "star"]):
            q, v = rs.randn(3) * 1e10, rs.randn(3) * 1e2
            f.write(" ".join("%.17e" % x for x in (*q, *v, 1e20 + i))
                    + f" {t}\n")
    return str(path)


def test_platform_gpu_raises_without_gpu(tmp_path):
    """Asking for the GPU on a host without one fails; nothing falls back
    to the CPU."""
    from nbody.cli import main

    with pytest.raises(RuntimeError, match="gpu"):
        backend.device_for("gpu")
    with pytest.raises(RuntimeError, match="gpu"):
        main([_tiny_scene_file(tmp_path), str(tmp_path / "o.out"),
              "--n-steps", "3", "--platform", "gpu"])
    assert not (tmp_path / "o.out").exists()


def test_auto_picks_cpu_on_a_cpu_only_process(tmp_path):
    assert backend.device_for("auto").platform == "cpu"
    assert backend.device_for(None).platform == "cpu"
    assert backend.device_for("cpu").platform == "cpu"

    from nbody.cli import main
    out = tmp_path / "o.out"
    assert main([_tiny_scene_file(tmp_path), str(out), "--n-steps", "3",
                 "--platform", "auto"]) == 0
    assert len(out.read_text().strip().split("\n")) == 3


def test_default_platform_for_precision(monkeypatch):
    """Every JAX precision, f64 included, runs on JAX's default backend;
    only the native core ('exact') stays on the CPU."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    for prec in ("f64", "e64", "ddp", "tf3", "dd", "f32"):
        assert backend.default_platform_for_precision(prec) == "gpu", prec
    assert backend.default_platform_for_precision("exact") == "cpu"


def test_compile_cache_honours_env(monkeypatch, tmp_path,
                                   restore_cache_config):
    """With JAX_COMPILATION_CACHE_DIR set, the program sets no directory
    of its own (JAX reads the variable itself)."""
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert backend.enable_persistent_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_repo_dir(monkeypatch,
                                            restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = backend.enable_persistent_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
