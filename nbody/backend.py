"""Backend/platform selection and the persistent compile cache.

The graded fp64 contract (16 significant digits over 200001 chaotic steps,
hw5.cu:136-137) needs IEEE-754 binary64, which both the CPU and the GPU
provide natively. Every JAX precision therefore runs on JAX's default
backend (the GPU when one is present); only 'exact', the native C++ serial
core, runs on the host CPU:

  * precision 'f64'  -> IEEE binary64 XLA scan (the main answer path)
  * precision 'e64'  -> bit-exact binary64 integer softfloat (ops/f64emu.py)
  * precision 'ddp'/'tf3'/'dd' -> extended/rescaled modes (engine.py)
  * precision 'f32'  -> fp32 fast path + exact 2^k rescaling; throughput
"""

from __future__ import annotations

import os

import jax

# <repo>/.jax_cache: a fixed path inside the checkout (listed in
# .gitignore). The cache key includes the directory, so it must not move
# between runs.
_REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def enable_persistent_compile_cache() -> str:
    """Turn on JAX's on-disk compilation cache and return its directory.

    When JAX_COMPILATION_CACHE_DIR is set, JAX already reads it and this
    sets no directory of its own; otherwise the cache lives in
    <repo>/.jax_cache. Mutates global jax config for the rest of the
    process (meant for entry points, not library code)."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = _REPO_CACHE_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 10.0)
    return path


def device_for(platform: str | None):
    """Return the first device of `platform` ('cpu' or 'gpu'), or JAX's
    default device when platform is None/'auto'. Asking for a platform
    that has no devices raises — a solve never falls back silently."""
    if platform in (None, "auto"):
        return jax.devices()[0]
    try:
        devices = jax.devices(platform)
    except RuntimeError as e:
        raise RuntimeError(f"no {platform!r} devices available: {e}") from e
    if not devices:
        raise RuntimeError(f"no {platform!r} devices available")
    return devices[0]


def default_platform_for_precision(precision: str) -> str:
    """'cpu' for the native core ('exact'); JAX's default backend for
    every JAX precision."""
    return "cpu" if precision == "exact" else jax.default_backend()
