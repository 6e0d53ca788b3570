"""ctypes binding to the native serial core (native/core.cc).

The `exact` precision mode: true-f64, serial-summation-order semantics that
reproduce the golden outputs byte-for-byte (with dist3 mode `pow`). The
native library is built by `make -C native` (done on demand here).
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

from .config import SimConfig
from .io import Scene

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libnbody_core.so")

_DIST3_MODES = {"pow": 0, "dsqrt": 1, "sqrt3": 2}

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    import fcntl
    # several processes (test workers) may build at once: the lock keeps
    # any of them from loading a library another is still linking
    with open(os.path.join(_NATIVE_DIR, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(_LIB_PATH):
            subprocess.run(["make", "-C", _NATIVE_DIR, "libnbody_core.so"],
                           check=True, capture_output=True)
        lib = ctypes.CDLL(_LIB_PATH)
    lib.nbody_solve_cfg.restype = ctypes.c_int
    lib.nbody_solve_cfg.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,          # n, planet, asteroid
        ctypes.POINTER(ctypes.c_double),                   # q (n,3)
        ctypes.POINTER(ctypes.c_double),                   # v (n,3)
        ctypes.POINTER(ctypes.c_double),                   # m (n,)
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int,      # device_idx, cnt
        ctypes.c_int, ctypes.c_int,                        # n_steps, mode
        ctypes.POINTER(ctypes.c_double),                   # phys[8]
        ctypes.POINTER(ctypes.c_double),                   # out_min_dist
        ctypes.POINTER(ctypes.c_int32),                    # out_hit_step
        ctypes.POINTER(ctypes.c_int32),                    # out_device_id
        ctypes.POINTER(ctypes.c_double),                   # out_cost
    ]
    _lib = lib
    return lib


def solve_exact(scene: Scene, cfg: SimConfig, dist3_mode: str = "pow"):
    """Solve all three problems with the native serial core.

    Every physics constant in `cfg` (dt, eps, G, planet_radius,
    missile_speed, missile cost coefficients, device-mass period) passes
    through the C ABI (core.h nbody_solve_cfg) — the runtime analog of the
    reference's compile-time `namespace param` (hw5.cu:50-67). With the
    defaults the solver is byte-identical to the hard-coded build (IEEE
    ops are value-deterministic). Returns (min_dist, hit_step, device_id,
    cost).
    """
    lib = _load()
    q = np.ascontiguousarray(scene.q, dtype=np.float64)
    v = np.ascontiguousarray(scene.v, dtype=np.float64)
    m = np.ascontiguousarray(scene.m, dtype=np.float64)
    dev = np.ascontiguousarray(scene.device_idx, dtype=np.int32)
    phys = np.asarray([cfg.dt, cfg.eps, cfg.G, cfg.planet_radius,
                       cfg.missile_speed, cfg.missile_cost_base,
                       cfg.missile_cost_per_t, cfg.device_mass_period],
                      dtype=np.float64)

    out_min = ctypes.c_double()
    out_hit = ctypes.c_int32()
    out_dev = ctypes.c_int32()
    out_cost = ctypes.c_double()
    rc = lib.nbody_solve_cfg(
        scene.n, scene.planet, scene.asteroid,
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        dev.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        scene.device_cnt, cfg.n_steps, _DIST3_MODES[dist3_mode],
        phys.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.byref(out_min), ctypes.byref(out_hit), ctypes.byref(out_dev),
        ctypes.byref(out_cost),
    )
    if rc != 0:
        raise RuntimeError(f"nbody_solve failed with code {rc}")
    return out_min.value, int(out_hit.value), int(out_dev.value), out_cost.value
