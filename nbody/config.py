"""Runtime configuration.

The reference hard-codes physics constants in `namespace param`
(hw5.cu:50-82, samples/nbody.cc:9-20) and uses compile-time #define feature
flags (hw5.cu:1-6). Here everything is a runtime dataclass; the defaults are
bit-identical to the reference's `param` values.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Physics + engine configuration.

    Defaults mirror hw5.cu:50-67 / samples/nbody.cc:9-20 exactly.
    """

    # --- physics (reference param namespace) ---
    n_steps: int = 200000          # hw5.cu:51
    dt: float = 60.0               # hw5.cu:52
    eps: float = 1e-3              # hw5.cu:53
    G: float = 6.674e-11           # hw5.cu:54
    planet_radius: float = 1e7     # hw5.cu:65
    missile_speed: float = 1e6     # hw5.cu:66
    # missile cost = cost_base + cost_per_t * t   (hw5.cu:67)
    missile_cost_base: float = 1e5
    missile_cost_per_t: float = 1e3
    # device mass m(t) = m0 + 0.5*m0*|sin(t / period)|   (hw5.cu:58)
    device_mass_period: float = 6000.0

    # --- numerics ---
    # How (d2)^1.5 is computed in the fp64 graded paths. None resolves per
    # engine path: 'pow' for the native exact mode (the golden generator's
    # serial semantics, samples/nbody.cc:69 — byte-golden 12/12) and
    # 'dsqrt' (d2*sqrt(d2)) for the JAX paths. Measured: dsqrt uses only
    # correctly-rounded IEEE ops so XLA and libm agree bitwise (and dsqrt
    # outputs are byte-golden too), while XLA's pow deviates from libm
    # systematically and wrecks chaotic cases; dsqrt is also ~10x faster
    # (no scalar pow calls). hw5's MATH_OPTIMIZE variant is 'sqrt3'
    # (sqrt(d2*d2*d2), hw5.cu:204-206).
    dist3_mode: str | None = None  # None | 'pow' | 'dsqrt' | 'sqrt3'

    def resolved_dist3(self, precision: str = "f64") -> str:
        if self.dist3_mode is not None:
            return self.dist3_mode
        return "pow" if precision == "exact" else "dsqrt"

    # --- engine knobs ---
    # Steps per on-device scan chunk when early exit is enabled: the P2/P3
    # loops check their hit flag once per chunk (the reference syncs its
    # break flag to the host every n_sync_steps=2000 steps, hw5.cu:69,398).
    # Our check is a `lax.while_loop` condition, still fully on-device.
    chunk_steps: int = 2000

    def mass_factor_time(self, step) -> float:
        """Oscillation argument t = step*dt (samples/nbody.cc:63)."""
        return step * self.dt

    def missile_cost(self, t: float) -> float:
        """1e5 + 1e3*t (hw5.cu:67). t is (arrival_step+1)*dt (hw5.cu:305)."""
        return self.missile_cost_base + self.missile_cost_per_t * t


DEFAULT_CONFIG = SimConfig()
