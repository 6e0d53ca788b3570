"""Physics core: oscillation table, effective masses, missile cost.

Mirrors the reference's `namespace param` functions (hw5.cu:55-67,
samples/nbody.cc:14-19) with identical fp64 operation order so results are
bit-comparable to the serial spec.
"""

from __future__ import annotations

import math

import numpy as np

from .config import SimConfig


def oscillation_table(cfg: SimConfig, n_steps: int | None = None) -> np.ndarray:
    """|sin(step*dt / period)| for step = 0..n_steps inclusive.

    The reference precomputes this on the GPUs (PREPROCESS_FST,
    hw5.cu:143-148, 311-320) to hoist the transcendental out of the O(N^2)
    kernel; here the host precomputes it once. Uses math.sin (libm, like
    the C++ spec) rather than np.sin to keep ulp-level agreement with the
    serial oracle.

    Note the reference's table has only n_steps entries and reads one past
    the end at the final step (hw5.cu:555, 371 with step == n_steps) — an
    OOB bug. We implement the formula (hw5.cu:58) for all n_steps+1 steps.
    """
    if n_steps is None:
        n_steps = cfg.n_steps
    out = np.empty(n_steps + 1, dtype=np.float64)
    for s in range(n_steps + 1):
        # samples/nbody.cc:63: t = step * dt; :15: sin(t / 6000)
        out[s] = abs(math.sin((s * cfg.dt) / cfg.device_mass_period))
    return out


def effective_masses(m0, m0_dev_half, fst_t):
    """Masses at oscillation factor fst_t = |sin(t/period)|.

    m(t) = m0 + (0.5*m0)*fst for devices, m0 otherwise
    (samples/nbody.cc:14-16). `m0_dev_half` is 0.5*m0*device_mask,
    precomputed (multiplication by 0.5 is exact, so the rounding matches the
    serial spec's `m0 + 0.5 * m0 * fabs(...)` evaluation order).
    Works for any batch shape: m0 (..., n), m0_dev_half (..., n), fst_t (...).
    """
    import jax.numpy as jnp

    return m0 + m0_dev_half * jnp.asarray(fst_t)[..., None]


def missile_cost_for_arrival(cfg: SimConfig, arrival_step) -> float:
    """Cost when the missile arrives at `arrival_step`.

    The reference charges get_missile_cost((step+1)*dt) at the arrival step
    (hw5.cu:305): 1e5 + 1e3*(step+1)*dt.
    """
    t = (np.asarray(arrival_step, dtype=np.float64) + 1.0) * cfg.dt
    return cfg.missile_cost_base + cfg.missile_cost_per_t * t


def missile_travel_distance(cfg: SimConfig, step):
    """Distance the missile has covered by `step`: (speed*dt)*step
    (hw5.cu:273). speed*dt = 6e7 is exactly representable."""
    return (cfg.missile_speed * cfg.dt) * step
