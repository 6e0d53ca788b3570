"""Plummer-sphere initial conditions for synthetic benchmarks.

The graded testcases top out at N=1024; the throughput/scale benchmarks
(N=65536 on one GPU, N=1M sharded over four) use a standard
Plummer (1911) model: density rho(r) ∝ (1 + r^2/a^2)^(-5/2), isotropic
velocities drawn from the self-consistent distribution function. Units are
O(1) by construction (G = M = a = 1 scaled into the requested G), which also
keeps everything comfortably inside float32 range.
"""

from __future__ import annotations

import numpy as np


def plummer_scene(n: int, *, seed: int = 0, total_mass: float = 1e15,
                  scale_radius: float = 1e6, G: float = 6.674e-11):
    """Return (q, v, m) float64 arrays for an approximately virialized
    Plummer sphere with the given physical scales."""
    rs = np.random.RandomState(seed)
    m = np.full(n, total_mass / n)

    # radii via inverse-CDF of the Plummer mass profile
    x = rs.uniform(0.0, 1.0, n)
    r = scale_radius / np.sqrt(np.maximum(x ** (-2.0 / 3.0) - 1.0, 1e-12))
    # isotropic directions
    mu = rs.uniform(-1.0, 1.0, n)
    phi = rs.uniform(0.0, 2 * np.pi, n)
    st = np.sqrt(1 - mu * mu)
    q = (r[:, None] * np.stack([st * np.cos(phi), st * np.sin(phi), mu],
                               axis=1))

    # velocities: von Neumann rejection from g(x) = x^2 (1-x^2)^(7/2)
    ve = np.sqrt(2.0 * G * total_mass) * (r * r + scale_radius ** 2) ** -0.25
    xv = np.empty(n)
    todo = np.arange(n)
    while todo.size:
        x1 = rs.uniform(0.0, 1.0, todo.size)
        x2 = rs.uniform(0.0, 0.1, todo.size)
        ok = x2 < x1 * x1 * (1.0 - x1 * x1) ** 3.5
        xv[todo[ok]] = x1[ok]
        todo = todo[~ok]
    vmag = xv * ve
    mu_v = rs.uniform(-1.0, 1.0, n)
    phi_v = rs.uniform(0.0, 2 * np.pi, n)
    st_v = np.sqrt(1 - mu_v * mu_v)
    v = vmag[:, None] * np.stack(
        [st_v * np.cos(phi_v), st_v * np.sin(phi_v), mu_v], axis=1)

    # center of mass frame
    q -= q.mean(0)
    v -= v.mean(0)
    return q, v, m
