"""Exact power-of-2 unit rescaling.

The graded scenes live at astronomical magnitudes (positions ~1e20 m, masses
~1e36 kg, squared distances ~1e41) that overflow float32 — and therefore
the fp32 fast path and the f32-component tf3 paths. Rescaling by powers
of two is EXACT in floating point (it only shifts exponents), so a
rescaled simulation computes, op for
op, the same significands as the original — every intermediate is the
original value times a known power of 2.

Transform (time is untouched):
    q' = q * 2^qe     v' = v * 2^qe      m' = m * 2^me
    eps' = eps * 2^qe   R' = R * 2^qe    missile_speed' = speed * 2^qe
    G' = G * 2^(3*qe - me)
so that a' = G' m' dq' / (|dq'|^2 + eps'^2)^1.5 = a * 2^qe, making the
integrator scale-covariant. Distances unscale by 2^-qe; step indices and
missile costs (functions of t only) are unchanged.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from ..config import SimConfig
from ..io import Scene


@dataclasses.dataclass(frozen=True)
class Rescale:
    qe: int   # position/velocity/length exponent shift
    me: int   # mass exponent shift

    @property
    def length_scale(self) -> float:
        return math.ldexp(1.0, self.qe)

    @property
    def mass_scale(self) -> float:
        return math.ldexp(1.0, self.me)

    def apply_scene(self, scene: Scene) -> Scene:
        ls, ms = self.length_scale, self.mass_scale
        return dataclasses.replace(
            scene, q=scene.q * ls, v=scene.v * ls, m=scene.m * ms)

    def apply_cfg(self, cfg: SimConfig) -> SimConfig:
        ls = self.length_scale
        g_scale = math.ldexp(1.0, 3 * self.qe - self.me)
        return dataclasses.replace(
            cfg,
            G=cfg.G * g_scale,
            eps=cfg.eps * ls,
            planet_radius=cfg.planet_radius * ls,
            missile_speed=cfg.missile_speed * ls,
        )

    def unscale_length(self, x):
        return x * math.ldexp(1.0, -self.qe)


def compute_rescale(scene: Scene, eps: float = 1e-3,
                    growth_margin: float = 16.0,
                    target_m_exp: int = 0,
                    anchor_accel: bool = False,
                    G: float = 6.674e-11) -> Rescale:
    """Pick exponent shifts keeping every force-kernel intermediate within
    float32 range.

    Constraints on the length exponent qe (with the rsqrt fast path,
    inv_d^3 = (d2)^{-3/2} appears explicitly):
      * self/coincident pairs: d2' = eps'^2, so eps'^{-3} <= f32_max
        => lower bound on qe;
      * far pairs: dist3' = (span'^2 * 3)^{3/2} <= f32_max, with a
        `growth_margin` factor for orbital expansion over the run
        => upper bound on qe.
    Raises if the window is empty (the scene's dynamic range exceeds what
    a float32-range pipeline can represent).

    `anchor_accel` (the tf3/'ddp' path): XLA flushes f32 subnormals, so a
    tf3 triple keeps all three limbs only for |value| >= ~2^-78, and the
    per-body accelerations/velocities must stay above that for the state
    update `v += a*dt; q += v*dt` to retain answer-grade precision (a
    gauge inside the force kernel cannot help — `a` crosses the kernel
    boundary as a plain tf3 value). Computes the t=0 accelerations in f64
    on the host (O(n^2), graded scenes are tiny) and raises the window so
    the smallest per-body |a| and nonzero |v| sit at ~2^-58 — 20 bits of
    shrink headroom before any limb flushes — subject to the range upper
    bound, which wins if they conflict.
    """
    f32_max = 3.4e38
    qmax = float(np.max(np.abs(scene.q)))
    mmax = float(np.max(scene.m))
    if qmax == 0.0:
        return Rescale(qe=0, me=0)

    # eps' >= f32_max^{-1/3}
    eps_min = f32_max ** (-1.0 / 3.0)
    qe_min = math.ceil(math.log2(eps_min / eps))
    # sqrt(3) * (2 * margin * qmax * 2^qe) <= f32_max^{1/3}
    span_lim = f32_max ** (1.0 / 3.0) / math.sqrt(3.0)
    qe_max = math.floor(math.log2(span_lim / (2.0 * growth_margin * qmax)))
    if qe_min > qe_max:
        raise ValueError(
            f"scene dynamic range too large for f32-range rescaling: "
            f"qe window [{qe_min}, {qe_max}] empty (qmax={qmax}, eps={eps})")
    qe = (qe_min + qe_max) // 2
    if anchor_accel:
        # The tf3 kernel normalizes every wide-range intermediate with
        # per-pair/per-row exponent gauges (ops/forces.pairwise_accel_tf3),
        # so the d^3 ceiling above is obsolete for it; the hard ceiling is
        # d2 itself plus Dekker-split headroom (2^12 during tf3 products):
        # 3 * (2 * growth * qmax * 2^qe)^2 <= 2^114.
        qe_max = math.floor(math.log2(
            2.0 ** 57 / math.sqrt(3.0) / (2.0 * growth_margin * qmax)))
        floors = []
        # t=0 acceleration estimate in j-chunks: O(n * block) host memory
        # (the full (n, n, 3) dq tensor is ~100 GB at n=65536 — it would
        # OOM the single-core host even though the device kernels are
        # j-blocked for exactly that scale).
        n = scene.q.shape[0]
        block = int(np.clip((1 << 29) // max(24 * n, 1), 32, n))
        gm = G * scene.m
        a = np.zeros((n, 3))
        for j0 in range(0, n, block):
            dq = scene.q[None, j0:j0 + block, :] - scene.q[:, None, :]
            d2 = (dq * dq).sum(-1) + eps * eps
            a += (gm[None, j0:j0 + block, None] * dq
                  / (d2 * np.sqrt(d2))[:, :, None]).sum(axis=1)
        amag = np.abs(a).max(axis=1)
        if (amag > 0).any():
            floors.append(float(amag[amag > 0].min()))
        vmag = np.abs(scene.v).max(axis=1)
        if (vmag > 0).any():
            floors.append(float(vmag[vmag > 0].min()))
        if floors:
            qe_floor = math.ceil(-58 - math.log2(min(floors)))
            qe = max(qe, qe_floor)
        qe = max(qe_min, min(qe, qe_max))
    # Mass anchor: put the SMALLEST positive mass at ~2^target_m_exp, so
    # every scaled mass is a fully-normal f32 triple/pair (a tiny mass
    # anchored near the flush boundary would silently carry only 24-48
    # bits into the force products — measured as 2e-11 per-body force
    # errors on the tf3 path). Cap the largest at 2^60 to keep products
    # comfortably inside Dekker-split range.
    pos = scene.m[scene.m > 0]
    if pos.size == 0:
        return Rescale(qe=qe, me=0)
    me = target_m_exp - math.frexp(float(pos.min()))[1]
    me = min(me, 60 - math.frexp(mmax)[1])
    return Rescale(qe=qe, me=me)


IDENTITY = Rescale(qe=0, me=0)
