"""Tiled all-pairs fp32 force kernel for the GPU (Pallas, Triton route).

The GPU replacement for the reference's hot CUDA kernel
`compute_accelerations_gpu` (hw5.cu:159-215). Design differences:

  * The CUDA kernel assigns one thread per (i, j) pair and folds rows with
    fp64 atomicAdd (hw5.cu:211-213) — a nondeterministic summation order.
    Here each program owns a block of BLOCK_I rows and walks the j bodies
    in blocks of BLOCK_J inside an in-kernel loop: every j block is loaded
    once and reused across all of the program's rows, and the partial
    sums stay in fp32 registers. This is the shared-memory j-tiling that
    hw5.cu:165-178 wrote and left disabled.
  * The per-row fold order is fixed (each lane folds its j column over
    ascending j blocks, then one fixed cross-lane reduction):
    deterministic by construction, no atomics.
  * The oscillating device masses are folded into `gm = G * m_eff(t)` by
    one (n,) elementwise XLA op per step before the call.

Bodies travel as separate x/y/z/gm vectors (Triton blocks are powers of
two, an (n, 3) layout is not). Ragged sizes are padded with zero-mass
bodies, which contribute exactly 0 to every sum. Self-interactions need
no masking: dq = 0 makes the numerator zero while softening keeps the
denominator finite (the identity the serial spec's `continue` expresses,
samples/nbody.cc:59-60).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# Block sizes and launch shape (rows per program, j bodies per loop step,
# warps, software-pipeline stages); see PERF.md for the sweep on the card.
BLOCK_I = 32
BLOCK_J = 32
NUM_WARPS = 4
NUM_STAGES = 3


def _accel_kernel(xi_ref, yi_ref, zi_ref, xj_ref, yj_ref, zj_ref, gm_ref,
                  ax_ref, ay_ref, az_ref, *, eps2: float, block_j: int):
    """One program: BLOCK_I rows against every j body, in j blocks.

    The partial sums stay (BLOCK_I, BLOCK_J)-shaped through the j loop
    (each lane folds its own j column) and are reduced across lanes once
    at the end: no cross-lane reduction inside the loop."""
    xi = xi_ref[...][:, None]                     # (BI, 1)
    yi = yi_ref[...][:, None]
    zi = zi_ref[...][:, None]

    def body(jb, acc):
        ax, ay, az = acc
        js = pl.ds(pl.multiple_of(jb * block_j, block_j), block_j)
        dx = xj_ref[js][None, :] - xi             # (BI, BJ)
        dy = yj_ref[js][None, :] - yi
        dz = zj_ref[js][None, :] - zi
        d2 = dx * dx + dy * dy + dz * dz + eps2
        inv = lax.rsqrt(d2)
        w = gm_ref[js][None, :] * (inv * inv * inv)
        return ax + w * dx, ay + w * dy, az + w * dz

    zero = jnp.zeros((xi_ref.shape[0], block_j), jnp.float32)
    n_blocks = xj_ref.shape[0] // block_j
    ax, ay, az = lax.fori_loop(jnp.int32(0), jnp.int32(n_blocks), body,
                               (zero, zero, zero))
    ax_ref[...] = jnp.sum(ax, axis=1)
    ay_ref[...] = jnp.sum(ay, axis=1)
    az_ref[...] = jnp.sum(az, axis=1)


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


@functools.partial(jax.jit, static_argnames=(
    "eps", "block_i", "block_j", "num_warps", "num_stages", "interpret"))
def pallas_accel_cross(qi, qj, gmj, *, eps: float, block_i: int = BLOCK_I,
                       block_j: int = BLOCK_J, num_warps: int = NUM_WARPS,
                       num_stages: int = NUM_STAGES, interpret: bool = False):
    """Accelerations on rows `qi` (ni, 3) from sources `qj` (nj, 3) with
    `gmj = G*m_eff` (nj,), in fp32. The building block of the body-sharded
    ring (parallel/sharded.py): each device's rows against a rotating
    source block. Any ni, nj: both sides are padded to their block with
    zero-mass bodies and the padded rows are dropped."""
    ni, nj = qi.shape[0], qj.shape[0]
    block_i = min(block_i, _next_pow2(ni))
    block_j = min(block_j, _next_pow2(nj))
    pad_i, pad_j = (-ni) % block_i, (-nj) % block_j
    f32 = jnp.float32
    qi_t = jnp.pad(qi.astype(f32), ((0, pad_i), (0, 0))).T     # (3, ni_p)
    qj_t = jnp.pad(qj.astype(f32), ((0, pad_j), (0, 0))).T     # (3, nj_p)
    gm = jnp.pad(gmj.astype(f32), (0, pad_j))
    ni_p, nj_p = ni + pad_i, nj + pad_j

    row = pl.BlockSpec((block_i,), lambda i: (i,))
    src = pl.BlockSpec((nj_p,), lambda i: (0,))
    out = jax.ShapeDtypeStruct((ni_p,), f32)
    ax, ay, az = pl.pallas_call(
        functools.partial(_accel_kernel, eps2=eps * eps, block_j=block_j),
        grid=(ni_p // block_i,),
        in_specs=[row, row, row, src, src, src, src],
        out_specs=[row, row, row],
        out_shape=[out, out, out],
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=num_stages),
        cost_estimate=pl.CostEstimate(
            flops=20 * ni_p * nj_p,
            bytes_accessed=4 * (3 * ni_p + 4 * nj_p + 3 * ni_p),
            transcendentals=ni_p * nj_p,                       # rsqrt
        ),
        interpret=interpret,
        name="nbody_accel_f32",
    )(qi_t[0], qi_t[1], qi_t[2], qj_t[0], qj_t[1], qj_t[2], gm)
    return jnp.stack([ax, ay, az], axis=-1)[:ni].astype(qi.dtype)


def pallas_accel(q, gm, *, eps: float, **kw):
    """All-pairs accelerations. q: (n, 3); gm: (n,) = G*m_eff.
    pallas_accel(q, gm) == pallas_accel_cross(q, q, gm)."""
    return pallas_accel_cross(q, q, gm, eps=eps, **kw)
