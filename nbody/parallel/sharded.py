"""Body-sharded N-body step: ring all-gather of body tiles over NVLink.

The N-body analog of context/sequence parallelism (SURVEY.md §2.4 P9): bodies
(the "sequence") are sharded across GPUs along a mesh axis; each GPU owns a
row-block of the N x N interaction matrix and accumulates forces against
j-body tiles that rotate around the ring via `lax.ppermute` — the ring-
attention communication pattern. XLA hands the collective to NCCL, which
carries it over NVLink; XLA schedules it beside the per-rotation force
computation.

The reference has no cross-GPU communication at all (its two GPUs stage
everything through host memory, hw5.cu:406-413, 482-486); this module is the
scale-out capability the reference lacks, targeting N = 1M bodies on four
GPUs of one host.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def _partial_accel(qi, qj, gmj, eps: float):
    """Forces on local rows qi from one j-tile. qi: (ni, 3), qj: (nj, 3),
    gmj: (nj,) = G*m_eff. Self-pairs contribute exactly zero (softened
    denominator, zero numerator)."""
    dq = qj[None, :, :] - qi[:, None, :]          # (ni, nj, 3)
    d2 = (dq * dq).sum(-1) + eps * eps
    inv = lax.rsqrt(d2)
    w = gmj[None, :] * (inv * inv * inv)          # (ni, nj)
    return (w[..., None] * dq).sum(1)             # (ni, 3)


def ring_pairwise_accel(q_local, gm_local, *, axis_name: str, eps: float,
                        use_pallas: bool = False, interpret: bool = False):
    """All-pairs accelerations for this shard's bodies, rotating j-tiles
    around the `axis_name` ring. Call inside shard_map.

    use_pallas routes each (local rows x rotating tile) block through the
    fp32 Triton kernel (ops/pallas_forces.pallas_accel_cross) — the GPU
    path; the XLA broadcast path is the portable one (and the one used on
    CPU test meshes, or the kernel in interpret mode).
    """
    nshards = lax.axis_size(axis_name)
    perm = [(i, (i + 1) % nshards) for i in range(nshards)]

    if use_pallas:
        from ..ops.pallas_forces import pallas_accel_cross

        def partial(qi, qj, gmj):
            return pallas_accel_cross(qi, qj, gmj, eps=eps,
                                      interpret=interpret)
    else:
        def partial(qi, qj, gmj):
            return _partial_accel(qi, qj, gmj, eps)

    def body(_, carry):
        a, qj, gmj = carry
        a = a + partial(q_local, qj, gmj)
        qj = lax.ppermute(qj, axis_name, perm)
        gmj = lax.ppermute(gmj, axis_name, perm)
        return a, qj, gmj

    a0 = jnp.zeros_like(q_local)
    a, _, _ = lax.fori_loop(0, nshards, body, (a0, q_local, gm_local),
                            unroll=True)
    return a


def make_sharded_step(mesh: Mesh, *, body_axis: str = "body",
                      batch_axes: tuple = (), G: float, eps: float,
                      dt: float, use_pallas: bool = False,
                      interpret: bool = False):
    """Build a jitted sharded step: (q, v, m_eff) -> (q, v).

    q, v: (*batch, n, 3) sharded over `batch_axes` + bodies over `body_axis`;
    m_eff: (*batch, n) likewise. The returned function is the "training
    step" of this framework: one fused force+integrate update with ring
    collectives between the devices.
    """
    in_spec = P(*batch_axes, body_axis)
    state_spec = P(*batch_axes, body_axis, None)

    def local_step(q, v, m_eff):
        # q, v: (*b, n_local, 3); m_eff: (*b, n_local)
        def one(qb, vb, mb):
            a = ring_pairwise_accel(qb, G * mb, axis_name=body_axis, eps=eps,
                                    use_pallas=use_pallas,
                                    interpret=interpret)
            vb = vb + a * dt
            qb = qb + vb * dt
            return qb, vb

        for _ in batch_axes:
            one = jax.vmap(one)
        return one(q, v, m_eff)

    step = jax.shard_map(
        local_step, mesh=mesh,
        in_specs=(state_spec, state_spec, in_spec),
        out_specs=(state_spec, state_spec),
        # pallas_call outputs carry no varying-mesh-axes metadata; the specs
        # above already pin the sharding.
        check_vma=not use_pallas,
    )
    return jax.jit(step)


def simulate_sharded(q, v, m, n_steps: int, mesh: Mesh, *,
                     body_axis: str = "body", G: float = 6.674e-11,
                     eps: float = 1e-3, dt: float = 60.0,
                     m_half=None, fst=None, chunk: int | None = None,
                     on_chunk=None):
    """March a (possibly huge) body-sharded system entirely on-device:
    the scan lives inside one shard_map program, so each step is local
    compute + ring ppermute with no host involvement.

    m_half/fst: optional device-mass oscillation — per step t the
    effective mass is m + m_half * fst[t] (the graded spec's
    `m + 0.5*m*|sin(t*dt/6000)|` when m_half = 0.5*m*device_mask and fst
    is physics.oscillation_table's |sin| column; hw5.cu:58-63). Omitted:
    fixed masses, one fused n_steps-long scan (the round-1 behavior).

    chunk/on_chunk: host-chunked marching — after every `chunk` steps
    on_chunk(step, q, v) is called with the HOST state (checkpoint/
    logging hook, the mesh twin of simulate()'s). chunk=None runs a
    single monolithic scan (no host round-trips)."""
    state_spec = P(body_axis, None)
    m_spec = P(body_axis)

    oscillating = fst is not None
    if oscillating and m_half is None:
        raise ValueError("fst given without m_half: pass the device-mass "
                         "half-amplitudes (0.5 * m * device_mask)")
    if not oscillating:
        m_half = jnp.zeros_like(m)

    def run(q, v, m, m_half, fst_chunk):
        gm0 = G * m
        gm_half = G * m_half

        def body(carry, fst_t):
            q, v = carry
            gm = gm0 + gm_half * fst_t if oscillating else gm0
            a = ring_pairwise_accel(q, gm, axis_name=body_axis, eps=eps)
            v = v + a * dt
            q = q + v * dt
            return (q, v), None

        (q, v), _ = lax.scan(body, (q, v), fst_chunk,
                             length=fst_chunk.shape[0])
        return q, v

    fn = jax.jit(jax.shard_map(
        run, mesh=mesh,
        in_specs=(state_spec, state_spec, m_spec, m_spec, P(None)),
        out_specs=(state_spec, state_spec)))
    sharding = NamedSharding(mesh, state_spec)
    q = jax.device_put(q, sharding)
    v = jax.device_put(v, sharding)
    m = jax.device_put(m, NamedSharding(mesh, m_spec))
    m_half = jax.device_put(m_half, NamedSharding(mesh, m_spec))
    rep = NamedSharding(mesh, P(None))

    import numpy as np
    fst_h = (np.asarray(fst) if oscillating
             else np.zeros(n_steps + 1, np.asarray(m).dtype))
    if chunk is None:
        fc = jax.device_put(fst_h[1:n_steps + 1], rep)
        return fn(q, v, m, m_half, fc)
    step = 0
    while step < n_steps:
        n_sub = min(chunk, n_steps - step)
        # steps are 1-indexed in the oscillation table (spec semantics)
        fc = jax.device_put(fst_h[step + 1: step + 1 + n_sub], rep)
        q, v = fn(q, v, m, m_half, fc)
        step += n_sub
        if on_chunk is not None:
            on_chunk(step, np.asarray(q), np.asarray(v))
    return q, v
