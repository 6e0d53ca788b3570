"""General simulation API: march a scene for N steps on any backend.

The reference binary only answers the three scenario questions; a framework
user also wants the underlying capability — "integrate this system" — with
device oscillation on/off, checkpoint/resume, and backend/precision choice.

  final = simulate(scene, n_steps=..., precision="f32",
                   integrator="leapfrog", on_chunk=callback)

The loop is chunked: each chunk is one on-device scan (zero host traffic);
between chunks the host may checkpoint or log. Chunk size trades host
round-trips against checkpoint granularity.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .config import SimConfig, DEFAULT_CONFIG
from .io import Scene
from .physics import oscillation_table
from . import backend
from .utils.rescale import compute_rescale, IDENTITY


@dataclasses.dataclass
class SimState:
    step: int
    q: np.ndarray
    v: np.ndarray


def _comp_add(x, c, d):
    """Kahan compensated x += d with running compensation c.

    y = d - c recovers the low-order bits lost on previous adds; the new
    compensation is the rounding error of t = x + y, extracted exactly by
    (t - x) - y (|y| <= |x| in the integration regime). XLA does not
    reassociate scalar float adds, so the extraction survives jit; an fma
    contraction inside d only changes the increment's last ulp, never the
    extraction (the same y value feeds both uses)."""
    y = d - c
    t = x + y
    return t, (t - x) - y


@functools.partial(jax.jit, static_argnames=("n_sub", "dt", "eps", "G",
                                             "fast", "dist3_mode",
                                             "use_pallas", "integrator",
                                             "compensated"))
def _chunk_scan(q, v, a, m0, m_half, fst_chunk, qc=None, vc=None, *,
                n_sub, dt, eps, G, fast, dist3_mode, use_pallas,
                integrator="euler", compensated=False):
    from .ops.integrate import symplectic_euler_step, kdk_leapfrog_step
    from .ops.forces import (pairwise_accel_e64, pairwise_accel_fast,
                             pairwise_accel_tf3)
    from .ops.pallas_forces import pallas_accel
    from .ops.f64emu import E64
    from .ops.tfloat import TF3

    def accel(q, m_eff):
        if isinstance(q, E64):
            return pairwise_accel_e64(q, m_eff, G=G, eps=eps)
        if isinstance(q, TF3):
            return pairwise_accel_tf3(q, m_eff, G=G, eps=eps)
        if use_pallas:
            return pallas_accel(q, (G * m_eff).astype(q.dtype), eps=eps)
        return pairwise_accel_fast(q, m_eff, G=G, eps=eps)

    def body(carry, fst_t):
        if compensated:
            # compensated q/v accumulation: the per-step kicks/drifts are
            # ~1e-5 of |v|/|q| in these scenes, so each += loses ~17 bits
            # of the increment in fp32; the running compensation recovers
            # them for ~6 flops/body/step — invisible next to the n^2
            # force (scripts/study_f32_horizon.py measures the error).
            q, v, a, qc, vc = carry
        else:
            q, v, a = carry
        m_eff = m0 + m_half * fst_t
        if integrator == "leapfrog":
            if compensated:
                v, vc = _comp_add(v, vc, a * (0.5 * dt))
                q, qc = _comp_add(q, qc, v * dt)
                a = accel(q, m_eff)
                v, vc = _comp_add(v, vc, a * (0.5 * dt))
            else:
                vh = v + a * (0.5 * dt)
                q = q + vh * dt
                a = accel(q, m_eff)
                v = vh + a * (0.5 * dt)
        elif compensated:
            a2 = accel(q, m_eff)
            v, vc = _comp_add(v, vc, a2 * dt)
            q, qc = _comp_add(q, qc, v * dt)
        elif use_pallas:
            a2 = accel(q, m_eff)
            v = v + a2 * dt
            q = q + v * dt
        else:
            q, v = symplectic_euler_step(q, v, m_eff, G=G, eps=eps, dt=dt,
                                         dist3_mode=dist3_mode, fast=fast)
        return ((q, v, a, qc, vc) if compensated else (q, v, a)), None

    if compensated:
        # the compensation carries ACROSS chunks (qc/vc thread through the
        # host loop): resetting it each chunk would re-lose the residual
        # at every boundary and break compensation-level chunk invariance
        init = (q, v, a, qc, vc)
        (q, v, a, qc, vc), _ = lax.scan(body, init, fst_chunk,
                                        length=n_sub)
        return q, v, a, qc, vc
    (q, v, a), _ = lax.scan(body, (q, v, a), fst_chunk, length=n_sub)
    return q, v, a, None, None


@functools.partial(jax.jit, static_argnames=("mesh", "n_sub", "dt", "eps",
                                             "G", "fast", "dist3_mode",
                                             "integrator", "tile", "kind",
                                             "seed", "compensated"))
def _chunk_scan_mesh(q, v, a, m0, m_half, fst_chunk, qc=None, vc=None, *,
                     mesh, n_sub, dt, eps, G, fast, dist3_mode, integrator,
                     tile, kind, seed=False, compensated=False):
    """One on-mesh chunk of simulate(): the scan lives inside shard_map,
    so each step is local compute + ring/all-gather collectives with no
    host involvement (the multi-chip twin of _chunk_scan).

    kind: 'native' (f64/dd/f32 — body-sharded state, ordered ppermute
    ring), 'tf3' (triple-f32 state on the ring), or 'e64' (the bit-exact
    softfloat: body-REPLICATED state, only the O(n^2) force rows split —
    see parallel/solver_sharded._p12_chunk_sharded_e64)."""
    from jax.sharding import PartitionSpec as P

    from .parallel.solver_sharded import (ring_accel_ordered,
                                          ring_accel_ordered_tf3)
    from .ops.f64emu import E64
    from .ops.forces import pairwise_accel_e64
    from .ops import f64emu as fe

    def accel(q, m_eff):
        if kind == "e64":
            k = lax.axis_size("body")
            me = lax.axis_index("body")
            ni = q.hi.shape[-2] // k
            rows = E64(
                lax.dynamic_slice_in_dim(q.hi, me * ni, ni, axis=0),
                lax.dynamic_slice_in_dim(q.lo, me * ni, ni, axis=0))
            ar = pairwise_accel_e64(q, m_eff, G=G, eps=eps, rows=rows)
            return E64(lax.all_gather(ar.hi, "body", axis=0, tiled=True),
                       lax.all_gather(ar.lo, "body", axis=0, tiled=True))
        if kind == "tf3":
            return ring_accel_ordered_tf3(q, m_eff, axis_name="body",
                                          eps=eps, G=G, tile=tile)
        return ring_accel_ordered(q, G * m_eff, axis_name="body", eps=eps,
                                  tile=tile, dist3_mode=dist3_mode,
                                  fast=fast)

    def local_chunk(q, v, a, m0, m_half, fst_chunk, qc=None, vc=None):
        if seed and integrator == "leapfrog":
            # the first chunk seeds the carried acceleration at the
            # initial positions with the first step's oscillating masses
            # (same value _chunk_scan's host-side seed uses)
            a = accel(q, m0 + m_half * fst_chunk[0])

        def body(carry, fst_t):
            if compensated:
                # the mesh twin of _chunk_scan's Kahan accumulation: the
                # compensation is per-body local state, so it shards with
                # q/v and needs no collectives
                q, v, a, qc, vc = carry
            else:
                q, v, a = carry
            m_eff = m0 + m_half * fst_t
            if integrator == "leapfrog":
                if compensated:
                    v, vc = _comp_add(v, vc, a * (0.5 * dt))
                    q, qc = _comp_add(q, qc, v * dt)
                    a = accel(q, m_eff)
                    v, vc = _comp_add(v, vc, a * (0.5 * dt))
                else:
                    vh = v + a * (0.5 * dt)
                    q = q + vh * dt
                    a = accel(q, m_eff)
                    v = vh + a * (0.5 * dt)
            elif compensated:
                a2 = accel(q, m_eff)
                v, vc = _comp_add(v, vc, a2 * dt)
                q, qc = _comp_add(q, qc, v * dt)
            else:
                a2 = accel(q, m_eff)
                v = v + a2 * dt
                q = q + v * dt
            return ((q, v, a, qc, vc) if compensated else (q, v, a)), None

        if compensated:
            (q, v, a, qc, vc), _ = lax.scan(body, (q, v, a, qc, vc),
                                            fst_chunk, length=n_sub)
            return q, v, a, qc, vc
        (q, v, a), _ = lax.scan(body, (q, v, a), fst_chunk, length=n_sub)
        return q, v, a

    state = P(None, None) if kind == "e64" else P("body", None)
    mspec = P(None) if kind == "e64" else P("body")
    if compensated:
        specs = (state, state, state, mspec, mspec, P(None), state, state)
        fn = jax.shard_map(local_chunk, mesh=mesh, in_specs=specs,
                           out_specs=(state, state, state, state, state))
        return fn(q, v, a, m0, m_half, fst_chunk, qc, vc)
    specs = (state, state, state, mspec, mspec, P(None))
    fn = jax.shard_map(local_chunk, mesh=mesh, in_specs=specs,
                       out_specs=(state, state, state))
    return (*fn(q, v, a, m0, m_half, fst_chunk), None, None)


def simulate(scene: Scene, cfg: SimConfig = DEFAULT_CONFIG, *,
             n_steps: Optional[int] = None, precision: str = "f64",
             platform: Optional[str] = None, devices_on: bool = True,
             chunk: int = 10000, integrator: str = "euler",
             mesh=None, tile: Optional[int] = None,
             compensated: Optional[bool] = None,
             on_chunk: Optional[Callable[[SimState], None]] = None
             ) -> SimState:
    """March the scene and return the final state (original units).

    integrator: 'euler' (the graded spec's semi-implicit Euler) or
    'leapfrog' (KDK velocity Verlet, 2nd order, same one-force-eval cost).

    mesh: a jax.sharding.Mesh with a 'body' axis — the chunk scan runs
    inside shard_map, bodies sharded over the ring (f64/dd/f32/tf3) or
    the force rows split with replicated state (e64). Every precision x
    integrator cell works on the mesh (see the support matrix in
    RUNBOOK.md); `tile` pins the force-tile size (same tile => the
    native-dtype paths are bit-identical across mesh shapes, the
    contract of parallel/solver_sharded).

    compensated: Kahan-compensated q/v accumulation for the native-dtype
    paths (~6 flops/body/step, invisible next to the n^2 force): the
    per-step increments are ~1e-5 of the state in these scenes, so each
    fp32 += quietly discards ~17 bits of the increment — compensation
    recovers them and extends the usable fp32 horizon (error study:
    scripts/study_f32_horizon.py). Default (None): ON for precision 'f32',
    single-device AND mesh (the compensation is per-body local state, so
    it shards with q/v). The extended representations (tf3/e64/dd) carry
    their own extra bits; requesting compensation there is an error.

    `on_chunk` is called with a host-side SimState after every chunk
    (checkpointing hook — pair with utils.checkpoint.CheckpointPolicy).
    """
    if integrator not in ("euler", "leapfrog"):
        raise ValueError(f"unknown integrator: {integrator}")
    if compensated is None:
        compensated = precision == "f32"
    elif compensated and precision in ("tf3", "ddp", "dd+", "e64", "dd"):
        raise ValueError(
            "compensated accumulation applies to the native-dtype paths "
            "(f32/f64, single-device or mesh); the extended "
            "representations carry their own low-order bits")
    if n_steps is None:
        n_steps = cfg.n_steps
    if mesh is None and platform is None:
        platform = backend.default_platform_for_precision(precision)
    device = None if mesh is not None else backend.device_for(platform)

    rescale = IDENTITY
    run_scene = scene
    run_cfg = dataclasses.replace(cfg,
                                  dist3_mode=cfg.resolved_dist3(precision))
    dtype: object = np.float64
    fast = False
    if precision in ("dd", "f32"):
        rescale = compute_rescale(scene, eps=run_cfg.eps)
        run_scene = rescale.apply_scene(scene)
        run_cfg = rescale.apply_cfg(run_cfg)
        fast = True
        if precision == "f32":
            dtype = np.float32
    elif precision == "e64":
        # bit-exact binary64 softfloat — full exponent range, no rescale
        dtype = "e64"
    elif precision in ("tf3", "ddp", "dd+"):
        # truth-grade triple-f32 trajectories (simulate() has no graded
        # decision quantities, so the f64-grid 'ddp' distinction does not
        # apply here — both names run raw tf3)
        rescale = compute_rescale(scene, eps=run_cfg.eps, anchor_accel=True,
                                  G=run_cfg.G)
        run_scene = rescale.apply_scene(scene)
        run_cfg = rescale.apply_cfg(run_cfg)
        dtype = "tf3"
    elif precision != "f64":
        raise ValueError(f"unknown precision for simulate: {precision}")

    # the fp32 force runs through the Triton kernel on the GPU
    # (ops/pallas_forces.py); elsewhere through XLA's fused reduction
    use_pallas = (mesh is None and precision == "f32"
                  and device.platform == "gpu")
    kind = dtype if dtype in ("e64", "tf3") else "native"
    if mesh is not None:
        # pad bodies so each shard owns n/body rows, themselves a
        # multiple of the force tile (padding is semantics-exact and the
        # final state slices back to scene.n)
        from .utils.padding import pad_scene
        body = mesh.shape["body"]
        align = body if kind == "e64" else body * (tile or 1)
        n_target = ((run_scene.n + align - 1) // align) * align
        run_scene = pad_scene(run_scene, n_target=n_target,
                              d_target=run_scene.device_cnt)
        if tile is None and kind != "e64":
            tile = run_scene.n // body

    fst = oscillation_table(run_cfg, n_steps)
    mask = run_scene.device_mask()
    m0 = run_scene.m * (1.0 if devices_on else (1.0 - mask))
    m_half = 0.5 * m0 * mask

    from .models.direct_sum import _make_converter
    conv = _make_converter(dtype)
    host_dtype = np.float64 if isinstance(dtype, str) else dtype
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        state_spec = P(None, None) if kind == "e64" else P("body", None)
        mass_spec = P(None) if kind == "e64" else P("body")
        put_state = lambda x: jax.device_put(x, NamedSharding(mesh,
                                                              state_spec))
        put_mass = lambda x: jax.device_put(x, NamedSharding(mesh,
                                                             mass_spec))
        put_rep = lambda x: jax.device_put(x, NamedSharding(mesh, P(None)))
    else:
        put_state = put_mass = put_rep = functools.partial(jax.device_put,
                                                           device=device)
    put = put_rep
    q = put_state(conv(np.asarray(run_scene.q, dtype=host_dtype)))
    v = put_state(conv(np.asarray(run_scene.v, dtype=host_dtype)))
    m0j = put_mass(conv(np.asarray(m0, dtype=host_dtype)))
    m_halfj = put_mass(conv(np.asarray(m_half, dtype=host_dtype)))

    inv = 1.0 / rescale.length_scale

    def host_qv(q, v):
        if isinstance(dtype, str):
            from .ops import tfloat
            from .ops.f64emu import e64_to_f64
            to64 = e64_to_f64 if dtype == "e64" else tfloat.to_f64
            return to64(q)[:scene.n] * inv, to64(v)[:scene.n] * inv
        return np.asarray(q)[:scene.n] * inv, np.asarray(v)[:scene.n] * inv
    # Leapfrog carries the acceleration; seed it at the initial positions
    # with the first step's oscillating masses. The representation-extended
    # types (TF3/E64) promote plain scalars through their overloaded
    # operators, so the same expressions serve every precision; only the
    # force kernel dispatches.
    if integrator == "leapfrog" and mesh is not None:
        # seeded inside the first mesh chunk (the scan's first fst value
        # IS the seed's): one fewer jit signature than a host-side seed
        from .ops.f64emu import zeros_e
        from .ops import tfloat
        a = put_state(
            zeros_e(np.shape(run_scene.q)) if dtype == "e64"
            else tfloat.zeros(np.shape(run_scene.q)) if dtype == "tf3"
            else np.zeros(np.shape(run_scene.q), host_dtype))
    elif integrator == "leapfrog":
        from .ops.forces import (pairwise_accel_e64, pairwise_accel_fast,
                                 pairwise_accel_tf3)
        f0 = float(fst[min(1, n_steps)])
        if dtype == "e64":
            m_eff0 = m0j + m_halfj * f0
            a = pairwise_accel_e64(q, m_eff0, G=run_cfg.G, eps=run_cfg.eps)
        elif dtype == "tf3":
            m_eff0 = m0j + m_halfj * f0
            a = pairwise_accel_tf3(q, m_eff0, G=run_cfg.G, eps=run_cfg.eps)
        else:
            m_eff0 = m0j + m_halfj * dtype(f0)
            a = pairwise_accel_fast(q, m_eff0, G=run_cfg.G, eps=run_cfg.eps)
    elif isinstance(dtype, str):
        from .ops.f64emu import zeros_e
        from .ops import tfloat
        a = (zeros_e(np.shape(run_scene.q)) if dtype == "e64"
             else tfloat.zeros(np.shape(run_scene.q)))
    else:
        a = jnp.zeros_like(q)

    qc = vc = None
    if compensated:
        qc = put_state(np.zeros(np.shape(run_scene.q), host_dtype))
        vc = put_state(np.zeros(np.shape(run_scene.q), host_dtype))
    step = 0
    while step < n_steps:
        n_sub = min(chunk, n_steps - step)
        fst_chunk = put(conv(np.asarray(fst[step + 1: step + 1 + n_sub],
                                        dtype=host_dtype)))
        if mesh is not None:
            q, v, a, qc, vc = _chunk_scan_mesh(
                q, v, a, m0j, m_halfj, fst_chunk, qc, vc, mesh=mesh,
                n_sub=n_sub, dt=run_cfg.dt, eps=run_cfg.eps, G=run_cfg.G,
                fast=fast, dist3_mode=run_cfg.dist3_mode,
                integrator=integrator, tile=tile, kind=kind,
                seed=step == 0, compensated=compensated)
        else:
            q, v, a, qc, vc = _chunk_scan(
                q, v, a, m0j, m_halfj, fst_chunk, qc, vc, n_sub=n_sub,
                dt=run_cfg.dt, eps=run_cfg.eps, G=run_cfg.G,
                fast=fast, dist3_mode=run_cfg.dist3_mode,
                use_pallas=use_pallas, integrator=integrator,
                compensated=compensated)
        step += n_sub
        if on_chunk is not None:
            hq, hv = host_qv(q, v)
            on_chunk(SimState(step=step, q=hq, v=hv))

    hq, hv = host_qv(q, v)
    return SimState(step=step, q=hq, v=hv)
