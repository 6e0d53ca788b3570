"""Scene padding to size buckets.

Why pad: compile-signature bucketing. Every distinct (n, device_cnt) is
its own jit signature and compile; padding the graded scene sizes into a
few buckets shares one executable per bucket. Whether the extra pair work
of a padded small scene pays for that on the GPU is an open measurement
(ROADMAP S4).

Padding is SEMANTICS-EXACT: pad bodies have zero mass, so they contribute
+0.0 to every force sum (an fp identity — x + 0.0 == x for finite x), and
dummy device slots point at pad bodies, so zeroing them in Problem-3
scenarios is a no-op. Pad scenario rows are masked out of answer selection
(the engine only reads the first `device_cnt` rows).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..io import Scene

N_BUCKETS = (128, 256, 512, 1024, 2048)


def bucket_size(n: int, buckets=N_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    # round up to the next multiple of the largest bucket
    top = buckets[-1]
    return ((n + top - 1) // top) * top


def mesh_pad_target(n: int, body: int, tile: int | None = None) -> int:
    """The padded body count the engine's mesh path will actually use.

    bucket_size(n) (or the NBODY_MESH_MIN_BUCKET override, for tiny-scene
    mesh runs whose wall is XLA:CPU softfloat COMPILE, not compute), rounded
    up so every shard's row block is a whole multiple of the tile. Shared
    by engine.solve_scene and the CLI --tile pre-check so the guard can
    never disagree with the engine."""
    import os
    n_target = bucket_size(n)
    mb = os.environ.get("NBODY_MESH_MIN_BUCKET")
    if mb:
        n_target = max(n, int(mb))
    n_target = ((n_target + body - 1) // body) * body
    if tile is not None:
        lcm = body * tile
        n_target = ((n_target + lcm - 1) // lcm) * lcm
    return n_target


def pad_scene(scene: Scene, n_target: int | None = None,
              d_target: int = 4) -> Scene:
    """Pad to n_target bodies (default: bucket) and d_target device slots.

    Pad bodies sit at the origin with zero mass and velocity; dummy device
    slots reference pad bodies (each a distinct one when available)."""
    if n_target is None:
        n_target = bucket_size(scene.n)
    n_pad = n_target - scene.n
    d_pad = max(d_target - scene.device_cnt, 0)
    if scene.device_cnt == 0:
        # A device-free scene has no Problem-3 scenarios at all; padding in
        # dummy device slots would require a zero-mass body to point them at
        # (none is guaranteed when n_pad == 0). Keep zero slots — the rare
        # extra jit signature beats corrupting a real body's mass.
        d_pad = 0
    if n_pad == 0 and d_pad == 0:
        return scene
    if n_pad < 0:
        raise ValueError(f"n_target {n_target} < scene.n {scene.n}")

    q = np.concatenate([scene.q, np.zeros((n_pad, 3))], axis=0)
    v = np.concatenate([scene.v, np.zeros((n_pad, 3))], axis=0)
    m = np.concatenate([scene.m, np.zeros(n_pad)], axis=0)
    types = list(scene.types) + ["pad"] * n_pad
    # Real devices first (selection reads rows [0, device_cnt)). Dummy slots
    # point at pad bodies when available; otherwise they duplicate the first
    # real device — a redundant scenario row that selection masks out.
    if n_pad > 0:
        dummy_targets = [scene.n + (i % n_pad) for i in range(d_pad)]
    else:
        # device_cnt > 0 here: the zero-device case forces d_pad = 0 above
        dummy_targets = [int(scene.device_idx[0])] * d_pad
    device_idx = np.concatenate(
        [scene.device_idx, np.asarray(dummy_targets, dtype=np.int64)])
    return dataclasses.replace(
        scene, n=n_target, q=q, v=v, m=m, types=types, device_idx=device_idx)
