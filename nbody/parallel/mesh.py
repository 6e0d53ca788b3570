"""Device-mesh helpers.

The reference's "distributed backend" is two host threads with a global
mutex staging everything through host memory (hw5.cu:84, 311-320, 438-530 —
SURVEY.md §2.5). Here it is a `jax.sharding.Mesh` with compiler-scheduled
collectives, which XLA hands to NCCL over NVLink. Every GPU of a host reaches
every other at the same rate, so the mesh shape follows the algorithm (the
scenario batch x the body ring), not the interconnect.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh


def make_mesh(axes: dict, devices=None) -> Mesh:
    """Build a mesh from {axis_name: size}. Sizes must multiply to the
    device count used. `axes` values may include one -1 (inferred)."""
    if devices is None:
        devices = jax.devices()
    names = tuple(axes.keys())
    sizes = list(axes.values())
    n_dev = len(devices)
    if sizes.count(-1) == 1:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = n_dev // known
    total = int(np.prod(sizes))
    if total > n_dev:
        raise ValueError(f"mesh {axes} needs {total} devices, have {n_dev}")
    dev_array = np.asarray(devices[:total]).reshape(sizes)
    return Mesh(dev_array, names)
