"""nbody — a GPU gravitational N-body engine in JAX.

A JAX/XLA/Pallas implementation with the capabilities of NTHU IPC
HW5's two-GPU CUDA solver (reference: dasbd72/NTHU_IPC_Nbody-Simulation,
`hw5.cu` + `samples/nbody.cc`): softened direct-summation gravity under
semi-implicit Euler, answering the three scenario questions (min
planet-asteroid distance with devices off, first planet-hit step with devices
on, cheapest missile-destroyable device that saves the planet).

Design (see SURVEY.md for the reference map):
  - the whole 200001-step loop runs on-device under `lax.scan` with carries
    for min-distance / hit-step / missile-arrival snapshots
    (replaces hw5.cu:368-403's kernel-launch loop + n_sync_steps readbacks)
  - Problem 1+2 run as a stacked batch of 2 scenarios; Problem 3 as a masked
    batch over device-destruction scenarios (replaces hw5.cu:438-530's
    host-thread work stealing)
  - deterministic fixed-order force reduction (replaces hw5.cu:211-213's
    fp64 atomicAdd, whose non-determinism made the reference fail 2/12 cases)
  - IEEE fp64 graded path on the GPU; fp32 Pallas (Triton) tiled kernel
    for large-N throughput; shard_map + ppermute ring (NCCL over NVLink)
    for multi-GPU scale-out.
"""

import os

if not os.environ.get("NBODY_NO_X64"):
    # The graded path is fp64 (hw5.cu uses double throughout); enable x64
    # once at package import. The fp32/bf16 fast paths request their dtypes
    # explicitly, so this is safe for them.
    import jax

    jax.config.update("jax_enable_x64", True)

from .config import SimConfig  # noqa: E402
from .io import Scene, read_input, write_output, format_output  # noqa: E402
from .engine import Answers, solve_scene  # noqa: E402
from .simulate import simulate, SimState  # noqa: E402

__all__ = [
    "SimConfig",
    "Scene",
    "read_input",
    "write_output",
    "format_output",
    "Answers",
    "solve_scene",
    "simulate",
    "SimState",
]

__version__ = "0.1.0"
