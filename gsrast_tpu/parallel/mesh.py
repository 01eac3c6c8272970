"""Device mesh construction and process bootstrap.

The reference is single-process/single-GPU (SURVEY.md §2.5 "Ground truth: the
reference has none"); this module introduces the mesh the framework shards
over. Axes:
  * "data"  — camera/image batch (training DP; grads psum over it)
  * "tiles" — image-space tile sharding (the renderer's SP analog: the
    "sequence" being split is the sorted tile|depth intersection list)

Primitive (Gaussian) sharding composes on top in parallel/sharded.py.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
TILE_AXIS = "tiles"


def make_mesh(
    shape: Optional[Tuple[int, int]] = None,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Mesh over (data, tiles). Default: all devices on the tile axis (the
    latency-relevant axis for a single-image render)."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if shape is None:
        shape = (1, n)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    arr = np.asarray(devices).reshape(shape)
    return Mesh(arr, (DATA_AXIS, TILE_AXIS))


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Multi-host bootstrap (jax.distributed). No-op when single-process.

    The reference's closest analog is GLFW window-count init/teardown
    (Window.cpp:19-31,72-87) — there is no distributed bootstrap to mirror,
    so this follows the standard JAX pod-slice recipe.
    """
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def tile_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(TILE_AXIS))
