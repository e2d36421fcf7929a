"""Device-mesh runtime.

The reference is single-host, single-process (SURVEY.md §2.3): its only
parallelism is OpenMP threads.  This module is the framework's NCCL/MPI
equivalent, built on jax.sharding: a named mesh over the devices of one
host or several, with the axes the SfM pipeline shards over:

- ``pairs``  — view pairs for matching (DP over the O(N^2) pair list)
- ``obs``    — observation blocks for distributed bundle adjustment
- ``views``  — reference views for dense depth-map clusters

On a single chip (or under tests) the mesh is 1-wide and everything
degenerates to the local path.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: F401  (re-exported: callers import the trio from here)


def make_mesh(n_devices: int | None = None, axis: str = "shard") -> Mesh:
    """1-D mesh over the first n_devices (default: all)."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def initialize_distributed(coordinator: str | None = None, num_processes: int | None = None,
                           process_id: int | None = None) -> None:
    """Multi-host init (jax.distributed).  No-op when single-process or when
    the runtime was already initialized (idempotent for service restarts)."""
    if num_processes is None or num_processes <= 1:
        return
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError:
        pass  # already initialized


def pad_to_multiple(arr: np.ndarray, multiple: int, axis: int = 0, fill=0):
    """Pad axis length up to a multiple (shard-able static shapes)."""
    n = arr.shape[axis]
    m = ((n + multiple - 1) // multiple) * multiple
    if m == n:
        return arr, np.ones(n, bool)
    pad_width = [(0, 0)] * arr.ndim
    pad_width[axis] = (0, m - n)
    out = np.pad(arr, pad_width, constant_values=fill)
    valid = np.arange(m) < n
    return out, valid
