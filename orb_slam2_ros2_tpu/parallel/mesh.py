"""Device-mesh utilities for distributed bundle adjustment.

The reference is a single shared-memory process (SURVEY.md §5.8 — "no
distributed backend").  Here multi-device scaling is one axis: landmark
blocks of the global BA are sharded over a 1-D mesh (solvers.pcg_ba);
everything else (tracking, local mapping) is latency-critical single-device
work.  Every card of a host reaches every other at the same rate, so the
mesh follows the algorithm alone.  Across hosts, call
:func:`init_distributed` before :func:`ba_mesh` — the mesh then spans all
hosts' devices and the same psum path crosses the network.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh


def init_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> int:
    """Multi-host bring-up: wire this process into a JAX distributed runtime
    so ``jax.devices()`` spans every host's devices and the BA mesh
    collectives span hosts (SURVEY.md §5.8).

    Arguments default to the standard env vars (``SLAM_COORDINATOR``,
    ``SLAM_NUM_PROCESSES``, ``SLAM_PROCESS_ID``); give all three, since
    nothing tells JAX of the cluster otherwise.  No-op (returns 0) when neither
    arguments nor env vars request multi-process mode — the single-host path
    must not pay any initialization cost.  Returns this process's index.
    """
    coordinator = coordinator or os.environ.get("SLAM_COORDINATOR")
    num_processes = num_processes or _env_int("SLAM_NUM_PROCESSES")
    process_id = process_id if process_id is not None else _env_int("SLAM_PROCESS_ID")
    if coordinator is None and num_processes is None:
        return 0
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
    return jax.process_index()


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v is not None else None


def device_count() -> int:
    return len(jax.devices())


def ba_mesh(n_devices: Optional[int] = None, axis: str = "ba") -> Optional[Mesh]:
    """1-D mesh over the first ``n_devices`` devices; None for a single chip
    (the single-chip path must pay zero collective cost)."""
    devs = jax.devices()
    n = n_devices or len(devs)
    if n <= 1:
        return None
    return Mesh(np.array(devs[:n]), (axis,))


def pad_points_for_mesh(n_points: int, n_devices: int) -> int:
    """Landmark-dimension padding so shards divide evenly."""
    per = -(-n_points // n_devices)
    return per * n_devices
