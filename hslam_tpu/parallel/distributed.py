"""Multi-process runtime initialization.

The reference scales with threads inside one process (IndexThreadReduce,
Src/Mapping.cpp); here the scaling unit is processes × devices per process
under `jax.distributed`. This module is the one place that knows how to
bring that runtime up:

  * `initialize()` — wraps jax.distributed.initialize with an explicit
    coordinator address, process count and rank (nothing in a plain GPU
    host or a CPU cluster tells JAX these by itself).
  * `global_mesh(axis)` — one named axis over every global device, the
    shape the point-sharded BA (parallel/dist_ba.py) and the edge-sharded
    pose graph (parallel/dist_pose_graph.py) consume. Devices are ordered
    process-local first, so each process's points stay on its own devices
    and only the psum'd camera system (a few hundred KB) crosses between
    processes.

Single-process use never needs this module — every sharded entry point
takes an explicit Mesh.
"""
from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Bring up the multi-process runtime. No-op if already initialized or
    if running single-process with no coordinator configured
    (`coordinator_address` falls back to $JAX_COORDINATOR_ADDRESS)."""
    if getattr(jax.distributed, "is_initialized", lambda: False)():
        return
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if coordinator_address is None and num_processes is None:
        return  # single-process run: nothing to initialize
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


def global_mesh(axis: str = "points", n_devices: int | None = None) -> Mesh:
    """One named axis over the global device set, process-local shards
    first (jax.devices() already orders devices by process)."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))
