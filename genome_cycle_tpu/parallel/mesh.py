"""Mesh construction for the two parallel axes of this domain (SURVEY.md §2.11):

- ``replica``: embarrassingly parallel ensemble of independent cell-cycle
  simulations (the analogue of the reference's multi-file shell-job ensemble,
  src/cool.py merging multiple trajectories) — data parallelism.
- ``beads``: spatial decomposition of one nucleus — each device owns a row
  block of beads, computes the O(N·nbr) pairwise/wall forces for its rows
  against the replicated bead table, and row blocks are re-assembled with an
  all-gather each step.  Wall axial reaction and overflow stats reduce with
  psum.  This is the "sequence parallel" analogue for bead count N.

Across hosts the replica axis should span the network between them
(independent work) and the beads axis should stay inside one host, whose
cards share a fast interconnect (NVLink on an H100 node): its per-step
all-gather or halo traffic must not cross the network.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding


def shard_to_mesh(arr, mesh: Mesh, spec):
    """``device_put`` onto a mesh sharding that also works multi-controller.

    Single process: plain ``device_put``.  Multi-process: every process is
    expected to hold the same full host value (replica inputs here are
    deterministic functions of config + seeds), and only the locally
    addressable shards are materialized on this host's devices.
    """
    sharding = NamedSharding(mesh, spec)
    if jax.process_count() == 1:
        return jax.device_put(arr, sharding)
    host = np.asarray(arr)
    return jax.make_array_from_callback(
        host.shape, sharding, lambda idx: host[idx]
    )


def make_mesh(n_replicas: int, n_bead_shards: int, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
    need = n_replicas * n_bead_shards
    if len(devices) < need:
        raise ValueError(
            f"need {need} devices for mesh ({n_replicas} replicas x "
            f"{n_bead_shards} bead shards), have {len(devices)}"
        )
    grid = np.asarray(devices[:need]).reshape(n_replicas, n_bead_shards)
    return Mesh(grid, axis_names=("replica", "beads"))


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids=None,
) -> None:
    """Multi-host entry point: join the distributed JAX runtime.

    Under a cluster manager JAX detects the arguments; for manual
    launches (and the multi-process CPU validation path) pass them
    explicitly.  Idempotent — a second call on an already-initialized
    runtime is a no-op, so drivers can call it unconditionally.
    """
    if getattr(jax.distributed, "is_initialized", lambda: False)():
        return
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            local_device_ids=local_device_ids,
        )
    except RuntimeError as ex:  # already initialized by the launcher
        if "already initialized" not in str(ex):
            raise


def make_hybrid_mesh(
    n_replicas: int, n_bead_shards: int, devices=None
) -> Mesh:
    """Host-aware mesh: replica axis across hosts, beads within a host.

    With one process this is exactly :func:`make_mesh`.  With multiple
    processes the replica axis is laid out so that replicas sharing a host
    are contiguous and the beads axis never crosses a host boundary —
    replicas are independent work (no per-step traffic crosses the network
    between hosts) while the beads axis' per-step halo/all-gather traffic
    stays on the host's own interconnect.
    """
    if jax.process_count() == 1:
        return make_mesh(n_replicas, n_bead_shards, devices)
    if devices is None:
        devices = jax.devices()
    n_hosts = jax.process_count()
    if n_replicas % n_hosts != 0:
        raise ValueError(
            f"replica axis ({n_replicas}) must divide over {n_hosts} hosts "
            "so the beads axis stays inside one host"
        )
    per_host_replicas = n_replicas // n_hosts
    by_proc: dict[int, list] = {}
    for d in devices:
        by_proc.setdefault(d.process_index, []).append(d)
    rows = []
    need = per_host_replicas * n_bead_shards
    for pid in sorted(by_proc):
        local = by_proc[pid]
        if len(local) < need:
            raise ValueError(
                f"process {pid} has {len(local)} devices, needs {need} "
                f"({per_host_replicas} replicas x {n_bead_shards} shards)"
            )
        rows.append(
            np.asarray(local[:need]).reshape(per_host_replicas, n_bead_shards)
        )
    # Host-major replica ordering: each host's devices fill whole replica
    # rows, so no beads-axis edge crosses a process (= host) boundary.
    grid = np.concatenate(rows, axis=0)
    return Mesh(grid, axis_names=("replica", "beads"))
