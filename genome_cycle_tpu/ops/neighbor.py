"""Neighbor engine: fixed-capacity cell list + masked candidate folds.

JAX replacement for micromd's neighbor-pairwise forcefields and
``md::neighbor_searcher`` (SURVEY.md §2.9): all shapes are static, the cell
table is rebuilt by scatter (no host round-trips), and pair iteration is a
dense fold over the 27 adjacent cells with validity masks — XLA fuses the
gather + pair math + accumulation.  This gather fold is the readable
reference (the test oracle); :mod:`block_pairs` implements the same contract
for the hot path.

Out-of-bounds beads are *clamped* to boundary cells: their true coordinates
still enter the distance computation, so results stay correct as long as the
grid covers the confinement region; only boundary-cell occupancy grows.
Capacity overflow is counted and reported, never silently dropped.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class CellGrid:
    """Static cell-grid geometry (part of the jit cache key)."""

    lower: tuple[float, float, float]
    cell_size: float
    dims: tuple[int, int, int]
    capacity: int

    @property
    def num_cells(self) -> int:
        nx, ny, nz = self.dims
        return nx * ny * nz

    @classmethod
    def cubic(cls, bound: float, cell_size: float, capacity: int) -> "CellGrid":
        """Grid covering [-bound, bound]^3."""
        n = max(int(np.ceil(2.0 * bound / cell_size)), 1)
        return cls(
            lower=(-bound, -bound, -bound),
            cell_size=float(cell_size),
            dims=(n, n, n),
            capacity=int(capacity),
        )


def cell_coords(grid: CellGrid, positions):
    """(N, 3) int32 cell coordinates, clamped into the grid."""
    lower = jnp.asarray(grid.lower, positions.dtype)
    dims = jnp.asarray(grid.dims, jnp.int32)
    coords = jnp.floor((positions - lower) / grid.cell_size).astype(jnp.int32)
    return jnp.clip(coords, 0, dims - 1)


def _cell_ids(grid: CellGrid, coords):
    nx, ny, nz = grid.dims
    return (coords[:, 0] * ny + coords[:, 1]) * nz + coords[:, 2]


def build_cell_table(grid: CellGrid, positions, valid=None):
    """Scatter beads into a (num_cells, capacity) table of bead indices.

    Returns ``(table, overflow, max_fill)``: ``table`` holds bead ids
    (-1 = empty), ``overflow`` counts beads that did not fit their cell's
    capacity, and ``max_fill`` is the densest cell's occupancy — the driver
    uses both to adapt capacity between chunks (grow on overflow, shrink when
    over-provisioned).  Rank-within-cell comes from one sort by cell id
    (deterministic layout).  ``valid`` optionally masks rows out of the
    table entirely (empty slots of a fixed-capacity bead buffer).
    """
    n = positions.shape[0]
    coords = cell_coords(grid, positions)
    cid = _cell_ids(grid, coords)
    if valid is not None:
        # Invalid rows sort to a virtual cell past the grid and are dropped.
        cid = jnp.where(valid, cid, grid.num_cells)

    order = jnp.argsort(cid)
    sorted_cid = cid[order]
    # rank of each sorted entry within its run of equal cell ids
    first_of_run = jnp.searchsorted(sorted_cid, sorted_cid, side="left")
    rank = jnp.arange(n, dtype=jnp.int32) - first_of_run.astype(jnp.int32)

    in_grid = sorted_cid < grid.num_cells  # False only for masked rows
    max_fill = (jnp.max(jnp.where(in_grid, rank, -1), initial=-1) + 1).astype(
        jnp.int32
    )
    fits = (rank < grid.capacity) & in_grid
    overflow = jnp.sum(~fits & in_grid).astype(jnp.int32)
    flat_index = jnp.where(
        fits,
        sorted_cid * grid.capacity + rank,
        grid.num_cells * grid.capacity,  # out of bounds -> dropped
    )
    table = jnp.full(grid.num_cells * grid.capacity, -1, dtype=jnp.int32)
    table = table.at[flat_index].set(
        order.astype(jnp.int32), mode="drop", unique_indices=True
    )
    return table.reshape(grid.num_cells, grid.capacity), overflow, max_fill


_OFFSETS = np.stack(
    np.meshgrid(*([np.arange(-1, 2)] * 3), indexing="ij"), axis=-1
).reshape(27, 3)


def neighbor_fold(grid: CellGrid, table, positions, kernel, init, query=None):
    """Fold ``kernel`` over all candidate neighbor pairs.

    ``kernel(carry, j_ids, dxs, r2, valid) -> carry`` is called 27 times (one
    per adjacent-cell offset) with:

    - ``j_ids``  (Q, capacity) int32 candidate bead indices
    - ``dxs``    3-tuple of (Q, capacity) planes: query[i] - positions[j]
                 per coordinate
    - ``r2``     (Q, capacity)     squared distances
    - ``valid``  (Q, capacity) bool: real entry, j != i, neighbor cell in grid

    Coordinates travel as separate (Q, capacity) planes rather than a
    (Q, capacity, 3) array: a 3-wide minor dimension can be padded by the
    compiler's layout to a full tile, multiplying the size of materialized
    gathers many-fold.

    ``query``: optional ``(q_pos (Q,3), q_ids (Q,))`` restricting the i side
    to a subset of beads — the hook spatially-sharded devices use to compute
    forces only for their owned row block while reading the full bead table.
    Defaults to all beads.

    Every unordered pair appears twice (once per side), so symmetric energies
    must be halved by the kernel; per-i force accumulation needs no scatter.
    """
    if query is None:
        q_pos = positions
        q_ids = jnp.arange(positions.shape[0], dtype=jnp.int32)
    else:
        q_pos, q_ids = query
    coords = cell_coords(grid, q_pos)
    dims = jnp.asarray(grid.dims, jnp.int32)
    nx, ny, nz = grid.dims
    offsets = jnp.asarray(_OFFSETS, jnp.int32)
    planes = tuple(positions[:, k] for k in range(3))
    q_planes = tuple(q_pos[:, k] for k in range(3))

    def body(k, carry):
        nbr = coords + offsets[k]
        in_grid = jnp.all((nbr >= 0) & (nbr < dims), axis=1)
        ncid = (nbr[:, 0] * ny + nbr[:, 1]) * nz + nbr[:, 2]
        ncid = jnp.clip(ncid, 0, grid.num_cells - 1)
        j_ids = table[ncid]  # (Q, capacity)
        valid = (j_ids >= 0) & in_grid[:, None] & (j_ids != q_ids[:, None])
        safe = jnp.maximum(j_ids, 0)
        dxs = tuple(q[:, None] - p[safe] for q, p in zip(q_planes, planes))
        r2 = dxs[0] * dxs[0] + dxs[1] * dxs[1] + dxs[2] * dxs[2]
        # Force r2 of invalid lanes far outside any cutoff.
        r2 = jnp.where(valid, r2, jnp.asarray(1e30, positions.dtype))
        return kernel(carry, j_ids, dxs, r2, valid)

    return jax.lax.fori_loop(0, 27, body, init)


def pairwise_forces_cell(grid, table, positions, coeff_fn, energy_fn=None,
                         query=None):
    """Neighbor-pairwise force (and optional energy) over the cell list.

    ``coeff_fn(r2, i_ids, j_ids) -> (Q, cap)`` force coefficient (F = c * dx);
    ``energy_fn`` same signature for u(r2).  Mirrors
    ``md::make_neighbor_pairwise_forcefield`` with a per-pair functor.
    With ``query=(q_pos, q_ids)`` only the given row block is computed
    (returns (Q, 3) forces and that block's half-energy share).
    """
    if query is None:
        q_pos = positions
        q_ids = jnp.arange(positions.shape[0], dtype=jnp.int32)
    else:
        q_pos, q_ids = query
    zero_f = tuple(jnp.zeros(q_pos.shape[0], positions.dtype) for _ in range(3))
    zero_e = jnp.asarray(0.0, positions.dtype)

    def kernel(carry, j_ids, dxs, r2, valid):
        forces, energy = carry
        c = jnp.where(valid, coeff_fn(r2, q_ids[:, None], j_ids), 0.0)
        forces = tuple(
            f + jnp.sum(c * d, axis=1) for f, d in zip(forces, dxs)
        )
        if energy_fn is not None:
            u = jnp.where(valid, energy_fn(r2, q_ids[:, None], j_ids), 0.0)
            energy = energy + 0.5 * jnp.sum(u)
        return forces, energy

    forces, energy = neighbor_fold(
        grid, table, positions, kernel, (zero_f, zero_e), query=(q_pos, q_ids)
    )
    return jnp.stack(forces, axis=-1), energy


def pairwise_forces_dense(positions, coeff_fn, energy_fn=None, targets=None):
    """O(N^2) masked pairwise forces for small systems (mitotic stages,
    a few hundred coarse beads) and for brute-force equivalence tests.

    ``coeff_fn(r2, i, j)`` as in :func:`pairwise_forces_cell`.  ``targets``
    optionally restricts interactions to a subset of particle indices
    (micromd ``set_neighbor_targets``, used by the nucleolar droplet force).
    """
    n = positions.shape[0]
    if targets is not None:
        pos = positions[targets]
        ids = jnp.asarray(targets, jnp.int32)
    else:
        pos = positions
        ids = jnp.arange(n, dtype=jnp.int32)
    m = pos.shape[0]
    # Per-coordinate (m, m) planes: a 3-minor pair array can pad to a full
    # layout tile (many-fold memory blowup at large m).
    dxs = tuple(pos[:, None, k] - pos[None, :, k] for k in range(3))
    r2 = dxs[0] * dxs[0] + dxs[1] * dxs[1] + dxs[2] * dxs[2]
    valid = ~jnp.eye(m, dtype=bool)
    r2 = jnp.where(valid, r2, jnp.asarray(1e30, positions.dtype))
    c = jnp.where(valid, coeff_fn(r2, ids[:, None], ids[None, :]), 0.0)
    f = jnp.stack([jnp.sum(c * d, axis=1) for d in dxs], axis=-1)
    if targets is not None:
        forces = jnp.zeros_like(positions).at[ids].add(f)
    else:
        forces = f
    energy = jnp.asarray(0.0, positions.dtype)
    if energy_fn is not None:
        u = jnp.where(valid, energy_fn(r2, ids[:, None], ids[None, :]), 0.0)
        energy = 0.5 * jnp.sum(u)
    return forces, energy
