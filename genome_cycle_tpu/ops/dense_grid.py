"""Dense cell-slab pair engine: the gather-free formulation of the hot loop.

The gather-based fold in :mod:`neighbor` is the readable reference
implementation.  This module reformulates the O(N*nbr) pair computation with
*zero gathers in the pair loop*; it is an explicit opt-in for comparison
(the sorted-block engine of :mod:`block_pairs` is the shipping path):

1. beads are scattered once per step into a dense per-cell slab layout
   ``(nx, ny, nz, M)`` (M = per-cell capacity) — one N-sized scatter;
2. the 27 neighbor-cell accesses become *static shifted slices* of the padded
   slab (free under XLA);
3. pair interactions are dense (M, jb) blocks per cell pair, computed
   elementwise over per-coordinate planes (dx, r2, the force coefficient
   and the ``sum_j c_ij (x_i - x_j)`` reduction) — no matrix product;
4. results scatter back to bead order through the slab's bead-id map.

Correctness contract matches :func:`neighbor.pairwise_forces_cell`: beads
outside the grid clamp to boundary cells (true coordinates still used),
capacity overflow is counted, never silently dropped.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

_FAR = 1e15  # padding coordinate: far away from everything real


@dataclasses.dataclass(frozen=True)
class DenseGrid:
    """Static dense-slab geometry (jit cache key)."""

    lower: tuple[float, float, float]
    cell_size: float
    dims: tuple[int, int, int]
    capacity: int

    @classmethod
    def cubic(cls, bound: float, cell_size: float, capacity: int) -> "DenseGrid":
        n = max(int(np.ceil(2.0 * bound / cell_size)), 1)
        return cls(
            lower=(-bound, -bound, -bound),
            cell_size=float(cell_size),
            dims=(n, n, n),
            capacity=int(capacity),
        )

    @property
    def num_cells(self) -> int:
        nx, ny, nz = self.dims
        return nx * ny * nz


class Slabs(NamedTuple):
    pos: jnp.ndarray       # (nx, ny, nz, M, 3) f32, FAR where empty
    ids: jnp.ndarray       # (nx, ny, nz, M) int32, -1 where empty
    extra: tuple           # per-bead scalar channels in slab layout (nx,ny,nz,M)
    overflow: jnp.ndarray  # () int32
    max_fill: jnp.ndarray  # () int32


def build_slabs(grid: DenseGrid, positions, extras=()) -> Slabs:
    """Scatter beads (and optional per-bead scalar channels) into slabs."""
    n = positions.shape[0]
    m = grid.capacity
    lower = jnp.asarray(grid.lower, positions.dtype)
    dims = jnp.asarray(grid.dims, jnp.int32)
    nx, ny, nz = grid.dims

    coords = jnp.floor((positions - lower) / grid.cell_size).astype(jnp.int32)
    coords = jnp.clip(coords, 0, dims - 1)
    cid = (coords[:, 0] * ny + coords[:, 1]) * nz + coords[:, 2]

    order = jnp.argsort(cid)
    sorted_cid = cid[order]
    first_of_run = jnp.searchsorted(sorted_cid, sorted_cid, side="left")
    rank = jnp.arange(n, dtype=jnp.int32) - first_of_run.astype(jnp.int32)

    max_fill = (jnp.max(rank, initial=-1) + 1).astype(jnp.int32)
    fits = rank < m
    overflow = jnp.sum(~fits).astype(jnp.int32)
    slot = jnp.where(fits, sorted_cid * m + rank, grid.num_cells * m)

    pos_flat = jnp.full((grid.num_cells * m, 3), _FAR, positions.dtype)
    pos_flat = pos_flat.at[slot].set(
        positions[order], mode="drop", unique_indices=True
    )
    ids_flat = jnp.full((grid.num_cells * m,), -1, jnp.int32)
    ids_flat = ids_flat.at[slot].set(
        order.astype(jnp.int32), mode="drop", unique_indices=True
    )
    extra_slabs = []
    for channel in extras:
        ch_flat = jnp.zeros((grid.num_cells * m,), positions.dtype)
        ch_flat = ch_flat.at[slot].set(
            channel[order], mode="drop", unique_indices=True
        )
        extra_slabs.append(ch_flat.reshape(nx, ny, nz, m))

    return Slabs(
        pos=pos_flat.reshape(nx, ny, nz, m, 3),
        ids=ids_flat.reshape(nx, ny, nz, m),
        extra=tuple(extra_slabs),
        overflow=overflow,
        max_fill=max_fill,
    )


def scatter_from_slab(slab_values, slab_ids, n: int):
    """Slab layout -> per-bead array: inverse of build_slabs' scatter."""
    flat_ids = slab_ids.reshape(-1)
    flat_vals = slab_values.reshape(flat_ids.shape[0], -1)
    out = jnp.zeros((n, flat_vals.shape[1]), flat_vals.dtype)
    safe = jnp.where(flat_ids >= 0, flat_ids, n)
    return out.at[safe].set(flat_vals, mode="drop", unique_indices=True)


_OFFSETS = [
    (dx, dy, dz)
    for dx in (-1, 0, 1)
    for dy in (-1, 0, 1)
    for dz in (-1, 0, 1)
]


def _shifted(padded, off, dims, extra_dims):
    nx, ny, nz = dims
    dx, dy, dz = off
    idx = (
        slice(1 + dx, 1 + dx + nx),
        slice(1 + dy, 1 + dy + ny),
        slice(1 + dz, 1 + dz + nz),
    )
    return padded[idx + (Ellipsis,)] if extra_dims else padded[idx]


def pair_forces_slab(grid: DenseGrid, slabs: Slabs, coeff_fn, energy_fn=None,
                     jb: int | None = None):
    """Pairwise forces over the dense slabs.

    ``coeff_fn(r2, ea_i, eb_i, ea_j, eb_j) -> c`` with F = c * (x_i - x_j),
    where ``ea``/``eb`` are the two extra channels (a/b factors).  Shapes are
    broadcast blocks (..., M, jb).  Returns (force_slab (...,M,3), energy).

    All pair math is elementwise over per-coordinate planes — dense blocks
    with no gathers and no contraction.  The j axis is processed in
    ``jb``-wide blocks so live temporaries stay at (cells, M, jb) regardless
    of capacity: at M = 256 the unblocked (cells, M, M) dx/r2/c temporaries
    total ~10 GB at a 100k nucleus.
    """
    m = grid.capacity
    if jb is None:
        jb = m if m <= 64 else 64
    valid = slabs.ids >= 0
    ea, eb = slabs.extra
    dtype = slabs.pos.dtype

    # Per-coordinate planes (..., M); FAR marks empty slots.
    planes = [slabs.pos[..., k] for k in range(3)]

    pad4 = ((1, 1), (1, 1), (1, 1), (0, 0))
    planes_p = [jnp.pad(p, pad4, constant_values=_FAR) for p in planes]
    ea_p = jnp.pad(ea, pad4, constant_values=0.0)
    eb_p = jnp.pad(eb, pad4, constant_values=0.0)
    valid_p = jnp.pad(valid, pad4, constant_values=False)

    forces = [jnp.zeros_like(p) for p in planes]
    energy = jnp.asarray(0.0, dtype)
    eye = jnp.eye(m, dtype=bool)

    for off in _OFFSETS:
        nbr_planes_f = [
            _shifted(pp, off, grid.dims, False) for pp in planes_p
        ]
        nbr_valid_f = _shifted(valid_p, off, grid.dims, False)
        nbr_ea_f = _shifted(ea_p, off, grid.dims, False)
        nbr_eb_f = _shifted(eb_p, off, grid.dims, False)

        for j0 in range(0, m, jb):
            js = slice(j0, j0 + jb)
            nbr_planes = [q[..., js] for q in nbr_planes_f]
            nbr_valid = nbr_valid_f[..., js]
            nbr_ea = nbr_ea_f[..., js]
            nbr_eb = nbr_eb_f[..., js]

            # dx_k = x_i - x_j per coordinate: (..., M, jb) blocks.
            dxs = [
                p[..., :, None] - q[..., None, :]
                for p, q in zip(planes, nbr_planes)
            ]
            r2 = dxs[0] * dxs[0] + dxs[1] * dxs[1] + dxs[2] * dxs[2]
            # FAR-FAR differences cancel to 0: mask empty-empty pairs via
            # validity; empty-real pairs have huge r2 already.
            if off == (0, 0, 0):
                r2 = jnp.where(eye[:, js], _FAR, r2)

            c = coeff_fn(
                r2,
                ea[..., :, None], eb[..., :, None],
                nbr_ea[..., None, :], nbr_eb[..., None, :],
            )
            c = jnp.where(nbr_valid[..., None, :], c, 0.0)

            for k in range(3):
                forces[k] = forces[k] + jnp.sum(c * dxs[k], axis=-1)

            if energy_fn is not None:
                u = energy_fn(
                    r2,
                    ea[..., :, None], eb[..., :, None],
                    nbr_ea[..., None, :], nbr_eb[..., None, :],
                )
                u = jnp.where(nbr_valid[..., None, :], u, 0.0)
                u = jnp.where(valid[..., :, None], u, 0.0)
                energy = energy + 0.5 * jnp.sum(u)

    force = jnp.stack(forces, axis=-1)
    force = jnp.where(valid[..., None], force, 0.0)
    return force, energy
