"""Sorted-block range pair engine: density-robust formulation.

The dense cell-slab engine (:mod:`dense_grid`) pays ``cells * 27 * M**2``
pair lanes with M = the *globally densest* cell's capacity — one hot cell
inflates every cell's block quadratically (measured: the driver bench ran 25k
beads at M=256 for a ~60-bead mean fill, >100x lane waste over true
candidates).  This module reformulates the same computation with lanes
**linear** in the density skew:

1. beads are sorted by flat cell id (one argsort per call — the slab engine
   already paid this);
2. the sorted order is laid out COLUMN-ALIGNED: each (x, y) cell column's
   bead run is padded up to a multiple of the block size ``B``, so every
   block of ``B`` consecutive slots lies within exactly ONE cell column.
   (Round 4 cut blocks straight through the sorted order; a block
   straddling a column boundary needed a candidate window spanning the
   two columns' ENTIRE bead runs, and that global max set the window
   capacity for every block — the banked lane count was ~116x the
   physical neighbourhood.  Column alignment caps every block's cell span
   at ~B/cell_fill cells, for a few percent of padded slots.);
3. for a block spanning cells [c_lo, c_hi] of its column and each of the 9
   stencil columns g = (dx, dy), the candidate partners — all beads in
   cells [c_lo + base_g - 1, c_hi + base_g + 1] (the dz in {-1,0,1} span
   merges into one id interval) — occupy ONE CONTIGUOUS SLICE of the
   column-aligned slot arrays, because cell id -> slot position is
   monotone.  Each block therefore reads 9 dynamic windows, not 27
   capacity-padded cell blocks;
4. j-side channels are fetched as whole 128-lane rows (slice starts snapped
   down to a row boundary): contiguous row gathers instead of one gather
   per element;
5. pair math runs on dense (B, Wq) tiles per block and column — elementwise
   float32, no matrix product — then reduces over the window axis and
   scatters back through the sort permutation.

Total lanes = slots * 9 * Wq with slots = N + per-column padding.  Density
skew widens the window *linearly* (a hot cell stretches only the slices
containing it), the empty-cube overhead of the slab layout disappears
(empty columns occupy no slots), and the largest temporary is a
(slots/B, B, Wq) tile block — no multi-GB resident set at 100k beads.

Stencil-column intervals of one block can overlap when the grid is tiny
(windows clipped across column edges); overlapping cells would
double-count pairs.  The columns are processed in ascending static base
order and each interval's end is clipped to the next interval's start —
the union is unchanged, so every candidate cell is covered exactly once
(`test_block_pairs.py` covers degenerate grids).

Slot-capacity overflow (the padded layout outgrowing the static ``slots``
buffer) is flagged with :data:`SLOT_OVERFLOW` in the overflow channel —
beads beyond capacity would be silently absent from every window, so the
driver must grow the slot buffer and retry, exactly like width overflow.

Correctness contract matches :func:`neighbor.pairwise_forces_cell`: beads
outside the grid clamp to boundary cells (true coordinates still used),
window-width overflow is counted and surfaced, never silently dropped.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

_FAR = 1e15
# Both sizes were chosen before the move to the H100 and are not yet
# measured there.
_ROW = 128   # j-side gather granularity (one row of lanes)
_SUB = 2048  # max pair-block lane width per fused compute chunk: the
             # (n_blocks, B, Wq) elementwise temporaries scale with the
             # window width, and the relaxation structure's density skew
             # can push W past 7000 (probed on the 60k-bead hg38 spline
             # structure) — unchunked that is multiple GB per live
             # temporary.

# Overflow-channel flag: the column-padded layout needs more slots than the
# grid's static capacity — some beads were dropped from the layout entirely.
# Kept separate from the width count (low bits) so drivers grow the right
# knob.
SLOT_OVERFLOW = 1 << 28
_WIDTH_OV_MAX = (1 << 27) - 1


@dataclasses.dataclass(frozen=True)
class BlockGrid:
    """Static geometry + engine shape (jit cache key).

    ``width`` is the per-column candidate-window capacity W; the engine
    reports the widest window actually needed so drivers can retry a grown
    width exactly like cell-capacity overflow.  ``slots`` is the static
    capacity of the column-aligned padded layout (0 = auto: the worst case
    ``n + min(columns, n) * (block - 1)`` — always sufficient, but drivers
    that know the structure should pass a tight probed value, since every
    slot costs ``9 * Wq`` candidate lanes).
    """

    lower: tuple[float, float, float]
    cell_size: float
    dims: tuple[int, int, int]
    width: int
    block: int = 32
    slots: int = 0

    @classmethod
    def cubic(cls, bound: float, cell_size: float, width: int,
              block: int = 32, slots: int = 0) -> "BlockGrid":
        n = max(int(np.ceil(2.0 * bound / cell_size)), 1)
        return cls(
            lower=(-bound, -bound, -bound),
            cell_size=float(cell_size),
            dims=(n, n, n),
            width=int(width),
            block=int(block),
            slots=int(slots),
        )

    @property
    def num_cells(self) -> int:
        nx, ny, nz = self.dims
        return nx * ny * nz

    @property
    def num_columns(self) -> int:
        nx, ny, _ = self.dims
        return nx * ny

    @property
    def column_bases(self) -> tuple[int, ...]:
        """The 9 (dx, dy) stencil-column id offsets, ascending (static)."""
        _, ny, nz = self.dims
        return tuple(
            sorted((dx * ny + dy) * nz for dx in (-1, 0, 1) for dy in (-1, 0, 1))
        )


class BlockStructure(NamedTuple):
    """Column-aligned slot layout + per-block candidate windows (one build
    per call; the force and contact consumers share it when evaluated at
    the same positions)."""

    order: jnp.ndarray        # (slots,) slot -> original bead id (-1 = pad)
    islot: jnp.ndarray        # (n,) sorted position -> slot (slots = dropped)
    sort: jnp.ndarray         # (n,) sorted position -> original bead id
    planes_r: tuple           # 3x (n_rows, 128) slot coordinate rows
    extras_r: tuple           # per-channel (n_rows, 128) slot rows
    j_lo: jnp.ndarray         # (9, n_blocks) window starts (slot space)
    j_hi: jnp.ndarray         # (9, n_blocks) window ends, exclusive
    overflow: jnp.ndarray     # () int32 width overflow + SLOT_OVERFLOW flag
    max_width: jnp.ndarray    # () int32 widest window needed (watermark)
    slot_need: jnp.ndarray    # () int32 slots the layout actually needs


def _shape(grid: BlockGrid, n: int):
    b = grid.block
    unit = b * _ROW // math.gcd(b, _ROW)
    if grid.slots > 0:
        n_slots = -(-grid.slots // unit) * unit
    else:
        # Worst case: every nonempty column pads by b - 1 (always enough).
        pad = min(grid.num_columns, n) * (b - 1)
        n_slots = -(-(n + pad) // unit) * unit
    n_blocks = n_slots // b
    n_rows = n_slots // _ROW
    wq = (-(-grid.width // _ROW) + 1) * _ROW  # whole rows covering W + snap
    return b, n_blocks, n_slots, n_rows, wq


def build_structure(grid: BlockGrid, positions, extras=(),
                    valid=None) -> BlockStructure:
    """Sort beads by cell id into the column-aligned layout and derive each
    block's 9 candidate windows.

    ``valid`` optionally masks rows out entirely (empty slots of a
    fixed-capacity bead buffer, e.g. the halo engine's slab layout): masked
    rows sort past every real cell, occupy no slots, and never enter any
    window (without the mask, hundreds of FAR-padded slots clump into the
    corner cell and inflate every window watermark that touches it).
    """
    n = positions.shape[0]
    b, n_blocks, n_slots, n_rows, _ = _shape(grid, n)
    dtype = positions.dtype
    ncols = grid.num_columns
    nz = grid.dims[2]

    lower = jnp.asarray(grid.lower, dtype)
    dims = jnp.asarray(grid.dims, jnp.int32)
    coords = jnp.floor((positions - lower) / grid.cell_size).astype(jnp.int32)
    coords = jnp.clip(coords, 0, dims - 1)
    _, ny, _ = grid.dims
    cid = (coords[:, 0] * ny + coords[:, 1]) * nz + coords[:, 2]
    if valid is not None:
        cid = jnp.where(valid, cid, grid.num_cells)

    # One variadic sort carries every value channel with the key, instead
    # of one element gather per channel through the permutation.
    chans = tuple(positions[:, k] for k in range(3)) + tuple(extras)
    sorted_ops = jax.lax.sort(
        (cid,) + chans + (jnp.arange(n, dtype=jnp.int32),), num_keys=1
    )
    cid_s = sorted_ops[0]
    chans_s = sorted_ops[1:-1]
    order = sorted_ops[-1]
    live_sorted = (cid_s < grid.num_cells) if valid is not None else None

    # cell id -> sorted bead range (monotone).  Invalid beads carry the
    # sentinel cell id, so starts[num_cells] already excludes them.
    cell_ids = jnp.arange(grid.num_cells + 1, dtype=cid_s.dtype)
    starts = jnp.searchsorted(cid_s, cell_ids, side="left").astype(jnp.int32)

    # Column-aligned padding: each (x, y) column's run rounds up to a
    # multiple of the block size, so no block straddles a column.
    col_start = starts[jnp.arange(ncols + 1, dtype=jnp.int32) * nz]
    counts = col_start[1:] - col_start[:-1]                       # (ncols,)
    padded = (-(-counts // b) * b).astype(jnp.int32)
    pad_off = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(padded, dtype=jnp.int32)]
    )                                                             # (ncols+1,)
    slot_need = pad_off[-1]

    # sorted position -> slot, WITHOUT per-slot binary searches or table
    # gathers (both profiled as the build's hot spots): each column's slot
    # offset (pad_off - col_start, monotone in the column id) is scattered
    # at the column's first sorted position, and a running maximum forward-
    # fills it across that column's beads.
    colpad = pad_off[:-1] - col_start[:-1]                        # (ncols,)
    offset_marks = (
        jnp.zeros((n + 1,), jnp.int32)
        .at[jnp.clip(col_start[:-1], 0, n)]
        .max(colpad, mode="drop")
    )
    offset_sorted = jax.lax.cummax(offset_marks)[:n]
    iota = jnp.arange(n, dtype=jnp.int32)
    islot = iota + offset_sorted
    if live_sorted is not None:
        # Invalid beads (all sorted last) park in the scratch region past
        # the slot buffer: distinct targets, never read back.
        n_valid = starts[-1]
        islot = jnp.where(live_sorted, islot, n_slots + (iota - n_valid))
    # Slot-overflow / scratch clamp: targets stay inside the scratch tail.
    islot = jnp.minimum(islot, n_slots + n - 1)

    # Slot value arrays: ONE row scatter of all channels (pads keep the
    # initial fill: FAR coordinates, zero extras).
    n_chan = len(chans_s)
    fill_row = jnp.asarray([_FAR] * 3 + [0.0] * (n_chan - 3), dtype)
    slot_vals = jnp.broadcast_to(
        fill_row, (n_slots + n, n_chan)
    ).at[islot].set(
        jnp.stack(chans_s, axis=1), unique_indices=True, mode="drop"
    )
    planes_r = tuple(
        slot_vals[:n_slots, k].reshape(n_rows, _ROW) for k in range(3)
    )
    extras_r = tuple(
        slot_vals[:n_slots, 3 + k].reshape(n_rows, _ROW)
        for k in range(n_chan - 3)
    )

    order_slots = (
        jnp.full((n_slots + n,), -1, jnp.int32)
        .at[islot]
        .set(order, unique_indices=True, mode="drop")
    )[:n_slots]

    # Slot-space cell ids: scatter cid+1 then forward-fill, so pads report
    # their column's LAST real cid (cummax; cids are monotone over slots).
    cid_slot = jax.lax.cummax(
        jnp.zeros((n_slots + n,), jnp.int32)
        .at[islot]
        .set(cid_s + 1, unique_indices=True, mode="drop")
    )[:n_slots] - 1

    # cell id -> slot position (monotone: within a column pads live past the
    # last real cell; across columns pad_off jumps past them).  The per-cell
    # column id is arange//nz, so the table lookups collapse into a
    # broadcast-reshape — no gathers.
    ss_main = (
        starts[:-1].reshape(ncols, nz) + colpad[:, None]
    ).reshape(-1)
    starts_slots = jnp.minimum(
        jnp.concatenate([ss_main, slot_need[None]]), n_slots
    )

    # Per-block cell ranges from the forward-filled slot cids (strided
    # slices, no gathers).  Every live block's first slot is real (padded
    # runs are whole multiples of b, so a block past the real run cannot
    # exist inside a column).
    blk = jnp.arange(n_blocks, dtype=jnp.int32)
    cid_blocks = cid_slot.reshape(n_blocks, b)
    c_lo = jnp.maximum(cid_blocks[:, 0], 0)
    c_hi = jnp.maximum(cid_blocks[:, b - 1], 0)
    dead = blk * b >= jnp.minimum(slot_need, n_slots)

    bases = grid.column_bases
    j_lo_list, j_hi_list = [], []
    for base in bases:
        lo_cell = jnp.clip(c_lo + base - 1, 0, grid.num_cells)
        hi_cell = jnp.clip(c_hi + base + 2, 0, grid.num_cells)  # exclusive
        j_lo = starts_slots[lo_cell]
        j_hi = starts_slots[hi_cell]
        j_lo_list.append(j_lo)
        j_hi_list.append(jnp.where(dead, j_lo, j_hi))
    for g in range(len(bases) - 1):
        # Ascending disjoint intervals: drop any overlap into the next column
        # (cell coverage of the union is unchanged).
        j_hi_list[g] = jnp.minimum(j_hi_list[g], j_lo_list[g + 1])

    widths = [jnp.maximum(hi - lo, 0) for lo, hi in zip(j_lo_list, j_hi_list)]
    max_width = jnp.maximum(
        jnp.max(jnp.stack([jnp.max(wd) for wd in widths])), 0
    ).astype(jnp.int32)
    overflow = sum(
        jnp.sum(jnp.maximum(wd - grid.width, 0)) for wd in widths
    ).astype(jnp.int32)
    overflow = jnp.minimum(overflow, _WIDTH_OV_MAX) + jnp.where(
        slot_need > n_slots, jnp.int32(SLOT_OVERFLOW), jnp.int32(0)
    )

    return BlockStructure(
        order=order_slots,
        islot=islot,
        sort=order.astype(jnp.int32),
        planes_r=planes_r,
        extras_r=extras_r,
        j_lo=jnp.stack(j_lo_list),
        j_hi=jnp.stack(j_hi_list),
        overflow=overflow,
        max_width=max_width,
        slot_need=slot_need,
    )


def _window(grid: BlockGrid, struct: BlockStructure, g: int, n: int):
    """Column g's row-quantized j-side window.

    Returns (j_planes 3x(n_blocks, Wq), j_extras, sj (n_blocks, Wq) sorted
    lane ids, valid (n_blocks, Wq)).
    """
    b, n_blocks, n_pad, n_rows, wq = _shape(grid, n)
    k_rows = wq // _ROW
    j_lo = struct.j_lo[g]
    j_hi = struct.j_hi[g]
    row0 = j_lo // _ROW
    rows_raw = row0[:, None] + jnp.arange(k_rows, dtype=jnp.int32)[None, :]
    rows = jnp.minimum(rows_raw, n_rows - 1)
    j_planes = tuple(p[rows].reshape(n_blocks, wq) for p in struct.planes_r)
    j_extras = tuple(e[rows].reshape(n_blocks, wq) for e in struct.extras_r)
    # Lane ids from the UNCLAMPED rows: a clamped duplicate row re-reads real
    # beads, and ids past the end make the validity mask reject them (ids
    # from the clamped rows would double-count the final rows).
    sj = (rows_raw[:, :, None] * _ROW
          + jnp.arange(_ROW, dtype=jnp.int32)).reshape(n_blocks, wq)
    valid = (sj >= j_lo[:, None]) & (sj < j_hi[:, None])
    return j_planes, j_extras, sj, valid


def _i_tiles(grid: BlockGrid, struct: BlockStructure, n: int):
    b, n_blocks, n_pad, _, _ = _shape(grid, n)
    si = jnp.arange(n_pad, dtype=jnp.int32).reshape(n_blocks, b)
    i_planes = tuple(
        p.reshape(-1)[:n_pad].reshape(n_blocks, b) for p in struct.planes_r
    )
    i_extras = tuple(
        e.reshape(-1)[:n_pad].reshape(n_blocks, b) for e in struct.extras_r
    )
    return si, i_planes, i_extras


def block_pair_forces(grid: BlockGrid, positions, extras, coeff_fn,
                      energy_fn=None, struct: BlockStructure | None = None):
    """Pairwise forces via sorted-block range windows.

    ``coeff_fn(r2, e_i, e_j) -> c`` with F_i = sum_j c_ij (x_i - x_j);
    ``e_i``/``e_j`` are tuples of the ``extras`` channels broadcast to the
    pair block, mirroring :func:`dense_grid.pair_forces_slab`'s contract.
    ``energy_fn`` same signature for u(r2) (each unordered pair seen twice;
    the half factor is applied here).

    Returns ``(forces (N, 3), energy, overflow, max_width)`` where
    ``overflow`` counts candidate beads beyond the width capacity (any
    nonzero means dropped pairs -> caller must retry with a wider grid) and
    ``max_width`` is the watermark for adaptive sizing.
    """
    n = positions.shape[0]
    b, n_blocks, n_slots, _, wq = _shape(grid, n)
    dtype = positions.dtype
    if struct is None:
        struct = build_structure(grid, positions, extras)

    si, i_planes, i_extras = _i_tiles(grid, struct, n)
    i_real = (struct.order >= 0).reshape(n_blocks, b)
    forces = [jnp.zeros((n_blocks, b), dtype) for _ in range(3)]
    energy = jnp.asarray(0.0, dtype)

    for g in range(len(grid.column_bases)):
        j_planes_f, j_extras_f, sj_f, valid_f = _window(grid, struct, g, n)

        for s0 in range(0, wq, _SUB):
            sl = slice(s0, min(s0 + _SUB, wq))
            j_planes = tuple(p[:, sl] for p in j_planes_f)
            j_extras = tuple(e[:, sl] for e in j_extras_f)
            sj = sj_f[:, sl]
            valid_j = valid_f[:, sl]

            dxs = [
                ip[:, :, None] - jp[:, None, :]
                for ip, jp in zip(i_planes, j_planes)
            ]
            r2 = dxs[0] * dxs[0] + dxs[1] * dxs[1] + dxs[2] * dxs[2]
            # Self-pairs: same slot.
            r2 = jnp.where(si[:, :, None] == sj[:, None, :], _FAR, r2)

            e_i = tuple(ie[:, :, None] for ie in i_extras)
            e_j = tuple(je[:, None, :] for je in j_extras)
            c = coeff_fn(r2, e_i, e_j)
            c = jnp.where(valid_j[:, None, :], c, 0.0)
            for k in range(3):
                forces[k] = forces[k] + jnp.sum(c * dxs[k], axis=-1)

            if energy_fn is not None:
                u = energy_fn(r2, e_i, e_j)
                u = jnp.where(valid_j[:, None, :], u, 0.0)
                u = jnp.where(i_real[:, :, None], u, 0.0)
                energy = energy + 0.5 * jnp.sum(u)

    # Slot forces -> original bead order: gather each sorted bead's slot
    # row, then scatter through the sort permutation (pads never gathered;
    # dropped-on-overflow beads read the zero sentinel row).
    force_rows = jnp.concatenate(
        [
            jnp.stack([f.reshape(n_slots) for f in forces], axis=-1),
            jnp.zeros((1, 3), dtype),
        ]
    )
    out = jnp.zeros((n, 3), dtype)
    out = out.at[struct.sort].set(
        force_rows[struct.islot], unique_indices=True
    )
    return out, energy, struct.overflow, struct.max_width


def block_contact_events(grid: BlockGrid, positions, cutoff,
                         events_capacity: int,
                         struct: BlockStructure | None = None):
    """All pairs within ``cutoff`` as a fixed-capacity event list, scatter-free.

    A tick needs the (i, j) identity of every in-range pair.  A formulation
    that scatters from the full candidate-lane domain issues N*9*Wq
    updates.  This extraction never scatters from that domain:

    1. hit masks are computed per column exactly as the pair force does,
       reduced to per-(row, column, 128-lane tile) counts, and stored as
       bytes (one elementwise pass);
    2. a hierarchical exclusive cumsum (per-row totals, then per-row tile
       prefix) assigns every hit a dense event index;
    3. each event index finds its row by one binary search over the per-row
       offsets, its tile by comparing against the row's (9*K,) tile prefix
       (one 128-byte-granular row gather), and its lane by a cumsum over
       the tile's 128 stored mask bytes (another row gather) — all gathers
       are row-granular.

    Each unordered pair is emitted exactly once (sorted-index ownership
    i < j; no per-row capacity exists to balance).  Returns ``(events
    (E, 3) int32 [i, j, 1] in ORIGINAL bead ids with i = -1 padding,
    n_events, width_overflow, max_width)``; ``n_events > events_capacity``
    means truncation (the driver grows the capacity and reruns).
    """
    n = positions.shape[0]
    b, n_blocks, n_pad, _, wq = _shape(grid, n)
    if struct is None:
        struct = build_structure(grid, positions)
    cutoff2 = jnp.asarray(cutoff * cutoff, positions.dtype)
    si, i_planes, _ = _i_tiles(grid, struct, n)
    # Pad slots sit at FAR, so pad-vs-pad lanes see r2 = 0 — gate hits on a
    # real i row (a real i against a pad j is already distance-rejected).
    i_real = (struct.order >= 0).reshape(si.shape)
    n_cols = len(grid.column_bases)
    k_tiles = wq // _ROW

    word_shift = jnp.arange(32, dtype=jnp.uint32)
    sub_tiles = _SUB // _ROW
    take_cols = []
    counts_cols = []
    for g in range(n_cols):
        j_planes_f, _, sj_f, valid_f = _window(grid, struct, g, n)
        packed_chunks = []
        # Lane-chunked like the force path: bounded temporaries at any
        # window width (the relaxation structure's skew).
        for t0 in range(0, k_tiles, sub_tiles):
            t1 = min(t0 + sub_tiles, k_tiles)
            sl = slice(t0 * _ROW, t1 * _ROW)
            j_planes = tuple(p[:, sl] for p in j_planes_f)
            sj = sj_f[:, sl]
            valid_j = valid_f[:, sl]
            dxs = [
                ip[:, :, None] - jp[:, None, :]
                for ip, jp in zip(i_planes, j_planes)
            ]
            r2 = dxs[0] * dxs[0] + dxs[1] * dxs[1] + dxs[2] * dxs[2]
            take = (
                valid_j[:, None, :]
                & i_real[:, :, None]
                & (si[:, :, None] < sj[:, None, :])
                & (r2 < cutoff2)
            )
            # Bit-pack 32 lanes per word: byte masks at production size are
            # ~1.7 GB per tick and OOM'd the fused 100k chunk at compile.
            # The packed words are the ONLY consumer of the big elementwise
            # chain — counts derive from popcount on the words — so XLA
            # fuses the whole mask computation into this one reduction
            # instead of materializing (N, K, 128) temporaries (which
            # OOM'd the fused 25k chunk: ~20 live 208 MB buffers).
            packed_chunks.append(
                jnp.sum(
                    take.reshape(n_pad, t1 - t0, 4, 32).astype(jnp.uint32)
                    << word_shift[None, None, None, :],
                    axis=-1,
                    dtype=jnp.uint32,
                )
            )
        packed = jnp.concatenate(packed_chunks, axis=1)
        take_cols.append(packed)                       # (n_pad, K, 4) u32
        counts_cols.append(
            jnp.sum(
                jax.lax.population_count(packed).astype(jnp.int32), axis=-1
            )
        )

    # (n_pad, n_cols*K) per-tile counts and packed masks.
    tile_counts = jnp.concatenate(counts_cols, axis=1)
    take_bits = jnp.concatenate(take_cols, axis=1)     # (n_pad, G*K, 4)

    # Hierarchical event indexing.
    tile_prefix = jnp.cumsum(tile_counts, axis=1)      # inclusive, per row
    row_counts = tile_prefix[:, -1]
    row_offsets = jnp.cumsum(row_counts)               # inclusive
    n_events = row_offsets[-1].astype(jnp.int32)

    e_cap = int(events_capacity)

    # Event -> owner row WITHOUT per-event binary search (an 800k-query
    # searchsorted lowers to a while loop and dominated the whole tick,
    # profiled ~400 ms at 100k beads): scatter one mark at every row's
    # exclusive start over the event domain, then a prefix sum counts the
    # rows started at-or-before each event — which IS the row index (empty
    # rows share their successor's start and the accumulate keeps the
    # count right).  The row's own start forward-fills with a running max.
    row_excl = (row_offsets - row_counts).astype(jnp.int32)   # (n_pad,)
    mark_at = jnp.minimum(row_excl, e_cap)
    row_of_e = jnp.cumsum(
        jnp.zeros((e_cap + 1,), jnp.int32).at[mark_at].add(1)
    )[:e_cap] - 1
    row_of_e = jnp.clip(row_of_e, 0, n_pad - 1)
    start_of_e = jax.lax.cummax(
        jnp.zeros((e_cap + 1,), jnp.int32).at[mark_at].max(row_excl)
    )[:e_cap]

    def extract(sl):
        """Locate one chunk of event indices; all temporaries are E-chunk
        sized (an adaptive capacity in the millions would otherwise hold
        ~10 E-sized temporaries per tick x 10 unrolled ticks — a 60k-bead
        chunk compile demanded 58 GB of device memory before this bound)."""
        e_ids = sl
        valid_e = e_ids < n_events
        row = row_of_e[e_ids]
        rank_in_row = e_ids - start_of_e[e_ids]

        # Tile within the row: compare against the row's tile prefix
        # (row-gather of the (G*K,) prefix, then a lane-wise count).
        prefix_rows = tile_prefix[row]                 # (E, G*K)
        tile = jnp.sum(
            (prefix_rows <= rank_in_row[:, None]).astype(jnp.int32), axis=1
        )
        tile = jnp.minimum(tile, n_cols * k_tiles - 1)
        tile_start = jnp.where(
            tile > 0,
            jnp.take_along_axis(
                prefix_rows, jnp.maximum(tile - 1, 0)[:, None], axis=1
            )[:, 0],
            0,
        )
        rank_in_tile = rank_in_row - tile_start

        # Lane within the tile: pick the word by cumulative popcount, then
        # the rank-th set bit by a 5-round binary bit-select — elementwise
        # u32 ops on (E,), replacing a (E, 128) cumsum (25x the traffic).
        flat_tile = row * (n_cols * k_tiles) + tile
        words = take_bits.reshape(-1, 4)[flat_tile]    # (E, 4) u32
        wpc = jax.lax.population_count(words).astype(jnp.int32)
        wcum = jnp.cumsum(wpc, axis=1)
        widx = jnp.minimum(
            jnp.sum((wcum <= rank_in_tile[:, None]).astype(jnp.int32),
                    axis=1),
            3,
        )
        wstart = jnp.where(
            widx > 0,
            jnp.take_along_axis(
                wcum, jnp.maximum(widx - 1, 0)[:, None], axis=1
            )[:, 0],
            0,
        )
        w = jnp.take_along_axis(words, widx[:, None], axis=1)[:, 0]
        r = (rank_in_tile - wstart).astype(jnp.uint32)
        lane32 = jnp.zeros_like(r)
        for width in (16, 8, 4, 2, 1):
            low = (w >> lane32) & jnp.uint32((1 << width) - 1)
            c = jax.lax.population_count(low)
            go_high = r >= c
            r = jnp.where(go_high, r - c, r)
            lane32 = jnp.where(go_high, lane32 + width, lane32)
        lane = (widx * 32 + lane32.astype(jnp.int32)).astype(jnp.int32)

        # Decode (column, tile) -> slot j id via the window row base.
        g_of = tile // k_tiles
        t_of = tile % k_tiles
        blk = row // b
        row0 = (struct.j_lo // _ROW)[g_of, blk]        # (E,)
        sj = (row0 + t_of) * _ROW + lane

        # Slot -> original ids (pads carry -1 but can never hit: their
        # positions are FAR).
        i_ids = struct.order[row]
        j_ids = struct.order[jnp.clip(sj, 0, n_pad - 1)]
        i_out = jnp.where(valid_e, i_ids, -1)
        j_out = jnp.where(valid_e, j_ids, -1)
        ones = jnp.where(valid_e, 1, 0).astype(jnp.int32)
        return jnp.stack([i_out, j_out, ones], axis=1)

    e_sub = 1 << 18
    if e_cap <= e_sub:
        events = extract(jnp.arange(e_cap, dtype=jnp.int32))
    else:
        # Unrolled chunks behind lax.cond: a chunk entirely past n_events
        # skips its extraction at run time, so the tick's cost follows the
        # ACTUAL event count, not the safety capacity (lax.map serialized
        # every chunk unconditionally — the profiled 400 ms while loop).
        n_chunks = -(-e_cap // e_sub)
        pad_chunk = jnp.concatenate(
            [
                jnp.full((e_sub, 2), -1, jnp.int32),
                jnp.zeros((e_sub, 1), jnp.int32),
            ],
            axis=1,
        )
        parts = []
        for c0 in range(n_chunks):
            ids = c0 * e_sub + jnp.arange(e_sub, dtype=jnp.int32)
            parts.append(
                jax.lax.cond(
                    jnp.int32(c0 * e_sub) < n_events,
                    lambda ids=ids: extract(ids),
                    lambda: pad_chunk,
                )
            )
        events = jnp.concatenate(parts)[:e_cap]
    return events, n_events, struct.overflow, struct.max_width


def block_contact_rows(grid: BlockGrid, positions, cutoff, row_capacity: int,
                       struct: BlockStructure | None = None):
    """All pairs within ``cutoff`` as fixed-capacity owner rows.

    The contact-tick analogue of :func:`contact.build_contact_list` on the
    sorted-block structure: per column, hit lanes compact into per-row slots
    with a running-fill prefix scan; each unordered pair lands on exactly one
    owner row (parity of the sorted indices — the same load-balancing trick
    as :func:`contact.owns_pair`, in sorted space).

    Returns ``(ids (n_pad, cap) int32 ORIGINAL partner ids (-1 empty),
    row_ids (n_pad,) original id per row (-1 on padding), row_overflow,
    width_overflow, max_width)``.  Feed to
    :func:`contact.compact_contact_events` with ``row_ids``.
    """
    n = positions.shape[0]
    b, n_blocks, n_pad, _, wq = _shape(grid, n)
    if struct is None:
        struct = build_structure(grid, positions)
    cutoff2 = jnp.asarray(cutoff * cutoff, positions.dtype)

    si, i_planes, _ = _i_tiles(grid, struct, n)
    # FAR-vs-FAR pad lanes see r2 = 0: gate on a real i row.
    i_real = (struct.order >= 0).reshape(si.shape)
    cap = int(row_capacity)
    ids = jnp.full((n_pad, cap), -1, jnp.int32)
    fill = jnp.zeros((n_pad,), jnp.int32)
    over = jnp.zeros((), jnp.int32)
    row_idx = jnp.arange(n_pad, dtype=jnp.int32).reshape(n_blocks, b)

    for g in range(len(grid.column_bases)):
        j_planes, _, sj, valid_j = _window(grid, struct, g, n)
        dxs = [
            ip[:, :, None] - jp[:, None, :]
            for ip, jp in zip(i_planes, j_planes)
        ]
        r2 = dxs[0] * dxs[0] + dxs[1] * dxs[1] + dxs[2] * dxs[2]
        sj3 = sj[:, None, :]
        si3 = si[:, :, None]
        lower = si3 < sj3
        even = ((si3 + sj3) % 2) == 0
        owns = jnp.where(even, lower, ~lower) & (si3 != sj3)
        take = valid_j[:, None, :] & i_real[:, :, None] & owns & (r2 < cutoff2)

        prefix = jnp.cumsum(take.astype(jnp.int32), axis=-1)
        slot = fill.reshape(n_blocks, b)[:, :, None] + prefix - 1
        ok = take & (slot < cap)
        rows3 = jnp.broadcast_to(row_idx[:, :, None], slot.shape)
        # Every in-bounds (row, slot) target is written by exactly one lane
        # (the prefix compaction guarantees it; rejected lanes aim at the
        # out-of-bounds dump column and are dropped).  Declaring that lets
        # XLA parallelize the scatter instead of serializing all ~N*9*Wq
        # updates.
        ids = ids.at[rows3, jnp.where(ok, slot, cap)].set(
            jnp.broadcast_to(sj3, slot.shape), mode="drop",
            unique_indices=True,
        )
        fill = fill + prefix[:, :, -1].reshape(n_pad)
        over = over + jnp.sum(take & ~ok).astype(jnp.int32)

    # Slot partner ids -> original bead ids (small (n_pad, cap) gather);
    # row ids are the slot layout's original-id map (-1 on pads).
    safe = jnp.minimum(jnp.maximum(ids, 0), n_pad - 1)
    ids = jnp.where(ids >= 0, struct.order[safe], -1)
    return ids, struct.order, over, struct.overflow, struct.max_width
