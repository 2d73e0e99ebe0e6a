"""Interphase stage driver: relaxation + G1 expansion with moving wall.

JAX re-design of the reference interphase driver
(``stage_interphase/simulation_driver*.cpp``, SURVEY.md §2.7): the entire hot
loop — neighbor-list build, A/B copolymer forces, bonds, nucleolus, wall with
axial-reaction feedback, BD update, scheduled expansion, wall ODE and contact
counting — runs inside one ``lax.scan`` chunk of ``sampling_interval`` steps;
only HDF5 sampling happens host-side between chunks.

Known deliberate cadence deviation (documented, within stochastic tolerance):
the reference samples the frame context *before* the per-step scale/wall
update of the same callback; we record the post-update values, a half-step
phase shift of order dt in the logged (not simulated) context.
"""

from __future__ import annotations

import dataclasses
import sys
import time as _time
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import InterphaseConfig, SimulationConfig
from ..store import InterphaseContext, SimulationStore, StageDesign
from ..ops import potentials as pot
from ..ops.bonded import (
    chain_bond_pairs,
    loop_bond_pairs,
    pair_bond_forces,
    shift_bond_forces,
)
from ..ops.contact import (
    ContactList,
    build_contact_list,
    compact_contact_events,
    contact_list_to_host,
    empty_window_acc,
    events_to_host,
    merge_events_acc,
    merge_window,
    track_drift,
    update_contact_counts,
)
from ..ops.integrator import BDParams, bd_update
from ..ops.block_pairs import (
    SLOT_OVERFLOW,
    BlockGrid,
    block_contact_events,
    block_pair_forces,
    build_structure,
)
from ..ops.dense_grid import (
    DenseGrid,
    build_slabs,
    pair_forces_slab,
    scatter_from_slab,
)
from ..ops.neighbor import (
    CellGrid,
    build_cell_table,
    pairwise_forces_cell,
    pairwise_forces_dense,
)
from ..ops.wall import wall_forces
from ..utils.logging import progress_line


SCALE_VIOLATION = 1 << 30  # contact_cell_overflow bit: cutoff > search cell


@dataclasses.dataclass(frozen=True)
class EngineSettings:
    """Performance-tuning knobs of the pair and contact engines (not part of
    the reference JSON schema; auto-derived from the system size when
    unset)."""

    cell_capacity: int = 32
    # Contact rows per bead at a tick (margin-free search lists the pairs
    # actually in contact: ~11 partners/bead at production density, halved
    # by parity ownership).  The halo/legacy margin-carrying lists also use
    # this row capacity, with margin-inflated occupancy.
    contact_capacity: int = 64
    # Margin of the coarse margin_grid (halo engine + per-step legacy path
    # only — the single-chip tick search is margin-free and ignores this).
    # A list built at cutoff + margin is valid while drift < margin/2
    # (measured equilibrium max drift at production density: 0.098 over 25
    # steps, 0.127 over 50).
    contact_margin: float = 0.25
    # Segment length between host-visible event blocks, in steps.  Prefers
    # tick multiples so segments run tick-free inner scans with the
    # margin-free search applied structurally at each block boundary; a
    # non-tick-aligned value falls back to the margin-carrying per-step
    # path.  Adjusted to a divisor of the chunk length at chunk-build time.
    contact_rebuild_interval: int = 20
    # Fixed per-segment event-buffer rows (None = auto: ~8 rows per bead).
    contact_events_capacity: Optional[int] = None
    # Per-cell capacity of the (coarser) contact-list search grid (None =
    # auto: cell_capacity scaled by the cell-volume ratio).  Decoupled from
    # cell_capacity so contact-grid occupancy cannot inflate the dense pair
    # engine's quadratic per-cell cost.
    contact_cell_capacity: Optional[int] = None
    # Tick-search cell as a fraction of contactmap_distance, bucketed by the
    # core-scale schedule: the gather fold's lanes scale with capacity^2, so
    # tracking the current cutoff cuts its lanes.  Must stay >= the largest
    # core_scale reached while a compiled chunk is live.
    contact_cell_scale: float = 1.0
    grid_bound: float = 8.0
    dtype: str = "float32"
    # Sorted-block range pair engine (ops/block_pairs.py): the hot path for
    # both the pair force and the contact tick.  Lanes scale linearly with
    # density skew, where the dense slab engine's scale with the square of
    # the densest cell.  None = auto (on; set False with
    # use_dense_grid=False for the readable gather-fold oracle).
    use_block_pairs: Optional[bool] = None
    # Per-column candidate-window capacity of the block engine; the adaptive
    # driver grows/shrinks it from the reported watermark.
    block_width: int = 1024
    # Static slot capacity of the block engine's column-aligned layout
    # (0 = auto worst case; the adaptive driver probes a tight value from
    # the structure and grows it on SLOT_OVERFLOW).
    block_slots: int = 0
    # Block size of the column-aligned layout.  Every occupied (x, y) cell
    # column pads to a multiple of this, so SMALL systems (hundreds of
    # beads over hundreds of columns) inflate their slot count ~block-fold
    # at the default; pass 8 (or 4) there to keep candidate lanes
    # proportional to the system.  Production-scale columns hold >> 32
    # beads.  The default of 32 was chosen before the move to the H100
    # and is not yet measured there.
    block_size: int = 32
    # Dense-slab pair engine (gather-free), explicit opt-in for comparison
    # (use_block_pairs=False, use_dense_grid=True).  The gather fold remains
    # as the readable reference implementation and for tests.
    use_dense_grid: bool = False
    dense_bound: float = 4.0
    # Below this particle count the O(N^2) dense pairwise path is used for
    # the pair force: fully dense pair lanes need no gathers and have no
    # per-cell capacity pathology on skewed density.  The crossover was
    # chosen before the move to the H100 and is not yet measured there.
    brute_force_threshold: int = 16384
    # Dense-grid cell size as a fraction of the max core diameter.  Early G1
    # runs at core_scale ~0.5, halving every cutoff; matching the cell size
    # to the current cutoff bucket cuts dense pair lanes ~8x in the densest
    # regime.  Must stay >= the largest core_scale reached while active
    # (the adaptive engine enforces this).
    dense_cell_scale: float = 1.0

    @classmethod
    def auto(cls, n_particles: int, config: InterphaseConfig) -> "EngineSettings":
        # The densest regime is the fresh spline-resampled post-telophase
        # structure, where ~coarse_graining fine beads share each coarse
        # bead's neighborhood — start generous; the adaptive engine shrinks
        # capacity once the nucleus decondenses.
        wall = config.wall_semiaxes_init
        return cls(
            cell_capacity=128,
            contact_capacity=128,
            contact_margin=0.25,
            grid_bound=float(4 * max(wall) + 1.0),
        )


@dataclasses.dataclass
class InterphaseModel:
    """Static system description + pure step functions for the interphase run."""

    config: InterphaseConfig
    n: int
    af: jnp.ndarray                # (N,) a factors
    bf: jnp.ndarray                # (N,) b factors
    mobility: jnp.ndarray          # (N,)
    bond_pairs: jnp.ndarray        # (B, 2) chain bonds
    bond_spring: jnp.ndarray       # (B,) pre-mixed K (unscaled)
    bond_length: jnp.ndarray       # (B,) pre-mixed l (unscaled)
    loop_pairs: jnp.ndarray        # (L, 2) intra-TAD (i, i+2) bonds
    loop_spring: jnp.ndarray       # (L,)
    # Row-aligned (N,) views of the same bonds for the shift formulation
    # (chain bonds are uniformly (i, i+1), loops (i, i+2)): mask True where
    # row i owns a bond, parameters aligned to the owning row.
    bond_mask: jnp.ndarray         # (N,)
    bond_k_row: jnp.ndarray        # (N,)
    bond_l_row: jnp.ndarray        # (N,)
    loop_mask: jnp.ndarray         # (N,)
    loop_k_row: jnp.ndarray        # (N,)
    nuc_bonds: jnp.ndarray         # (Bn, 2) NOR-nucleolus bonds
    nuc_targets: jnp.ndarray       # (Tn,) nucleolar particle indices
    grid: CellGrid
    contact_grid: CellGrid         # fine grid for margin-free tick search
    margin_grid: CellGrid          # coarse grid for margin-carrying lists
    settings: EngineSettings
    use_loops: bool
    use_droplet: bool
    dense_grid: Optional[DenseGrid] = None
    block_grid: Optional[BlockGrid] = None

    # -- construction --------------------------------------------------------

    @classmethod
    def from_design(
        cls,
        design: StageDesign,
        config: SimulationConfig,
        settings: Optional[EngineSettings] = None,
    ) -> "InterphaseModel":
        icfg = config.interphase
        n = design.particle_count
        ab = np.zeros((n, 2))
        ab[: design.ab_factors.shape[0]] = design.ab_factors
        af, bf = ab[:, 0], ab[:, 1]

        # Mobility: a >= b -> a_core_mobility else b_core_mobility; nucleolar
        # particles override (simulation_driver_particles.cpp:19-34).
        mobility = np.where(af >= bf, icfg.a_core_mobility, icfg.b_core_mobility)
        if design.nucleolar_bonds is not None and len(design.nucleolar_bonds):
            mobility[design.nucleolar_bonds[:, 1]] = icfg.nucleolus_mobility

        # Per-bond mixed parameters (simulation_driver_forcefield.cpp:61-96):
        # K = a_mix K_A + b_mix K_B, l = a_mix l_A + b_mix l_B.
        bond_pairs = np.asarray(chain_bond_pairs(design.chains))
        if len(bond_pairs):
            a_mix = 0.5 * (af[bond_pairs[:, 0]] + af[bond_pairs[:, 1]])
            b_mix = 0.5 * (bf[bond_pairs[:, 0]] + bf[bond_pairs[:, 1]])
            bond_spring = a_mix * icfg.a_core_bond_spring + b_mix * icfg.b_core_bond_spring
            bond_length = a_mix * icfg.a_core_bond_length + b_mix * icfg.b_core_bond_length
        else:
            bond_spring = np.zeros((0,))
            bond_length = np.zeros((0,))

        loop_pairs = np.asarray(loop_bond_pairs(design.chains))
        if len(loop_pairs):
            a_mix = 0.5 * (af[loop_pairs[:, 0]] + af[loop_pairs[:, 1]])
            b_mix = 0.5 * (bf[loop_pairs[:, 0]] + bf[loop_pairs[:, 1]])
            loop_spring = (
                a_mix * icfg.a_core_2nd_bond_spring + b_mix * icfg.b_core_2nd_bond_spring
            )
        else:
            loop_spring = np.zeros((0,))
        use_loops = bool(len(loop_pairs)) and bool(np.any(loop_spring != 0))

        # Row-aligned shift-bond views: bond (i, i+1) / loop (i, i+2) params
        # land on row i; rows without a bond mask out.
        bond_mask = np.zeros((n,), bool)
        bond_k_row = np.zeros((n,))
        bond_l_row = np.zeros((n,))
        if len(bond_pairs):
            bond_mask[bond_pairs[:, 0]] = True
            bond_k_row[bond_pairs[:, 0]] = bond_spring
            bond_l_row[bond_pairs[:, 0]] = bond_length
        loop_mask = np.zeros((n,), bool)
        loop_k_row = np.zeros((n,))
        if len(loop_pairs):
            loop_mask[loop_pairs[:, 0]] = True
            loop_k_row[loop_pairs[:, 0]] = loop_spring

        nuc_bonds = (
            design.nucleolar_bonds
            if design.nucleolar_bonds is not None
            else np.zeros((0, 2), np.int64)
        )
        nuc_targets = np.unique(nuc_bonds[:, 1]) if len(nuc_bonds) else np.zeros(0, np.int64)
        use_droplet = icfg.nucleolus_droplet_energy != 0 and len(nuc_targets) > 1

        if settings is None:
            settings = EngineSettings.auto(n, icfg)
        cell_size = max(icfg.a_core_diameter, icfg.b_core_diameter)
        grid = CellGrid.cubic(
            bound=settings.grid_bound,
            cell_size=cell_size,
            capacity=settings.cell_capacity,
        )
        # Margin-free tick search grid: the tick builds a fresh pair list at
        # the CURRENT contact distance (<= contactmap_distance at core_scale
        # 1), exactly the reference's fresh-search-every-update semantics
        # (contact_map.cpp:33-63).  The coarse margin-carrying grid's per-cell
        # capacity (and so its fold lanes, which scale with capacity^2) grows
        # with (cutoff+margin)^3.
        contact_cell = icfg.contactmap_distance * settings.contact_cell_scale
        ratio = (contact_cell / cell_size) ** 3
        contact_capacity_cells = settings.contact_cell_capacity or max(
            16, int(np.ceil(settings.cell_capacity * ratio * 2))
        )
        contact_grid = CellGrid.cubic(
            bound=settings.grid_bound,
            cell_size=contact_cell,
            capacity=contact_capacity_cells,
        )
        # Coarse margin-carrying grid (halo engine + the per-step legacy
        # path): lists built at cutoff + margin stay valid while drift <
        # margin/2; the 27-cell stencil needs cells at least that big.
        margin_cell = icfg.contactmap_distance + settings.contact_margin
        margin_capacity_cells = int(
            settings.cell_capacity
            * max(1, int(np.ceil((margin_cell / cell_size) ** 3)))
        )
        margin_grid = CellGrid.cubic(
            bound=settings.grid_bound,
            cell_size=margin_cell,
            capacity=margin_capacity_cells,
        )
        dense_grid = None
        if settings.use_dense_grid:
            dense_grid = DenseGrid.cubic(
                bound=settings.dense_bound,
                cell_size=cell_size * settings.dense_cell_scale,
                capacity=settings.cell_capacity,
            )
        use_block = settings.use_block_pairs
        if use_block is None:
            # The shipping engine: lanes scale linearly with density skew
            # and the tick shares its structure.  The gather fold remains
            # the explicit test oracle (use_block_pairs=False,
            # use_dense_grid=False).
            use_block = True
        block_grid = None
        # Below the brute threshold the O(N^2) path computes the pair FORCE,
        # but the contact tick still runs through the block grid, whose
        # lanes stay linear in N where the legacy gather tick's grow with
        # the square of the cell capacity.
        if use_block:
            # One grid serves the pair force AND the contact tick: the cell
            # covers both the interaction diameter and the largest contact
            # cutoff the schedule can reach (monotonic between
            # core_scale_init and 1), so the one-cell stencil invariant
            # holds statically for every tick — no runtime scale violation
            # is possible on this path.
            max_core = max(1.0, icfg.core_scale_init)
            block_cell = max(cell_size, icfg.contactmap_distance * max_core)
            block_grid = BlockGrid.cubic(
                bound=settings.dense_bound,
                cell_size=block_cell,
                width=settings.block_width,
                block=settings.block_size,
                slots=settings.block_slots,
            )

        f = jnp.float32 if settings.dtype == "float32" else jnp.float64
        return cls(
            config=icfg,
            n=n,
            af=jnp.asarray(af, f),
            bf=jnp.asarray(bf, f),
            mobility=jnp.asarray(mobility, f),
            bond_pairs=jnp.asarray(bond_pairs, jnp.int32).reshape(-1, 2),
            bond_spring=jnp.asarray(bond_spring, f),
            bond_length=jnp.asarray(bond_length, f),
            loop_pairs=jnp.asarray(loop_pairs, jnp.int32).reshape(-1, 2),
            loop_spring=jnp.asarray(loop_spring, f),
            bond_mask=jnp.asarray(bond_mask),
            bond_k_row=jnp.asarray(bond_k_row, f),
            bond_l_row=jnp.asarray(bond_l_row, f),
            loop_mask=jnp.asarray(loop_mask),
            loop_k_row=jnp.asarray(loop_k_row, f),
            nuc_bonds=jnp.asarray(nuc_bonds, jnp.int32).reshape(-1, 2),
            nuc_targets=jnp.asarray(nuc_targets, jnp.int32),
            grid=grid,
            contact_grid=contact_grid,
            margin_grid=margin_grid,
            settings=settings,
            use_loops=use_loops,
            use_droplet=use_droplet,
            dense_grid=dense_grid,
            block_grid=block_grid,
        )

    # -- scale schedule ------------------------------------------------------

    def scales(self, t):
        """Scheduled G1 decompaction (simulation_driver_interphase.cpp:67-76)."""
        c = self.config
        core = 1.0 - (1.0 - c.core_scale_init) * jnp.exp(-t / c.core_scale_tau)
        bond = 1.0 - (1.0 - c.bond_scale_init) * jnp.exp(-t / c.bond_scale_tau)
        return core, bond

    # -- force field ---------------------------------------------------------

    def _ab_params(self, core_scale):
        c = self.config
        return dict(
            a_energy=c.a_core_repulsion,
            a_diameter=c.a_core_diameter * core_scale,
            b_energy=c.b_core_repulsion,
            b_diameter=c.b_core_diameter * core_scale,
        )

    def _wall_params(self, core_scale):
        c = self.config
        return dict(
            a_energy=c.a_core_repulsion,
            a_diameter=c.a_core_diameter / 2 * core_scale,
            b_energy=c.b_core_repulsion,
            b_diameter=c.b_core_diameter / 2 * core_scale,
            packing_spring=c.wall_packing_spring,
        )

    def _pair_kernels(self, core_scale, with_energy):
        params = self._ab_params(core_scale)
        af, bf = self.af, self.bf

        def coeff(r2, i, j):
            a_mix = 0.5 * (af[i] + af[j])
            b_mix = 0.5 * (bf[i] + bf[j])
            return pot.ab_pair_force_coeff(r2, a_mix, b_mix, params)

        def energy(r2, i, j):
            a_mix = 0.5 * (af[i] + af[j])
            b_mix = 0.5 * (bf[i] + bf[j])
            return pot.ab_pair_energy(r2, a_mix, b_mix, params)

        return coeff, (energy if with_energy else None)

    def bonded_forces(self, positions, bond_scale, with_energy=False):
        """All topology-indexed terms: chain bonds, loops, nucleolar bonds,
        nucleolar droplet. Cheap O(N); computed for the full system even on
        spatially sharded devices."""
        c = self.config
        forces = jnp.zeros_like(positions)
        energy = jnp.asarray(0.0, positions.dtype)

        # Chain bonds: fluctuation-preserving rescale K/s^2, l*s
        # (simulation_driver_forcefield.cpp:78-88).  Uniform (i, i+1)
        # offset -> shift formulation (rolls, no gather/scatter).
        s2 = bond_scale * bond_scale
        k_bond = self.bond_k_row / s2
        l_bond = self.bond_l_row * bond_scale
        f, e = shift_bond_forces(
            positions, 1, self.bond_mask,
            lambda r2: pot.semispring_energy(r2, k_bond, l_bond),
            lambda r2: pot.semispring_force_coeff(r2, k_bond, l_bond),
        )
        forces, energy = forces + f, energy + e

        if self.use_loops:
            k_loop = self.loop_k_row / s2
            f, e = shift_bond_forces(
                positions, 2, self.loop_mask,
                lambda r2: pot.harmonic_energy(r2, k_loop),
                lambda r2: pot.harmonic_force_coeff(r2, k_loop),
            )
            forces, energy = forces + f, energy + e

        if self.nuc_bonds.shape[0]:
            k_nuc = c.nucleolus_bond_spring / s2
            l_nuc = c.nucleolus_bond_length * bond_scale
            f, e = pair_bond_forces(
                positions,
                self.nuc_bonds,
                lambda r2: pot.semispring_energy(r2, k_nuc, l_nuc),
                lambda r2: pot.semispring_force_coeff(r2, k_nuc, l_nuc),
            )
            forces, energy = forces + f, energy + e

        if self.use_droplet:
            cutoff = c.nucleolus_droplet_cutoff

            def drop_u(r2, i, j):
                return pot.cutoff_shift(
                    lambda q: pot.softwell_energy(
                        q, c.nucleolus_droplet_energy, c.nucleolus_droplet_decay, 6
                    ),
                    r2,
                    cutoff,
                )

            def drop_c(r2, i, j):
                inside = r2 < cutoff * cutoff
                return jnp.where(
                    inside,
                    pot.softwell_force_coeff(
                        r2, c.nucleolus_droplet_energy, c.nucleolus_droplet_decay, 6
                    ),
                    0.0,
                )

            f, e = pairwise_forces_dense(
                positions, drop_c, drop_u if with_energy else None,
                targets=self.nuc_targets,
            )
            forces, energy = forces + f, energy + e

        return forces, energy

    def pair_forces_rows(self, positions, table, core_scale, query=None,
                         with_energy=False):
        """A/B copolymer repulsion for a row block (full system if query is
        None)."""
        coeff, energy_fn = self._pair_kernels(core_scale, with_energy)
        return pairwise_forces_cell(
            self.grid, table, positions, coeff, energy_fn, query=query
        )

    def pair_forces_full(self, positions, core_scale, with_energy=False):
        """A/B copolymer repulsion for the whole system.

        Engine order: O(N^2) brute force below the threshold; the
        sorted-block range engine (the hot path, energy included — its
        window tiles cost the same with or without the energy term); then
        the dense slab / gather paths.  Returns (forces (N,3),
        energy, overflow, watermark) — for the block engine the last two are
        the candidate-window overflow count and width watermark.
        """
        if self.n <= self.settings.brute_force_threshold:
            coeff, energy_fn = self._pair_kernels(core_scale, with_energy)
            forces, energy = pairwise_forces_dense(
                positions, coeff, energy_fn
            )
            zero = jnp.zeros((), jnp.int32)
            return forces, energy, zero, zero

        if self.block_grid is not None:
            params = self._ab_params(core_scale)

            def coeff_b(r2, e_i, e_j):
                return pot.ab_pair_force_coeff(
                    r2, 0.5 * (e_i[0] + e_j[0]), 0.5 * (e_i[1] + e_j[1]),
                    params,
                )

            energy_b = None
            if with_energy:
                def energy_b(r2, e_i, e_j):
                    return pot.ab_pair_energy(
                        r2, 0.5 * (e_i[0] + e_j[0]), 0.5 * (e_i[1] + e_j[1]),
                        params,
                    )

            forces, energy, overflow, max_width = block_pair_forces(
                self.block_grid, positions, (self.af, self.bf),
                coeff_b, energy_b,
            )
            return forces, energy, overflow, max_width

        if self.dense_grid is None or with_energy:
            table, ov, fill = build_cell_table(self.grid, positions)
            forces, energy = self.pair_forces_rows(
                positions, table, core_scale, with_energy=with_energy
            )
            return forces, energy, ov, fill

        params = self._ab_params(core_scale)
        slabs = build_slabs(
            self.dense_grid, positions, extras=(self.af, self.bf)
        )

        def coeff(r2, ai, bi, aj, bj):
            return pot.ab_pair_force_coeff(
                r2, 0.5 * (ai + aj), 0.5 * (bi + bj), params
            )

        energy_fn = None
        if with_energy:
            def energy_fn(r2, ai, bi, aj, bj):
                return pot.ab_pair_energy(
                    r2, 0.5 * (ai + aj), 0.5 * (bi + bj), params
                )

        force_slab, energy = pair_forces_slab(
            self.dense_grid, slabs, coeff, energy_fn
        )
        forces = scatter_from_slab(force_slab, slabs.ids, self.n)
        return forces, energy, slabs.overflow, slabs.max_fill

    def wall_forces_rows(self, q_pos, q_ids, semiaxes, core_scale):
        """Nuclear envelope for a row block; returns (forces, reaction,
        energy) — reaction must be psum'd over row shards when sharded."""
        c = self.config
        wall_a = 0.5 * (self.af[q_ids] + c.wall_ab_factor.a)
        wall_b = 0.5 * (self.bf[q_ids] + c.wall_ab_factor.b)
        return wall_forces(
            q_pos, semiaxes, wall_a, wall_b, self._wall_params(core_scale)
        )

    def forces(self, positions, table, core_scale, bond_scale, semiaxes,
               with_energy=False):
        """Total force field. Returns (forces, axial_reaction, energy)."""
        forces, energy = self.pair_forces_rows(
            positions, table, core_scale, with_energy=with_energy
        )
        f, e = self.bonded_forces(positions, bond_scale, with_energy)
        forces, energy = forces + f, energy + e

        wf, reaction, we = self.wall_forces_rows(
            positions,
            jnp.arange(self.n, dtype=jnp.int32),
            semiaxes,
            core_scale,
        )
        forces = forces + wf
        energy = energy + we
        return forces, reaction, energy

    def total_energy(self, positions, core_scale, bond_scale, semiaxes):
        _, _, energy, _, _ = self._assemble_forces(
            positions, core_scale, bond_scale, semiaxes, with_energy=True
        )
        return energy

    # -- scan step functions -------------------------------------------------

    def _assemble_forces(self, x, core_scale, bond_scale, semiaxes,
                         with_energy=False):
        """Full force field via the fast pair path.
        Returns (forces, reaction, energy, overflow, max_fill)."""
        forces, energy, ov, fill = self.pair_forces_full(
            x, core_scale, with_energy=with_energy
        )
        f, e = self.bonded_forces(x, bond_scale, with_energy)
        forces, energy = forces + f, energy + e
        wf, reaction, we = self.wall_forces_rows(
            x, jnp.arange(self.n, dtype=jnp.int32), semiaxes, core_scale
        )
        return forces + wf, reaction, energy + we, ov, fill

    def relaxation_step(self, carry, step):
        """Displacement-limited BD at frozen init scales and wall
        (simulation_driver_relaxation.cpp:8-56)."""
        x, key, semiaxes, stats = carry
        c = self.config
        forces, _, _, ov, fill = self._assemble_forces(
            x, c.core_scale_init, c.bond_scale_init, semiaxes
        )
        stats = (jnp.maximum(stats[0], ov), jnp.maximum(stats[1], fill))
        key, sub = jax.random.split(key)
        x = bd_update(
            x,
            forces,
            self.mobility,
            sub,
            BDParams(c.temperature, c.timestep, c.relaxation_spacestep),
        )
        return (x, key, semiaxes, stats)

    def _bd_step4(self, carry, step):
        """Forces at lagged scales, BD update, wall ODE — everything except
        contact accounting (simulation_driver_interphase.cpp:16-63,79-90)."""
        x, key, semiaxes, stats = carry
        c = self.config
        dt = c.timestep
        # Scales were last updated by the previous step's callback at
        # time (step-1) * dt.
        core_scale, bond_scale = self.scales((step - 1).astype(x.dtype) * dt)

        forces, reaction, _, ov, fill = self._assemble_forces(
            x, core_scale, bond_scale, semiaxes
        )
        stats = (jnp.maximum(stats[0], ov), jnp.maximum(stats[1], fill))
        key, sub = jax.random.split(key)
        x = bd_update(
            x, forces, self.mobility, sub, BDParams(c.temperature, dt)
        )

        # Wall ODE: overdamped motion of the semiaxes under chromatin pressure
        # (simulation_driver_interphase.cpp:79-90).
        spring = jnp.asarray(c.wall_semiaxes_spring, x.dtype)
        semiaxes = semiaxes + dt * c.wall_mobility * (reaction - spring * semiaxes)

        return (x, key, semiaxes, stats)

    def _bd_step(self, carry, step):
        """Legacy 5-carry step: BD step plus the drift watermark guarding a
        margin-carrying contact list (the per-step path and halo engine)."""
        x, key, semiaxes, contact, stats = carry
        x, key, semiaxes, stats = self._bd_step4((x, key, semiaxes, stats), step)
        contact = track_drift(contact, x)
        return (x, key, semiaxes, contact, stats)

    def _contact_tick(self, carry, step):
        """Count contact events at the post-update positions and post-step
        distance (reference cadence: contact_map.cpp:33-63)."""
        x, key, semiaxes, contact, stats = carry
        c = self.config
        core_now, _ = self.scales(
            jnp.asarray(step, x.dtype) * c.timestep
        )
        contact = update_contact_counts(
            contact, x, c.contactmap_distance * core_now
        )
        return (x, key, semiaxes, contact, stats)

    def interphase_step(self, carry, step):
        """One G1 step including the conditional contact tick.

        Kept as the readable single-step reference (compile checks, tests).
        Hot chunks use :meth:`interphase_segment`, which restructures the
        tick into block boundaries so that no per-step ``cond`` sits inside
        the scan."""
        carry = self._bd_step(carry, step)
        return jax.lax.cond(
            step % self.config.contactmap_update_interval == 0,
            lambda cr: self._contact_tick(cr, step),
            lambda cr: cr,
            carry,
        )

    def fresh_contact_list(self, positions, core_scale) -> ContactList:
        """Margin-carrying list on the coarse grid (per-step legacy path)."""
        table, _, _ = build_cell_table(self.margin_grid, positions)
        cutoff = (
            self.config.contactmap_distance * core_scale
            + self.settings.contact_margin
        )
        return build_contact_list(
            self.margin_grid, table, positions, cutoff,
            self.settings.contact_capacity,
        )

    def contact_events_tick(self, x, step):
        """Fresh spatial search at a tick step -> compacted contact events.

        Exactly the reference cadence and semantics: every
        ``contactmap_update_interval`` steps a full neighbor search at the
        *current* contact distance counts each in-range pair once
        (contact_map.cpp:33-63).  No margin, no list lifetime, no drift
        assumption — the listed pairs ARE the events.  Returns (events
        (E, 3), n_events, overflow) where overflow counts pairs dropped by
        either the search-grid cell capacity or the per-row slot capacity.
        """
        c = self.config
        core_now, _ = self.scales(jnp.asarray(step, x.dtype) * c.timestep)
        cutoff = c.contactmap_distance * core_now

        if self.block_grid is not None:
            # Sorted-block tick: same machinery as the pair force (the block
            # cell statically covers every cutoff the schedule can reach),
            # with scatter-free direct event extraction — no per-row
            # capacity exists on this path.  Width overflow rides the pair
            # engine's channel via the driver's shared width knob.
            events, n_events, width_ov, _ = block_contact_events(
                self.block_grid, x, cutoff, self.events_capacity
            )
            zero = jnp.zeros((), jnp.int32)
            return events, n_events, zero, width_ov

        table, table_ov, _ = build_cell_table(self.contact_grid, x)
        # 27-cell stencil invariant: the search cell must cover the current
        # cutoff, else in-range pairs beyond the stencil are silently lost.
        # The drivers size contact_cell_scale >= the core scale reached while
        # a compiled chunk is live; a direct library user who violates that
        # gets the SCALE_VIOLATION bit in the grid-overflow signal instead of
        # silently dropped contacts (the retry loop re-buckets on it).
        scale_bad = cutoff > self.contact_grid.cell_size * (1.0 + 1e-6)
        table_ov = table_ov + jnp.where(
            scale_bad, jnp.int32(SCALE_VIOLATION), jnp.int32(0)
        )
        ct = build_contact_list(
            self.contact_grid, table, x, cutoff,
            self.settings.contact_capacity,
        )
        ct = ct._replace(counts=(ct.ids >= 0).astype(jnp.int32))
        events, n_events = compact_contact_events(ct, self.events_capacity)
        return events, n_events, ct.overflow, table_ov

    @property
    def events_capacity(self) -> int:
        # Auto default: ~5.5 contact pairs per bead at G1 density, times the
        # union growth over a segment's ticks (measured ~9.4/bead at 25k
        # beads), with headroom; overflow is detected and grows this.  The
        # block tick extracts each tick separately (no union), and its
        # per-event stage materializes (E, G*K) index gathers — a tighter
        # default bounds that temporary at large N.
        cap = self.settings.contact_events_capacity
        if cap is not None:
            return cap
        if self.block_grid is not None:
            return max(4096, 8 * self.n)
        return max(4096, 14 * self.n)

    def rebuild_interval(self, chunk_steps: int) -> int:
        """Largest divisor of the chunk length not exceeding the requested
        contact rebuild cadence (segments must tile the chunk exactly),
        preferring multiples of the contact tick interval so segments can
        run tick-free inner scans with ticks at block boundaries."""
        tick = self.config.contactmap_update_interval
        want = min(self.settings.contact_rebuild_interval, chunk_steps)
        divisors = [
            d for d in range(1, chunk_steps + 1)
            if chunk_steps % d == 0 and d <= want
        ]
        ticked = [d for d in divisors if d % tick == 0]
        return max(ticked) if ticked else max(divisors)

    def interphase_segment(self, seg_steps: int):
        """(carry, seg_start) -> (carry, events): BD steps with a margin-free
        spatial contact search at every tick boundary.

        carry = (x, key, semiaxes, ChunkStats); events (ticks, E, 3).  Chunk
        starts are multiples of the tick interval, so each block boundary IS
        the step where ``step % tick == 0`` — the search runs there at the
        current contact distance and its compacted events are the block's
        contribution (reference: fresh search per update,
        contact_map.cpp:33-63).  There is no list lifetime and therefore no
        drift assumption to verify.  The inner scans are tick-free: the
        tick runs once per block, outside any per-step ``cond``.

        A segment length the tick interval does not divide takes the legacy
        margin-carrying path (:meth:`_interphase_segment_margin`).
        """
        c = self.config
        tick = c.contactmap_update_interval
        if seg_steps % tick != 0:
            return self._interphase_segment_margin(seg_steps)

        def segment(carry, seg_start):
            x, key, semiaxes, stats = carry
            inner = (x, key, semiaxes, (stats.cell_overflow, stats.cell_fill))
            events = []
            n_ev = jnp.zeros((), jnp.int32)
            row_ov = stats.contact_overflow
            grid_ov = stats.contact_cell_overflow
            for blk in range(seg_steps // tick):
                block_start = seg_start + blk * tick
                inner, _ = jax.lax.scan(
                    lambda cr, s: (self._bd_step4(cr, s), None),
                    inner,
                    block_start + 1 + jnp.arange(tick),
                )
                ev, ne, rov, gov = self.contact_events_tick(
                    inner[0], block_start + tick
                )
                events.append(ev)
                n_ev = jnp.maximum(n_ev, ne)
                row_ov = jnp.maximum(row_ov, rov)
                grid_ov = jnp.maximum(grid_ov, gov)
            x, key, semiaxes, (ov, fill) = inner
            stats = ChunkStats(
                cell_overflow=ov,
                cell_fill=fill,
                contact_overflow=row_ov,
                drift2=stats.drift2,
                event_overflow=jnp.maximum(
                    stats.event_overflow,
                    n_ev - np.int32(self.events_capacity),
                ),
                contact_cell_overflow=grid_ov,
            )
            return (x, key, semiaxes, stats), jnp.stack(events)

        return segment

    def _interphase_segment_margin(self, seg_steps: int):
        """Legacy margin-carrying segment (one contact-list lifetime).

        A pair list built at cutoff + margin covers the segment's ticks while
        drift stays under margin/2, which the drift watermark verifies at run
        time.  Only non-tick-aligned cadences use this path now."""
        c = self.config

        def segment(carry, seg_start):
            x, key, semiaxes, stats = carry
            t_end = (seg_start + seg_steps).astype(x.dtype) * c.timestep
            core_end, _ = self.scales(t_end)
            cutoff = (
                c.contactmap_distance * core_end + self.settings.contact_margin
            )
            table, margin_table_ov, _ = build_cell_table(self.margin_grid, x)
            contact = build_contact_list(
                self.margin_grid, table, x, cutoff,
                self.settings.contact_capacity,
            )
            inner = (x, key, semiaxes, contact, (stats.cell_overflow,
                                                 stats.cell_fill))
            inner, _ = jax.lax.scan(
                lambda cr, s: (self.interphase_step(cr, s), None),
                inner,
                seg_start + 1 + jnp.arange(seg_steps),
            )
            x, key, semiaxes, contact, (ov, fill) = inner
            events, n_events = compact_contact_events(
                contact, self.events_capacity
            )
            stats = ChunkStats(
                cell_overflow=ov,
                cell_fill=fill,
                contact_overflow=jnp.maximum(
                    stats.contact_overflow, contact.overflow
                ),
                drift2=jnp.maximum(stats.drift2, contact.drift2),
                event_overflow=jnp.maximum(
                    stats.event_overflow,
                    n_events - np.int32(self.events_capacity),
                ),
                contact_cell_overflow=stats.contact_cell_overflow,
            )
            # Beads dropped from an overfull margin-grid cell would silently
            # vanish from the pair list.  margin_grid capacity scales with
            # cell_capacity (from_design), so surface the table overflow
            # through cell_overflow — the knob whose growth enlarges it.
            stats = stats._replace(
                cell_overflow=jnp.maximum(stats.cell_overflow, margin_table_ov)
            )
            return (x, key, semiaxes, stats), events

        return segment

    def make_interphase_chunk(self, chunk_steps: int):
        """(carry, start) -> (carry, events) over one sampling chunk.

        carry = (x, key, semiaxes, ChunkStats); events (segments, E, 3).
        The segment is one jit and segments dispatch from a host loop.
        Measured on an NVIDIA H100 80GB HBM3 at 700 W: one jit holding every
        segment unrolled ran its 1000-step chunk no more than 2% faster at
        5,979 and 59,610 particles, and took 229 s and 581 s to compile
        against 9 s and 22 s for the segment.
        """
        seg = self.rebuild_interval(chunk_steps)
        n_segments = chunk_steps // seg
        segment = jax.jit(self.interphase_segment(seg))

        def chunk(carry, start):
            start = jnp.asarray(start, jnp.int32)
            events = []
            for k in range(n_segments):
                carry, ev = segment(carry, start + k * seg)
                events.append(ev)
            return carry, jnp.stack(events)

        return chunk


class ChunkStats(NamedTuple):
    """Validity diagnostics accumulated across a jitted chunk."""

    cell_overflow: jnp.ndarray     # () int32 pair-engine slot overflow
    cell_fill: jnp.ndarray         # () int32 densest cell seen
    contact_overflow: jnp.ndarray  # () int32 contact-list row overflow
    drift2: jnp.ndarray            # () max squared drift within a segment
    event_overflow: jnp.ndarray    # () int32 event rows beyond capacity
    contact_cell_overflow: jnp.ndarray  # () int32 tick search grid

    @classmethod
    def zero(cls, dtype=jnp.float32) -> "ChunkStats":
        z = jnp.zeros((), jnp.int32)
        # event_overflow carries the watermark as (n_events - capacity):
        # start far below zero so an all-under-capacity chunk still reports
        # its true maximum (capacity + event_overflow) for shrink decisions;
        # > 0 still means overflow.
        ev = jnp.full((), -(1 << 30), jnp.int32)
        return cls(z, z, z, jnp.zeros((), dtype), ev, z)


class _AdaptiveEngine:
    """Capacity-adaptive compiled-function cache.

    Fixed-capacity cell/contact tables need static shapes under jit; the
    engine reruns a chunk with doubled capacity on overflow (results never
    silently drop pairs) and shrinks capacity when the densest cell uses
    under a third of it (the fresh post-mitotic structure is far denser than
    the decondensed G1 nucleus, so one static choice would waste most of the
    run).  Compiled chunks are cached per capacity so revisiting a bucket is
    free.
    """

    MAX_CAPACITY = 4096

    def __init__(self, design, config, settings: Optional[EngineSettings], log):
        self.design = design
        self.config = config
        self.log = log
        base = settings or EngineSettings.auto(
            design.particle_count, config.interphase
        )
        self.settings = base
        self.cell_capacity = base.cell_capacity
        self.contact_capacity = base.contact_capacity
        self.contact_margin = base.contact_margin
        self.rebuild_interval = base.contact_rebuild_interval
        self.events_capacity = base.contact_events_capacity
        self.contact_cell_capacity = base.contact_cell_capacity
        self.contact_cell_scale = base.contact_cell_scale
        self.dense_bound = base.dense_bound
        self.dense_cell_scale = base.dense_cell_scale
        self.block_width = base.block_width
        self.block_slots = base.block_slots
        # Device-resident window-accumulator capacity (unique (i, j) pairs
        # per output window); overflow only costs a re-merge, so the default
        # starts modest and doubles on demand.
        self.acc_capacity = max(1 << 16, 16 * design.particle_count)
        # Brute-force systems ignore the cell grids entirely: freeze every
        # grid adaptation (each change would recompile for nothing).
        self.brute = design.particle_count <= base.brute_force_threshold
        use_block = base.use_block_pairs
        if use_block is None:
            use_block = True  # shipping engine on every backend (from_design)
        # Width adaptivity applies whenever the block grid exists — brute
        # systems still run their contact tick through it.
        self.block = use_block
        self._cache: dict[tuple, dict] = {}

    def update_cell_scale(self, core_scale: float):
        """Cell-size buckets.

        DENSE pair grid: buckets disabled.  The dense cell stays at the
        interaction diameter: small per-cell capacities tile the (M, M)
        blocks badly, so fewer lanes need not run faster.

        CONTACT tick-search grid: buckets enabled.  The gather fold's lanes
        scale with per-cell capacity^2, so the search cell tracks the
        cutoff."""
        if self.brute or self.block:
            # The block engine's tick shares the pair grid (cell = the
            # static max of interaction diameter and schedule-max cutoff);
            # bucket changes would only churn recompiles.
            return
        for bucket in (0.52, 0.6, 0.7, 0.8, 0.9, 1.0):
            if core_scale <= bucket + 1e-6:
                break
        if bucket != self.contact_cell_scale:
            self.log(f"engine: contact-search cell bucket -> {bucket}")
            self.contact_cell_scale = bucket

    def force_contact_scale(self, scale: float):
        """Stencil-invariant recovery: the tick search saw a cutoff larger
        than its cell (SCALE_VIOLATION).  Jump the bucket to ``scale``; if
        already there the config's schedule exceeds every bucket."""
        if self.contact_cell_scale >= scale:
            raise ValueError(
                "contact tick cutoff exceeds the largest search-cell bucket; "
                "the core-scale schedule reaches beyond core_scale 1.0 — "
                "raise EngineSettings.contact_cell_scale accordingly"
            )
        self.log(f"engine: contact-search cell bucket forced -> {scale}")
        self.contact_cell_scale = scale

    def update_bound(self, max_abs_coord: float):
        """Track the occupied extent; the dense grid stays tight around it
        (empty cells cost dense-slab compute)."""
        if self.brute:
            return
        needed = float(np.ceil(max_abs_coord + 0.5))
        if needed != self.dense_bound and abs(needed - self.dense_bound) >= 1.0:
            self.log(f"engine: dense grid bound -> {needed}")
            self.dense_bound = needed
        elif needed > self.dense_bound:
            self.log(f"engine: dense grid bound -> {needed}")
            self.dense_bound = needed

    def bundle(self, relax: bool = False) -> dict:
        # The fresh spline-resampled relaxation structure has extreme local
        # density skew (~coarse_graining beads per spline segment), which
        # defeats the dense engine's uniform per-cell capacity; the gather
        # engine's cost scales with N, not with the worst cell, so the
        # relaxation phase always uses it.
        key = (
            self.cell_capacity, self.contact_capacity, self.contact_margin,
            self.rebuild_interval, self.events_capacity, self.dense_bound,
            self.dense_cell_scale, self.contact_cell_capacity,
            self.contact_cell_scale, self.block_width, self.block_slots,
            relax,
        )
        if key not in self._cache:
            settings = dataclasses.replace(
                self.settings,
                cell_capacity=self.cell_capacity,
                contact_capacity=self.contact_capacity,
                contact_margin=self.contact_margin,
                contact_rebuild_interval=self.rebuild_interval,
                contact_events_capacity=self.events_capacity,
                contact_cell_capacity=self.contact_cell_capacity,
                contact_cell_scale=self.contact_cell_scale,
                dense_bound=self.dense_bound,
                dense_cell_scale=self.dense_cell_scale,
                block_width=self.block_width,
                block_slots=self.block_slots,
                use_block_pairs=self.block,
                # The block engine handles the relaxation structure's density
                # skew with linear width growth; the slab engine cannot.
                use_dense_grid=self.settings.use_dense_grid and not relax,
            )
            model = InterphaseModel.from_design(self.design, self.config, settings)
            c = model.config
            relax_chunk = jax.jit(
                lambda carry: jax.lax.scan(
                    lambda cr, s: (model.relaxation_step(cr, s), None),
                    carry,
                    jnp.arange(c.relaxation_sampling_interval),
                )[0]
            )
            inter_chunk = model.make_interphase_chunk(c.sampling_interval)
            energy = jax.jit(model.total_energy)
            self._cache[key] = dict(
                model=model, relax_chunk=relax_chunk, inter_chunk=inter_chunk,
                energy=energy,
            )
        return self._cache[key]

    MAX_WIDTH = 1 << 17

    def grow_cells(self, watermark: int = 0):
        """Pair-engine capacity retry.  For the block engine the knob is the
        candidate-window width, grown to cover the reported watermark (the
        slab engine's doubling left the round-3 bench at 2x the needed
        capacity — 4x wasted lanes)."""
        if self.block:
            if watermark > 0:
                need = int(np.ceil(max(watermark * 1.25,
                                       self.block_width + 128)))
            else:
                # No watermark available (halo adjust, step-0 dump): double
                # instead of creeping 128 lanes per recompile.
                need = self.block_width * 2
            new = min(-(-need // 128) * 128, self.MAX_WIDTH)
            if new == self.block_width:
                # Only fail when the previous width was already at the limit
                # and overflow persists; a watermark that needs exactly
                # MAX_WIDTH still gets to run at it.
                raise RuntimeError("block window width limit exceeded")
            self.block_width = new
            self.log(f"engine: growing block width to {self.block_width}")
            return
        if self.cell_capacity >= self.MAX_CAPACITY:
            raise RuntimeError("cell capacity limit exceeded")
        self.cell_capacity *= 2
        self.log(f"engine: growing cell capacity to {self.cell_capacity}")

    def grow_block_slots(self):
        """Column-padded layout outgrew its static slot buffer: grow 1.5x
        (0 = auto worst case never overflows but costs dead-block lanes, so
        probed drivers stay tight and grow on the SLOT_OVERFLOW flag)."""
        if self.block_slots <= 0:
            raise RuntimeError(
                "slot overflow with auto (worst-case) capacity — impossible "
                "unless the grid geometry itself is inconsistent"
            )
        self.block_slots = -(-(self.block_slots * 3 // 2) // 128) * 128
        self.log(f"engine: growing block slots to {self.block_slots}")

    def handle_pair_overflow(self, overflow: int, watermark: int):
        """Dispatch a pair-engine overflow to the right knob: the block
        engine flags slot-capacity exhaustion with SLOT_OVERFLOW (grow the
        layout), anything else is window-width/cell-capacity overflow."""
        if self.block and (overflow & SLOT_OVERFLOW):
            self.grow_block_slots()
        else:
            self.grow_cells(watermark)

    def shrink_cells_if_idle(self, max_fill: int):
        if self.brute:
            return
        if self.block:
            want = max(-(-int(max_fill * 1.25) // 128) * 128, 256)
            # Hysteresis: only shrink past a whole step so a watermark
            # hovering near a 128 boundary cannot thrash recompiles.
            if max_fill > 0 and want <= self.block_width - 256:
                self.block_width = want
                self.log(f"engine: shrinking block width to {want}")
            return
        if self.cell_capacity > 2 * max(max_fill, 4) and self.cell_capacity > 8:
            self.cell_capacity //= 2
            self.log(f"engine: shrinking cell capacity to {self.cell_capacity}")

    def grow_contacts(self):
        if self.contact_capacity >= self.MAX_CAPACITY:
            raise RuntimeError("contact capacity limit exceeded")
        self.contact_capacity *= 2
        self.log(f"engine: growing contact capacity to {self.contact_capacity}")

    def grow_contact_cells(self, model):
        cur = self.contact_cell_capacity or model.contact_grid.capacity
        if cur >= self.MAX_CAPACITY:
            raise RuntimeError("contact search grid capacity limit exceeded")
        self.contact_cell_capacity = cur * 2
        self.log(
            f"engine: growing contact search-grid capacity to "
            f"{self.contact_cell_capacity}"
        )

    def handle_drift(self):
        """A segment's max bead displacement exceeded margin/2 — the
        per-segment pair list is only a superset of contact-eligible pairs
        within that bound.  Prefer shortening the list lifetime (rebuilds
        cost one cell pass) over widening the margin: a wider margin grows
        the row capacity — and the every-20-step tick cost — with the margin
        cubed, and on a compact structure a margin of O(system size) lists
        every pair, which cascades into contact-capacity doublings (observed:
        an under-relaxed 500-bead blob churned margin -> 2.0 -> capacity 256
        -> five recompiles before the first chunk landed).  Below the tick
        interval the segment falls back to the per-step conditional tick —
        slower per step, but only violent far-from-equilibrium dynamics land
        there, and correctness never depends on the margin."""
        if self.rebuild_interval > 1:
            floor = self.config.interphase.contactmap_update_interval
            want = (
                floor if self.rebuild_interval > floor
                else self.rebuild_interval // 2
            )
            self.rebuild_interval = max(want, 1)
            self.log(
                f"engine: drift exceeded margin/2; contact rebuild interval "
                f"-> {self.rebuild_interval}"
            )
        elif self.contact_margin < 4.0:
            self.contact_margin *= 2.0
            self.log(f"engine: growing contact margin to {self.contact_margin}")
        else:
            raise RuntimeError("contact margin limit exceeded")

    def grow_events(self, model):
        cur = self.events_capacity or model.events_capacity
        if cur >= 1 << 26:
            raise RuntimeError("contact event capacity limit exceeded")
        self.events_capacity = cur * 2
        self.log(f"engine: growing event capacity to {self.events_capacity}")

    def grow_acc(self, deficit: int):
        """Window accumulator overflowed by ``deficit`` unique pairs: size
        past the watermark with headroom (re-merging is cheap; the growth
        only recompiles the standalone merge jit, never the chunk)."""
        want = -(-int((self.acc_capacity + deficit) * 3 // 2) // 4096) * 4096
        if want > 1 << 27:
            raise RuntimeError("contact window accumulator limit exceeded")
        self.acc_capacity = want
        self.log(f"engine: growing window accumulator to {want}")

    def shrink_events_if_idle(self, model, event_overflow: int):
        """The event watermark is capacity + event_overflow (the overflow
        channel goes negative when under capacity).  The compact
        post-relaxation structure can inflate the capacity several-fold
        before G1 decompacts; shrink back so later chunks stop paying
        E-sized extraction work for empty rows."""
        cap = self.events_capacity or model.events_capacity
        watermark = cap + event_overflow
        want = max(4096, -(-int(watermark * 1.5) // 4096) * 4096)
        if watermark > 0 and want <= cap // 2:
            self.events_capacity = want
            self.log(f"engine: shrinking event capacity to {want}")

    def probe_capacity(self, positions):
        """Size the cell capacity (and block window width) from the actual
        structure before the first chunk (each adaptive retry costs a
        compile + a slow chunk; spline-resampled structures can exceed any
        reasonable default)."""
        icfg = self.config.interphase
        cell_size = max(icfg.a_core_diameter, icfg.b_core_diameter)
        if not self.brute:
            from ..ops.neighbor import CellGrid, build_cell_table

            grid = CellGrid.cubic(
                bound=self.settings.grid_bound, cell_size=cell_size,
                capacity=1,
            )
            _, _, max_fill = jax.jit(
                lambda x: build_cell_table(grid, x)
            )(positions)
            needed = int(2 ** np.ceil(np.log2(max(int(max_fill), 8))))
            if needed > self.cell_capacity:
                self.log(
                    f"engine: probed densest cell = {int(max_fill)} beads; "
                    f"cell capacity -> {needed}"
                )
                self.cell_capacity = min(needed, self.MAX_CAPACITY)
        if self.block:
            # The window watermark and slot need are exact and independent
            # of the width setting — one cheap structure build sizes the
            # engine.
            max_core = max(1.0, icfg.core_scale_init)
            block_cell = max(cell_size, icfg.contactmap_distance * max_core)
            bgrid = BlockGrid.cubic(
                bound=self.dense_bound, cell_size=block_cell, width=128
            )
            def _probe(x):
                s = build_structure(bgrid, x)
                return s.max_width, s.slot_need

            mw, need = (int(v) for v in jax.jit(_probe)(positions))
            want = max(-(-int(mw * 1.25) // 128) * 128, 256)
            if want != self.block_width:
                self.log(
                    f"engine: probed window watermark = {mw}; "
                    f"block width -> {want}"
                )
                self.block_width = min(want, self.MAX_WIDTH)
            # Tight slot capacity: every slot costs 9*Wq candidate lanes, so
            # the auto worst case (n + columns*(B-1)) would waste the lane
            # win; 15% headroom over the probed need absorbs drift between
            # probes, SLOT_OVERFLOW retries cover the rest.
            slots = -(-int(need * 1.15) // 128) * 128
            if slots != self.block_slots:
                self.log(
                    f"engine: probed slot need = {need}; "
                    f"block slots -> {slots}"
                )
                self.block_slots = slots


def run_interphase(
    store: SimulationStore,
    settings: Optional[EngineSettings] = None,
    log=print,
    n_shards: Optional[int] = None,
    mesh=None,
):
    """Full interphase stage: relaxation then G1, with reference cadences.

    With ``n_shards`` (or an explicit ``mesh`` with a "beads" axis) the G1
    phase runs spatially decomposed over devices through the halo-exchange
    engine — same store output, same sampling/window/checkpoint semantics
    (:func:`..parallel.halo.run_halo_g1`).  Relaxation stays single-device
    (10k steps on the skewed post-telophase structure; not worth a mesh).
    """
    config = store.load_config()
    design = store.load_interphase_design()
    engine = _AdaptiveEngine(design, config, settings, log)
    c = config.interphase
    n = design.particle_count

    key = jax.random.PRNGKey(design.seed)
    key, relax_key, inter_key = jax.random.split(key, 3)

    dtype = jnp.float32
    semiaxes0 = jnp.asarray(c.wall_semiaxes_init, dtype)

    def mean_energy(bundle, x, t, semiaxes):
        model = bundle["model"]
        core, bond = model.scales(jnp.asarray(t, x.dtype))
        return float(bundle["energy"](x, core, bond, semiaxes)) / n

    def zero_stats():
        return (jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32))

    # ---- relaxation phase --------------------------------------------------
    store.set_stage("relaxation")
    store.clear_frames()
    x = jnp.asarray(store.load_positions(0), dtype)
    if x.shape[0] != n:
        raise ValueError("initial structure size mismatch")
    engine.update_bound(float(np.abs(np.asarray(x)).max()))
    engine.update_cell_scale(c.core_scale_init)
    engine.probe_capacity(x)

    def relax_context(bundle, x):
        e = mean_energy(bundle, x, 0.0, semiaxes0)
        return InterphaseContext(
            time=0.0,
            wall_semiaxes=tuple(float(v) for v in np.asarray(semiaxes0)),
            core_scale=c.core_scale_init,
            bond_scale=c.bond_scale_init,
            mean_energy=e,
        )

    bundle = engine.bundle(relax=True)
    ctx = relax_context(bundle, x)
    store.save_positions(0, np.asarray(x))
    store.save_interphase_context(0, ctx)
    store.append_frame(0)
    log(progress_line("relaxation", 0, t=0.0, energy=ctx.mean_energy))

    state = (x, relax_key, semiaxes0)
    n_chunks = c.relaxation_steps // c.relaxation_sampling_interval
    for chunk in range(n_chunks):
        while True:
            bundle = engine.bundle(relax=True)
            carry = bundle["relax_chunk"]((*state, zero_stats()))
            overflow, max_fill = (int(v) for v in carry[3])
            if overflow > 0:
                engine.handle_pair_overflow(overflow, max_fill)
                continue
            break
        state = carry[:3]
        engine.shrink_cells_if_idle(max_fill)
        step = (chunk + 1) * c.relaxation_sampling_interval
        x = state[0]
        engine.update_bound(float(np.abs(np.asarray(x)).max()))
        ctx = relax_context(bundle, x)
        store.save_positions(step, np.asarray(x))
        store.save_interphase_context(step, ctx)
        store.append_frame(step)
        log(progress_line("relaxation", step, t=0.0, energy=ctx.mean_energy))

    # ---- interphase (G1) phase ---------------------------------------------
    store.set_stage("interphase")

    sampling = c.sampling_interval
    window_steps = sampling * c.contactmap_output_window

    # Intra-stage resume: a long G1 run snapshots its scan carry at contact
    # window boundaries; re-running the stage continues from the snapshot
    # (the reference can only restart whole stages, SURVEY.md §5.3-5.4).
    checkpoint = store.load_checkpoint()
    resume_step = 0
    if checkpoint is not None and 0 < checkpoint["step"] < c.steps:
        resume_step = int(checkpoint["step"])
        log(f"resuming interphase from checkpoint at step {resume_step}")
        # Frames written after the snapshot (before the crash) would be
        # re-appended by the resumed chunks.
        store.truncate_frames(resume_step)
    else:
        checkpoint = None
        store.clear_frames()

    def save_frame(bundle, step, x, semiaxes, contacts_coo=None):
        t = step * c.timestep
        model = bundle["model"]
        core, bond = model.scales(jnp.asarray(float(t)))
        ctx = InterphaseContext(
            time=t,
            wall_semiaxes=tuple(float(v) for v in np.asarray(semiaxes)),
            core_scale=float(core),
            bond_scale=float(bond),
            mean_energy=mean_energy(bundle, x, t, semiaxes),
        )
        store.save_positions(step, np.asarray(x))
        store.save_interphase_context(step, ctx)
        if contacts_coo is not None and len(contacts_coo):
            store.save_contacts(step, contacts_coo)
        store.append_frame(step)
        return ctx

    # The relaxed structure is far less skewed than the fresh spline blobs:
    # re-size the capacity for the G1 engine, and pick the cell-size bucket
    # covering the first (possibly resumed) chunk's cutoff.
    engine.probe_capacity(x)

    def _core_at(t):
        return 1.0 - (1.0 - c.core_scale_init) * np.exp(-t / c.core_scale_tau)

    engine.update_cell_scale(
        _core_at((resume_step + 2 * c.sampling_interval) * c.timestep)
    )
    bundle = engine.bundle()
    model = bundle["model"]
    if checkpoint is not None:
        x = jnp.asarray(checkpoint["positions"], dtype)
        semiaxes = jnp.asarray(checkpoint["semiaxes"], dtype)
        inter_key = jnp.asarray(checkpoint["key"], jnp.uint32)
        engine.update_bound(float(np.abs(np.asarray(x)).max()))
    else:
        # callback(0): sample, one contact update, dump-and-clear the window
        # (step 0 satisfies both cadences), then the wall gets its first
        # (reaction-free) update.
        semiaxes = semiaxes0
        core0, _ = model.scales(jnp.asarray(0.0))
        while True:
            model = engine.bundle()["model"]
            if model.block_grid is not None:
                # Block tick for the step-0 dump: the legacy margin path's
                # fold lanes scale with the square of the skew-probed cell
                # capacity, which is huge on the relaxation structure.
                ev, ne, _, width_ov = jax.jit(
                    lambda q: model.contact_events_tick(q, jnp.asarray(0))
                )(x)
                if int(width_ov) > 0:
                    engine.handle_pair_overflow(int(width_ov), 0)
                    continue
                if int(ne) > model.events_capacity:
                    engine.grow_events(model)
                    continue
                coo0 = merge_window([events_to_host(np.asarray(ev))])
            else:
                contact = model.fresh_contact_list(x, float(core0))
                contact = update_contact_counts(
                    contact, x, c.contactmap_distance * float(core0)
                )
                coo0 = merge_window([contact_list_to_host(contact)])
            break
        bundle = engine.bundle()
        ctx = save_frame(bundle, 0, x, semiaxes, coo0)
        log(progress_line("interphase", 0, t=0.0, energy=ctx.mean_energy))
        spring = jnp.asarray(c.wall_semiaxes_spring, dtype)
        semiaxes = semiaxes + c.timestep * c.wall_mobility * (0.0 - spring * semiaxes)

    if mesh is None and n_shards and n_shards > 1:
        from ..parallel.mesh import make_mesh

        mesh = make_mesh(1, n_shards)
    if mesh is not None:
        from ..parallel.halo import run_halo_g1

        return run_halo_g1(
            store, engine, mesh, x, inter_key, semiaxes, resume_step,
            save_frame, log,
        )

    # Window contacts accumulate ON DEVICE (sorted-COO dedup per chunk,
    # ops/contact.merge_events_acc): raw tick events are ~480 MB per
    # 1000-step chunk at 100k beads, while the deduplicated window COO
    # moves to the host once per dump boundary.
    merge_jit = jax.jit(merge_events_acc)
    acc, acc_n = empty_window_acc(engine.acc_capacity)
    state = (x, inter_key, semiaxes)
    wall_t0 = _time.perf_counter()
    steps_done = 0

    n_chunks = c.steps // sampling
    for chunk in range(resume_step // sampling, n_chunks):
        start = chunk * sampling
        while True:
            bundle = engine.bundle()
            model = bundle["model"]
            carry, events = bundle["inter_chunk"](
                (*state, ChunkStats.zero(dtype)), jnp.asarray(start)
            )
            x, k, semiaxes, stats = carry
            if int(stats.cell_overflow) > 0:
                engine.handle_pair_overflow(
                    int(stats.cell_overflow), int(stats.cell_fill)
                )
                continue
            if int(stats.contact_overflow) > 0:
                engine.grow_contacts()
                continue
            if int(stats.contact_cell_overflow) >= SCALE_VIOLATION:
                # The tick cutoff outgrew the search cell (stencil invariant):
                # re-bucket the cell scale for the worst case instead of
                # growing capacity (the wrong knob).
                engine.force_contact_scale(1.0)
                continue
            if int(stats.contact_cell_overflow) > 0:
                if engine.block:
                    # On the block path this channel is the tick's window
                    # width / slot overflow — same knobs as the pair engine.
                    engine.handle_pair_overflow(
                        int(stats.contact_cell_overflow),
                        int(stats.cell_fill),
                    )
                else:
                    engine.grow_contact_cells(model)
                continue
            if int(stats.event_overflow) > 0:
                engine.grow_events(model)
                continue
            if float(np.sqrt(stats.drift2)) > engine.contact_margin / 2:
                engine.handle_drift()
                continue
            break
        state = (x, k, semiaxes)
        max_fill = int(stats.cell_fill)
        engine.shrink_cells_if_idle(max_fill)
        engine.shrink_events_if_idle(model, int(stats.event_overflow))
        engine.update_bound(float(np.abs(np.asarray(x)).max()))
        # Bucket must cover the cutoff through the END of the next chunk.
        core_next, _ = model.scales(jnp.asarray((start + 2 * sampling) * c.timestep))
        engine.update_cell_scale(float(core_next))
        step = start + sampling

        while True:
            acc2, acc_n2, acc_ov = merge_jit(acc, acc_n, events)
            if int(acc_ov) > 0:
                engine.grow_acc(int(acc_ov))
                grown, _ = empty_window_acc(engine.acc_capacity)
                acc = jnp.concatenate([acc, grown[acc.shape[0]:]])
                continue
            acc, acc_n = acc2, acc_n2
            break

        contacts_coo = None
        if step % window_steps == 0:
            # The accumulator IS the sorted (i, j, count) window COO.
            contacts_coo = np.asarray(acc[: int(acc_n)])
            acc, acc_n = empty_window_acc(engine.acc_capacity)

        ctx = save_frame(bundle, step, x, semiaxes, contacts_coo)
        steps_done += sampling
        if step % c.logging_interval == 0:
            rate = steps_done / max(_time.perf_counter() - wall_t0, 1e-9)
            log(
                progress_line(
                    "interphase", step, t=step * c.timestep,
                    energy=ctx.mean_energy,
                    radius=float(np.cbrt(np.prod(np.asarray(semiaxes)))),
                )
                + f"\t{rate:.1f} steps/s ({rate * n:.3g} bead-steps/s)"
            )

        # Snapshot the carry at window boundaries (contact windows are
        # flushed there, so a resume never double-counts contacts).
        if contacts_coo is not None:
            store.save_checkpoint(
                step,
                {
                    "positions": np.asarray(x),
                    "semiaxes": np.asarray(semiaxes),
                    "key": np.asarray(k),
                },
            )

    store.clear_checkpoint()
    return np.asarray(state[0])
