"""Cell-list neighbor engine vs O(N^2) brute force, and contact accumulation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from genome_cycle_tpu.ops import potentials as pot
from genome_cycle_tpu.ops.contact import (
    build_contact_list,
    contact_list_to_host,
    merge_window,
    update_contact_counts,
)
from genome_cycle_tpu.ops.neighbor import (
    CellGrid,
    build_cell_table,
    pairwise_forces_cell,
    pairwise_forces_dense,
)


def softcore_fns(energy=2.0, diameter=0.3):
    def coeff(r2, i, j):
        return pot.softcore_force_coeff(r2, energy, diameter, 2, 3)

    def u(r2, i, j):
        return pot.softcore_energy(r2, energy, diameter, 2, 3)

    return coeff, u


@pytest.mark.parametrize("n", [64, 500])
def test_cell_vs_dense(rng, n):
    positions = jnp.asarray(rng.uniform(-1.0, 1.0, size=(n, 3)), jnp.float32)
    grid = CellGrid.cubic(bound=1.5, cell_size=0.3, capacity=64)
    table, overflow, max_fill = build_cell_table(grid, positions)
    assert int(overflow) == 0
    assert 0 < int(max_fill) <= grid.capacity
    coeff, u = softcore_fns()
    f_cell, e_cell = pairwise_forces_cell(grid, table, positions, coeff, u)
    f_dense, e_dense = pairwise_forces_dense(positions, coeff, u)
    np.testing.assert_allclose(np.asarray(f_cell), np.asarray(f_dense), atol=1e-4)
    assert float(e_cell) == pytest.approx(float(e_dense), rel=1e-5)


def test_out_of_grid_beads_still_interact(rng):
    # Beads outside the grid bounds are clamped to boundary cells but keep
    # their true coordinates; pairs spanning the boundary must still be found.
    positions = jnp.asarray(
        [[1.95, 0.0, 0.0], [2.15, 0.0, 0.0], [-2.4, 0.0, 0.0], [-2.5, 0.1, 0.0]],
        jnp.float32,
    )
    grid = CellGrid.cubic(bound=2.0, cell_size=0.3, capacity=8)
    table, _, _ = build_cell_table(grid, positions)
    coeff, u = softcore_fns(diameter=0.4)
    f_cell, e_cell = pairwise_forces_cell(grid, table, positions, coeff, u)
    f_dense, e_dense = pairwise_forces_dense(positions, coeff, u)
    np.testing.assert_allclose(np.asarray(f_cell), np.asarray(f_dense), atol=1e-5)
    assert float(e_cell) == pytest.approx(float(e_dense), rel=1e-5)
    assert float(e_cell) > 0  # the clamped pairs really interact


def test_capacity_overflow_detected(rng):
    positions = jnp.asarray(rng.normal(0, 0.01, size=(100, 3)), jnp.float32)
    grid = CellGrid.cubic(bound=1.0, cell_size=0.3, capacity=16)
    _, overflow, max_fill = build_cell_table(grid, positions)
    assert int(overflow) == 100 - 16
    assert int(max_fill) == 100


def test_dense_targets_subset(rng):
    # set_neighbor_targets semantics: only listed particles interact.
    positions = jnp.asarray(rng.uniform(-0.1, 0.1, size=(10, 3)), jnp.float32)
    coeff, u = softcore_fns()
    targets = jnp.asarray([0, 3, 7], jnp.int32)
    f, e = pairwise_forces_dense(positions, coeff, u, targets=targets)
    others = np.setdiff1d(np.arange(10), np.asarray(targets))
    np.testing.assert_array_equal(np.asarray(f)[others], 0.0)
    assert float(e) > 0


def test_contact_accumulation(rng):
    n = 200
    positions = jnp.asarray(rng.uniform(-0.8, 0.8, size=(n, 3)), jnp.float32)
    grid = CellGrid.cubic(bound=1.0, cell_size=0.3, capacity=64)
    table, _, _ = build_cell_table(grid, positions)
    distance = 0.24
    contact = build_contact_list(grid, table, positions, cutoff=0.3, capacity=64)
    assert int(contact.overflow) == 0
    contact = update_contact_counts(contact, positions, distance)
    contact = update_contact_counts(contact, positions, distance)

    i, j, c = contact_list_to_host(contact)
    coo = merge_window([(i, j, c)])

    # Brute-force expected contacts.
    p = np.asarray(positions)
    d2 = np.sum((p[:, None] - p[None, :]) ** 2, axis=-1)
    iu, ju = np.triu_indices(n, k=1)
    hits = d2[iu, ju] < distance**2
    expected = np.stack([iu[hits], ju[hits], np.full(hits.sum(), 2)], axis=1)
    order = np.lexsort((expected[:, 1], expected[:, 0]))
    expected = expected[order]

    np.testing.assert_array_equal(coo, expected)
    # Sorted by packed (i << 32 | j) key.
    keys = (coo[:, 0].astype(np.uint64) << np.uint64(32)) | coo[:, 1].astype(np.uint64)
    assert (np.diff(keys.astype(np.int64)) > 0).all()


def test_contact_margin_tracks_moved_beads(rng):
    # Beads listed with a margin keep counting after small drifts.
    positions = jnp.asarray([[0.0, 0, 0], [0.3, 0, 0]], jnp.float32)
    grid = CellGrid.cubic(bound=1.0, cell_size=0.5, capacity=8)
    table, _, _ = build_cell_table(grid, positions)
    contact = build_contact_list(grid, table, positions, cutoff=0.45, capacity=4)
    # Initially out of contact range (0.3 > 0.24): no count.
    contact = update_contact_counts(contact, positions, 0.24)
    # Drift together: now counted without rebuilding the list.
    moved = jnp.asarray([[0.05, 0, 0], [0.25, 0, 0]], jnp.float32)
    contact = update_contact_counts(contact, moved, 0.24)
    i, j, c = contact_list_to_host(contact)
    coo = merge_window([(i, j, c)])
    np.testing.assert_array_equal(coo, [[0, 1, 1]])


def test_contact_drift_guard_catches_fast_bead(rng):
    # A bead sprinting past margin/2 raises the drift watermark; rebuilding
    # with the widened margin lists (and counts) the approaching pair the
    # frozen list would silently have missed.
    from genome_cycle_tpu.ops.contact import track_drift

    distance, margin = 0.24, 0.25
    # Start 0.6 apart: outside cutoff = distance + margin = 0.49, so the
    # pair is NOT on the initial list.
    positions = jnp.asarray([[0.0, 0, 0], [0.6, 0, 0], [0, 0.9, 0]], jnp.float32)
    grid = CellGrid.cubic(bound=1.5, cell_size=0.49, capacity=8)
    table, _, _ = build_cell_table(grid, positions)
    contact = build_contact_list(
        grid, table, positions, cutoff=distance + margin, capacity=4
    )
    assert float(contact.drift2) == 0.0

    # Bead 1 sprints into contact range: a frozen list misses the pair...
    moved = positions.at[1, 0].set(0.2)
    contact = track_drift(contact, moved)
    counted = update_contact_counts(contact, moved, distance)
    i, j, c = contact_list_to_host(counted)
    assert len(merge_window([(i, j, c)])) == 0  # the silent-miss hazard

    # ...but the watermark exposes it, so the driver rebuilds wider.
    drift = float(jnp.sqrt(contact.drift2))
    assert drift > margin / 2

    wide = 2 * margin
    grid2 = CellGrid.cubic(bound=1.5, cell_size=distance + wide, capacity=8)
    table2, _, _ = build_cell_table(grid2, positions)
    rebuilt = build_contact_list(
        grid2, table2, positions, cutoff=distance + wide, capacity=4
    )
    rebuilt = update_contact_counts(rebuilt, moved, distance)
    i, j, c = contact_list_to_host(rebuilt)
    np.testing.assert_array_equal(merge_window([(i, j, c)]), [[0, 1, 1]])


def test_dense_slab_vs_brute_force(rng):
    """Dense cell-slab pair engine against O(N^2) brute force."""
    from genome_cycle_tpu.ops.dense_grid import (
        DenseGrid,
        build_slabs,
        pair_forces_slab,
        scatter_from_slab,
    )

    n = 400
    positions = jnp.asarray(rng.uniform(-1.0, 1.0, size=(n, 3)), jnp.float32)
    af = jnp.asarray(rng.uniform(0, 1, n), jnp.float32)
    bf = 1.0 - af
    grid = DenseGrid.cubic(bound=1.5, cell_size=0.3, capacity=32)
    slabs = build_slabs(grid, positions, extras=(af, bf))
    assert int(slabs.overflow) == 0
    assert 0 < int(slabs.max_fill) <= grid.capacity

    params = dict(a_energy=2.5, a_diameter=0.3, b_energy=2.5, b_diameter=0.24)

    def coeff_slab(r2, ai, bi, aj, bj):
        return pot.ab_pair_force_coeff(r2, 0.5 * (ai + aj), 0.5 * (bi + bj), params)

    def energy_slab(r2, ai, bi, aj, bj):
        return pot.ab_pair_energy(r2, 0.5 * (ai + aj), 0.5 * (bi + bj), params)

    force_slab, e_slab = pair_forces_slab(grid, slabs, coeff_slab, energy_slab)
    f_slab = scatter_from_slab(force_slab, slabs.ids, n)

    def coeff_dense(r2, i, j):
        a_mix = 0.5 * (af[i] + af[j])
        b_mix = 0.5 * (bf[i] + bf[j])
        return pot.ab_pair_force_coeff(r2, a_mix, b_mix, params)

    def u_dense(r2, i, j):
        a_mix = 0.5 * (af[i] + af[j])
        b_mix = 0.5 * (bf[i] + bf[j])
        return pot.ab_pair_energy(r2, a_mix, b_mix, params)

    f_dense, e_dense = pairwise_forces_dense(positions, coeff_dense, u_dense)
    np.testing.assert_allclose(
        np.asarray(f_slab), np.asarray(f_dense), atol=2e-3, rtol=1e-3
    )
    assert float(e_slab) == pytest.approx(float(e_dense), rel=1e-3)


def test_dense_slab_overflow_detected(rng):
    from genome_cycle_tpu.ops.dense_grid import DenseGrid, build_slabs

    positions = jnp.asarray(rng.normal(0, 0.01, size=(100, 3)), jnp.float32)
    grid = DenseGrid.cubic(bound=1.0, cell_size=0.3, capacity=16)
    slabs = build_slabs(grid, positions)
    assert int(slabs.overflow) == 100 - 16
    assert int(slabs.max_fill) == 100


def test_interphase_segment_events_dense_vs_gather(rng):
    """The dense-slab segment (slab tick search) and the gather segment (gather tick
    search) produce identical contact events and positions from the same
    carry (pair forces take the same brute path at this size, so positions
    are bitwise equal and only the contact formulation differs)."""
    import json

    import jax
    import jax.numpy as jnp

    from genome_cycle_tpu.config import parse_config
    from genome_cycle_tpu.models.interphase import (
        ChunkStats,
        EngineSettings,
        InterphaseModel,
    )
    from genome_cycle_tpu.ops.contact import events_to_host, merge_window
    from genome_cycle_tpu.store import StageDesign
    from genome_cycle_tpu.topology import ChainAssignment

    n = 256
    assigns = [ChainAssignment("chr1:a", 0, n)]
    ab = np.zeros((n, 2))
    ab[::2, 0] = 1.0
    ab[1::2, 1] = 1.0
    design = StageDesign(
        seed=5, chains=assigns, ab_factors=ab,
        nucleolar_bonds=np.zeros((0, 2), np.int64),
    )
    config = parse_config(json.dumps({}))

    def run(use_dense):
        settings = EngineSettings(
            cell_capacity=64, contact_capacity=64, grid_bound=4.0,
            dense_bound=2.0, use_dense_grid=use_dense,
        )
        model = InterphaseModel.from_design(design, config, settings)
        x0 = jnp.asarray(
            np.cumsum(rng2.normal(0, 0.06, (n, 3)), axis=0), jnp.float32
        )
        carry = (
            x0, jax.random.PRNGKey(9),
            jnp.asarray([2.0, 2.0, 2.0], jnp.float32),
            ChunkStats.zero(jnp.float32),
        )
        seg = jax.jit(model.interphase_segment(20))
        carry, ev = seg(carry, jnp.asarray(0))
        stats = carry[3]
        assert int(stats.contact_overflow) == 0
        assert int(stats.contact_cell_overflow) == 0
        assert int(stats.event_overflow) <= 0
        return np.asarray(carry[0]), merge_window([events_to_host(ev)])

    rng2 = np.random.default_rng(77)
    p_d, ev_d = run(True)
    rng2 = np.random.default_rng(77)
    p_g, ev_g = run(False)
    np.testing.assert_array_equal(p_d, p_g)
    np.testing.assert_array_equal(ev_d, ev_g)
    assert len(ev_d) > 0
