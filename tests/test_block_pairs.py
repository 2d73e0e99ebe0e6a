"""Sorted-block range pair engine vs O(N^2) brute force.

Covers the properties the formulation's correctness hangs on:
- force/energy equality with the dense reference at random configurations;
- column-interval clipping on degenerate grids (blocks spanning nearly a
  whole z-column of cells would double-count without the clip);
- out-of-grid clamping (true coordinates still interact);
- width overflow counted, never silently dropped;
- per-pair extra channels (a/b factors) broadcast matching the slab engine.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from genome_cycle_tpu.ops import potentials as pot
from genome_cycle_tpu.ops.block_pairs import BlockGrid, block_pair_forces
from genome_cycle_tpu.ops.neighbor import pairwise_forces_dense


def ab_fns(params):
    def coeff(r2, e_i, e_j):
        a = 0.5 * (e_i[0] + e_j[0])
        b = 0.5 * (e_i[1] + e_j[1])
        return pot.ab_pair_force_coeff(r2, a, b, params)

    def energy(r2, e_i, e_j):
        a = 0.5 * (e_i[0] + e_j[0])
        b = 0.5 * (e_i[1] + e_j[1])
        return pot.ab_pair_energy(r2, a, b, params)

    return coeff, energy


def dense_fns(params, af, bf):
    def coeff(r2, i, j):
        a = 0.5 * (af[i] + af[j])
        b = 0.5 * (bf[i] + bf[j])
        return pot.ab_pair_force_coeff(r2, a, b, params)

    def energy(r2, i, j):
        a = 0.5 * (af[i] + af[j])
        b = 0.5 * (bf[i] + bf[j])
        return pot.ab_pair_energy(r2, a, b, params)

    return coeff, energy


PARAMS = dict(a_energy=2.5, a_diameter=0.3, b_energy=2.0, b_diameter=0.24)


@pytest.mark.parametrize(
    "n,block,width", [(500, 64, 256), (1000, 128, 384), (700, 8, 256)]
)
def test_block_vs_dense(rng, n, block, width):
    x = jnp.asarray(rng.uniform(-1.0, 1.0, size=(n, 3)), jnp.float32)
    af = jnp.asarray(rng.uniform(0, 1, size=n), jnp.float32)
    bf = 1.0 - af
    grid = BlockGrid.cubic(bound=1.5, cell_size=0.3, width=width, block=block)
    coeff, u = ab_fns(PARAMS)
    f, e, overflow, max_w = block_pair_forces(grid, x, (af, bf), coeff, u)
    assert int(overflow) == 0
    assert 0 < int(max_w) <= width
    dc, du = dense_fns(PARAMS, af, bf)
    f_ref, e_ref = pairwise_forces_dense(x, dc, du)
    np.testing.assert_allclose(np.asarray(f), np.asarray(f_ref), atol=2e-4)
    assert float(e) == pytest.approx(float(e_ref), rel=1e-5)


def test_degenerate_grid_no_double_count(rng):
    # A tiny grid (3x3x3 cells) with blocks spanning most of the id space:
    # without interval clipping the 9 column windows overlap heavily and
    # every pair would be counted several times.
    n = 300
    x = jnp.asarray(rng.uniform(-0.44, 0.44, size=(n, 3)), jnp.float32)
    af = jnp.ones((n,), jnp.float32)
    bf = jnp.zeros((n,), jnp.float32)
    grid = BlockGrid.cubic(bound=0.45, cell_size=0.3, width=512, block=64)
    assert grid.dims == (3, 3, 3)
    coeff, u = ab_fns(PARAMS)
    f, e, overflow, _ = block_pair_forces(grid, x, (af, bf), coeff, u)
    assert int(overflow) == 0
    dc, du = dense_fns(PARAMS, af, jnp.zeros((n,), jnp.float32))
    f_ref, e_ref = pairwise_forces_dense(x, dc, du)
    np.testing.assert_allclose(np.asarray(f), np.asarray(f_ref), atol=2e-4)
    assert float(e) == pytest.approx(float(e_ref), rel=1e-5)


def test_out_of_grid_beads_still_interact():
    x = jnp.asarray(
        [[1.95, 0.0, 0.0], [2.15, 0.0, 0.0], [-2.4, 0.0, 0.0],
         [-2.5, 0.1, 0.0]],
        jnp.float32,
    )
    af = jnp.ones((4,), jnp.float32)
    bf = jnp.zeros((4,), jnp.float32)
    params = dict(a_energy=2.0, a_diameter=0.4, b_energy=1.0, b_diameter=0.3)
    grid = BlockGrid.cubic(bound=2.0, cell_size=0.4, width=64, block=4)
    coeff, u = ab_fns(params)
    f, e, overflow, _ = block_pair_forces(grid, x, (af, bf), coeff, u)
    assert int(overflow) == 0
    dc, du = dense_fns(params, af, bf)
    f_ref, e_ref = pairwise_forces_dense(x, dc, du)
    np.testing.assert_allclose(np.asarray(f), np.asarray(f_ref), atol=1e-5)
    assert float(e) == pytest.approx(float(e_ref), rel=1e-5)


def test_width_overflow_detected(rng):
    # All beads in one cell: candidate slice needs ~n lanes, width 32 cannot
    # hold them -> overflow must be reported.
    n = 128
    x = jnp.asarray(rng.uniform(-0.1, 0.1, size=(n, 3)), jnp.float32)
    af = jnp.ones((n,), jnp.float32)
    bf = jnp.zeros((n,), jnp.float32)
    grid = BlockGrid.cubic(bound=1.0, cell_size=0.3, width=32, block=32)
    coeff, _ = ab_fns(PARAMS)
    _, _, overflow, max_w = block_pair_forces(grid, x, (af, bf), coeff)
    assert int(overflow) > 0
    assert int(max_w) > 32


def test_uneven_block_padding(rng):
    # n not a multiple of the block size: pad rows must not contribute.
    n = 181
    x = jnp.asarray(rng.uniform(-0.9, 0.9, size=(n, 3)), jnp.float32)
    af = jnp.asarray(rng.uniform(0, 1, size=n), jnp.float32)
    bf = 1.0 - af
    grid = BlockGrid.cubic(bound=1.0, cell_size=0.3, width=256, block=64)
    coeff, u = ab_fns(PARAMS)
    f, e, overflow, _ = block_pair_forces(grid, x, (af, bf), coeff, u)
    assert int(overflow) == 0
    dc, du = dense_fns(PARAMS, af, bf)
    f_ref, e_ref = pairwise_forces_dense(x, dc, du)
    np.testing.assert_allclose(np.asarray(f), np.asarray(f_ref), atol=2e-4)
    assert float(e) == pytest.approx(float(e_ref), rel=1e-5)


def test_block_contact_rows_vs_kdtree(rng):
    from scipy.spatial import cKDTree

    from genome_cycle_tpu.ops.block_pairs import block_contact_rows
    from genome_cycle_tpu.ops.contact import ContactList, compact_contact_events

    n = 700
    cutoff = 0.28
    x_host = rng.uniform(-1.0, 1.0, size=(n, 3)).astype(np.float32)
    x = jnp.asarray(x_host)
    grid = BlockGrid.cubic(bound=1.5, cell_size=0.3, width=512, block=128)
    ids, row_ids, row_ov, width_ov, _ = block_contact_rows(grid, x, cutoff, 64)
    assert int(row_ov) == 0 and int(width_ov) == 0

    contact = ContactList(
        ids=ids,
        counts=(ids >= 0).astype(jnp.int32),
        fill=jnp.sum(ids >= 0, axis=1).astype(jnp.int32),
        overflow=row_ov,
        ref_pos=jnp.zeros((ids.shape[0], 3), jnp.float32),
        drift2=jnp.zeros((), jnp.float32),
    )
    events, n_events = compact_contact_events(contact, 8192, row_ids=row_ids)
    ev = np.asarray(events)
    ev = ev[ev[:, 0] >= 0]
    got = {(min(a, b), max(a, b)) for a, b in ev[:, :2]}
    assert len(got) == len(ev)  # each pair exactly once

    tree = cKDTree(x_host)
    want = {
        (min(a, b), max(a, b))
        for a, b in tree.query_pairs(cutoff, output_type="ndarray")
    }
    assert got == want


def test_interphase_segment_block_vs_gather(rng):
    """The block-engine segment (block pair force + block tick) and the CPU
    gather segment produce identical contact events — and stochastically
    equivalent positions — from the same carry.  With the brute-force
    threshold lowered the block engine also computes the pair force, so this
    covers the full wired path (pair + tick + stats channels)."""
    import json

    import jax

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

    def run(use_block):
        settings = EngineSettings(
            cell_capacity=64, contact_capacity=64, grid_bound=4.0,
            dense_bound=2.0, use_dense_grid=False,
            use_block_pairs=use_block, block_width=512,
            brute_force_threshold=0 if use_block else 16384,
        )
        model = InterphaseModel.from_design(design, config, settings)
        assert (model.block_grid is not None) == use_block
        rng2 = np.random.default_rng(77)
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
        assert int(stats.cell_overflow) == 0
        assert int(stats.contact_overflow) == 0
        assert int(stats.contact_cell_overflow) == 0
        assert int(stats.event_overflow) <= 0
        return np.asarray(carry[0]), merge_window([events_to_host(ev)])

    p_b, ev_b = run(True)
    p_g, ev_g = run(False)
    # Same PRNG stream and same physics: positions agree to float tolerance
    # (different reduction orders), events are identical sets.
    np.testing.assert_allclose(p_b, p_g, atol=5e-4)
    np.testing.assert_array_equal(ev_b, ev_g)
    assert len(ev_b) > 0


def test_block_contact_events_vs_kdtree(rng):
    from scipy.spatial import cKDTree

    from genome_cycle_tpu.ops.block_pairs import block_contact_events

    n = 700
    cutoff = 0.28
    x_host = rng.uniform(-1.0, 1.0, size=(n, 3)).astype(np.float32)
    x = jnp.asarray(x_host)
    grid = BlockGrid.cubic(bound=1.5, cell_size=0.3, width=512, block=128)
    events, n_events, width_ov, _ = block_contact_events(grid, x, cutoff, 8192)
    assert int(width_ov) == 0
    ev = np.asarray(events)
    ev = ev[ev[:, 0] >= 0]
    assert len(ev) == int(n_events)
    got = {(min(a, b), max(a, b)) for a, b in ev[:, :2]}
    assert len(got) == len(ev)  # each pair exactly once
    assert (ev[:, 2] == 1).all()

    tree = cKDTree(x_host)
    want = {
        (min(a, b), max(a, b))
        for a, b in tree.query_pairs(cutoff, output_type="ndarray")
    }
    assert got == want


def test_block_contact_events_capacity_truncation(rng):
    from genome_cycle_tpu.ops.block_pairs import block_contact_events

    n = 400
    x = jnp.asarray(rng.uniform(-0.5, 0.5, size=(n, 3)), jnp.float32)
    grid = BlockGrid.cubic(bound=1.0, cell_size=0.3, width=1024, block=128)
    _, n_full, _, _ = block_contact_events(grid, x, 0.3, 1 << 15)
    assert int(n_full) > 64
    events, n_events, _, _ = block_contact_events(grid, x, 0.3, 64)
    assert int(n_events) == int(n_full)  # true count still reported
    ev = np.asarray(events)
    assert (ev[:, 0] >= 0).sum() == 64  # buffer filled to capacity


def test_valid_mask_matches_subset(rng):
    """A FAR-padded fixed-capacity buffer (halo slab layout) with a validity
    mask must produce the same forces as the packed subset alone — and must
    not inflate the window watermark with the empty slots."""
    from genome_cycle_tpu.ops.block_pairs import build_structure

    n_real, n_buf = 300, 512
    x_real = rng.uniform(-1.0, 1.0, size=(n_real, 3)).astype(np.float32)
    x_buf = np.full((n_buf, 3), 1e15, np.float32)
    x_buf[:n_real] = x_real
    valid = np.zeros(n_buf, bool)
    valid[:n_real] = True
    af_b = jnp.asarray(np.where(valid, 1.0, 0.0), jnp.float32)
    bf_b = jnp.zeros((n_buf,), jnp.float32)

    grid = BlockGrid.cubic(bound=1.5, cell_size=0.3, width=384, block=64)
    coeff, u = ab_fns(PARAMS)
    struct = build_structure(
        grid, jnp.asarray(x_buf), (af_b, bf_b), valid=jnp.asarray(valid)
    )
    f, e, ov, mw = block_pair_forces(
        grid, jnp.asarray(x_buf), (af_b, bf_b), coeff, u, struct=struct
    )
    assert int(ov) == 0

    af = jnp.ones((n_real,), jnp.float32)
    bf = jnp.zeros((n_real,), jnp.float32)
    f_ref, e_ref, ov_ref, mw_ref = block_pair_forces(
        grid, jnp.asarray(x_real), (af, bf), coeff, u
    )
    assert int(ov_ref) == 0
    np.testing.assert_allclose(
        np.asarray(f[:n_real]), np.asarray(f_ref), atol=2e-4
    )
    np.testing.assert_allclose(np.asarray(f[n_real:]), 0.0)
    assert float(e) == pytest.approx(float(e_ref), rel=1e-5)
    # Watermark must reflect the real structure, not the 212 empty slots.
    assert int(mw) <= int(mw_ref) + 64


def test_window_accumulator_matches_host_merge():
    """Device window accumulator == host merge_window on random tick events,
    including duplicate pairs across ticks, swapped pair ends, padding rows,
    and the overflow flag."""
    import jax
    from genome_cycle_tpu.ops.contact import (
        empty_window_acc, merge_events_acc, merge_window)

    rng = np.random.default_rng(7)
    acc, n = empty_window_acc(512)
    host_chunks = []
    merge = jax.jit(merge_events_acc)
    for _ in range(6):
        ne = int(rng.integers(10, 150))
        i = rng.integers(0, 50, ne)
        j = rng.integers(0, 50, ne)
        keep = i != j
        i, j = i[keep], j[keep]
        ne = len(i)
        ev = np.full((200, 3), -1, np.int32)
        ev[:ne, 0] = i
        ev[:ne, 1] = j
        ev[:ne, 2] = 1
        ev[ne:, 2] = 0
        host_chunks.append(
            (np.minimum(i, j).astype(np.int64),
             np.maximum(i, j).astype(np.int64),
             np.ones(ne, np.int64))
        )
        acc, n, ov = merge(acc, n, jnp.asarray(ev))
        assert int(ov) == 0
    ref = merge_window(host_chunks)
    got = np.asarray(acc[: int(n)])
    assert np.array_equal(ref, got)

    small, sn = empty_window_acc(4)
    _, sn2, sov = merge(small, sn, jnp.asarray(ev))
    assert int(sov) > 0 and int(sn2) == 4
