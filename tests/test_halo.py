"""Halo-exchange spatial decomposition vs the single-device engine."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from genome_cycle_tpu.config import parse_config
from genome_cycle_tpu.models.interphase import (
    ChunkStats,
    EngineSettings,
    InterphaseModel,
)
from genome_cycle_tpu.ops.contact import events_to_host, merge_window
from genome_cycle_tpu.parallel.mesh import make_mesh
from genome_cycle_tpu.parallel.halo import (
    gather_positions,
    make_halo_carry,
    make_halo_segment,
    plan_halo,
)
from genome_cycle_tpu.store import StageDesign
from genome_cycle_tpu.topology import ChainAssignment


def make_model(temperature=1.0, n=256, chains=2):
    per = n // chains
    assigns = [
        ChainAssignment(f"chr{i}:a", i * per, (i + 1) * per) for i in range(chains)
    ]
    ab = np.zeros((n, 2))
    ab[::2, 0] = 1.0
    ab[1::2, 1] = 1.0
    design = StageDesign(
        seed=7,
        chains=assigns,
        ab_factors=ab,
        nucleolar_bonds=np.zeros((0, 2), np.int64),
    )
    config = parse_config(json.dumps({"interphase": {"temperature": temperature}}))
    settings = EngineSettings(
        cell_capacity=64, contact_capacity=64, grid_bound=4.0,
        use_dense_grid=False,
    )
    return InterphaseModel.from_design(design, config, settings)


def chain_positions(n, radius=1.2, seed=0):
    """Walk-chain init: bonded partners are one bond length apart, as in any
    physically meaningful structure (the halo engine's bond locality
    assumption; a random ball would place bond partners across the volume)."""
    import sys
    import pathlib

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import bench

    return bench._chain_walk(n, 2, radius, seed=seed)


def run_halo(model, n_shards, x0, seed, seg_steps, n_replicas=1):
    mesh = make_mesh(n_replicas, n_shards)
    geo = plan_halo(model, n_shards, x0)
    reps = np.stack([x0] * n_replicas)
    carry = make_halo_carry(
        model, geo, mesh, reps, [seed + i for i in range(n_replicas)],
        np.tile([2.0, 2.0, 2.0], (n_replicas, 1)),
    )
    segment = make_halo_segment(model, geo, mesh, seg_steps)
    carry, events, stats = segment(carry, jnp.asarray(0))
    return carry, events, jax.tree.map(np.asarray, stats), model


def assert_clean(stats):
    assert int(np.max(stats.cell_overflow)) == 0
    assert int(np.max(stats.band_overflow)) == 0
    assert int(np.max(stats.bond_misses)) == 0
    assert int(np.max(stats.contact_overflow)) == 0
    assert int(np.max(stats.contact_misses)) == 0
    assert int(np.max(stats.event_overflow)) <= 0


def test_halo_matches_single_device_at_zero_temperature(rng):
    model = make_model(temperature=0.0)
    x0 = chain_positions(model.n)
    carry, events, stats, _ = run_halo(model, 8, x0, 3, 20)
    assert_clean(stats)
    halo_pos = gather_positions(model, carry)[0]
    halo_semi = np.asarray(carry.semiaxes)[0]

    segment = jax.jit(model.interphase_segment(20))
    carry1 = (
        jnp.asarray(x0, jnp.float32),
        jax.random.PRNGKey(3),
        jnp.asarray([2.0, 2.0, 2.0], jnp.float32),
        ChunkStats.zero(jnp.float32),
    )
    carry1, events1 = segment(carry1, jnp.asarray(0))

    np.testing.assert_allclose(halo_pos, np.asarray(carry1[0]), atol=2e-5)
    np.testing.assert_allclose(halo_semi, np.asarray(carry1[2]), rtol=1e-5)

    # Contact events: identical pair sets and counts (20 steps = one tick).
    halo_coo = merge_window([events_to_host(events)])
    single_coo = merge_window([events_to_host(events1)])
    np.testing.assert_array_equal(halo_coo, single_coo)
    assert len(halo_coo) > 0


def test_halo_equivalent_across_shard_counts(rng):
    # Noise is drawn per global bead id, so different shard counts see
    # identical random increments; positions agree to f32 force-summation
    # tolerance even at T > 0.
    model = make_model(temperature=1.0)
    x0 = chain_positions(model.n)
    c2, ev2, s2, _ = run_halo(model, 2, x0, 5, 20)
    c4, ev4, s4, _ = run_halo(model, 4, x0, 5, 20)
    assert_clean(s2)
    assert_clean(s4)
    p2 = gather_positions(model, c2)[0]
    p4 = gather_positions(model, c4)[0]
    np.testing.assert_allclose(p2, p4, atol=5e-5)
    np.testing.assert_array_equal(
        merge_window([events_to_host(ev2)]), merge_window([events_to_host(ev4)])
    )


def test_halo_replicas_diverge(rng):
    model = make_model(temperature=1.0)
    x0 = chain_positions(model.n)
    carry, events, stats, _ = run_halo(model, 4, x0, 11, 20, n_replicas=2)
    assert_clean(stats)
    pos = gather_positions(model, carry)
    assert np.isfinite(pos).all()
    assert np.abs(pos[0] - pos[1]).max() > 1e-4


def make_block_model(temperature=1.0, n=256, chains=2):
    """Same system with the sorted-block engine forced on (the hot
    path): brute-force threshold lowered so block_grid activates."""
    per = n // chains
    assigns = [
        ChainAssignment(f"chr{i}:a", i * per, (i + 1) * per) for i in range(chains)
    ]
    ab = np.zeros((n, 2))
    ab[::2, 0] = 1.0
    ab[1::2, 1] = 1.0
    design = StageDesign(
        seed=7,
        chains=assigns,
        ab_factors=ab,
        nucleolar_bonds=np.zeros((0, 2), np.int64),
    )
    config = parse_config(json.dumps({"interphase": {"temperature": temperature}}))
    settings = EngineSettings(
        cell_capacity=64, contact_capacity=64, grid_bound=4.0,
        dense_bound=2.0, use_dense_grid=False,
        use_block_pairs=True, block_width=640, brute_force_threshold=0,
    )
    return InterphaseModel.from_design(design, config, settings)


def test_halo_block_engine_matches_single_device(rng):
    """The per-shard sorted-block pair engine (the hot path) through the
    halo exchange must reproduce the single-device block engine: positions
    to f32 summation tolerance at T=0, contact events exactly."""
    model = make_block_model(temperature=0.0)
    assert model.block_grid is not None
    x0 = chain_positions(model.n)
    carry, events, stats, _ = run_halo(model, 4, x0, 3, 20)
    assert_clean(stats)
    halo_pos = gather_positions(model, carry)[0]

    segment = jax.jit(model.interphase_segment(20))
    carry1 = (
        jnp.asarray(x0, jnp.float32),
        jax.random.PRNGKey(3),
        jnp.asarray([2.0, 2.0, 2.0], jnp.float32),
        ChunkStats.zero(jnp.float32),
    )
    carry1, events1 = segment(carry1, jnp.asarray(0))

    np.testing.assert_allclose(halo_pos, np.asarray(carry1[0]), atol=5e-5)
    halo_coo = merge_window([events_to_host(events)])
    single_coo = merge_window([events_to_host(events1)])
    np.testing.assert_array_equal(halo_coo, single_coo)
    assert len(halo_coo) > 0
