"""Bonded/topological force terms: chain bonds, bending triples, point sources,
kinetochore fibers.

These act on O(N) index arrays (gather + scatter-add), not the O(N*nbr)
neighbor loop, so they are cheap; clarity over micro-optimization.

Force convention: each helper returns ``(forces, energy)`` where ``forces``
has shape (N, 3) and accumulates -grad(U).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import potentials


def pair_bond_forces(positions, pairs, energy_fn, coeff_fn):
    """Generic bonded-pairwise force over (B, 2) index pairs.

    ``energy_fn(r2) -> (B,)`` and ``coeff_fn(r2) -> (B,)`` may close over
    per-bond parameters (the reference mixes spring constants per bonded pair,
    simulation_driver_forcefield.cpp:61-96).
    """
    n = positions.shape[0]
    if pairs.shape[0] == 0:
        return jnp.zeros_like(positions), jnp.asarray(0.0, positions.dtype)
    i, j = pairs[:, 0], pairs[:, 1]
    dx = positions[i] - positions[j]
    r2 = jnp.sum(dx * dx, axis=-1)
    energy = jnp.sum(energy_fn(r2))
    f = coeff_fn(r2)[:, None] * dx
    forces = jnp.zeros_like(positions)
    forces = forces.at[i].add(f)
    forces = forces.at[j].add(-f)
    return forces, energy


def shift_bond_forces(positions, offset, mask, energy_fn, coeff_fn):
    """Bonded-pairwise force for UNIFORM-OFFSET bonds (i, i + offset).

    Chain bonds are (i, i+1) and intra-TAD loops (i, i+2) by construction,
    so the gather/scatter of :func:`pair_bond_forces` collapses into two
    rolls — contiguous vector ops instead of per-element gathers and
    scatter-adds.

    ``mask`` is (N,) bool: True where row i owns a bond to i + offset
    (False at chain tails); ``energy_fn``/``coeff_fn`` close over
    (N,)-row-aligned per-bond parameters.
    """
    dx = positions - jnp.roll(positions, -offset, axis=0)
    r2 = jnp.sum(dx * dx, axis=-1)
    energy = jnp.sum(jnp.where(mask, energy_fn(r2), 0.0))
    c = jnp.where(mask, coeff_fn(r2), 0.0)
    f = c[:, None] * dx
    forces = f - jnp.roll(f, offset, axis=0)
    return forces, energy


def chain_bond_pairs(chains) -> jnp.ndarray:
    """(B, 2) consecutive-bead pairs for a list of ChainAssignment ranges
    (md::make_bonded_pairwise_forcefield().add_bonded_range)."""
    import numpy as np

    pairs = []
    for chain in chains:
        idx = np.arange(chain.start, chain.end - 1)
        pairs.append(np.stack([idx, idx + 1], axis=1))
    if not pairs:
        return jnp.zeros((0, 2), dtype=jnp.int32)
    return jnp.asarray(np.concatenate(pairs), dtype=jnp.int32)


def loop_bond_pairs(chains) -> jnp.ndarray:
    """(B, 2) second-neighbor (i, i+2) pairs within each chain — the mean-field
    intra-TAD loops (simulation_driver_forcefield.cpp:131-135)."""
    import numpy as np

    pairs = []
    for chain in chains:
        idx = np.arange(chain.start, max(chain.end - 2, chain.start))
        pairs.append(np.stack([idx, idx + 2], axis=1))
    if not pairs:
        return jnp.zeros((0, 2), dtype=jnp.int32)
    return jnp.asarray(np.concatenate(pairs), dtype=jnp.int32)


def bending_triples(chains, penalize_centromere: bool = False) -> jnp.ndarray:
    """(T, 3) consecutive triples per chain.  Unless ``penalize_centromere``,
    ranges are split at the kinetochore bead so no triple crosses it
    (stage_anatelophase/simulation_driver.cpp:125-132)."""
    import numpy as np

    triples = []

    def add_range(start, end):
        if end - start >= 3:
            idx = np.arange(start, end - 2)
            triples.append(np.stack([idx, idx + 1, idx + 2], axis=1))

    for chain in chains:
        if penalize_centromere or chain.kinetochore is None:
            add_range(chain.start, chain.end)
        else:
            add_range(chain.start, chain.kinetochore)
            add_range(chain.kinetochore + 1, chain.end)
    if not triples:
        return jnp.zeros((0, 3), dtype=jnp.int32)
    return jnp.asarray(np.concatenate(triples), dtype=jnp.int32)


def bending_forces(positions, triples, bending_energy):
    """Cosine bending over (T, 3) triples; forces via autodiff of the energy
    (exactly F = -grad U, the property unit tests check for every potential)."""
    if triples.shape[0] == 0:
        return jnp.zeros_like(positions), jnp.asarray(0.0, positions.dtype)

    def total_energy(pos):
        r_prev = pos[triples[:, 1]] - pos[triples[:, 0]]
        r_next = pos[triples[:, 2]] - pos[triples[:, 1]]
        return jnp.sum(
            potentials.cosine_bending_energy(r_prev, r_next, bending_energy)
        )

    energy, grad = jax.value_and_grad(total_energy)(positions)
    return -grad, energy


def point_source_forces(positions, source, energy_fn, coeff_fn, targets=None):
    """md::make_point_source_forcefield: radial interaction of every particle
    (or ``targets`` subset) with a fixed point."""
    if targets is not None:
        pos = positions[targets]
    else:
        pos = positions
    dx = pos - jnp.asarray(source, positions.dtype)
    r2 = jnp.sum(dx * dx, axis=-1)
    energy = jnp.sum(energy_fn(r2))
    f = coeff_fn(r2)[:, None] * dx
    if targets is not None:
        forces = jnp.zeros_like(positions).at[targets].add(f)
    else:
        forces = f
    return forces, energy


def kfiber_forces(positions, kinetochores, pole, spring_constants, lengths):
    """Kinetochore-fiber dragging: effective spring of each kinetochore bead
    toward a spindle pole, K = decay_rate / mobility, b = stationary_length
    (common/forcefield/kinetochore_fiber_forcefield.cpp:23-53)."""
    dx = positions[kinetochores] - jnp.asarray(pole, positions.dtype)
    r2 = jnp.sum(dx * dx, axis=-1)
    energy = jnp.sum(potentials.spring_energy(r2, spring_constants, lengths))
    coeff = potentials.spring_force_coeff(r2, spring_constants, lengths)
    forces = jnp.zeros_like(positions).at[kinetochores].add(coeff[:, None] * dx)
    return forces, energy
