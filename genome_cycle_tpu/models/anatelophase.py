"""Anatelophase stage driver: anaphase dragging + telophase packing.

Re-design of ``stage_anatelophase/simulation_driver.cpp`` (SURVEY.md §2.5):
one coarse bead system (N ~ hundreds), two phases with a forcefield swap at
the anaphase->telophase boundary.  The coarse system is small, so pairwise
repulsion uses the dense masked O(N^2) path (elementwise, no cell grid).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import MitoticPhaseConfig, SimulationConfig
from ..store import SimulationStore, StageDesign
from ..ops import potentials as pot
from ..ops.bonded import (
    bending_forces,
    bending_triples,
    chain_bond_pairs,
    kfiber_forces,
    pair_bond_forces,
    point_source_forces,
)
from ..ops.integrator import BDParams, bd_update
from ..ops.neighbor import pairwise_forces_dense
from ..utils.logging import progress_line


@dataclasses.dataclass
class AnatelophaseModel:
    config: MitoticPhaseConfig
    n: int
    mobility: jnp.ndarray
    bond_pairs: jnp.ndarray
    triples: jnp.ndarray
    kinetochores: jnp.ndarray      # (C,)
    kfiber_springs: jnp.ndarray    # (C,) K = decay / (mobility/chain_len)
    pole: jnp.ndarray              # (3,) anaphase pole (origin + spindle shift)

    @classmethod
    def from_design(
        cls, design: StageDesign, config: SimulationConfig
    ) -> "AnatelophaseModel":
        m = config.mitotic_phase
        n = design.particle_count
        chains = design.chains
        # Chains without a kinetochore (shorter than the coarse-graining
        # window) have no microtubule attachment: exclude them from dragging.
        attached = [c for c in chains if c.kinetochore is not None]
        kinetochores = np.asarray(
            [c.kinetochore for c in attached], np.int32
        )
        # Per-chain kinetochore spring: K = decay_rate / (core_mobility/len)
        # (stage_anatelophase/simulation_driver.cpp:158-168).
        lens = np.asarray([c.end - c.start for c in attached], np.float64)
        kf = m.kfiber_decay_rate_anaphase / (m.core_mobility / np.maximum(lens, 1))
        pole = np.asarray(m.anaphase_spindle_shift, np.float64)
        return cls(
            config=m,
            n=n,
            mobility=jnp.full((n,), m.core_mobility, jnp.float32),
            bond_pairs=chain_bond_pairs(chains),
            triples=bending_triples(chains, m.penalize_centromere_bending),
            kinetochores=jnp.asarray(kinetochores),
            kfiber_springs=jnp.asarray(kf, jnp.float32),
            pole=jnp.asarray(pole, jnp.float32),
        )

    def forces(self, positions, telophase: bool, with_energy=False):
        m = self.config
        energy = jnp.asarray(0.0, positions.dtype)

        def rep_c(r2, i, j):
            return pot.softcore_force_coeff(r2, m.core_repulsion, m.core_diameter, 2, 3)

        def rep_u(r2, i, j):
            return pot.softcore_energy(r2, m.core_repulsion, m.core_diameter, 2, 3)

        forces, e = pairwise_forces_dense(
            positions, rep_c, rep_u if with_energy else None
        )
        energy += e

        bond_k = m.bond_spring * (m.telophase_bond_spring_multiplier if telophase else 1.0)
        f, e = pair_bond_forces(
            positions,
            self.bond_pairs,
            lambda r2: pot.semispring_energy(r2, bond_k, m.bond_length),
            lambda r2: pot.semispring_force_coeff(r2, bond_k, m.bond_length),
        )
        forces, energy = forces + f, energy + e

        bend_e = m.bending_energy * (
            m.telophase_bending_energy_multiplier if telophase else 1.0
        )
        f, e = bending_forces(positions, self.triples, bend_e)
        forces, energy = forces + f, energy + e

        if telophase:
            # Packing well keeps the decondensing chromosomes together
            # (simulation_driver.cpp:175-189).
            f, e = point_source_forces(
                positions,
                jnp.zeros(3, positions.dtype),
                lambda r2: pot.semispring_energy(
                    r2, m.telophase_packing_spring, m.telophase_packing_radius
                ),
                lambda r2: pot.semispring_force_coeff(
                    r2, m.telophase_packing_spring, m.telophase_packing_radius
                ),
            )
            forces, energy = forces + f, energy + e
        else:
            # Anaphase kinetochore dragging toward the shifted pole.
            f, e = kfiber_forces(
                positions,
                self.kinetochores,
                self.pole,
                self.kfiber_springs,
                jnp.asarray(self.config.kfiber_length_anaphase, positions.dtype),
            )
            forces, energy = forces + f, energy + e

        return forces, energy

    def step(self, carry, step, telophase: bool):
        x, key = carry
        m = self.config
        forces, _ = self.forces(x, telophase)
        key, sub = jax.random.split(key)
        x = bd_update(x, forces, self.mobility, sub, BDParams(m.temperature, m.timestep))
        return (x, key)

    def initial_rods(self, rng: np.random.Generator, chains) -> np.ndarray:
        """Randomly-directed rods from Gaussian-displaced centroids at
        -spindle_axis (simulation_driver.cpp:221-237)."""
        m = self.config
        positions = np.zeros((self.n, 3))
        start_center = -np.asarray(m.spindle_axis)
        for chain in chains:
            centroid = start_center + m.anaphase_start_stddev * rng.normal(size=3)
            direction = rng.normal(size=3)
            step_vec = m.bond_length * direction / np.linalg.norm(direction)
            length = chain.end - chain.start
            pos = centroid - step_vec * length / 2
            for i in range(chain.start, chain.end):
                positions[i] = pos
                pos = pos + step_vec
        return positions


def run_anatelophase(store: SimulationStore, log=print):
    config = store.load_config()
    design = store.load_anatelophase_design()
    model = AnatelophaseModel.from_design(design, config)
    m = model.config

    rng = np.random.default_rng(design.seed)
    key = jax.random.PRNGKey(design.seed)
    key, ana_key, telo_key = jax.random.split(key, 3)

    store.set_stage("anaphase")
    store.clear_frames()

    # Initial structure may be stored (cycle continuation)
    # (simulation_driver.cpp:211-219); otherwise random rods.
    if store.check_positions(0):
        x0 = store.load_positions(0)
        if x0.shape[0] != model.n:
            raise ValueError("initial structure size mismatch")
    else:
        x0 = model.initial_rods(rng, design.chains)
    x = jnp.asarray(x0, jnp.float32)

    energy_fn = {
        phase: jax.jit(lambda p, ph=phase: model.forces(p, ph, with_energy=True)[1])
        for phase in (False, True)
    }

    def run_phase(stage: str, telophase: bool, steps: int, x, key):
        store.set_stage(stage)
        store.clear_frames()
        chunk = jax.jit(
            lambda carry: jax.lax.scan(
                lambda cr, s: (model.step(cr, s, telophase), None),
                carry,
                jnp.arange(m.sampling_interval),
            )[0]
        )
        store.save_positions(0, np.asarray(x))
        store.append_frame(0)
        log(
            progress_line(
                stage, 0, energy=float(energy_fn[telophase](x)) / model.n
            )
        )
        carry = (x, key)
        for c in range(steps // m.sampling_interval):
            carry = chunk(carry)
            step = (c + 1) * m.sampling_interval
            store.save_positions(step, np.asarray(carry[0]))
            store.append_frame(step)
            if step % m.logging_interval == 0:
                log(
                    progress_line(
                        stage, step,
                        energy=float(energy_fn[telophase](carry[0])) / model.n,
                    )
                )
        return carry

    (x, _) = run_phase("anaphase", False, m.anaphase_steps, x, ana_key)
    (x, _) = run_phase("telophase", True, m.telophase_steps, x, telo_key)
    log("Finished.")
    return np.asarray(x)
