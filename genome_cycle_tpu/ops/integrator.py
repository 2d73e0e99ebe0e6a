"""Overdamped Langevin (Brownian dynamics) integration.

JAX replacement for ``md::simulate_brownian_dynamics`` (SURVEY.md
§2.9): an Euler-Maruyama update

    x += mu * F * dt + sqrt(2 * mu * kT * dt) * xi,   xi ~ N(0, 1)

with per-particle mobility mu, threaded through counter-based threefry keys
(explicit PRNG-key discipline instead of the reference's seeded mt19937).

``spacestep`` reproduces micromd's displacement-limited stepping used by the
interphase relaxation (simulation_driver_relaxation.cpp:48-55): the effective
timestep of a step is scaled down so the largest deterministic displacement
|mu F| dt does not exceed ``spacestep`` (noise scales with sqrt(dt_eff)
accordingly), defusing huge forces in fresh spline-resampled structures.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp


class BDParams(NamedTuple):
    temperature: float
    timestep: float
    spacestep: Optional[float] = None


def bd_update(positions, forces, mobility, key, params: BDParams):
    """One Euler-Maruyama step; returns new positions."""
    dtype = positions.dtype
    dt = jnp.asarray(params.timestep, dtype)
    drift_vel = mobility[:, None] * forces  # mu F
    if params.spacestep is not None:
        max_disp = jnp.max(jnp.linalg.norm(drift_vel, axis=-1)) * dt
        scale = jnp.minimum(1.0, params.spacestep / jnp.maximum(max_disp, 1e-30))
        dt = dt * scale
    sigma = jnp.sqrt(2.0 * params.temperature * mobility * dt)
    noise = jax.random.normal(key, positions.shape, dtype)
    return positions + drift_vel * dt + sigma[:, None] * noise


def run_chunk(
    step_fn: Callable,
    carry,
    start_step: int,
    num_steps: int,
):
    """Scan ``step_fn(carry, step_index) -> carry`` over a chunk of steps.

    Stage drivers jit-compile one chunk (typically ``sampling_interval``
    steps) and loop chunks host-side, keeping HDF5 I/O out of jit while the
    entire hot loop stays on device (SURVEY.md §7).
    """
    steps = start_step + jnp.arange(num_steps)

    def body(c, step):
        return step_fn(c, step), None

    carry, _ = jax.lax.scan(body, carry, steps)
    return carry
