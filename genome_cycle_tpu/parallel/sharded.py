"""Spatially sharded + replica-parallel interphase stepping via shard_map.

One full G1 training step over a ("replica", "beads") mesh:

- positions are replicated across the beads axis (N*3 f32 per replica — an
  all-gather of this size per step over the cards' interconnect);
- each device computes the expensive O(N·nbr) pairwise + wall forces ONLY for
  its owned row block of beads (the compute that dominates), while O(N)
  bonded forces are computed redundantly (cheaper than communicating them);
- wall axial reaction reduces over the beads axis with psum before the wall
  ODE (identical on all shards of a replica);
- contact-list rows are owned by the device that owns the beads, so contact
  accumulation is sharded with zero communication;
- replicas never communicate (independent cells of the ensemble).

This mirrors SURVEY.md §5.7's spatial-decomposition design at the
"replicated positions, sharded compute" point of the design space — the
right regime for N up to ~10^6 beads where positions fit every device and
the all-gather is tiny compared to pair computation.  True halo exchange
(ppermute of boundary cells only) is the next step beyond this.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..models.interphase import InterphaseModel
from ..ops.contact import ContactList, build_contact_list, update_contact_counts
from ..ops.integrator import BDParams, bd_update
from ..ops.neighbor import build_cell_table


class ShardedCarry(NamedTuple):
    positions: jnp.ndarray      # (R, N, 3) sharded P("replica",)
    key: jnp.ndarray            # (R,) typed PRNG keys, P("replica",)
    semiaxes: jnp.ndarray       # (R, 3) P("replica",)
    contact_ids: jnp.ndarray    # (R, N, C) P("replica", "beads")
    contact_counts: jnp.ndarray # (R, N, C) P("replica", "beads")
    overflow: jnp.ndarray       # (R,) int32 P("replica",)


def carry_specs() -> ShardedCarry:
    return ShardedCarry(
        positions=P("replica", None, None),
        key=P("replica"),
        semiaxes=P("replica", None),
        contact_ids=P("replica", "beads", None),
        contact_counts=P("replica", "beads", None),
        overflow=P("replica"),
    )


def make_sharded_interphase_step(model: InterphaseModel, mesh: Mesh):
    """Build a jitted (carry, step) -> carry function over the mesh."""
    c = model.config
    n = model.n
    n_shards = mesh.shape["beads"]
    if n % n_shards != 0:
        raise ValueError(f"bead count {n} not divisible by {n_shards} shards")
    rows = n // n_shards
    dt = c.timestep
    spring = jnp.asarray(c.wall_semiaxes_spring, jnp.float32)

    def replica_step(pos, key, semiaxes, cids, ccounts, step):
        """Single-replica step; runs on one device with that device's rows."""
        shard = jax.lax.axis_index("beads")
        offset = shard * rows
        core_scale, bond_scale = model.scales((step - 1).astype(pos.dtype) * dt)

        table, ov, _ = build_cell_table(model.grid, pos)

        q_pos = jax.lax.dynamic_slice(pos, (offset, 0), (rows, 3))
        q_ids = offset + jnp.arange(rows, dtype=jnp.int32)

        pair_f, _ = model.pair_forces_rows(
            pos, table, core_scale, query=(q_pos, q_ids)
        )
        bonded_f, _ = model.bonded_forces(pos, bond_scale)
        bonded_rows = jax.lax.dynamic_slice(bonded_f, (offset, 0), (rows, 3))
        wall_f, reaction_rows, _ = model.wall_forces_rows(
            q_pos, q_ids, semiaxes, core_scale
        )
        reaction = jax.lax.psum(reaction_rows, "beads")
        force_rows = pair_f + bonded_rows + wall_f

        # Per-device noise stream: fold in the shard index so row blocks
        # draw independent noise.
        step_key = jax.random.fold_in(jax.random.fold_in(key, step), shard)
        mob_rows = jax.lax.dynamic_slice(model.mobility, (offset,), (rows,))
        new_rows = bd_update(
            q_pos, force_rows, mob_rows, step_key, BDParams(c.temperature, dt)
        )
        pos = jax.lax.all_gather(new_rows, "beads", axis=0, tiled=True)

        # Contact update on owned rows.
        core_now, _ = model.scales(step.astype(pos.dtype) * dt)
        new_q = jax.lax.dynamic_slice(pos, (offset, 0), (rows, 3))
        contact = ContactList(
            ids=cids, counts=ccounts, fill=jnp.zeros((rows,), jnp.int32),
            overflow=jnp.zeros((), jnp.int32),
            ref_pos=new_q, drift2=jnp.zeros((), pos.dtype),
        )
        contact = jax.lax.cond(
            step % c.contactmap_update_interval == 0,
            lambda ct: update_contact_counts(
                ct, pos, c.contactmap_distance * core_now, q_pos=new_q
            ),
            lambda ct: ct,
            contact,
        )

        semiaxes = semiaxes + dt * c.wall_mobility * (reaction - spring * semiaxes)
        return pos, semiaxes, contact.ids, contact.counts, ov

    def step_body(positions, key, semiaxes, cids, ccounts, overflow, step):
        # Leading axis: replica block owned by this device.
        pos, semi, ids, counts, ov = jax.vmap(
            replica_step, in_axes=(0, 0, 0, 0, 0, None)
        )(positions, key, semiaxes, cids, ccounts, step)
        return pos, key, semi, ids, counts, jnp.maximum(overflow, ov)

    specs = carry_specs()
    sharded = shard_map(
        step_body,
        mesh=mesh,
        in_specs=(*specs, P()),
        out_specs=tuple(specs),
        check_vma=False,
    )

    @jax.jit
    def step(carry: ShardedCarry, step_index) -> ShardedCarry:
        out = sharded(*carry, jnp.asarray(step_index, jnp.int32))
        return ShardedCarry(*out)

    return step


def make_sharded_chunk(model: InterphaseModel, mesh: Mesh, chunk_steps: int):
    """Scan the sharded step over a chunk of steps (the jit unit)."""
    c = model.config
    n = model.n
    n_shards = mesh.shape["beads"]
    rows = n // n_shards
    single = make_sharded_interphase_step(model, mesh)

    @jax.jit
    def chunk(carry: ShardedCarry, start):
        def body(cr, s):
            return single(cr, s), None

        carry, _ = jax.lax.scan(
            body, carry, start + 1 + jnp.arange(chunk_steps)
        )
        return carry

    return chunk


def init_sharded_carry(
    model: InterphaseModel, mesh: Mesh, positions, seeds, semiaxes
) -> ShardedCarry:
    """Build a device-sharded carry from per-replica host arrays.

    ``positions``: (R, N, 3); ``seeds``: (R,) ints; ``semiaxes``: (R, 3).
    The contact list is built per replica at the current positions.
    """
    n_shards = mesh.shape["beads"]
    r = positions.shape[0]
    cap = model.settings.contact_capacity
    rows = model.n // n_shards

    pos = jnp.asarray(positions, jnp.float32)
    keys = jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds, jnp.uint32))

    core0, _ = model.scales(jnp.asarray(0.0))
    cutoff = float(
        model.config.contactmap_distance * core0 + model.settings.contact_margin
    )

    def build_replica(p):
        table, _, _ = build_cell_table(model.margin_grid, p)
        contact = build_contact_list(
            model.margin_grid, table, p, cutoff, cap
        )
        return contact.ids, contact.counts

    ids, counts = jax.vmap(build_replica)(pos)

    carry = ShardedCarry(
        positions=pos,
        key=keys,
        semiaxes=jnp.asarray(semiaxes, jnp.float32),
        contact_ids=ids,
        contact_counts=counts,
        overflow=jnp.zeros((r,), jnp.int32),
    )
    specs = carry_specs()
    from .mesh import shard_to_mesh

    return ShardedCarry(
        *(shard_to_mesh(arr, mesh, spec) for arr, spec in zip(carry, specs))
    )
