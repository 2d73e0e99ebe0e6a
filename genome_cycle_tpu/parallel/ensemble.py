"""Ensemble replica axis: many independent cell-cycle simulations at once.

The reference runs ensemble replicas as separate shell jobs over separate
trajectory files and merges their contact maps downstream
(src/cool.py:80-110; SURVEY.md §2.11).  Here the replica axis is a real
data-parallel axis: R independent interphase systems integrate in lock-step
in one jitted program (vmap over the replica dimension), each still writing
its own reference-schema trajectory file so the downstream analysis
(cool/dephase/pc1) is unchanged.

Robustness matches the single-store driver: chunks that overflow a cell,
contact-row, or event capacity — or whose drift exceeds the contact margin —
are re-run with the grown setting via the same ``_AdaptiveEngine`` (results
never silently drop pairs), and the scan carry checkpoints at contact-window
boundaries so a killed run resumes without recomputing or double-counting.

Pass ``mesh`` (with a "replica" axis) to shard replicas across devices: the
carry is device_put with a replica-axis sharding and XLA partitions the
vmapped program — replicas never communicate, so this scales linearly.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.interphase import (
    SCALE_VIOLATION,
    ChunkStats,
    EngineSettings,
    _AdaptiveEngine,
)
from ..ops.contact import (
    contact_list_to_host,
    empty_window_acc,
    events_to_host,
    merge_events_acc,
    merge_window,
    update_contact_counts,
)
from ..store import InterphaseContext, SimulationStore
from ..utils.logging import progress_line


def run_ensemble_interphase(
    stores: Sequence[SimulationStore],
    settings: Optional[EngineSettings] = None,
    mesh: Optional[Mesh] = None,
    log=print,
):
    """Run the interphase stage for R replicas in lock-step.

    All stores must come from the same ``prepare`` inputs (identical
    topology); each keeps its own stage seed, so trajectories are
    independent samples.  Relaxation initial structures must already be in
    place (``transition interphase`` per store).
    """
    r = len(stores)
    if r == 0:
        return

    config = stores[0].load_config()
    designs = [s.load_interphase_design() for s in stores]
    n = designs[0].particle_count
    for d in designs[1:]:
        if d.particle_count != n:
            raise ValueError("ensemble stores disagree on topology")

    engine = _AdaptiveEngine(designs[0], config, settings, log)
    c = config.interphase
    sampling = c.sampling_interval
    window_steps = sampling * c.contactmap_output_window

    def shard_replicas(tree):
        if mesh is None:
            return tree
        return jax.tree.map(
            lambda a: jax.device_put(
                a,
                NamedSharding(mesh, P("replica", *([None] * (a.ndim - 1)))),
            ),
            tree,
        )

    # Probe the densest cell across replicas up front (each adaptive retry
    # costs a compile + a slow chunk).
    positions = jnp.stack(
        [jnp.asarray(s_store_positions(s), jnp.float32) for s in stores]
    )
    for k in range(r):
        engine.probe_capacity(positions[k])
        engine.update_bound(float(np.abs(np.asarray(positions[k])).max()))
    engine.update_cell_scale(c.core_scale_init)

    keys = jnp.stack(
        [jax.random.split(jax.random.PRNGKey(d.seed), 3)[2] for d in designs]
    )
    relax_keys = jnp.stack(
        [jax.random.split(jax.random.PRNGKey(d.seed), 3)[1] for d in designs]
    )
    semiaxes = jnp.tile(jnp.asarray(c.wall_semiaxes_init, jnp.float32), (r, 1))

    # Vmapped chunk builders, cached per engine bundle (capacity change =>
    # new model => new compile; revisiting a capacity is free).
    vm_cache: dict = {}

    def vm_bundle(relax: bool = False):
        bundle = engine.bundle(relax=relax)
        model = bundle["model"]
        cache_key = (id(model), relax)
        if cache_key not in vm_cache:
            if relax:
                def one(x, key, semi):
                    stats = (jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32))
                    (x, key, semi, stats), _ = jax.lax.scan(
                        lambda cr, s: (model.relaxation_step(cr, s), None),
                        (x, key, semi, stats),
                        jnp.arange(c.relaxation_sampling_interval),
                    )
                    return x, key, semi, stats

                vm_cache[cache_key] = jax.jit(jax.vmap(one))
            else:
                seg_len = model.rebuild_interval(sampling)
                segment = model.interphase_segment(seg_len)
                n_segments = sampling // seg_len

                def one_segment(x, key, semi, stats, start):
                    carry, ev = segment((x, key, semi, stats), start)
                    return (*carry, ev)

                # One jitted vmapped segment; segments dispatched from a
                # host loop, the structure the single-replica chunk uses
                # at large N (InterphaseModel.make_interphase_chunk).
                vseg = jax.jit(jax.vmap(one_segment, in_axes=(0, 0, 0, 0, None)))

                def chunk(x, key, semi, start):
                    stats = jax.tree.map(
                        lambda a: jnp.broadcast_to(a, (r,) + a.shape),
                        ChunkStats.zero(x.dtype),
                    )
                    events = []
                    start = jnp.asarray(start, jnp.int32)
                    for k in range(n_segments):
                        x, key, semi, stats, ev = vseg(
                            x, key, semi, stats, start + k * seg_len
                        )
                        events.append(ev)
                    return x, key, semi, stats, jnp.stack(events, axis=1)

                vm_cache[cache_key] = chunk
        return vm_cache[cache_key], model

    # ---- relaxation (vmapped, adaptive) -------------------------------------
    for store in stores:
        store.set_stage("relaxation")
        store.clear_frames()

    def sample_relax(step, positions):
        for k, store in enumerate(stores):
            store.save_positions(step, np.asarray(positions[k]))
            store.save_interphase_context(
                step,
                InterphaseContext(
                    time=0.0,
                    wall_semiaxes=tuple(float(v) for v in np.asarray(semiaxes[k])),
                    core_scale=c.core_scale_init,
                    bond_scale=c.bond_scale_init,
                ),
            )
            store.append_frame(step)

    sample_relax(0, positions)
    x, rkeys, semis = shard_replicas((positions, relax_keys, semiaxes))
    for chunk in range(c.relaxation_steps // c.relaxation_sampling_interval):
        while True:
            relax_chunk, _ = vm_bundle(relax=True)
            x2, rk2, s2, stats = relax_chunk(x, rkeys, semis)
            if int(np.max(np.asarray(stats[0]))) > 0:
                engine.grow_cells(int(np.max(np.asarray(stats[1]))))
                continue
            break
        x, rkeys, semis = x2, rk2, s2
        step = (chunk + 1) * c.relaxation_sampling_interval
        sample_relax(step, x)
        log(progress_line("relaxation", step, t=0.0))
    positions = x

    # ---- interphase (vmapped, adaptive, checkpointed) ------------------------
    for store in stores:
        store.set_stage("interphase")

    # Resume only when every store holds a checkpoint at the same window
    # boundary (windows flush there, so no contact is double-counted).
    checkpoints = [s.load_checkpoint() for s in stores]
    resume_step = 0
    if all(cp is not None for cp in checkpoints):
        steps_at = {int(cp["step"]) for cp in checkpoints}
        if len(steps_at) == 1 and 0 < next(iter(steps_at)) < c.steps:
            resume_step = next(iter(steps_at))
            log(f"resuming ensemble interphase from step {resume_step}")

    if resume_step:
        positions = jnp.stack(
            [jnp.asarray(cp["positions"], jnp.float32) for cp in checkpoints]
        )
        semiaxes = jnp.stack(
            [jnp.asarray(cp["semiaxes"], jnp.float32) for cp in checkpoints]
        )
        keys = jnp.stack(
            [jnp.asarray(cp["key"], jnp.uint32) for cp in checkpoints]
        )
        for store in stores:
            store.truncate_frames(resume_step)
    else:
        for store in stores:
            store.clear_frames()
        # callback(0) semantics of the reference / single-store driver:
        # sample frame 0, one contact update, dump-and-clear the step-0
        # window, then a reaction-free wall update before step 1.
        _, model0 = vm_bundle()
        core0, _ = model0.scales(jnp.asarray(0.0))
        if model0.block_grid is not None:
            # Block tick for the step-0 dump (the margin fold's lanes scale
            # with the skew-probed cell capacity; see run_interphase).
            tick0 = jax.jit(
                lambda q: model0.contact_events_tick(q, jnp.asarray(0))
            )
        for k, store in enumerate(stores):
            if model0.block_grid is not None:
                ev0, _, _, _ = tick0(positions[k])
                coo0 = merge_window([events_to_host(np.asarray(ev0))])
            else:
                contact0 = update_contact_counts(
                    model0.fresh_contact_list(positions[k], float(core0)),
                    positions[k],
                    c.contactmap_distance * float(core0),
                )
                coo0 = merge_window([contact_list_to_host(contact0)])
            store.save_positions(0, np.asarray(positions[k]))
            store.save_interphase_context(
                0,
                InterphaseContext(
                    time=0.0,
                    wall_semiaxes=tuple(
                        float(v) for v in np.asarray(semiaxes[k])
                    ),
                    core_scale=float(core0),
                    bond_scale=float(model0.scales(jnp.asarray(0.0))[1]),
                ),
            )
            store.save_contacts(0, coo0)
            store.append_frame(0)
        spring = jnp.asarray(c.wall_semiaxes_spring, jnp.float32)
        semiaxes = semiaxes + c.timestep * c.wall_mobility * (
            0.0 - spring * semiaxes
        )

    # Per-replica contact windows accumulate ON DEVICE (one vmapped
    # sort-dedup per chunk, ops/contact.merge_events_acc); only the merged
    # COO crosses to the host at dump boundaries — raw tick events at
    # production size cost ~22 ms/step over the device link.
    vmerge = jax.jit(jax.vmap(merge_events_acc))

    def fresh_acc():
        a, n0 = empty_window_acc(engine.acc_capacity)
        return (
            shard_replicas(jnp.broadcast_to(a, (r,) + a.shape)),
            shard_replicas(jnp.broadcast_to(n0, (r,))),
        )

    acc, acc_n = fresh_acc()
    x, keys_c, semis = shard_replicas((positions, keys, semiaxes))

    for chunk in range(resume_step // sampling, c.steps // sampling):
        start = chunk * sampling
        while True:
            inter_chunk, model = vm_bundle()
            x2, k2, s2, stats, events = inter_chunk(
                x, keys_c, semis, jnp.asarray(start)
            )
            watermark = int(np.max(np.asarray(stats.cell_fill)))
            cell_ov = int(np.max(np.asarray(stats.cell_overflow)))
            if cell_ov > 0:
                engine.handle_pair_overflow(cell_ov, watermark)
                continue
            if int(np.max(np.asarray(stats.contact_overflow))) > 0:
                engine.grow_contacts()
                continue
            contact_cell_ov = int(np.max(np.asarray(stats.contact_cell_overflow)))
            if contact_cell_ov >= SCALE_VIOLATION:
                # Legacy path stencil invariant: the tick cutoff outgrew the
                # search cell — re-bucket the cell scale (capacity is the
                # wrong knob and would double forever).
                engine.force_contact_scale(1.0)
                continue
            if contact_cell_ov > 0:
                if engine.block:
                    # Block path: this channel is the tick's window-width /
                    # slot overflow — same knobs as the pair engine.
                    engine.handle_pair_overflow(contact_cell_ov, watermark)
                else:
                    engine.grow_contact_cells(model)
                continue
            if int(np.max(np.asarray(stats.event_overflow))) > 0:
                engine.grow_events(model)
                continue
            drift = float(np.sqrt(np.max(np.asarray(stats.drift2))))
            if drift > engine.contact_margin / 2:
                engine.handle_drift()
                continue
            break
        x, keys_c, semis = x2, k2, s2
        engine.shrink_cells_if_idle(int(np.max(np.asarray(stats.cell_fill))))
        engine.shrink_events_if_idle(
            model, int(np.max(np.asarray(stats.event_overflow)))
        )
        step = start + sampling
        core_next, _ = model.scales(jnp.asarray((start + 2 * sampling) * c.timestep))
        engine.update_cell_scale(float(core_next))

        while True:
            acc2, acc_n2, acc_ov = vmerge(acc, acc_n, events)
            deficit = int(np.max(np.asarray(acc_ov)))
            if deficit > 0:
                engine.grow_acc(deficit)
                ext, _ = empty_window_acc(
                    engine.acc_capacity - acc.shape[1]
                )
                acc = jnp.concatenate(
                    [acc, shard_replicas(
                        jnp.broadcast_to(ext, (r,) + ext.shape)
                    )],
                    axis=1,
                )
                continue
            acc, acc_n = acc2, acc_n2
            break

        dump = step % window_steps == 0
        core, bond = model.scales(jnp.asarray(step * c.timestep))
        for i, store in enumerate(stores):
            ctx = InterphaseContext(
                time=step * c.timestep,
                wall_semiaxes=tuple(float(v) for v in np.asarray(semis[i])),
                core_scale=float(core),
                bond_scale=float(bond),
            )
            store.save_positions(step, np.asarray(x[i]))
            store.save_interphase_context(step, ctx)
            if dump:
                store.save_contacts(
                    step, np.asarray(acc[i, : int(acc_n[i])])
                )
            store.append_frame(step)

        if dump:
            acc, acc_n = fresh_acc()
            for i, store in enumerate(stores):
                store.save_checkpoint(
                    step,
                    {
                        "positions": np.asarray(x[i]),
                        "semiaxes": np.asarray(semis[i]),
                        "key": np.asarray(keys_c[i]),
                    },
                )

        if step % c.logging_interval == 0:
            log(progress_line("interphase", step, t=step * c.timestep))

    for store in stores:
        store.clear_checkpoint()
    return np.asarray(x)


def s_store_positions(store: SimulationStore) -> np.ndarray:
    store.set_stage("relaxation")
    return store.load_positions(0)
