"""Chip smoke test: the genome-cycle main path once on a GPU, at full width.

    python chip_smoke.py                 # one card
    python chip_smoke.py --four-cards    # interphase --shards 4 and its check

One card (the default) runs, in this one process:

a. the device gate: JAX's default device must be a GPU, else the script
   exits non-zero before any work;
b. one whole cell cycle of the reference-default deployment, the hg38
   diploid genome at 100 kb/bead (59,610 interphase particles,
   examples/hg38_chains_100kb.tsv), with the reference-default force field
   and step counts cut to :data:`STEP_CUTS` — the calls ``cli cycles -n 1``
   makes: prepare, anaphase/telophase, spline transition, relaxation + G1
   with contact maps, prometaphase transition, prometaphase.  The trajectory
   is an HDF5 file when h5py imports, else an in-memory store
   (:class:`genome_cycle_tpu.store.MemoryFile`); either way it is checked
   through ``SimulationStore``'s own loaders;
c. the sorted-block pair engine, as compiled for the card, against its plain
   references on the post-G1 structure: the gather-fold oracle (forces and
   the contact set) and the O(N^2) dense path on a random 4096-bead subset.

``--four-cards`` prepares the same input (through the spline transition)
and runs only the G1 halo decomposition: ``interphase --shards 4`` and one
zero-temperature halo segment against the single-device segment from the
same positions.

Informational lines go to standard output as phases finish; the last line
is one JSON object, ``{"ok": true, "device": {...}}``, printed only when
every phase passed.  Any failure raises, and the exit code is non-zero.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent
CHAINS = REPO / "examples" / "hg38_chains_100kb.tsv"
PARTICLES = 59_610  # 59,590 chain beads + 20 nucleolar particles

# The reference default (an empty config: simulation_config.hpp:15-115) with
# only the step counts cut, so that one whole cycle fits a smoke run.  Two
# G1 sampling chunks with a contact window each.
STEP_CUTS = {
    "mitotic_phase": {
        "anaphase_steps": 2000,
        "telophase_steps": 1000,
        "prometaphase_steps": 2000,
        "sampling_interval": 1000,
    },
    "interphase": {
        "relaxation_steps": 1000,
        "steps": 2000,
        "sampling_interval": 1000,
        "contactmap_output_window": 1,
    },
}

# Pair forces: max |F - F_ref| over max |F_ref|.  Both sides sum the same
# float32 pair terms in different orders (per-window reductions here, per
# stencil-cell folds in the oracle; XLA's GPU reductions do not fix their
# order), so each bead's sum of a few tens of terms carries ~1e-6 relative
# error.  A missed or double-counted pair shows at 1e-2 or more.
FORCE_RTOL = 1e-4
# Contact sets: a pair may be in one set and not the other only when its
# distance lies within this of the cutoff (float32 rounding of r^2).
CONTACT_EPS = 1e-5
# Halo vs single device, one 20-step segment at zero temperature: max
# |x_halo - x_single| in length units (positions are O(1)); the two
# engines sum forces in different orders for 20 steps.
HALO_POS_ATOL = 1e-4
HALO_SEGMENT = 20
SUBSET = 4096


def cut_config() -> dict:
    return json.loads(json.dumps(STEP_CUTS))


def last_line(device: dict) -> str:
    return json.dumps(
        {
            "ok": True,
            "device": {
                "platform": device["platform"],
                "kind": device["kind"],
                "count": device["count"],
            },
        }
    )


def _imports(name: str) -> bool:
    try:
        __import__(name)
        return True
    except ImportError:
        return False


class Log:
    """Stage logger that keeps (time, message) pairs for later reduction."""

    def __init__(self, echo=True):
        self.lines: list[tuple[float, str]] = []
        self.echo = echo

    def __call__(self, message: str):
        self.lines.append((time.perf_counter(), message))
        if self.echo:
            print(message, file=sys.stderr, flush=True)

    def engine_changes(self) -> int:
        """Adaptive-engine changes; each one compiles a new chunk."""
        return sum(m.startswith("engine: ") for _, m in self.lines)

    def steady_g1_rate(self, n: int, compiles: "CompileCounter"):
        """Bead-steps/s between the last two G1 progress lines (the first
        G1 chunk carries the first compiles), less the compile seconds
        that fell inside that window (adaptive recompiles)."""
        marks = []
        for t, m in self.lines:
            if m.startswith("[interphase]"):
                marks.append((t, int(m.split("\t")[1])))
        if len(marks) < 3:
            return None
        (t1, s1), (t2, s2) = marks[-2], marks[-1]
        return n * (s2 - s1) / (t2 - t1 - compiles.seconds_between(t1, t2))


class CompileCounter:
    """Programs built (compiled, or loaded from the persistent cache) and
    the seconds spent tracing, lowering and compiling them, through
    jax.monitoring."""

    BUILD = "/jax/core/compile/backend_compile_duration"
    CACHE_HIT = "/jax/compilation_cache/cache_hits"

    def __init__(self):
        from jax import monitoring

        self.count = 0
        self.cache_hits = 0
        self._steps: list[tuple[float, float]] = []  # (end time, seconds)
        monitoring.register_event_duration_secs_listener(self._on_duration)
        monitoring.register_event_listener(self._on_event)

    def _on_duration(self, name, seconds, **_):
        if name.startswith("/jax/core/compile/"):
            self._steps.append((time.perf_counter(), seconds))
            self.count += name == self.BUILD

    def _on_event(self, name, **_):
        self.cache_hits += name == self.CACHE_HIT

    @property
    def seconds(self) -> float:
        return sum(s for _, s in self._steps)

    def seconds_between(self, t1: float, t2: float) -> float:
        return sum(s for t, s in self._steps if t1 < t <= t2)


def say(tag: str, card: str, **fields):
    """One informational line, with the card beside every number."""
    print(json.dumps({"phase": tag, "card": card, **fields}), flush=True)


# -- b. main path -------------------------------------------------------------


def write_config(out: pathlib.Path) -> pathlib.Path:
    path = out / "config.json"
    path.write_text(json.dumps(cut_config(), indent=1))
    return path


def prepare_target(out: pathlib.Path, use_hdf5: bool):
    from genome_cycle_tpu.store import MemoryFile

    return str(out / "smoke_cell_0.h5") if use_hdf5 else MemoryFile()


def run_main_path(target, config_path, chains, log) -> dict:
    """prepare + every stage of one cycle; returns wall seconds per stage."""
    from genome_cycle_tpu.cli import run_cell_cycle
    from genome_cycle_tpu.models.prepare import run_prepare
    from genome_cycle_tpu.store import SimulationStore

    t0 = time.perf_counter()
    run_prepare(target, str(config_path), str(chains), seed=1, log=log)
    seconds = {"prepare": time.perf_counter() - t0}
    with SimulationStore(target) as store:
        seconds.update(run_cell_cycle(store, log=log))
    return seconds


CYCLE_STAGES = ("anaphase", "telophase", "relaxation", "interphase",
                "prometaphase")


def check_store(store, particles: int | None, stages=CYCLE_STAGES) -> dict:
    """The store checks of phase b, through SimulationStore's loaders:
    the particle count, finite positions in every saved frame of
    ``stages``, and a non-empty contact map in every G1 window."""
    import numpy as np

    config = store.load_config()
    design = store.load_interphase_design()
    n = design.particle_count
    if particles is not None and n != particles:
        raise AssertionError(f"{n} interphase particles, expected {particles}")
    frames = {}
    for stage in stages:
        store.set_stage(stage)
        steps = store.load_steps()
        if not steps:
            raise AssertionError(f"no {stage} frames")
        for step in steps:
            x = store.load_positions(step)
            if x.ndim != 2 or x.shape[1] != 3 or not np.isfinite(x).all():
                raise AssertionError(f"{stage} step {step}: bad positions")
        frames[stage] = len(steps)
    store.set_stage("interphase")
    ic = config.interphase
    window = ic.sampling_interval * ic.contactmap_output_window
    contacts = {}
    for step in store.load_steps():
        if step % window == 0:
            coo = store.load_contacts(step)
            if coo is None or len(coo) == 0:
                raise AssertionError(f"empty contact map at step {step}")
            contacts[step] = int(len(coo))
    return {"particles": n, "frames": frames, "contact_pairs": contacts}


# -- c. parity at real width --------------------------------------------------


def parity_models(design, config, x):
    """(block model, gather-fold oracle) sized from the structure ``x``."""
    import numpy as np

    from genome_cycle_tpu.models.interphase import (
        EngineSettings, InterphaseModel, _AdaptiveEngine,
    )

    engine = _AdaptiveEngine(design, config, None, lambda *_: None)
    engine.update_bound(float(np.abs(x).max()))
    engine.probe_capacity(x)
    base = EngineSettings.auto(design.particle_count, config.interphase)
    block = dataclasses.replace(
        base,
        use_block_pairs=True,
        brute_force_threshold=0,
        block_width=engine.block_width,
        block_slots=engine.block_slots,
        dense_bound=engine.dense_bound,
        contact_events_capacity=16 * design.particle_count,
    )
    oracle = dataclasses.replace(
        base,
        use_block_pairs=False,
        use_dense_grid=False,
        cell_capacity=engine.cell_capacity,
        contact_capacity=256,
        contact_events_capacity=16 * design.particle_count,
    )
    return (
        InterphaseModel.from_design(design, config, block),
        InterphaseModel.from_design(design, config, oracle),
    )


def force_parity(model_block, model_oracle, x, core_scale) -> dict:
    """Block engine vs gather-fold oracle: the A/B pair force on ``x``."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    x = jnp.asarray(x, jnp.float32)

    def pair(model):
        return jax.jit(lambda q: model.pair_forces_full(q, core_scale))(x)

    f, _, ov, _ = pair(model_block)
    f_ref, _, ov_ref, _ = pair(model_oracle)
    if int(ov) or int(ov_ref):
        raise AssertionError(f"pair engine overflow: block {int(ov)}, "
                             f"oracle {int(ov_ref)}")
    f, f_ref = np.asarray(f, np.float64), np.asarray(f_ref, np.float64)
    scale = float(np.abs(f_ref).max())
    err = float(np.abs(f - f_ref).max()) / scale
    return {"max_rel_err": err, "max_abs_force": scale, "tol": FORCE_RTOL,
            "pass": err <= FORCE_RTOL}


def dense_subset_parity(model_block, x, core_scale, size=SUBSET,
                        seed=0) -> dict:
    """Block engine vs the O(N^2) dense path, both restricted to a random
    subset of beads (``pairwise_forces_dense(targets=...)``)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from genome_cycle_tpu.ops import potentials as pot
    from genome_cycle_tpu.ops.block_pairs import (
        block_pair_forces, build_structure,
    )
    from genome_cycle_tpu.ops.neighbor import pairwise_forces_dense

    n = model_block.n
    sub = np.sort(np.random.default_rng(seed).choice(n, min(size, n),
                                                     replace=False))
    x = jnp.asarray(x, jnp.float32)
    targets = jnp.asarray(sub, jnp.int32)
    coeff, _ = model_block._pair_kernels(core_scale, False)
    f_ref = jax.jit(
        lambda q: pairwise_forces_dense(q, coeff, targets=targets)[0]
    )(x)[targets]

    grid = model_block.block_grid
    xs = x[targets]
    probe = dataclasses.replace(grid, width=128, slots=0)
    width = int(jax.jit(lambda q: build_structure(probe, q).max_width)(xs))
    sub_grid = dataclasses.replace(grid, width=max(width, 1), slots=0)
    params = model_block._ab_params(core_scale)

    def coeff_b(r2, e_i, e_j):
        return pot.ab_pair_force_coeff(
            r2, 0.5 * (e_i[0] + e_j[0]), 0.5 * (e_i[1] + e_j[1]), params
        )

    extras = (model_block.af[targets], model_block.bf[targets])
    f, _, ov, _ = jax.jit(
        lambda q, e: block_pair_forces(sub_grid, q, e, coeff_b)
    )(xs, extras)
    if int(ov):
        raise AssertionError(f"subset block engine overflow {int(ov)}")
    f, f_ref = np.asarray(f, np.float64), np.asarray(f_ref, np.float64)
    scale = float(np.abs(f_ref).max())
    err = float(np.abs(f - f_ref).max()) / scale if scale else 0.0
    return {"beads": int(len(sub)), "max_rel_err": err,
            "max_abs_force": scale, "tol": FORCE_RTOL,
            "pass": err <= FORCE_RTOL}


def _pairs(events) -> set:
    import numpy as np

    ev = np.asarray(events)
    ev = ev[ev[:, 0] >= 0]
    return {(int(min(a, b)), int(max(a, b))) for a, b in ev[:, :2]}


def near_cutoff(pairs, x, cutoff, eps) -> bool:
    """True when every pair's distance lies within ``eps`` of ``cutoff``."""
    import numpy as np

    if not pairs:
        return True
    ij = np.asarray(sorted(pairs))
    x = np.asarray(x, np.float64)
    r = np.linalg.norm(x[ij[:, 0]] - x[ij[:, 1]], axis=1)
    return bool(np.all(np.abs(r - cutoff) <= eps))


def contact_parity(model_block, model_oracle, x, step) -> dict:
    """Block contact tick vs the oracle's margin-free gather search."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    xj = jnp.asarray(x, jnp.float32)

    def tick(model):
        return jax.jit(
            lambda q: model.contact_events_tick(q, jnp.asarray(step))
        )(xj)

    ev, ne, _, width_ov = tick(model_block)
    ev_ref, ne_ref, row_ov, grid_ov = tick(model_oracle)
    if int(width_ov) or int(row_ov) or int(grid_ov):
        raise AssertionError("contact search overflow")
    if int(ne) > model_block.events_capacity or (
        int(ne_ref) > model_oracle.events_capacity
    ):
        raise AssertionError("contact event capacity exceeded")
    got, want = _pairs(ev), _pairs(ev_ref)
    c = model_block.config
    core, _ = model_block.scales(np.float32(step) * np.float32(c.timestep))
    cutoff = float(c.contactmap_distance * float(core))
    diff = got ^ want
    ok = near_cutoff(diff, x, cutoff, CONTACT_EPS)
    return {"pairs": len(want), "differ": len(diff), "cutoff": cutoff,
            "eps": CONTACT_EPS, "pass": ok}


# -- --four-cards: the halo decomposition -------------------------------------


def halo_parity(design, config, x0, seed=3, n_shards=4) -> dict:
    """One zero-temperature halo segment over ``n_shards`` devices against
    the single-device segment from the same positions."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from genome_cycle_tpu.models.interphase import ChunkStats, _AdaptiveEngine
    from genome_cycle_tpu.ops.contact import events_to_host, merge_window
    from genome_cycle_tpu.parallel.halo import (
        HaloPlanner, gather_positions, make_halo_segment,
    )
    from genome_cycle_tpu.parallel.mesh import make_mesh

    cold = dataclasses.replace(
        config,
        interphase=dataclasses.replace(config.interphase, temperature=0.0),
    )
    x0 = np.asarray(x0, np.float32)
    engine = _AdaptiveEngine(design, cold, None, lambda *_: None)
    engine.update_bound(float(np.abs(x0).max()))
    engine.probe_capacity(jnp.asarray(x0))
    semi = np.asarray(cold.interphase.wall_semiaxes_init, np.float32)
    key = np.asarray(jax.random.PRNGKey(seed), np.uint32)

    # The same re-planning the halo G1 driver does on a violated segment.
    mesh = make_mesh(1, n_shards)
    planner = HaloPlanner(engine, n_shards, x0, lambda *_: None)
    while True:
        carry = planner.build_carry(mesh, x0, key, semi)
        segment = make_halo_segment(planner.model, planner.geo, mesh,
                                    HALO_SEGMENT)
        carry, events, stats = segment(carry, jnp.asarray(0))
        if not planner.adjust(jax.tree.map(np.asarray, stats), x0):
            break
    model = planner.model
    halo_pos = gather_positions(model, carry)[0]

    single = jax.jit(model.interphase_segment(HALO_SEGMENT))
    carry1, events1 = single(
        (jnp.asarray(x0), jnp.asarray(key), jnp.asarray(semi),
         ChunkStats.zero(jnp.float32)),
        jnp.asarray(0),
    )
    st1 = carry1[3]
    if (int(st1.cell_overflow) or int(st1.contact_cell_overflow)
            or int(st1.event_overflow) > 0):
        raise AssertionError("single-device segment overflow")
    single_pos = np.asarray(carry1[0])
    err = float(np.abs(halo_pos - single_pos).max())
    coo_h = merge_window([events_to_host(events)])
    coo_s = merge_window([events_to_host(events1)])
    pairs_h = {(int(i), int(j)) for i, j, _ in coo_h}
    pairs_s = {(int(i), int(j)) for i, j, _ in coo_s}
    c = cold.interphase
    core, _ = model.scales(np.float32(HALO_SEGMENT * c.timestep))
    cutoff = float(c.contactmap_distance * float(core))
    diff = pairs_h ^ pairs_s
    ok_pairs = near_cutoff(diff, single_pos, cutoff,
                           CONTACT_EPS + 2 * HALO_POS_ATOL)
    return {"beads": int(model.n), "shards": n_shards,
            "max_abs_pos_err": err, "tol": HALO_POS_ATOL,
            "pairs": len(pairs_s), "pairs_differ": len(diff),
            "pass": err <= HALO_POS_ATOL and ok_pairs}


# -- entry point --------------------------------------------------------------


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run interphase --shards 4 and its halo check "
                        "only")
    parser.add_argument("--out", default=str(REPO / "runs" / "chip_smoke"),
                        help="output directory (config, trajectory)")
    args = parser.parse_args(argv)

    # a. Device gate: before anything else, no CPU mode.
    sys.path.insert(0, str(REPO))
    from genome_cycle_tpu.utils.runtime import (
        card_line, enable_compile_cache, require_gpu,
    )

    device = require_gpu()
    import jax
    import jaxlib

    card = card_line()
    enable_compile_cache()
    have_h5py, have_pandas = _imports("h5py"), _imports("pandas")
    say("device", card, **device, jax=jax.__version__,
        jaxlib=jaxlib.__version__, h5py=have_h5py, pandas=have_pandas)
    if not have_h5py:
        say("note", card, message="h5py is missing: the stages run through "
            "the library on an in-memory store (MemoryFile); no HDF5 file "
            "is written and `cool` is skipped")

    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    config_path = write_config(out)
    say("config", card, chains=str(CHAINS.relative_to(REPO)),
        cuts=STEP_CUTS, note="every other field at the reference default")
    compiles = CompileCounter()

    if args.four_cards:
        if device["count"] < 4:
            raise RuntimeError(f"--four-cards needs 4 devices, found "
                               f"{device['count']}")
        run_four_cards(out, config_path, have_h5py, card, compiles)
        device = dict(device, count=4)
    else:
        run_one_card(out, config_path, have_h5py, have_pandas, card, device,
                     compiles)
    print(f"card: {card}", flush=True)
    print(last_line(device), flush=True)
    return 0


def run_one_card(out, config_path, have_h5py, have_pandas, card, device,
                 compiles):
    import jax

    from genome_cycle_tpu.store import SimulationStore

    log = Log()
    target = prepare_target(out, have_h5py)
    t0 = time.perf_counter()
    seconds = run_main_path(target, config_path, CHAINS, log)
    total = time.perf_counter() - t0
    mem = jax.devices()[0].memory_stats() or {}

    with SimulationStore(target) as store:
        checks = check_store(store, PARTICLES)
        say("main_path", card, stage_seconds=seconds, total_seconds=total,
            programs_built=compiles.count,
            persistent_cache_hits=compiles.cache_hits,
            compile_seconds=compiles.seconds,
            adaptive_engine_changes=log.engine_changes(),
            g1_steady_bead_steps_per_s=log.steady_g1_rate(
                checks["particles"], compiles),
            peak_bytes_in_use=mem.get("peak_bytes_in_use"))
        say("store_checks", card, **checks)
        store.set_stage("interphase")
        last = store.load_steps()[-1]
        x = store.load_positions(last)
        core = store.load_interphase_context(last).core_scale
        design = store.load_interphase_design()
        config = store.load_config()

    if have_h5py and have_pandas:
        from genome_cycle_tpu.cli import main as cli_main

        t0 = time.perf_counter()
        cli_main(["cool", "--output", str(out / "smoke.cool"), target])
        say("cool", card, seconds=time.perf_counter() - t0)

    model_block, model_oracle = parity_models(design, config, x)
    results = {
        "forces_vs_gather_oracle": force_parity(model_block, model_oracle, x,
                                                core),
        "forces_vs_dense_subset": dense_subset_parity(model_block, x, core),
        "contacts_vs_gather_oracle": contact_parity(model_block, model_oracle,
                                                    x, last),
    }
    say("parity", card, step=last, core_scale=core, **results)
    failed = [k for k, v in results.items() if not v["pass"]]
    if failed:
        raise AssertionError(f"parity failed: {failed}")


def run_four_cards(out, config_path, have_h5py, card, compiles):
    from genome_cycle_tpu.models.anatelophase import run_anatelophase
    from genome_cycle_tpu.models.interphase import run_interphase
    from genome_cycle_tpu.models.prepare import run_prepare
    from genome_cycle_tpu.models.transitions import transition_interphase
    from genome_cycle_tpu.store import SimulationStore

    log = Log()
    target = prepare_target(out, have_h5py)
    run_prepare(target, str(config_path), str(CHAINS), seed=1, log=log)
    with SimulationStore(target) as store:
        run_anatelophase(store, log=log)
        transition_interphase(store, log=log)
        t0 = time.perf_counter()
        # What `cli interphase --shards 4` runs.
        run_interphase(store, log=log, n_shards=4)
        seconds = time.perf_counter() - t0
        checks = check_store(store, PARTICLES, ("relaxation", "interphase"))
        say("interphase_shards_4", card, seconds=seconds,
            programs_built=compiles.count,
            persistent_cache_hits=compiles.cache_hits,
            compile_seconds=compiles.seconds,
            adaptive_engine_changes=log.engine_changes(),
            g1_steady_bead_steps_per_s=log.steady_g1_rate(
                checks["particles"], compiles))
        say("store_checks", card, **checks)
        store.set_stage("relaxation")
        x0 = store.load_positions(store.load_steps()[-1])
        design = store.load_interphase_design()
        config = store.load_config()
    result = halo_parity(design, config, x0)
    say("halo_vs_single_device", card, **result)
    if not result["pass"]:
        raise AssertionError("halo segment differs from the single device")


if __name__ == "__main__":
    sys.exit(main())
