"""Benchmark: interphase BD hot loop on one GPU.

Prints one JSON line per banked result:
    {"metric": "bead_steps_per_s_per_chip", "value": N, "unit": "bead-steps/s",
     "vs_baseline": R, "platform": "gpu", "device_kind": ..., ...}

The primary metric follows BASELINE.md: bead-steps/s/chip for the full
interphase force field (sorted-block A/B softcore pair engine, chain bonds,
moving ellipsoid wall with axial reaction, contact counting cadence, BD
update).  ``vs_baseline`` compares against a single-threaded C++ cell-list
implementation of the same force field compiled with the reference's flags
(genome_cycle_tpu/native/bench_baseline.cpp) — the reference itself cannot be
built here (micromd submodule not vendored, SURVEY.md §2.9).

Workload geometry: chains initialised as ball-confined Gaussian random walks
at the thermal equilibrium bond length.  A uniform random ball (earlier
rounds) puts bonded neighbours ~1.5 apart, so every chain collapses into a
dense clump within a few hundred steps — cell occupancy quadruples
mid-measurement, each fixed-capacity retry costs a multi-minute recompile,
and two rounds of driver benches timed out exactly this way.  The walk is
density-stationary from step 0, so the capacity probed from the initial
structure holds for the whole measurement.

Banking strategy (escalation ladder): a small config runs first and banks a
valid number quickly; the production 100k config (the PRIMARY metric) runs
last, so its record is also the final printed line once it lands.  Variants
run one after another, each in its own subprocess, while this parent process
stays off JAX: one process holds the card at a time.  A variant that finds
no GPU fails; it never measures the CPU.
"""

import json
import math
import os
import pathlib
import subprocess
import sys
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))
from genome_cycle_tpu.utils.runtime import compile_cache_dir  # noqa: E402

CHAINS = 46
BENCH_STEPS = 200
TIMED_REPS = 3
# Equilibrium-G1-like density: 100k beads in a radius-2.5 ball
# (~1500 beads/unit^3); smaller configs shrink the ball at equal density.
FULL_N = 100_000
FULL_RADIUS = 2.5
FLOPS_PER_PAIR_LANE = 36.0  # dx/dy/dz, r2, two softcore branches, 3 FMAs out


def _ball_radius(n: int) -> float:
    return FULL_RADIUS * (n / FULL_N) ** (1.0 / 3.0)


def _chain_walk(n: int, chains: int, radius: float, bond_rms=0.1, seed=0):
    """Chains as ball-confined Gaussian random walks at equilibrium bond
    length (<r^2> = 3kT/k_eff with k_eff ~ 300 at core_scale 0.5 -> rms 0.1).
    Walks escaping the ball fold back by radial reflection (triangle-wave map
    of the radius), which preserves local step statistics almost everywhere.
    """
    rng = np.random.default_rng(seed)
    per = n // chains
    out = np.empty((per * chains, 3), np.float32)
    sigma = bond_rms / math.sqrt(3.0)
    for c in range(chains):
        steps = rng.normal(0.0, sigma, size=(per, 3))
        start_dir = rng.normal(size=3)
        start_dir /= np.linalg.norm(start_dir)
        walk = np.empty((per, 3))
        walk[0] = start_dir * radius * rng.uniform(0, 0.9) ** (1 / 3)
        for i in range(1, per):
            q = walk[i - 1] + steps[i]
            r = math.sqrt(q @ q)
            if r > radius:
                # Mirror across the boundary sphere (steps << radius, so one
                # reflection suffices and angular diversity is preserved).
                q *= (2.0 * radius - r) / r
            walk[i] = q
        out[c * per : (c + 1) * per] = walk
    return out


def _round_up(v: int, m: int) -> int:
    return ((v + m - 1) // m) * m


def _grid_max_fill(x, bound: float, cell: float) -> int:
    """Densest-cell occupancy under the engine's own grid alignment
    (DenseGrid.cubic: lower = -bound, dims = ceil(2*bound/cell))."""
    ndim = max(int(np.ceil(2.0 * bound / cell)), 1)
    c = np.clip(((x + bound) / cell).astype(np.int64), 0, ndim - 1)
    cid = (c[:, 0] * ndim + c[:, 1]) * ndim + c[:, 2]
    return int(np.bincount(cid).max())


def _max_contact_partners(x, cutoff: float) -> int:
    """Largest per-row pair count within ``cutoff`` under the engine's
    parity-balanced ownership (ops/contact.py:owns_pair)."""
    from scipy.spatial import cKDTree

    tree = cKDTree(x)
    pairs = tree.query_pairs(cutoff, output_type="ndarray")
    if len(pairs) == 0:
        return 0
    i = np.minimum(pairs[:, 0], pairs[:, 1])
    j = np.maximum(pairs[:, 0], pairs[:, 1])
    owner = np.where((i + j) % 2 == 0, i, j)
    return int(np.bincount(owner, minlength=len(x)).max())


def _plan(n_beads: int):
    """Static engine plan derived from the initial structure: grid geometry,
    capacities, and the dense cell-size bucket covering the whole run."""
    import jax.numpy as jnp  # noqa: F401  (ensures jax is importable early)

    radius = _ball_radius(n_beads)
    x = _chain_walk(n_beads, CHAINS, radius)

    # Interphase defaults: dt 1e-5, scheduled expansion from core_scale 0.5.
    dt = 1e-5
    t_end = (1 + TIMED_REPS) * BENCH_STEPS * dt
    core_end = 1.0 - 0.5 * math.exp(-t_end / 0.5)
    # Dense cell = full interaction diameter (see
    # _AdaptiveEngine.update_cell_scale).
    bucket = 1.0

    dense_bound = radius + 0.5
    cell = 0.3 * bucket
    fill = _grid_max_fill(x, dense_bound, cell)
    cell_capacity = _round_up(max(int(fill * 1.5), 32), 32)

    # Contact rows: margin-free tick search at the current contact distance.
    margin = 0.25  # only sizes the coarse margin_grid (halo/legacy paths)
    contact_cutoff = 0.24 * core_end
    partners = _max_contact_partners(x, contact_cutoff)
    contact_capacity = _round_up(max(int(partners * 1.5), 16), 8)

    # Tick search grid: cell bucketed to the cutoff schedule (fold lanes
    # scale with capacity^2).
    contact_bucket = next(
        b for b in (0.52, 0.6, 0.7, 0.8, 0.9, 1.0) if core_end <= b + 1e-6
    )
    contact_cell = 0.24 * contact_bucket
    contact_fill = _grid_max_fill(x, radius + 1.0, contact_cell)
    contact_cell_capacity = _round_up(max(int(contact_fill * 1.3), 16), 8)

    return dict(
        n_beads=n_beads,
        radius=radius,
        dense_bound=dense_bound,
        bucket=bucket,
        contact_bucket=contact_bucket,
        cell=cell,
        cell_capacity=cell_capacity,
        contact_capacity=contact_capacity,
        contact_cell_capacity=contact_cell_capacity,
        margin=margin,
    )


def _measure_variant(n_beads: int, engine: str = "block"):
    import jax
    import jax.numpy as jnp

    import __graft_entry__ as ge
    from genome_cycle_tpu.models.interphase import EngineSettings
    from genome_cycle_tpu.utils.runtime import require_gpu

    device = require_gpu()
    plan = _plan(n_beads)
    use_block = engine == "block"
    settings = EngineSettings(
        cell_capacity=plan["cell_capacity"],
        contact_capacity=plan["contact_capacity"],
        contact_cell_capacity=plan["contact_cell_capacity"],
        contact_cell_scale=plan["contact_bucket"],
        contact_margin=plan["margin"],
        grid_bound=plan["radius"] + 1.0,
        dense_bound=plan["dense_bound"],
        dense_cell_scale=plan["bucket"],
        use_block_pairs=use_block,
        use_dense_grid=True,
    )
    x_host = _chain_walk(n_beads, CHAINS, plan["radius"])

    if use_block:
        # Exact window watermark + slot need from the initial structure (one
        # tiny jit); the in-run retry loop handles drift growth.
        from genome_cycle_tpu.ops.block_pairs import (
            BlockGrid, build_structure,
        )

        bgrid = BlockGrid.cubic(
            bound=plan["dense_bound"], cell_size=0.3, width=128
        )
        def _probe(x):
            s = build_structure(bgrid, x)
            return s.max_width, s.slot_need

        mw, slot_need = (
            int(v) for v in jax.jit(_probe)(jnp.asarray(x_host))
        )
        settings = __import__("dataclasses").replace(
            settings,
            block_width=max(_round_up(int(mw * 1.25), 128), 256),
            block_slots=_round_up(int(slot_need * 1.15), 128),
        )

    model = ge._make_model(n_beads=n_beads, chains=CHAINS, settings=settings)
    x_host = x_host[: model.n]

    x = jnp.asarray(x_host)
    key = jax.random.PRNGKey(0)
    # Wall semiaxes match the start ball so density stays at the stated value
    # instead of compressing mid-measurement (C++ baseline: same geometry).
    semiaxes = jnp.full((3,), plan["radius"], jnp.float32)

    from genome_cycle_tpu.models.interphase import ChunkStats

    for attempt in range(2):
        carry = (x, key, semiaxes, ChunkStats.zero(jnp.float32))
        chunk = model.make_interphase_chunk(BENCH_STEPS)

        # Warmup (compile + first chunk) + validity: an overflowed run
        # measured dropped pairs, not the force field.
        carry, _ = chunk(carry, jnp.asarray(0))
        jax.block_until_ready(carry[0])
        stats = carry[3]
        bad = {
            # On the block path contact_cell_overflow is the tick's window
            # width overflow — same knob as the pair engine's channel.
            "cell": int(stats.cell_overflow)
            + (int(stats.contact_cell_overflow) if use_block else 0),
            "contact": int(stats.contact_overflow),
            # Watermark channel: negative means under capacity.
            "events": max(0, int(stats.event_overflow)),
        }
        if any(bad.values()):
            print(
                f"capacity overflow {bad} (watermark "
                f"{int(stats.cell_fill)}); retrying grown",
                file=sys.stderr,
            )
            import dataclasses

            if use_block and bad["cell"]:
                from genome_cycle_tpu.ops.block_pairs import SLOT_OVERFLOW

                if bad["cell"] & SLOT_OVERFLOW:
                    settings = dataclasses.replace(
                        settings,
                        block_slots=_round_up(
                            settings.block_slots * 3 // 2, 128
                        ),
                    )
                else:
                    wm = int(stats.cell_fill)
                    settings = dataclasses.replace(
                        settings,
                        block_width=max(
                            _round_up(int(wm * 1.25), 128),
                            settings.block_width + 128,
                        ),
                    )
            settings = dataclasses.replace(
                settings,
                cell_capacity=settings.cell_capacity
                * (2 if bad["cell"] and not use_block else 1),
                contact_capacity=settings.contact_capacity
                * (2 if bad["contact"] else 1),
                contact_events_capacity=(
                    model.events_capacity * 2 if bad["events"] else None
                ),
            )
            model = ge._make_model(
                n_beads=n_beads, chains=CHAINS, settings=settings
            )
            continue

        # Timed loop includes the device-side window merge the production
        # driver performs per chunk (ops/contact.merge_events_acc) — the
        # metric is the full driver step, not the integration kernel alone.
        from genome_cycle_tpu.ops.contact import (
            empty_window_acc, merge_events_acc,
        )

        merge = jax.jit(merge_events_acc)
        acc, acc_n = empty_window_acc(max(1 << 16, 16 * model.n))
        t0 = time.perf_counter()
        for r in range(TIMED_REPS):
            carry, events = chunk(carry, jnp.asarray((r + 1) * BENCH_STEPS))
            acc, acc_n, _ = merge(acc, acc_n, events)
        jax.block_until_ready(carry[0])
        jax.block_until_ready(acc)
        dt = (time.perf_counter() - t0) / TIMED_REPS

        steps_per_s = BENCH_STEPS / dt
        if model.block_grid is not None:
            from genome_cycle_tpu.ops.block_pairs import _shape

            bg = model.block_grid
            _, n_blocks, n_slots, _, wq = _shape(bg, model.n)
            lanes_per_step = n_blocks * bg.block * 9.0 * wq
            shape_note = {"block_width": bg.width, "block_slots": n_slots}
        else:
            grid = model.dense_grid
            lanes_per_step = grid.num_cells * 27.0 * grid.capacity**2
            shape_note = {"cell_capacity": grid.capacity}
        flops = lanes_per_step * FLOPS_PER_PAIR_LANE * steps_per_s
        return dict(
            bead_steps=steps_per_s * model.n,
            steps_per_s=steps_per_s,
            n=model.n,
            pair_lanes_per_s=lanes_per_step * steps_per_s,
            tflops_est=flops / 1e12,
            device=device,
            **shape_note,
        )
    raise RuntimeError("cell capacity overflow persisted after retry")


def _bench_env():
    # Variant subprocesses share one persistent compile cache, so a rerun
    # of the bench does not compile twice.
    env = dict(os.environ)
    env["JAX_COMPILATION_CACHE_DIR"] = compile_cache_dir()
    return env


def _result_line(res, baseline):
    """The driver-facing JSON line for one banked result."""
    vs = (res["bead_steps"] / baseline) if baseline else 0.0
    return json.dumps(
        {
            "metric": "bead_steps_per_s_per_chip",
            "value": round(res["bead_steps"]),
            "unit": "bead-steps/s",
            "vs_baseline": round(vs, 2),
            "variant": res["variant"],
            "n_beads": res["n"],
            "steps_per_s": round(res["steps_per_s"], 2),
            "pair_lanes_per_s": res["pair_lanes_per_s"],
            "tflops_est": round(res["tflops_est"], 2),
            "platform": res["device"]["platform"],
            "device_kind": res["device"]["kind"],
            "device_count": res["device"]["count"],
        }
    )


PRIMARY_N = 100_000  # BASELINE.md: the primary metric is the 100k config


def measure_variants(deadline):
    """Run the escalation ladder; bank + PRINT every result as it lands.

    Every variant runs in its own subprocess with a hard timeout: a compile
    hang or worker crash costs that variant only.  Ordering puts reliability
    first (the small config banks a valid number quickly); the production
    100k config is the PRIMARY metric (BASELINE.md) and is the last entry,
    so once it lands it is also the final printed line — the driver records
    the last JSON line, and round 4 mis-banked the 25k record by printing
    the global best instead of the primary.  Each success immediately
    prints a complete driver-format JSON line to stdout, so a timeout or
    crash later can no longer lose a banked result.
    """
    ladder = [
        ("block-25k", 25_000, "block", 1200),
        ("block-100k", 100_000, "block", 1200),
        # Comparison engine, strictly AFTER the primary banks: the XLA
        # dense slab (regression row for ops/dense_grid.py).
        ("slab-25k", 25_000, "slab", 600),
    ]
    best = None
    primary = None
    for name, n_beads, engine, timeout in ladder:
        remaining = deadline - time.perf_counter()
        if remaining < 180:
            print(f"bench deadline reached; skipping {name}", file=sys.stderr)
            break
        timeout = min(timeout, max(60, deadline - time.perf_counter()))
        code = (
            "import sys, json; sys.path.insert(0, %r); import bench; "
            "res = bench._measure_variant(%d, %r); "
            "print('BENCHRESULT ' + json.dumps(res))"
            % (str(REPO), n_beads, engine)
        )
        try:
            out = subprocess.run(
                [sys.executable, "-c", code],
                capture_output=True, text=True, timeout=timeout,
                env=_bench_env(),
            )
            for line in out.stdout.splitlines():
                if line.startswith("BENCHRESULT "):
                    res = json.loads(line[len("BENCHRESULT "):])
                    res["variant"] = name
                    print(
                        f"variant {name}: {res['bead_steps']:.3g} "
                        f"bead-steps/s ({res['steps_per_s']:.2f} steps/s, "
                        f"~{res['tflops_est']:.1f} Tflop/s est)",
                        file=sys.stderr,
                    )
                    if best is None or res["bead_steps"] > best["bead_steps"]:
                        best = res
                    if n_beads >= PRIMARY_N:
                        primary = res
                    # Bank NOW: the primary record once it exists, else the
                    # best seen so far.
                    banked = primary or best
                    baseline = measure_baseline(banked["n"])
                    print(_result_line(banked, baseline), flush=True)
                    break
            else:
                print(f"variant {name} failed:\n{out.stderr[-2000:]}",
                      file=sys.stderr)
        except subprocess.TimeoutExpired:
            print(f"variant {name} timed out", file=sys.stderr)
    if best is None:
        raise RuntimeError("all engine variants failed")
    return primary or best


def measure_baseline(n_beads: int):
    """Single-thread C++ cell-list baseline (reference-equivalent), measured
    on this host at the same bead count, density, and walk-chain initial
    structure."""
    src = REPO / "genome_cycle_tpu" / "native" / "bench_baseline.cpp"
    if not src.exists():
        return None
    exe = REPO / "bench_baseline"
    try:
        subprocess.run(
            ["g++", "-O2", "-march=native", "-funsafe-math-optimizations",
             "-std=c++17", "-o", str(exe), str(src)],
            check=True, capture_output=True,
        )
        out = subprocess.run(
            [str(exe), str(n_beads), "20", str(_ball_radius(n_beads))],
            check=True, capture_output=True, text=True, timeout=1200,
        )
        return float(json.loads(out.stdout.strip())["bead_steps_per_s"])
    except Exception as ex:
        print(f"baseline build/run failed: {ex}", file=sys.stderr)
        return None


def main():
    # Total wall-time budget: the driver's own timeout has killed the bench
    # in earlier rounds (its envelope is tighter than 2100 s) — default well
    # under it (BENCH_BUDGET_S to override).  Intermediate results are
    # printed as they bank, so even an external kill keeps whatever
    # finished; a normal finish exits 0 with the 100k primary as the final
    # line.
    budget = float(os.environ.get("BENCH_BUDGET_S", "1500"))
    deadline = time.perf_counter() + budget
    best = measure_variants(deadline)
    baseline = measure_baseline(best["n"])
    print(_result_line(best, baseline))


if __name__ == "__main__":
    main()
