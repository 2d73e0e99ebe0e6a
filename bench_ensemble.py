"""Aggregate ensemble throughput: R lock-step replicas on one GPU.

BASELINE.md north-star arithmetic: the reference's natural parallelism is
independent shell jobs on a multi-core node (SURVEY.md §2.11), so the chip
must be compared at its own natural batch point — R vmapped replicas of the
production interphase step (parallel/ensemble.py's vmapped segment), not a
single replica.  This measures total bead-steps/s versus R at a fixed
per-replica bead count:

    python bench_ensemble.py [n_beads] [R1,R2,...]

Prints one JSON line per R, with the device it ran on; stop scaling when
the marginal gain flattens (compute-bound) or allocation fails (out of
device memory).  Fails without a GPU.
"""

import dataclasses
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, ".")
import bench  # noqa: E402
import __graft_entry__ as ge  # noqa: E402
from genome_cycle_tpu.models.interphase import ChunkStats, EngineSettings  # noqa: E402
from genome_cycle_tpu.utils.runtime import enable_compile_cache, require_gpu  # noqa: E402
from genome_cycle_tpu.ops.block_pairs import BlockGrid, build_structure  # noqa: E402
from genome_cycle_tpu.ops.contact import empty_window_acc, merge_events_acc  # noqa: E402

CHUNK = 200


def measure(n_beads: int, replicas: list[int]):
    device = require_gpu()
    plan = bench._plan(n_beads)
    settings = EngineSettings(
        cell_capacity=plan["cell_capacity"],
        contact_capacity=plan["contact_capacity"],
        contact_cell_capacity=plan["contact_cell_capacity"],
        contact_cell_scale=plan["contact_bucket"],
        contact_margin=plan["margin"],
        grid_bound=plan["radius"] + 1.0,
        dense_bound=plan["dense_bound"],
        dense_cell_scale=plan["bucket"],
        use_block_pairs=True,
        use_dense_grid=True,
    )
    xs = [
        bench._chain_walk(n_beads, bench.CHAINS, plan["radius"], seed=s)
        for s in range(max(replicas))
    ]
    bgrid = BlockGrid.cubic(
        bound=plan["dense_bound"], cell_size=0.3, width=128
    )

    def _probe(q):
        s = build_structure(bgrid, q)
        return s.max_width, s.slot_need

    mw = need = 0
    for q in xs:
        a, c = (int(v) for v in jax.jit(_probe)(jnp.asarray(q)))
        mw, need = max(mw, a), max(need, c)
    settings = dataclasses.replace(
        settings,
        block_width=max(bench._round_up(int(mw * 1.25), 128), 256),
        block_slots=bench._round_up(int(need * 1.15), 128),
    )
    model = ge._make_model(n_beads=n_beads, chains=bench.CHAINS,
                           settings=settings)
    n = model.n
    seg_len = model.rebuild_interval(CHUNK)
    n_segments = CHUNK // seg_len
    segment = model.interphase_segment(seg_len)

    def one_segment(x, key, semi, stats, start):
        carry, ev = segment((x, key, semi, stats), start)
        return (*carry, ev)

    vseg = jax.jit(jax.vmap(one_segment, in_axes=(0, 0, 0, 0, None)))
    vmerge = jax.jit(jax.vmap(merge_events_acc))

    results = []
    for r in replicas:
        x = jnp.asarray(np.stack([q[:n] for q in xs[:r]]))
        key = jax.vmap(jax.random.PRNGKey)(jnp.arange(r, dtype=jnp.uint32))
        semi = jnp.tile(jnp.full((3,), plan["radius"], jnp.float32), (r, 1))
        stats = jax.tree.map(
            lambda a: jnp.broadcast_to(a, (r,) + a.shape),
            ChunkStats.zero(jnp.float32),
        )
        acc, acc_n = jax.vmap(lambda _: empty_window_acc(16 * n))(
            jnp.arange(r)
        )
        try:
            t0 = time.perf_counter()
            for k in range(n_segments):
                x, key, semi, stats, ev = vseg(
                    x, key, semi, stats, jnp.asarray(k * seg_len)
                )
                acc, acc_n, _ = vmerge(acc, acc_n, ev)
            jax.block_until_ready(x)
            compile_s = time.perf_counter() - t0
            if int(jnp.max(stats.cell_overflow)) > 0:
                print(f"R={r}: overflow, skipping", file=sys.stderr)
                continue
            t0 = time.perf_counter()
            reps = 2
            for rep in range(reps):
                for k in range(n_segments):
                    x, key, semi, stats, ev = vseg(
                        x, key, semi, stats,
                        jnp.asarray((rep + 1) * CHUNK + k * seg_len),
                    )
                acc, acc_n, _ = vmerge(acc, acc_n, ev)
            jax.block_until_ready(x)
            jax.block_until_ready(acc)
            dt = (time.perf_counter() - t0) / reps
        except Exception as ex:  # noqa: BLE001 — out of memory ends the scan
            print(f"R={r}: failed ({type(ex).__name__}: {ex})",
                  file=sys.stderr)
            break
        agg = r * n * CHUNK / dt
        res = {
            "metric": "ensemble_bead_steps_per_s_per_chip",
            "replicas": r,
            "n_beads": n,
            "steps_per_s": round(CHUNK / dt, 2),
            "aggregate_bead_steps_per_s": round(agg),
            "compile_s": round(compile_s, 1),
            "platform": device["platform"],
            "device_kind": device["kind"],
            "device_count": device["count"],
        }
        results.append(res)
        print(json.dumps(res), flush=True)
    return results


if __name__ == "__main__":
    n_beads = int(sys.argv[1]) if len(sys.argv) > 1 else 24_978
    rs = (
        [int(v) for v in sys.argv[2].split(",")]
        if len(sys.argv) > 2
        else [1, 2, 4, 6, 8]
    )
    enable_compile_cache()
    measure(n_beads, rs)
