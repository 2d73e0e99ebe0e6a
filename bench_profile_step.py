"""Profile a real interphase segment (pair + bonds + wall + BD + tick) and
print per-step device-op costs — the in-chunk component breakdown.

    N=99958 python bench_profile_step.py

Fails without a GPU; the first line names the device."""

import glob
import gzip
import json
import collections
import os
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, ".")
import bench
import __graft_entry__ as ge
from genome_cycle_tpu.models.interphase import ChunkStats, EngineSettings
from genome_cycle_tpu.utils.runtime import enable_compile_cache, require_gpu

device = require_gpu()
print(json.dumps({"platform": device["platform"],
                  "device_kind": device["kind"],
                  "device_count": device["count"]}), flush=True)
enable_compile_cache()
N = int(os.environ.get("N", "99958"))
plan = bench._plan(N)
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
x_host = bench._chain_walk(N, bench.CHAINS, plan["radius"])

from genome_cycle_tpu.ops.block_pairs import BlockGrid, build_structure

bgrid = BlockGrid.cubic(bound=plan["dense_bound"], cell_size=0.3, width=128)


def _probe(q):
    s = build_structure(bgrid, q)
    return s.max_width, s.slot_need


mw, need = (int(v) for v in jax.jit(_probe)(jnp.asarray(x_host)))
import dataclasses

settings = dataclasses.replace(
    settings,
    block_width=max(bench._round_up(int(mw * 1.25), 128), 256),
    block_slots=bench._round_up(int(need * 1.15), 128),
)
model = ge._make_model(n_beads=N, chains=bench.CHAINS, settings=settings)
x = jnp.asarray(x_host[: model.n])
key = jax.random.PRNGKey(0)
semiaxes = jnp.full((3,), plan["radius"], jnp.float32)

seg = jax.jit(model.interphase_segment(20))
carry = (x, key, semiaxes, ChunkStats.zero(jnp.float32))
carry, ev = seg(carry, jnp.asarray(0))
jax.block_until_ready(carry[0])

out = tempfile.mkdtemp(prefix="stepprof")
with jax.profiler.trace(out):
    for k in range(3):
        carry, ev = seg(carry, jnp.asarray(20 * (k + 1)))
    jax.block_until_ready(carry[0])
    np.asarray(carry[0][:1])

f = sorted(glob.glob(out + "/plugins/profile/*/*.trace.json.gz"))[-1]
with gzip.open(f) as fh:
    tr = json.load(fh)
# Device planes are the trace processes named "/device:...".
device_pids = {
    e["pid"] for e in tr["traceEvents"]
    if e.get("ph") == "M" and e.get("name") == "process_name"
    and str(e.get("args", {}).get("name", "")).startswith("/device:")
}
agg = collections.Counter()
cnt = collections.Counter()
for e in tr["traceEvents"]:
    if e.get("ph") == "X" and e.get("pid") in device_pids and "dur" in e:
        agg[e["name"]] += e["dur"]
        cnt[e["name"]] += 1
steps = 60.0
print(f"device total {sum(agg.values())/1e3/steps:.2f} ms/step (incl. "
      f"nesting double-count)", flush=True)
for name, d in agg.most_common(28):
    print(f"{d/steps/1e3:8.3f} ms/step x{cnt[name]/steps:<6.2f} {name[:90]}",
          flush=True)
