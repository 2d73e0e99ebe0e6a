"""End-to-end single-cycle pipeline on a tiny system (CPU, small steps).

The 'minimum end-to-end slice' of SURVEY.md §7 phase 3: prepare ->
anatelophase -> transition interphase -> interphase -> transition
prometaphase -> prometaphase -> transition cycle, all through the public
drivers, verifying schema-correct output at each stage.
"""

import json

import h5py
import numpy as np
import pytest

from genome_cycle_tpu.config import parse_config
from genome_cycle_tpu.models.anatelophase import run_anatelophase
from genome_cycle_tpu.models.interphase import EngineSettings, run_interphase
from genome_cycle_tpu.models.prepare import run_prepare
from genome_cycle_tpu.models.prometaphase import run_prometaphase
from genome_cycle_tpu.models.transitions import (
    transition_cycle,
    transition_interphase,
    transition_prometaphase,
)
from genome_cycle_tpu.store import SimulationStore

CONFIG = {
    "mitotic_phase": {
        "anaphase_steps": 300,
        "telophase_steps": 200,
        "prometaphase_steps": 300,
        "sampling_interval": 100,
        "logging_interval": 100,
    },
    "interphase": {
        "steps": 400,
        "sampling_interval": 100,
        "logging_interval": 100,
        "relaxation_steps": 200,
        "relaxation_sampling_interval": 100,
        "contactmap_update_interval": 20,
        "contactmap_output_window": 2,
    },
}


def write_inputs(tmp_path):
    config_path = tmp_path / "config.json"
    config_path.write_text(json.dumps(CONFIG))
    rows = ["chain\tstart\tend\tA\tB\ttags"]
    for name, nbeads, cen in [("chr1:a", 300, (140, 160)), ("chr2:a", 200, (90, 110))]:
        for i in range(nbeads):
            if cen[0] <= i < cen[1]:
                tag, a, b = "cen,B", 0, 1
            elif name == "chr1:a" and i < 2:
                tag, a, b = "anor,A", 1, 0
            elif i % 2 == 0:
                tag, a, b = "A", 1, 0
            else:
                tag, a, b = "B", 0, 1
            rows.append(f"{name}\t{i * 100000}\t{(i + 1) * 100000}\t{a}\t{b}\t{tag}")
    chains_path = tmp_path / "chains.tsv"
    chains_path.write_text("\n".join(rows) + "\n")
    return str(config_path), str(chains_path)


@pytest.fixture(scope="module")
def cycle_file(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("pipeline")
    config_path, chains_path = write_inputs(tmp_path)
    path = str(tmp_path / "cell_0.h5")
    logs = []
    run_prepare(path, config_path, chains_path, seed=42, log=logs.append)
    with SimulationStore(path) as store:
        run_anatelophase(store, log=logs.append)
        transition_interphase(store, log=logs.append)
        run_interphase(
            store,
            # The gather-fold pair engine: the dense-slab path is wasteful
            # on the CPU test mesh (it is covered by the slab-vs-brute-force
            # equivalence test instead).
            settings=EngineSettings(
                cell_capacity=128, contact_capacity=128, grid_bound=9.0,
                use_dense_grid=False,
            ),
            log=logs.append,
        )
        transition_prometaphase(store, log=logs.append)
        run_prometaphase(store, log=logs.append)
    return path, tmp_path, config_path, chains_path, logs


def test_anatelophase_output(cycle_file):
    path = cycle_file[0]
    with SimulationStore(path) as store:
        store.set_stage("anaphase")
        steps = store.load_steps()
        assert steps == [0, 100, 200, 300]
        x = store.load_positions(300)
        assert x.shape == (5, 3)  # 300//100 + 200//100 coarse beads
        assert np.isfinite(x).all()
        store.set_stage("telophase")
        assert store.load_steps() == [0, 100, 200]
        # Telophase packs toward the origin within ~packing radius + slack.
        x = store.load_positions(200)
        assert np.linalg.norm(x, axis=1).max() < 12.0


def test_interphase_output(cycle_file):
    path = cycle_file[0]
    with SimulationStore(path) as store:
        store.set_stage("relaxation")
        assert store.load_steps() == [0, 100, 200]
        ctx = store.load_interphase_context(100)
        assert ctx.core_scale == pytest.approx(0.5)

        store.set_stage("interphase")
        steps = store.load_steps()
        assert steps == [0, 100, 200, 300, 400]
        x = store.load_positions(400)
        assert np.isfinite(x).all()
        # All beads near/inside the wall.
        ctx = store.load_interphase_context(400)
        assert np.linalg.norm(x, axis=1).max() < 1.5 * max(ctx.wall_semiaxes)
        assert ctx.time == pytest.approx(400 * 1e-5)
        assert ctx.mean_energy != 0.0
        # Wall semiaxes must have moved (ODE active).
        assert ctx.wall_semiaxes != (2.0, 2.0, 2.0)

        # Contact windows at step 0 and every 200 steps.
        c0 = store.load_contacts(0)
        assert c0 is not None and len(c0) > 0
        c200 = store.load_contacts(200)
        assert c200 is not None and (c200[:, 2] >= 1).all()
        # i < j and in-bounds bead ids.
        assert (c200[:, 0] < c200[:, 1]).all()
        assert c200[:, 1].max() < 506


def test_prometaphase_output(cycle_file):
    path = cycle_file[0]
    with SimulationStore(path) as store:
        store.set_stage("prometaphase")
        steps = store.load_steps()
        assert steps == [0, 100, 200, 300]
        x = store.load_positions(300)
        assert x.shape == (10, 3)  # doubled chromatids
        assert np.isfinite(x).all()
        # Initial structure: sisters displaced along -spindle_axis.
        x0 = store.load_positions(0)
        design = store.load_prometaphase_design()
        t0, s0 = design.sister_chromatids[0]
        tc, sc = design.chains[t0], design.chains[s0]
        rel = x0[sc.start] - x0[tc.start]
        np.testing.assert_allclose(rel, [0, -0.3, 0], atol=1e-4)


def test_cycle_handoff(cycle_file):
    path, tmp_path, config_path, chains_path, _ = cycle_file
    next_path = str(tmp_path / "cell_1.h5")
    run_prepare(next_path, config_path, chains_path, seed=43, log=lambda *_: None)
    with SimulationStore(path) as prev, SimulationStore(next_path) as nxt:
        transition_cycle(prev, nxt, log=lambda *_: None)
    with SimulationStore(next_path) as nxt:
        nxt.set_stage("anaphase")
        assert nxt.check_positions(0)
        x = nxt.load_positions(0)
        assert x.shape == (5, 3)
        # Displaced by -spindle_axis from the previous metaphase target plate.
    with SimulationStore(path) as prev:
        prev.set_stage("prometaphase")
        xm = prev.load_positions(prev.load_steps()[-1])
        design = prev.load_prometaphase_design()
        t0 = design.chains[design.sister_chromatids[0][0]]
        np.testing.assert_allclose(
            x[0], xm[t0.start] + np.asarray([0, -5, 0]), atol=1e-4
        )


def test_contexts_are_reference_shaped(cycle_file):
    path = cycle_file[0]
    with h5py.File(path, "r") as f:
        raw = f["/stages/interphase/100/context"][()].decode()
        obj = json.loads(raw)
        assert list(obj) == [
            "time",
            "wall_semiaxes",
            "core_scale",
            "bond_scale",
            "mean_energy",
            "wall_energy",
        ]


def test_analysis_chain_on_trajectory(cycle_file, tmp_path):
    """Trajectory -> cool -> dephase -> pc1 -> gsd, through the CLIs."""
    path = cycle_file[0]
    from genome_cycle_tpu.analysis import cool as cool_mod
    from genome_cycle_tpu.analysis import dephase as dephase_mod
    from genome_cycle_tpu.analysis import pc1 as pc1_mod
    from genome_cycle_tpu.analysis import dumpgsd as dumpgsd_mod
    from genome_cycle_tpu.analysis.coolio import Cooler
    from genome_cycle_tpu.analysis.gsdio import GSDReader

    sim_cool = str(tmp_path / "sim.cool")
    cool_mod.main(output=sim_cool, input_sims=[path])
    clr = Cooler(sim_cool)
    # Diploid chains + virtual nucleoli chain.
    assert set(clr.chromnames) == {"chr1:a", "chr2:a", "nucleoli"}
    assert clr.nbins == 504  # 500 chain beads + 2 aNORs * 2 nucleolar
    mat = clr.matrix(balance=False)[:, :]
    assert mat.sum() > 0
    # Chain-neighbor contacts must dominate: mean near-diagonal count higher
    # than mean long-range count.
    near = np.mean([mat[i, i + 1] for i in range(0, 290)])
    far = np.mean(mat[0:50, 200:250])
    assert near > far

    hap_cool = str(tmp_path / "hap.cool")
    dephase_mod.main(output=hap_cool, input=sim_cool)
    hap = Cooler(hap_cool)
    assert set(hap.chromnames) == {"chr1", "chr2"}
    assert hap.nbins == 500

    pc1_tsv = str(tmp_path / "pc1.tsv")
    aux_json = str(tmp_path / "aux.json")
    pc1_mod.main(cool=hap_cool, output=pc1_tsv, aux_output=aux_json)
    import pandas as pd

    table = pd.read_csv(pc1_tsv, sep="\t")
    assert list(table.columns) == ["chrom", "start", "end", "ev1", "pc1"]
    assert len(table) == 500
    aux = json.loads(open(aux_json).read())
    assert 0 <= aux["explained_variance_ratio"] <= 1

    gsd_path = str(tmp_path / "traj.gsd")
    dumpgsd_mod.main(input_filename=path, output_filename=gsd_path, stage="interphase")
    with GSDReader(gsd_path) as r:
        assert r.nframes == 5
        pos = r.chunk(0, "particles/position")
        assert pos.shape == (504, 3)
        # nucleolar pseudo-bonds added after 498 chain backbone bonds.
        assert r.chunk(0, "bonds/N")[0] == 498 + 4

    gsd_path2 = str(tmp_path / "ana.gsd")
    dumpgsd_mod.main(input_filename=path, output_filename=gsd_path2, stage="anaphase")
    with GSDReader(gsd_path2) as r:
        # Spindle-pole pseudo-particle appended.
        assert r.chunk(0, "particles/N")[0] == 5 + 1


def test_interphase_checkpoint_resume(cycle_file, tmp_path):
    """Kill-and-resume: re-running the interphase stage from a mid-stage
    checkpoint continues instead of restarting (new capability, SURVEY §5.4)."""
    path, _, config_path, chains_path, _ = cycle_file
    import shutil

    copy = str(tmp_path / "resume.h5")
    shutil.copy(path, copy)
    settings = EngineSettings(
        cell_capacity=128, contact_capacity=128, grid_bound=9.0,
        use_dense_grid=False,
    )
    with SimulationStore(copy) as store:
        # Simulate a crash after the window at step 200: plant a checkpoint.
        store.set_stage("interphase")
        x200 = store.load_positions(200)
        ctx200 = store.load_interphase_context(200)
        store.save_checkpoint(
            200,
            {
                "positions": x200,
                "semiaxes": np.asarray(ctx200.wall_semiaxes),
                "key": np.asarray([1234, 5678], np.uint32),
            },
        )
        # Truncate the frame list to the checkpoint.
        store._write(
            store._data_path(".steps"),
            np.asarray(["0", "100", "200"], dtype=object),
            dtype=__import__("h5py").string_dtype(),
        )
        logs = []
        run_interphase(store, settings=settings, log=logs.append)
        assert any("resuming interphase from checkpoint at step 200" in l for l in logs)
        store.set_stage("interphase")
        assert store.load_steps() == [0, 100, 200, 300, 400]
        assert np.isfinite(store.load_positions(400)).all()
        # Checkpoint cleared after completion.
        assert store.load_checkpoint() is None


def test_cli_cycles_runs_one_whole_cycle(tmp_path, monkeypatch):
    """`cli cycles -n 1` end to end: prepare plus every stage of the cycle
    into one reference-schema trajectory file."""
    from genome_cycle_tpu import cli

    # The cache location is honoured as given; JAX's own configuration is
    # left alone.
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cache"))
    config_path, chains_path = write_inputs(tmp_path)
    prefix = str(tmp_path / "run_")
    cli.main(["cycles", "-n", "1", "-s", "7", "-o", prefix, config_path,
              chains_path])
    with SimulationStore(prefix + "cell_0.h5") as store:
        for stage in ("anaphase", "telophase", "relaxation", "interphase",
                      "prometaphase"):
            store.set_stage(stage)
            steps = store.load_steps()
            assert steps, stage
            assert np.isfinite(store.load_positions(steps[-1])).all()
        store.set_stage("interphase")
        assert store.load_steps() == [0, 100, 200, 300, 400]
        assert store.load_contacts(400) is not None
