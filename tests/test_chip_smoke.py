"""chip_smoke.py's CPU-checkable parts: the device gate, the cut config,
the parity helpers at ~2k beads, the last-line format, and the in-memory
main path at a tiny size."""

import json
import pathlib
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import bench  # noqa: E402
import chip_smoke  # noqa: E402
from genome_cycle_tpu.config import parse_config  # noqa: E402
from genome_cycle_tpu.store import MemoryFile, SimulationStore, StageDesign  # noqa: E402
from genome_cycle_tpu.topology import ChainAssignment  # noqa: E402


def test_device_gate_raises_on_cpu(tmp_path, capsys):
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.main(["--out", str(tmp_path)])
    assert '"ok"' not in capsys.readouterr().out


def test_cut_config_parses_and_tiles_the_rebuild_interval():
    from genome_cycle_tpu.models.interphase import EngineSettings

    config = parse_config(json.dumps(chip_smoke.cut_config()))
    ic, mc = config.interphase, config.mitotic_phase
    for section, cuts in chip_smoke.STEP_CUTS.items():
        block = ic if section == "interphase" else mc
        for key, value in cuts.items():
            assert getattr(block, key) == value
    rebuild = EngineSettings().contact_rebuild_interval
    assert ic.sampling_interval % rebuild == 0
    assert rebuild % ic.contactmap_update_interval == 0
    assert ic.steps % ic.sampling_interval == 0
    assert ic.relaxation_steps % ic.relaxation_sampling_interval == 0
    for steps in (mc.anaphase_steps, mc.telophase_steps,
                  mc.prometaphase_steps):
        assert steps % mc.sampling_interval == 0


def test_last_line_has_exactly_the_contract_keys():
    device = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
              "extra": "dropped"}
    line = chip_smoke.last_line(device)
    assert "\n" not in line
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                   "count": 1},
    }


@pytest.fixture(scope="module")
def system_2k():
    """~2k beads in two walk chains at G1 density, A/B alternating."""
    n, chains = 2048, 2
    per = n // chains
    design = StageDesign(
        seed=1,
        chains=[ChainAssignment(f"chr{i}:a", i * per, (i + 1) * per)
                for i in range(chains)],
        ab_factors=np.stack([np.arange(n) % 2, 1 - np.arange(n) % 2], 1)
        .astype(np.float64),
        nucleolar_bonds=np.zeros((0, 2), np.int64),
    )
    config = parse_config("{}")
    x = bench._chain_walk(n, chains, 0.85, seed=3).astype(np.float64)
    models = chip_smoke.parity_models(design, config, x)
    return design, config, x, models


def test_force_parity_block_vs_gather_oracle(system_2k):
    _, _, x, (block, oracle) = system_2k
    assert block.block_grid is not None and oracle.block_grid is None
    assert oracle.dense_grid is None
    res = chip_smoke.force_parity(block, oracle, x, 0.6)
    assert res["pass"], res
    assert res["max_abs_force"] > 0


def test_force_parity_block_vs_dense_subset(system_2k):
    _, _, x, (block, _) = system_2k
    res = chip_smoke.dense_subset_parity(block, x, 0.6, size=512)
    assert res["beads"] == 512
    assert res["pass"], res
    assert res["max_abs_force"] > 0


def test_contact_parity_block_vs_gather_oracle(system_2k):
    _, _, x, (block, oracle) = system_2k
    res = chip_smoke.contact_parity(block, oracle, x, 20_000)
    assert res["pass"], res
    assert res["pairs"] > 0


def test_near_cutoff_rejects_a_far_pair():
    x = np.asarray([[0.0, 0.0, 0.0], [0.2, 0.0, 0.0], [0.1, 0.0, 0.0]])
    assert chip_smoke.near_cutoff({(0, 1)}, x, 0.2, 1e-5)
    assert not chip_smoke.near_cutoff({(0, 1), (0, 2)}, x, 0.2, 1e-5)
    assert chip_smoke.near_cutoff(set(), x, 0.2, 1e-5)


def test_in_memory_main_path_passes_store_checks(tmp_path):
    """The one-card main path at a tiny size, on the in-memory store the
    smoke uses where h5py is missing."""
    from test_pipeline import write_inputs

    cfg = chip_smoke.cut_config()
    cfg["interphase"].update(steps=200, sampling_interval=100,
                             relaxation_steps=100,
                             relaxation_sampling_interval=100,
                             logging_interval=100)
    cfg["mitotic_phase"].update(anaphase_steps=200, telophase_steps=100,
                                prometaphase_steps=100, sampling_interval=100)
    _, chains = write_inputs(tmp_path)
    config_path = tmp_path / "smoke.json"
    config_path.write_text(json.dumps(cfg))
    log = chip_smoke.Log(echo=False)
    compiles = chip_smoke.CompileCounter()
    target = chip_smoke.prepare_target(tmp_path, use_hdf5=False)
    assert isinstance(target, MemoryFile)
    seconds = chip_smoke.run_main_path(target, config_path, chains, log)
    assert set(seconds) == {"prepare", "anatelophase",
                            "transition interphase", "interphase",
                            "transition prometaphase", "prometaphase"}
    with SimulationStore(target) as store:
        checks = chip_smoke.check_store(store, 504)
    assert checks["frames"]["interphase"] == 3
    assert sorted(checks["contact_pairs"]) == [0, 100, 200]
    assert log.steady_g1_rate(504, compiles) > 0
    assert compiles.count > 0 and compiles.seconds > 0
    assert not list(tmp_path.glob("*.h5"))
