import json

import h5py
import numpy as np
import pytest

from genome_cycle_tpu.config import parse_config
from genome_cycle_tpu.store import (
    InterphaseContext,
    MemoryFile,
    SimulationStore,
    prepare_store,
    quantize_positions,
)
from genome_cycle_tpu.topology import compile_topology, load_chains

CHAINS = (
    "chain\tstart\tend\tA\tB\ttags\n"
    + "".join(
        f"chr1:a\t{i * 100000}\t{(i + 1) * 100000}\t1\t0\t"
        + ("cen,A" if 180 <= i < 220 else ("anor,A" if i < 4 else "A"))
        + "\n"
        for i in range(400)
    )
    + "".join(
        f"chr2:a\t{i * 100000}\t{(i + 1) * 100000}\t0\t1\t"
        + ("cen,B" if 100 <= i < 120 else "B")
        + "\n"
        for i in range(300)
    )
)


def _prepared(target):
    cfg = parse_config('{"interphase":{"steps":100}}')
    chains = load_chains(CHAINS)
    topo = compile_topology(chains, cfg)
    prepare_store(target, cfg, chains, topo, master_seed=12345)
    return target


@pytest.fixture
def store_file(tmp_path):
    return _prepared(str(tmp_path / "cell.h5"))


@pytest.fixture(params=["hdf5", "memory"])
def store_target(request, tmp_path):
    """A prepared trajectory: an HDF5 file, or the in-memory stand-in the
    stages use where h5py is missing.  Both go through the same loaders."""
    if request.param == "hdf5":
        return _prepared(str(tmp_path / "cell.h5"))
    return _prepared(MemoryFile())


def test_schema_layout(store_file):
    with h5py.File(store_file, "r") as f:
        assert int(f["/metadata/master_seed"][()]) == 12345
        config = json.loads(f["/metadata/config"][()].decode())
        assert config["interphase"]["steps"] == 100
        assert f["/metadata/chains_source"][()].decode() == CHAINS

        # Enum dtype on particle_types (required by dumpgsd readers).
        dset = f["/stages/interphase/metadata/particle_types"]
        enum = h5py.check_enum_dtype(dset.dtype)
        assert enum is not None and enum["nucleolus"] == 7
        dset_m = f["/stages/anaphase/metadata/particle_types"]
        enum_m = h5py.check_enum_dtype(dset_m.dtype)
        assert enum_m == {"unknown": 0, "arm": 1, "kinetochore": 2}

        # Interphase: 700 chain beads + 4 active NOR * 2 nucleolus beads.
        assert dset.shape == (708,)
        assert f["/stages/interphase/metadata/ab_factors"].shape == (708, 2)
        assert f["/stages/interphase/metadata/nucleolar_bonds"].shape == (8, 2)

        # Soft links share metadata between stages.
        link = f.get("/stages/relaxation/metadata/particle_types", getlink=True)
        assert isinstance(link, h5py.SoftLink)
        assert link.path == "/stages/interphase/metadata/particle_types"
        link2 = f.get("/stages/telophase/metadata/chain_ranges", getlink=True)
        assert link2.path == "/stages/anaphase/metadata/chain_ranges"

        # Prometaphase extras.
        assert f["/stages/prometaphase/metadata/sister_chromatids"][:].tolist() == [
            [0, 1],
            [2, 3],
        ]
        assert f["/stages/prometaphase/metadata/pole_positions"].shape == (2, 3)

        # Seeds are the std::seed_seq derivation of the master seed.
        assert int(f["/stages/anaphase/metadata/seed"][()]) == 2323448196
        assert int(f["/stages/interphase/metadata/seed"][()]) == 1798476213
        assert int(f["/stages/prometaphase/metadata/seed"][()]) == 717421070


def test_positions_round_trip(store_target, rng):
    pos = rng.normal(size=(7, 3))
    with SimulationStore(store_target) as store:
        store.set_stage("anaphase")
        store.save_positions(0, pos)
        store.append_frame(0)
        store.save_positions(1000, pos * 2)
        store.append_frame(1000)
        assert store.load_steps() == [0, 1000]
        got = store.load_positions(0)
    # Quantized to 16 mantissa bits then f32: relative error <= 2^-16 + f32 eps.
    np.testing.assert_allclose(got, pos, rtol=2e-5)


def test_quantization():
    vals = np.array([1.0, 1.0 + 1e-9, -3.14159265358979, 0.0, 1e-30])
    q = quantize_positions(vals)
    assert q[0] == 1.0
    assert q[1] == 1.0  # low bits truncated
    assert q[3] == 0.0
    assert abs(q[2] - vals[2]) <= abs(vals[2]) * 2**-16
    # Idempotent.
    np.testing.assert_array_equal(quantize_positions(q), q)


def test_clear_frames(store_target):
    with SimulationStore(store_target) as store:
        store.set_stage("interphase")
        store.append_frame(0)
        store.append_frame(10)
        assert store.load_steps() == [0, 10]
        store.clear_frames()
        assert store.load_steps() == []


def test_context_round_trip(store_target):
    ctx = InterphaseContext(
        time=0.5,
        wall_semiaxes=(2.0, 2.1, 2.2),
        core_scale=0.7,
        bond_scale=0.8,
        mean_energy=1.5,
    )
    with SimulationStore(store_target) as store:
        store.set_stage("interphase")
        store.save_interphase_context(0, ctx)
        got = store.load_interphase_context(0)
    assert got == ctx
    # JSON field order matches the jsoncons traits for byte-level compatibility.
    keys = list(json.loads(ctx.to_json()))
    assert keys == [
        "time",
        "wall_semiaxes",
        "core_scale",
        "bond_scale",
        "mean_energy",
        "wall_energy",
    ]


def test_contacts_round_trip(store_target):
    contacts = np.array([[0, 1, 5], [0, 2, 3], [5, 9, 1]], dtype=np.int32)
    with SimulationStore(store_target) as store:
        store.set_stage("interphase")
        store.save_contacts(0, contacts)
        got = store.load_contacts(0)
        np.testing.assert_array_equal(got, contacts)
        # Empty contact sets are not stored (simulation_store.cpp:258-260).
        store.save_contacts(20, np.zeros((0, 3), dtype=np.int32))
        assert store.load_contacts(20) is None


def test_design_loaders(store_target):
    with SimulationStore(store_target) as store:
        inter = store.load_interphase_design()
        assert inter.seed == 1798476213
        assert [c.name for c in inter.chains] == ["chr1:a", "chr2:a"]
        assert inter.particle_count == 708
        assert inter.ab_factors.shape == (708, 2)

        ana = store.load_anatelophase_design()
        assert ana.chains[0].kinetochore == 2
        assert ana.chains[1].end == 7

        pro = store.load_prometaphase_design()
        assert pro.sister_chromatids.shape == (2, 2)
        np.testing.assert_allclose(pro.pole_positions[1], [0, 5, 0])


def test_memory_file_types_links_and_checkpoint():
    target = _prepared(MemoryFile())
    with SimulationStore(target) as store:
        types, enum = store.load_particle_types("interphase")
        assert types.shape == (708,) and enum["nucleolus"] == 7
        # Soft links resolve to the interphase metadata.
        np.testing.assert_array_equal(
            store.file["/stages/relaxation/metadata/particle_types"], types
        )
        store.set_stage("interphase")
        assert store.load_checkpoint() is None
        store.save_checkpoint(40, {"positions": np.ones((3, 3)),
                                   "key": np.asarray([1, 2], np.uint32)})
        ck = store.load_checkpoint()
        assert ck["step"] == 40 and sorted(ck) == ["key", "positions", "step"]
        np.testing.assert_array_equal(ck["key"], [1, 2])
        store.clear_checkpoint()
        assert store.load_checkpoint() is None
    # The data outlives the store opened on it.
    with SimulationStore(target) as store:
        assert store.load_config().interphase.steps == 100
