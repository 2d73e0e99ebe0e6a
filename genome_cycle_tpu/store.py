"""HDF5 trajectory store with the reference-exact schema.

One HDF5 file per simulated cell cycle.  Schema ground truth (SURVEY.md §2.3;
reference ``src/simulation/common/simulation_store.{hpp,cpp}`` and
``stage_prepare/prepare.cpp``):

    /metadata/master_seed                     u32
    /metadata/config                          str   (JSON of resolved config)
    /metadata/config_source                   str   (raw input JSON)
    /metadata/chains_source                   str   (raw chains.tsv text)
    /stages/<stage>/metadata/seed             u32
    /stages/<stage>/metadata/particle_types   (N,)  i32 *enum dtype*
    /stages/interphase/metadata/ab_factors    (N,2) f32
    /stages/<stage>/metadata/chain_names      (C,)  str
    /stages/<stage>/metadata/chain_ranges     (C,2) i32
    /stages/interphase/metadata/nucleolar_bonds     (B,2) i32
    /stages/{anaphase,prometaphase}/metadata/kinetochore_beads (C,) i32
    /stages/prometaphase/metadata/sister_chromatids (C,2) i32
    /stages/prometaphase/metadata/pole_positions    (2,3) f32
    /stages/<stage>/.steps                    (F,)  str   frame index
    /stages/<stage>/<step>/positions          (N,3) f32   quantized, gzip 6
    /stages/<stage>/<step>/context            str   (JSON)
    /stages/interphase/<step>/contacts        (K,3) i32   gzip 4 + scaleoffset 0

Stage names: anaphase, telophase, relaxation, interphase, prometaphase.
Relaxation soft-links interphase metadata; telophase soft-links anaphase
metadata (prepare.cpp:435-444, 489-496).  Positions are mantissa-quantized to
16 fraction bits before storing (simulation_store.cpp:22-33,197-215).

h5py is imported only where a file on disk is opened.  A :class:`MemoryFile`
takes the file's place where h5py is missing: every stage then runs and
stores its frames in memory, through the same loaders, and nothing is
written to disk.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
from typing import Optional

import numpy as np

from .config import SimulationConfig, format_config, parse_config
from .topology import (
    INTERPHASE_TYPES,
    MITOTIC_TYPES,
    ChainAssignment,
    ChainDefinitions,
    GenomeTopology,
    derive_stage_seeds,
)

# The dtypes h5py.string_dtype("utf-8") and h5py.enum_dtype build, spelled
# out so that they need no h5py.
_STR = np.dtype("O", metadata={"vlen": str})


def _enum_dtype(values: dict[str, int]) -> np.dtype:
    return np.dtype(np.int32, metadata={"enum": dict(values)})


POSITION_FRACTION_BITS = 16
POSITION_COMPRESSION = 6
CONTACT_COMPRESSION = 4


def quantize_positions(values: np.ndarray, bits: int = POSITION_FRACTION_BITS) -> np.ndarray:
    """Zero low mantissa bits for compressibility (simulation_store.cpp:22-33).

    Binary analogue of HDF5's scaleoffset filter: value -> round(mant * 2^bits)
    * 2^(exp - bits), where value = mant * 2^exp with mant in [0.5, 1).
    Uses the native host-ops library when available.
    """
    from . import native

    shape = np.shape(values)
    return native.quantize_f64(np.asarray(values, np.float64).ravel(), bits).reshape(
        shape
    )


@dataclasses.dataclass
class InterphaseContext:
    """Per-frame interphase context, stored as a JSON string per frame.

    Field order matches the jsoncons traits (simulation_store.cpp:36-45).
    ``wall_energy`` is serialized but never assigned by the reference drivers;
    we keep the field for schema parity.
    """

    time: float = 0.0
    wall_semiaxes: tuple[float, float, float] = (0.0, 0.0, 0.0)
    core_scale: float = 1.0
    bond_scale: float = 1.0
    mean_energy: float = 0.0
    wall_energy: float = 0.0

    def to_json(self) -> str:
        return json.dumps(
            {
                "time": self.time,
                "wall_semiaxes": list(self.wall_semiaxes),
                "core_scale": self.core_scale,
                "bond_scale": self.bond_scale,
                "mean_energy": self.mean_energy,
                "wall_energy": self.wall_energy,
            },
            separators=(",", ":"),
        )

    @classmethod
    def from_json(cls, text: str) -> "InterphaseContext":
        obj = json.loads(text)
        return cls(
            time=obj["time"],
            wall_semiaxes=tuple(obj["wall_semiaxes"]),
            core_scale=obj["core_scale"],
            bond_scale=obj["bond_scale"],
            mean_energy=obj["mean_energy"],
            wall_energy=obj.get("wall_energy", 0.0),
        )


@dataclasses.dataclass
class StageDesign:
    """Chains (+ per-stage extras) as loaded back from the store."""

    seed: int
    chains: list[ChainAssignment]
    ab_factors: Optional[np.ndarray] = None          # interphase only
    nucleolar_bonds: Optional[np.ndarray] = None     # interphase only
    sister_chromatids: Optional[np.ndarray] = None   # prometaphase only
    pole_positions: Optional[np.ndarray] = None      # prometaphase only

    @property
    def particle_count(self) -> int:
        n = max(c.end for c in self.chains)
        if self.nucleolar_bonds is not None and len(self.nucleolar_bonds):
            n = max(n, int(self.nucleolar_bonds[:, 1].max()) + 1)
        return n


class SimulationStore:
    """Typed read/write views over one trajectory HDF5 file.

    Mirrors the reference ``simulation_store`` class (simulation_store.hpp:65-111)
    with the same per-stage namespace convention: ``set_stage`` selects the
    ``/stages/<stage>/`` prefix for frame-level I/O.
    """

    def __init__(self, filename, mode: str = "r+"):
        if isinstance(filename, MemoryFile):
            self._file = filename
        else:
            import h5py

            self._file = h5py.File(filename, mode)
        self._stage = ""

    def close(self):
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @property
    def file(self):
        return self._file

    def set_stage(self, name: str):
        self._stage = name

    # -- low-level helpers ---------------------------------------------------

    def _write(self, path: str, data, **kwargs):
        if path in self._file:
            del self._file[path]
        self._file.create_dataset(path, data=data, **kwargs)

    def _data_path(self, *keys) -> str:
        return "/stages/" + self._stage + "/" + "/".join(str(k) for k in keys)

    def _metadata_path(self, stage: str, key: str) -> str:
        return f"/stages/{stage}/metadata/{key}"

    # -- config & metadata ---------------------------------------------------

    def load_config(self) -> SimulationConfig:
        text = self._file["/metadata/config"][()]
        if isinstance(text, bytes):
            text = text.decode()
        return parse_config(text)

    def load_master_seed(self) -> int:
        return int(self._file["/metadata/master_seed"][()])

    def load_chains_source(self) -> str:
        text = self._file["/metadata/chains_source"][()]
        if isinstance(text, bytes):
            text = text.decode()
        return text

    def load_seed(self, stage: str) -> int:
        return int(self._file[self._metadata_path(stage, "seed")][()])

    def load_chain_assignments(self, stage: str) -> list[ChainAssignment]:
        names = [
            n.decode() if isinstance(n, bytes) else n
            for n in self._file[self._metadata_path(stage, "chain_names")][:]
        ]
        ranges = self._file[self._metadata_path(stage, "chain_ranges")][:]
        chains = [
            ChainAssignment(name=name, start=int(lo), end=int(hi))
            for name, (lo, hi) in zip(names, ranges)
        ]
        kpath = self._metadata_path(stage, "kinetochore_beads")
        if kpath in self._file:
            for chain, k in zip(chains, self._file[kpath][:]):
                # -1 marks "no kinetochore" (chain shorter than the
                # coarse-graining window); keep it None, not a real index.
                chain.kinetochore = int(k) if int(k) >= 0 else None
        return chains

    def load_anatelophase_design(self) -> StageDesign:
        # Anaphase and telophase share the same design (simulation_store.cpp:86-95).
        stage = "anaphase"
        return StageDesign(
            seed=self.load_seed(stage),
            chains=self.load_chain_assignments(stage),
        )

    def load_interphase_design(self) -> StageDesign:
        stage = "interphase"
        return StageDesign(
            seed=self.load_seed(stage),
            chains=self.load_chain_assignments(stage),
            ab_factors=self._file[self._metadata_path(stage, "ab_factors")][:].astype(
                np.float64
            ),
            nucleolar_bonds=self._file[
                self._metadata_path(stage, "nucleolar_bonds")
            ][:].astype(np.int64),
        )

    def load_prometaphase_design(self) -> StageDesign:
        stage = "prometaphase"
        return StageDesign(
            seed=self.load_seed(stage),
            chains=self.load_chain_assignments(stage),
            sister_chromatids=self._file[
                self._metadata_path(stage, "sister_chromatids")
            ][:].astype(np.int64),
            pole_positions=self._file[
                self._metadata_path(stage, "pole_positions")
            ][:].astype(np.float64),
        )

    def load_particle_types(self, stage: str) -> tuple[np.ndarray, dict[str, int]]:
        dset = self._file[self._metadata_path(stage, "particle_types")]
        enum = (dset.dtype.metadata or {}).get("enum", {})
        return dset[:].astype(np.int32), dict(enum)

    # -- frames --------------------------------------------------------------

    def clear_frames(self):
        path = self._data_path(".steps")
        if path in self._file:
            self._write(path, np.asarray([], dtype=object), dtype=_STR)

    def load_steps(self) -> list[int]:
        path = self._data_path(".steps")
        if path not in self._file:
            return []
        raw = self._file[path][:]
        return [int(s.decode() if isinstance(s, bytes) else s) for s in raw]

    def append_frame(self, step: int):
        # Stored as strings for schema parity (simulation_store.cpp:177-189,
        # including the upstream "FIXME: Why strings?").
        steps = self.load_steps()
        steps.append(int(step))
        self._write(
            self._data_path(".steps"),
            np.asarray([str(s) for s in steps], dtype=object),
            dtype=_STR,
        )
        # Frame boundaries are durability points: without a flush a hard kill
        # loses every buffered write since open (HDF5 caches aggressively).
        self._file.flush()

    def append_frames(self, steps_to_add):
        """Batch variant of append_frame (one dataset rewrite for many frames)."""
        steps = self.load_steps()
        steps.extend(int(s) for s in steps_to_add)
        self._write(
            self._data_path(".steps"),
            np.asarray([str(s) for s in steps], dtype=object),
            dtype=_STR,
        )

    def truncate_frames(self, max_step: int):
        """Drop frame-index entries beyond max_step (checkpoint resume)."""
        steps = [s for s in self.load_steps() if s <= max_step]
        self._write(
            self._data_path(".steps"),
            np.asarray([str(s) for s in steps], dtype=object),
            dtype=_STR,
        )
        self._file.flush()

    def check_positions(self, step: int) -> bool:
        return self._data_path(step, "positions") in self._file

    def save_positions(self, step: int, positions: np.ndarray):
        data = quantize_positions(positions).astype(np.float32)
        self._write(
            self._data_path(step, "positions"),
            data,
            compression="gzip",
            compression_opts=POSITION_COMPRESSION,
            chunks=data.shape if data.size else None,
        )

    def load_positions(self, step: int) -> np.ndarray:
        return self._file[self._data_path(step, "positions")][:].astype(np.float64)

    def save_interphase_context(self, step: int, context: InterphaseContext):
        self._write(self._data_path(step, "context"), context.to_json(), dtype=_STR)

    def load_interphase_context(self, step: int) -> InterphaseContext:
        text = self._file[self._data_path(step, "context")][()]
        if isinstance(text, bytes):
            text = text.decode()
        return InterphaseContext.from_json(text)

    # -- intra-stage checkpointing (new capability over the reference, whose
    # -- only checkpoint granularity is whole stages; SURVEY.md §5.3-5.4) ----

    def save_checkpoint(self, step: int, arrays: dict):
        """Persist a scan-carry snapshot under <stage>/.checkpoint."""
        base = self._data_path(".checkpoint")
        self._write(base + "/step", np.int64(step))
        for name, value in arrays.items():
            self._write(base + "/" + name, np.asarray(value))
        self._file.flush()

    def load_checkpoint(self) -> Optional[dict]:
        base = self._data_path(".checkpoint")
        if base + "/step" not in self._file:
            return None
        group = self._file[base]
        out = {"step": int(group["step"][()])}
        for name in group:
            if name != "step":
                out[name] = group[name][:]
        return out

    def clear_checkpoint(self):
        base = self._data_path(".checkpoint")
        if base in self._file:
            del self._file[base]

    def save_contacts(self, step: int, contacts: np.ndarray):
        """Sorted COO (i, j, count) rows; no-op when empty
        (simulation_store.cpp:253-267)."""
        contacts = np.asarray(contacts, dtype=np.int32).reshape(-1, 3)
        if len(contacts) == 0:
            return
        self._write(
            self._data_path(step, "contacts"),
            contacts,
            compression="gzip",
            compression_opts=CONTACT_COMPRESSION,
            scaleoffset=0,
            chunks=contacts.shape,
        )

    def load_contacts(self, step: int) -> Optional[np.ndarray]:
        path = self._data_path(step, "contacts")
        if path not in self._file:
            return None
        return self._file[path][:]


class MemoryFile:
    """In-memory stand-in for the part of ``h5py.File`` the store uses.

    Datasets are numpy arrays keyed by absolute path; a group is the set of
    paths under its prefix.  Compression and chunking options are accepted
    and ignored.  Pass an instance wherever a trajectory path is expected
    (:func:`prepare_store`, :class:`SimulationStore`); it outlives the
    stores opened on it.
    """

    def __init__(self):
        self._data: dict[str, np.ndarray] = {}
        self._links: dict[str, str] = {}

    def _key(self, path: str) -> str:
        path = "/" + path.strip("/")
        return self._links.get(path, path)

    def __contains__(self, path: str) -> bool:
        key = self._key(path)
        return key in self._data or any(
            k.startswith(key + "/") for k in self._data
        )

    def __getitem__(self, path: str):
        key = self._key(path)
        if key in self._data:
            return self._data[key]
        if key in self:
            return _MemoryGroup(self, key)
        raise KeyError(path)

    def __delitem__(self, path: str):
        key = self._key(path)
        for k in [k for k in self._data if k == key or k.startswith(key + "/")]:
            del self._data[k]

    def create_dataset(self, path: str, data, dtype=None, **storage):
        arr = np.array(data, dtype=dtype)
        if dtype is not None:
            arr = arr.view(np.dtype(dtype))  # keep the dtype's metadata
        self._data[self._key(path)] = arr

    def soft_link(self, existing: str, new: str):
        self._links["/" + new.strip("/")] = "/" + existing.strip("/")

    def flush(self):
        pass

    def close(self):
        pass


class _MemoryGroup:
    def __init__(self, file: MemoryFile, key: str):
        self._file = file
        self._key = key

    def __iter__(self):
        prefix = self._key + "/"
        names = {k[len(prefix):].split("/")[0]
                 for k in self._file._data if k.startswith(prefix)}
        return iter(sorted(names))

    def __getitem__(self, name: str):
        return self._file[self._key + "/" + name]


@contextlib.contextmanager
def _create(filename):
    if isinstance(filename, MemoryFile):
        yield filename
        return
    import h5py

    with h5py.File(filename, "w") as f:
        yield f


def _link(file, existing: str, new: str):
    """Soft link with intermediate group creation (stage_prepare/h5_misc.hpp:9-27)."""
    if isinstance(file, MemoryFile):
        file.soft_link(existing, new)
        return
    import h5py

    parent = new.rsplit("/", 1)[0]
    if parent and parent not in file:
        file.require_group(parent)
    file[new] = h5py.SoftLink(existing)


def prepare_store(
    filename,
    config: SimulationConfig,
    chains: ChainDefinitions,
    topology: GenomeTopology,
    master_seed: int,
):
    """Create a fresh trajectory file with all /metadata and /stages/*/metadata
    datasets, replicating the reference prepare pipeline's writes
    (prepare.cpp:373-562).  ``filename`` may be a :class:`MemoryFile`."""
    with _create(filename) as f:

        def write(path, data, **kw):
            f.create_dataset(path, data=data, **kw)

        write("/metadata/master_seed", np.uint32(master_seed))
        write("/metadata/config", format_config(config), dtype=_STR)
        write("/metadata/config_source", config.source, dtype=_STR)
        write("/metadata/chains_source", chains.source, dtype=_STR)

        inter_enum = _enum_dtype(INTERPHASE_TYPES)
        mitotic_enum = _enum_dtype(MITOTIC_TYPES)

        def write_chain_meta(prefix: str, assigns, enum_dtype, types):
            write(f"{prefix}/particle_types", types.astype(np.int32), dtype=enum_dtype)
            write(
                f"{prefix}/chain_names",
                np.asarray([c.name for c in assigns], dtype=object),
                dtype=_STR,
            )
            write(
                f"{prefix}/chain_ranges",
                np.asarray([[c.start, c.end] for c in assigns], dtype=np.int32),
            )

        # Interphase (+ relaxation via soft links).
        inter = topology.interphase
        iprefix = "/stages/interphase/metadata"
        write_chain_meta(iprefix, inter.chains, inter_enum, inter.particle_types)
        write(f"{iprefix}/ab_factors", inter.ab_factors.astype(np.float32))
        write(
            f"{iprefix}/nucleolar_bonds",
            inter.nucleolar_bonds.astype(np.int32).reshape(-1, 2),
        )
        for key in (
            "particle_types",
            "ab_factors",
            "chain_names",
            "chain_ranges",
            "nucleolar_bonds",
        ):
            _link(f, f"{iprefix}/{key}", f"/stages/relaxation/metadata/{key}")

        # Anatelophase (+ telophase via soft links).
        ana = topology.anatelophase
        aprefix = "/stages/anaphase/metadata"
        write_chain_meta(aprefix, ana.chains, mitotic_enum, ana.particle_types)
        write(
            f"{aprefix}/kinetochore_beads",
            np.asarray(
                [c.kinetochore if c.kinetochore is not None else -1 for c in ana.chains],
                dtype=np.int32,
            ),
        )
        for key in ("particle_types", "chain_names", "chain_ranges"):
            _link(f, f"{aprefix}/{key}", f"/stages/telophase/metadata/{key}")

        # Prometaphase.
        pro = topology.prometaphase
        pprefix = "/stages/prometaphase/metadata"
        write_chain_meta(pprefix, pro.chains, mitotic_enum, pro.particle_types)
        write(
            f"{pprefix}/kinetochore_beads",
            np.asarray(
                [c.kinetochore if c.kinetochore is not None else -1 for c in pro.chains],
                dtype=np.int32,
            ),
        )
        write(
            f"{pprefix}/sister_chromatids",
            pro.sister_chromatids.astype(np.int32),
        )
        write(f"{pprefix}/pole_positions", pro.pole_positions.astype(np.float32))

        # Stage seeds, derived exactly as std::seed_seq (prepare.cpp:549-562).
        seeds = derive_stage_seeds(master_seed)
        for stage, seed in seeds.items():
            write(f"/stages/{stage}/metadata/seed", np.uint32(seed))
