"""genome_cycle_tpu — whole-genome cell-cycle Brownian-dynamics framework.

A from-scratch JAX/XLA re-design of the capabilities of
snsinfu/3d-genome-cycle (Fujishiro & Sasai 2025): overdamped-Langevin dynamics
of the diploid human genome as bead-spring polymers through repeated cell
cycles (anaphase -> telophase -> interphase relaxation -> G1 ->
prometaphase/metaphase -> next cycle), plus the Hi-C analysis toolchain
(contact maps, cooler output, dephasing, PC1 compartment profiles, NCI input
prep, GSD visualization dumps).

Layout (see SURVEY.md for the reference layer map this covers):

- :mod:`genome_cycle_tpu.config`    — JSON config (reference-compatible schema)
- :mod:`genome_cycle_tpu.topology`  — chains.tsv parsing + topology compiler
- :mod:`genome_cycle_tpu.store`     — HDF5 trajectory store (reference-exact
  schema), with an in-memory stand-in where h5py is missing
- :mod:`genome_cycle_tpu.ops`       — potentials, forces, pair engines,
  contact map, BD integrator
- :mod:`genome_cycle_tpu.models`    — stage drivers (anatelophase, interphase,
  prometaphase) and structure transitions
- :mod:`genome_cycle_tpu.parallel`  — device meshes: ensemble replica axis and
  bead-sharded force computation
- :mod:`genome_cycle_tpu.analysis`  — nci/annotate/cool/dephase/pc1/dumpgsd
- :mod:`genome_cycle_tpu.utils`     — splines, logging, compile cache and
  device checks
"""

__version__ = "0.1.0"
