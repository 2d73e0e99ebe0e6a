"""Multi-host scaffolding: 2-process distributed runtime over CPU devices.

SURVEY.md §2.11/§5.8: the replica axis spans hosts (independent work), the
beads axis stays inside one host.  Real multi-host hardware is absent here, so the
scaffolding is validated the JAX-blessed way: two OS processes join one
distributed runtime through a coordinator and execute a fully sharded step
on the global hybrid mesh (one replica per "host", beads axis inside each
process's devices).
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import __graft_entry__ as ge  # noqa: E402


def test_two_process_distributed_step():
    # 4 global devices: 2 processes x 2 CPU devices; raises on any failure.
    ge._dryrun_two_process(4)


def test_two_process_store_backed_interphase():
    # Full run_interphase over a 2-process global beads mesh, each process
    # against its own store copy; rank 0's trajectory is validated
    # (reference surface: one command -> one trajectory).
    ge._dryrun_two_process_store(4)
