"""Command-line interface mirroring the reference's five stage binaries plus
the `simulate` orchestration script.

Usage (one trajectory file carries the whole cell cycle, SURVEY.md §3):

    python -m genome_cycle_tpu.cli prepare [-s SEED] -o out.h5 config.json chains.tsv
    python -m genome_cycle_tpu.cli anatelophase out.h5
    python -m genome_cycle_tpu.cli transition {interphase|prometaphase} out.h5
    python -m genome_cycle_tpu.cli transition cycle prev.h5 next.h5
    python -m genome_cycle_tpu.cli interphase out.h5
    python -m genome_cycle_tpu.cli prometaphase out.h5
    python -m genome_cycle_tpu.cli simulate [-s SEED] -o out.h5 config.json chains.tsv
    python -m genome_cycle_tpu.cli cycles -n 3 [-s SEED] -o prefix config.json chains.tsv

`simulate` = prepare + anatelophase + transition interphase + interphase
(scripts/simulate:42-45).  `cycles` runs the full multi-cycle experiment the
reference leaves to ad-hoc scripting (SURVEY.md §3.4).
"""

from __future__ import annotations

import argparse
import sys
import time

from .store import SimulationStore
from .utils.logging import log_stderr
from .utils.runtime import enable_compile_cache


def _add_store_cmd(sub, name, help_text):
    p = sub.add_parser(name, help=help_text)
    p.add_argument("trajectory", help="trajectory .h5 file")
    return p


ANALYSIS_COMMANDS = {
    "nci": "genome_cycle_tpu.analysis.nci",
    "annotate": "genome_cycle_tpu.analysis.annotate",
    "cool": "genome_cycle_tpu.analysis.cool",
    "dephase": "genome_cycle_tpu.analysis.dephase",
    "pc1": "genome_cycle_tpu.analysis.pc1",
    "dumpgsd": "genome_cycle_tpu.analysis.dumpgsd",
}


def run_cell_cycle(store, log=print) -> dict:
    """Every stage of one cell after ``prepare``: anaphase/telophase, the
    spline transition, relaxation + G1, the prometaphase transition and
    prometaphase — what ``cycles`` runs for each cycle.  Returns each
    stage's wall seconds, compiles included."""
    from .models.anatelophase import run_anatelophase
    from .models.interphase import run_interphase
    from .models.prometaphase import run_prometaphase
    from .models.transitions import (
        transition_interphase,
        transition_prometaphase,
    )

    seconds = {}
    for name, stage in (
        ("anatelophase", run_anatelophase),
        ("transition interphase", transition_interphase),
        ("interphase", run_interphase),
        ("transition prometaphase", transition_prometaphase),
        ("prometaphase", run_prometaphase),
    ):
        t0 = time.perf_counter()
        stage(store, log=log)
        seconds[name] = time.perf_counter() - t0
        log(f"{name}: {seconds[name]:.1f} s")
    return seconds


def main(argv=None):
    if argv is None:
        argv = sys.argv[1:]
    # Adaptive capacity changes re-jit chunks; revisited capacities and
    # re-runs load them from the persistent cache.
    enable_compile_cache()

    # Analysis tools keep their own argparse CLIs (mirroring the reference's
    # scripts/_run_py symlink dispatch); forward to them.
    if argv and argv[0] in ANALYSIS_COMMANDS:
        import importlib

        module = importlib.import_module(ANALYSIS_COMMANDS[argv[0]])
        old_argv = sys.argv
        sys.argv = [argv[0]] + list(argv[1:])
        try:
            from .analysis.common import invoke_main
            import logging

            invoke_main(module.main, module.parse_args(), logging.getLogger())
        finally:
            sys.argv = old_argv
        return

    parser = argparse.ArgumentParser(
        prog="genome_cycle_tpu",
        description="whole-genome cell-cycle simulator",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("prepare", help="compile config + chains into a new store")
    p.add_argument("-s", "--seed", type=int, default=None)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("config")
    p.add_argument("chains")

    _add_store_cmd(sub, "anatelophase", "run anaphase + telophase")
    p = _add_store_cmd(sub, "interphase", "run relaxation + G1 interphase")
    p.add_argument(
        "--profile",
        metavar="DIR",
        default=None,
        help="capture a jax.profiler trace of the run into DIR "
        "(view with TensorBoard / xprof)",
    )
    p.add_argument(
        "--shards",
        type=int,
        default=None,
        metavar="N",
        help="spatially decompose the G1 phase over N devices (x-slab "
        "ownership + halo exchange over the device mesh); same output "
        "schema/semantics as the single-device run — trajectories are "
        "reproducible across shard counts (per-bead noise), not bitwise "
        "identical to the unsharded run",
    )
    _add_store_cmd(sub, "prometaphase", "run prometaphase/metaphase")

    p = sub.add_parser("transition", help="convert structures between stages")
    tsub = p.add_subparsers(dest="mode", required=True)
    _add_store_cmd(tsub, "interphase", "telophase -> relaxation initial structure")
    _add_store_cmd(tsub, "prometaphase", "interphase -> prometaphase initial structure")
    pc = tsub.add_parser("cycle", help="metaphase of prev -> anaphase of next")
    pc.add_argument("prev")
    pc.add_argument("next")

    p = sub.add_parser("simulate", help="prepare + anatelophase + interphase")
    p.add_argument("-s", "--seed", type=int, default=None)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("config")
    p.add_argument("chains")

    p = sub.add_parser("cycles", help="multi-cycle experiment (one file per cycle)")
    p.add_argument("-n", "--cycles", type=int, default=3)
    p.add_argument("-s", "--seed", type=int, default=None)
    p.add_argument("-o", "--output-prefix", required=True)
    p.add_argument("config")
    p.add_argument("chains")

    p = sub.add_parser(
        "ensemble",
        help="R replica interphase runs in lock-step (one vmapped program), "
        "one trajectory file each — the reference's multi-file ensemble "
        "(merged downstream by `cool` over all files)",
    )
    p.add_argument("-n", "--replicas", type=int, default=4)
    p.add_argument("-s", "--seed", type=int, default=None)
    p.add_argument("-o", "--output-prefix", required=True)
    p.add_argument("config")
    p.add_argument("chains")

    sub.add_parser(
        "analysis-help",
        help="analysis tools: " + ", ".join(ANALYSIS_COMMANDS),
    )

    args = parser.parse_args(argv)
    log = log_stderr

    if args.command == "prepare":
        from .models.prepare import run_prepare

        run_prepare(args.output, args.config, args.chains, args.seed, log=log)

    elif args.command == "anatelophase":
        from .models.anatelophase import run_anatelophase

        with SimulationStore(args.trajectory) as store:
            run_anatelophase(store, log=log)

    elif args.command == "interphase":
        import contextlib

        from .models.interphase import run_interphase

        profile_ctx = contextlib.nullcontext()
        if getattr(args, "profile", None):
            import jax

            profile_ctx = jax.profiler.trace(args.profile)
        with profile_ctx, SimulationStore(args.trajectory) as store:
            run_interphase(store, log=log, n_shards=args.shards)

    elif args.command == "prometaphase":
        from .models.prometaphase import run_prometaphase

        with SimulationStore(args.trajectory) as store:
            run_prometaphase(store, log=log)

    elif args.command == "transition":
        from .models import transitions

        if args.mode == "interphase":
            with SimulationStore(args.trajectory) as store:
                transitions.transition_interphase(store, log=log)
        elif args.mode == "prometaphase":
            with SimulationStore(args.trajectory) as store:
                transitions.transition_prometaphase(store, log=log)
        else:
            with SimulationStore(args.prev) as prev, SimulationStore(args.next) as nxt:
                transitions.transition_cycle(prev, nxt, log=log)

    elif args.command == "simulate":
        from .models.anatelophase import run_anatelophase
        from .models.interphase import run_interphase
        from .models.prepare import run_prepare
        from .models.transitions import transition_interphase

        run_prepare(args.output, args.config, args.chains, args.seed, log=log)
        with SimulationStore(args.output) as store:
            run_anatelophase(store, log=log)
            transition_interphase(store, log=log)
            run_interphase(store, log=log)

    elif args.command == "ensemble":
        import contextlib

        from .models.anatelophase import run_anatelophase
        from .models.prepare import run_prepare
        from .models.transitions import transition_interphase
        from .parallel.ensemble import run_ensemble_interphase

        paths = [
            f"{args.output_prefix}rep_{k}.h5" for k in range(args.replicas)
        ]
        for k, path in enumerate(paths):
            seed = None if args.seed is None else args.seed + k
            log(f"=== replica {k}: {path} ===")
            run_prepare(path, args.config, args.chains, seed, log=log)
            with SimulationStore(path) as store:
                run_anatelophase(store, log=log)
                transition_interphase(store, log=log)
        log(f"=== ensemble interphase: {args.replicas} replicas lock-step ===")
        with contextlib.ExitStack() as stack:
            stores = [
                stack.enter_context(SimulationStore(p)) for p in paths
            ]
            run_ensemble_interphase(stores, log=log)

    elif args.command == "cycles":
        from .models.prepare import run_prepare
        from .models.transitions import transition_cycle

        prev_path = None
        base_seed = args.seed
        for k in range(args.cycles):
            path = f"{args.output_prefix}cell_{k}.h5"
            seed = None if base_seed is None else base_seed + k
            log(f"=== cycle {k}: {path} ===")
            run_prepare(path, args.config, args.chains, seed, log=log)
            if prev_path is not None:
                with SimulationStore(prev_path) as prev, SimulationStore(path) as nxt:
                    transition_cycle(prev, nxt, log=log)
            with SimulationStore(path) as store:
                run_cell_cycle(store, log=log)
            prev_path = path


if __name__ == "__main__":
    main()
