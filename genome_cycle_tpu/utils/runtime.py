"""Process set-up shared by the CLI, the benchmarks and the chip smoke test:
where the persistent compile cache lives, and which device a measurement
ran on."""

from __future__ import annotations

import os
import pathlib
import subprocess

CHECKOUT = pathlib.Path(__file__).resolve().parents[2]


def compile_cache_dir() -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` when set, else ``<checkout>/.jax_cache``.

    A fixed path: the cache directory is part of what a later run must find
    again, so it never depends on the home directory, a temporary name, the
    process or the time."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(
        CHECKOUT / ".jax_cache"
    )


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at :func:`compile_cache_dir`.

    JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself, so when it is set this
    configures nothing."""
    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu() -> dict:
    """The device record every measurement prints; raises unless JAX's
    default device is a GPU (a measurement never falls back to the CPU)."""
    import jax

    devices = jax.devices()
    info = {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }
    if info["platform"] != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default device is {info['platform']} "
            f"({info['kind']})"
        )
    return info


def card_line() -> str:
    """``name, power.limit`` of each card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip()
