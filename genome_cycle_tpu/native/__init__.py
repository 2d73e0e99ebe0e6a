"""Native host-runtime loader: compiles hostops.cpp on first use (ctypes ABI).

Gracefully degrades to numpy implementations when no C++ toolchain is
available; callers use :func:`merge_contact_events` / :func:`quantize_f64`
without caring which backend ran.

The library is built for a generic target of the host's architecture (no
``-march=native``), and a digest of the source, the flags and the host is
recorded beside it: a library whose record differs, for example one copied
with the checkout from another machine, is rebuilt before it is loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import platform
import subprocess
import threading

import numpy as np

_HERE = pathlib.Path(__file__).resolve().parent
_SRC = _HERE / "hostops.cpp"
_LIB_PATH = _HERE / "_hostops.so"
_STAMP_PATH = _HERE / "_hostops.so.sha256"
_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]
_lock = threading.Lock()
_lib = None
_tried = False


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            digest = _build_digest()
            if not _LIB_PATH.exists() or _recorded_digest() != digest:
                # Build beside the target and rename into place, so that a
                # concurrent loader never maps a half-written file.
                tmp = _LIB_PATH.with_name(f"{_LIB_PATH.name}.{os.getpid()}.tmp")
                subprocess.run(
                    ["g++", *_FLAGS, "-o", str(tmp), str(_SRC)],
                    check=True,
                    capture_output=True,
                )
                os.replace(tmp, _LIB_PATH)
                _STAMP_PATH.write_text(digest)
            lib = ctypes.CDLL(str(_LIB_PATH))
            lib.gct_quantize_f64.argtypes = [
                ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int,
            ]
            lib.gct_merge_contacts.argtypes = [
                ctypes.POINTER(ctypes.c_uint64),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_uint64),
                ctypes.POINTER(ctypes.c_int64),
            ]
            lib.gct_merge_contacts.restype = ctypes.c_int64
            _lib = lib
        except Exception:
            _lib = None
        return _lib


def _build_digest() -> str:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    h.update(f"{platform.node()} {platform.machine()}".encode())
    return h.hexdigest()


def _recorded_digest() -> str:
    try:
        return _STAMP_PATH.read_text().strip()
    except OSError:
        return ""


def available() -> bool:
    return _load() is not None


def quantize_f64(values: np.ndarray, bits: int) -> np.ndarray:
    """Mantissa quantization; native when possible, numpy otherwise."""
    lib = _load()
    out = np.ascontiguousarray(values, dtype=np.float64).copy()
    if lib is not None and out.size:
        lib.gct_quantize_f64(
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            out.size,
            bits,
        )
        return out
    mant, exp = np.frexp(out)
    scaled = np.rint(np.ldexp(mant, bits))
    return np.ldexp(scaled, exp - bits)


def merge_contact_events(keys: np.ndarray, weights: np.ndarray):
    """Sum weights of duplicate uint64 keys; returns (sorted unique keys,
    summed counts)."""
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    weights = np.ascontiguousarray(weights, dtype=np.int64)
    n = len(keys)
    lib = _load()
    if lib is not None and n:
        out_keys = np.empty(n, dtype=np.uint64)
        out_counts = np.empty(n, dtype=np.int64)
        m = lib.gct_merge_contacts(
            keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            weights.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n,
            out_keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            out_counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        return out_keys[:m], out_counts[:m]
    uniq, inverse = np.unique(keys, return_inverse=True)
    sums = np.bincount(inverse, weights=weights.astype(np.float64))
    return uniq, np.rint(sums).astype(np.int64)
