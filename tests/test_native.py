"""Native host-ops: C++ backend vs numpy fallback equivalence."""

import numpy as np
import pytest

from genome_cycle_tpu import native


def test_native_builds():
    # g++ is part of this environment; the library must compile and load.
    assert native.available()


def test_quantize_matches_numpy(rng):
    vals = rng.normal(scale=3.0, size=1000)
    vals[0] = 0.0
    got = native.quantize_f64(vals, 16)
    mant, exp = np.frexp(vals)
    expected = np.ldexp(np.rint(np.ldexp(mant, 16)), exp - 16)
    np.testing.assert_array_equal(got, expected)


def test_merge_contacts(rng):
    keys = rng.integers(0, 50, size=200).astype(np.uint64)
    weights = rng.integers(1, 5, size=200).astype(np.int64)
    uk, uc = native.merge_contact_events(keys, weights)
    assert (np.diff(uk.astype(np.int64)) > 0).all()
    # Totals conserved and per-key sums match a dict-based reference.
    assert uc.sum() == weights.sum()
    ref = {}
    for k, w in zip(keys, weights):
        ref[int(k)] = ref.get(int(k), 0) + int(w)
    assert {int(k): int(c) for k, c in zip(uk, uc)} == ref


def test_merge_contacts_empty():
    uk, uc = native.merge_contact_events(
        np.zeros(0, np.uint64), np.zeros(0, np.int64)
    )
    assert len(uk) == 0 and len(uc) == 0


def test_stale_record_forces_a_rebuild(monkeypatch):
    # A library whose recorded digest differs (e.g. copied with the checkout
    # from another machine) is rebuilt before it is loaded.
    assert native.available()
    native._STAMP_PATH.write_text("0" * 64)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    assert native.available()
    assert native._recorded_digest() == native._build_digest()
    got = native.quantize_f64(np.asarray([1.0 / 3.0]), 16)
    mant, exp = np.frexp(1.0 / 3.0)
    assert got[0] == np.ldexp(np.rint(np.ldexp(mant, 16)), exp - 16)
