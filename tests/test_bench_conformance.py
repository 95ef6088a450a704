"""Unit tests for bench.py's chip-side conformance layer (no device, no
jit): the per-group vector pins must reject what the count tolerances
could not — offsetting decision flips, per-pair solution jumps, and PA
physics shifts beyond the measured chip-vs-CPU borderline density.

The pinned vectors (tests/golden/bench_pins.npz) are written on the CPU
backend by tools/pin_bench_conformance.py; the bounds (bench.VECTOR_PINS)
leave headroom over the measured device-vs-CPU flip counts (PERF.md).
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench


@pytest.fixture(scope="module")
def pins():
    z = bench._load_pins()
    assert z is not None, "tests/golden/bench_pins.npz missing"
    return z


def _check(mode, vec):
    return bench._conformance_check(mode, lambda _: np.asarray(vec), None)


def test_exact_match_passes(pins):
    for mode, (key, _, _) in bench.VECTOR_PINS.items():
        count, expected = _check(mode, pins[key].astype(np.int32))
        assert count == expected


def test_flip_bound_enforced(pins):
    v = pins["veff_trig"].astype(np.int32)
    key, kind, bound = bench.VECTOR_PINS["veff_f32"]
    zeros = np.where(v == 0)[0]
    v2 = v.copy()
    v2[zeros[:bound]] ^= 1
    _check("veff_f32", v2)          # at the bound: accepted
    v2[zeros[bound]] ^= 1
    with pytest.raises(AssertionError):
        _check("veff_f32", v2)      # one past the bound: rejected


def test_offsetting_flips_cannot_hide(pins):
    """The failure mode the count tolerance had: +n and -n flips cancel.

    60 up-flips + 60 down-flips leave the COUNT exactly at the pin but are
    120 decision flips — far outside any measured rounding population."""
    v = pins["veff_trig"].astype(np.int32)
    ups = np.where(v == 0)[0][:60]
    downs = np.where(v == 1)[0][:60]
    v2 = v.copy()
    v2[ups] ^= 1
    v2[downs] ^= 1
    assert v2.sum() == v.sum()
    with pytest.raises(AssertionError):
        _check("veff_f32", v2)


def test_pa_flips_count_per_source(pins):
    """The PA batch tiles ~5.5 copies of 3000 source events: one borderline
    SOURCE flips all its copies at once, so flips are counted modulo the
    tiling period (pa_g0), not per group."""
    v = pins["pa_nl_trig"].astype(np.int32)
    g0 = int(pins["pa_g0"])
    v2 = v.copy()
    src = 17
    for c in range(len(v) // g0 + 1):           # every copy of one source
        if src + c * g0 < len(v2):
            v2[src + c * g0] ^= 1
    count, _ = _check("pa_noiseless", v2)       # 1 source flip: fine
    # a >=5% PA physics bug shifts >= 8 distinct sources -> rejected
    v3 = v.copy()
    for src in range(9):
        v3[src] ^= 1
    with pytest.raises(AssertionError):
        _check("pa_noiseless", v3)


def test_raytrace_bounds_solution_jumps(pins):
    v = pins["rt_nsol"].astype(np.int32)
    v2 = v.copy()
    v2[7] += 2                                   # shadow-boundary pair: ok
    _check("raytrace", v2)
    v3 = v.copy()
    v3[7] += 3                                   # |delta| > 2: a real bug
    with pytest.raises(AssertionError):
        _check("raytrace", v3)
