"""Conformance tests for the batched analytic ray tracer.

Golden data in tests/golden/raytrace_sp.npz was produced by running the
reference implementation (see generate_raytrace_golden.py): 400 random
geometries in South Pole ice, receiver at (0, 0, -5) m, matching the
distribution of the reference regression test
NuRadioMC/test/SignalProp/T05unit_test_C0_SP.py.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nuradiomc_tpu.models import ice as ice_models
from nuradiomc_tpu.ops import raytrace

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "raytrace_sp.npz")


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.fixture(scope="module")
def solutions(golden):
    ice = ice_models.southpole_simple
    x1 = jnp.asarray(golden["points"])                      # (N, 3)
    x2 = jnp.broadcast_to(jnp.asarray(golden["receiver"]), x1.shape)
    geom = raytrace.to_2d(x1, x2)
    solve = jax.jit(jax.vmap(
        lambda a, b, c, d: raytrace.find_solutions(a, b, c, d, ice)))
    sols = solve(geom.x1y, geom.x1z, geom.x2y, geom.x2z)
    return geom, sols


def test_solution_existence_matches_reference(golden, solutions):
    _, sols = solutions
    ref_has = ~np.isnan(golden["C0"])
    got_has = np.asarray(sols.mask)
    # allow a tiny disagreement budget at the shadow boundary
    disagree = np.sum(ref_has != got_has)
    assert disagree <= 2, f"{disagree} of {ref_has.size} solution-existence mismatches"


def test_c0_matches_reference(golden, solutions):
    _, sols = solutions
    ref = golden["C0"]
    mask = ~np.isnan(ref) & np.asarray(sols.mask)
    got = np.asarray(sols.c0)
    np.testing.assert_allclose(got[mask], ref[mask], rtol=1e-7)


def test_solution_type_matches_reference(golden, solutions):
    _, sols = solutions
    ref = golden["sol_type"]
    mask = (ref > 0) & np.asarray(sols.mask)
    np.testing.assert_array_equal(np.asarray(sols.sol_type)[mask], ref[mask])


def test_path_length_and_travel_time(golden, solutions):
    _, sols = solutions
    mask = ~np.isnan(golden["C0"]) & np.asarray(sols.mask)
    np.testing.assert_allclose(
        np.asarray(sols.path_length)[mask], golden["path_length"][mask], rtol=1e-6)
    np.testing.assert_allclose(
        np.asarray(sols.travel_time)[mask], golden["travel_time"][mask], rtol=1e-6)


def test_launch_receive_vectors(golden, solutions):
    geom, sols = solutions
    launch, receive = raytrace.launch_receive_vectors(geom, sols)
    mask = ~np.isnan(golden["C0"]) & np.asarray(sols.mask)
    np.testing.assert_allclose(
        np.asarray(launch)[mask], golden["launch"][mask], atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(receive)[mask], golden["receive"][mask], atol=1e-6)


def test_attenuation_factors(golden, solutions):
    geom, sols = solutions
    ice = ice_models.southpole_simple
    ff = jnp.asarray(golden["freqs"])
    att = jax.jit(jax.vmap(jax.vmap(
        lambda c0, x1y, x1z, x2y, x2z: raytrace.attenuation_factor(
            c0, x1y, x1z, x2y, x2z, ice, ff, "SP1", n_steps=256),
        in_axes=(0, None, None, None, None)),
    ))(sols.c0, geom.x1y, geom.x1z, geom.x2y, geom.x2z)
    mask = ~np.isnan(golden["C0"]) & np.asarray(sols.mask)
    got = np.asarray(att)[mask]
    ref = golden["attenuation"][mask]
    # reference itself integrates with epsrel=1e-2 and sparse-freq interpolation
    np.testing.assert_allclose(got, ref, atol=5e-3)


def test_f32_c0_accuracy(golden):
    """The float32 path must agree with the reference to ~1e-5 relative."""
    ice = ice_models.southpole_simple
    x1 = jnp.asarray(golden["points"], dtype=jnp.float32)
    x2 = jnp.broadcast_to(jnp.asarray(golden["receiver"], dtype=jnp.float32), x1.shape)
    geom = raytrace.to_2d(x1, x2)
    sols = jax.jit(jax.vmap(
        lambda a, b, c, d: raytrace.find_solutions(a, b, c, d, ice)))(
            geom.x1y, geom.x1z, geom.x2y, geom.x2z)
    ref = golden["C0"]
    mask = ~np.isnan(ref) & np.asarray(sols.mask)
    np.testing.assert_allclose(np.asarray(sols.c0)[mask], ref[mask], rtol=2e-4)


def test_focusing_implicit_matches_numeric():
    """The implicit-differentiation focusing derivative (one gradient pass)
    must match the displaced-receiver numeric re-solve (get_focusing,
    analyticraytracing.py:2778-2888) to <1% on valid slots."""
    import jax
    from nuradiomc_tpu.models.ice import get_ice_model

    ice = get_ice_model("southpole_2015")
    rng = np.random.default_rng(7)
    N = 200
    x1 = np.stack([rng.uniform(-3000, 3000, N), rng.uniform(-3000, 3000, N),
                   rng.uniform(-2500, -5, N)], -1)
    x2 = np.stack([np.zeros(N), np.zeros(N), rng.uniform(-200, -5, N)], -1)
    geom = raytrace.to_2d(jnp.asarray(x1), jnp.asarray(x2))
    solve = jax.vmap(lambda a, b, c, d: raytrace.find_solutions(
        a, b, c, d, ice, n_bisect=96))
    sols = solve(geom.x1y, geom.x1z, geom.x2y, geom.x2z)

    d_imp = np.asarray(raytrace.focusing_dtheta_dz(geom, sols, ice))

    dz = -0.01
    x1z_d = jnp.where(geom.swapped, geom.x1z + dz, geom.x1z)
    x2z_d = jnp.where(geom.swapped, geom.x2z, geom.x2z + dz)
    sols1 = solve(geom.x1y, x1z_d, geom.x2y, x2z_d)
    geom_d = raytrace.Geometry2D(geom.x1y, x1z_d, geom.x2y, x2z_d,
                                 geom.swapped, geom.dphi, geom.ux, geom.uy)
    l0, _ = raytrace.launch_receive_vectors(geom, sols)
    l1, _ = raytrace.launch_receive_vectors(geom_d, sols1)
    la0 = np.arccos(np.clip(np.asarray(l0)[..., 2], -1, 1))
    la1 = np.arccos(np.clip(np.asarray(l1)[..., 2], -1, 1))
    d_num = np.abs(la1 - la0) / abs(dz)

    m = np.asarray(sols.mask & sols1.mask) & (d_num > 1e-9)
    assert m.sum() > 100
    rel = np.abs(d_imp - d_num) / np.maximum(d_num, 1e-12)
    assert np.median(rel[m]) < 1e-3
    assert rel[m].max() < 0.01


def test_sp1_moment_quadrature_equivalence(golden, solutions):
    """The moment-factored SP1 quadrature (one exp per depth sample,
    Taylor-in-(bb - b_bar) frequency evaluation) must agree with the exact
    exp(b1 + bb*w) branch quadrature (attenuation_factor_general, which
    evaluates inv_length_factored per (sample, frequency)) to ~1e-4 across
    the full band incl. sub-MHz frequencies."""
    geom, sols = solutions
    ice = ice_models.southpole_simple
    # wide grid: 0.3 MHz .. 5 GHz
    ff = jnp.asarray(np.geomspace(3e-4, 5.0, 24))

    # the same internal classification attenuation_factor uses (sol_type
    # from find_solutions can disagree near the shadow boundary)
    mirror = jax.jit(jax.vmap(jax.vmap(
        lambda c0, a, b, c, d: raytrace._solution_type(c0, a, b, c, d, ice)
        != raytrace.SOL_DIRECT,
        in_axes=(0, None, None, None, None)),
    ))(sols.c0, geom.x1y, geom.x1z, geom.x2y, geom.x2z)

    def general(c0, m, x1z, x2z):
        def f(mm):
            return raytrace.attenuation_factor_general(
                c0, x1z, x2z, ice, ff, "SP1", r=0, case=1, mirror=mm,
                n_steps=128, quadrature="gauss")
        return jnp.where(m, f(True), f(False))

    exact = jax.jit(jax.vmap(jax.vmap(
        general, in_axes=(0, 0, None, None)),
    ))(sols.c0, mirror, geom.x1z, geom.x2z)

    fast = jax.jit(jax.vmap(jax.vmap(
        lambda c0, x1y, x1z, x2y, x2z: raytrace.attenuation_factor(
            c0, x1y, x1z, x2y, x2z, ice, ff, "SP1", n_steps=128,
            quadrature="gauss"),
        in_axes=(0, None, None, None, None)),
    ))(sols.c0, geom.x1y, geom.x1z, geom.x2y, geom.x2z)

    mask = np.asarray(sols.mask) & (np.asarray(sols.sol_type) != 3)
    # (reflected rays clamp z_top to the surface in attenuation_factor but
    # not in the r=0 general path's turning point -- excluded: different
    # node placement, not different math)
    np.testing.assert_allclose(np.asarray(fast)[mask],
                               np.asarray(exact)[mask], atol=2e-4, rtol=2e-4)

    # float32 path stays well-behaved (excluding slots whose direct/mirror
    # classification flips at reduced precision near the shadow boundary —
    # a different path, not a different quadrature)
    mirror32 = jax.jit(jax.vmap(jax.vmap(
        lambda c0, a, b, c, d: raytrace._solution_type(c0, a, b, c, d, ice)
        != raytrace.SOL_DIRECT,
        in_axes=(0, None, None, None, None)),
    ))(jnp.asarray(sols.c0, jnp.float32),
       jnp.asarray(geom.x1y, jnp.float32), jnp.asarray(geom.x1z, jnp.float32),
       jnp.asarray(geom.x2y, jnp.float32), jnp.asarray(geom.x2z, jnp.float32))
    mask32 = mask & (np.asarray(mirror32) == np.asarray(mirror))
    fast32 = jax.jit(jax.vmap(jax.vmap(
        lambda c0, x1y, x1z, x2y, x2z: raytrace.attenuation_factor(
            c0, x1y, x1z, x2y, x2z, ice, jnp.asarray(ff, jnp.float32),
            "SP1", n_steps=32, quadrature="gauss"),
        in_axes=(0, None, None, None, None)),
    ))(jnp.asarray(sols.c0, jnp.float32),
       jnp.asarray(geom.x1y, jnp.float32), jnp.asarray(geom.x1z, jnp.float32),
       jnp.asarray(geom.x2y, jnp.float32), jnp.asarray(geom.x2z, jnp.float32))
    np.testing.assert_allclose(np.asarray(fast32)[mask32],
                               np.asarray(exact)[mask32], atol=2e-3)
