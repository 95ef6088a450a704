"""Batched analytic ray tracing in exponential ice (JAX).

A batch-first re-design of the reference analytic ray tracer
(NuRadioMC/SignalProp/analyticraytracing.py). The reference solves, per
(source, receiver) pair, for the parameter ``C_0`` of the closed-form ray path

    y(z) = z_0 / sqrt(n_ice^2 C_0^2 - 1) * ln(gamma / (2 sqrt(c) sqrt(gamma^2
           - gamma b + c) - b gamma + 2 c)) + C_1,
    gamma(z) = delta_n exp(z / z_0),  b = 2 n_ice,  c = n_ice^2 - C_0^-2

(analyticraytracing.py:105-125) using scipy ``optimize.root`` plus two
``brentq`` bracketed searches (find_solutions:1400-1547), one host call per
pair. Here the entire solve is a fixed-shape batched device computation:

* The objective ``delta_y(logC0)`` tends to a negative value at both ends of
  the logC0 axis ("turning point too deep" penalty on the left, mirrored
  overshoot on the right), so it has either zero or two roots. We locate its
  maximum with a dense grid + golden-section refinement, then run
  fixed-iteration bisection from the maximum towards both ends. No dynamic
  control flow; invalid pairs carry a validity mask.
* All observables (launch/receive angle, path length, travel time) use the
  closed forms only (analyticraytracing.py:602-783, Bouma thesis formulas) —
  scipy.quad is gone.
* The frequency-dependent attenuation integral uses the substitution
  z = z_turn - t^2 which removes the 1/sqrt turning-point singularity of
  ds/dz, so a fixed-K midpoint rule is accurate and fully batched
  (replaces get_attenuation_along_path:933-1089).

Solution slots: 2 per (pair, bottom-reflection level), matching the
reference's 2*(n_reflections+1) output layout (propagation_base_class.py:424).
Solutions are sorted by C0 ascending (find_solutions:1547).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from nuradiomc_tpu.models.ice import IceModelSimple
from nuradiomc_tpu.ops import attenuation as attenuation_ops
from nuradiomc_tpu.utils.constants import speed_of_light

# solution types (propagation.py:3-8)
SOL_DIRECT = 1
SOL_REFRACTED = 2
SOL_REFLECTED = 3

_LOGC0_LO = -100.0
_LOGC0_HI = 100.0
# |delta_y| acceptance for a grazing (tangent) solution; the reference accepts
# the squared objective < 1e-7 (find_solutions:1484)
_TANGENT_TOL = 3.16e-4


def _c0_from_log(logc0, n_ice):
    """C0 reparametrization, get_C0_from_log (analyticraytracing.py:99-103)."""
    return jnp.exp(logc0) + 1.0 / n_ice


def _gamma(z, ice: IceModelSimple):
    return ice.delta_n * jnp.exp((z - ice.z_shift) / ice.z_0)


def _n_z(z, ice: IceModelSimple):
    """In-ice refractive index (no air branch; rays here live below surface)."""
    return ice.n_ice - ice.delta_n * jnp.exp((z - ice.z_shift) / ice.z_0)


def _arg_stable(z, c0, ice: IceModelSimple):
    """c0^2 n(z)^2 - 1 without the near-turning-point cancellation.

    The naive form subtracts two ~1 numbers (float32 noise ~1e-7 absolute),
    which inflates the 1/sqrt(arg) path-measure by orders of magnitude for
    quadrature nodes near the turning point (true arg ~ t^2 * dn2/dz). The
    factored identity  arg = c0 (gamma_t - gamma(z)) (c0 n(z) + 1)  with
    gamma_t - gamma(z) = -gamma_t expm1((z - z_turn_raw)/z_0)  evaluates the
    small factor directly (z_turn_raw = UNclamped turning depth)."""
    b = 2.0 * ice.n_ice
    c = ice.n_ice ** 2 - c0 ** -2
    disc = jnp.sqrt(jnp.maximum(0.25 * b * b - c, 0.0))
    gamma_t = c / (0.5 * b + disc)
    # dz = z - z_turn_raw; gamma_t <= 0 (no turning) -> dz large negative
    safe_g = jnp.maximum(gamma_t, 1e-30)
    dz = (z - ice.z_shift) - jnp.log(safe_g / ice.delta_n) * ice.z_0
    dgamma = -safe_g * jnp.expm1(jnp.minimum(dz / ice.z_0, 0.0))
    nz = _n_z(z, ice)
    return c0 * dgamma * (c0 * nz + 1.0)


def _turning_point(c0, ice: IceModelSimple):
    """(gamma_turn, z_turn); stable form of get_turning_point (:133-158).

    gamma_turn = b/2 - sqrt(b^2/4 - c) is rewritten as c / (b/2 + sqrt(...))
    to avoid catastrophic cancellation for steep rays (c -> 0).
    """
    b = 2.0 * ice.n_ice
    c = ice.n_ice ** 2 - c0 ** -2
    disc = jnp.sqrt(jnp.maximum(0.25 * b * b - c, 0.0))
    gamma2 = c / (0.5 * b + disc)
    z2 = jnp.log(gamma2 / ice.delta_n) * ice.z_0 + ice.z_shift
    # saddle point above surface -> surface reflection: turning at z=0
    above = z2 > 0
    z2 = jnp.where(above, 0.0, z2)
    gamma2 = jnp.where(above, _gamma(0.0, ice), gamma2)
    return gamma2, z2


def _y_of_gamma(gamma, c0, c1, ice: IceModelSimple):
    """Closed-form ray path y(gamma) (get_y, analyticraytracing.py:105-125)."""
    b = 2.0 * ice.n_ice
    c = ice.n_ice ** 2 - c0 ** -2
    root = jnp.abs(gamma ** 2 - gamma * b + c)
    logargument = gamma / (2 * jnp.sqrt(c) * jnp.sqrt(root) - b * gamma + 2 * c)
    return ice.z_0 / jnp.sqrt(ice.n_ice ** 2 * c0 ** 2 - 1.0) * jnp.log(logargument) + c1


def _y_with_mirror(z, c0, ice: IceModelSimple, c1=0.0):
    """y(z) continued beyond the turning point by mirroring (get_y_with_z_mirror:161-184)."""
    gamma_turn, z_turn = _turning_point(c0, ice)
    y_turn = _y_of_gamma(gamma_turn, c0, c1, ice)
    below = z < z_turn
    y_below = _y_of_gamma(_gamma(z, ice), c0, c1, ice)
    y_above = 2 * y_turn - _y_of_gamma(_gamma(2 * z_turn - z, ice), c0, c1, ice)
    return jnp.where(below, y_below, y_above)


def _c1_of(x1y, x1z, c0, ice: IceModelSimple):
    """Integration constant pinning the path to x1 (get_C_1, :489-491)."""
    return x1y - _y_with_mirror(x1z, c0, ice)


def delta_y(c0, x1y, x1z, x2y, x2z, ice: IceModelSimple):
    """Miss distance at the receiver for trial parameter C0.

    Batched re-expression of get_delta_y (analyticraytracing.py:204-272) for
    the in-ice, no-bottom-reflection case. Positive when the ray path at the
    receiver depth falls short of the receiver (direct branch), with the
    "turning point too deep" penalty and the mirrored overshoot branch making
    the function end negative on both ends of the logC0 axis.
    """
    c1 = _c1_of(x1y, x1z, c0, ice)
    gamma_turn, z_turn = _turning_point(c0, ice)
    y_turn = _y_of_gamma(gamma_turn, c0, c1, ice)

    # penalty branch: turning point deeper than receiver -> can't reach
    # (reference: -(dist + 10 |z_turn - z2|), :243-250)
    penalty = -(jnp.sqrt((z_turn - x2z) ** 2 + (y_turn - x2y) ** 2)
                + 10.0 * jnp.abs(z_turn - x2z))

    # direct branch (receiver before the turning point)
    y2_direct = _y_of_gamma(_gamma(x2z, ice), c0, c1, ice)
    d_direct = x2y - y2_direct

    # mirrored branch (receiver past the turning point)
    y2_mirror = 2 * y_turn - _y_of_gamma(_gamma(x2z, ice), c0, c1, ice)
    d_mirror = -(x2y - y2_mirror)

    out = jnp.where(y_turn > x2y, d_direct, d_mirror)
    return jnp.where(z_turn < x2z, penalty, out)


def _delta_y_log(logc0, x1y, x1z, x2y, x2z, ice: IceModelSimple):
    return delta_y(_c0_from_log(logc0, ice.n_ice), x1y, x1z, x2y, x2z, ice)


class RaySolutions(NamedTuple):
    """Struct-of-arrays ray-tracing solutions; leading axes = batch, last = slot."""

    c0: jnp.ndarray            # path parameter C0
    c1: jnp.ndarray            # path parameter C1
    mask: jnp.ndarray          # bool, slot holds a valid solution
    sol_type: jnp.ndarray      # 1 direct / 2 refracted / 3 reflected
    launch_angle: jnp.ndarray  # 2D launch zenith (rad, from +z)
    receive_angle: jnp.ndarray # 2D receive zenith (rad, from +z)
    path_length: jnp.ndarray
    travel_time: jnp.ndarray
    reflection: jnp.ndarray    # number of bottom reflections
    refl_case: jnp.ndarray     # 1 up-going start, 2 down-going start


def _w_up(z, c0, ice: IceModelSimple):
    """Horizontal advance of the rising ray, y(gamma(z)) with C1 = 0."""
    return _y_of_gamma(_gamma(z, ice), c0, 0.0, ice)


def _branch_misses(logc0, x1z, x2z, dy_target, ice: IceModelSimple):
    """(miss_direct, miss_mirror) for trial logC0.

    The two-point problem decomposes into two monotone branches over
    C0 in (C0_min, inf), where C0_min is the ray whose turning point sits at
    the receiver depth:

    * direct:  horizontal advance  w(z2) - w(z1)            (rising part only)
    * mirror:  advance 2 w(z_turn) - w(z2) - w(z1)          (up, turn, down)

    The direct advance = int_{z1}^{z2} dz / sqrt(C0^2 n^2 - 1) is strictly
    decreasing in C0, so ``dy_target - advance`` crosses zero exactly once.
    The mirror branch behaves the same way in practice. This replaces the
    reference's root-then-bracket search (find_solutions:1479-1547) with two
    guaranteed bisections — and is robust where the combined objective has a
    sign change squeezed into a narrow logC0 window (near-merged solutions).
    """
    c0 = _c0_from_log(logc0, ice.n_ice)
    _, z_turn = _turning_point(c0, ice)
    w1 = _w_up(x1z, c0, ice)
    w2 = _w_up(x2z, c0, ice)
    wt = _w_up(z_turn, c0, ice)
    return dy_target - (w2 - w1), dy_target - (2 * wt - w2 - w1)


def _logc0_min(x2z, ice: IceModelSimple):
    """log-parametrized C0 of the ray that turns exactly at the receiver depth.

    gamma_turn = gamma(z2) implies c = gamma2 (b - gamma2); C0 = (n_ice^2-c)^-0.5.
    """
    gamma2 = _gamma(x2z, ice)
    b = 2.0 * ice.n_ice
    c = gamma2 * (b - gamma2)
    c0_min = 1.0 / jnp.sqrt(ice.n_ice ** 2 - c)
    return jnp.log(c0_min - 1.0 / ice.n_ice)


def _bracketed_solve(f, lo, hi, f_lo, n_bisect: int):
    """Root of monotone-sign-change f on [lo, hi]: bisection narrows the
    bracket, then a safeguarded-secant (false-position) polish converges
    superlinearly — n_bisect total evaluations reach the precision of ~2.5x
    as many pure-bisection steps. The polish iterate is clamped to the live
    bracket, so robustness is identical to bisection."""
    n_secant = max(min(4, n_bisect // 4), 0)
    n_narrow = n_bisect - n_secant - (2 if n_secant else 0)

    def body(_, st):
        lo_, hi_ = st
        mid = 0.5 * (lo_ + hi_)
        same = jnp.sign(f(mid)) == jnp.sign(f_lo)
        return jnp.where(same, mid, lo_), jnp.where(same, hi_, mid)
    lo_, hi_ = jax.lax.fori_loop(0, n_narrow, body, (lo, hi))
    if n_secant == 0:
        return 0.5 * (lo_ + hi_)

    f_a = f(lo_)
    f_b = f(hi_)
    tiny = jnp.asarray(1e-30, lo_.dtype)

    def polish(_, st):
        a, b, fa, fb = st
        denom = fb - fa
        x = b - fb * (b - a) / jnp.where(jnp.abs(denom) > tiny, denom, tiny)
        x = jnp.clip(x, jnp.minimum(a, b), jnp.maximum(a, b))
        fx = f(x)
        same = jnp.sign(fx) == jnp.sign(f_lo)
        return (jnp.where(same, x, a), jnp.where(same, b, x),
                jnp.where(same, fx, fa), jnp.where(same, fb, fx))
    a, b, _, _ = jax.lax.fori_loop(0, n_secant, polish, (lo_, hi_, f_a, f_b))
    return 0.5 * (a + b)


_GOLDEN_ITERS = 48
_INV_PHI = 0.6180339887498949


def _golden_min(f, lo, hi, n_iter: int = _GOLDEN_ITERS):
    """Argmin of a unimodal f on [lo, hi] by golden-section (fixed trip count)."""
    a, b = lo, hi
    c = b - _INV_PHI * (b - a)
    d = a + _INV_PHI * (b - a)
    fc, fd = f(c), f(d)

    def body(_, st):
        a, b, c, d, fc, fd = st
        # <= tie-break: the advance is exactly flat (in f64) over most of the
        # wide logC0 domain; a strict < would walk the bracket into the
        # plateau on the right instead of keeping the minimum on the left
        left = fc <= fd
        a2 = jnp.where(left, a, c)
        b2 = jnp.where(left, d, b)
        c2 = b2 - _INV_PHI * (b2 - a2)
        d2 = a2 + _INV_PHI * (b2 - a2)
        # only one of (c2, d2) is a new point; evaluate both for simplicity
        return a2, b2, c2, d2, f(c2), f(d2)

    a, b, _, _, _, _ = jax.lax.fori_loop(0, n_iter, body, (a, b, c, d, fc, fd))
    return 0.5 * (a + b)


def _solve_branch_pair(f_direct, f_mirror, lo0, hi0, n_bisect: int):
    """Up to two roots of the (direct, mirror) branch pair of one path family.

    The direct branch (final leg rising) is strictly monotone: at most one
    root. The mirror branch (final leg descending after the turn) is
    *unimodal* but NOT monotone: near the shadow boundary both physical
    solutions sit on it (the reference's combined delta_y objective finds them
    as the root pair around its maximum, find_solutions:1500-1543). We locate
    the mirror branch's minimum by golden-section and bisect each side.

    Since advance_mirror(C0_min) == advance_direct(C0_min) (the turning point
    sits exactly at the receiver, so the descending leg has zero length), a
    direct root existing implies f_mirror(lo0) < 0 and the low-side mirror
    root cannot coexist with it: the layout stays 2 slots.

    Returns (root0, valid0, mirror0, root1, valid1); root1 is always mirror.
    """
    def bisect(f, lo, hi, f_lo):
        return _bracketed_solve(f, lo, hi, f_lo, n_bisect)

    fd_lo = f_direct(lo0)
    fd_hi = f_direct(hi0)
    has_direct = jnp.sign(fd_lo) != jnp.sign(fd_hi)
    r_direct = bisect(f_direct, lo0, hi0, fd_lo)

    mid = _golden_min(f_mirror, lo0, hi0)
    fm_lo = f_mirror(lo0)
    fm_mid = f_mirror(mid)
    fm_hi = f_mirror(hi0)
    has_m_hi = jnp.sign(fm_mid) != jnp.sign(fm_hi)
    r_m_hi = bisect(f_mirror, mid, hi0, fm_mid)
    has_m_lo = (jnp.sign(fm_lo) != jnp.sign(fm_mid)) & ~has_direct
    r_m_lo = bisect(f_mirror, lo0, mid, fm_lo)

    # grazing (tangent) geometry: both branches touch zero at C0_min
    tangent = (~has_direct) & (~has_m_lo) & (jnp.abs(fd_lo) < _TANGENT_TOL)
    root0 = jnp.where(has_direct, r_direct, jnp.where(has_m_lo, r_m_lo, lo0))
    valid0 = has_direct | has_m_lo | tangent
    mirror0 = ~has_direct & has_m_lo
    return root0, valid0, mirror0, r_m_hi, has_m_hi


def _solve_two_roots(x1y, x1z, x2y, x2z, ice: IceModelSimple, n_bisect: int):
    """Find the two ray-tracing roots (direct + mirror branch) for one geometry.

    Returns (logc0[2], valid[2]) sorted ascending by C0.
    """
    x1y, x1z, x2y, x2z = map(jnp.asarray, (x1y, x1z, x2y, x2z))
    dy_target = x2y - x1y

    def f_direct(lg):
        return _branch_misses(lg, x1z, x2z, dy_target, ice)[0]

    def f_mirror(lg):
        return _branch_misses(lg, x1z, x2z, dy_target, ice)[1]

    eps = jnp.asarray(1e-12 if x1y.dtype == jnp.float64 else 1e-5, x1y.dtype)
    lo0 = _logc0_min(x2z, ice) + eps
    hi0 = jnp.asarray(_LOGC0_HI, x1y.dtype)

    # observables downstream self-classify from the C0 geometry, so the
    # mirror0 flag is not needed here
    root0, valid0, _, root1, valid1 = _solve_branch_pair(
        f_direct, f_mirror, lo0, hi0, n_bisect)

    roots = jnp.stack([root0, root1])
    valid = jnp.stack([valid0, valid1])
    # sort the two slots by C0 ascending (reference find_solutions:1547),
    # pushing invalid slots last
    key = jnp.where(valid, roots, jnp.inf)
    order = jnp.argsort(key)
    return roots[order], valid[order]


# ---------------------------------------------------------------------------
# bottom-reflection paths (Moore's Bay): every observable of a path with r
# bottom bounces decomposes into  A f(z_turn) + B f(z_bottom) + C f(z1) + D f(z2)
# where f is the per-observable antiderivative (w for horizontal advance, the
# Bouma s/ct for length/time) and the integer coefficients depend only on
# (r, reflection_case, final-leg branch). Each leg's horizontal advance is
# strictly decreasing in C0, so one bisection per branch still finds all
# solutions (replaces get_delta_y's reflection loop, analyticraytracing.py
# :204-272 + get_reflection_point:280-291).
# ---------------------------------------------------------------------------

def _path_coeffs(r: int, case: int, mirror: bool):
    """(A, B, C, D) coefficients of the segment decomposition."""
    A = 2 * r - 2 * (case == 2) + 2 * int(mirror)
    B = -2 * r
    C = -1 if case == 1 else 1
    D = -1 if mirror else 1
    return A, B, C, D


def _advance_general(logc0, x1z, x2z, ice: IceModelSimple, r: int, case: int,
                     mirror: bool):
    """Total horizontal advance of an r-bounce path."""
    c0 = _c0_from_log(logc0, ice.n_ice)
    _, z_turn = _turning_point(c0, ice)
    A, B, C, D = _path_coeffs(r, case, mirror)
    zb = ice.refl_z if ice.refl_z is not None else 0.0
    return (A * _w_up(z_turn, c0, ice) + B * _w_up(zb, c0, ice)
            + C * _w_up(x1z, c0, ice) + D * _w_up(x2z, c0, ice))


def _solve_reflection_roots(x1y, x1z, x2y, x2z, ice: IceModelSimple,
                            r: int, case: int, n_bisect: int):
    """Roots (direct-final-leg, mirror-final-leg) for an r-bounce path.

    Returns (logc0[2], valid[2], is_mirror[2]): near the shadow boundary both
    solutions can sit on the mirror branch (see _solve_branch_pair), in which
    case slot 0 carries a mirror root and is_mirror[0] is True.
    """
    x1y, x1z, x2y, x2z = map(jnp.asarray, (x1y, x1z, x2y, x2z))
    dy_target = x2y - x1y
    eps = jnp.asarray(1e-12 if x1y.dtype == jnp.float64 else 1e-5, x1y.dtype)
    lo0 = _logc0_min(x2z, ice) + eps
    hi0 = jnp.asarray(_LOGC0_HI, x1y.dtype)

    def f_direct(lg):
        return dy_target - _advance_general(lg, x1z, x2z, ice, r, case, False)

    def f_mirror(lg):
        return dy_target - _advance_general(lg, x1z, x2z, ice, r, case, True)

    root0, valid0, mirror0, root1, valid1 = _solve_branch_pair(
        f_direct, f_mirror, lo0, hi0, n_bisect)
    return (jnp.stack([root0, root1]), jnp.stack([valid0, valid1]),
            jnp.stack([mirror0, jnp.ones_like(mirror0)]))


def path_length_general(c0, x1z, x2z, ice: IceModelSimple, r, case, mirror):
    """Closed-form path length of an r-bounce path (Bouma antiderivative)."""
    beta, alpha = _bouma_beta_alpha(c0, x1z, ice)

    def s_of(z):
        nz = _n_z(z, ice)
        gam = jnp.maximum(nz ** 2 - beta ** 2, 0.0)
        l1 = jnp.sqrt(alpha * gam) + ice.n_ice * nz - beta ** 2
        l2 = jnp.sqrt(gam) + nz
        return ice.n_ice / jnp.sqrt(alpha) * (z - ice.z_0 * jnp.log(l1)) + ice.z_0 * jnp.log(l2)

    _, z_turn = _turning_point(c0, ice)
    A, B, C, D = _path_coeffs(r, case, mirror)
    zb = ice.refl_z if ice.refl_z is not None else 0.0
    return A * s_of(z_turn) + B * s_of(zb) + C * s_of(x1z) + D * s_of(x2z)


def travel_time_general(c0, x1z, x2z, ice: IceModelSimple, r, case, mirror):
    """Closed-form travel time of an r-bounce path (Bouma antiderivative)."""
    beta, alpha = _bouma_beta_alpha(c0, x1z, ice)

    def ct_of(z):
        nz = _n_z(z, ice)
        gam = jnp.maximum(nz ** 2 - beta ** 2, 0.0)
        l1 = jnp.sqrt(alpha * gam) + ice.n_ice * nz - beta ** 2
        l2 = jnp.sqrt(gam) + nz
        return (ice.z_0 * (jnp.sqrt(gam) - ice.n_ice ** 2 / jnp.sqrt(alpha) * jnp.log(l1)
                           + ice.n_ice * jnp.log(l2))
                + ice.n_ice ** 2 * z / jnp.sqrt(alpha))

    _, z_turn = _turning_point(c0, ice)
    A, B, C, D = _path_coeffs(r, case, mirror)
    zb = ice.refl_z if ice.refl_z is not None else 0.0
    return (A * ct_of(z_turn) + B * ct_of(zb) + C * ct_of(x1z)
            + D * ct_of(x2z)) / speed_of_light


def _quad_nodes(n_steps: int, quadrature: str):
    """(nodes, weights) on [0, 1]: midpoint rule or Gauss-Legendre (the
    t-substituted integrand is smooth, so GL-8 beats midpoint-32; measured
    max errs vs a 1024-step truth: mid-32 7e-4, GL-8 4e-4, GL-12 7e-5)."""
    import functools as _ft

    @_ft.lru_cache(maxsize=16)
    def cached(n, q):
        import numpy as _np
        if q == "gauss":
            x, w = _np.polynomial.legendre.leggauss(n)
            return (x + 1.0) / 2.0, w / 2.0
        return (_np.arange(n) + 0.5) / n, _np.full(n, 1.0 / n)
    return cached(n_steps, quadrature)


def attenuation_factor_general(c0, x1z, x2z, ice: IceModelSimple, frequencies,
                               model: str, r, case, mirror, n_steps: int = 64,
                               quadrature: str = "midpoint"):
    """Attenuation of an r-bounce path via per-leg t-substitution integrals.

    exponent = c1 I(z1) + cb I(zb) + c2 I(z2) with I(z) = int_z^{z_turn} ds/L.
    """
    _, z_turn = _turning_point(c0, ice)
    zb = ice.refl_z if ice.refl_z is not None else 0.0
    qt, qw = _quad_nodes(n_steps, quadrature)

    def I_of(z_start):
        T = jnp.sqrt(jnp.maximum(z_turn - z_start, 0.0))
        t = jnp.asarray(qt, c0.dtype) * T
        z = z_turn - t ** 2
        nz = _n_z(z, ice)
        arg = jnp.maximum(_arg_stable(z, c0, ice), 1e-20)
        ds_dt = 2.0 * t * c0 * nz / jnp.sqrt(arg)
        inv_L = attenuation_ops.inv_length_factored(z, frequencies, model)
        return jnp.sum((jnp.asarray(qw, c0.dtype) * ds_dt)[:, None] * inv_L,
                       axis=0) * T

    c1 = 1.0 if case == 1 else -1.0
    cb = 2.0 * r
    c2 = 1.0 if mirror else -1.0
    exponent = c1 * I_of(x1z) + cb * I_of(zb) + c2 * I_of(x2z)
    return jnp.exp(-exponent)


def attenuation_factor_slots(c0, sol_type, reflection, refl_case, x1z, x2z,
                             ice: IceModelSimple, frequencies, model: str,
                             n_steps: int = 64, quadrature: str = "gauss"):
    """attenuation_factor_general with TRACED per-slot (r, case, mirror) —
    one uniform code path over the 2 + 4*n_reflections solution slots of
    ``find_solutions_all`` (the reference integrates each path segment with
    adaptive quad, get_attenuation_along_path analyticraytracing.py:933-1089;
    the coefficient identity c1 I(z1) + 2r I(zb) + c2 I(z2) with
    I(z) = int_z^{z_turn} ds/L covers every slot, r=0 included: mirror is
    sol_type != direct, case is the stored refl_case)."""
    _, z_turn = _turning_point(c0, ice)
    zb = ice.refl_z if ice.refl_z is not None else 0.0
    qt, qw = _quad_nodes(n_steps, quadrature)

    def I_of(z_start):
        T = jnp.sqrt(jnp.maximum(z_turn - z_start, 0.0))
        t = jnp.asarray(qt, c0.dtype) * T
        z = z_turn - t ** 2
        nz = _n_z(z, ice)
        arg = jnp.maximum(_arg_stable(z, c0, ice), 1e-20)
        ds_dt = 2.0 * t * c0 * nz / jnp.sqrt(arg)
        inv_L = attenuation_ops.inv_length_factored(z, frequencies, model)
        return jnp.sum((jnp.asarray(qw, c0.dtype) * ds_dt)[:, None] * inv_L,
                       axis=0) * T

    one = jnp.ones((), c0.dtype)
    c1 = jnp.where(refl_case == 1, one, -one)
    cb = 2.0 * reflection.astype(c0.dtype)
    c2 = jnp.where(sol_type != SOL_DIRECT, one, -one)
    exponent = c1 * I_of(x1z) + cb * I_of(jnp.asarray(zb, c0.dtype)) \
        + c2 * I_of(x2z)
    return jnp.exp(-exponent)


def launch_angle_general(c0, x1z, ice: IceModelSimple, case):
    """Launch zenith; case 2 paths start downward (pi - upward angle)."""
    up = jnp.arctan(_dy_dz(x1z, c0, ice))
    return jnp.pi - up if case == 2 else up


def receive_angle_general(c0, x2z, ice: IceModelSimple, mirror: bool):
    """Receive zenith from the final-leg branch (up-going unless mirrored)."""
    ang = jnp.arctan(_dy_dz(x2z, c0, ice))
    ang = jnp.pi - ang if mirror else ang
    return jnp.pi - ang


def turning_depth(c0, ice: IceModelSimple):
    """Turning depth of the ray (clamped to the surface for reflected
    rays, get_turning_point:133-158)."""
    return _turning_point(c0, ice)[1]


def surface_touches(r: int, case: int, mirror: bool, z_turn):
    """Number of surface reflections of the path (Fresnel factor count)."""
    n = (r if case == 1 else r - 1) + int(mirror)
    return jnp.where(z_turn >= 0, n, 0)


def surface_touches_slots(sol_type, reflection, refl_case, z_turn):
    """surface_touches with traced per-slot fields (every slot of
    find_solutions_all, r=0 included — the reference applies one Fresnel
    factor per surface touch, apply_propagation_effects:2967-3002; all
    touches of a slot share the same C0 hence the same angle)."""
    n = (reflection - (refl_case == 2).astype(reflection.dtype)
         + (sol_type != SOL_DIRECT).astype(reflection.dtype))
    return jnp.where(z_turn >= 0, jnp.maximum(n, 0), 0)


def find_solutions_all(x1y, x1z, x2y, x2z, ice: IceModelSimple,
                       n_reflections: int = 0, n_bisect: int = 96) -> RaySolutions:
    """All solutions including bottom reflections: 2 + 4*n_reflections slots
    ordered [r=0 x2, (r=1,case=1) x2, (r=1,case=2) x2, ...]
    (propagation_base_class.get_number_of_raytracing_solutions:424-429)."""
    base = find_solutions(x1y, x1z, x2y, x2z, ice, n_bisect)
    if n_reflections == 0:
        return base
    if ice.refl_z is None:
        raise ValueError("n_reflections > 0 requires an ice model with a reflective bottom")

    parts = [base]
    for r in range(1, n_reflections + 1):
        for case in (1, 2):
            logc0, valid, is_mirror = _solve_reflection_roots(
                x1y, x1z, x2y, x2z, ice, r, case, n_bisect)
            c0 = _c0_from_log(logc0, ice.n_ice)
            c1 = _c1_of(x1y, x1z, c0, ice)
            slots = []
            for k in range(2):
                c0k = c0[k]
                mk = is_mirror[k]
                _, z_turn = _turning_point(c0k, ice)
                sol_type = jnp.where(mk,
                                     jnp.where(z_turn >= 0, SOL_REFLECTED, SOL_REFRACTED),
                                     SOL_DIRECT)

                def pick(fn):
                    return jnp.where(mk, fn(True), fn(False))

                slots.append(RaySolutions(
                    c0=c0k, c1=c1[k], mask=valid[k],
                    sol_type=jnp.where(valid[k], sol_type, 0),
                    launch_angle=launch_angle_general(c0k, x1z, ice, case),
                    receive_angle=pick(lambda m: receive_angle_general(c0k, x2z, ice, m)),
                    path_length=pick(lambda m: path_length_general(
                        c0k, x1z, x2z, ice, r, case, m)),
                    travel_time=pick(lambda m: travel_time_general(
                        c0k, x1z, x2z, ice, r, case, m)),
                    reflection=jnp.full_like(sol_type, r),
                    refl_case=jnp.full_like(sol_type, case),
                ))
            parts.append(jax.tree.map(lambda *xs: jnp.stack(xs, axis=-1), *slots))
    return jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=-1), *parts)


def _solution_type(c0, x1y, x1z, x2y, x2z, ice: IceModelSimple):
    """1=direct / 2=refracted / 3=reflected (determine_solution_type:1365-1398)."""
    c1 = _c1_of(x1y, x1z, c0, ice)
    gamma_turn, z_turn = _turning_point(c0, ice)
    y_turn = _y_of_gamma(gamma_turn, c0, c1, ice)
    direct = x2y < y_turn
    reflected = z_turn >= 0.0
    return jnp.where(direct, SOL_DIRECT, jnp.where(reflected, SOL_REFLECTED, SOL_REFRACTED))


def _dy_dz(z, c0, ice: IceModelSimple):
    """|dy/dz| along the path, eq. C.12 of arXiv:1906.01670 (get_y_diff:306-355)."""
    nz = _n_z(z, ice)
    arg = c0 ** 2 * nz ** 2 - 1.0
    return jnp.where(arg > 0, 1.0 / jnp.sqrt(jnp.maximum(arg, 1e-30)), jnp.inf)


def _z2_mirrored(c0, x1y, x1z, x2y, x2z, ice: IceModelSimple):
    """Receiver depth continued past the turning point (get_z_mirrored:496-511)."""
    c1 = _c1_of(x1y, x1z, c0, ice)
    gamma_turn, z_turn = _turning_point(c0, ice)
    y_turn = _y_of_gamma(gamma_turn, c0, c1, ice)
    past_turn = y_turn < x2y
    return jnp.where(past_turn, x1z + jnp.abs(z_turn - x1z) + jnp.abs(z_turn - x2z), x2z)


def launch_angle(c0, x1z, ice: IceModelSimple):
    """2D launch zenith at the source (get_launch_angle:1195; always upward)."""
    return jnp.arctan(_dy_dz(x1z, c0, ice))


def receive_angle(c0, x1y, x1z, x2y, x2z, ice: IceModelSimple):
    """2D receive zenith at the receiver (get_receive_angle:1198).

    pi - angle(x2), where angle is measured against +z and flips sign past the
    turning point (get_angle:1161-1193).
    """
    z2m = _z2_mirrored(c0, x1y, x1z, x2y, x2z, ice)
    dy = _dy_dz(x2z, c0, ice)
    past_turn = z2m != x2z
    ang = jnp.arctan(dy)
    ang = jnp.where(past_turn, jnp.pi - ang, ang)  # arctan(-dy) < 0 -> +pi
    return jnp.pi - ang


def reflection_angle(c0, x1y, x1z, x2y, x2z, ice: IceModelSimple):
    """Surface-incidence zenith for reflected rays, NaN otherwise (:1201-1237)."""
    gamma_turn, z_turn = _turning_point(c0, ice)
    dy_surface = _dy_dz(0.0, c0, ice)
    ang = jnp.arctan(dy_surface)
    sol = _solution_type(c0, x1y, x1z, x2y, x2z, ice)
    return jnp.where((sol == SOL_REFLECTED) & (z_turn >= 0), ang, jnp.nan)


def _bouma_beta_alpha(c0, x1z, ice: IceModelSimple):
    n1 = _n_z(x1z, ice)
    beta = n1 * jnp.sin(launch_angle(c0, x1z, ice))
    alpha = ice.n_ice ** 2 - beta ** 2
    return beta, alpha


def path_length(c0, x1y, x1z, x2y, x2z, ice: IceModelSimple):
    """Closed-form path length (get_path_length_analytic:602-690, Bouma)."""
    beta, alpha = _bouma_beta_alpha(c0, x1z, ice)

    def s_of(z):
        nz = _n_z(z, ice)
        gam = jnp.maximum(nz ** 2 - beta ** 2, 0.0)
        l1 = jnp.sqrt(alpha * gam) + ice.n_ice * nz - beta ** 2
        l2 = jnp.sqrt(gam) + nz
        return ice.n_ice / jnp.sqrt(alpha) * (z - ice.z_0 * jnp.log(l1)) + ice.z_0 * jnp.log(l2)

    sol = _solution_type(c0, x1y, x1z, x2y, x2z, ice)
    _, z_turn = _turning_point(c0, ice)
    z_turn = jnp.where(sol == SOL_REFLECTED, 0.0, z_turn)
    s_direct = s_of(x2z) - s_of(x1z)
    s_turn = 2 * s_of(z_turn) - s_of(x1z) - s_of(x2z)
    return jnp.where(sol == SOL_DIRECT, s_direct, s_turn)


def travel_time(c0, x1y, x1z, x2y, x2z, ice: IceModelSimple):
    """Closed-form travel time (get_travel_time_analytic:692-783, Bouma)."""
    beta, alpha = _bouma_beta_alpha(c0, x1z, ice)

    def ct_of(z):
        nz = _n_z(z, ice)
        gam = jnp.maximum(nz ** 2 - beta ** 2, 0.0)
        l1 = jnp.sqrt(alpha * gam) + ice.n_ice * nz - beta ** 2
        l2 = jnp.sqrt(gam) + nz
        return (ice.z_0 * (jnp.sqrt(gam) - ice.n_ice ** 2 / jnp.sqrt(alpha) * jnp.log(l1)
                           + ice.n_ice * jnp.log(l2))
                + ice.n_ice ** 2 * z / jnp.sqrt(alpha))

    sol = _solution_type(c0, x1y, x1z, x2y, x2z, ice)
    _, z_turn = _turning_point(c0, ice)
    z_turn = jnp.where(sol == SOL_REFLECTED, 0.0, z_turn)
    ct_direct = ct_of(x2z) - ct_of(x1z)
    ct_turn = 2 * ct_of(z_turn) - ct_of(x1z) - ct_of(x2z)
    return jnp.where(sol == SOL_DIRECT, ct_direct, ct_turn) / speed_of_light


def focusing_factor(c0, x1y, x1z, x2y, x2z, ice: IceModelSimple, limit=2.0):
    """Analytic focusing factor (get_focusing_analytic:786-883, Bouma appendix).

    NaN-unstable for refracted trajectories (the theta width diverges at the
    horizontal point); for those the caller should fall back to the numeric
    estimate (finite-difference re-solve) or clamp. The result is clipped to
    ``limit`` as in the reference config (focusing_limit).
    """
    beta, alpha = _bouma_beta_alpha(c0, x1z, ice)
    la = launch_angle(c0, x1z, ice)
    ra = receive_angle(c0, x1y, x1z, x2y, x2z, ice)
    s = path_length(c0, x1y, x1z, x2y, x2z, ice)
    n1 = _n_z(x1z, ice)
    n2 = _n_z(x2z, ice)

    def w_phi(z):
        nz = _n_z(z, ice)
        gam = jnp.maximum(nz ** 2 - beta ** 2, 0.0)
        return (z - ice.z_0 * jnp.log(jnp.sqrt(alpha * gam) + ice.n_ice * nz - beta ** 2)) / jnp.sqrt(alpha)

    def w_theta(z):
        nz = _n_z(z, ice)
        gam = jnp.maximum(nz ** 2 - beta ** 2, 1e-30)
        return (ice.n_ice ** 2 * z / alpha ** 1.5
                + ice.z_0 * (ice.n_ice * nz + beta ** 2) / (alpha * jnp.sqrt(gam))
                - ice.n_ice ** 2 * ice.z_0 / alpha ** 1.5
                * jnp.log(jnp.sqrt(alpha * gam) + ice.n_ice * nz - beta ** 2))

    sol = _solution_type(c0, x1y, x1z, x2y, x2z, ice)
    wt_direct = w_theta(x2z) - w_theta(x1z)
    wp_direct = w_phi(x2z) - w_phi(x1z)
    wt_refl = 2 * w_theta(0.0) - w_theta(x1z) - w_theta(x2z)
    wp_refl = 2 * w_phi(0.0) - w_phi(x1z) - w_phi(x2z)
    wt = jnp.where(sol == SOL_DIRECT, wt_direct, wt_refl)
    wp = jnp.where(sol == SOL_DIRECT, wp_direct, wp_refl)

    f_inv_sq = n1 * n2 * jnp.abs(jnp.cos(la) * jnp.cos(ra)) * wt * wp / s ** 2
    focusing = jnp.sqrt(1.0 / jnp.maximum(f_inv_sq, 1e-30))
    # refracted trajectories: analytic form invalid (reference returns NaN and
    # falls back to numerics); clamp at the limit instead of NaN-poisoning
    focusing = jnp.where(sol == SOL_REFRACTED, jnp.minimum(focusing, limit), focusing)
    return jnp.minimum(focusing, limit)


# moment-factored SP1 quadrature: 1/L = exp(b1(z) + bb(z) w), w = ln(f/GHz),
# and both frequency branches share the intercept b1 (attenuation.sp1_w_coeffs)
# so exp(bb w) = exp(b_bar w) exp((bb - b_bar) w) Taylor-expands around a
# static per-branch center — the quadrature then needs ONE exp per depth
# sample (not one per (sample, frequency)) and the frequency evaluation
# collapses to an [K+1]x[K+1,F] contraction. |bb - b_bar| <= 0.13 (lo) /
# 0.47 (hi) over z in [-2800, 0], so K=10 keeps the truncation below 1e-6
# for any detector band (incl. sparse grids down to 0.1 MHz via the w clamp).
_SP1_BLO = 0.22
_SP1_BHI = 1.6
_SP1_K = 10


def _sp1_branch_moments(c0, ice, qt, qw, z_start, z_end_top):
    """Taylor moments M_k = int q(z) e^{b1(z)} (bb(z)-b_bar)^k ds for one
    t-substituted quadrature branch; (lo, hi) moment vectors of length K+1."""
    T = jnp.sqrt(jnp.maximum(z_end_top - z_start, 0.0))
    t = jnp.asarray(qt, c0.dtype) * T
    z = z_end_top - t ** 2
    nz = _n_z(z, ice)
    arg = jnp.maximum(_arg_stable(z, c0, ice), 1e-20)
    ds_dt = 2.0 * t * c0 * nz / jnp.sqrt(arg)
    q = jnp.asarray(qw, c0.dtype) * ds_dt * T
    b1, bb_lo, bb_hi = attenuation_ops.sp1_w_coeffs(z)
    e = jnp.where(z > 0, 0.0, q * jnp.exp(b1))
    dlo = bb_lo - _SP1_BLO
    dhi = bb_hi - _SP1_BHI
    mlo, mhi = [], []
    plo = e
    phi = e
    for _ in range(_SP1_K + 1):
        mlo.append(jnp.sum(plo))
        mhi.append(jnp.sum(phi))
        plo = plo * dlo
        phi = phi * dhi
    return jnp.stack(mlo), jnp.stack(mhi)


def _sp1_attenuation_from_moments(m_lo, m_hi, frequencies, dtype):
    """exp(-exponent(f)) from the summed branch moments."""
    import math as _math

    import numpy as _np
    from nuradiomc_tpu.utils import units as _units

    f_ghz = jnp.maximum(frequencies / _units.GHz, 1e-4)
    w = jnp.log(f_ghz).astype(dtype)                      # [F]
    kk = _np.arange(_SP1_K + 1)
    inv_fact = jnp.asarray(1.0 / _np.asarray(
        [_math.factorial(int(k)) for k in kk]), dtype)
    wk = jnp.power(w[None, :], jnp.asarray(kk, dtype)[:, None]) \
        * inv_fact[:, None]                               # [K+1, F]
    # alternating-sign powers of log f cancel: the contraction needs full
    # float32 products (a TF32 pass loses the Taylor tail)
    hi = jax.lax.Precision.HIGHEST
    expo_lo = jnp.exp(_SP1_BLO * w) * jnp.matmul(m_lo, wk, precision=hi)
    expo_hi = jnp.exp(_SP1_BHI * w) * jnp.matmul(m_hi, wk, precision=hi)
    lo = frequencies < 1.0 * _units.GHz
    return jnp.exp(-jnp.where(lo, expo_lo, expo_hi))


def attenuation_factor(c0, x1y, x1z, x2y, x2z, ice: IceModelSimple,
                       frequencies, model: str, n_steps: int = 64,
                       quadrature: str = "midpoint"):
    """exp(-int ds / L_att(z, f)) along the path, per frequency.

    Replaces get_attenuation_along_path (analyticraytracing.py:933-1089).
    The substitution z = z_top - t^2 turns ds = C0 n / sqrt(C0^2 n^2 - 1) dz
    into a bounded integrand near the turning point (where C0 n(z_turn) = 1),
    so a fixed-``n_steps`` midpoint rule per path branch converges fast and
    maps onto dense [batch, step, freq] tensor ops.

    Parameters
    ----------
    frequencies : array (F,)
        Frequencies at which to evaluate (the caller typically passes a sparse
        grid and interpolates, mirroring the reference's n_freq config).
    """
    _, z_turn = _turning_point(c0, ice)
    sol = _solution_type(c0, x1y, x1z, x2y, x2z, ice)
    z_top = jnp.where(sol == SOL_REFLECTED, 0.0, z_turn)
    # for direct rays, integrate [z1, z2] in one branch; otherwise two
    # branches [z1, z_top] (up) and [z2, z_top] (down-mirrored)
    direct = sol == SOL_DIRECT

    qt, qw = _quad_nodes(n_steps, quadrature)

    if model == "SP1":
        up_lo, up_hi = _sp1_branch_moments(
            c0, ice, qt, qw, x1z, jnp.where(direct, x2z, z_top))
        dn_lo, dn_hi = _sp1_branch_moments(
            c0, ice, qt, qw, x2z, jnp.where(direct, x2z, z_top))
        return _sp1_attenuation_from_moments(
            up_lo + dn_lo, up_hi + dn_hi, frequencies, c0.dtype)

    def branch_exponent(z_start, z_end_top):
        """int_{z_start}^{z_end_top} ds/L, with z_end_top >= z_start, via t-substitution."""
        # t in [0, T], z = z_end_top - t^2; quadrature nodes on [0, 1]
        T = jnp.sqrt(jnp.maximum(z_end_top - z_start, 0.0))
        t = jnp.asarray(qt, c0.dtype) * T
        z = z_end_top - t ** 2
        nz = _n_z(z, ice)
        arg = jnp.maximum(_arg_stable(z, c0, ice), 1e-20)
        ds_dt = 2.0 * t * c0 * nz / jnp.sqrt(arg)
        # guard: at the exact turning point arg -> 0 like t^2, ratio finite;
        # the epsilon floor keeps it bounded
        inv_L = attenuation_ops.inv_length_factored(z, frequencies, model)
        return jnp.sum((jnp.asarray(qw, c0.dtype) * ds_dt)[:, None] * inv_L,
                       axis=0) * T  # [F]

    # up branch: from z1 to (z2 for direct, z_top otherwise)
    exp_up = branch_exponent(x1z, jnp.where(direct, x2z, z_top))
    # down branch: from z2 to z_top (zero-length for direct rays)
    exp_down = branch_exponent(x2z, jnp.where(direct, x2z, z_top))
    return jnp.exp(-(exp_up + exp_down))


def find_solutions(x1y, x1z, x2y, x2z, ice: IceModelSimple,
                   n_bisect: int = 96) -> RaySolutions:
    """Solve the in-ice two-point ray tracing problem for one geometry.

    vmap over leading axes for batches. Prerequisite (as in the reference,
    find_solutions:1400-1412): x2 above-or-level with x1 and to the right
    (achieved by the 3D wrapper's swap + rotation).

    Returns a 2-slot RaySolutions (slot axis last), sorted by C0 ascending.
    """
    logc0, valid = _solve_two_roots(x1y, x1z, x2y, x2z, ice, n_bisect)
    c0 = _c0_from_log(logc0, ice.n_ice)
    c1 = _c1_of(x1y, x1z, c0, ice)
    sol_type = _solution_type(c0, x1y, x1z, x2y, x2z, ice)
    la = launch_angle(c0, x1z, ice)
    ra = receive_angle(c0, x1y, x1z, x2y, x2z, ice)
    pl = path_length(c0, x1y, x1z, x2y, x2z, ice)
    tt = travel_time(c0, x1y, x1z, x2y, x2z, ice)
    zeros = jnp.zeros_like(sol_type)
    # invalid slots keep finite (garbage) values — consumers multiply by
    # ``mask``; keeping everything NaN-free lets the fused pipeline avoid
    # NaN-poisoning without extra sanitization passes
    return RaySolutions(
        c0=c0, c1=c1, mask=valid,
        sol_type=jnp.where(valid, sol_type, 0),
        launch_angle=la, receive_angle=ra,
        path_length=pl, travel_time=tt,
        reflection=zeros, refl_case=jnp.ones_like(sol_type),
    )


# ---------------------------------------------------------------------------
# ice-to-air propagation: a single solution exists between the vertical ray
# and the ray that exits at the critical angle (find_solutions:1437-1460 —
# note that the reference's Python path for this case is non-functional in
# the studied snapshot: its objective reduces to the always-negative
# "turning point too deep" penalty for z2 > 0, so find_solutions returns
# zero ice-air solutions; this implementation solves the physics directly).
# ---------------------------------------------------------------------------

def _air_miss(logc0, x1y, x1z, x2y, x2z, ice: IceModelSimple):
    """Horizontal miss at an in-air receiver: closed-form in-ice path to the
    surface + straight Snell-refracted line in air."""
    c0 = _c0_from_log(logc0, ice.n_ice)
    y_exit = x1y + _w_up(0.0, c0, ice) - _w_up(x1z, c0, ice)
    n_surf = ice.n_ice - ice.delta_n
    sin_ice = 1.0 / (c0 * n_surf)          # sin of zenith at the surface (in ice)
    sin_air = jnp.clip(n_surf * sin_ice, 0.0, 1.0 - 1e-12)
    tan_air = sin_air / jnp.sqrt(1.0 - sin_air ** 2)
    y_at_z2 = y_exit + x2z * tan_air
    return x2y - y_at_z2


def find_solution_ice_to_air(x1y, x1z, x2y, x2z, ice: IceModelSimple,
                             n_bisect: int = 96) -> RaySolutions:
    """Single-slot solution for a receiver above the surface (x2z > 0)."""
    x1y, x1z, x2y, x2z = map(jnp.asarray, (x1y, x1z, x2y, x2z))
    n1 = _n_z(x1z, ice)
    # flattest escaping ray: surface angle = critical angle ->
    # C0 n_surf sin=1 with sin_ice=1 -> c0_lo = 1/n_surf
    n_surf = ice.n_ice - ice.delta_n
    eps = jnp.asarray(1e-12 if x1y.dtype == jnp.float64 else 1e-5, x1y.dtype)
    lo0 = jnp.log(jnp.asarray(1.0 / n_surf, x1y.dtype) - 1.0 / ice.n_ice) + eps
    hi0 = jnp.asarray(_LOGC0_HI, x1y.dtype)

    f = lambda lg: _air_miss(lg, x1y, x1z, x2y, x2z, ice)
    f_lo = f(lo0)
    f_hi = f(hi0)
    has = jnp.sign(f_lo) != jnp.sign(f_hi)

    def body(_, st):
        lo_, hi_ = st
        mid = 0.5 * (lo_ + hi_)
        same = jnp.sign(f(mid)) == jnp.sign(f_lo)
        return jnp.where(same, mid, lo_), jnp.where(same, hi_, mid)
    lo_, hi_ = jax.lax.fori_loop(0, n_bisect, body, (lo0, hi0))
    logc0 = 0.5 * (lo_ + hi_)
    c0 = _c0_from_log(logc0, ice.n_ice)

    # observables: in-ice leg to the surface (closed forms to z=0) + air leg
    beta, alpha = _bouma_beta_alpha(c0, x1z, ice)

    def s_of(z):
        nz = _n_z(z, ice)
        gam = jnp.maximum(nz ** 2 - beta ** 2, 0.0)
        l1 = jnp.sqrt(alpha * gam) + ice.n_ice * nz - beta ** 2
        l2 = jnp.sqrt(gam) + nz
        return ice.n_ice / jnp.sqrt(alpha) * (z - ice.z_0 * jnp.log(l1)) + ice.z_0 * jnp.log(l2)

    def ct_of(z):
        nz = _n_z(z, ice)
        gam = jnp.maximum(nz ** 2 - beta ** 2, 0.0)
        l1 = jnp.sqrt(alpha * gam) + ice.n_ice * nz - beta ** 2
        l2 = jnp.sqrt(gam) + nz
        return (ice.z_0 * (jnp.sqrt(gam) - ice.n_ice ** 2 / jnp.sqrt(alpha) * jnp.log(l1)
                           + ice.n_ice * jnp.log(l2)) + ice.n_ice ** 2 * z / jnp.sqrt(alpha))

    y_exit = x1y + _w_up(0.0, c0, ice) - _w_up(x1z, c0, ice)
    d_air = jnp.sqrt((x2y - y_exit) ** 2 + x2z ** 2)
    path = s_of(0.0) - s_of(x1z) + d_air
    ttime = (ct_of(0.0) - ct_of(x1z)) / speed_of_light + d_air / speed_of_light

    la = jnp.arctan(_dy_dz(x1z, c0, ice))
    sin_ice = 1.0 / (c0 * n_surf)
    sin_air = jnp.clip(n_surf * sin_ice, 0.0, 1.0 - 1e-12)
    ra = jnp.pi - jnp.arcsin(sin_air)  # receive zenith (from +z, downward-from-above)

    sol_type = jnp.where(has, SOL_DIRECT, 0).astype(jnp.int32)
    sols = RaySolutions(
        c0=c0, c1=_c1_of(x1y, x1z, c0, ice), mask=jnp.asarray(has),
        sol_type=sol_type, launch_angle=la, receive_angle=ra,
        path_length=path, travel_time=ttime,
        reflection=jnp.zeros_like(sol_type),
        refl_case=jnp.ones_like(sol_type),
    )
    # single solution slot (trailing axis of size 1)
    return jax.tree.map(lambda a: jnp.asarray(a)[..., None], sols)


# ---------------------------------------------------------------------------
# 3D wrapper: reduce (3D src, 3D rcv) to the 2D plane (set_start_and_end_point
# semantics, analyticraytracing.py:2057-2090) and lift angles back to 3D.
# ---------------------------------------------------------------------------

class Geometry2D(NamedTuple):
    """Per-pair reduction of the 3D problem to the propagation plane."""

    x1y: jnp.ndarray
    x1z: jnp.ndarray
    x2y: jnp.ndarray
    x2z: jnp.ndarray
    swapped: jnp.ndarray   # bool: source/receiver exchanged (z2 < z1 originally)
    dphi: jnp.ndarray      # rotation angle of the plane
    # unit vector of the horizontal propagation direction (pre-swap x1 -> x2)
    ux: jnp.ndarray
    uy: jnp.ndarray


def to_2d(x1, x2) -> Geometry2D:
    """Rotate the pair into the y-z plane. x1, x2: (..., 3) arrays."""
    swap = x2[..., 2] < x1[..., 2]
    a = jnp.where(swap[..., None], x2, x1)  # lower point
    b = jnp.where(swap[..., None], x1, x2)  # upper point
    d = b - a
    r_h = jnp.sqrt(d[..., 0] ** 2 + d[..., 1] ** 2)
    dphi = -jnp.arctan2(d[..., 1], d[..., 0])
    safe_r = jnp.where(r_h == 0, 1.0, r_h)
    return Geometry2D(
        x1y=a[..., 0], x1z=a[..., 2],
        x2y=a[..., 0] + r_h, x2z=b[..., 2],
        swapped=swap, dphi=dphi,
        ux=jnp.where(r_h == 0, 1.0, d[..., 0] / safe_r),
        uy=jnp.where(r_h == 0, 0.0, d[..., 1] / safe_r),
    )


def _rot_to_3d(geom: Geometry2D, sin_component, cos_component):
    """Lift a 2D (sin, 0, cos) direction back to 3D ground coordinates."""
    return jnp.stack([
        geom.ux * sin_component,
        geom.uy * sin_component,
        cos_component,
    ], axis=-1)


def focusing_dtheta_dz(geom: Geometry2D, sols: RaySolutions, ice: IceModelSimple):
    """|d(theta_launch at the true emitter) / d(z of the true receiver)| at
    the solved roots — the exact dz->0 limit of the displaced-receiver
    numeric focusing (get_focusing, analyticraytracing.py:2778-2888), at the
    cost of ONE gradient evaluation instead of a second full bisection solve.

    Derivation: the root condition miss(logC0; z1, z2) = 0 defines
    logC0(z_receiver) implicitly, so dlogC0/dz_r = -(dmiss/dz_r)/(dmiss/dlogC0).
    Both partials are evaluated by central differences of the closed-form
    miss function (4 evaluations; autodiff hits an inf-inf cancellation at
    the turning-point antiderivative, so finite differences are the stable
    choice). Along the ray the Snell invariant gives
    sin(theta(z)) = 1/(C0 n(z)), hence at the fixed emitter depth
    |dtheta/dC0| = tan(theta)/C0; dC0/dlogC0 = C0 - 1/n_ice completes the
    chain.

    Returns an array shaped like ``sols.c0``; values at masked-out slots are
    meaningless (guard with ``sols.mask``).
    """
    tiny = jnp.asarray(1e-30, sols.c0.dtype)
    logc0 = jnp.log(jnp.maximum(sols.c0 - 1.0 / ice.n_ice, tiny))
    dy_target = (geom.x2y - geom.x1y)[..., None]
    is_mirror = sols.sol_type != SOL_DIRECT
    z1 = jnp.broadcast_to(geom.x1z[..., None], logc0.shape)
    z2 = jnp.broadcast_to(geom.x2z[..., None], logc0.shape)

    def miss_vec(lg, z1_, z2_):
        md, mm = _branch_misses(lg, z1_, z2_, dy_target, ice)
        return jnp.where(is_mirror, mm, md)

    f64 = sols.c0.dtype == jnp.float64
    h_l = jnp.asarray(1e-6 if f64 else 1e-3, sols.c0.dtype) \
        * jnp.maximum(jnp.abs(logc0), 1.0)
    h_z = jnp.asarray(0.005, sols.c0.dtype)  # receiver displaced +-5 mm

    g_l = (miss_vec(logc0 + h_l, z1, z2)
           - miss_vec(logc0 - h_l, z1, z2)) / (2 * h_l)
    # the true receiver is the 2D x1 when the pair was swapped
    swapped = jnp.broadcast_to(geom.swapped[..., None], logc0.shape)
    z1_p = jnp.where(swapped, z1 + h_z, z1)
    z2_p = jnp.where(swapped, z2, z2 + h_z)
    z1_m = jnp.where(swapped, z1 - h_z, z1)
    z2_m = jnp.where(swapped, z2, z2 - h_z)
    g_zr = (miss_vec(logc0, z1_p, z2_p)
            - miss_vec(logc0, z1_m, z2_m)) / (2 * h_z)
    dlog_dzr = -g_zr / jnp.where(jnp.abs(g_l) > tiny, g_l, tiny)

    # emitter-side angle: launch_angle at 2D x1, receive_angle at 2D x2
    theta_e = jnp.where(swapped, sols.receive_angle, sols.launch_angle)
    sin_t, cos_t = jnp.sin(theta_e), jnp.cos(theta_e)
    dth_dc0 = sin_t / (sols.c0 * jnp.maximum(jnp.abs(cos_t), 1e-6))
    dc0_dlog = sols.c0 - 1.0 / ice.n_ice
    return jnp.abs(dth_dc0 * dc0_dlog * dlog_dzr)


def launch_receive_vectors(geom: Geometry2D, sols: RaySolutions):
    """3D launch and receive unit vectors (get_launch_vector/get_receive_vector,
    analyticraytracing.py:2561-2624), handling the swap case.

    Returns (launch[..., slot, 3], receive[..., slot, 3]).
    """
    la, ra = sols.launch_angle, sols.receive_angle
    swapped = geom.swapped[..., None]
    ux = geom.ux[..., None]
    uy = geom.uy[..., None]
    g = Geometry2D(geom.x1y, geom.x1z, geom.x2y, geom.x2z, geom.swapped, geom.dphi, ux, uy)

    # unswapped: launch = (sin la, 0, cos la); receive = (-sin ra, 0, cos ra)
    launch_plain = _rot_to_3d(g, jnp.sin(la), jnp.cos(la))
    receive_plain = _rot_to_3d(g, -jnp.sin(ra), jnp.cos(ra))
    # swapped: launch = (-sin ra, 0, cos ra); receive = (sin la, 0, cos la)
    launch_swap = _rot_to_3d(g, -jnp.sin(ra), jnp.cos(ra))
    receive_swap = _rot_to_3d(g, jnp.sin(la), jnp.cos(la))

    launch = jnp.where(swapped[..., None], launch_swap, launch_plain)
    receive = jnp.where(swapped[..., None], receive_swap, receive_plain)
    return launch, receive
