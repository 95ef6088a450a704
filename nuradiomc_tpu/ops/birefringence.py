"""Birefringent pulse propagation (JAX).

Re-implementation of the analytic birefringence treatment of
NuRadioMC/SignalProp/analyticraytracing.py: effective refractive indices from
the diagonalized dielectric tensor (get_effective_index_birefringence:
2165-2210), polarization eigenvectors (get_polarization_birefringence_simple:
2212-2243), and the per-meter path scan that rotates (eTheta, ePhi) into the
birefringent eigenbasis, applies the fast/slow relative Fourier time shift
and rotates back (get_pulse_propagation_birefringence:2369-2445).

The spline-interpolated (nx, ny, nz)(z) models (utilities/medium_base.py:
378-421, data in utilities/birefringence_models/*.npy) are densified on the
host into regular tables evaluated with jnp.interp; the path scan is a
jax.lax.scan over a fixed number of segments, vmappable over solutions.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from nuradiomc_tpu.models.ice import IceModelSimple
from nuradiomc_tpu.ops import raytrace
from nuradiomc_tpu.utils import geometry
from nuradiomc_tpu.utils.constants import speed_of_light

_MODEL_DIR_CANDIDATES = (
    os.path.join(os.path.dirname(os.path.dirname(__file__)), "data", "birefringence_models"),
    "/root/reference/NuRadioMC/utilities/birefringence_models",
)


@functools.lru_cache(maxsize=8)
def load_model(name: str = "southpole_A", n_depth: int = 2501):
    """(depths[m positive], nx, ny, nz) dense tables from the spline model."""
    from scipy import interpolate

    path = None
    for d in _MODEL_DIR_CANDIDATES:
        cand = os.path.join(d, f"birefringence_{name}.npy")
        if os.path.exists(cand):
            path = cand
            break
    if path is None:
        raise FileNotFoundError(f"birefringence model {name} not found")
    tck = np.load(path, allow_pickle=True)
    f1 = interpolate.UnivariateSpline._from_tck(tck[0])
    f2 = interpolate.UnivariateSpline._from_tck(tck[1])
    f3 = interpolate.UnivariateSpline._from_tck(tck[2])
    depths = np.linspace(0.0, 2500.0, n_depth)
    return (depths, f1(depths), f2(depths), f3(depths))


def _eigensystem_2x2(direction, nx, ny, nz):
    """Exact transverse-D eigensystem of the dielectric tensor, posed so
    f32 cannot blow it up.

    The exact plane-wave dispersion relation in an anisotropic dielectric
    is ``(P_t B P_t) D = (1/n^2) D`` with ``B = diag(1/nx^2, 1/ny^2,
    1/nz^2)`` and ``P_t`` the projector transverse to the propagation
    direction — the same physics as the reference's Booker-quartic
    formulas (get_effective_index_birefringence:2165-2210), but restricted
    to the 2D (theta-hat, phi-hat) basis it becomes a symmetric 2x2
    eigenproblem whose eigenvectors are EXACTLY orthonormal on-sky, so
    the per-segment propagation matrix is a pure rotation. The
    reference's E-field eigenvectors project on-sky PARALLEL to these D
    eigenvectors (transverse part of E = D/n^2), so the physics is
    identical; what changes is conditioning. The reference's generic
    formula ``s_i / (n^2 - n_i^2)`` is catastrophic at f32 — near a
    principal index the denominator is pure cancellation noise (~1e-7 of
    n^2 vs a true difference that can be arbitrarily small), the
    "eigenvectors" of the two modes stop being orthogonal, and the
    transpose-reconstruction in the path scan then AMPLIFIES by the
    non-orthogonality every segment: measured e^30..e^70 trace blowups
    over ~250-segment paths in the gen2 workload at float32, seeded
    differently by each backend's rounding. Here the
    anisotropy enters only through differences ``delta_i = B_i - mean(B)``
    (no large-term cancellation), and an O(ulp) angle error just
    mis-rotates by O(ulp) — the transform stays unitary by construction.

    Returns (n1, n2, cos_psi, sin_psi, dn, k1sq, k2sq) with n1 <= n2
    (fast mode first, the reference's ordering), (cos_psi, sin_psi) the
    fast-mode eigenvector angle in the (theta_hat, phi_hat) basis,
    dn = n2 - n1 computed cancellation-free, and k_i^2 <= 1 the
    reference's per-segment walk-off damping of mode i.
    """
    sx, sy, sz = direction[..., 0], direction[..., 1], direction[..., 2]
    # transverse basis from the propagation direction (no trig round-trip)
    rho = jnp.sqrt(sx ** 2 + sy ** 2)
    safe = rho > 1e-12
    inv_rho = jnp.where(safe, 1.0 / jnp.maximum(rho, 1e-12), 0.0)
    cp = jnp.where(safe, sx * inv_rho, 1.0)
    sp = jnp.where(safe, sy * inv_rho, 0.0)
    ct, st_ = sz, rho
    th = (ct * cp, ct * sp, -st_)          # theta_hat
    ph = (-sp, cp, jnp.zeros_like(sp))     # phi_hat

    bx, by, bz = 1.0 / nx ** 2, 1.0 / ny ** 2, 1.0 / nz ** 2
    bbar = (bx + by + bz) / 3.0
    dx, dy, dz = bx - bbar, by - bbar, bz - bbar
    # sum_i th_i^2 = sum_i ph_i^2 = 1 and sum_i th_i ph_i = 0, so the
    # isotropic part drops out of the off-diagonal and the difference
    # analytically — only the O(anisotropy) deltas are ever subtracted
    q11 = dx * th[0] ** 2 + dy * th[1] ** 2 + dz * th[2] ** 2
    q22 = dx * ph[0] ** 2 + dy * ph[1] ** 2 + dz * ph[2] ** 2
    m12 = dx * th[0] * ph[0] + dy * th[1] * ph[1] + dz * th[2] * ph[2]
    half_diff = 0.5 * (q11 - q22)
    mean = bbar + 0.5 * (q11 + q22)
    r = jnp.sqrt(half_diff ** 2 + m12 ** 2)
    lam1, lam2 = mean + r, mean - r        # lam1 >= lam2  ->  n1 <= n2
    s1, s2 = jnp.sqrt(lam1), jnp.sqrt(lam2)
    n1, n2 = 1.0 / s1, 1.0 / s2
    dn = 2.0 * r / (s1 * s2 * (s1 + s2))   # n2 - n1 without cancellation
    psi = 0.5 * jnp.arctan2(2.0 * m12, q11 - q22)
    cpsi, spsi = jnp.cos(psi), jnp.sin(psi)
    # The reference's R rows are the 3D-normalized E eigenvectors
    # projected on-sky, whose 2D norms are k_i = |P_t B v_i| / |B v_i|
    # = lam_i / |B v_i| <= 1 — its transpose-reconstruction therefore
    # DAMPS mode i by k_i^2 per segment (walk-off energy bookkeeping,
    # ~1e-6/segment, ~0.3-1% over km paths — above the BF anchor's 3e-4).
    # Reproduce it exactly from the stable eigenvectors: never amplifies.
    def _ksq(c, s, lam):
        v = (c * th[0] + s * ph[0], c * th[1] + s * ph[1],
             c * th[2] + s * ph[2])
        bv2 = (bx * v[0]) ** 2 + (by * v[1]) ** 2 + (bz * v[2]) ** 2
        return lam ** 2 / bv2

    k1sq = _ksq(cpsi, spsi, lam1)
    k2sq = _ksq(-spsi, cpsi, lam2)
    return n1, n2, cpsi, spsi, dn, k1sq, k2sq


def effective_indices(direction, nx, ny, nz):
    """(n1, n2) effective indices (get_effective_index_birefringence:
    2165-2210), n1 <= n2; computed via the stable transverse-D
    eigensystem (identical values, see _eigensystem_2x2)."""
    n1, n2, _, _, _, _, _ = _eigensystem_2x2(direction, nx, ny, nz)
    return n1, n2


def polarization_onsky(n_eff, direction, nx, ny, nz, eps=0.0):
    """Normalized polarization eigenvector projected on (eTheta, ePhi)
    (get_polarization_birefringence_simple:2212-2243 + on-sky projection).

    Diagnostic/parity-check only: the propagation scan uses the
    orthonormal rotation from _eigensystem_2x2 instead — this formula's
    ``n^2 - n_i^2`` denominators are f32-catastrophic near a principal
    index (the reference guards them with 1e-9 atol special cases that
    only make sense in f64)."""
    d = jnp.stack([direction[..., 0] / (n_eff ** 2 - nx ** 2 + eps),
                   direction[..., 1] / (n_eff ** 2 - ny ** 2 + eps),
                   direction[..., 2] / (n_eff ** 2 - nz ** 2 + eps)], axis=-1)
    d = d / jnp.maximum(jnp.linalg.norm(d, axis=-1, keepdims=True), 1e-30)
    zen, az = geometry.cartesian_to_spherical(direction)
    onsky = geometry.ground_to_onsky(d, zen, az)
    return onsky[..., 1], onsky[..., 2]  # (theta, phi) components


def path_points_3d(c0, geom: raytrace.Geometry2D, ice: IceModelSimple,
                   n_points: int, iceflow_angle: float = 0.0):
    """3D sample points along a ray solution (get_path:2060-2116 + the
    ice-flow rotation of get_pulse_propagation_birefringence:2405-2408)."""
    z2m = raytrace._z2_mirrored(c0, geom.x1y, geom.x1z, geom.x2y, geom.x2z, ice)
    _, z_turn = raytrace._turning_point(c0, ice)
    c1 = raytrace._c1_of(geom.x1y, geom.x1z, c0, ice)

    zm = jnp.linspace(geom.x1z, z2m, n_points)
    below = zm < z_turn
    y_below = raytrace._y_of_gamma(raytrace._gamma(zm, ice), c0, c1, ice)
    y_turn = raytrace._y_of_gamma(raytrace._gamma(z_turn, ice), c0, c1, ice)
    y_above = 2 * y_turn - raytrace._y_of_gamma(
        raytrace._gamma(2 * z_turn - zm, ice), c0, c1, ice)
    y = jnp.where(below, y_below, y_above)
    z = jnp.where(below, zm, 2 * z_turn - zm)

    # into 3D: horizontal direction (ux, uy) from the 2D reduction
    dx = (y - geom.x1y)
    px = geom.ux * dx
    py = geom.uy * dx
    # rotate x,y by the ice-flow angle
    ca, sa = jnp.cos(iceflow_angle), jnp.sin(iceflow_angle)
    x_rot = ca * px - sa * py
    y_rot = sa * px + ca * py
    return jnp.stack([x_rot, y_rot, z], axis=-1)  # [n_points, 3]


def propagate_pulse(spec_theta, spec_phi, path_xyz, frequencies,
                    ice: IceModelSimple, model: str = "southpole_A"):
    """Propagate (eTheta(f), ePhi(f)) along the path with per-segment
    birefringent eigenbasis rotations and relative time shifts
    (get_pulse_propagation_birefringence:2369-2445).

    path_xyz: [K, 3] points; returns propagated (spec_theta, spec_phi).
    """
    depths, bx, by, bz = load_model(model)
    depths = jnp.asarray(depths)
    bx, by, bz = jnp.asarray(bx), jnp.asarray(by), jnp.asarray(bz)

    p0 = path_xyz[:-1]
    p1 = path_xyz[1:]
    d_vec = p1 - p0
    seg_len = jnp.linalg.norm(d_vec, axis=-1)
    direction = d_vec / jnp.maximum(seg_len[:, None], 1e-30)

    n_iso = ice.index_of_refraction(p0[:, 2])
    depth_pos = -p0[:, 2]
    nx = n_iso + jnp.interp(depth_pos, depths, bx) - 1.78
    ny = n_iso + jnp.interp(depth_pos, depths, by) - 1.78
    nz = n_iso + jnp.interp(depth_pos, depths, bz) - 1.78

    # stable orthonormal eigenbasis: the per-segment transform is
    # R^T diag(k1^2, k2^2 phase) R with R an exact 2D rotation and
    # k_i <= 1 the reference's walk-off damping, so the scan can NEVER
    # amplify (see _eigensystem_2x2 — the reference's eigenvector formula
    # amplifies f32 cancellation noise exponentially over the path; same
    # physics, reconditioned)
    _, _, cpsi, spsi, dn, k1sq, k2sq = _eigensystem_2x2(direction, nx, ny, nz)
    dt_rel = seg_len * dn / speed_of_light          # t_slow - t_fast >= 0

    ok = (jnp.isfinite(cpsi) & jnp.isfinite(spsi) & jnp.isfinite(dt_rel)
          & (seg_len > 0))

    # follow the spectrum dtype (the model tables are f64 on the host)
    cdtype = jnp.result_type(spec_theta)
    rdtype = jnp.finfo(cdtype).dtype
    cpsi, spsi = cpsi.astype(rdtype), spsi.astype(rdtype)
    k1sq, k2sq = k1sq.astype(rdtype), k2sq.astype(rdtype)
    ffr = frequencies.astype(rdtype)

    def seg(carry, xs):
        st, sp = carry
        cc, ss, k1, k2, dt, valid = xs
        # phase computed IN-STEP from the scalar dt: precomputing it as a
        # scan input materializes a [paths, K, F] complex array when the
        # pipeline vmaps over solutions (~10 GB for the gen2 workload at
        # G=512), vs K*F in-register sincos here
        arg = (-2.0 * jnp.pi) * dt * ffr
        ph = jax.lax.complex(jnp.cos(arg), jnp.sin(arg))
        b0 = k1 * (cc * st + ss * sp)    # fast mode (n1)
        b1 = k2 * (-ss * st + cc * sp)   # slow mode (n2)
        b1 = b1 * ph
        st_new = cc * b0 - ss * b1
        sp_new = ss * b0 + cc * b1
        st = jnp.where(valid, st_new, st)
        sp = jnp.where(valid, sp_new, sp)
        return (st, sp), None

    (out_t, out_p), _ = jax.lax.scan(
        seg, (spec_theta, spec_phi), (cpsi, spsi, k1sq, k2sq,
                                      dt_rel.astype(rdtype), ok))
    return out_t, out_p
