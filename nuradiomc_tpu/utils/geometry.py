"""Geometry utilities: spherical transforms and Fresnel coefficients (JAX).

Batched, jit-friendly re-implementations of the reference semantics
(NuRadioReco/utilities/geometryUtilities.py:100-290 and radiotools helper
conventions). All functions broadcast over leading batch axes.

Conventions
-----------
* ``zenith = arccos(z / r)``, ``azimuth = arctan2(y, x)``
* on-sky basis for a propagation direction (zenith t, azimuth p):
    eR     = (sin t cos p, sin t sin p, cos t)
    eTheta = (cos t cos p, cos t sin p, -sin t)
    ePhi   = (-sin p, cos p, 0)
* Fresnel: the eTheta component is the p (parallel) polarization, the ePhi
  component is the s (perpendicular) polarization.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def cartesian_to_spherical(v: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(..., 3) cartesian vector -> (zenith, azimuth)."""
    r = jnp.linalg.norm(v, axis=-1)
    zenith = jnp.arccos(jnp.clip(v[..., 2] / jnp.where(r == 0, 1.0, r), -1.0, 1.0))
    azimuth = jnp.arctan2(v[..., 1], v[..., 0])
    return zenith, azimuth


def spherical_to_cartesian(zenith: jnp.ndarray, azimuth: jnp.ndarray) -> jnp.ndarray:
    """(zenith, azimuth) -> unit vector of shape (..., 3)."""
    st, ct = jnp.sin(zenith), jnp.cos(zenith)
    sp, cp = jnp.sin(azimuth), jnp.cos(azimuth)
    return jnp.stack([st * cp, st * sp, ct], axis=-1)


def onsky_basis(zenith: jnp.ndarray, azimuth: jnp.ndarray) -> jnp.ndarray:
    """Rows (eR, eTheta, ePhi) for the given direction; shape (..., 3, 3)."""
    st, ct = jnp.sin(zenith), jnp.cos(zenith)
    sp, cp = jnp.sin(azimuth), jnp.cos(azimuth)
    zeros = jnp.zeros_like(st)
    e_r = jnp.stack([st * cp, st * sp, ct], axis=-1)
    e_theta = jnp.stack([ct * cp, ct * sp, -st], axis=-1)
    e_phi = jnp.stack([-sp, cp, zeros], axis=-1)
    return jnp.stack([e_r, e_theta, e_phi], axis=-2)


def ground_to_onsky(v: jnp.ndarray, zenith: jnp.ndarray, azimuth: jnp.ndarray) -> jnp.ndarray:
    """Project cartesian vector(s) onto the on-sky basis -> (vR, vTheta, vPhi)."""
    basis = onsky_basis(zenith, azimuth)
    return jnp.einsum("...ij,...j->...i", basis, v,
                      precision=jax.lax.Precision.HIGHEST)


def onsky_to_ground(v_onsky: jnp.ndarray, zenith: jnp.ndarray, azimuth: jnp.ndarray) -> jnp.ndarray:
    """Inverse of :func:`ground_to_onsky` (the basis is orthonormal)."""
    basis = onsky_basis(zenith, azimuth)
    return jnp.einsum("...ji,...j->...i", basis, v_onsky,
                      precision=jax.lax.Precision.HIGHEST)


# ---------------------------------------------------------------------------
# Fresnel coefficients (travel from medium n_1 into/off medium n_2)
# ---------------------------------------------------------------------------

def fresnel_angle(zenith_incoming, n_2=1.3, n_1=1.0):
    """Snell's law refraction angle; NaN where total internal reflection occurs.

    Mirrors geometryUtilities.get_fresnel_angle:115-141 (which returns None on
    total internal reflection; here NaN keeps the computation batched).
    """
    t = n_1 / n_2 * jnp.sin(zenith_incoming)
    angle = jnp.arcsin(jnp.clip(t, -1.0, 1.0))
    angle = jnp.where(zenith_incoming > 0.5 * jnp.pi, jnp.pi - angle, angle)
    return jnp.where(jnp.abs(t) > 1.0, jnp.nan, angle)


def fresnel_t_p(zenith_incoming, n_2=1.3, n_1=1.0):
    """Transmission amplitude for p / eTheta polarization (0 beyond TIR)."""
    out = fresnel_angle(zenith_incoming, n_2, n_1)
    t = 2 * n_1 * jnp.cos(zenith_incoming) / (n_1 * jnp.cos(out) + n_2 * jnp.cos(zenith_incoming))
    return jnp.where(jnp.isnan(out), 0.0, t)


def fresnel_t_s(zenith_incoming, n_2=1.3, n_1=1.0):
    """Transmission amplitude for s / ePhi polarization (0 beyond TIR)."""
    out = fresnel_angle(zenith_incoming, n_2, n_1)
    t = 2 * n_1 * jnp.cos(zenith_incoming) / (n_1 * jnp.cos(zenith_incoming) + n_2 * jnp.cos(out))
    return jnp.where(jnp.isnan(out), 0.0, t)


def _csqrt(x):
    """Complex sqrt defined on the principal branch (scimath.sqrt semantics).

    Promotes to the complex dtype matching the input precision (complex64 for
    float32 inputs and complex128 under x64).
    """
    x = jnp.asarray(x)
    if jnp.isrealobj(x):
        x = jax.lax.complex(x, jnp.zeros_like(x))
    return jnp.sqrt(x)


def fresnel_r_p(zenith_incoming, n_2=1.3, n_1=1.0):
    """Reflection amplitude for p / eTheta polarization (complex beyond TIR).

    conj((n^2 cos t - sqrt(n^2 - sin^2 t)) / (n^2 cos t + sqrt(n^2 - sin^2 t)))
    with n = n_2/n_1, as in geometryUtilities.get_fresnel_r_p:208-235.
    """
    n = n_2 / n_1
    ct = jnp.cos(zenith_incoming)
    root = _csqrt(jnp.asarray(n ** 2 - jnp.sin(zenith_incoming) ** 2))
    return jnp.conjugate((n ** 2 * ct - root) / (n ** 2 * ct + root))


def fresnel_r_s(zenith_incoming, n_2=1.3, n_1=1.0):
    """Reflection amplitude for s / ePhi polarization (complex beyond TIR)."""
    n = n_2 / n_1
    ct = jnp.cos(zenith_incoming)
    root = _csqrt(jnp.asarray(n ** 2 - jnp.sin(zenith_incoming) ** 2))
    return jnp.conjugate((ct - root) / (ct + root))
