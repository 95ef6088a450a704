"""Frequency- and depth-dependent ice attenuation lengths (JAX).

Batched re-implementations of the five reference models SP1/GL1/GL2/GL3/MB1
(NuRadioMC/utilities/attenuation.py:145-262). All functions take depth ``z``
(negative below surface) and ``frequency`` in internal units and broadcast over
any batch shape; they are pure jnp so they fuse into the attenuation-integral
kernel of the ray tracer.

The GL3 slope/offset table (attenuation.py:16-33, data/GL3_params.csv) is baked
into a device-resident array at import time.
"""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np

from nuradiomc_tpu.utils import units

MODELS = ("SP1", "GL1", "GL2", "GL3", "MB1")

_GL3 = np.genfromtxt(
    os.path.join(os.path.dirname(os.path.dirname(__file__)), "data", "GL3_params.csv"),
    delimiter=",",
)  # columns: positive depth [m], slope, offset
_MIN_LENGTH = 1.0 * units.m


def _sp1_temperature(z):
    """South Pole ice temperature in Celsius vs depth (attenuation.py:137-151).

    Cubic fit from https://icecube.wisc.edu/~araproject/radio/#icetabsorption.
    """
    z2 = jnp.abs(z) / units.m
    return 1.83415e-09 * z2 ** 3 - 1.59061e-08 * z2 ** 2 + 0.00267687 * z2 - 51.0696


def sp1_w_coeffs(z):
    """SP1's 1/L(z, f) = exp(b1(z) + bb(z) * w), w = ln(f/GHz): returns
    (b1, bb_lo, bb_hi) with bb chosen by branch (f < 1 GHz -> lo).

    Both piecewise branches of the reference's tri-point interpolation
    (attenuation.py:137-160) share the SAME intercept at w = 0 (the 1 GHz
    control point b1) — the algebraic identity the moment-factored
    quadrature in ops.raytrace exploits (one exp per depth sample instead
    of one per (sample, frequency))."""
    t = _sp1_temperature(z)
    w0 = jnp.log(jnp.asarray(0.0001, t.dtype))
    w2 = jnp.log(jnp.asarray(3.16, t.dtype))
    b0 = -6.74890 + t * (0.026709 - t * 0.000884)
    b1 = -6.22121 - t * (0.070927 + t * 0.001773)
    b2 = -4.09468 - t * (0.002213 + t * 0.000332)
    return b1, (b1 - b0) / (-w0), (b2 - b1) / w2


def _sp1(z, frequency):
    t = _sp1_temperature(z)
    f0 = 0.0001
    f2 = 3.16
    w0 = jnp.log(f0)
    w1 = 0.0
    w2 = jnp.log(f2)
    w = jnp.log(frequency / units.GHz)
    b0 = -6.74890 + t * (0.026709 - t * 0.000884)
    b1 = -6.22121 - t * (0.070927 + t * 0.001773)
    b2 = -4.09468 - t * (0.002213 + t * 0.000332)
    # piecewise in frequency: below 1 GHz interpolate (b0,b1), above (b1,b2)
    lo = frequency < 1.0 * units.GHz
    a = jnp.where(lo, (b1 * w0 - b0 * w1) / (w0 - w1), (b2 * w1 - b1 * w2) / (w1 - w2))
    bb = jnp.where(lo, (b1 - b0) / (w1 - w0), (b2 - b1) / (w2 - w1))
    return 1.0 / jnp.exp(a + bb * w)


def _gl1_75mhz(z):
    """GL1 attenuation length at 75 MHz vs depth (attenuation.py:99-129)."""
    zz = z / units.m
    coeffs = jnp.array([1.16052586e03, 6.87257150e-02, -9.82378264e-05,
                        -3.50628312e-07, -2.21040482e-10, -3.63912864e-14])
    att = jnp.polyval(coeffs[::-1], zz)
    return jnp.maximum(att, 100.0 * units.m)


def _gl1(z, frequency):
    return _gl1_75mhz(z) - 0.55 * units.m * (frequency / units.MHz - 75.0)


def _gl2(z, frequency):
    fit = jnp.array([1.20547286e00, 1.58815679e-05, -2.58901767e-07,
                     -5.16435542e-10, -2.89124473e-13, -4.58987344e-17])
    bulk = 852.0 * units.m - 0.54 * (units.m / units.MHz) * frequency
    return bulk * jnp.polyval(fit[::-1], z)


_GL3_DEPTH = jnp.asarray(_GL3[:, 0])   # positive depth in m
_GL3_SLOPE = jnp.asarray(_GL3[:, 1])
_GL3_OFFSET = jnp.asarray(_GL3[:, 2])


def _gl3(z, frequency):
    d = -z  # table is indexed by positive depth
    slope = jnp.interp(d, _GL3_DEPTH, _GL3_SLOPE)
    offset = jnp.interp(d, _GL3_DEPTH, _GL3_OFFSET)
    return slope * frequency + offset


def _mb1(z, frequency):
    R = 0.82
    d_ice = 576 * units.m
    att = 460 * units.m - 180 * (units.m / units.GHz) * frequency
    att = att / (1 + att / (2 * d_ice) * jnp.log(R))
    d = -z * 420.0 * units.m / d_ice
    L = 1250.0 * 0.08886 * jnp.exp(-0.048827 * (225.6746 - 86.517596 * jnp.log10(848.870 - d)))
    return att * L / 231.21 * units.m


_DISPATCH = {"SP1": _sp1, "GL1": _gl1, "GL2": _gl2, "GL3": _gl3, "MB1": _mb1}


def inv_length_factored(z, frequencies, model: str):
    """1/L(z, f) on the outer product grid [**z.shape, F] with the z-only
    coefficients computed ONCE per z sample (the broadcast form recomputes
    the temperature cubic and branch coefficients per frequency).

    SP1 is exp-affine in w = ln f: 1/L = exp(a(z) + b(z) w); the other
    models fall back to the broadcast evaluation.
    """
    if model != "SP1":
        inv = 1.0 / get_attenuation_length(z[..., None], frequencies, model)
        return inv
    t = _sp1_temperature(z)
    f0 = 0.0001
    f2 = 3.16
    w0 = jnp.log(f0)
    w2 = jnp.log(f2)
    b0 = -6.74890 + t * (0.026709 - t * 0.000884)
    b1 = -6.22121 - t * (0.070927 + t * 0.001773)
    b2 = -4.09468 - t * (0.002213 + t * 0.000332)
    a_lo = (b1 * w0 - b0 * 0.0) / w0
    bb_lo = (b1 - b0) / (0.0 - w0)
    a_hi = (b2 * 0.0 - b1 * w2) / (0.0 - w2)
    bb_hi = (b2 - b1) / (w2 - 0.0)
    w = jnp.log(frequencies / units.GHz)
    lo = frequencies < 1.0 * units.GHz
    a = jnp.where(lo, a_lo[..., None], a_hi[..., None])
    bb = jnp.where(lo, bb_lo[..., None], bb_hi[..., None])
    inv = jnp.exp(a + bb * w)
    # clamps of get_attenuation_length: L >= 1 m below, L = inf above surface
    inv = jnp.minimum(inv, 1.0 / _MIN_LENGTH)
    return jnp.where(z[..., None] > 0, 0.0, inv)


def get_attenuation_length(z, frequency, model: str):
    """Attenuation length L(z, f); clipped below at 1 m, inf above the surface.

    Semantics follow attenuation.py:145-262. ``model`` is a static string
    resolved at trace time.
    """
    if model not in _DISPATCH:
        raise NotImplementedError(f"attenuation model {model} is not implemented")
    z, frequency = jnp.broadcast_arrays(jnp.asarray(z), jnp.asarray(frequency))
    att = _DISPATCH[model](z, frequency)
    att = jnp.maximum(att, _MIN_LENGTH)
    return jnp.where(z > 0, jnp.inf, att)
