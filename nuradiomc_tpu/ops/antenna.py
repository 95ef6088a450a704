"""Antenna vector-effective-length (VEL) evaluation (JAX, batched).

Re-design of the reference antenna pattern machinery
(NuRadioReco/detector/antennapattern.py). Semantics preserved:

* ``get_antenna_response_vectorized`` (antennapattern.py:1246-1307): transform
  the arrival direction into the antenna frame, evaluate the raw pattern,
  rotate the (eR=0, eTheta, ePhi) response back into the global on-sky frame.
* analytic models ``analytic_LPDA`` / ``analytic_VPol`` / ``analytic_HPol``
  (antennapattern.py:1580-1770) used when tabulated models are unavailable.

Batch-first structure: for the analytic models the response factorizes as

    VEL_onsky(f, dir) = T_k(f) * (M(dir) @ [0, d_theta(dir), d_phi(dir)])

with a complex frequency template ``T_k`` (k = LPDA phase sector) precomputed
on the host and a frequency-independent 3x3 rotation ``M`` per (channel,
direction) — so the device work is a couple of scalars plus an outer product.
Tabulated patterns use a batched bilinear gather over (theta, phi) per
frequency bin instead.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from nuradiomc_tpu.utils import geometry, units

# the direction rotations are 3x3 products of unit vectors: cheap, and a
# TF32 pass would leave ~1e-3 relative error in the mixing factors
_matmul = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)

KIND_LPDA = 0
KIND_VPOL = 1
KIND_HPOL = 2

ANALYTIC_MODELS = {
    "analytic_LPDA": (KIND_LPDA, 110 * units.MHz, 0.55 * units.m),
    "analytic_VPol": (KIND_VPOL, 220 * units.MHz, 0.18 * units.m),
    "analytic_HPol": (KIND_HPOL, 500 * units.MHz, 0.055 * units.m),
}

# antenna-frame (WIPL-D) reference orientation of the analytic models:
# boresight +z, tine-normal +x (antennapattern.py:1615-1640)
_MODEL_ORIENTATION = (0.0, 0.0, 90 * units.deg, 0.0)


def _parametric_phase(freq: np.ndarray, phase_type: str) -> np.ndarray:
    """Analytic group-delay phases (antennapattern.py:1642-1670)."""
    if phase_type == "frontlobe_lpda":
        a = 100 * (freq - 400 * units.MHz) ** 2 - 20
        hi = freq > 400 * units.MHz
        a[hi] -= 0.00007 * (freq[hi] - 400 * units.MHz) ** 2
    elif phase_type == "side_lpda":
        a = 40 * (freq - 950 * units.MHz) ** 2 - 40
    elif phase_type == "back_lpda":
        a = 50 * (freq - 950 * units.MHz) ** 2 - 50
    elif phase_type == "VPol_third_order":
        a = 2.086 - 117.917 * freq + 74.567 / 2 * freq ** 2 - 64.343 / 3 * freq ** 3
    elif phase_type == "HPol_third_order":
        a = 0.321 - 11.400 * freq + 39.590 / 2 * freq ** 2 - 38.181 / 3 * freq ** 3
    else:
        raise ValueError(phase_type)
    return a


def _hann(M: int) -> np.ndarray:
    n = np.arange(M)
    return 0.5 - 0.5 * np.cos(2 * np.pi * n / (M - 1)) if M > 1 else np.ones(M)


def build_analytic_template(model: str, freqs: np.ndarray) -> np.ndarray:
    """Complex frequency templates ``T_k(f)`` of an analytic antenna model.

    Returns an array [K, F]: K = 3 phase sectors for the LPDA
    (frontlobe/side/back, antennapattern.py:1700-1707), K = 1 otherwise.
    Host-side numpy; run once at pipeline build.
    """
    kind, cutoff, max_vel = ANALYTIC_MODELS[model]
    freqs = np.asarray(freqs, dtype=float)
    fmask = freqs > 0
    index = int(np.argmax(freqs > cutoff))
    gain_filter = _hann(2 * index) if index > 0 else np.ones(0)

    if kind in (KIND_LPDA, KIND_VPOL):
        gain = np.ones_like(freqs)
        if kind == KIND_VPOL:
            gain[fmask] /= np.sqrt(freqs[fmask])
        T = np.zeros_like(freqs)
        T[fmask] = np.sqrt(gain[fmask]) / freqs[fmask]
        if index > 0:
            T[:index] *= gain_filter[:index]
        T[fmask] *= max_vel / np.max(T[fmask])
    else:  # HPol: gain peaks at cutoff frequency (antennapattern.py:1743-1760)
        T = np.zeros_like(freqs)
        T[fmask] = np.sin(freqs[fmask] / cutoff * np.pi / 2) ** 2
        T[freqs > cutoff * 2] = 0.0
        m = np.max(T[fmask])
        if m > 0:
            T[fmask] *= max_vel / m

    if kind == KIND_LPDA:
        out = np.zeros((3, len(freqs)), dtype=complex)
        for k, pt in enumerate(["frontlobe_lpda", "side_lpda", "back_lpda"]):
            out[k] = T * np.exp(1j * _parametric_phase(freqs, pt))
        return out
    if kind == KIND_VPOL:
        return (T * np.exp(1j * _parametric_phase(freqs, "VPol_third_order")))[None, :]
    return (T * np.exp(1j * _parametric_phase(freqs, "HPol_third_order")))[None, :]


def antenna_rotation_matrix(orientation_theta, orientation_phi,
                            rotation_theta, rotation_phi,
                            model_orientation=_MODEL_ORIENTATION) -> np.ndarray:
    """rot = E^-1 A mapping global -> antenna-frame directions
    (antennapattern.py:1190-1216). Host-side numpy, per channel."""
    def basis(theta, phi, rtheta, rphi):
        e1 = np.array([np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi), np.cos(theta)])
        e2 = np.array([np.sin(rtheta) * np.cos(rphi), np.sin(rtheta) * np.sin(rphi), np.cos(rtheta)])
        e3 = np.cross(e1, e2)
        if np.linalg.norm(e3) < 0.9:
            raise ValueError("antenna orientation and rotation vectors are not perpendicular")
        return np.array([e1, e2, e3])

    E = basis(*model_orientation)
    A = basis(orientation_theta, orientation_phi, rotation_theta, rotation_phi)
    return np.linalg.inv(E) @ A


def _direction_factors(kind, theta_a, phi_a):
    """Raw-pattern direction factors (d_theta, d_phi) in the antenna frame."""
    d_theta_lpda = jnp.cos(theta_a) * jnp.sin(phi_a) * jnp.cos(theta_a / 2)
    d_phi_lpda = jnp.cos(theta_a / 2) * jnp.cos(phi_a)
    d_theta = jnp.where(kind == KIND_LPDA, d_theta_lpda,
                        jnp.where(kind == KIND_VPOL, jnp.sin(theta_a), 0.0))
    d_phi = jnp.where(kind == KIND_LPDA, d_phi_lpda,
                      jnp.where(kind == KIND_HPOL, jnp.sin(theta_a) ** 2, 0.0))
    return d_theta, d_phi


def _lpda_sector(kind, theta_a):
    """LPDA phase sector index (antennapattern.py:1700-1707); 0 otherwise."""
    sector = jnp.where(theta_a <= 45 * units.deg, 0,
                       jnp.where(theta_a <= 90 * units.deg, 1, 2))
    return jnp.where(kind == KIND_LPDA, sector, 0)


def analytic_vel_mix(zenith, azimuth, rot, kind):
    """Frequency-independent part of :func:`analytic_vel`:
    (mix_theta, mix_phi, template_sector). Splitting this out lets batched
    callers gather the (small) frequency templates ONCE instead of
    broadcasting them per element."""
    v_global = geometry.spherical_to_cartesian(zenith, azimuth)
    v_ant = _matmul(rot, v_global)
    theta_a, phi_a = geometry.cartesian_to_spherical(v_ant)

    d_theta, d_phi = _direction_factors(kind, theta_a, phi_a)

    B_out = geometry.onsky_basis(zenith, azimuth)
    B_ant = geometry.onsky_basis(theta_a, phi_a)
    M = _matmul(_matmul(B_out, rot.T), B_ant.T)

    mix_theta = M[1, 1] * d_theta + M[1, 2] * d_phi
    mix_phi = M[2, 1] * d_theta + M[2, 2] * d_phi
    return mix_theta, mix_phi, _lpda_sector(kind, theta_a)


def analytic_vel(zenith, azimuth, rot, templates, kind):
    """On-sky VEL (theta, phi components) of an analytic antenna.

    Parameters
    ----------
    zenith, azimuth : scalars
        Signal arrival direction (global frame), i.e. the receive direction.
    rot : (3, 3)
        Global->antenna-frame rotation from :func:`antenna_rotation_matrix`.
    templates : (K, F) complex
        Frequency templates from :func:`build_analytic_template`.
    kind : int
        KIND_LPDA / KIND_VPOL / KIND_HPOL.

    Returns
    -------
    (vel_theta, vel_phi) : complex arrays of shape (F,)

    vmap over channels x directions for batches.
    """
    # direction in antenna frame
    v_global = geometry.spherical_to_cartesian(zenith, azimuth)
    v_ant = _matmul(rot, v_global)
    theta_a, phi_a = geometry.cartesian_to_spherical(v_ant)

    d_theta, d_phi = _direction_factors(kind, theta_a, phi_a)

    # freq-independent on-sky mixing matrix:
    # M = B(zen, az) @ rot^-1 @ B(theta_a, phi_a)^T   (antennapattern.py:1290-1307)
    B_out = geometry.onsky_basis(zenith, azimuth)          # rows eR,eT,eP (global)
    B_ant = geometry.onsky_basis(theta_a, phi_a)           # rows in antenna frame
    M = _matmul(_matmul(B_out, rot.T), B_ant.T)                            # rot is orthogonal: inv = T

    mix_theta = M[1, 1] * d_theta + M[1, 2] * d_phi
    mix_phi = M[2, 1] * d_theta + M[2, 2] * d_phi

    T = templates[_lpda_sector(kind, theta_a)]
    return T * mix_theta, T * mix_phi


# ---------------------------------------------------------------------------
# tabulated antenna patterns (pickled VEL grids, antennapattern.py:1426-1580)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AntennaTable:
    """Regular-grid complex VEL table H(freq, theta, phi) as device arrays.

    ``orientation`` is the simulated antenna frame stored in the pickle
    (orientation_theta/phi, rotation_theta/phi — the E basis of
    antennapattern.py:1197-1205); pass it as ``model_orientation`` to
    antenna_rotation_matrix so the detector orientation is expressed
    relative to the simulated one.
    """

    freqs: jnp.ndarray     # (F0,) ascending
    thetas: jnp.ndarray    # (T,) ascending
    phis: jnp.ndarray      # (P,) ascending
    h_theta: jnp.ndarray   # (F0, T, P) complex
    h_phi: jnp.ndarray     # (F0, T, P) complex
    orientation: tuple = (0.0, 0.0, np.pi / 2, np.pi / 2)


def _grid_weights(x, grid):
    """(idx, w) for linear interpolation on an ascending regular-ish grid."""
    grid = jnp.asarray(grid)   # ChannelParams leaves may be host numpy
    idx = jnp.clip(jnp.searchsorted(grid, x, side="right") - 1, 0, grid.shape[0] - 2)
    x0 = grid[idx]
    x1 = grid[idx + 1]
    w = jnp.clip((x - x0) / jnp.where(x1 == x0, 1.0, x1 - x0), 0.0, 1.0)
    return idx, w


def table_vel_raw(table: AntennaTable, freqs, theta_a, phi_a):
    """Trilinear complex interpolation of the raw VEL table at one direction
    (antennapattern.py:1426-1580 semantics). freqs: (F,); returns (F,) pairs."""
    fi, fw = _grid_weights(freqs, table.freqs)
    ti, tw = _grid_weights(theta_a, table.thetas)
    pi_, pw = _grid_weights(phi_a, table.phis)

    def gather(h):
        h = jnp.asarray(h)

        def corner(df, dt, dp):
            return h[fi + df, ti + dt, pi_ + dp]
        h00 = corner(0, 0, 0) * (1 - pw) + corner(0, 0, 1) * pw
        h01 = corner(0, 1, 0) * (1 - pw) + corner(0, 1, 1) * pw
        h10 = corner(1, 0, 0) * (1 - pw) + corner(1, 0, 1) * pw
        h11 = corner(1, 1, 0) * (1 - pw) + corner(1, 1, 1) * pw
        h0 = h00 * (1 - tw) + h01 * tw
        h1 = h10 * (1 - tw) + h11 * tw
        return h0 * (1 - fw) + h1 * fw

    # out-of-band frequencies AND out-of-grid directions return 0
    # (_get_antenna_response_vectorized_raw:1437-1448, 1556-1560)
    out_of_band = (freqs < table.freqs[0]) | (freqs > table.freqs[-1])
    out_dir = ((theta_a < table.thetas[0]) | (theta_a > table.thetas[-1])
               | (phi_a < table.phis[0]) | (phi_a > table.phis[-1]))
    vt = jnp.where(out_of_band | out_dir, 0.0, gather(table.h_theta))
    vp = jnp.where(out_of_band | out_dir, 0.0, gather(table.h_phi))
    return vt, vp


def table_vel(zenith, azimuth, rot, table: AntennaTable, freqs):
    """On-sky VEL from a tabulated pattern, including orientation rotation."""
    v_global = geometry.spherical_to_cartesian(zenith, azimuth)
    v_ant = _matmul(rot, v_global)
    theta_a, phi_a = geometry.cartesian_to_spherical(v_ant)
    # wrap phi into the grid's 2-pi window (the reference's +-2pi while
    # loops, antennapattern.py:1430-1434)
    phi_a = table.phis[0] + jnp.mod(phi_a - table.phis[0], 2 * jnp.pi)

    vt_raw, vp_raw = table_vel_raw(table, freqs, theta_a, phi_a)

    B_out = geometry.onsky_basis(zenith, azimuth)
    B_ant = geometry.onsky_basis(theta_a, phi_a)
    M = _matmul(_matmul(B_out, rot.T), B_ant.T)
    vel_theta = M[1, 1] * vt_raw + M[1, 2] * vp_raw
    vel_phi = M[2, 1] * vt_raw + M[2, 2] * vp_raw
    return vel_theta, vel_phi


def load_antenna_table(path: str) -> AntennaTable:
    """Load a reference-format pickled antenna pattern into an AntennaTable.

    The reference pickle (antennapattern.py:1315-1336) holds 9 lists:
    [orientation_theta, orientation_phi, rotation_theta, rotation_phi,
    ff, thetas, phis, H_phi, H_theta] — note H_PHI before H_THETA — with
    flat index iFreq*n_theta*n_phi + iPhi*n_theta + iTheta
    (_get_index, antennapattern.py:1423), i.e. a (freq, PHI, THETA) layout.
    """
    import pickle

    with open(path, "rb") as f:
        data = pickle.load(f, encoding="latin1")
    if len(data) != 9:
        raise ValueError(
            f"unexpected antenna pickle format: {len(data)} entries "
            "(the reference format has 9, antennapattern.py:1315-1336)")
    (ori_theta, ori_phi, rot_theta, rot_phi,
     ff, thetas, phis, h_phi, h_theta) = data
    f_u = np.unique(ff)
    t_u = np.unique(thetas)
    p_u = np.unique(phis)
    shape = (len(f_u), len(p_u), len(t_u))        # [freq][phi][theta]

    def grid(h):
        return np.transpose(np.reshape(np.asarray(h), shape), (0, 2, 1))

    return AntennaTable(
        freqs=jnp.asarray(f_u), thetas=jnp.asarray(t_u), phis=jnp.asarray(p_u),
        h_theta=jnp.asarray(grid(h_theta)),
        h_phi=jnp.asarray(grid(h_phi)),
        orientation=(float(ori_theta), float(ori_phi),
                     float(rot_theta), float(rot_phi)),
    )
