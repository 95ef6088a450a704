"""ARZ2019/ARZ2020 semi-analytic Askaryan model (JAX, batched).

Re-implementation of the reference ARZ model
(NuRadioMC/SignalGen/ARZ/ARZ.py): the time-domain vector potential is the
convolution of a tabulated charge-excess profile with the parametrized
Cherenkov form factor A_C(tt) (get_vector_potential:36-275, Eq. 15/16 of the
ARZ PRD paper); the electric field is its (negative) time derivative, rotated
into on-sky coordinates using the viewing angle relative to the shower
maximum (get_time_trace:500-655).

Fixed-shape integration scheme: the reference refines the profile integral with
a data-dependent 100x interpolation wherever |tt| < 1 ns (ARZ.py:166-227).
Here the integral is a fixed-shape sum: a coarse trapezoid over the full
profile plus two dense windows (static width) centered on the two coarse grid
points closest to tt = 0 — exactly where the form-factor peak crosses the
profile. Away from those crossings the integrand is smooth on the coarse
grid, so the decomposition is accurate with no dynamic shapes.

Model parameters from ARZ.py:394-434; em_fraction from :436-447.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from nuradiomc_tpu.utils import geometry, units

RHO = 0.924 * units.g / units.cm ** 3        # ice density (ARZ.py:31)
XMU = 12.566370e-7 * units.newton / units.ampere ** 2
C = 2.99792458e8 * units.m / units.s

# (Af, t0_pos, freq_pos, exp_pos, t0_neg, freq_neg, exp_neg) per shower type
PARAMS = {
    "ARZ2019": {
        "EM": (-4.5e-14 * 0.88 * units.V * units.s, 0.057, 2.87, -3.00, 0.030, 3.05, -3.50),
        "HAD": (-3.2e-14 * units.V * units.s, 0.065, 3.00, -2.65, 0.043, 2.92, -3.21),
        "em_factor": False,
    },
    "ARZ2020": {
        "EM": (-4.445e-14 * units.V * units.s, 0.0348, 2.298, -3.588, 0.0203, 2.616, -4.043),
        "HAD": (-4.071e-14 * units.V * units.s, 0.0391, 2.338, -3.320, 0.0234, 2.686, -3.687),
        "em_factor": True,
    },
}


def em_fraction(energy):
    """EM energy fraction of a hadronic shower (ARZ.py:436-447, ARZ2020)."""
    eps = jnp.log10(energy / units.eV)
    return -21.98905 - 2.32492 * eps + 0.019650 * eps ** 2 + 13.76152 * jnp.sqrt(eps)


def theta_to_thetaprime(theta, xmax_m, R):
    """Viewing angle w.r.t. shower max from angle w.r.t. vertex
    (ARZ.py:299-315). ``xmax_m`` is the distance of shower max along the
    axis in metres (the library stores its depth grid pre-divided by RHO:
    column-depth values in internal units are ~1e40 and would overflow a
    float32 constant)."""
    return jnp.arctan2(R * jnp.sin(theta), R * jnp.cos(theta) - xmax_m)


def _form_factor(tt, t0_pos, freq_pos, exp_pos, t0_neg, freq_neg, exp_neg):
    """A_Cherenkov(tt) / (Af E_TeV) (Eq. 16, get_vector_potential:245-261)."""
    pos = jnp.exp(-jnp.abs(tt) / t0_pos) + (1.0 + freq_pos * jnp.abs(tt)) ** exp_pos
    neg = jnp.exp(-jnp.abs(tt) / t0_neg) + (1.0 + freq_neg * jnp.abs(tt)) ** exp_neg
    return jnp.where(tt > 0, pos, neg)


def vector_potential(shower_energy, theta, N: int, dt: float,
                     profile_depth, profile_ce, is_em, n_index, distance,
                     version: str = "ARZ2020", em_frac=None,
                     window_halfwidth: int = 3, n_dense: int = 96):
    """Vector potential A(t) with N+1 samples (get_vector_potential:36-275).

    profile_depth/profile_ce: (P,) arrays (uniform depth grid).
    is_em: traced bool selecting the EM/HAD parameter set and em_factor.
    Returns vp of shape (N+1, 3).
    """
    p = PARAMS[version]
    prm_em = jnp.asarray(p["EM"][:7])
    prm_had = jnp.asarray(p["HAD"][:7])
    prm = jnp.where(is_em, prm_em, prm_had)
    Af, t0p, fqp, exp_p, t0n, fqn, exp_n = [prm[i] for i in range(7)]

    if em_frac is None:
        em_frac = em_fraction(shower_energy) if p["em_factor"] else 1.0
    em_factor = jnp.where(is_em, 1.0, em_frac)

    ttt = jnp.arange(N + 1) * dt
    ttt = ttt + 0.5 * dt - jnp.mean(ttt)

    cher = jnp.arccos(1.0 / n_index)
    length = profile_depth                           # (P,) metres (see ShowerLibrary)
    X = jnp.stack([distance * jnp.sin(theta), jnp.zeros_like(theta),
                   distance * jnp.cos(theta)])

    dz_coarse = length[1] - length[0]
    xntot = jnp.sum(profile_ce) * dz_coarse          # total track length
    factor = -XMU / (4 * jnp.pi)
    fc = 4 * jnp.pi / (XMU * jnp.sin(cher))
    E_TeV = shower_energy / units.TeV
    R0 = jnp.sqrt(X[0] ** 2 + X[2] ** 2)

    def integrand(z, ce, tobs):
        """-v_perp * ce * F_p / R at shower coordinate z (vectorized over z)."""
        R = jnp.sqrt(X[0] ** 2 + (X[2] - z) ** 2)
        arg = z - (C * tobs - n_index * R)
        tt = -arg / C
        in_window = (tt < 20.0) & (tt > -20.0)
        Acher = Af * E_TeV * _form_factor(tt, t0p, fqp, exp_p, t0n, fqn, exp_n)
        F_p = jnp.where(in_window, Acher * fc / xntot * em_factor, 0.0)
        u_x = X[0] / R
        u_z = (X[2] - z) / R
        v = jnp.stack([u_x * u_z, jnp.zeros_like(u_x), -(u_x * u_x)], axis=-1)
        return -v * (ce * F_p / R)[..., None], tt     # (..., 3)

    w = window_halfwidth
    P = profile_depth.shape[0]

    def one_time(t):
        tobs = t + R0 / C * n_index
        f_coarse, tt = integrand(length, profile_ce, tobs)      # (P, 3)
        coarse = jnp.trapezoid(f_coarse, dx=dz_coarse, axis=0)

        # two dense windows around the two |tt|=0 crossings
        i1 = jnp.clip(jnp.argmin(jnp.abs(tt)), w, P - 1 - w)
        masked = jnp.where(jnp.abs(jnp.arange(P) - i1) <= 2 * w, jnp.inf, jnp.abs(tt))
        i2 = jnp.clip(jnp.argmin(masked), w, P - 1 - w)

        def window_correction(ic):
            z_lo = length[ic - w]
            z_hi = length[ic + w]
            # dense replacement integral over [z_lo, z_hi]
            zd = jnp.linspace(0.0, 1.0, n_dense) * (z_hi - z_lo) + z_lo
            ced = jnp.interp(zd, length, profile_ce)
            f_dense, _ = integrand(zd, ced, tobs)
            dense = jnp.trapezoid(f_dense, x=zd, axis=0)
            # subtract the coarse contribution of the same interval
            seg = jnp.arange(P - 1)
            w_seg = ((seg >= ic - w) & (seg < ic + w)).astype(f_coarse.dtype)
            coarse_win = jnp.sum(
                0.5 * (f_coarse[1:] + f_coarse[:-1]) * w_seg[:, None], axis=0) * dz_coarse
            return dense - coarse_win

        return coarse + window_correction(i1) + window_correction(i2)

    vp = jax.vmap(one_time)(ttt)                     # (N+1, 3)
    return vp * factor


def get_time_trace(shower_energy, theta, N: int, dt: float,
                   profile_depth, profile_ce, is_em, n_index, R,
                   version: str = "ARZ2020",
                   maximum_angle=20 * units.deg, **kwargs):
    """On-sky (eR, eTheta, ePhi) electric-field trace, shape (3, N)
    (ARZ.get_time_trace:500-655). Zero outside ``maximum_angle`` of the cone."""
    vp = vector_potential(shower_energy, theta, N, dt, profile_depth,
                          profile_ce, is_em, n_index, R, version, **kwargs)
    trace = -jnp.diff(vp, axis=0) / dt               # (N, 3) ground frame

    xmax = profile_depth[jnp.argmax(profile_ce)]
    thetaprime = theta_to_thetaprime(theta, xmax, R)
    onsky = geometry.ground_to_onsky(trace, thetaprime, jnp.zeros_like(thetaprime))

    cher = jnp.arccos(1.0 / n_index)
    keep = jnp.abs(theta - cher) <= maximum_angle
    return jnp.where(keep, onsky.T, 0.0)             # (3, N)


# ---------------------------------------------------------------------------
# shower-profile library
# ---------------------------------------------------------------------------

class ShowerLibrary(NamedTuple):
    """Packed charge-excess profile library (device arrays).

    Profiles are stored per shower type on a common depth grid, with the
    energy they were simulated at (amplitudes rescale linearly with energy,
    ARZ.get_time_trace:563-570).

    ``depth`` holds the grid as axis distance in METRES (column depth /
    RHO, converted at load time): raw column-depth values carry units.g
    (~6e33) and overflow float32; the distance representation is
    what every consumer uses anyway.
    """

    depth: jnp.ndarray        # (P,) common depth grid, metres (= X/RHO)
    ce_em: jnp.ndarray        # (M_em, P)
    e_em: jnp.ndarray         # (M_em,) simulation energies
    ce_had: jnp.ndarray       # (M_had, P)
    e_had: jnp.ndarray        # (M_had,)


def load_library_pickle(path: str) -> ShowerLibrary:
    """Load a reference-format shower library pickle
    (dict[shower_type][energy] -> {'depth', 'charge_excess'})."""
    import pickle

    with open(path, "rb") as f:
        lib = pickle.load(f, encoding="latin1")

    def pack(sub):
        depths, ces, es = None, [], []
        for E, entry in sorted(sub.items()):
            depths = np.asarray(entry["depth"])
            for ce in entry["charge_excess"]:
                ces.append(np.asarray(ce))
                es.append(E)
        return depths, np.array(ces), np.array(es)

    d_em, ce_em, e_em = pack(lib.get("EM", lib.get("em", {})))
    d_had, ce_had, e_had = pack(lib.get("HAD", lib.get("had", {})))
    depth = (d_em if d_em is not None else d_had) / float(RHO)
    return ShowerLibrary(depth=jnp.asarray(depth),
                         ce_em=jnp.asarray(ce_em), e_em=jnp.asarray(e_em),
                         ce_had=jnp.asarray(ce_had), e_had=jnp.asarray(e_had))


def build_library_from_t_files(file_electron: str, file_positron: str,
                               energy: float) -> ShowerLibrary:
    """Build a single-shower library from raw AIRES .t1005/.t1006 exports
    (charge excess = N_e - N_p; scripts/A01preprocess_shower_library_v1.2.py)."""
    depth_e, N_e = np.loadtxt(file_electron, unpack=True, usecols=(1, 2))
    depth_p, N_p = np.loadtxt(file_positron, unpack=True, usecols=(1, 2))
    depth = (depth_e - 1000.0) * float(units.g / units.cm ** 2 / RHO)
    ce = (N_e - N_p)[None, :]
    return ShowerLibrary(depth=jnp.asarray(depth),
                         ce_em=jnp.asarray(ce), e_em=jnp.asarray([energy]),
                         ce_had=jnp.asarray(ce), e_had=jnp.asarray([energy]))


def select_profile(lib: ShowerLibrary, shower_energy, is_em, i_profile):
    """Pick profile ``i_profile`` with energy rescaling; returns (P,) ce.

    Mirrors the closest-energy pick + linear rescale (ARZ.py:563-599); the
    random profile index is drawn on the host and persisted per shower.
    """
    def pick(ce, es):
        i = jnp.clip(i_profile, 0, ce.shape[0] - 1)
        return ce[i] * (shower_energy / es[i])

    return jnp.where(is_em, pick(lib.ce_em, lib.e_em), pick(lib.ce_had, lib.e_had))
