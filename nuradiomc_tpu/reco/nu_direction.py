"""Neutrino direction + shower-energy reconstruction by forward folding.

Re-implementation of NuRadioReco/modules/neutrinoDirectionReconstructor/
voltageToEfieldAnalyticConverterForNeutrinos.py (:24-512): with the vertex
known, the ray geometry (launch/receive vectors, travel times, attenuation,
Fresnel coefficients) to every antenna is FIXED; the fit parameters
(nu zenith, nu azimuth, log10 shower energy) only enter through the viewing
angle, the polarization, and the Askaryan amplitude.  The reference evaluates
one parameter triple per scipy.optimize.brute step ("takes roughly 20
minutes"); here the whole parameter grid is one vmapped, jitted batch —
seconds on a GPU or CPU for the same 1-degree x 0.1-dex scan.
"""

from __future__ import annotations

import numpy as np

from nuradiomc_tpu.framework import parameters as par
from nuradiomc_tpu.ops import antenna as antenna_ops
from nuradiomc_tpu.ops import askaryan, filters, raytrace
from nuradiomc_tpu.reco.base import register_run
from nuradiomc_tpu.reco.efield_converters import get_channel_vel
from nuradiomc_tpu.utils import geometry, units

stnp = par.stationParameters


class neutrinoDirectionReconstructor:

    def begin(self, ice, attenuation_model="SP1", antenna_replacements=None,
              n_attenuation_steps=64):
        self._ice = ice
        self._att_model = attenuation_model
        self._reps = antenna_replacements or {}
        self._att_steps = n_attenuation_steps

    def _fixed_geometry(self, det, station_id, vertex, use_channels, ff):
        """Ray-tracing quantities that do not depend on the fit parameters
        (reference run():300-376, computed once before the minimizer)."""
        import jax
        import jax.numpy as jnp

        A = len(use_channels)
        positions = np.array([det.get_relative_position(station_id, c)
                              for c in use_channels])
        x1 = jnp.asarray(np.broadcast_to(vertex, (A, 3)).copy())
        x2 = jnp.asarray(positions)
        geom = raytrace.to_2d(x1, x2)
        sols = jax.vmap(lambda a, b, c, d: raytrace.find_solutions(
            a, b, c, d, self._ice))(geom.x1y, geom.x1z, geom.x2y, geom.x2z)
        launch, receive = raytrace.launch_receive_vectors(geom, sols)

        att = jax.vmap(jax.vmap(
            lambda c0, a, b, c, d: raytrace.attenuation_factor(
                c0, a, b, c, d, self._ice, jnp.asarray(ff), self._att_model,
                n_steps=self._att_steps),
            in_axes=(0, None, None, None, None)))(
            sols.c0, geom.x1y, geom.x1z, geom.x2y, geom.x2z)   # [A,2,F]

        n_surf = self._ice.index_of_refraction(-1e-2 * units.m)
        refl_zen = np.arctan(1.0 / np.sqrt(np.maximum(
            np.asarray(sols.c0) ** 2 * n_surf ** 2 - 1.0, 1e-12)))
        is_refl = np.asarray(sols.sol_type) == raytrace.SOL_REFLECTED
        r_t = np.where(is_refl, np.asarray(
            geometry.fresnel_r_p(jnp.asarray(refl_zen), n_2=1.0, n_1=n_surf)), 1.0)
        r_p = np.where(is_refl, np.asarray(
            geometry.fresnel_r_s(jnp.asarray(refl_zen), n_2=1.0, n_1=n_surf)), 1.0)

        # antenna response at the (fixed) receive directions
        zen_r, az_r = geometry.cartesian_to_spherical(receive)
        vel_t = np.zeros((A, 2, len(ff)), dtype=complex)
        vel_p = np.zeros((A, 2, len(ff)), dtype=complex)
        for i, cid in enumerate(use_channels):
            for s in range(2):
                vt, vp = get_channel_vel(det, station_id, cid, ff,
                                         float(zen_r[i, s]), float(az_r[i, s]),
                                         self._reps)
                vel_t[i, s], vel_p[i, s] = vt, vp

        return dict(
            launch=np.asarray(launch), mask=np.asarray(sols.mask),
            travel_time=np.asarray(sols.travel_time),
            path_length=np.asarray(sols.path_length),
            att=np.asarray(att), r_t=r_t, r_p=r_p,
            vel_t=vel_t, vel_p=vel_p,
            zen_l=np.asarray(geometry.cartesian_to_spherical(launch)[0]),
            az_l=np.asarray(geometry.cartesian_to_spherical(launch)[1]),
        )

    @register_run()
    def run(self, evt, station, det, vertex=None, use_channels=(0, 1, 2, 3),
            shower_type="HAD", model="Alvarez2000", passband=None,
            noise_RMS=10 * units.micro * units.V, use_hilbert=False,
            zenith_range=None, azimuth_range=None, energy_range=(15.0, 19.0),
            coarse_steps=(20, 20, 16), n_zoom=2):
        """Fit (nu_zenith, nu_azimuth, log10 E_shower) to the measured traces.

        vertex: interaction vertex (e.g. from the vertex reconstructor or MC).
        zenith_range/azimuth_range default to the full sky; pass narrow
        windows (the reference's use_MC mode) for speed.
        """
        import jax
        import jax.numpy as jnp

        station_id = station.get_id()
        if vertex is None:
            vertex = np.asarray(station[stnp.nu_vertex])
        ch0 = station.get_channel(use_channels[0])
        fs = ch0.get_sampling_rate()
        n_t = min(station.get_channel(c).get_number_of_samples()
                  for c in use_channels)
        n_t -= n_t % 2
        dt = 1.0 / fs
        ff = np.fft.rfftfreq(n_t, dt)

        fixed = self._fixed_geometry(det, station_id, vertex, use_channels, ff)
        measured = np.array([np.asarray(station.get_channel(c).get_trace())[:n_t]
                             for c in use_channels])
        cable = np.array([det.get_cable_delay(station_id, c)
                          for c in use_channels])
        best_ch = int(np.argmax(np.max(np.abs(measured), axis=-1)))

        band = np.ones(len(ff), dtype=complex)
        if passband is not None:
            band = filters.get_filter_response(ff, passband, "butter", order=5)
        n_index = float(self._ice.index_of_refraction(vertex[2]))
        is_em = shower_type.upper() == "EM"
        tt_rel = fixed["travel_time"] - np.min(
            np.where(fixed["mask"], fixed["travel_time"], np.inf))
        dT = tt_rel + (cable - cable.min())[:, None]              # [A,2]

        launch = jnp.asarray(fixed["launch"])                     # [A,2,3]
        mask = jnp.asarray(fixed["mask"])
        att = jnp.asarray(fixed["att"])
        r_t = jnp.asarray(fixed["r_t"])
        r_p = jnp.asarray(fixed["r_p"])
        vel_t = jnp.asarray(fixed["vel_t"])
        vel_p = jnp.asarray(fixed["vel_p"])
        zen_l = jnp.asarray(fixed["zen_l"])
        az_l = jnp.asarray(fixed["az_l"])
        R = jnp.asarray(np.maximum(fixed["path_length"], 1.0))
        ffj = jnp.asarray(ff)
        bandj = jnp.asarray(band)
        phase_dt = jnp.exp(-2j * jnp.pi * ffj[None, None, :]
                           * jnp.asarray(dT)[..., None]) * bandj
        measured_j = jnp.asarray(measured)
        meas_best = jnp.asarray(measured[best_ch])

        def forward(zen_nu, az_nu, log10_E):
            """Analytic voltage traces for one parameter triple -> [A, n_t]."""
            nu_dir = -geometry.spherical_to_cartesian(zen_nu, az_nu)
            cosv = jnp.sum(nu_dir * launch, axis=-1)
            view = jnp.arccos(jnp.clip(cosv, -1.0, 1.0))          # [A,2]
            spec = jax.vmap(jax.vmap(
                lambda v, r: askaryan.get_frequency_spectrum(
                    10.0 ** log10_E, v, n_t, dt, is_em, n_index, r, model)))(
                view, R)                                          # [A,2,F]
            pol = jnp.cross(launch, jnp.cross(nu_dir[None, None, :], launch))
            pol = pol / jnp.maximum(
                jnp.linalg.norm(pol, axis=-1, keepdims=True), 1e-30)
            pol_onsky = geometry.ground_to_onsky(pol, zen_l, az_l)
            e_t = pol_onsky[..., 1:2] * spec * att * r_t[..., None]
            e_p = pol_onsky[..., 2:3] * spec * att * r_p[..., None]
            v_spec = (vel_t * e_t + vel_p * e_p) * phase_dt
            v_spec = jnp.where(mask[..., None], v_spec, 0.0)
            v_spec = jnp.sum(v_spec, axis=1)                      # [A,F]
            return jnp.fft.irfft(v_spec, n=n_t, axis=-1) * fs / jnp.sqrt(2.0)

        def chi2_one(params):
            zen_nu, az_nu, log10_E = params
            traces = forward(zen_nu, az_nu, log10_E)
            # global time offset from the best-SNR channel (reference :190-210)
            corr = jnp.fft.irfft(
                jnp.fft.rfft(meas_best, 2 * n_t)
                * jnp.conj(jnp.fft.rfft(traces[best_ch], 2 * n_t)), 2 * n_t)
            toffset = jnp.argmax(jnp.abs(corr))                  # circular lag
            rolled = jnp.roll(traces, toffset, axis=-1)
            if use_hilbert:
                from nuradiomc_tpu.ops import trace as trace_ops
                d = (trace_ops.hilbert_envelope(measured_j)
                     - trace_ops.hilbert_envelope(rolled))
            else:
                d = measured_j - rolled
            return jnp.sum(jnp.abs(d) ** 2) / (2 * noise_RMS ** 2)

        chi2_batch = jax.jit(jax.vmap(chi2_one))

        if zenith_range is None:
            zenith_range = (0.0, np.pi)
        if azimuth_range is None:
            azimuth_range = (0.0, 2 * np.pi)
        lo = np.array([zenith_range[0], azimuth_range[0], energy_range[0]])
        hi = np.array([zenith_range[1], azimuth_range[1], energy_range[1]])
        center, half = 0.5 * (lo + hi), 0.5 * (hi - lo)
        nz, na, ne = coarse_steps
        for _ in range(1 + n_zoom):
            axes = [np.linspace(center[d] - half[d], center[d] + half[d], n)
                    for d, n in zip(range(3), (nz, na, ne))]
            ZZ, AA, EE = np.meshgrid(*axes, indexing="ij")
            pts = np.stack([ZZ.ravel(), AA.ravel(), EE.ravel()], axis=-1)
            chi2 = np.asarray(chi2_batch(jnp.asarray(pts)))
            k = int(np.argmin(chi2))
            center = pts[k]
            half = np.array([axes[d][1] - axes[d][0] for d in range(3)]) * 1.5

        zen_fit, az_fit, logE_fit = center
        station[stnp.nu_zenith] = float(zen_fit)
        station[stnp.nu_azimuth] = float(np.mod(az_fit, 2 * np.pi))
        station[stnp.shower_energy] = float(10 ** logE_fit)
        nu_dir = -np.asarray(geometry.spherical_to_cartesian(zen_fit, az_fit))
        cosv = np.sum(nu_dir * fixed["launch"], axis=-1)
        station[stnp.viewing_angles] = np.arccos(np.clip(cosv, -1, 1))
        self.chi2_min = float(chi2[k])
        self.forward = forward
        return zen_fit, float(np.mod(az_fit, 2 * np.pi)), float(logE_fit)

    def end(self):
        pass
