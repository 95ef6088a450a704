"""Radio-interferometric air-shower reconstruction (RIT).

Re-implementation of
NuRadioReco/modules/efieldRadioInterferometricReconstruction.py (:32-956) and
utilities/interferometry.py (:24-327), on top of the in-repo atmosphere /
refractivity models (models/atmosphere.py) instead of the external radiotools
package.

The beamformed signal at a point in the atmosphere is the sum of all antenna
traces time-shifted by the (refractivity-corrected) light travel time from
that point.  Sampling this along the shower axis gives a longitudinal profile
whose peak depth X_RIT correlates with X_max; sampling lateral planes and
fitting the line through their maxima reconstructs the shower axis.

Batch-first twist: the per-point time shifts for a whole batch of sample
points are computed as one (points, antennas) array; the reference loops
point-by-point through a cached refractivity table.
"""

from __future__ import annotations

import numpy as np
from scipy import optimize, signal as scisig

from nuradiomc_tpu.models.atmosphere import Atmosphere, Refractivity
from nuradiomc_tpu.reco.base import register_run
from nuradiomc_tpu.utils import units
from nuradiomc_tpu.utils.constants import speed_of_light
from nuradiomc_tpu.framework import parameters as par

shp = par.showerParameters

CONVERSION_FACTOR_INTEGRATED_SIGNAL = 1.0 / (376.730313667 * units.ohm)


def get_signal(sum_trace, tstep, window_width=100 * units.ns, kind="power"):
    """Signal metric of a beamformed trace (interferometry.get_signal:24-80)."""
    env = np.abs(scisig.hilbert(sum_trace))
    peak = int(np.argmax(env))
    if kind == "amplitude":
        return float(env[peak])
    n = len(sum_trace)
    tr = np.roll(sum_trace, n // 2 - peak)
    peak = n // 2
    half = int(window_width / 2 // tstep)
    if n < 2 * half:
        tr = np.concatenate([np.zeros(half), tr, np.zeros(half)])
        peak += half
    tr = tr * CONVERSION_FACTOR_INTEGRATED_SIGNAL * tstep
    window = tr[peak - half:peak + half]
    if kind == "power":
        return float(np.sum(window ** 2))
    if kind == "hilbert_sum":
        return float(np.sum(np.abs(scisig.hilbert(tr))[peak - half:peak + half]))
    raise ValueError(f"unknown signal kind {kind}")


def interfere_traces(target_pos, positions, traces, times, refractivity):
    """Shift every antenna trace to the source point and sum
    (interferometry.interfere_traces_rit:83-112 + linear interpolation)."""
    tshifts = refractivity.time_delay(target_pos, positions, speed_of_light)
    times_new = np.asarray(times) - tshifts[:, None]
    tstep = times_new[0, 1] - times_new[0, 0]
    t_sum = np.arange(times_new.min(), times_new.max() + tstep, tstep)
    out = np.zeros(len(t_sum))
    for trace, tt in zip(np.asarray(traces), times_new):
        out += np.interp(t_sum, tt, trace, left=0.0, right=0.0)
    return out, tstep


def shower_frame(zenith, azimuth, magnetic_field_vector):
    """(e_vxB, e_vxvxB, v) unit vectors; v = propagation direction of the
    shower (radiotools cstrafo convention: zenith/azimuth point back to the
    source)."""
    v = -np.array([np.sin(zenith) * np.cos(azimuth),
                   np.sin(zenith) * np.sin(azimuth), np.cos(zenith)])
    B = np.asarray(magnetic_field_vector, dtype=float)
    B = B / np.linalg.norm(B)
    e1 = np.cross(v, B)
    e1 /= np.linalg.norm(e1)
    e2 = np.cross(v, e1)
    e2 /= np.linalg.norm(e2)
    return e1, e2, v


def fit_axis_through_points(points, observation_level=0.0):
    """Least-squares line through beamformed maxima: returns (zenith,
    azimuth, core) with the core at the observation level
    (interferometry.fit_axis:251-289 equivalent)."""
    points = np.asarray(points, dtype=float)
    centroid = points.mean(axis=0)
    _, _, vh = np.linalg.svd(points - centroid)
    axis = vh[0]
    if axis[2] < 0:
        axis = -axis
    zenith = np.arccos(np.clip(axis[2], -1, 1))
    azimuth = np.mod(np.arctan2(axis[1], axis[0]), 2 * np.pi)
    t_core = (observation_level - centroid[2]) / axis[2]
    core = centroid + t_core * axis
    return zenith, azimuth, core


class efieldInterferometricDepthReco:
    """Depth of the beamformed-emission maximum X_RIT along a given axis
    (efieldRadioInterferometricReconstruction.py:32-388)."""

    def begin(self, interpolation=True, signal_kind="power", debug=False,
              atmospheric_model=17, refractivity_at_ground=1.000292):
        self._signal_kind = signal_kind
        self._at = Atmosphere(atmospheric_model)
        self._refr = Refractivity(self._at, n0=refractivity_at_ground)

    def sample_longitudinal_profile(self, traces, times, station_positions,
                                    shower_axis, core, depths=None,
                                    distances=None):
        """Beamformed signal sampled along the axis (:78-160).
        ``shower_axis`` points from the core toward the source."""
        zenith = np.arccos(np.clip(shower_axis[2] / np.linalg.norm(shower_axis),
                                   -1, 1))
        dod = depths if depths is not None else distances
        signals = np.zeros(len(dod))
        for idx, val in enumerate(np.asarray(dod, dtype=float)):
            if depths is not None:
                try:
                    dist = self._at.get_distance_xmax_geometric(
                        zenith, val, observation_level=core[-1])
                except ValueError:
                    continue
            else:
                dist = val
            if dist < 0:
                continue
            point = np.asarray(shower_axis) * dist + np.asarray(core)
            sum_trace, tstep = interfere_traces(
                point, station_positions, traces, times, self._refr)
            signals[idx] = get_signal(sum_trace, tstep, kind=self._signal_kind)
        return signals

    def reconstruct_interferometric_depth(self, traces, times,
                                          station_positions, shower_axis,
                                          core, lower_depth=400.0,
                                          upper_depth=800.0, bin_size=100.0,
                                          return_profile=False):
        """Gauss fit to the longitudinal profile peak (:163-280), extending
        the sampling range if the maximum sits on an edge."""
        depths = np.arange(lower_depth, upper_depth, bin_size)
        sig = self.sample_longitudinal_profile(
            traces, times, station_positions, shower_axis, core, depths=depths)
        while np.argmax(sig) == len(depths) - 1 and depths[-1] <= 2000:
            depths = np.append(depths, depths[-1] + bin_size)
            sig = np.append(sig, self.sample_longitudinal_profile(
                traces, times, station_positions, shower_axis, core,
                depths=depths[-1:]))
        while np.argmax(sig) == 0 and depths[0] > 0:
            depths = np.append(depths[0] - bin_size, depths)
            sig = np.append(self.sample_longitudinal_profile(
                traces, times, station_positions, shower_axis, core,
                depths=depths[:1]), sig)

        imax = int(np.argmax(sig))
        lo = depths[max(imax - 1, 0)]
        hi = depths[min(imax + 1, len(depths) - 1)]
        depths_fine = np.linspace(lo, hi, 20)
        sig_fine = self.sample_longitudinal_profile(
            traces, times, station_positions, shower_axis, core,
            depths=depths_fine)

        def normal(x, A, x0, sigma):
            return A / np.sqrt(2 * np.pi * sigma ** 2) * np.exp(
                -0.5 * ((x - x0) / sigma) ** 2)

        popt, _ = optimize.curve_fit(
            normal, depths_fine, sig_fine,
            p0=[np.max(sig_fine), depths_fine[np.argmax(sig_fine)], 100],
            maxfev=1000)
        if return_profile:
            return depths, depths_fine, sig, sig_fine, popt
        return popt

    @register_run()
    def run(self, evt, station=None, det=None, traces=None, times=None,
            station_positions=None, shower_axis=None, core=None,
            shower=None):
        """Array-level entry point: pass the (vxB) traces and geometry
        directly, or a shower object to pull axis/core from parameters."""
        if shower is not None:
            zen, az = shower[shp.zenith], shower[shp.azimuth]
            shower_axis = np.array([np.sin(zen) * np.cos(az),
                                    np.sin(zen) * np.sin(az), np.cos(zen)])
            core = shower[shp.core]
        popt = self.reconstruct_interferometric_depth(
            traces, times, station_positions, shower_axis, core)
        return float(popt[1])

    def end(self):
        pass


class efieldInterferometricAxisReco(efieldInterferometricDepthReco):
    """Shower-axis reconstruction from beamformed lateral maxima
    (efieldRadioInterferometricReconstruction.py:389-754, simplified: the
    maxima of a refined transverse grid at several depths are fit with an
    SVD line instead of the reference's iterative angular zoom)."""

    def find_maximum_in_plane(self, xs, ys, p_axis, station_positions,
                              traces, times, frame):
        e1, e2, _ = frame
        signals = np.zeros((len(xs), len(ys)))
        for i, x in enumerate(xs):
            for j, y in enumerate(ys):
                p = p_axis + x * e1 + y * e2
                sum_trace, tstep = interfere_traces(
                    p, station_positions, traces, times, self._refr)
                signals[i, j] = get_signal(sum_trace, tstep,
                                           kind=self._signal_kind)
        k = np.unravel_index(np.argmax(signals), signals.shape)
        return k, signals

    def sample_lateral_cross_section(self, traces, times, station_positions,
                                     axis_guess, core_guess, depth, frame,
                                     grid_size=300.0, n_grid=7, n_zoom=5):
        """Maximum of the beamformed signal in the plane transverse to the
        axis at slant depth ``depth``; coarse grid + recursive zoom."""
        zenith = np.arccos(np.clip(axis_guess[2], -1, 1))
        dist = self._at.get_distance_xmax_geometric(
            zenith, depth, observation_level=core_guess[-1])
        p_axis = np.asarray(axis_guess) * dist + np.asarray(core_guess)
        center = np.zeros(2)
        half = grid_size
        for _ in range(n_zoom):
            xs = center[0] + np.linspace(-half, half, n_grid)
            ys = center[1] + np.linspace(-half, half, n_grid)
            (i, j), sig = self.find_maximum_in_plane(
                xs, ys, p_axis, station_positions, traces, times, frame)
            center = np.array([xs[i], ys[j]])
            half = half / (n_grid - 1) * 2
        e1, e2, _ = frame
        return p_axis + center[0] * e1 + center[1] * e2

    def reconstruct_shower_axis(self, traces, times, station_positions,
                                axis_guess, core_guess,
                                magnetic_field_vector,
                                depths=(500.0, 600.0, 700.0, 800.0),
                                grid_size=300.0, n_iterations=2):
        """Iterative: the fitted axis/core of one pass seed the next, with a
        shrinking transverse search window (the reference's angular zoom,
        :456-754, collapsed into whole-axis passes)."""
        axis, core = np.asarray(axis_guess, float), np.asarray(core_guess, float)
        size = grid_size
        for _ in range(n_iterations):
            zen0 = np.arccos(np.clip(axis[2], -1, 1))
            az0 = np.arctan2(axis[1], axis[0])
            frame = shower_frame(zen0, np.mod(az0 + np.pi, 2 * np.pi),
                                 magnetic_field_vector)
            points = [self.sample_lateral_cross_section(
                traces, times, station_positions, axis, core, d,
                frame, grid_size=size) for d in depths]
            zenith, azimuth, core = fit_axis_through_points(
                points, observation_level=core_guess[-1])
            axis = np.array([np.sin(zenith) * np.cos(azimuth),
                             np.sin(zenith) * np.sin(azimuth),
                             np.cos(zenith)])
            size = max(size / 5.0, 40.0)
        return zenith, azimuth, core

    def end(self):
        pass
