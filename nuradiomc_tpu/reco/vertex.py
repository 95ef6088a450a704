"""Neutrino vertex reconstruction from channel-pair timing correlations.

Re-implementation of
NuRadioReco/modules/neutrinoVertexReconstructor/neutrino2DVertexReconstructor.py
(:16-500) and its lookup-table generator (create_lookup_table.py:1-107).

Batch-first twist: the reference precomputes travel-time lookup tables with a
double Python loop over the (r, z) grid (hours per table, shipped as pickles);
here the table is ONE batched call into the vmapped analytic ray solver
(ops/raytrace.find_solutions), so tables are built on the fly per antenna
depth in seconds.
"""

from __future__ import annotations

import numpy as np
from scipy import signal as scisig

from nuradiomc_tpu.framework import parameters as par
from nuradiomc_tpu.reco.base import register_run
from nuradiomc_tpu.utils import units

stnp = par.stationParameters

RAY_TYPE_INDEX = {"direct": 0, "refracted": 1, "reflected": 2}


def build_travel_time_table(ice, antenna_z, x_min=10 * units.m,
                            x_max=5 * units.km, d_x=2 * units.m,
                            z_min=-3 * units.km, z_max=-50 * units.m,
                            d_z=2 * units.m, chunk=65536):
    """Travel-time tables t(r, z) for direct/refracted/reflected rays to an
    antenna at depth ``antenna_z`` (create_lookup_table.py:64-107, but one
    vmapped solver call per chunk instead of a scalar double loop).

    Returns (header dict, (3, n_x, n_z) array; 0 where no solution).
    """
    import jax
    import jax.numpy as jnp

    from nuradiomc_tpu.ops import raytrace

    x_pos = np.arange(x_min, x_max, d_x)
    z_pos = np.arange(z_min, z_max, d_z)
    XX, ZZ = np.meshgrid(x_pos, z_pos, indexing="ij")
    n_pts = XX.size

    @jax.jit
    def solve(x1, x2):
        geom = raytrace.to_2d(x1, x2)
        sols = jax.vmap(lambda a, b, c, d: raytrace.find_solutions(
            a, b, c, d, ice))(geom.x1y, geom.x1z, geom.x2y, geom.x2z)
        return sols.sol_type, sols.travel_time, sols.mask

    table = np.zeros((3, len(x_pos), len(z_pos)))
    flat_x, flat_z = XX.ravel(), ZZ.ravel()
    for i0 in range(0, n_pts, chunk):
        sl = slice(i0, min(i0 + chunk, n_pts))
        m = sl.stop - sl.start
        x1 = np.c_[flat_x[sl], np.zeros(m), flat_z[sl]]
        x2 = np.broadcast_to(np.array([0.0, 0.0, antenna_z]), (m, 3))
        st, tt, mask = jax.tree.map(np.asarray, solve(jnp.asarray(x1),
                                                      jnp.asarray(x2)))
        flat_idx = np.arange(sl.start, sl.stop)
        for slot in range(st.shape[-1]):
            ok = mask[:, slot] & (st[:, slot] > 0)
            ix, iz = np.unravel_index(flat_idx[ok], XX.shape)
            table[st[ok, slot] - 1, ix, iz] = tt[ok, slot]

    header = {"x_min": x_pos[0], "d_x": d_x, "n_x": len(x_pos),
              "z_min": z_pos[0], "d_z": d_z, "n_z": len(z_pos)}
    return header, table


def lookup_travel_time(header, table, ray_type, d_hor, z):
    """Nearest-bin lookup (get_signal_travel_time:396-433); NaN outside."""
    i_x = np.round((np.asarray(d_hor) - header["x_min"]) / header["d_x"]).astype(int)
    i_z = np.round((np.asarray(z) - header["z_min"]) / header["d_z"]).astype(int)
    mask = (i_x >= 0) & (i_x < header["n_x"]) & (i_z >= 0) & (i_z < header["n_z"])
    tt = table[RAY_TYPE_INDEX[ray_type]][np.clip(i_x, 0, header["n_x"] - 1),
                                         np.clip(i_z, 0, header["n_z"] - 1)]
    out = np.where(mask & (tt > 0), tt, np.nan)
    return out


class neutrino2DVertexReconstructor:
    """Vertex (r, z) from stacked channel-pair correlation maps
    (neutrino2DVertexReconstructor.py:16-500).

    All channels must be on one string. For every channel pair and every
    ray-type hypothesis, the time difference expected from each grid point
    indexes the pair's cross-correlation; maps are stacked (weighted by
    correlation SNR) and the maximum is the reconstructed vertex.
    """

    RAY_TYPES = [
        ("direct", "direct"), ("reflected", "reflected"),
        ("refracted", "refracted"), ("direct", "reflected"),
        ("reflected", "direct"), ("direct", "refracted"),
        ("refracted", "direct"), ("reflected", "refracted"),
        ("refracted", "reflected"),
    ]
    DNR_RAY_TYPES = [
        ("direct", "reflected"), ("reflected", "direct"),
        ("direct", "refracted"), ("refracted", "direct"),
        ("reflected", "refracted"), ("refracted", "reflected"),
    ]

    def __init__(self, ice, table_kwargs=None):
        """ice: IceModelSimple used to build travel-time tables on demand.

        table_kwargs: grid overrides for build_travel_time_table (use a
        coarser grid for quick scans)."""
        self._ice = ice
        self._table_kwargs = table_kwargs or {}
        self._tables = {}

    def begin(self, station_id, channel_ids, detector, passband=None,
              template=None):
        first = detector.get_relative_position(station_id, channel_ids[0])
        for cid in channel_ids:
            pos = detector.get_relative_position(station_id, cid)
            if (abs(pos[0] - first[0]) > 1 * units.m
                    or abs(pos[1] - first[1]) > 1 * units.m):
                raise ValueError("All channels have to be on the same string")
        self._det = detector
        self._station_id = station_id
        self._channel_ids = list(channel_ids)
        self._pairs = [(a, b) for i, a in enumerate(channel_ids)
                       for b in channel_ids[i + 1:]]
        self._passband = passband
        self._template = template
        for cid in channel_ids:
            z = detector.get_relative_position(station_id, cid)[2]
            key = round(float(z), 3)
            if key not in self._tables:
                self._tables[key] = build_travel_time_table(
                    self._ice, z, **self._table_kwargs)

    def _travel_time(self, cid, ray_type, d_hor, z):
        key = round(float(self._det.get_relative_position(
            self._station_id, cid)[2]), 3)
        header, table = self._tables[key]
        return lookup_travel_time(header, table, ray_type, d_hor, z)

    def _pair_correlation(self, ch1, ch2):
        """Windowed, normalized cross-correlation of a channel pair
        (run:160-197)."""
        spec1 = np.asarray(ch1.get_frequency_spectrum()).copy()
        spec2 = np.asarray(ch2.get_frequency_spectrum()).copy()
        if self._passband is not None:
            b, a = scisig.butter(10, self._passband, "bandpass", analog=True)
            _, h = scisig.freqs(b, a, np.asarray(ch1.get_frequencies()))
            spec1 *= h
            spec2 *= h
        fs = ch1.get_sampling_rate()
        trace1 = np.fft.irfft(spec1, axis=-1) * fs / np.sqrt(2.0)
        trace2 = np.fft.irfft(spec2, axis=-1) * fs / np.sqrt(2.0)
        corr_range = 50 * units.ns
        t1 = np.asarray(ch1.get_times())[:len(trace1)]
        t2 = np.asarray(ch2.get_times())[:len(trace2)]
        if np.max(np.abs(trace1)) > np.max(np.abs(trace2)):
            trace1[np.abs(t1 - t1[np.argmax(np.abs(trace1))]) > corr_range] = 0
        else:
            trace2[np.abs(t2 - t2[np.argmax(np.abs(trace2))]) > corr_range] = 0
        corr = np.abs(scisig.correlate(trace1, trace2))
        if np.sum(corr) > 0:
            corr = corr / np.sum(corr)
        return corr

    @register_run()
    def run(self, event, station, det=None, max_distance=3 * units.km,
            z_width=2 * units.km, grid_spacing=20 * units.m,
            direction_guess=None, use_dnr=False):
        distances = np.arange(50 * units.m, max_distance, grid_spacing)
        if direction_guess is None:
            heights = np.arange(-z_width, 0, grid_spacing)
        else:
            heights = np.arange(-z_width, z_width, grid_spacing)
        x0, z0 = np.meshgrid(distances, heights)
        if direction_guess is None:
            x_coords, z_coords = x0, z0
        else:
            ang = direction_guess - 90 * units.deg
            x_coords = np.cos(ang) * x0 + np.sin(ang) * z0
            z_coords = -np.sin(ang) * x0 + np.cos(ang) * z0

        corr_sum = np.zeros_like(x_coords)
        for pair in self._pairs:
            ch1 = station.get_channel(pair[0])
            ch2 = station.get_channel(pair[1])
            if (np.max(np.abs(np.asarray(ch1.get_trace()))) == 0
                    or np.max(np.abs(np.asarray(ch2.get_trace()))) == 0):
                continue
            corr = self._pair_correlation(ch1, ch2)
            corr_snr = (np.max(corr) / np.mean(corr[corr > 0])
                        if np.any(corr > 0) else 0.0)
            fs = ch1.get_sampling_rate()
            pos1 = self._det.get_relative_position(self._station_id, pair[0])
            pos2 = self._det.get_relative_position(self._station_id, pair[1])
            d1 = np.sqrt((x_coords - pos1[0]) ** 2 + pos1[1] ** 2)
            d2 = np.sqrt((x_coords - pos2[0]) ** 2 + pos2[1] ** 2)

            best = np.zeros_like(corr_sum)
            for rt1, rt2 in self.RAY_TYPES:
                t1 = self._travel_time(pair[0], rt1, d1, z_coords)
                t2 = self._travel_time(pair[1], rt2, d2, z_coords)
                delta_t = t1 - t2
                idx = corr.shape[0] / 2 + np.round(delta_t * fs)
                ok = np.isfinite(delta_t) & (idx > 0) & (idx < corr.shape[0])
                idx = np.where(ok, idx, 0).astype(int)
                res = np.where(ok, np.take(corr, idx), 0.0)
                best = np.maximum(best, res)
            if np.max(best) > 0:
                corr_sum += best / np.max(best) * corr_snr

        k = np.unravel_index(np.argmax(corr_sum), corr_sum.shape)
        station[stnp.vertex_2D_fit] = [x_coords[k], z_coords[k]]
        self.correlation_sum = corr_sum
        self.grid = (x_coords, z_coords)
        return x_coords[k], z_coords[k]

    def end(self):
        pass


class neutrino3DVertexReconstructor(neutrino2DVertexReconstructor):
    """Full 3D vertex search (neutrino3DVertexReconstructor.py:15-999).

    The reference runs a rough 2D (azimuth, distance, z) scan to pick a
    search line, then a fine scan around it; here the same pair/ray-type
    correlation stacking is evaluated on a Cartesian 3D grid with a
    coarse-to-fine zoom — channels may sit on different strings.
    """

    def begin(self, station_id, channel_ids, detector, passband=None,
              template=None):
        # no same-string restriction in 3D
        self._det = detector
        self._station_id = station_id
        self._channel_ids = list(channel_ids)
        self._pairs = [(a, b) for i, a in enumerate(channel_ids)
                       for b in channel_ids[i + 1:]]
        self._passband = passband
        self._template = template
        for cid in channel_ids:
            z = detector.get_relative_position(station_id, cid)[2]
            key = round(float(z), 3)
            if key not in self._tables:
                self._tables[key] = build_travel_time_table(
                    self._ice, z, **self._table_kwargs)

    def _stack(self, station, xx, yy, zz):
        """Correlation sum on arbitrary same-shape coordinate arrays."""
        corr_sum = np.zeros_like(xx)
        for pair in self._pairs:
            ch1 = station.get_channel(pair[0])
            ch2 = station.get_channel(pair[1])
            if (np.max(np.abs(np.asarray(ch1.get_trace()))) == 0
                    or np.max(np.abs(np.asarray(ch2.get_trace()))) == 0):
                continue
            corr = self._pair_correlation(ch1, ch2)
            corr_snr = (np.max(corr) / np.mean(corr[corr > 0])
                        if np.any(corr > 0) else 0.0)
            fs = ch1.get_sampling_rate()
            pos1 = self._det.get_relative_position(self._station_id, pair[0])
            pos2 = self._det.get_relative_position(self._station_id, pair[1])
            d1 = np.sqrt((xx - pos1[0]) ** 2 + (yy - pos1[1]) ** 2)
            d2 = np.sqrt((xx - pos2[0]) ** 2 + (yy - pos2[1]) ** 2)
            best = np.zeros_like(corr_sum)
            for rt1, rt2 in self.RAY_TYPES:
                t1 = self._travel_time(pair[0], rt1, d1, zz)
                t2 = self._travel_time(pair[1], rt2, d2, zz)
                delta_t = t1 - t2
                idx = corr.shape[0] / 2 + np.round(delta_t * fs)
                ok = np.isfinite(delta_t) & (idx > 0) & (idx < corr.shape[0])
                idx = np.where(ok, idx, 0).astype(int)
                best = np.maximum(best, np.where(ok, np.take(corr, idx), 0.0))
            if np.max(best) > 0:
                corr_sum += best / np.max(best) * corr_snr
        return corr_sum

    @register_run()
    def run(self, event, station, det=None, max_distance=3 * units.km,
            z_range=(-2.7 * units.km, -50 * units.m), coarse_steps=24,
            n_zoom=3, zoom_factor=4.0):
        lo = np.array([-max_distance, -max_distance, z_range[0]])
        hi = np.array([max_distance, max_distance, z_range[1]])
        center = 0.5 * (lo + hi)
        half = 0.5 * (hi - lo)
        for _ in range(n_zoom):
            axes = [np.linspace(center[d] - half[d], center[d] + half[d],
                                coarse_steps) for d in range(3)]
            XX, YY, ZZ = np.meshgrid(*axes, indexing="ij")
            corr = self._stack(station, XX, YY, ZZ)
            k = np.unravel_index(np.argmax(corr), corr.shape)
            center = np.array([XX[k], YY[k], ZZ[k]])
            half = half / zoom_factor
        station[stnp.nu_vertex] = center.copy()
        self.correlation_max = float(np.max(corr))
        return center

    def end(self):
        pass
