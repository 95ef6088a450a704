"""Module-level trigger simulators (framework-object API).

Host-side per-event wrappers mirroring the reference trigger modules'
``run(evt, station, det, ...)`` surface and exact bin semantics:

* simpleThreshold          (modules/trigger/simpleThreshold.py:14-160)
* highLowThreshold         (modules/trigger/highLowThreshold.py:13-340)
* multiHighLowThreshold    (modules/trigger/multiHighLowThreshold.py:10-160)
* BeamformedPowerIntegrationTrigger
  (modules/phasedarray/{phasedArrayBase,beamformedPowerIntegrationTrigger}.py)
* analogToDigitalConverter.get_digital_trace equivalent
  (modules/analogToDigitalConverter.py:173-372)

The batched production path lives in sim/pipeline.py (ops/triggers.py,
ops/phased_array.py kernels); these wrappers serve the object-level module
chain (event files, reconstruction studies, the reference's trigger_tests).
"""

from __future__ import annotations

import numpy as np

from nuradiomc_tpu.framework import parameters as par
from nuradiomc_tpu.framework.event import Trigger
from nuradiomc_tpu.reco.base import register_run
from nuradiomc_tpu.utils import units

stnp = par.stationParameters


# ---------------------------------------------------------------------------
# bin-exact helpers (reference module semantics, numpy)
# ---------------------------------------------------------------------------

def get_threshold_triggers(trace, threshold):
    """|V| >= threshold per bin (simpleThreshold.py:14-31)."""
    return np.abs(trace) >= threshold


def _windowed_any(mask, n_bins):
    """any() over the trailing n_bins window ending at each bin, evaluated on
    the front-padded trace like the reference's as_strided frames
    (highLowThreshold.get_high_low_triggers:50-80): output has
    len(mask) - 1 frames."""
    conv = np.convolve(mask.astype(np.int32), np.ones(n_bins, dtype=np.int32),
                       mode="full")[:len(mask)] > 0
    return conv[:len(mask) - 1]


def get_high_low_triggers(trace, high_threshold, low_threshold,
                          time_coincidence=5 * units.ns, dt=1 * units.ns):
    """High+low crossing inside a coincidence window
    (highLowThreshold.py:13-80; >= / <= comparisons, front-padded frames)."""
    n_bins = int(np.round(time_coincidence / dt))
    high = _windowed_any(np.asarray(trace) >= high_threshold, n_bins)
    low = _windowed_any(np.asarray(trace) <= low_threshold, n_bins)
    return high & low


def get_majority_logic(tts, number_of_coincidences=2,
                       time_coincidence=32 * units.ns, dt=1 * units.ns):
    """Cross-channel majority coincidence
    (highLowThreshold.get_majority_logic:83-143).

    Returns (has_triggered, triggered_bins, triggered_times)."""
    n_bins = int(np.round(time_coincidence / dt))
    n = len(tts[0])
    n_bins = min(n_bins, n)
    windowed = [_windowed_any(np.asarray(t), n_bins) for t in tts]
    ttt = np.sum(windowed, axis=0) >= number_of_coincidences
    triggered_bins = np.atleast_1d(np.squeeze(np.argwhere(ttt)))
    return bool(np.any(ttt)), triggered_bins, triggered_bins * dt


def get_high_triggers(trace, threshold):
    """Rising-edge crossings above threshold (multiHighLowThreshold.py:10-16,
    strict >)."""
    m1 = np.asarray(trace) > threshold
    return np.convolve(m1, np.array([1, -1]), mode="full")[:len(m1)] > 0


def get_low_triggers(trace, threshold):
    m1 = np.asarray(trace) < threshold
    return np.convolve(m1, np.array([1, -1]), mode="full")[:len(m1)] > 0


def get_multiple_high_low_trigger(trace, high_threshold, low_threshold,
                                  n_high_lows, time_coincidence=10 * units.ns,
                                  dt=1 * units.ns):
    """n edge crossings inside a coincidence window
    (multiHighLowThreshold.py:24-56)."""
    trig_up = get_high_triggers(trace, high_threshold)
    trig_low = get_low_triggers(trace, low_threshold)
    nc = int(time_coincidence / dt)
    c1 = np.ones(nc)
    tsum_high = np.convolve(trig_up, c1, mode="full")[:-(nc - 1)]
    tsum_low = np.convolve(trig_low, c1, mode="full")[:-(nc - 1)]
    tsumtot = np.convolve((tsum_high + tsum_low) >= n_high_lows,
                          np.array([1, -1]), mode="same")
    return tsumtot > 0


def _threshold_of(threshold, channel_id):
    return threshold[channel_id] if isinstance(threshold, dict) else threshold


def _finish_trigger(station, trigger, has_triggered, triggered_times,
                    channel_trace_start_time, channels_that_passed):
    trigger._triggered_channels = list(channels_that_passed)
    if has_triggered:
        trigger.set_triggered(True)
        trigger.set_trigger_time(float(np.min(triggered_times))
                                 + channel_trace_start_time)
        trigger.set_trigger_times(np.asarray(triggered_times)
                                  + channel_trace_start_time)
    else:
        trigger.set_triggered(False)
    station.set_trigger(trigger)
    return has_triggered


def _iter_trigger_channels(station, triggered_channels):
    for channel in station.iter_channels():
        if triggered_channels is not None and \
                channel.get_id() not in triggered_channels:
            continue
        yield channel


class simpleThreshold:
    """Namespace parity: reference module path
    `modules.trigger.simpleThreshold.triggerSimulator`."""


class triggerSimulatorSimple:
    """Amplitude threshold + channel majority (simpleThreshold.py:34-160)."""

    def begin(self):
        pass

    @register_run()
    def run(self, evt, station, det, threshold=60 * units.mV,
            number_concidences=1, triggered_channels=None,
            coinc_window=200 * units.ns,
            trigger_name="default_simple_threshold"):
        channels = list(_iter_trigger_channels(station, triggered_channels))
        channel_trace_start_time = channels[0].get_trace_start_time()
        dt = 1.0 / channels[0].get_sampling_rate()

        tts = []
        passed = []
        for channel in channels:
            bins = get_threshold_triggers(
                channel.get_trace(), _threshold_of(threshold, channel.get_id()))
            tts.append(bins)
            if np.any(bins):
                passed.append(channel.get_id())

        has_triggered, triggered_bins, triggered_times = get_majority_logic(
            tts, number_concidences, coinc_window, dt)
        if has_triggered:
            max_signal = max(np.abs(np.asarray(ch.get_trace())[triggered_bins]).max()
                             for ch in channels)
            station[stnp.channels_max_amplitude] = max_signal

        trigger = Trigger(trigger_name, triggered_channels, "simple_threshold")
        trigger._threshold = threshold
        return _finish_trigger(station, trigger, has_triggered, triggered_times,
                               channel_trace_start_time, passed)


class triggerSimulatorHighLow:
    """ARIANNA high/low + majority (highLowThreshold.py:145-340)."""

    def begin(self):
        pass

    @register_run()
    def run(self, evt, station, det, threshold_high=60 * units.mV,
            threshold_low=-60 * units.mV, high_low_window=5 * units.ns,
            coinc_window=200 * units.ns, number_concidences=2,
            triggered_channels=None, trigger_name="default_high_low",
            set_not_triggered=False):
        passed = []
        has_triggered = False
        triggered_times = np.array([])
        channel_trace_start_time = 0.0
        if not set_not_triggered:
            channels = list(_iter_trigger_channels(station, triggered_channels))
            channel_trace_start_time = channels[0].get_trace_start_time()
            tts = []
            dt = 1.0 / channels[0].get_sampling_rate()
            for channel in channels:
                cid = channel.get_id()
                bins = get_high_low_triggers(
                    np.asarray(channel.get_trace()),
                    _threshold_of(threshold_high, cid),
                    _threshold_of(threshold_low, cid),
                    high_low_window, 1.0 / channel.get_sampling_rate())
                if np.any(bins):
                    passed.append(cid)
                tts.append(bins)
            if tts:
                has_triggered, triggered_bins, triggered_times = \
                    get_majority_logic(tts, number_concidences, coinc_window, dt)
                if has_triggered:
                    max_signal = max(
                        np.abs(np.asarray(ch.get_trace())[triggered_bins]).max()
                        for ch in channels)
                    station[stnp.channels_max_amplitude] = max_signal

        trigger = Trigger(trigger_name, triggered_channels, "high_low")
        trigger._threshold_high = threshold_high
        trigger._threshold_low = threshold_low
        return _finish_trigger(station, trigger, has_triggered, triggered_times,
                               channel_trace_start_time, passed)


class triggerSimulatorMultiHighLow:
    """n high/low crossings per window + majority
    (multiHighLowThreshold.py:60-160)."""

    def begin(self):
        pass

    @register_run()
    def run(self, evt, station, det, threshold_high=60 * units.mV,
            threshold_low=-60 * units.mV, high_low_window=5 * units.ns,
            n_high_lows=5, coinc_window=200 * units.ns, number_concidences=2,
            triggered_channels=None, trigger_name="default_high_low",
            set_not_triggered=False):
        passed = []
        has_triggered = False
        triggered_times = np.array([])
        channel_trace_start_time = 0.0
        if not set_not_triggered:
            channels = list(_iter_trigger_channels(station, triggered_channels))
            channel_trace_start_time = channels[0].get_trace_start_time()
            dt = 1.0 / channels[0].get_sampling_rate()
            tts = []
            for channel in channels:
                cid = channel.get_id()
                bins = get_multiple_high_low_trigger(
                    np.asarray(channel.get_trace()),
                    _threshold_of(threshold_high, cid),
                    _threshold_of(threshold_low, cid),
                    n_high_lows, high_low_window,
                    1.0 / channel.get_sampling_rate())
                if np.any(bins):
                    passed.append(cid)
                tts.append(bins)
            if tts:
                has_triggered, triggered_bins, triggered_times = \
                    get_majority_logic(tts, number_concidences, coinc_window, dt)

        trigger = Trigger(trigger_name, triggered_channels, "multi_high_low")
        trigger._threshold_high = threshold_high
        trigger._threshold_low = threshold_low
        trigger._n_high_lows = n_high_lows
        return _finish_trigger(station, trigger, has_triggered, triggered_times,
                               channel_trace_start_time, passed)


# ---------------------------------------------------------------------------
# ADC + phased array module chain
# ---------------------------------------------------------------------------

def downsampling_linear_interpolation(trace, fs_in, fs_out):
    """Linear-interpolation downsampling keeping aliasing
    (analogToDigitalConverter.downsampling_linear_interpolation)."""
    n_out = int(len(trace) * fs_out / fs_in)
    t_out = np.arange(n_out) / fs_out
    t_in = np.arange(len(trace)) / fs_in
    return np.interp(t_out, t_in, trace)


def get_digital_trace(station, det, channel, Vrms=None, trigger_adc=False,
                      adc_output="voltage", return_sampling_frequency=False):
    """Digitize one channel like the reference ADC module
    (analogToDigitalConverter.get_digital_trace:254-372 with the
    Vrms+adc_noise_count voltage-range convention :216-241)."""
    from nuradiomc_tpu.ops import adc as adc_ops

    det_channel = det.get_channel(station.get_id(), channel.get_id())
    prefix = "trigger_" if trigger_adc else ""
    adc_n_bits = int(det_channel[prefix + "adc_nbits"])
    adc_fs = float(det_channel[prefix + "adc_sampling_frequency"]) * units.GHz
    if Vrms is not None:
        noise_count = det_channel[prefix + "adc_noise_count"]
        vrange = Vrms * (2 ** adc_n_bits - 1) / noise_count
        adc_range = (-vrange / 2, vrange / 2)
    else:
        adc_range = (float(det_channel[prefix + "adc_min_voltage"]),
                     float(det_channel[prefix + "adc_max_voltage"]))

    fs = channel.get_sampling_rate()
    if not np.allclose(adc_fs, fs):
        # upsample to 5 GHz (Fourier), then linear-interp downsample to keep
        # higher-Nyquist-zone content (aliasing) like the reference
        work = channel
        if 5.0 * units.GHz > fs:
            import copy

            work = copy.deepcopy(channel)
            work.resample(5.0 * units.GHz)
        trace = downsampling_linear_interpolation(
            np.asarray(work.get_trace()), work.get_sampling_rate(), adc_fs)
    else:
        trace = np.asarray(channel.get_trace())

    digital = np.asarray(adc_ops.perfect_floor_comparator(
        trace, adc_n_bits, adc_range, output=adc_output))
    if len(digital) % 2 == 1:
        digital = digital[:-1]
    if return_sampling_frequency:
        return digital, adc_fs
    return digital


_DEFAULT_ANGLES = np.arcsin(np.linspace(
    np.sin(np.deg2rad(-59.54968597864437)),
    np.sin(np.deg2rad(59.54968597864437)), 11))


class BeamformedPowerIntegrationTrigger:
    """Phased-array power-integration trigger, module level
    (phasedArrayBase.phased_trigger:370-540 +
    beamformedPowerIntegrationTrigger.run:21-190)."""

    def begin(self, pre_trigger_time=100 * units.ns):
        self._pre_trigger_time = pre_trigger_time

    @register_run()
    def run(self, evt, station, det, Vrms=None, threshold=60 * units.mV,
            triggered_channels=None, trigger_name="simple_phased_threshold",
            phasing_angles=_DEFAULT_ANGLES, set_not_triggered=False,
            ref_index=1.75, trigger_adc=False, adc_output="voltage",
            upsampling_factor=1, window=32, step=16,
            apply_digitization=True):
        from nuradiomc_tpu.ops import phased_array as pa_ops
        from nuradiomc_tpu.ops import trace as trace_ops
        from nuradiomc_tpu.utils import fft as fft_utils

        if set_not_triggered:
            trigger = Trigger(trigger_name, triggered_channels, "simple_phased")
            trigger.set_triggered(False)
            station.set_trigger(trigger)
            return False

        channels = list(_iter_trigger_channels(station, triggered_channels))
        channel_ids = [c.get_id() for c in channels]
        channel_trace_start_time = channels[0].get_trace_start_time()

        traces = []
        fs_adc = channels[0].get_sampling_rate()
        for channel in channels:
            if apply_digitization:
                tr, fs_adc = get_digital_trace(
                    station, det, channel, Vrms=Vrms, trigger_adc=trigger_adc,
                    adc_output=adc_output, return_sampling_frequency=True)
            else:
                tr = np.asarray(channel.get_trace())
                fs_adc = channel.get_sampling_rate()
            if upsampling_factor >= 2:
                n = len(tr)
                spec = np.asarray(fft_utils.time2freq(tr, fs_adc))
                spec_up = np.asarray(trace_ops.resample_spectrum(
                    spec, n, n * int(upsampling_factor)))
                tr = np.asarray(fft_utils.freq2time(
                    spec_up, fs_adc * upsampling_factor,
                    n=n * int(upsampling_factor)))
                fs_adc = fs_adc * upsampling_factor
            traces.append(tr)
        n_min = min(len(t) for t in traces)
        traces = np.array([t[:n_min] for t in traces])

        ant_z = [det.get_relative_position(station.get_id(), cid)[2]
                 for cid in channel_ids]
        cable_delays = [det.get_cable_delay(station.get_id(), cid)
                        for cid in channel_ids]
        rolls = pa_ops.beam_rolls(np.asarray(ant_z), np.asarray(cable_delays),
                                  np.asarray(phasing_angles), ref_index, fs_adc)

        is_triggered, max_amps, frames_above = _phased_power_host(
            traces, np.asarray(rolls, dtype=int), threshold, window, step)

        trigger = Trigger(trigger_name, triggered_channels, "simple_phased")
        trigger._primary_angles = np.asarray(phasing_angles)
        trigger._maximum_amps = max_amps
        if is_triggered:
            trigger.set_triggered(True)
            # the reference offsets by abs(min(channel ids)) — replicated
            # verbatim for conformance (phasedArrayBase.py:524)
            offset = abs(min(channel_ids))
            tt = offset + frames_above * step / fs_adc + channel_trace_start_time
            trigger.set_trigger_time(tt.min())
            trigger.set_trigger_times(tt)
        else:
            trigger.set_triggered(False)
            trigger.set_trigger_time(None)
        station.set_trigger(trigger)
        return bool(is_triggered)


def _phased_power_host(traces, rolls, threshold, window, step):
    """Beamform + sliding power sums (phasedArrayBase.power_sum:217-270:
    squared coherent sum, num_frames = floor((n - window)/step), divide by
    the window)."""
    n_beams = rolls.shape[0]
    n = traces.shape[-1]
    max_amps = np.zeros(n_beams)
    frames = []
    for b in range(n_beams):
        coh = np.zeros(n)
        for ci in range(traces.shape[0]):
            coh += np.roll(traces[ci], int(rolls[b, ci]))
        sq = coh ** 2
        num_frames = int(np.floor((n - window) / step))
        idx = np.arange(num_frames)[:, None] * step + np.arange(window)[None, :]
        power = sq[idx].sum(axis=1) / window
        max_amps[b] = power.max()
        above = np.where(power > threshold)[0]
        if len(above):
            frames.append(above)
    if frames:
        all_frames = np.unique(np.concatenate(frames))
        return True, max_amps, all_frames
    return False, max_amps, np.array([], dtype=int)
