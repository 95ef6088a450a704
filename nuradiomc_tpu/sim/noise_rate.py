"""Noise-trigger-rate estimation and threshold tuning (device-batched).

Replaces the reference thermal-noise trigger-rate generators
(NuRadioReco/utilities/noise.py:278-560, thermalNoiseGeneratorPhasedArray):
thresholds for a target noise-trigger rate (e.g. the 100 Hz point of the
4-channel deep phased array) are obtained from the distribution of the
maximum windowed beam power over pure-noise traces. Where the reference
generates noise traces one by one in numpy, here millions of noise windows
run as one batched device computation — the distribution tail (1 Hz rates
need ~1e7 trace-seconds) is reachable in one batched run.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from nuradiomc_tpu.ops import adc as adc_ops
from nuradiomc_tpu.ops import noise as noise_ops
from nuradiomc_tpu.ops import phased_array
from nuradiomc_tpu.ops import trace as trace_ops
from nuradiomc_tpu.utils import fft


def max_beam_power_batch(key, n_batch: int, n_samples: int, sampling_rate: float,
                         amplitude: float, filter_response: jnp.ndarray,
                         rolls: np.ndarray, n_channels: int,
                         window: int, step: int,
                         adc_fs: float = None, adc_nbits: int = 8,
                         adc_range: float = 0.0, upsampling: int = 2,
                         dtype=jnp.float32):
    """Maximum sliding-window beam power of ``n_batch`` pure-noise traces.

    Mirrors the simulation trigger chain: white rayleigh noise at the internal
    rate x filter -> (optional ADC digitization) -> FFT upsampling ->
    beamforming -> power sums.
    """
    keys = jax.random.split(key, n_batch * n_channels).reshape(n_batch, n_channels, 2)

    def one_channel(k):
        spec = noise_ops.bandlimited_noise_spectrum(
            k, n_samples, sampling_rate, amplitude, None, sampling_rate / 2,
            "rayleigh", dtype)
        spec = spec * filter_response
        return fft.freq2time(spec, sampling_rate, n=n_samples)

    traces = jax.vmap(jax.vmap(one_channel))(keys)       # [B, C, N]

    fs = sampling_rate
    n = n_samples
    if adc_fs is not None:
        fs_hi = 5.0
        n_hi = int(round(n * fs_hi / fs))
        decim = int(round(fs_hi / adc_fs))
        spec_hi = trace_ops.resample_spectrum(fft.time2freq(traces, fs), n, n_hi)
        traces = fft.freq2time(spec_hi, fs_hi, n=n_hi)[..., ::decim]
        fs = adc_fs
        n = traces.shape[-1]
        traces = adc_ops.perfect_floor_comparator(
            traces, adc_nbits, (-adc_range / 2, adc_range / 2))
    if upsampling > 1:
        spec = trace_ops.resample_spectrum(fft.time2freq(traces, fs), n, n * upsampling)
        fs = fs * upsampling
        n = n * upsampling
        traces = fft.freq2time(spec, fs, n=n)

    beams = phased_array.phase_signals(traces, rolls)     # [B, n_beams, n]
    power, _ = phased_array.power_sum(beams, window, step)
    return jnp.max(power, axis=(-2, -1))                  # [B]


def estimate_rate_curve(thresholds, max_powers: np.ndarray, trace_duration: float):
    """Noise-trigger rate vs threshold from max-power samples.

    rate(T) ~= P(max power over one trace > T) / trace_duration (valid for
    rates << 1/duration, the tuning regime).
    """
    max_powers = np.sort(np.asarray(max_powers))
    frac = 1.0 - np.searchsorted(max_powers, thresholds) / len(max_powers)
    return frac / trace_duration


def tune_threshold(target_rate: float, max_powers: np.ndarray,
                   trace_duration: float) -> float:
    """Threshold whose noise-trigger rate equals ``target_rate``
    (quantile of the max-power distribution)."""
    p_per_trace = target_rate * trace_duration
    q = np.clip(1.0 - p_per_trace, 0.0, 1.0)
    return float(np.quantile(np.asarray(max_powers), q))


def run_phased_array_tuning(n_traces: int, n_samples: int, sampling_rate: float,
                            amplitude: float, filter_response, rolls,
                            n_channels: int, window: int, step: int,
                            seed: int = 0, batch: int = 4096, **kwargs):
    """Collect max-power samples over ``n_traces`` noise traces (chunked)."""
    filter_response = jnp.asarray(filter_response)
    fn = jax.jit(functools.partial(
        max_beam_power_batch, n_batch=batch, n_samples=n_samples,
        sampling_rate=sampling_rate, amplitude=amplitude,
        filter_response=filter_response, rolls=rolls, n_channels=n_channels,
        window=window, step=step, **kwargs))
    out = []
    key = jax.random.PRNGKey(seed)
    for _ in range(int(np.ceil(n_traces / batch))):
        key, sub = jax.random.split(key)
        out.append(np.asarray(fn(sub)))
    return np.concatenate(out)[:n_traces]
