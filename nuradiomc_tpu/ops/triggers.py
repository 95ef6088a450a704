"""Trigger kernels (JAX, batched).

Masked batch re-implementations of the reference trigger modules:

* simple threshold (modules/trigger/simpleThreshold.py:14-31)
* high-low threshold with coincidence window + channel majority logic
  (modules/trigger/highLowThreshold.py:13-142)
* sliding-window power integration (modules/trigger/powerIntegration.py)

The reference uses numpy stride tricks to build [frame, window] views; here
windowed any/all reductions are expressed as difference-of-cumulative
("sliding or") operations that XLA fuses into a couple of scans — no gather
materialization. All functions operate on the last (time) axis and broadcast
over arbitrary leading batch axes.
"""

from __future__ import annotations

import jax.numpy as jnp


def _shift_right_zero(x, s: int):
    """x shifted right by s along the last axis, zero-filled."""
    return jnp.pad(x[..., :-s], [(0, 0)] * (x.ndim - 1) + [(s, 0)])


def _sliding_window_any(x_bool, window: int):
    """out[i] = any(x[i-window+1 .. i]) — zero-padded at the start.

    Matches the reference's stride-trick framing with left zero padding
    (highLowThreshold.py:52-56), so a trigger bin aligns with the last sample
    of the coincidence window.

    Implemented as log2(window) boolean shift-ORs (each pass touches 1-byte
    bools) instead of an int32 cumsum: these windowed reductions are
    memory-bandwidth bound.
    """
    out = x_bool
    covered = 1
    while covered < window:
        s = min(covered, window - covered)
        out = out | _shift_right_zero(out, s)
        covered += s
    return out


def get_threshold_triggers(trace, threshold):
    """|V| >= threshold per sample (simpleThreshold.get_threshold_triggers:14-31)."""
    return jnp.abs(trace) >= threshold


def get_high_low_triggers(trace, high_threshold, low_threshold,
                          time_coincidence, dt):
    """Bins where a high and a low crossing occur within the coincidence window
    (highLowThreshold.get_high_low_triggers:13-79, step=1 path)."""
    n_bins = max(int(round(time_coincidence / dt)), 1)
    hi = _sliding_window_any(trace >= high_threshold, n_bins)
    lo = _sliding_window_any(trace <= low_threshold, n_bins)
    return hi & lo


def majority_logic(tts, number_of_coincidences: int, time_coincidence, dt):
    """Station-level majority trigger (highLowThreshold.get_majority_logic:82-142).

    Parameters
    ----------
    tts : bool array [..., n_channels, n_samples]
        Per-channel single-channel trigger bins.

    Returns
    -------
    triggered : bool [...]
    triggered_bins : bool [..., n_samples] — bins fulfilling the coincidence
    trigger_time_idx : int [...] — first triggered bin (0 if not triggered)
    """
    n_samples = tts.shape[-1]
    n_bins = min(max(int(round(time_coincidence / dt)), 1), n_samples)
    widened = _sliding_window_any(tts, n_bins)
    count = jnp.sum(widened, axis=-2)
    ttt = count >= number_of_coincidences
    triggered = jnp.any(ttt, axis=-1)
    first = jnp.argmax(ttt, axis=-1)
    return triggered, ttt, first


def get_envelope_triggers(trace, threshold):
    """Hilbert-envelope threshold trigger (envelopeTrigger.py:14-31)."""
    from nuradiomc_tpu.ops.trace import hilbert_envelope

    return hilbert_envelope(trace) > threshold


def get_multiple_high_low_triggers(trace, high_threshold, low_threshold,
                                   n_high_lows: int, time_coincidence, dt):
    """n high/low crossings within a window (multiHighLowThreshold.py:24-58).

    The reference counts crossing bins with a boxcar convolution and marks
    the rising edge of the >= n condition; here the boxcar is a
    difference-of-cumsum (XLA-fusable) with identical semantics.
    """
    nc = max(int(time_coincidence / dt), 1)

    def rising_edge(mask):
        prev = jnp.pad(mask[..., :-1], [(0, 0)] * (mask.ndim - 1) + [(1, 0)])
        return mask & ~prev

    # crossings = rising edges of the high/low conditions (strict
    # inequalities; multiHighLowThreshold.get_high_triggers:12-21)
    crossings = (rising_edge(trace > high_threshold).astype(jnp.int32)
                 + rising_edge(trace < low_threshold).astype(jnp.int32))
    c = jnp.cumsum(crossings, axis=-1)
    # 'full' convolution with ones(nc), truncated to the trace length:
    # out[i] = sum of crossings[max(0, i-nc+1) .. i]
    shifted = jnp.pad(c[..., :-nc], [(0, 0)] * (c.ndim - 1) + [(nc, 0)])
    tsum = c - shifted
    cond = tsum >= n_high_lows
    # rising edge (convolve with [1, -1], 'same')
    prev = jnp.pad(cond[..., :-1], [(0, 0)] * (cond.ndim - 1) + [(1, 0)])
    return cond & ~prev


# AraSim tunnel-diode response parameters (utilities/diodeSimulator.py:38-45)
_TD_DOWN1 = (-0.8, 15.0, 2.3)      # (amp, mu [ns], sigma [ns])
_TD_DOWN2 = (-0.2, 15.0, 4.0)
_TD_UP_MU, _TD_UP_SIGMA, _TD_UP_SCALE = 18.0, 7.0, 1.0  # scale 1e9/s = 1/ns


def tunnel_diode_response(times):
    """Dimensionless AraSim diode impulse response on a time grid (ns)."""
    up_amp = (-jnp.sqrt(2 * jnp.pi)
              * (_TD_DOWN1[0] * _TD_DOWN1[2] + _TD_DOWN2[0] * _TD_DOWN2[2])
              / (2.0 * _TD_UP_SIGMA ** 3))
    down1 = _TD_DOWN1[0] * jnp.exp(-(times - _TD_DOWN1[1]) ** 2 / (2 * _TD_DOWN1[2] ** 2))
    down2 = _TD_DOWN2[0] * jnp.exp(-(times - _TD_DOWN2[1]) ** 2 / (2 * _TD_DOWN2[2] ** 2))
    up = up_amp * (times - _TD_UP_MU) ** 2 * jnp.exp(-(times - _TD_UP_MU) / _TD_UP_SIGMA)
    return down1 + down2 + jnp.where(times > _TD_UP_MU, up, 0.0)


def tunnel_diode(trace, sampling_rate, antenna_resistance=8.5 * 1.602176462e-10):
    """Power trace after the AraSim tunnel diode (diodeSimulator.tunnel_diode
    :59-96): convolve V^2/R with the 3-term diode impulse response.
    The default resistance is 8.5 ohm in internal units (diodeSimulator.py:83)."""
    n = trace.shape[-1]
    # the reference evaluates the response on a 100 ns grid (t_max = 1e-7 s,
    # diodeSimulator.py:82-85)
    n_resp = int(100.0 * sampling_rate) + 1
    times = jnp.linspace(0.0, 100.0, n_resp)
    diode = tunnel_diode_response(times)
    power = trace * trace / antenna_resistance
    # 'full' convolution truncated to n samples, via FFT (batched)
    m = n + n_resp
    P = jnp.fft.rfft(power, n=m, axis=-1)
    D = jnp.fft.rfft(diode, n=m)
    conv = jnp.fft.irfft(P * D, n=m, axis=-1)[..., :n]
    return conv / sampling_rate


def ara_diode_trigger(trace, sampling_rate, power_mean, power_std, threshold_sigma):
    """ARA tunnel-diode trigger bins: diode output below
    mean - |threshold| * std (ARA/triggerSimulator.py:26-60)."""
    out = tunnel_diode(trace, sampling_rate)
    return out < (power_mean - power_std * jnp.abs(threshold_sigma))


def power_integration_triggers(trace, window, threshold, dt):
    """Sliding-window power sum above threshold (powerIntegration.py semantics).

    int V^2 dt over ``window`` > threshold.
    """
    n_bins = max(int(round(window / dt)), 1)
    p = trace * trace
    c = jnp.cumsum(p, axis=-1)
    shifted = jnp.pad(c[..., :-n_bins], [(0, 0)] * (c.ndim - 1) + [(n_bins, 0)])
    power = (c - shifted) * dt
    return power > threshold
