#!/usr/bin/env python3
"""Aliased (higher-Nyquist-zone) phased-array SNR study.

Counterpart of NuRadioReco/examples/AliasPhasedArray/SNR_study/
T02SNRNyquist.py (stale upstream — its trigger arguments no longer exist
and the reference CI has it commented out, test_examples.sh:26-29; this
version actually runs): a trigger ADC undersamples the RF band, so a band
placed in the z-th Nyquist zone of the ADC folds down ("aliases") into
the first zone — the beamformed power trigger still works on the aliased
band. The study measures trigger efficiency vs SNR per Nyquist zone, with
the per-zone power threshold self-calibrated to a fixed noise rate
(the role of the reference's hard-coded thresholds table,
T02SNRNyquist.py:86-99).

Chain per zone z (T02SNRNyquist semantics):
  analog band 132-700 MHz (butter 8/10) -> zone filter
  [(z-1) fs_adc/2 + edge, z fs_adc/2 - edge], edge = 20 MHz ->
  undersample to fs_adc (integer stride of the 5 GHz grid = the
  reference's linear-interp downsampling at commensurate rates) ->
  FFT upsample x4 -> 30 beams in +-50 deg sin-space -> power integration.

Batch-first: each zone's whole (SNR ladder x trials x beams) study is ONE
jitted batch; the undersampling is a static stride and the zone filter a
precomputed rFFT mask, so everything fuses.

Run: python run_alias_snr.py [n_trials]
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import jax
import jax.numpy as jnp
import numpy as np

from nuradiomc_tpu.ops import askaryan, filters, noise as noise_ops, \
    phased_array
from nuradiomc_tpu.utils import fft, units

N_TRIALS = int(sys.argv[1]) if len(sys.argv) > 1 else 120
N_SNR = 16
SNRS = np.linspace(0.5, 6.0, N_SNR)

fs_hi = 5.0                    # internal rate, GHz (reference upsamples to 5)
n_hi = 4096
fs_adc = 0.5                   # trigger-ADC rate
upsampling = 4
bandwidth_edge = 20 * units.MHz
low_freq, high_freq = 132 * units.MHz, 700 * units.MHz
n_channels = 4
ant_z = -100.0 - np.arange(n_channels)
decim = int(round(fs_hi / fs_adc))

# signal: 1e18 eV hadronic shower 1 deg off-cone, as in 07_snr_curves
n_index = 1.75
trace = np.asarray(askaryan.get_time_trace(
    1e18, np.arccos(1.0 / n_index) + np.deg2rad(1.0), n_hi, 1.0 / fs_hi,
    is_em=False, n_index=n_index, R=1000.0, model="Alvarez2000"))

ff = np.fft.rfftfreq(n_hi, 1.0 / fs_hi)
analog = filters.get_filter_response(
    ff, (low_freq, 1150 * units.MHz), "butter", order=8) \
    * filters.get_filter_response(ff, (0, high_freq), "butter", order=10)
sig = np.asarray(fft.freq2time(
    fft.time2freq(jnp.asarray(trace), fs_hi) * analog, fs_hi, n=n_hi))
signal = np.tile(sig, (n_channels, 1))

Vrms = 10 * units.mV
base_factor = Vrms / (0.5 * (sig.max() - sig.min()))   # scales to SNR = 1

# generation amplitude so the POST-analog-chain RMS equals Vrms (the e2e
# noise normalization convention)
band_power = np.trapezoid(np.abs(analog) ** 2, ff) / (fs_hi / 2)
noise_gen_amp = Vrms / np.sqrt(band_power)

rolls = phased_array.beam_rolls(
    ant_z, np.zeros(n_channels),
    np.arcsin(np.linspace(np.sin(np.deg2rad(-50.0)),
                          np.sin(np.deg2rad(50.0)), 30)),
    n_index, fs_adc * upsampling)

window = int(16 * units.ns * fs_adc * upsampling)
step = int(8 * units.ns * fs_adc * upsampling)


def _max_beam_power(tr, mask):
    """analog trace [C, n_hi] -> zone filter -> undersample -> upsample x4
    -> beams -> max windowed power."""
    spec = jnp.fft.rfft(tr) * mask
    tr_z = jnp.fft.irfft(spec, n=n_hi)[..., ::decim]
    n_adc = tr_z.shape[-1]
    tr_up = jnp.fft.irfft(jnp.fft.rfft(tr_z),
                          n=n_adc * upsampling) * upsampling
    beams = phased_array.phase_signals(tr_up, rolls)
    power, _ = phased_array.power_sum(beams, window, step)
    return jnp.max(power)


def _noise(k):
    """White pre-chain noise [C, n_hi]; the analog chain is applied inside
    the zone mask (the reference filters again after noise addition, so
    signal passes the chain twice and noise once — same here)."""
    keys = jax.random.split(k, n_channels)
    return jax.vmap(lambda kk: noise_ops.bandlimited_noise_trace(
        kk, n_hi, fs_hi, noise_gen_amp, None, None,
        type="rayleigh", dtype=jnp.float64))(keys)


def run_zone(z, key):
    lo = (z - 1) * fs_adc / 2 + bandwidth_edge
    hi = z * fs_adc / 2 - bandwidth_edge
    mask = jnp.asarray(((ff >= lo) & (ff <= hi)) * analog)

    @jax.jit
    def study(key):
        def one_trial(k):
            noise = _noise(k)

            def one_snr(s):
                return _max_beam_power(signal * (s * base_factor) + noise,
                                       mask)

            return jax.vmap(one_snr)(jnp.asarray(SNRS))

        return jax.vmap(one_trial)(jax.random.split(key, N_TRIALS))

    @jax.jit
    def noise_stat(key):
        return jax.vmap(lambda k: _max_beam_power(_noise(k), mask))(
            jax.random.split(key, 256))

    max_power = np.asarray(study(key))                    # [T, N_SNR]
    noise_powers = np.asarray(noise_stat(jax.random.fold_in(key, 999)))
    threshold = np.quantile(noise_powers, 0.999)
    eff = (max_power > threshold).mean(axis=0)
    return eff, threshold


key = jax.random.PRNGKey(42)
results = {}
for z in (1, 2, 3):
    eff, thr = run_zone(z, jax.random.fold_in(key, z))
    results[z] = eff
    snr50 = np.interp(0.5, eff, SNRS) if eff.max() >= 0.5 else np.inf
    print(f"Nyquist zone {z}: threshold={thr:.3g} V^2, "
          f"eff@SNR6={eff[-1]:.2f}, SNR50={snr50:.2f}")
    print("  eff:", np.round(eff, 2))

np.savez("alias_snr.npz",
         snrs=SNRS, **{f"zone_{z}": results[z] for z in results})
print("alias phased-array study done")
