#!/usr/bin/env python3
"""Phased-array trigger-efficiency (SNR) curves.

Mirrors the reference study NuRadioReco/examples/PhasedArray/SNR_curves/
T02RunSNR.py: a Cherenkov-cone Askaryan signal is rescaled to a ladder of
SNR values, thermal noise is superimposed, and the 4-channel deep phased
array is run on each realization; the trigger fraction vs SNR is the SNR
curve (SNR = Vpp / (2 Vrms), as in the reference).

Batch-first design: the whole study — n_snr x n_trials noise realizations x
11 beams — is ONE vmapped jitted batch, instead of the reference's
per-event per-SNR Python loop.

Run: python run_snr_curves.py [n_trials]
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np
import jax
import jax.numpy as jnp

from nuradiomc_tpu.ops import askaryan, filters, noise as noise_ops, phased_array
from nuradiomc_tpu.utils import fft, units

N_TRIALS = int(sys.argv[1]) if len(sys.argv) > 1 else 200
N_SNR = 20
SNRS = np.linspace(0.5, 4.0, N_SNR)

fs = 1.0                       # detector rate, GHz
n_samples = 512
n_channels = 4
ant_z = -97.0 - np.arange(n_channels)

# ---------------------------------------------------------------------------
# signal template: 1e18 eV hadronic shower viewed 1 deg off the Cherenkov cone
# ---------------------------------------------------------------------------
n_index = 1.78
cherenkov = np.arccos(1.0 / n_index)
trace = np.asarray(askaryan.get_time_trace(
    1e18, cherenkov + np.deg2rad(1.0), n_samples, 1.0 / fs,
    is_em=False, n_index=n_index, R=1000.0, model="Alvarez2000"))

ff = np.fft.rfftfreq(n_samples, 1.0 / fs)
band = filters.get_filter_response(ff, (96 * units.MHz, 100 * units.GHz),
                                   "butter", order=4) \
    * filters.get_filter_response(ff, (0, 220 * units.MHz), "butter", order=7)
sig = np.asarray(fft.freq2time(
    fft.time2freq(jnp.asarray(trace), fs) * band, fs, n=n_samples))
signal = np.tile(sig, (n_channels, 1))          # plane wave at beam center

# thermal noise level in the same band (Vrms = 10 mV reference-style choice)
Vrms = 10 * units.mV
vpp_half = 0.5 * (signal.max() - signal.min())
base_factor = Vrms / vpp_half                   # scales signal to SNR=1

# noise generation amplitude so the post-band Vrms equals Vrms
flow, fhigh = 96 * units.MHz, 220 * units.MHz
fine = np.linspace(0, fs / 2, 10000)
resp = filters.get_filter_response(fine, (flow, 100 * units.GHz), "butter",
                                   order=4) \
    * filters.get_filter_response(fine, (0, fhigh), "butter", order=7)
bandwidth = np.trapezoid(np.abs(resp) ** 2, fine)
amp = Vrms / np.sqrt(bandwidth / (0.5 * fs))

# 11 phased beams from the antenna geometry
rolls = np.asarray(phased_array.beam_rolls(
    ant_z, np.zeros(n_channels), np.arcsin(np.linspace(-0.55, 0.55, 11)),
    ref_index=n_index, sampling_frequency=fs), dtype=int)
window, step = 32, 16

# tune the power threshold to a fixed noise-trigger rate (the reference's
# Noise_trigger_rate study; sim/noise_rate.py runs it as vmapped batches)
from nuradiomc_tpu.sim import noise_rate

max_powers = noise_rate.run_phased_array_tuning(
    8192, n_samples, fs, amp, band, rolls, n_channels, window, step,
    seed=1, batch=2048)
trace_duration = n_samples / fs
target_rate = 10 * units.kHz          # internal units: 1/ns
threshold = noise_rate.tune_threshold(target_rate, max_powers, trace_duration)
print(f"threshold tuned to 10 kHz noise rate: {threshold / Vrms ** 2:.2f} Vrms^2")


def one_trial(key, snr_factor):
    keys = jax.random.split(key, n_channels)
    nspec = jax.vmap(lambda k: noise_ops.bandlimited_noise_spectrum(
        k, n_samples, fs, amp, None, fs / 2, type="rayleigh"))(keys)
    ntr = fft.freq2time(nspec * band[None, :], fs, n=n_samples)
    traces = signal * snr_factor + ntr
    trig, _, _, _ = phased_array.phased_power_trigger(
        traces, rolls, threshold, window, step)
    return trig


@jax.jit
def snr_curve(key):
    keys = jax.random.split(key, N_SNR * N_TRIALS).reshape(N_SNR, N_TRIALS, 2)
    factors = jnp.asarray(SNRS * base_factor)
    trig = jax.vmap(lambda ks, f: jax.vmap(lambda k: one_trial(k, f))(ks))(
        keys, factors)
    return jnp.mean(trig, axis=1)


eff = np.asarray(snr_curve(jax.random.PRNGKey(0)))
print("SNR   efficiency")
for s, e in zip(SNRS, eff):
    bar = "#" * int(round(e * 40))
    print(f"{s:4.2f}  {e:5.3f}  {bar}")
np.savez(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "snr_curve.npz"), SNRs=SNRS, efficiency=eff,
         total_events=N_TRIALS)
assert eff[0] < 0.3 and eff[-1] > 0.8, "SNR curve should rise from ~0 to ~1"
assert np.all(np.diff(np.convolve(eff, np.ones(3) / 3, mode="valid")) > -0.15)
print("saved snr_curve.npz")
