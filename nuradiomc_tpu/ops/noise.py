"""Band-limited noise synthesis in the rFFT domain (JAX).

Re-implementation of the reference channelGenericNoiseAdder semantics
(NuRadioReco/modules/channelGenericNoiseAdder.py:66-160): noise is built
directly in the rFFT domain on the active band [min_freq, max_freq] with

    sigscale = n_samples / sqrt(n_active_bins)
    perfect_white: |A_k| = amplitude * sigscale
    rayleigh:      |A_k| ~ Rayleigh(amplitude * sigscale / sqrt(2))

uniform random phases on bins 1..(n-1)//2 (add_random_phases:15-32), divided
by the sampling rate, giving a trace with RMS ~= ``amplitude`` via the
framework freq2time. Uses counter-based `jax.random` keys instead of the
reference's stateful numpy generator — same distribution, reproducible by key.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from nuradiomc_tpu.utils import fft


def bandlimited_noise_spectrum(key, n_samples: int, sampling_rate: float,
                               amplitude, min_freq, max_freq,
                               type: str = "rayleigh", dtype=jnp.float32,
                               sampler: str = "phase"):
    """One realization of the noise rFFT spectrum (NuRadioMC normalization).

    Returns a complex array of shape (n_samples // 2 + 1,) to be added to a
    channel's frequency spectrum (already scaled like fft.time2freq output
    divided by... no: like `spectrum / sampling_rate` per the reference, so
    that freq2time yields the time-domain noise directly).

    vmap over keys for a batch of channels/events.

    ``sampler`` selects the draw for type="rayleigh" — both produce the
    SAME distribution (Rayleigh amplitude x uniform phase == circular
    complex gaussian), different realizations per key:

    * "phase": the literal reference construction (one log + sqrt + two
      sincos per bin);
    * "gaussian": two normal draws per bin (erfinv is a polynomial: fewer
      transcendentals than log + sqrt + sincos). Bins whose phase is pinned real (DC/Nyquist,
      add_random_phases:15-32) take the Rayleigh modulus |z1 + i z2|.
    """
    n_freqs = n_samples // 2 + 1
    frequencies = jnp.fft.rfftfreq(n_samples, 1.0 / sampling_rate).astype(dtype)

    if min_freq is None or min_freq == 0:
        # remove DC only (channelGenericNoiseAdder.py:112-117)
        min_freq = 0.5 * (frequencies[2] - frequencies[1])
    if max_freq is None:
        max_freq = frequencies[-1]

    selection = (frequencies >= min_freq) & (frequencies <= max_freq)
    nbins = jnp.sum(selection)
    sigscale = n_samples / jnp.sqrt(nbins).astype(dtype)

    key_amp, key_phase = jax.random.split(key)
    if type == "rayleigh" and sampler == "gaussian":
        fsigma = amplitude * sigscale / jnp.sqrt(2.0).astype(dtype)
        z = jax.random.normal(key_amp, (2, n_freqs), dtype=dtype)
        Np = (n_samples - 1) // 2
        bin_idx = jnp.arange(n_freqs)
        phase_mask = (bin_idx >= 1) & (bin_idx <= Np)
        cdtype = jnp.result_type(dtype, jnp.complex64)
        val = jnp.where(phase_mask,
                        (z[0] + 1j * z[1]).astype(cdtype),
                        jnp.sqrt(z[0] ** 2 + z[1] ** 2).astype(cdtype))
        return jnp.where(selection, fsigma * val, 0.0) / sampling_rate
    if type == "perfect_white":
        ampl = jnp.where(selection, amplitude * sigscale, 0.0)
    elif type == "rayleigh":
        fsigma = amplitude * sigscale / jnp.sqrt(2.0).astype(dtype)
        u = jax.random.uniform(key_amp, (n_freqs,), dtype=dtype, minval=jnp.finfo(dtype).tiny)
        rayleigh = fsigma * jnp.sqrt(-2.0 * jnp.log(u))
        ampl = jnp.where(selection, rayleigh, 0.0)
    else:
        raise NotImplementedError(f"noise type {type}")

    # random phases on bins 1..(n-1)//2; DC and Nyquist stay real
    Np = (n_samples - 1) // 2
    phases = jax.random.uniform(key_phase, (n_freqs,), dtype=dtype) * 2 * jnp.pi
    bin_idx = jnp.arange(n_freqs)
    phase_mask = (bin_idx >= 1) & (bin_idx <= Np)
    phasor = jnp.where(phase_mask, jnp.exp(1j * phases.astype(jnp.result_type(dtype, jnp.complex64))), 1.0)

    return ampl * phasor / sampling_rate


def bandlimited_noise_trace(key, n_samples: int, sampling_rate: float,
                            amplitude, min_freq, max_freq,
                            type: str = "rayleigh", dtype=jnp.float32):
    """Time-domain noise trace (bandlimited_noise with time_domain=True)."""
    spec = bandlimited_noise_spectrum(key, n_samples, sampling_rate, amplitude,
                                      min_freq, max_freq, type, dtype)
    return fft.freq2time(spec, sampling_rate, n=n_samples)
