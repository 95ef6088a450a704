"""Trace manipulation ops in the rFFT domain (JAX, batched).

Replaces the per-object BaseTrace methods of the reference
(NuRadioReco/framework/base_trace.py): sub-bin Fourier time shifts
(apply_time_shift:246), placement of short traces into a common time base
(add_to_trace:308, efieldToVoltageConverter.py:197-245), and FFT resampling
(resample:278). Everything operates on fixed-length arrays with masks, so the
whole signal chain stays one fused rFFT-domain pipeline.
"""

from __future__ import annotations

import jax.numpy as jnp

from nuradiomc_tpu.utils import fft


def time_shift_phase(frequencies, dt_shift):
    """Phase factor exp(-2 pi i f dt) delaying a spectrum by ``dt_shift``."""
    ctype = jnp.result_type(frequencies.dtype, jnp.complex64)
    return jnp.exp(jnp.asarray(-2j * jnp.pi, ctype) * frequencies * dt_shift)


def time_shift_phase_uniform(n_freqs: int, df, dt_shift, block: int = 32):
    """exp(-2 pi i k df dt) for k = 0..n_freqs-1 on a UNIFORM frequency grid.

    Equivalent to ``time_shift_phase(k * df, dt)`` but built as the outer
    product of two small phase tables (k = block*a + b  =>
    w^k = (w^block)^a * w^b): ~(block + n/block) transcendental evaluations
    per element of ``dt_shift`` instead of n_freqs (hundreds of millions of
    sincos per pipeline step at production batch sizes); the factored form
    replaces ~94% of them with 6-flop complex multiplies.
    """
    real_dtype = jnp.asarray(dt_shift).dtype
    ctype = jnp.result_type(real_dtype, jnp.complex64)
    n_hi = -(-n_freqs // block)
    theta = jnp.asarray(-2 * jnp.pi * df, real_dtype) * dt_shift   # [...]
    b = jnp.arange(block, dtype=real_dtype)
    a = jnp.arange(n_hi, dtype=real_dtype) * block
    wb = jnp.exp(jnp.asarray(1j, ctype) * theta[..., None] * b)    # [..., B]
    wa = jnp.exp(jnp.asarray(1j, ctype) * theta[..., None] * a)    # [..., A]
    ph = wa[..., :, None] * wb[..., None, :]
    return ph.reshape(*theta.shape, n_hi * block)[..., :n_freqs]


def shift_spectrum(spectrum, frequencies, dt_shift):
    """Delay a spectrum by dt_shift (sub-bin accurate, BaseTrace.apply_time_shift)."""
    return spectrum * time_shift_phase(frequencies, dt_shift)


def place_spectrum(spectrum_short, freqs_short, t_start, base_t0, n_base: int,
                   sampling_rate):
    """Embed a short trace's spectrum into a longer common time base.

    The short trace (length N_s, spectrum ``spectrum_short`` over
    ``freqs_short``) starts at absolute time ``t_start``; the base window
    starts at ``base_t0`` with ``n_base`` samples at ``sampling_rate``.
    Returns the length-(n_base//2+1) spectrum of the embedded trace.

    Implementation: zero-pad the time trace to n_base (irfft of the short
    spectrum onto n_base samples after frequency-domain zero interpolation
    would distort; instead go through the time domain once) — but to keep the
    pipeline in the frequency domain, we use the exact relation: zero-padding
    a length-N_s trace to n_base corresponds to evaluating its (continuous)
    DTFT on the denser grid. We therefore irfft -> pad -> rfft lazily via
    jnp; XLA fuses this into the surrounding chain. The sub-bin offset
    (t_start - base_t0) modulo dt is applied as a phase, the integer part as
    a roll of the padded trace (masked to the window).
    """
    dt = 1.0 / sampling_rate
    offset = t_start - base_t0
    n_int = jnp.floor(offset / dt + 0.5).astype(jnp.int32)
    frac = offset - n_int * dt

    # sub-bin shift on the short spectrum, then to time domain
    spec_shifted = shift_spectrum(spectrum_short, freqs_short, frac)
    n_short = 2 * (freqs_short.shape[0] - 1)
    trace = fft.freq2time(spec_shifted, sampling_rate, n=n_short)

    # place into base via padding + roll; contributions that don't fit are
    # rolled around — callers should size the base so this doesn't happen
    padded = jnp.pad(trace, (0, n_base - n_short))
    placed = jnp.roll(padded, n_int, axis=-1)
    return fft.time2freq(placed, sampling_rate)


def hilbert_envelope_from_rfft(spectrum, n: int, sampling_rate: float):
    """Hilbert envelope directly from a one-sided (rfft-convention) spectrum.

    The analytic signal is ifft of the one-sided spectrum with positive
    frequencies doubled (scipy.signal.hilbert), which for a spectrum in the
    power-conserving V/GHz normalization (utils.fft.time2freq) is ONE complex
    ifft — 3x cheaper than irfft + fft + ifft of the time trace.
    """
    # irfft treats the DC and Nyquist bins as real; mirror that here
    head = spectrum[..., :1].real.astype(spectrum.dtype)
    nyq = spectrum[..., -1:].real.astype(spectrum.dtype)
    full = jnp.concatenate(
        [head, 2.0 * spectrum[..., 1:-1], nyq,
         jnp.zeros((*spectrum.shape[:-1], n - spectrum.shape[-1]),
                   spectrum.dtype)], axis=-1)
    z = jnp.fft.ifft(full, axis=-1) * (sampling_rate / jnp.sqrt(2.0))
    return jnp.abs(z)


def hilbert_envelope(trace):
    """|analytic signal| of a real trace (trace_utilities.get_hilbert_envelope,
    scipy.signal.hilbert convention). Last axis = time; batch-polymorphic."""
    n = trace.shape[-1]
    spec = jnp.fft.fft(trace, axis=-1)
    h = jnp.zeros(n, dtype=spec.real.dtype)
    h = h.at[0].set(1.0)
    if n % 2 == 0:
        h = h.at[n // 2].set(1.0)
        h = h.at[1:n // 2].set(2.0)
    else:
        h = h.at[1:(n + 1) // 2].set(2.0)
    return jnp.abs(jnp.fft.ifft(spec * h, axis=-1))


def resample_spectrum(spectrum, n_in: int, n_out: int):
    """FFT-domain resampling (BaseTrace.resample:278 / scipy.signal.resample).

    Down-sampling truncates the spectrum; up-sampling zero-pads. The
    amplitude convention of the framework FFT (V/GHz) is rate-independent, so
    no rescaling is needed beyond Nyquist-bin bookkeeping.
    """
    n_freq_out = n_out // 2 + 1
    n_freq_in = spectrum.shape[-1]
    if n_freq_out <= n_freq_in:
        out = spectrum[..., :n_freq_out]
        # halve the new Nyquist bin if truncating (scipy convention)
        if n_out < n_in and n_out % 2 == 0:
            out = out.at[..., -1].set(out[..., -1].real)
        return out
    pad = [(0, 0)] * (spectrum.ndim - 1) + [(0, n_freq_out - n_freq_in)]
    return jnp.pad(spectrum, pad)
