"""The pipeline's dense-matmul stages against independent numpy references.

* placement: every in-window pulse spectrum zero-padded onto the base grid,
  delayed by its offset and summed over showers and rays
  (``pipeline.place_spectra``), against per-row ``np.fft`` time shifts;
* trigger traces + high/low + majority: the irfft matmul
  (``pipeline.spectrum_to_trace``) and the windowed trigger logic
  (``pipeline._eval_trigger``) against XLA's FFT lowering and the
  module-level trigger functions of ``reco/trigger_modules.py``;
* phased array: decimating irfft, 8-bit quantisation, FFT upsampling, 11
  beams and power windows (``pipeline._eval_trigger``) against a numpy chain.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from nuradiomc_tpu.models import ice as ice_models
from nuradiomc_tpu.ops import phased_array
from nuradiomc_tpu.reco import trigger_modules as tm
from nuradiomc_tpu.sim import pipeline
from nuradiomc_tpu.sim.pipeline import PipelineSettings, TriggerSettings

FS = 2.0                       # GHz
DT = 1.0 / FS


def _settings(n_base, **kw):
    return PipelineSettings(ice=ice_models.southpole_simple, n_base=n_base,
                            sampling_rate=FS, **kw)


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("eps", [0.0, 1e-2])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_placement_matches_numpy_time_shift(dtype, eps):
    rng = np.random.default_rng(5)
    G, S, C, R = 3, 2, 2, 2
    n_int, n_base = 64, 256
    F_int, F_base = n_int // 2 + 1, n_base // 2 + 1
    ctype = np.complex64 if dtype == np.float32 else np.complex128

    volt = (rng.normal(size=(G, S, C, R, F_int))
            + 1j * rng.normal(size=(G, S, C, R, F_int)))
    valid = rng.random((G, S, C, R)) < 0.7
    offset = rng.uniform(0.0, (n_base - n_int) * DT, (G, S, C, R))

    D_r, D_i = pipeline._placement_matrices(n_int, n_base)
    K = F_int
    if eps > 0:
        # an order-8 low-pass: the rows it suppresses below eps are dropped
        f = np.fft.rfftfreq(n_int, DT)
        response = 1.0 / (1.0 + (f / 0.3) ** 8)
        K = pipeline._band_support((response[None, :],), eps, F_int)
        assert K < F_int
    out = pipeline.place_spectra(
        jnp.asarray(volt, ctype), jnp.asarray(valid),
        jnp.asarray(offset, dtype), jnp.asarray(D_r[:K], ctype),
        jnp.asarray(D_i[:K], ctype), FS / n_base, dtype)
    assert out.shape == (G, C, F_base) and out.dtype == ctype

    v = np.where(valid[..., None], volt, 0.0)
    v[..., K:] = 0.0
    x = np.fft.irfft(v, n=n_int, axis=-1)
    X = np.fft.rfft(np.pad(x, [(0, 0)] * 4 + [(0, n_base - n_int)]), axis=-1)
    f_base = np.fft.rfftfreq(n_base, DT)
    X = X * np.exp(-2j * np.pi * f_base * offset[..., None])
    ref = X.sum(axis=(1, 3))
    # float32: the phase of a ~100 ns delay at 1 GHz (~600 rad) is good to
    # ~4e-5 rad
    tol = 1e-4 if dtype == np.float32 else 1e-11
    np.testing.assert_allclose(np.asarray(out), ref,
                               atol=tol * np.abs(ref).max())


# ---------------------------------------------------------------------------
# trigger traces + high/low + majority
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("C,n_coinc,n_base,k", [
    (1, 1, 256, None),
    (3, 2, 256, None),
    (3, 2, 250, 72),           # odd F_base = 126, band-limited to 72 rows
])
def test_high_low_majority_matches_fft_and_reference(C, n_coinc, n_base, k):
    rng = np.random.default_rng(7)
    G = 16
    F = n_base // 2 + 1
    spec = rng.normal(size=(G, C, F)) + 1j * rng.normal(size=(G, C, F))
    if k is not None:
        spec[..., k:] = 0.0    # what the filter chain leaves of the band
    # scale each group so the +-1 thresholds sit at 0.5 .. 1.2 of its peak:
    # some groups fire, some do not
    peak = np.abs(np.fft.irfft(spec, n=n_base, axis=-1)).max(axis=(1, 2))
    spec = spec / (peak * np.linspace(0.5, 1.2, G))[:, None, None]
    ref_traces = np.fft.irfft(spec, n=n_base, axis=-1) * FS / np.sqrt(2.0)

    t = TriggerSettings(trigger_type="high_low", threshold_high=1.0,
                        threshold_low=-1.0, highlow_coincidence=5.0,
                        number_of_coincidences=n_coinc,
                        channel_coincidence=32.0)
    decisions = {}
    for irfft in ("matmul", "fft"):
        s = _settings(n_base, trigger_irfft=irfft)
        spec_j = jnp.asarray(spec, jnp.complex64)
        traces = pipeline.spectrum_to_trace(spec_j, s, jnp.float32, k)
        assert traces.shape == (G, C, n_base)
        np.testing.assert_allclose(np.asarray(traces), ref_traces,
                                   atol=1e-5 * np.abs(ref_traces).max())
        fired, time = pipeline._eval_trigger(
            t, traces, spec_j, jnp.zeros(G, jnp.float32), s, None,
            jnp.float32)
        decisions[irfft] = (np.asarray(fired), np.asarray(time))
    np.testing.assert_array_equal(*(d[0] for d in decisions.values()))
    np.testing.assert_array_equal(*(d[1] for d in decisions.values()))

    fired, time = decisions["matmul"]
    assert fired.any() and not fired.all(), "degenerate test"
    for g in range(G):
        tts = [tm.get_high_low_triggers(ref_traces[g, c], 1.0, -1.0,
                                        t.highlow_coincidence, DT)
               for c in range(C)]
        has, bins, _ = tm.get_majority_logic(tts, n_coinc,
                                             t.channel_coincidence, DT)
        assert fired[g] == has, g
        if has:
            assert time[g] == pytest.approx(bins[0] * DT), g


# ---------------------------------------------------------------------------
# phased array
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("upsampling", [1, 2])
def test_phased_array_chain_matches_numpy(upsampling):
    rng = np.random.default_rng(11)
    G, C, n_base = 8, 4, 1024
    adc_fs, nbits, window, step = 0.5, 8, 32, 16
    F = n_base // 2 + 1
    spec = (rng.normal(size=(G, C, F)) + 1j * rng.normal(size=(G, C, F)))
    spec *= np.linspace(0.5, 2.0, G)[:, None, None]
    rolls = phased_array.beam_rolls(
        [-197.0 - i for i in range(C)], [0.0] * C,
        phased_array.default_angles, 1.73, adc_fs * upsampling)
    assert rolls.shape == (11, C)

    # numpy chain: resample to 5 GHz, decimate to the ADC rate, floor
    # comparator with saturation, FFT upsampling, beams, power windows
    fs_hi = 5.0
    n_hi = int(round(n_base * fs_hi / FS))
    decim = int(round(fs_hi / adc_fs))
    tr = np.fft.irfft(spec, n=n_hi, axis=-1)[..., ::decim] * fs_hi / np.sqrt(2)
    adc_range = 1.6 * np.abs(tr).max()          # the loudest groups saturate
    v_min, lsb = -adc_range / 2, adc_range / (2 ** nbits - 1)
    counts = np.clip(np.floor((tr - v_min) / lsb), 0, 2 ** nbits - 1)
    q = lsb * (counts + np.floor(v_min / lsb))
    n_pa = q.shape[-1]
    if upsampling > 1:
        q = np.fft.irfft(np.fft.rfft(q, axis=-1), n=n_pa * upsampling,
                         axis=-1) * upsampling
    fs_pa = adc_fs * upsampling
    max_power = np.array([tm._phased_power_host(q[g], rolls, np.inf, window,
                                                step)[1].max()
                          for g in range(G)])
    # the median group's peak power, a hair below and above: that group
    # sits on the knife edge (float64 both sides: ~1e-13 apart), so the
    # power of every stage must agree, not just the loud/quiet split
    s = _settings(n_base)
    spec_j = jnp.asarray(spec)
    edge = float(np.sort(max_power)[G // 2])
    for threshold in (edge * (1 - 1e-9), edge * (1 + 1e-9)):
        t = TriggerSettings(
            trigger_type="phased_array", pa_rolls=tuple(map(tuple, rolls)),
            pa_window=window, pa_step=step, pa_upsampling=upsampling,
            pa_threshold=threshold, pa_digitize=True, pa_adc_fs=adc_fs,
            pa_adc_nbits=nbits, pa_adc_range=adc_range)
        fired, time = pipeline._eval_trigger(
            t, pipeline.spectrum_to_trace(spec_j, s, jnp.float64), spec_j,
            jnp.zeros(G), s, None, jnp.float64)
        fired, time = np.asarray(fired), np.asarray(time)

        assert fired.any() and not fired.all(), "degenerate test"
        for g in range(G):
            has, _, frames = tm._phased_power_host(q[g], rolls, threshold,
                                                   window, step)
            assert fired[g] == has, (threshold, g)
            if has:
                assert time[g] == pytest.approx(frames[0] * step / fs_pa), g


def test_matmul_dtype_bfloat16_trace_within_input_rounding():
    """bf16 matmul inputs with float32 accumulation stay within bf16's
    relative input rounding of the exact trace."""
    rng = np.random.default_rng(2)
    spec = rng.normal(size=(2, 1, 129)) + 1j * rng.normal(size=(2, 1, 129))
    s = dataclasses.replace(_settings(256), matmul_dtype="bfloat16")
    traces = pipeline.spectrum_to_trace(jnp.asarray(spec, jnp.complex64), s,
                                        jnp.float32)
    ref = np.fft.irfft(spec, n=256, axis=-1) * FS / np.sqrt(2.0)
    err = np.abs(np.asarray(traces) - ref).max() / np.abs(ref).max()
    assert 1e-4 < err < 2e-2        # rounded like bf16, but not more
