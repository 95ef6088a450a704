"""The fused end-to-end MC pipeline (JAX, one jitted function).

Batch-first re-design of the reference per-event loop
(NuRadioMC/simulation/simulation.py:1426-1726, calculate_sim_efield:93-292,
apply_det_response:530-609): instead of nested Python loops over event groups,
stations, channels and ray-tracing solutions, the whole physics chain runs as
one batched device computation over

    [group G x shower S x channel C x solution 2]

with validity masks replacing every early-exit (no-solution, delta_C cut,
padding). The stages:

1. batched analytic ray tracing           (ops.raytrace)
2. viewing angle + delta_C cut            (simulation.py:195-206)
3. Askaryan spectrum per solution         (ops.askaryan, simulation.py:230)
4. polarization in on-sky coordinates     (simulation.py:798-829)
5. propagation effects: attenuation on a sparse frequency grid + interp,
   surface-reflection Fresnel, focusing   (analyticraytracing.py:2937-3033)
6. antenna response (VEL dot product)     (efieldToVoltageConverter.py:309-310)
7. placement into a common time base with sub-bin shifts
   (efieldToVoltageConverter.py:150-245) + cable delays
8. filter chain (precomputed response), optional noise
9. triggers (high-low / threshold + majority logic)

Host code (sim.simulation) prepares padded numpy batches and static settings;
this module is pure JAX and shards over a device mesh via vmap/pjit.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from nuradiomc_tpu.models.ice import IceModelSimple
from nuradiomc_tpu.ops import (antenna, askaryan, noise as noise_ops,
                               phased_array, raytrace, trace as trace_ops,
                               triggers)
from nuradiomc_tpu.utils import fft, geometry

# Precision of the dense DFT matmuls (placement, trigger irfft and the
# phased-array resample chain). DEFAULT lets a float32 product run in TF32
# on a GPU (10 mantissa bits, more than the bfloat16 inputs that
# matmul_dtype="bfloat16" is licensed for): on an NVIDIA H100 80GB HBM3
# at its 700 W limit it gave the same per-group decisions as HIGHEST on
# every bench probe at 2.4x the veff rate (tools/device_measure.py
# precision). Float64 products are exact
# either way.
DFT_PRECISION = jax.lax.Precision.DEFAULT
# The attenuation interpolation matmuls are small; full float32 products.
_INTERP_PRECISION = jax.lax.Precision.HIGHEST


@dataclasses.dataclass(frozen=True)
class PipelineSettings:
    """Static (trace-time) configuration of the fused pipeline."""

    ice: IceModelSimple
    attenuation_model: str = "SP1"
    askaryan_model: str = "Alvarez2000"
    n_internal: int = 512          # efield trace samples at internal rate
    n_bisect: int = 96             # ray-solver bisection iterations (f32: ~40 suffices)
    n_base: int = 2048             # channel time-base samples
    sampling_rate: float = 2.0     # internal rate, GHz
    delta_C_cut: float = 0.698     # rad, speedup cut off the Cherenkov cone
    distance_cut: bool = False     # polynomial vertex-distance speedup cut
    # config_default.yaml:20-21
    distance_cut_coefficients: tuple = (-1.56434411e02, 2.54131322e01,
                                        -1.34932379e00, 2.39984185e-02)
    distance_cut_sum_length: float = 10.0   # m
    n_freq_attenuation: int = 25   # sparse frequencies for the attenuation integral
    # detector nyquist frequency: the sparse attenuation grid is dense up to
    # here and half as dense above (reference analyticraytracing.py:885-931)
    max_detector_freq: float = None
    # bottom-reflection solutions (Moore's Bay): the solution axis widens to
    # 2 + 4*n_reflections slots ordered [r=0 x2, (r=1,case=1) x2,
    # (r=1,case=2) x2, ...] (propagation_base_class.py:424-429); each bounce
    # multiplies the spectrum by ice.refl_coef * exp(i*refl_phase_shift)
    # (apply_propagation_effects:3004-3011). Requires ice.refl_z.
    n_reflections: int = 0
    # sub-event readout windows per group: the reference splits one event
    # group into sub-events when ray arrivals gap by more than
    # split_event_time_diff and evaluates each sub-event's readout window
    # separately (simulation.py group splitting). A fixed n_base window
    # cannot hold arrivals that span more than (n_base - n_internal)*dt
    # (e.g. bottom-bounce rays arrive ~1-6 us after the direct pulse), so
    # the pipeline greedily clusters arrivals into up to n_windows windows
    # (anchor = earliest remaining arrival) and evaluates the full
    # filter+trigger chain per window; decisions OR, trigger time = min.
    # n_windows=1 reproduces the single-window behavior exactly.
    n_windows: int = 1
    attenuation_steps: int = 16    # quadrature nodes along the path
    # "gauss" (default): Gauss-Legendre nodes — the t-substituted integrand is
    # smooth, so GL-16 reaches ~1e-5 accuracy (the old midpoint-64 was ~4e-4);
    # "midpoint" keeps the original rule
    attenuation_quadrature: str = "gauss"
    attenuate_ice: bool = True
    apply_focusing: bool = False
    focusing_limit: float = 2.0
    focusing_dz: float = -0.01             # receiver displacement (-1 cm), numeric focusing
    focusing_mode: str = "implicit"        # "implicit" (exact dz->0 grad) | "numeric"
    # trigger block
    trigger_type: str = "high_low"         # 'high_low' | 'simple_threshold' | 'phased_array'
    highlow_coincidence: float = 5.0       # ns within a channel
    number_of_coincidences: int = 1
    channel_coincidence: float = 200.0     # ns across channels
    # phased-array trigger block (trigger_type == 'phased_array')
    pa_rolls: tuple = ()                   # static (B, C) integer beam delays
    pa_window: int = 32                    # power window in (upsampled) ticks
    pa_step: int = 16
    pa_upsampling: int = 1                 # FFT upsampling factor before phasing
    pa_threshold: float = 0.0              # power threshold (e.g. 30.85 Vrms^2)
    # trigger-ADC digitization before phasing (analogToDigitalConverter
    # .get_digital_trace:254-372; apply_digitization=True is the module default)
    pa_digitize: bool = False
    pa_adc_fs: float = 0.5                 # ADC sampling rate, GHz
    pa_adc_nbits: int = 8
    pa_adc_range: float = 0.0              # full-scale voltage range (host-computed)
    # trigger-trace inverse transform: "matmul" (default) lowers the final
    # irfft(n_base) — and the PA upsample/decimate chain — to dense real
    # matmuls; "fft" keeps XLA's FFT lowering. Numerically equivalent to
    # ~1e-15; which is faster on a given device is a measurement.
    trigger_irfft: str = "matmul"
    # band-limited compute: > 0 slices the placement-DFT and trigger-irfft
    # matmuls (the step's dominant FLOPs) to the filter chain's numerical
    # support — frequency rows whose |response| <= eps * max|response| for
    # EVERY channel are dropped before the matmul. The e2e filter chains
    # (order-10 low-pass) suppress the dropped band to <= eps, so traces
    # perturb by O(eps) relative vs the measured >= 2% closest trigger
    # margin (BASELINE.md f32 audit). 0 disables (exact). Host-side static:
    # ignored when the channel responses are traced (mesh argument form).
    band_limit_eps: float = 0.0
    # PROFILING ONLY — cumulative stop-after ladder: truncate simulate_batch
    # after the named stage and return a dummy output whose `triggered`
    # keeps everything computed so far live (so timings of successive
    # anchors attribute the REAL full step, with XLA's DCE behaving exactly
    # as in the bench block). "" = full step (production).
    # Anchors: ray | spec | attquad | scalars | placement | filter
    stop_after: str = ""
    # matmul input dtype for the final irfft's dense DFT matrices:
    # "float32" (default) or "bfloat16" — bf16 inputs with f32 accumulation
    # halve the operand bytes; the ~4e-3 relative rounding is an order of magnitude below the smallest non-borderline
    # trigger margin (BASELINE.md f32 margin audit: 6.0%) and the bf16
    # variant is held to the same golden-triggered-set budget
    matmul_dtype: str = "float32"
    # birefringence block (config propagation.birefringence*,
    # apply_propagation_effects analyticraytracing.py:3020-3030)
    birefringence: bool = False
    birefringence_model: str = "southpole_A"
    birefringence_points: int = 256        # fixed path samples (jit static)
    birefringence_iceflow: float = 0.0     # ice-flow azimuth (rad)
    # noise block
    add_noise: bool = False
    noise_type: str = "rayleigh"
    # "phase" = the reference's literal Rayleigh-amplitude x uniform-phase
    # construction; "gaussian" = circular complex gaussian — SAME
    # distribution, fewer transcendentals per bin
    # (ops/noise.py docstring). Different realizations per key, so flip
    # only with statistical (not bit-pinned) conformance targets.
    noise_sampler: str = "phase"
    # multi-trigger block: tuple of TriggerSettings evaluated in ONE fused
    # pass (the reference registers N named triggers per station in one run,
    # e.g. T02RunPhasedRNO.py:76-109; HDF5 multiple_triggers matrix,
    # output_writer_hdf5.py:350-381). Empty tuple = legacy single-trigger
    # fields above.
    triggers: tuple = ()

    @property
    def dt(self) -> float:
        return 1.0 / self.sampling_rate

    @property
    def freqs_internal(self):
        return jnp.fft.rfftfreq(self.n_internal, self.dt)

    @property
    def freqs_base(self):
        return jnp.fft.rfftfreq(self.n_base, self.dt)


@dataclasses.dataclass(frozen=True)
class TriggerSettings:
    """Static configuration of ONE named trigger inside the fused pipeline.

    The reference evaluates many named triggers per station in a single run
    (simulation.py evaluates every Trigger the user registers; the standard
    threshold-ladder workflow registers eight,
    NuRadioReco/examples/PhasedArray/Effective_volume/T02RunPhasedRNO.py:76-109)
    and writes a per-trigger-name ``multiple_triggers`` matrix
    (output_writer_hdf5.py:350-381). Each instance here is one column of that
    matrix; all are evaluated on the SAME assembled channel traces, so N
    triggers cost N trivial kernels, not N simulations.

    ``channels`` holds channel INDICES into the station's channel axis
    (host-resolved from channel ids); empty = all channels. Thresholds are
    absolute volts; ``None`` falls back to the per-channel
    ChannelParams.threshold_high/low arrays (legacy single-trigger path).
    """

    name: str = "default_high_low"
    trigger_type: str = "high_low"   # 'high_low' | 'simple_threshold' | 'phased_array'
    channels: tuple = ()
    threshold_high: float = None
    threshold_low: float = None
    highlow_coincidence: float = 5.0
    number_of_coincidences: int = 1
    channel_coincidence: float = 200.0
    pa_rolls: tuple = ()
    pa_window: int = 32
    pa_step: int = 16
    pa_upsampling: int = 1
    pa_threshold: float = 0.0
    pa_digitize: bool = False
    pa_adc_fs: float = 0.5
    pa_adc_nbits: int = 8
    pa_adc_range: float = 0.0
    # name of an earlier-declared trigger this one is gated on (the
    # reference's set_not_triggered(not has_triggered(name)) pattern); None
    # evaluates unconditionally
    requires: str = None


class ChannelParams(NamedTuple):
    """Per-channel device arrays (built on host from the Detector)."""

    positions: jnp.ndarray       # [C, 3] absolute antenna positions
    cable_delays: jnp.ndarray    # [C]
    rot: jnp.ndarray             # [C, 3, 3] global->antenna-frame rotations
    kind: jnp.ndarray            # [C] analytic antenna kind
    templates: jnp.ndarray       # [C, 3, F_int] complex VEL frequency templates
    filter_response: jnp.ndarray # [C, F_base] complex chain response
    filter_response_int: jnp.ndarray  # [C, F_int] chain response on the efield grid
    threshold_high: jnp.ndarray  # [C]
    threshold_low: jnp.ndarray   # [C]
    noise_amplitude: jnp.ndarray # [C] noise amplitude at generation (pre-filter,
                                 # normalized so post-filter RMS = Vrms;
                                 # simulation.py:595-600)
    min_efield_amplitude: jnp.ndarray  # [C] candidate speedup cut threshold
                                 # (simulation.py:283-286; 0 disables)
    # optional separate trigger-channel response (channel.py:33-58
    # set_trigger_channel / iter_trigger_channels): when not None, trigger
    # kernels read traces filtered with THIS [C, F_base] response while
    # readout observables keep filter_response
    trigger_filter_response: Optional[jnp.ndarray] = None
    # optional tabulated antenna patterns (AntennaTableParams): when not
    # None, the VEL comes from per-direction trilinear interpolation of the
    # pickled grids (antennapattern.py:1426-1580) instead of the analytic
    # templates; `templates`/`kind` are ignored
    antenna_table: Optional["AntennaTableParams"] = None


class AntennaTableParams(NamedTuple):
    """Per-channel stacked tabulated antenna grids (common grid shape).

    Built host-side from reference-format pickles
    (ops.antenna.load_antenna_table); h_* are [C, F0, T, P] complex.
    """

    freqs: jnp.ndarray     # (F0,)
    thetas: jnp.ndarray    # (T,)
    phis: jnp.ndarray      # (P,)
    h_theta: jnp.ndarray   # (C, F0, T, P)
    h_phi: jnp.ndarray     # (C, F0, T, P)


class ShowerBatch(NamedTuple):
    """Padded struct-of-arrays event-group batch (leading axes [G, S])."""

    vertices: jnp.ndarray      # [G, S, 3]
    energies: jnp.ndarray      # [G, S] shower energies
    is_em: jnp.ndarray         # [G, S] bool
    shower_mask: jnp.ndarray   # [G, S] bool (padding)
    prop_dir: jnp.ndarray      # [G, S, 3] unit propagation direction (-axis)
    k_L: jnp.ndarray           # [G, S] Alvarez2009 parameter (ignored otherwise)
    vertex_times: jnp.ndarray  # [G, S]
    profile_idx: Optional[jnp.ndarray] = None  # [G, S] ARZ shower-library pick
    # emitter mode: per-emitter efield polarization (0 = eTheta, 1 = ePhi;
    # efield_delta_pulse semantics, SignalGen/emitter.py:153-157)
    emitter_polarization: Optional[jnp.ndarray] = None  # [G, S]


class PipelineOutput(NamedTuple):
    triggered: jnp.ndarray        # [G] bool
    candidate: jnp.ndarray        # [G] bool (min_efield_amplitude speedup cut)
    max_efield: jnp.ndarray       # [G] max |E| over showers/channels/solutions
    trigger_time: jnp.ndarray     # [G] absolute trigger time (ns)
    max_amplitude: jnp.ndarray    # [G, C]
    traces: Optional[jnp.ndarray] # [G, C, n_base] (None if not requested)
    base_t0: jnp.ndarray          # [G] start time of the time base
    # per-solution observables for the output writer [G, S, C, 2]
    sol_mask: jnp.ndarray
    c0: jnp.ndarray
    c1: jnp.ndarray
    sol_type: jnp.ndarray
    travel_time: jnp.ndarray
    path_length: jnp.ndarray
    launch_vector: jnp.ndarray    # [G, S, C, 2, 3]
    receive_vector: jnp.ndarray   # [G, S, C, 2, 3]
    polarization: jnp.ndarray     # [G, S, C, 2, 3] on-sky at the vertex
    viewing_angle: jnp.ndarray
    max_amp_per_solution: jnp.ndarray  # [G, S, C, 2]
    focusing: jnp.ndarray         # [G, S, C, 2]
    # per-slot bottom-bounce bookkeeping (0 / r for bounce slots, and the
    # reflection case 1|2) — the output writer's ray_tracing_reflection /
    # ray_tracing_reflection_case columns (output_writer_hdf5 schema)
    reflection: Optional[jnp.ndarray] = None
    refl_case: Optional[jnp.ndarray] = None
    # propagated on-sky efield spectra [2(theta,phi), G, S, C, 2, F_int]
    # (only when requested with keep_efields)
    efields: Optional[jnp.ndarray] = None
    # per-named-trigger decision matrix [G, T] and times [G, T] in the order
    # of PipelineSettings.triggers (the reference's multiple_triggers /
    # trigger_times columns, output_writer_hdf5.py:350-381)
    triggered_per: Optional[jnp.ndarray] = None
    trigger_times_per: Optional[jnp.ndarray] = None


import functools


@functools.lru_cache(maxsize=8)
def _irfft_matrices(n_base: int):
    """Real-linear irfft as two dense [F_base, n_base] matrices:
    x = I_r Re(X) + I_i Im(X) (irfft is real-linear in (Re, Im))."""
    import numpy as _np
    F = n_base // 2 + 1
    eye = _np.eye(F)
    I_r = _np.fft.irfft(eye, n=n_base, axis=1)
    I_i = _np.fft.irfft(1j * eye, n=n_base, axis=1)
    return I_r, I_i


@functools.lru_cache(maxsize=8)
def _decimating_irfft_matrices(n_base: int, n_hi: int, decim: int):
    """irfft(spec, n=n_hi)[::decim] as two [F_base, n_hi//decim] matrices
    (spectrum zero-padding is implicit in irfft's n= argument)."""
    import numpy as _np
    F = n_base // 2 + 1
    eye = _np.eye(F)
    D_r = _np.fft.irfft(eye, n=n_hi, axis=1)[:, ::decim]
    D_i = _np.fft.irfft(1j * eye, n=n_hi, axis=1)[:, ::decim]
    return D_r, D_i


@functools.lru_cache(maxsize=8)
def _fft_upsample_matrix(n_in: int, factor: int):
    """rfft -> zero-pad -> irfft FFT upsampling as one [n_in, n_in*factor]
    matrix; the V/GHz density convention makes the net scale = factor."""
    import numpy as _np
    eye = _np.eye(n_in)
    return _np.fft.irfft(_np.fft.rfft(eye, axis=1),
                         n=n_in * factor, axis=1) * factor


def _band_support(responses, eps, full):
    """Highest frequency index (exclusive) whose |response| exceeds
    ``eps * max|response|`` on ANY channel in any of the given response
    arrays, rounded up to a multiple of 8 (keeps the sliced matmul widths
    aligned). Returns ``full`` when nothing can be
    dropped — including when a response is a traced value (mesh argument
    form: the support must be static, so band limiting is silently
    disabled there)."""
    k = 0
    for resp in responses:
        if resp is None:
            continue
        if not isinstance(resp, np.ndarray):
            return full
        mag = np.max(np.abs(np.asarray(resp)), axis=0)
        keep = mag > eps * mag.max()
        if not keep.any():
            continue
        k = max(k, int(np.flatnonzero(keep).max()) + 1)
    if k == 0 or k >= full:
        return full
    return int(min(full, -(-k // 8) * 8))


@functools.lru_cache(maxsize=8)
def _placement_matrices(n_int: int, n_base: int):
    """Dense real-linear maps from a short rFFT spectrum to the spectrum of
    the zero-padded trace on the n_base grid: X_base = D_r Re(V) + D_i Im(V)
    (irfft is real-linear, not complex-linear, so two matrices are needed).
    Built column-by-column with numpy's own irfft/rfft, so edge-bin handling
    matches the FFT exactly."""
    import numpy as _np
    F_int = n_int // 2 + 1
    eye = _np.eye(F_int)
    x_r = _np.fft.irfft(eye, n=n_int, axis=1)
    x_i = _np.fft.irfft(1j * eye, n=n_int, axis=1)
    pad = ((0, 0), (0, n_base - n_int))
    D_r = _np.fft.rfft(_np.pad(x_r, pad), axis=1)
    D_i = _np.fft.rfft(_np.pad(x_i, pad), axis=1)
    return D_r, D_i


@functools.lru_cache(maxsize=8)
def _interp_matrix(x_sparse: tuple, x_dense: tuple):
    """W[s, d] with (v_sparse @ W) == np.interp(x_dense, x_sparse, v_sparse)."""
    import numpy as _np
    xs = _np.asarray(x_sparse)
    xd = _np.asarray(x_dense)
    W = _np.zeros((len(xs), len(xd)))
    idx = _np.clip(_np.searchsorted(xs, xd) - 1, 0, len(xs) - 2)
    x0, x1 = xs[idx], xs[idx + 1]
    t = _np.clip((xd - x0) / (x1 - x0), 0.0, 1.0)
    W[idx, _np.arange(len(xd))] = 1.0 - t
    W[idx + 1, _np.arange(len(xd))] = t
    return W


def _attenuation_freq_grid(ff, n_freq, max_detector_freq=None):
    """The reference's sparse frequency vector for the attenuation integral
    (analyticraytracing.py:885-931): n_freq points over the positive
    detector band (0, f_nyq_det] plus n_freq//2 points over
    (f_nyq_det, f_max] when the internal band extends beyond the detector —
    linear interpolation of the attenuation curve between THESE nodes is
    part of the conformance contract (the interpolation error is a few
    percent mid-band and both sides must make the same one)."""
    ff = np.asarray(ff)
    pos = ff[ff > 0]
    n = min(int(n_freq), pos.size)
    if max_detector_freq is not None and n < pos.size:
        det = pos[pos <= max_detector_freq]
        if det.size:
            n = min(int(n_freq), det.size)
            freqs = np.linspace(det.min(), det.max(), n)
            above = pos[pos > max_detector_freq]
            if above.size > 1:
                freqs = np.append(
                    freqs, np.linspace(above.min(), above.max(), n // 2))
            return freqs
    return np.linspace(pos.min(), pos.max(), n)


def _attenuation_sparse_values(sols: raytrace.RaySolutions, geom,
                               s: PipelineSettings):
    """Attenuation factors at the sparse frequencies [..., n_sparse] plus the
    host interpolation matrix W [n_sparse, F_int] mapping to the dense grid
    (the reference's sparse-frequency optimization,
    analyticraytracing.py:885-931)."""
    ff_np = np.fft.rfftfreq(s.n_internal, s.dt)
    sparse_np = _attenuation_freq_grid(tuple(ff_np), s.n_freq_attenuation,
                                       s.max_detector_freq)
    sparse = jnp.asarray(sparse_np)

    shape = sols.c0.shape
    if s.n_reflections > 0:
        # uniform per-slot path: traced (r, case, mirror) coefficients
        # cover base AND bottom-bounce slots (attenuation_factor_slots)
        def one_slot(c0, st, rr, cc, x1z, x2z):
            return raytrace.attenuation_factor_slots(
                c0, st, rr, cc, x1z, x2z, s.ice, sparse,
                s.attenuation_model, n_steps=s.attenuation_steps,
                quadrature=s.attenuation_quadrature)

        flat = jax.vmap(one_slot)(
            sols.c0.reshape(-1),
            sols.sol_type.reshape(-1),
            sols.reflection.reshape(-1),
            sols.refl_case.reshape(-1),
            jnp.broadcast_to(geom.x1z[..., None], shape).reshape(-1),
            jnp.broadcast_to(geom.x2z[..., None], shape).reshape(-1),
        ).reshape(*shape, -1)  # [..., n_sparse]
        W = _interp_matrix(tuple(sparse_np), tuple(ff_np))
        return flat, W

    def one(c0, x1y, x1z, x2y, x2z):
        return raytrace.attenuation_factor(
            c0, x1y, x1z, x2y, x2z, s.ice, sparse, s.attenuation_model,
            n_steps=s.attenuation_steps, quadrature=s.attenuation_quadrature)

    # flatten [G,S,C,2] -> vmap -> restore
    flat = jax.vmap(one)(
        sols.c0.reshape(-1),
        jnp.broadcast_to(geom.x1y[..., None], shape).reshape(-1),
        jnp.broadcast_to(geom.x1z[..., None], shape).reshape(-1),
        jnp.broadcast_to(geom.x2y[..., None], shape).reshape(-1),
        jnp.broadcast_to(geom.x2z[..., None], shape).reshape(-1),
    ).reshape(*shape, -1)  # [..., n_sparse]
    W = _interp_matrix(tuple(sparse_np), tuple(ff_np))
    return flat, W


def _attenuation_sparse(sols: raytrace.RaySolutions, geom, s: PipelineSettings):
    """Attenuation factors on the internal frequency grid via a sparse grid
    + one [n_sparse, F_int] interpolation matmul (jnp.interp would compile
    to a gather per element)."""
    ff = s.freqs_internal
    flat, W = _attenuation_sparse_values(sols, geom, s)
    shape = flat.shape[:-1]
    full = jnp.einsum("ps,sf->pf", flat.reshape(-1, flat.shape[-1]),
                      jnp.asarray(W, flat.dtype),
                      precision=_INTERP_PRECISION)
    full = jnp.where(ff > 0, full, 1.0)
    return full.reshape(*shape, ff.shape[0])


class EmitterParams(NamedTuple):
    """Static parameters of an artificial emitter run (one emitter antenna
    model per batch; calculate_sim_efield_for_emitter, simulation.py:299-460).

    In emitter mode the ShowerBatch fields are reinterpreted: ``vertices`` are
    emitter positions, ``energies`` the pulser amplitudes, ``k_L`` the
    emitter frequency (cw/tone_burst) and ``vertex_times`` the emitter times.
    """

    model: str                 # emitter signal model (ops.emitter)
    templates: jnp.ndarray     # [3, F_int] emitting-antenna VEL templates
    rot: jnp.ndarray           # [3, 3]
    kind: int
    half_width: float = 5.0
    # measured-waveform models (idl1/hvsp1/ARA02/rno_cal5C_*): the unit-
    # amplitude voltage spectrum, precomputed on the host (the waveform is
    # normalized so amplitude scales it linearly, emitter.py:121-152);
    # numpy, [F_int] complex. None for analytic models.
    unit_spec: Optional[np.ndarray] = None
    # efield_idl1_spice (emitter.py:159-250): measured per-launch-angle
    # (eTheta, ePhi) unit spectra — the device gathers the nearest angle
    # row per (shower, channel, ray) launch direction. numpy:
    # angles [A] radians ascending, specs [A, 2, F_int] complex.
    spice_angles: Optional[np.ndarray] = None
    spice_specs: Optional[np.ndarray] = None


def _eval_trigger(t: TriggerSettings, channel_traces, chan_spec, base_t0,
                  s: PipelineSettings, ch: ChannelParams, real_dtype):
    """Evaluate one named trigger on the assembled channel traces.

    Returns (triggered [G] bool, trigger_time [G]). ``channel_traces`` is
    [G, C, n_base]; ``chan_spec`` the matching filtered rFFT spectrum (used by
    the matmul-lowered phased-array resample chain).
    """
    dt = s.dt
    sel = np.asarray(t.channels, dtype=int) if len(t.channels) else None

    if t.trigger_type in ("high_low", "simple_threshold"):
        tr = channel_traces if sel is None else channel_traces[:, sel, :]
        if t.threshold_high is not None:
            th_hi = jnp.asarray(t.threshold_high, real_dtype)
        elif sel is None:
            th_hi = ch.threshold_high[None, :, None]
        else:
            th_hi = jnp.asarray(ch.threshold_high)[None, sel, None]
        if t.trigger_type == "high_low":
            if t.threshold_low is not None:
                th_lo = jnp.asarray(t.threshold_low, real_dtype)
            elif sel is None:
                th_lo = ch.threshold_low[None, :, None]
            else:
                th_lo = jnp.asarray(ch.threshold_low)[None, sel, None]
            tts = triggers.get_high_low_triggers(
                tr, th_hi, th_lo, t.highlow_coincidence, dt)
        else:
            tts = triggers.get_threshold_triggers(tr, th_hi)
        triggered, _, first_bin = triggers.majority_logic(
            tts, t.number_of_coincidences, t.channel_coincidence, dt)
        return triggered, base_t0 + first_bin * dt

    if t.trigger_type == "phased_array":
        # beamformed power-integration trigger (phasedArrayTrigger semantics):
        # optional trigger-ADC digitization, FFT upsampling, static integer
        # beam delays, sliding power sums
        tr = channel_traces if sel is None else channel_traces[:, sel, :]
        spec = chan_spec if sel is None else chan_spec[:, sel, :]
        fs_pa = s.sampling_rate
        n_pa = s.n_base
        if t.pa_digitize:
            # resample to 5 GHz then decimate to the ADC rate by integer
            # stride (exact equivalent of the reference's linear-interp
            # downsampling when the rates divide, get_digital_trace:348-360)
            fs_hi = 5.0
            n_hi = int(round(s.n_base * fs_hi / s.sampling_rate))
            decim = int(round(fs_hi / t.pa_adc_fs))
            if s.trigger_irfft == "matmul":
                # upsample + stride-decimate fused into ONE [F_base, n_dec]
                # matmul straight from the (already computed) filtered
                # spectrum: zero-padding the spectrum == irfft(spec, n=n_hi),
                # and the stride just selects irfft-matrix columns
                Dd_r, Dd_i = _decimating_irfft_matrices(s.n_base, n_hi, decim)
                scale = fs_hi / np.sqrt(2.0)
                tr = (jnp.einsum("gcf,fn->gcn",
                                 spec.real.astype(real_dtype),
                                 jnp.asarray(Dd_r, real_dtype),
                                 precision=DFT_PRECISION)
                      + jnp.einsum("gcf,fn->gcn",
                                   spec.imag.astype(real_dtype),
                                   jnp.asarray(Dd_i, real_dtype),
                                   precision=DFT_PRECISION)) * scale
            else:
                spec_hi = trace_ops.resample_spectrum(
                    fft.time2freq(tr, s.sampling_rate), s.n_base, n_hi)
                tr_hi = fft.freq2time(spec_hi, fs_hi, n=n_hi)
                tr = tr_hi[..., ::decim]
            fs_pa = t.pa_adc_fs
            n_pa = tr.shape[-1]
            from nuradiomc_tpu.ops import adc as adc_ops
            tr = adc_ops.perfect_floor_comparator(
                tr, t.pa_adc_nbits, (-t.pa_adc_range / 2, t.pa_adc_range / 2))
        if t.pa_upsampling > 1:
            if s.trigger_irfft == "matmul":
                # rfft -> zero-pad -> irfft is linear in the trace: one
                # [n_pa, n_pa*up] matmul on the quantized trace
                U = _fft_upsample_matrix(n_pa, int(t.pa_upsampling))
                tr = jnp.einsum("gcn,nm->gcm", tr.astype(real_dtype),
                                jnp.asarray(U, real_dtype),
                                precision=DFT_PRECISION)
                fs_pa = fs_pa * t.pa_upsampling
                n_pa = n_pa * t.pa_upsampling
            else:
                spec_pa = fft.time2freq(tr, fs_pa)
                spec_pa = trace_ops.resample_spectrum(spec_pa, n_pa,
                                                      n_pa * t.pa_upsampling)
                fs_pa = fs_pa * t.pa_upsampling
                n_pa = n_pa * t.pa_upsampling
                tr = fft.freq2time(spec_pa, fs_pa, n=n_pa)
        rolls = np.asarray(t.pa_rolls, dtype=int)
        triggered, frame, _, _ = phased_array.phased_power_trigger(
            tr, rolls, t.pa_threshold, t.pa_window, t.pa_step)
        return triggered, base_t0 + frame * t.pa_step / fs_pa

    raise NotImplementedError(t.trigger_type)


def place_spectra(volt_spec, place_valid, offset, D_r, D_i, df_base,
                  real_dtype):
    """Channel spectra [G, C, F_base] of one readout window.

    Every in-window pulse spectrum of ``volt_spec`` [G, S, C, R, F_int] is
    zero-padded onto the base grid by the placement DFT (``D_r``/``D_i``
    from ``_placement_matrices``, possibly cut to their first K_int rows:
    the rows beyond are dropped), delayed by its ``offset`` [G, S, C, R]
    and summed over showers and rays. The named scope lets a profiler
    trace attribute device time to this stage.
    """
    F_base = D_r.shape[1]
    K_int = D_r.shape[0]
    ctype = D_r.dtype
    with jax.named_scope("placement"):
        V = jnp.where(place_valid[..., None], volt_spec, 0.0)
        Vb = V[..., :K_int]                                 # [G,S,C,R,K]
        Xb = (jnp.einsum("gscrf,fk->gscrk", Vb.real.astype(real_dtype),
                         D_r, precision=DFT_PRECISION)
              + jnp.einsum("gscrf,fk->gscrk", Vb.imag.astype(real_dtype),
                           D_i, precision=DFT_PRECISION))
        # factored phase ramp: the rFFT grid is uniform, so the per-bin
        # sincos chain reduces to two small per-row tables + complex
        # multiplies
        ph = trace_ops.time_shift_phase_uniform(F_base, df_base, offset)
        return jnp.sum(Xb * ph.astype(ctype), axis=(1, 3))   # [G,C,Fb]


@jax.named_scope("trigger_irfft")
def spectrum_to_trace(spec, s: PipelineSettings, real_dtype, k=None):
    """Time traces [..., n_base] of base-grid spectra [..., F_base].

    ``s.trigger_irfft == "matmul"`` lowers the irfft to two dense real
    matmuls over the first ``k`` frequency rows (band-limited compute: the
    rows beyond are dropped); ``"fft"`` is XLA's FFT over all rows.
    """
    F_base = s.n_base // 2 + 1
    k = F_base if k is None else k
    if s.trigger_irfft == "matmul":
        I_r, I_i = _irfft_matrices(s.n_base)
        if k < F_base:
            spec = spec[..., :k]
            I_r, I_i = I_r[:k], I_i[:k]
        mm_dtype = (jnp.bfloat16 if s.matmul_dtype == "bfloat16"
                    and real_dtype == jnp.float32 else real_dtype)
        scale = s.sampling_rate / np.sqrt(2.0)
        return (jnp.einsum("...f,fn->...n", spec.real.astype(mm_dtype),
                           jnp.asarray(I_r, mm_dtype),
                           precision=DFT_PRECISION,
                           preferred_element_type=real_dtype)
                + jnp.einsum("...f,fn->...n", spec.imag.astype(mm_dtype),
                             jnp.asarray(I_i, mm_dtype),
                             precision=DFT_PRECISION,
                             preferred_element_type=real_dtype)) * scale
    return fft.freq2time(spec, s.sampling_rate, n=s.n_base)


def _stop_output(live, G, S, C, n_rays, real_dtype):
    """Dummy PipelineOutput for the stop-after profiling ladder: reduces
    every live array into `triggered` so nothing computed so far is DCE'd,
    everything downstream is."""
    acc = jnp.zeros((G,), real_dtype)
    for a in live:
        if a is None:
            continue
        a = a.astype(real_dtype) if a.dtype != real_dtype else a
        acc = acc + (a if a.ndim == 1 else jnp.sum(a.reshape(G, -1), axis=-1))
    trig = acc != 0
    z4 = jnp.zeros((G, S, C, n_rays), real_dtype)
    z43 = jnp.zeros((G, S, C, n_rays, 3), real_dtype)
    return PipelineOutput(
        triggered=trig, candidate=trig, max_efield=acc, trigger_time=acc,
        max_amplitude=jnp.zeros((G, C), real_dtype), traces=None,
        base_t0=acc, sol_mask=z4 > 0, c0=z4, c1=z4,
        sol_type=jnp.zeros((G, S, C, n_rays), jnp.int32),
        travel_time=z4, path_length=z4, launch_vector=z43,
        receive_vector=z43, polarization=z43, viewing_angle=z4,
        max_amp_per_solution=z4, focusing=z4)


def simulate_batch(batch: ShowerBatch, ch: ChannelParams, s: PipelineSettings,
                   noise_key: Optional[jnp.ndarray] = None,
                   keep_traces: bool = False,
                   keep_efields: bool = False,
                   emitter: Optional[EmitterParams] = None,
                   arz_library=None) -> PipelineOutput:
    """Run the full chain on a padded batch. jit/pjit over the G axis.

    ``arz_library`` (ops.arz.ShowerLibrary) is required when
    settings.askaryan_model is ARZ2019/ARZ2020; the per-shower profile pick
    comes from batch.profile_idx (pre-drawn on the host and persisted, like
    the reference's shower_realization_ARZ, simulation.py:221-226).
    """
    G, S = batch.energies.shape
    C = ch.positions.shape[0]
    dt = s.dt
    ff_int = s.freqs_internal
    real_dtype = batch.vertices.dtype

    # ---- 1. ray tracing [G,S,C] pairs, 2 solution slots ---------------------
    x1 = batch.vertices[:, :, None, :]                      # [G,S,1,3]
    x2 = jnp.broadcast_to(ch.positions[None, None, :, :], (G, S, C, 3))
    geom = raytrace.to_2d(jnp.broadcast_to(x1, (G, S, C, 3)), x2)

    flat = lambda a: a.reshape(-1)

    def _solve(a, b, c, d):
        if s.n_reflections > 0:
            return raytrace.find_solutions_all(
                a, b, c, d, s.ice, n_reflections=s.n_reflections,
                n_bisect=s.n_bisect)
        return raytrace.find_solutions(a, b, c, d, s.ice,
                                       n_bisect=s.n_bisect)

    sols_flat = jax.vmap(_solve)(
        flat(geom.x1y), flat(geom.x1z), flat(geom.x2y), flat(geom.x2z))
    sols = jax.tree.map(lambda a: a.reshape(G, S, C, *a.shape[1:]), sols_flat)
    n_rays = sols.c0.shape[-1]                      # 2 + 4*n_reflections

    launch, receive = raytrace.launch_receive_vectors(geom, sols)  # [G,S,C,R,3]

    if s.stop_after == "ray":
        return _stop_output(
            (sols.c0, sols.c1, sols.travel_time, sols.path_length,
             sols.mask, launch, receive), G, S, C, n_rays, real_dtype)

    # ---- 2. viewing angle + delta_C cut ------------------------------------
    n_vertex = s.ice.index_of_refraction(batch.vertices[..., 2])   # [G,S]
    cherenkov = jnp.arccos(1.0 / n_vertex)                         # [G,S]
    cos_view = jnp.sum(batch.prop_dir[:, :, None, None, :] * launch, axis=-1)
    viewing_angle = jnp.arccos(jnp.clip(cos_view, -1.0, 1.0))      # [G,S,C,2]
    delta_C = viewing_angle - cherenkov[:, :, None, None]

    bshape = (G, S, C, n_rays)
    R_safe = jnp.where(sols.path_length > 1.0, sols.path_length, 1.0)

    if s.distance_cut:
        # skip shower-channel pairs whose vertex distance exceeds the
        # energy-dependent polynomial cut (simulation.py:1399-1409 with the
        # 100 m floor; calculate_sim_efield:126-161): the energy entering
        # the polynomial is the SUM over the group's showers whose distance
        # from shower 0 is within distance_cut_sum_length of this shower's
        # (simulation.py:157-160)
        vd = jnp.linalg.norm(
            batch.vertices - batch.vertices[:, :1, :], axis=-1)   # [G,S]
        near = (jnp.abs(vd[:, None, :] - vd[:, :, None])
                < s.distance_cut_sum_length)                      # [G,S_i,S_j]
        near = near & batch.shower_mask[:, None, :]
        e_sum = jnp.sum(jnp.where(near, batch.energies[:, None, :], 0.0),
                        axis=-1)                                  # [G,S]
        log10_E = jnp.log10(jnp.maximum(e_sum, 1.0))
        coeffs = jnp.asarray(s.distance_cut_coefficients)
        log10_dmax = (coeffs[0] + coeffs[1] * log10_E
                      + coeffs[2] * log10_E ** 2 + coeffs[3] * log10_E ** 3)
        # max(100 m, ...) floor; non-positive energy sums also fall back to
        # the floor (get_distance_cut, simulation.py:1404-1407)
        d_max = jnp.maximum(10.0 ** log10_dmax, 100.0)           # [G,S]
        dist = jnp.linalg.norm(
            batch.vertices[:, :, None, :] - ch.positions[None, None, :, :],
            axis=-1)                                             # [G,S,C]
        distance_ok = (dist <= d_max[:, :, None])[..., None]     # [G,S,C,1]
        sols = sols._replace(mask=sols.mask & distance_ok)

    # scalar-factoring fast path: polarization/Fresnel/focusing are scalars
    # per (shower, channel, ray) for ALL shower Askaryan models — the
    # orchestrator reduces even the semi-MC ARZ trace to a scalar spectrum
    # (askaryan.py:128 keeps only get_time_trace(...)[1]) — so they factor
    # out of every [.., F]-sized op. Not applicable when the efield has
    # independent 3-component structure (emitter efield models) or must be
    # materialized (birefringence segments mix pols; keep_efields output).
    factored = (emitter is None
                and not s.birefringence and not keep_efields
                # tabulated VEL is frequency-dependent per direction, so the
                # scalar-mixing factorization does not apply
                and ch.antenna_table is None)

    if emitter is None:
        valid = (sols.mask
                 & (jnp.abs(delta_C) <= s.delta_C_cut)
                 & batch.shower_mask[:, :, None, None])            # [G,S,C,2]

        if s.askaryan_model in ("ARZ2019", "ARZ2020"):
            # ---- 3. ARZ semi-analytic model ------------------------------
            # The production orchestrator uses only the eTheta component of
            # the semi-MC trace as a SCALAR spectrum (askaryan.py:128 takes
            # ARZ.get_time_trace(...)[1]) and outer-products it with the
            # geometric polarization vector below (simulation.py:244-246) —
            # exactly like the parametrized models.
            from nuradiomc_tpu.ops import arz as arz_ops

            if arz_library is None or batch.profile_idx is None:
                raise ValueError(
                    "ARZ models require arz_library and batch.profile_idx")

            def arz_one(E, view, em, n_idx, R, ip):
                ce = arz_ops.select_profile(arz_library, E, em, ip)
                tr = arz_ops.get_time_trace(E, view, s.n_internal, dt,
                                            arz_library.depth, ce, em, n_idx,
                                            R, version=s.askaryan_model)
                return fft.time2freq(tr[1], s.sampling_rate)       # (F,)

            spec = jax.vmap(arz_one)(
                flat(jnp.broadcast_to(batch.energies[:, :, None, None], bshape)),
                flat(viewing_angle),
                flat(jnp.broadcast_to(batch.is_em[:, :, None, None], bshape)),
                flat(jnp.broadcast_to(n_vertex[:, :, None, None], bshape)),
                flat(R_safe),
                flat(jnp.broadcast_to(batch.profile_idx[:, :, None, None], bshape)),
            ).reshape(*bshape, -1)                                 # [G,S,C,2,F]
        else:
            # ---- 3. Askaryan spectrum per (G,S,C,2) ------------------------
            def spec_one(E, view, em, n_idx, R, kl):
                return askaryan.get_frequency_spectrum(
                    E, view, s.n_internal, dt, em, n_idx, R, s.askaryan_model, k_L=kl)

            spec = jax.vmap(spec_one)(
                flat(jnp.broadcast_to(batch.energies[:, :, None, None], bshape)),
                flat(viewing_angle),
                flat(jnp.broadcast_to(batch.is_em[:, :, None, None], bshape)),
                flat(jnp.broadcast_to(n_vertex[:, :, None, None], bshape)),
                flat(R_safe),
                flat(jnp.broadcast_to(batch.k_L[:, :, None, None], bshape)),
            ).reshape(*bshape, -1)                                 # [G,S,C,2,F]

        if s.stop_after == "spec":
            return _stop_output((spec.real, spec.imag), G, S, C, n_rays,
                                real_dtype)

        # ---- 4. polarization (on-sky at the vertex, simulation.py:798-829) -
        axis = batch.prop_dir[:, :, None, None, :]
        pol = jnp.cross(launch, jnp.cross(axis, launch))
        pol = pol / jnp.maximum(jnp.linalg.norm(pol, axis=-1, keepdims=True), 1e-30)
        zen_l, az_l = geometry.cartesian_to_spherical(launch)
        pol_onsky = geometry.ground_to_onsky(pol, zen_l, az_l)     # [G,S,C,2,3]

        if factored:
            # the polarization split is a SCALAR per path: defer it (and
            # every other scalar propagation factor) so only ONE full-size
            # multiply (spec * attenuation) ever materializes — the
            # elementwise chain on [G,S,C,2,F] arrays dominates the step
            # otherwise (~30 ms of 73 at the bench shape, memory-bound)
            e_theta = e_phi = None
        else:
            e_theta = pol_onsky[..., 1:2] * spec                   # [G,S,C,2,F]
            e_phi = pol_onsky[..., 2:3] * spec
    else:
        # emitter mode: pulser voltage spectrum folded with the emitting
        # antenna response at the launch direction:
        # E = VEL * (-i) * V(f) * f * n / c / R (simulation.py:401-424)
        from nuradiomc_tpu.ops import emitter as emitter_ops
        from nuradiomc_tpu.utils.constants import speed_of_light

        valid = sols.mask & batch.shower_mask[:, :, None, None]

        if emitter.model == "efield_idl1_spice":
            # measured SPICE pulser efields keyed by launch zenith
            # (emitter.py:159-250): gather the nearest-angle unit spectrum
            # per (shower, channel, ray) and scale by the event amplitude;
            # only the 1/R spreading applies (efield model — no antenna)
            zen_sp, _ = geometry.cartesian_to_spherical(launch)  # [G,S,C,2]
            ang = jnp.asarray(emitter.spice_angles)              # [A]
            idx = jnp.argmin(jnp.abs(zen_sp[..., None] - ang), axis=-1)
            sp = jnp.asarray(emitter.spice_specs)[idx]    # [G,S,C,2,2,F]
            amp_b = batch.energies[:, :, None, None, None]
            e_theta = amp_b * sp[..., 0, :] / R_safe[..., None]
            e_phi = amp_b * sp[..., 1, :] / R_safe[..., None]
        elif emitter.model.startswith("efield_"):
            # efield emitter models produce (eR, eTheta, ePhi) directly —
            # no emitting antenna, no -i f n/c factor; only the 1/R
            # spreading is applied here (simulation.py:388-400, 421-423)
            pol = (batch.emitter_polarization
                   if batch.emitter_polarization is not None
                   else jnp.full_like(batch.energies, 0.5))
            spec3 = jax.vmap(
                lambda amp, p: emitter_ops.get_frequency_spectrum(
                    amp, s.n_internal, dt, emitter.model, polarization=p,
                    half_width=emitter.half_width))(
                flat(jnp.broadcast_to(batch.energies[:, :, None, None],
                                      bshape)),
                flat(jnp.broadcast_to(pol[:, :, None, None], bshape)),
            ).reshape(*bshape, 3, -1)
            e_theta = spec3[..., 1, :] / R_safe[..., None]
            e_phi = spec3[..., 2, :] / R_safe[..., None]
        else:
            if emitter.unit_spec is not None:
                # measured waveform: per-row amplitude x static unit spectrum
                vspec = (batch.energies[:, :, None, None, None]
                         * jnp.asarray(emitter.unit_spec))
                vspec = jnp.broadcast_to(vspec, (*bshape, vspec.shape[-1]))
            else:
                vspec = jax.vmap(lambda amp, fq: emitter_ops.get_frequency_spectrum(
                    amp, s.n_internal, dt, emitter.model,
                    emitter_frequency=fq, half_width=emitter.half_width))(
                    flat(jnp.broadcast_to(batch.energies[:, :, None, None], bshape)),
                    flat(jnp.broadcast_to(batch.k_L[:, :, None, None], bshape)),
                ).reshape(*bshape, -1)

            zen_l, az_l = geometry.cartesian_to_spherical(launch)
            # templates/rot are host numpy constants — the LPDA sector
            # gather needs a device array
            em_tpl = jnp.asarray(emitter.templates)
            em_rot = jnp.asarray(emitter.rot)
            vel_t, vel_p = jax.vmap(lambda z, a: antenna.analytic_vel(
                z, a, em_rot, em_tpl, emitter.kind))(
                flat(zen_l), flat(az_l))
            vel_t = vel_t.reshape(*bshape, -1)
            vel_p = vel_p.reshape(*bshape, -1)

            deriv = ((-1j) * ff_int[None, None, None, None, :]
                     * n_vertex[:, :, None, None, None] / speed_of_light)
            e_theta = vel_t * vspec * deriv / R_safe[..., None]
            e_phi = vel_p * vspec * deriv / R_safe[..., None]
        pol_onsky = jnp.zeros((*bshape, 3), dtype=real_dtype)

    # ---- 5. propagation effects --------------------------------------------
    att_vals = att_W = None
    if s.attenuate_ice:
        att_vals, att_W = _attenuation_sparse_values(sols, geom, s)
        if s.stop_after == "attquad":
            return _stop_output((spec.real, spec.imag, att_vals),
                                G, S, C, n_rays, real_dtype)
        full = jnp.einsum(
            "ps,sf->pf", att_vals.reshape(-1, att_vals.shape[-1]),
            jnp.asarray(att_W, att_vals.dtype), precision=_INTERP_PRECISION)
        att = jnp.where(ff_int > 0, full, 1.0).reshape(
            *att_vals.shape[:-1], -1)                              # [G,S,C,2,F]
        if factored:
            spec_att = spec * att
        else:
            e_theta = e_theta * att
            e_phi = e_phi * att
    elif factored:
        spec_att = spec

    # surface-reflection Fresnel coefficients, one factor per surface touch
    # (apply_propagation_effects, analyticraytracing.py:2967-3007; all
    # touches of a slot share the same C0 hence the same angle). For the
    # base 2-slot solver this reduces to exactly one factor on reflected
    # rays; bottom-bounce slots can touch the surface up to r+1 times.
    n_surf = s.ice.index_of_refraction(jnp.asarray(-1e-5, real_dtype))
    refl_zenith = jnp.arctan(1.0 / jnp.sqrt(jnp.maximum(
        sols.c0 ** 2 * n_surf ** 2 - 1.0, 1e-12)))                 # [G,S,C,R]
    r_p = geometry.fresnel_r_p(refl_zenith, n_2=1.0, n_1=n_surf)
    r_s = geometry.fresnel_r_s(refl_zenith, n_2=1.0, n_1=n_surf)
    one_c = jnp.ones((), dtype=r_p.dtype)
    z_turn_slots = raytrace.turning_depth(sols.c0, s.ice)
    n_touch = raytrace.surface_touches_slots(
        sols.sol_type, sols.reflection, sols.refl_case, z_turn_slots)
    a_p = jnp.ones_like(r_p)
    a_s = jnp.ones_like(r_s)
    for k in range(s.n_reflections + 1):
        a_p = jnp.where(n_touch > k, a_p * r_p, a_p)
        a_s = jnp.where(n_touch > k, a_s * r_s, a_s)
    if s.n_reflections > 0:
        # bottom bounces: refl_coef * exp(i*phase) per bounce, both
        # components equally (apply_propagation_effects:3004-3011)
        b1 = jnp.asarray(
            s.ice.refl_coef * np.exp(1j * s.ice.refl_phase_shift),
            a_p.dtype)
        for k in range(s.n_reflections):
            bounce = sols.reflection > k
            a_p = jnp.where(bounce, a_p * b1, a_p)
            a_s = jnp.where(bounce, a_s * b1, a_s)
    if not factored:
        e_theta = e_theta * a_p[..., None]
        e_phi = e_phi * a_s[..., None]

    if s.apply_focusing:
        # Focusing from the launch-angle convergence toward a displaced
        # receiver (get_focusing, analyticraytracing.py:2778-2888 — the
        # simulation default).  "implicit" (default) evaluates the exact
        # dz->0 derivative by implicit differentiation at the solved root —
        # one gradient pass instead of a second full bisection solve;
        # "numeric" keeps the reference's finite-difference re-solve.
        lau_ang = jnp.arccos(jnp.clip(launch[..., 2], -1.0, 1.0))
        rec_ang = jnp.arccos(jnp.clip(-receive[..., 2], -1.0, 1.0))

        if s.focusing_mode == "implicit" and s.n_reflections == 0:
            d_launch_dz = raytrace.focusing_dtheta_dz(geom, sols, s.ice)
            foc_valid = sols.mask
        else:
            # bottom-bounce slots always use the displaced-receiver re-solve
            # (slot ordering of find_solutions_all is stable, so slots of
            # the displaced problem align 1:1)
            dz = jnp.asarray(s.focusing_dz, real_dtype)
            x1z_d = jnp.where(geom.swapped, geom.x1z + dz, geom.x1z)
            x2z_d = jnp.where(geom.swapped, geom.x2z, geom.x2z + dz)
            sols1_flat = jax.vmap(_solve)(
                flat(geom.x1y), flat(x1z_d), flat(geom.x2y), flat(x2z_d))
            sols1 = jax.tree.map(lambda a: a.reshape(G, S, C, *a.shape[1:]), sols1_flat)
            geom_d = raytrace.Geometry2D(geom.x1y, x1z_d, geom.x2y, x2z_d,
                                         geom.swapped, geom.dphi, geom.ux, geom.uy)
            launch1, _ = raytrace.launch_receive_vectors(geom_d, sols1)
            lau_ang1 = jnp.arccos(jnp.clip(launch1[..., 2], -1.0, 1.0))
            d_launch_dz = jnp.abs(lau_ang1 - lau_ang) / jnp.abs(dz)
            foc_valid = sols1.mask & sols.mask

        r_h = jnp.abs(geom.x2y - geom.x1y)[..., None]
        dist = jnp.maximum(sols.path_length, 1.0)
        foc = jnp.sqrt(dist / jnp.maximum(jnp.sin(rec_ang), 1e-6) * d_launch_dz)
        foc = foc * jnp.sqrt(dist * jnp.sin(lau_ang) / jnp.maximum(r_h, 1e-6))
        foc = jnp.where(foc_valid, foc, 1.0)
        foc = jnp.minimum(foc, s.focusing_limit)
        # refractive-index correction between emitter and receiver
        n1 = s.ice.index_of_refraction(batch.vertices[..., 2])[:, :, None, None]
        n2 = s.ice.index_of_refraction(ch.positions[:, 2])[None, None, :, None]
        foc = foc * jnp.sqrt(n1 / n2)
        if not factored:
            e_theta = e_theta * foc[..., None]
            e_phi = e_phi * foc[..., None]
    else:
        foc = jnp.ones(bshape, dtype=real_dtype)

    if s.birefringence:
        # birefringent eigenbasis propagation, applied LAST like the
        # reference (apply_propagation_effects:3020-3030); fixed-K path
        # sampling keeps the shape static under jit
        from nuradiomc_tpu.ops import birefringence as bire_ops

        def bire_one(st, sp, c0, x1y, x1z, x2y, x2z, swapped, dphi, ux, uy):
            g = raytrace.Geometry2D(x1y, x1z, x2y, x2z, swapped, dphi, ux, uy)
            path = bire_ops.path_points_3d(
                c0, g, s.ice, s.birefringence_points,
                iceflow_angle=s.birefringence_iceflow)
            return bire_ops.propagate_pulse(st, sp, path, ff_int, s.ice,
                                            s.birefringence_model)

        F = e_theta.shape[-1]
        bcast = lambda a: flat(jnp.broadcast_to(a[..., None], bshape))
        bt, bp = jax.vmap(bire_one)(
            e_theta.reshape(-1, F), e_phi.reshape(-1, F), flat(sols.c0),
            bcast(geom.x1y), bcast(geom.x1z), bcast(geom.x2y), bcast(geom.x2z),
            bcast(geom.swapped), bcast(geom.dphi), bcast(geom.ux), bcast(geom.uy))
        e_theta = jnp.where(valid[..., None], bt.reshape(e_theta.shape), e_theta)
        e_phi = jnp.where(valid[..., None], bp.reshape(e_phi.shape), e_phi)

    # candidate cut: a group is only simulated/triggered if at least one
    # efield exceeds min_efield_amplitude (simulation.py:283-286, speedup
    # min_efield_amplitude; the reference skips such stations entirely)
    cut_statically_off = isinstance(ch.min_efield_amplitude, np.ndarray) \
        and bool(np.all(ch.min_efield_amplitude <= 0))
    if cut_statically_off:
        # candidate cut disabled: skip the efield time-domain round trip
        # entirely (only when ChannelParams leaves are host numpy — under a
        # jit-traced ChannelParams the dynamic path below is used)
        ef_max = jnp.zeros(bshape, dtype=real_dtype)
        candidate = jnp.ones((G,), dtype=bool)
    else:
        if factored:
            amp_t_c = (pol_onsky[..., 1] * foc).astype(a_p.dtype) * a_p
            amp_p_c = (pol_onsky[..., 2] * foc).astype(a_s.dtype) * a_s
            ef_traces = fft.freq2time(
                jnp.stack([amp_t_c[..., None] * spec_att,
                           amp_p_c[..., None] * spec_att]),
                s.sampling_rate, n=s.n_internal)
        else:
            ef_traces = fft.freq2time(jnp.stack([e_theta, e_phi]),
                                      s.sampling_rate, n=s.n_internal)
        ef_max = jnp.max(jnp.abs(ef_traces), axis=(0, -1))      # [G,S,C,2]
        ef_max = jnp.where(valid, ef_max, 0.0)
        candidate = jnp.any(
            ef_max > ch.min_efield_amplitude[None, None, :, None],
            axis=(1, 2, 3))                                      # [G]
        candidate = candidate | jnp.all(ch.min_efield_amplitude <= 0)

    # ---- 6. antenna response (VEL dot product) -----------------------------
    zen_r, az_r = geometry.cartesian_to_spherical(receive)         # [G,S,C,2]

    if ch.antenna_table is not None:
        # tabulated patterns: trilinear complex interpolation of the pickled
        # grids at every receive direction (antennapattern.py:1426-1580 +
        # on-sky rotation :1246-1307); static per-channel loop (C is small)
        tab = ch.antenna_table
        vel_t_ch, vel_p_ch = [], []
        for ci in range(C):
            table_ci = antenna.AntennaTable(
                freqs=tab.freqs, thetas=tab.thetas, phis=tab.phis,
                h_theta=tab.h_theta[ci], h_phi=tab.h_phi[ci])
            rot_ci = ch.rot[ci]
            vt, vp = jax.vmap(lambda z, a: antenna.table_vel(
                z, a, rot_ci, table_ci, ff_int))(
                zen_r[:, :, ci].reshape(-1), az_r[:, :, ci].reshape(-1))
            vel_t_ch.append(vt.reshape(G, S, 2, -1))
            vel_p_ch.append(vp.reshape(G, S, 2, -1))
        vel_t = jnp.stack(vel_t_ch, axis=2)                        # [G,S,C,2,F]
        vel_p = jnp.stack(vel_p_ch, axis=2)
    else:
        # frequency-independent mixing factors per element, then ONE gather
        # of the small [C, n_sector, F] templates (avoids materializing a
        # [G,S,C,2,n_sector,F] broadcast of the templates)
        rot_b = jnp.broadcast_to(ch.rot[None, None, :, None, :, :], (*bshape, 3, 3))
        kind_b = jnp.broadcast_to(ch.kind[None, None, :, None], bshape)
        mix_t, mix_p, sector = jax.vmap(antenna.analytic_vel_mix)(
            flat(zen_r), flat(az_r), rot_b.reshape(-1, 3, 3), flat(kind_b))
        mix_t = mix_t.reshape(bshape)
        mix_p = mix_p.reshape(bshape)
        sector = sector.reshape(bshape)
        c_idx = jnp.broadcast_to(jnp.arange(C)[None, None, :, None], bshape)
        T = jnp.asarray(ch.templates)[c_idx, sector]               # [G,S,C,2,F]
        if not factored:
            vel_t = T * mix_t[..., None]
            vel_p = T * mix_p[..., None]

    if factored:
        # volt = T*mix_t*(pol_t*foc*a_p)*spec_att + T*mix_p*(...)*spec_att
        #      = T * combined_scalar * spec_att        (one fused chain)
        amp_t_c = (pol_onsky[..., 1] * foc).astype(a_p.dtype) * a_p
        amp_p_c = (pol_onsky[..., 2] * foc).astype(a_s.dtype) * a_s
        combined = mix_t.astype(a_p.dtype) * amp_t_c             + mix_p.astype(a_s.dtype) * amp_p_c       # [G,S,C,2] complex
        if s.stop_after == "scalars":
            return _stop_output(
                (spec.real, spec.imag, att_vals, combined.real,
                 combined.imag, candidate), G, S, C, n_rays, real_dtype)
        volt_spec = T * combined[..., None] * spec_att
    else:
        volt_spec = vel_t * e_theta + vel_p * e_phi                # [G,S,C,2,F]
    volt_spec = jnp.where(valid[..., None], volt_spec, 0.0)

    # remove DC (< 5 MHz, efieldToVoltageConverter.py:313)
    volt_spec = jnp.where(ff_int < 5e-3, 0.0, volt_spec)

    # per-solution max amplitude after the filter chain (the reference runs
    # the filter/amp chain on each per-efield SimChannel before measuring
    # amplitudes, simulation.py:465-527 + channelSignalReconstructor)
    sol_spec_filtered = volt_spec * ch.filter_response_int[None, None, :, None, :]
    # ... and the observable is the Hilbert-envelope maximum
    # (simulation._calculate_amp_per_ray_solution:1868-1886); computed
    # straight from the spectrum (one complex ifft, no time-domain round trip)
    max_amp_sol = jnp.max(trace_ops.hilbert_envelope_from_rfft(
        sol_spec_filtered, s.n_internal, s.sampling_rate), axis=-1)

    # ---- 7. placement into the common time base ----------------------------
    # trace start: center of trace = vertex time + travel time (simulation.py:262-272)
    t_start = (batch.vertex_times[:, :, None, None] + sols.travel_time
               - 0.5 * s.n_internal * dt + ch.cable_delays[None, None, :, None])
    big = jnp.asarray(1e30, real_dtype)
    any_valid = jnp.any(valid, axis=(1, 2, 3))
    cap = (s.n_base - s.n_internal) * dt

    ctype = jnp.complex64 if real_dtype == jnp.float32 else jnp.complex128
    D_r, D_i = _placement_matrices(s.n_internal, s.n_base)
    # band-limited compute (band_limit_eps doc): the assembled spectrum is
    # only ever consumed through the channel filter chain, so efield-grid
    # rows beyond the chain's numerical support contribute O(eps); slice
    # them out of the placement DFT (its matmul K dim halves at the e2e
    # chains).
    F_int_full = s.n_internal // 2 + 1
    K_int = F_int_full
    if s.band_limit_eps > 0 and ch.trigger_filter_response is None:
        # (a separate trigger chain has no efield-grid response to take
        # the support union with — band limiting stays off there)
        K_int = _band_support((ch.filter_response_int,),
                              s.band_limit_eps, F_int_full)
        D_r = D_r[:K_int]
        D_i = D_i[:K_int]
    D_r = jnp.asarray(D_r, ctype)
    D_i = jnp.asarray(D_i, ctype)
    df_base = float(s.sampling_rate / s.n_base)
    F_base = s.n_base // 2 + 1
    # base-grid analogue of K_int: the trigger/trace irfft matmuls only see
    # the spectrum AFTER the filter multiply, so rows beyond the chain's
    # support are O(eps) there too. Kept full when traces are a requested
    # output (user-visible waveforms stay exact).
    K_base = F_base
    K_trig = F_base
    if s.band_limit_eps > 0 and not keep_traces:
        K_base = _band_support((ch.filter_response,), s.band_limit_eps,
                               F_base)
        K_trig = (_band_support((ch.trigger_filter_response,),
                                s.band_limit_eps, F_base)
                  if ch.trigger_filter_response is not None else K_base)

    if s.triggers:
        trig_list = s.triggers
    else:
        # legacy single-trigger fields
        trig_list = (TriggerSettings(
            trigger_type=s.trigger_type,
            highlow_coincidence=s.highlow_coincidence,
            number_of_coincidences=s.number_of_coincidences,
            channel_coincidence=s.channel_coincidence,
            pa_rolls=s.pa_rolls, pa_window=s.pa_window, pa_step=s.pa_step,
            pa_upsampling=s.pa_upsampling, pa_threshold=s.pa_threshold,
            pa_digitize=s.pa_digitize, pa_adc_fs=s.pa_adc_fs,
            pa_adc_nbits=s.pa_adc_nbits, pa_adc_range=s.pa_adc_range),)

    def _assemble_and_trigger(place_valid, offset, t0_w, key_w):
        """Place the in-window pulses, apply filters (+noise), run every
        declared trigger: ONE sub-event readout window."""
        chan_spec = place_spectra(volt_spec, place_valid, offset, D_r, D_i,
                                  df_base, real_dtype)

        if s.stop_after == "placement":
            return ("STOP", (chan_spec.real, chan_spec.imag))

        # ---- 8. filter chain (+ optional noise) ----------------------------
        if s.add_noise:
            if key_w is None:
                raise ValueError("add_noise=True requires a noise_key")
            keys = jax.random.split(key_w, G * C)
            # legacy uint32 keys are [n, 2]; typed (e.g. rbg) keys are [n]
            keys = keys.reshape(G, C, *keys.shape[1:])
            nyquist = s.sampling_rate / 2

            def noise_one(key, amp):
                return noise_ops.bandlimited_noise_spectrum(
                    key, s.n_base, s.sampling_rate, amp, None, nyquist,
                    type=s.noise_type, dtype=real_dtype,
                    sampler=s.noise_sampler)
            nspec = jax.vmap(jax.vmap(noise_one))(
                keys, jnp.broadcast_to(ch.noise_amplitude[None, :], (G, C)))
            chan_spec = chan_spec + nspec

        raw_spec = chan_spec
        chan_spec = raw_spec * ch.filter_response[None, :, :]

        if s.stop_after == "filter":
            return ("STOP", (chan_spec.real, chan_spec.imag))

        channel_traces = spectrum_to_trace(chan_spec, s, real_dtype, K_base)
        if ch.trigger_filter_response is not None:
            # distinct trigger-channel response: same pre-amp voltage +
            # noise, different signal chain (hardwareResponseIncorporator
            # trigger_channels semantics, RNO_G/hardwareResponseIncorporator
            # .py:191-229); trigger kernels read these traces only
            trig_spec = raw_spec * ch.trigger_filter_response[None, :, :]
            trigger_traces = spectrum_to_trace(trig_spec, s, real_dtype,
                                               K_trig)
        else:
            trig_spec = chan_spec
            trigger_traces = channel_traces

        # ---- 9. triggers (one kernel per declared named trigger) -----------
        # all declared triggers run on the SAME assembled traces; the
        # per-trigger kernel cost is trivial next to the propagation chain,
        # which is the point of multi-trigger one-pass orchestration
        cols, times = [], []
        for t in trig_list:
            trig_t, time_t = _eval_trigger(t, trigger_traces, trig_spec,
                                           t0_w, s, ch, real_dtype)
            cols.append(trig_t & any_valid & candidate)
            times.append(time_t)
        return cols, times, channel_traces, jnp.max(jnp.abs(channel_traces),
                                                    axis=-1)

    # ---- 7b. sub-event window loop (n_windows=1: single global window) ----
    remaining = valid
    per_window = []
    base_t0 = None
    traces0 = None
    max_amp_tr = None
    for w in range(max(1, s.n_windows)):
        any_rem = jnp.any(remaining, axis=(1, 2, 3))
        t0_w = jnp.min(jnp.where(remaining, t_start, big), axis=(1, 2, 3))
        t0_w = jnp.where(any_rem, t0_w, 0.0)
        offset = t_start - t0_w[:, None, None, None]
        in_w = remaining & (offset <= cap)
        key_w = (None if noise_key is None
                 else (noise_key if s.n_windows == 1
                       else jax.random.fold_in(noise_key, w)))
        res_w = _assemble_and_trigger(in_w, offset, t0_w, key_w)
        if isinstance(res_w[0], str):   # stop-after profiling ladder
            return _stop_output(res_w[1], G, S, C, n_rays, real_dtype)
        cols, times, traces_w, amp_w = res_w
        # a window with no pulses must not trigger (noise-only windows do
        # not exist in the reference: no sub-event is created without rays)
        cols = [c & any_rem for c in cols]
        per_window.append((cols, times))
        if w == 0:
            base_t0, traces0, max_amp_tr = t0_w, traces_w, amp_w
        else:
            max_amp_tr = jnp.maximum(max_amp_tr, amp_w)
        remaining = remaining & ~in_w

    # combine windows per trigger: requires-gating applies WITHIN each
    # sub-event (the reference gates set_not_triggered per station/event),
    # decisions OR across windows, trigger time = earliest fired window
    trig_cols, time_cols = [], []
    name_to_col = {t.name: i for i, t in enumerate(trig_list)}
    inf_t = jnp.asarray(jnp.inf, real_dtype)
    gated_per_window = []
    for w, (cols, times) in enumerate(per_window):
        gated = []
        for i, t in enumerate(trig_list):
            c = cols[i]
            if getattr(t, "requires", None):
                # set_not_triggered dependency: evaluated only when an
                # earlier named trigger fired (T02RunSimulation.py:42-61);
                # in the fused pass that is an AND with the prerequisite.
                if t.requires not in name_to_col or                         name_to_col[t.requires] >= i:
                    raise ValueError(
                        f"trigger {t.name!r} requires {t.requires!r}, which "
                        "must be declared earlier in the trigger list")
                c = c & gated[name_to_col[t.requires]]
            gated.append(c)
        gated_per_window.append(gated)
    for i in range(len(trig_list)):
        fired_w = [gated_per_window[w][i] for w in range(len(per_window))]
        times_w = [per_window[w][1][i] for w in range(len(per_window))]
        fired = fired_w[0]
        tmin = jnp.where(fired_w[0], times_w[0], inf_t)
        for w in range(1, len(per_window)):
            fired = fired | fired_w[w]
            tmin = jnp.minimum(tmin, jnp.where(fired_w[w], times_w[w], inf_t))
        trig_cols.append(fired)
        time_cols.append(jnp.where(fired, tmin, times_w[0]))
    channel_traces = traces0
    triggered_per = jnp.stack(trig_cols, axis=-1)           # [G, T]
    trigger_times_per = jnp.stack(time_cols, axis=-1)       # [G, T]
    triggered = jnp.any(triggered_per, axis=-1)
    # event trigger time = earliest among fired triggers
    # (output_writer_hdf5.py:381 min semantics)
    inf = jnp.asarray(jnp.inf, trigger_times_per.dtype)
    tt_masked = jnp.where(triggered_per, trigger_times_per, inf)
    trigger_time = jnp.where(triggered, jnp.min(tt_masked, axis=-1),
                             trigger_times_per[..., 0])

    return PipelineOutput(
        triggered=triggered,
        candidate=candidate & any_valid,
        triggered_per=triggered_per,
        trigger_times_per=trigger_times_per,
        max_efield=jnp.max(ef_max, axis=(1, 2, 3)),
        trigger_time=trigger_time,
        max_amplitude=max_amp_tr,
        traces=channel_traces if keep_traces else None,
        base_t0=base_t0,
        sol_mask=valid,
        c0=sols.c0, c1=sols.c1, sol_type=sols.sol_type,
        travel_time=sols.travel_time, path_length=sols.path_length,
        launch_vector=launch, receive_vector=receive,
        polarization=pol_onsky, viewing_angle=viewing_angle,
        max_amp_per_solution=max_amp_sol,
        focusing=foc,
        reflection=sols.reflection, refl_case=sols.refl_case,
        efields=jnp.stack([e_theta, e_phi]) if keep_efields else None,
    )
