"""Host-side simulation orchestrator.

The declarative batched replacement for the reference ``simulation`` class
(NuRadioMC/simulation/simulation.py:1084-1886). Instead of subclass hooks
that imperatively run modules per event (``_detector_simulation_filter_amp`` /
``_detector_simulation_trigger``), the detector signal chain and trigger are
*declared* (FilterStage / TriggerSpec); the orchestrator

1. merges the yaml config (simulation.py:67-90),
2. computes the integrated channel response and thermal Vrms exactly as the
   reference calibration pass does (simulation.py:1288-1389),
3. packs the input event list into padded [group x shower] batches,
4. runs the jitted fused pipeline chunk by chunk on the device mesh,
5. computes weights (earth attenuation) and Veff, and writes the output HDF5.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from nuradiomc_tpu.detector.detector import Detector
from nuradiomc_tpu.models import ice as ice_models
from nuradiomc_tpu.ops import antenna, askaryan, filters, phased_array
from nuradiomc_tpu.ops import emitter as emitter_ops
from nuradiomc_tpu.sim import earth_attenuation, io_hdf5
from nuradiomc_tpu.sim.pipeline import (ChannelParams, PipelineOutput,
                                        PipelineSettings, ShowerBatch,
                                        TriggerSettings, simulate_batch)
from nuradiomc_tpu.utils import config as config_util
from nuradiomc_tpu.utils import units
from nuradiomc_tpu.utils.constants import boltzmann


@dataclasses.dataclass
class FilterStage:
    passband: tuple
    filter_type: str
    kwargs: dict = dataclasses.field(default_factory=dict)
    # channel IDS this stage applies to; () = all. Gives per-channel response
    # chains (the reference derives per-channel responses from amp_type,
    # channelBandPassFilter per-channel dict arguments :89-100)
    channels: tuple = ()


@dataclasses.dataclass
class TriggerSpec:
    name: str = "default_high_low"
    trigger_type: str = "high_low"          # 'high_low' | 'simple_threshold' | 'phased_array'
    channels: tuple = ()                    # channel IDS the trigger reads; () = all
    threshold_high_sigma: float = 2.0       # in units of Vrms
    threshold_low_sigma: float = -2.0
    highlow_coincidence: float = 5.0        # ns
    number_of_coincidences: int = 1
    channel_coincidence: float = 200.0      # ns
    # phased-array settings (trigger_type == 'phased_array'), mirroring the
    # reference phasedArrayTrigger configuration (test/Veff D05phased_array_deep.py)
    pa_phasing_angles: tuple = tuple(np.arcsin(np.linspace(
        np.sin(np.deg2rad(-59.54968597864437)),
        np.sin(np.deg2rad(59.54968597864437)), 11)))
    pa_ref_index: float = 1.75
    pa_window_ns: float = 16.0
    pa_step_ns: float = 8.0
    pa_upsampling: int = 2
    pa_threshold_factor: float = 30.85      # threshold = factor * Vrms^2
    pa_digitize: bool = True                # ADC before phasing (module default)
    pa_adc_noise_count: int = None          # from detector if None
    # evaluate this trigger only for events where the named earlier trigger
    # fired (the reference's set_not_triggered(not has_triggered(name))
    # gating, test/SingleEvents/T02RunSimulation.py:42-61)
    requires: str = None


# ``perf`` keys that selected kernel implementations which no longer exist
_REMOVED_PERF_KEYS = ("placement_impl", "placement_phase", "trigger_impl")


def _reject_removed_perf_keys(config):
    """A config that still asks for a removed kernel path fails loudly
    rather than silently running another one."""
    perf = config.get("perf") or {}
    for key in _REMOVED_PERF_KEYS:
        if key in perf:
            raise ValueError(
                f"config perf.{key} was removed: the pipeline has one "
                "implementation per stage")


class Simulation:
    """End-to-end MC simulation of one station.

    Parameters
    ----------
    inputfilename : str | io_hdf5.EventInput
        Reference-format HDF5 event list, or the same table already in
        memory (``io_hdf5.event_input`` of an evtgen result).
    detector : Detector | str
        Detector description (or path to JSON).
    config : dict | str | None
        User config merged onto the defaults (simulation.py:765-795).
    filter_chain : sequence of FilterStage
        The detector signal chain (replaces _detector_simulation_filter_amp).
    trigger : TriggerSpec
        The trigger definition (replaces _detector_simulation_trigger).
    antenna_replacements : dict
        ant_type -> analytic model name, for sites whose tabulated antenna
        models are not on disk (mirrors antenna_model_replacements.json).
    """

    def __init__(self, inputfilename, detector, config=None,
                 filter_chain: Sequence[FilterStage] = (),
                 trigger: TriggerSpec = TriggerSpec(),
                 triggers: Optional[Sequence[TriggerSpec]] = None,
                 trigger_filter_chain: Optional[Sequence[FilterStage]] = None,
                 outputfilename: Optional[str] = None,
                 antenna_replacements: Optional[dict] = None,
                 antenna_models_path: Optional[str] = None,
                 chunk_size: int = 256,
                 n_base: int = 2048,
                 dtype=jnp.float64,
                 arz_library_path: Optional[str] = None,
                 nur_outputfilename: Optional[str] = None,
                 spice_pulses_path: Optional[str] = None,
                 spice_pulse_index: int = 0,
                 mesh=None):
        self.config = config_util.get_config(config)
        _reject_removed_perf_keys(self.config)
        self.det = detector if isinstance(detector, Detector) else Detector(detector)
        self.filter_chain = list(filter_chain)
        # multi-trigger: all declared named triggers are evaluated in ONE
        # fused pass (the reference convention, T02RunPhasedRNO.py:76-109);
        # the single `trigger` kwarg remains as the 1-trigger special case
        self.triggers = list(triggers) if triggers is not None else [trigger]
        if len({t.name for t in self.triggers}) != len(self.triggers):
            raise ValueError("trigger names must be unique")
        self.trigger = self.triggers[0]
        trigger = self.trigger
        # distinct trigger-channel signal chain (the reference's extra
        # trigger channels, channel.py:33-58 + RNO_G
        # hardwareResponseIncorporator trigger_channels); None = trigger on
        # the readout chain
        self.trigger_filter_chain = (list(trigger_filter_chain)
                                     if trigger_filter_chain is not None
                                     else None)
        self.outputfilename = outputfilename
        # executor host/device wall-time split, accumulated across
        # _run_station calls: pack_dispatch_s = host-side chunk packing +
        # async dispatch; drain_fetch_s = blocking result fetches (device-
        # bound wait + host readback). Reset it before timed campaigns.
        self.exec_timing = {"pack_dispatch_s": 0.0, "drain_fetch_s": 0.0,
                            "batch_upload_s": 0.0,
                            "dispatch_chunk_s": [], "drain_chunk_s": []}
        self.nur_outputfilename = nur_outputfilename
        self.antenna_replacements = antenna_replacements or {}
        # SPICE pulser archive (emitter model 'efield_idl1_spice'):
        # override path + which measured pulse to use (emitter.py kwargs
        # iN; the reference default is a random draw per efield)
        self.spice_pulses_path = spice_pulses_path
        self.spice_pulse_index = int(spice_pulse_index)
        # directory holding <model>/<model>.pkl reference-format antenna
        # pickles (the reference's path_to_antennamodels convention);
        # models found here are used as tabulated patterns
        self.antenna_models_path = antenna_models_path
        self.chunk_size = chunk_size
        self.dtype = dtype

        # ---- device mesh (SPMD data parallelism over event groups) ----------
        # mesh=None: single-device (default). mesh="auto": all visible
        # devices on one event axis. mesh=jax.sharding.Mesh: as given.
        # Replaces the reference's file splitting + cluster jobs
        # (EvtGen/generator.py:88-199, utilities/runner.py:9-99).
        from nuradiomc_tpu.parallel import mesh as mesh_util
        if mesh == "auto":
            mesh = mesh_util.make_mesh()
        self.mesh = mesh
        if self.mesh is not None:
            n_ev = self.mesh.shape["event"]
            if self.chunk_size % n_ev:
                # chunks are padded to a fixed size; keep it divisible so
                # every chunk shards evenly over the event axis
                self.chunk_size = ((self.chunk_size + n_ev - 1) // n_ev) * n_ev

        self.station_id = self.det.get_station_ids()[0]
        station = self.det.get_station(self.station_id)
        ch = station.channels

        cfg = self.config
        self.internal_rate = float(cfg["sampling_rate"])
        dt = 1.0 / self.internal_rate
        # rescale detector samples to the internal rate (simulation.py:151-153)
        n = ch.n_samples[0] / ch.sampling_frequency[0] / dt
        self.n_internal = int(np.ceil(n / 2.0) * 2)
        # the global time base must leave room beyond one readout window:
        # pulses arriving later than (n_base - n_internal) samples after the
        # group's earliest pulse fall into later sub-event windows
        # (config n_windows) or are dropped. The reference's converter grows
        # its global window to cover every pulse (efieldToVoltageConverter
        # .py:139-166); with a static shape we keep >= 25% headroom.
        pad = int(np.ceil(0.25 * self.n_internal / 128.0) * 128)
        self.n_base = max(n_base, self.n_internal + pad)

        self.ice = ice_models.get_ice_model(cfg["propagation"]["ice_model"])

        # ---- Vrms calibration (simulation.py:1302-1389) --------------------
        # per channel: chains may differ per channel via FilterStage.channels
        # (the reference computes _Vrms_per_channel the same way)
        ff_cal = np.linspace(0, 0.5 * self.internal_rate, 10000)
        noise_temp = cfg["trigger"]["noise_temperature"]
        vrms_cfg = cfg["trigger"]["Vrms"]

        def thermal_vrms(bandwidth):
            if vrms_cfg is not None:
                return float(vrms_cfg)
            impedance = 50 * units.ohm
            return float(np.sqrt(float(noise_temp) * impedance
                                 * bandwidth * boltzmann))

        ids0 = [int(c) for c in ch.channel_ids]
        self.bandwidth_per_channel = {}
        self.Vrms_per_channel = {}
        self.max_amplification_per_channel = {}
        for cid in ids0:
            filt = self._chain_response_for(ff_cal, cid, self.filter_chain)
            bw = np.trapezoid(np.abs(filt) ** 2, ff_cal)
            self.bandwidth_per_channel[cid] = bw
            self.Vrms_per_channel[cid] = thermal_vrms(bw)
            self.max_amplification_per_channel[cid] = (
                float(np.abs(filt).max()) if len(self.filter_chain) else 1.0)
        self.bandwidth = self.bandwidth_per_channel[ids0[0]]
        self.max_amplification = self.max_amplification_per_channel[ids0[0]]
        self.Vrms = self.Vrms_per_channel[ids0[0]]
        self.Vrms_efield = self.Vrms / self.max_amplification / units.m

        # trigger-channel Vrms from the trigger chain's bandwidth
        # (_Vrms_per_trigger_channel, simulation.py:1331): trigger thresholds
        # in sigma refer to this when a separate trigger chain is declared
        if self.trigger_filter_chain is not None:
            filt_t = self._chain_response_for(ff_cal, ids0[0],
                                              self.trigger_filter_chain)
            self.bandwidth_trigger = np.trapezoid(np.abs(filt_t) ** 2, ff_cal)
            self.Vrms_trigger = thermal_vrms(self.bandwidth_trigger)
        else:
            self.bandwidth_trigger = self.bandwidth
            self.Vrms_trigger = self.Vrms

        # ---- device-side channel parameters (per station) -------------------
        self.channel_params_per_station = {}
        for sid in self.det.get_station_ids():
            self.channel_params_per_station[sid] = self._build_channel_params(sid)
        self.channel_params = self.channel_params_per_station[self.station_id]
        ch = station.channels


        trigger_settings = tuple(
            self._build_trigger_settings(t) for t in self.triggers)
        self.trigger_names = [t.name for t in self.triggers]

        self.settings = PipelineSettings(
            triggers=trigger_settings,
            ice=self.ice,
            attenuation_model=cfg["propagation"]["attenuation_model"],
            askaryan_model=cfg["signal"]["model"],
            n_internal=self.n_internal,
            n_base=self.n_base,
            sampling_rate=self.internal_rate,
            delta_C_cut=float(cfg["speedup"]["delta_C_cut"]),
            distance_cut=bool(cfg["speedup"]["distance_cut"]),
            distance_cut_coefficients=tuple(cfg["speedup"]["distance_cut_coefficients"]),
            distance_cut_sum_length=float(cfg["speedup"]["distance_cut_sum_length"]),
            n_freq_attenuation=int(cfg["propagation"]["n_freq"]),
            # detector nyquist: the sparse attenuation grid is dense up to
            # max(channel adc rate)/2 and half as dense above
            # (propagation_base_class.py:75-80 + analyticraytracing.py:885-931)
            max_detector_freq=float(max(
                float(np.max(self.det.get_station(sid).channels
                             .sampling_frequency))
                for sid in self.det.get_station_ids())) * 0.5,
            **({"attenuation_steps": int(cfg["propagation"]["attenuation_steps"])}
               if cfg["propagation"].get("attenuation_steps") else {}),
            **({"attenuation_quadrature": str(cfg["propagation"]["attenuation_quadrature"])}
               if cfg["propagation"].get("attenuation_quadrature") else {}),
            **({"n_bisect": int(cfg["propagation"]["n_bisect"])}
               if cfg["propagation"].get("n_bisect") else {}),
            attenuate_ice=bool(cfg["propagation"]["attenuate_ice"]),
            n_reflections=int(cfg["propagation"].get("n_reflections", 0)
                              or 0),
            # sub-event windows: bounce rays arrive micro-seconds after the
            # direct pulse, one per (r, case) family — mirror the
            # reference's gap-based sub-event splitting with one window per
            # arrival cluster (config propagation.n_windows overrides)
            n_windows=int(cfg["propagation"].get("n_windows", 0)
                          or (1 + 2 * int(cfg["propagation"]
                                          .get("n_reflections", 0) or 0))),
            # perf block (optional): matmul_dtype 'float32'|'bfloat16',
            # noise_sampler, band_limit_eps (see docs/performance.md)
            **({"matmul_dtype": str(cfg["perf"]["matmul_dtype"])}
               if cfg.get("perf", {}).get("matmul_dtype") else {}),
            **({"noise_sampler": str(cfg["perf"]["noise_sampler"])}
               if cfg.get("perf", {}).get("noise_sampler") else {}),
            **({"band_limit_eps": float(cfg["perf"]["band_limit_eps"])}
               if cfg.get("perf", {}).get("band_limit_eps") else {}),
            apply_focusing=bool(cfg["propagation"]["focusing"]),
            focusing_limit=float(cfg["propagation"]["focusing_limit"]),
            # "implicit" (default): exact dz->0 derivative at the solved
            # root; "numeric": the reference's dz=-1cm displaced-receiver
            # re-solve (get_focusing, analyticraytracing.py:2778-2888) —
            # they differ only for grazing rays near a turning point, where
            # the true derivative diverges and the finite difference
            # regularizes it differently (see tests/test_singleevents.py)
            **({"focusing_mode": str(cfg["propagation"]["focusing_mode"])}
               if cfg["propagation"].get("focusing_mode") else {}),
            birefringence=bool(cfg["propagation"].get("birefringence", False)),
            birefringence_model=str(cfg["propagation"].get(
                "birefringence_model", "southpole_A")),
            # the reference's get_pulse_propagation_birefringence rotates the
            # path into the ice-flow frame when the config carries
            # angle_to_iceflow (deg); the default config does (-131 deg)
            birefringence_iceflow=float(np.deg2rad(
                cfg["propagation"].get("angle_to_iceflow", -131.0))),
            add_noise=bool(cfg["noise"]),
            noise_type="rayleigh",
        )
        if (self.settings.birefringence and cfg["propagation"].get(
                "birefringence_propagation", "analytical") != "analytical"):
            raise NotImplementedError(
                "only analytical birefringence propagation is implemented "
                "(config propagation.birefringence_propagation)")

        # ---- ARZ shower library (signal.model ARZ2019/ARZ2020) --------------
        self.arz_library = None
        if cfg["signal"]["model"] in ("ARZ2019", "ARZ2020"):
            from nuradiomc_tpu.ops import arz as arz_ops
            if arz_library_path is None:
                raise ValueError("ARZ models require arz_library_path "
                                 "(reference-format shower library pickle)")
            self.arz_library = arz_ops.load_library_pickle(arz_library_path)

        # ---- input ----------------------------------------------------------
        self.input = (inputfilename
                      if isinstance(inputfilename, io_hdf5.EventInput)
                      else io_hdf5.read_input_hdf5(inputfilename))
        self._emitter = self._build_emitter_params()

        def _step_mesh(batch, key, chp):
            out = simulate_batch(batch, chp, self.settings, noise_key=key,
                                 arz_library=self.arz_library,
                                 emitter=self._emitter)
            # device-side trigger-count reduction: under a sharded batch this
            # compiles to a per-shard sum + AllReduce over the event axis
            return out, jnp.sum(out.triggered.astype(jnp.int32))

        self._jit_step_mesh = jax.jit(_step_mesh)
        self._jit_step_by_station = {}

        def _single_step_for(station_id):
            # per-station jit CLOSING OVER the (numpy) channel constants:
            # host-side constants keep the band-limit support and the
            # candidate-cut switch static (pipeline._band_support,
            # cut_statically_off); the trigger count is a trivial host-side
            # sum on one device.
            if station_id not in self._jit_step_by_station:
                chp = self.channel_params_per_station[station_id]
                self._jit_step_by_station[station_id] = jax.jit(
                    lambda batch, key: simulate_batch(
                        batch, chp, self.settings, noise_key=key,
                        arz_library=self.arz_library,
                        emitter=self._emitter))
            return self._jit_step_by_station[station_id]

        self._single_step_for = _single_step_for

        def _call(batch, key, chp, station_id=None):
            if self.mesh is not None:
                return self._jit_step_mesh(batch, key, chp)
            sid = station_id if station_id is not None else self.station_id
            return self._single_step_for(sid)(batch, key), None

        self._jit_pipeline_ch = _call
        self._jit_pipeline = lambda batch, key: self._jit_pipeline_ch(
            batch, key, self.channel_params)
        # single-device packed executor state (see _packed_step_for)
        self._jit_packed_by_station = {}
        self._dev_batch_cache = None


    def _build_emitter_params(self):
        """EmitterParams when the input declares simulation_mode='emitter'
        (calculate_sim_efield_for_emitter, simulation.py:299-460): the
        emitter model + (for voltage models) the emitting-antenna VEL.
        Static per run; per-row amplitude/frequency/polarization ride the
        ShowerBatch."""
        mode = self.input.attrs.get("simulation_mode", "neutrino")
        mode = mode.decode() if isinstance(mode, bytes) else str(mode)
        self.emitter_mode = (mode == "emitter")
        if not self.emitter_mode:
            return None
        from nuradiomc_tpu.sim.pipeline import EmitterParams

        em = self.input.emitter or {}

        def uniq(key, default=None):
            if key not in em:
                return default
            vals = [v.decode() if isinstance(v, bytes) else v for v in em[key]]
            u = sorted(set(np.asarray(vals).tolist()))
            if len(u) != 1:
                raise NotImplementedError(
                    f"mixed per-row {key} in one emitter run is not "
                    f"supported (found {u}); split the input file")
            return u[0]

        model = str(uniq("emitter_model"))
        half_width = float(uniq("emitter_half_width", 5.0) or 5.0)
        dtc = np.complex64 if jnp.dtype(self.dtype) == jnp.float32 \
            else np.complex128
        freqs_int = np.fft.rfftfreq(self.n_internal, 1.0 / self.internal_rate)
        if model.startswith("efield_"):
            tpl = np.zeros((3, len(freqs_int)), dtype=dtc)
            rot = np.eye(3)
            kind = 0
        else:
            ant = str(uniq("emitter_antenna_type"))
            ant = self.antenna_replacements.get(ant, ant)
            if ant not in antenna.ANALYTIC_MODELS:
                raise NotImplementedError(
                    f"emitting antenna '{ant}' is not analytic; pass "
                    "antenna_replacements or antenna_models_path")
            kind = antenna.ANALYTIC_MODELS[ant][0]
            t = antenna.build_analytic_template(ant, freqs_int)
            tpl = np.zeros((3, len(freqs_int)), dtype=dtc)
            tpl[:t.shape[0]] = t
            if t.shape[0] == 1:
                tpl[1:] = t[0]
            rot = antenna.antenna_rotation_matrix(
                float(uniq("emitter_orientation_theta", 0.0) or 0.0),
                float(uniq("emitter_orientation_phi", 0.0) or 0.0),
                float(uniq("emitter_rotation_theta", 0.0) or 0.0),
                float(uniq("emitter_rotation_phi", 0.0) or 0.0))
        dtr = np.float64 if jnp.dtype(self.dtype) == jnp.float64 \
            else np.float32
        unit_spec = None
        if model in emitter_ops.MEASURED_MODELS:
            # measured lab waveform: amplitude scales the normalized trace
            # linearly (emitter.py:121-152), so the unit-amplitude spectrum
            # is a static host-side constant
            trace = emitter_ops.get_measured_time_trace(
                model, 1.0, self.n_internal, 1.0 / self.internal_rate)
            # numpy, not utils.fft: closure constants stay host-side numpy
            unit_spec = np.asarray(
                np.fft.rfft(trace) / self.internal_rate * np.sqrt(2.0), dtc)
        spice_angles = spice_specs = None
        if model == "efield_idl1_spice":
            # measured SPICE pulser archive -> per-launch-angle unit
            # spectra (ops.emitter.spice_unit_specs); the pipeline gathers
            # the nearest angle per ray on device
            import os as _os
            path = self.spice_pulses_path or _os.path.join(
                _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
                "data", "SPice_pulses.xz")
            archive = emitter_ops.load_spice_archive(path)
            spice_angles, specs = emitter_ops.spice_unit_specs(
                archive, self.n_internal, 1.0 / self.internal_rate,
                iN=self.spice_pulse_index)
            spice_angles = np.asarray(spice_angles, dtr)
            spice_specs = np.asarray(specs, dtc)
        return EmitterParams(model=model, templates=np.asarray(tpl, dtc),
                             rot=np.asarray(rot, dtr), kind=int(kind),
                             half_width=half_width, unit_spec=unit_spec,
                             spice_angles=spice_angles,
                             spice_specs=spice_specs)

    def _chain_response_for(self, freqs, channel_id, chain):
        """Combined response of the stages applying to ``channel_id``."""
        stages = [(f.passband, f.filter_type, f.kwargs) for f in chain
                  if not f.channels or int(channel_id) in f.channels]
        return filters.chain_response(freqs, stages, fs=self.internal_rate)

    def _build_trigger_settings(self, spec: TriggerSpec) -> TriggerSettings:
        """Resolve one TriggerSpec to static pipeline settings (absolute
        thresholds in volts, channel ids -> indices, phased-array beam
        configuration — phasedArrayTrigger / analogToDigitalConverter
        host-side setup)."""
        station = self.det.get_station(self.station_id)
        ch = station.channels
        ids = [int(c) for c in ch.channel_ids]
        if spec.channels:
            idx = tuple(ids.index(int(c)) for c in spec.channels)
        else:
            idx = ()
        sub = np.asarray(idx, dtype=int) if idx else np.arange(len(ids))

        pa_rolls = ()
        pa_window = pa_step = 0
        pa_threshold = 0.0
        pa_digitize = False
        pa_adc_fs = 0.5
        pa_adc_nbits = 8
        pa_adc_range = 0.0
        if spec.trigger_type == "phased_array":
            det_fs = float(ch.sampling_frequency[0])
            pa_digitize = spec.pa_digitize
            # with digitization the trigger runs at the ADC rate x upsampling
            base_fs = det_fs if pa_digitize else self.internal_rate
            fs_up = base_fs * spec.pa_upsampling
            rolls = phased_array.beam_rolls(
                ch.positions[sub, 2], ch.cable_delay[sub],
                np.asarray(spec.pa_phasing_angles), spec.pa_ref_index, fs_up)
            pa_rolls = tuple(tuple(int(v) for v in row) for row in rolls)
            pa_window = int(spec.pa_window_ns * det_fs * spec.pa_upsampling)
            pa_step = int(spec.pa_step_ns * det_fs * spec.pa_upsampling)
            pa_threshold = spec.pa_threshold_factor * self.Vrms_trigger ** 2
            pa_adc_fs = det_fs
            pa_adc_nbits = int(ch.adc_nbits[0]) if ch.adc_nbits[0] > 0 else 8
            noise_count = spec.pa_adc_noise_count or 15
            # ADC range from the noise occupancy (analogToDigitalConverter
            # ._get_adc_parameters:216-241)
            pa_adc_range = self.Vrms_trigger * (2 ** pa_adc_nbits - 1) / noise_count

        return TriggerSettings(
            name=spec.name,
            trigger_type=spec.trigger_type,
            channels=idx,
            threshold_high=float(spec.threshold_high_sigma * self.Vrms_trigger),
            threshold_low=float(spec.threshold_low_sigma * self.Vrms_trigger),
            highlow_coincidence=spec.highlow_coincidence,
            number_of_coincidences=spec.number_of_coincidences,
            channel_coincidence=spec.channel_coincidence,
            pa_rolls=pa_rolls, pa_window=pa_window, pa_step=pa_step,
            pa_upsampling=spec.pa_upsampling, pa_threshold=pa_threshold,
            pa_digitize=pa_digitize, pa_adc_fs=pa_adc_fs,
            pa_adc_nbits=pa_adc_nbits, pa_adc_range=pa_adc_range,
            requires=spec.requires)

    def _build_channel_params(self, station_id) -> ChannelParams:
        """Device-side per-channel arrays for one station."""
        cfg = self.config
        trigger = self.trigger
        station = self.det.get_station(station_id)
        ch = station.channels
        dt = 1.0 / self.internal_rate
        C = len(ch.channel_ids)
        freqs_int = np.fft.rfftfreq(self.n_internal, dt)
        freqs_base = np.fft.rfftfreq(self.n_base, dt)

        rot = np.zeros((C, 3, 3))
        kind = np.zeros(C, dtype=np.int32)
        templates = np.zeros((C, 3, len(freqs_int)), dtype=complex)
        tables = []
        for i in range(C):
            model = ch.antenna_model[i]
            model = self.antenna_replacements.get(model, model)
            table = None
            if model not in antenna.ANALYTIC_MODELS:
                # tabulated pattern from a reference-format pickle under
                # antenna_models_path/<model>/<model>.pkl (the reference's
                # path_to_antennamodels layout, antennapattern.py:1363)
                import os
                pkl = (os.path.join(self.antenna_models_path, model,
                                    f"{model}.pkl")
                       if self.antenna_models_path else None)
                if pkl is None or not os.path.exists(pkl):
                    raise NotImplementedError(
                        f"antenna model '{model}' has no tabulated data on "
                        "disk; provide antenna_models_path with the pickle "
                        "or antenna_replacements to an analytic model")
                table = antenna.load_antenna_table(pkl)
            tables.append(table)
            if table is None:
                kind[i] = antenna.ANALYTIC_MODELS[model][0]
                tpl = antenna.build_analytic_template(model, freqs_int)
                templates[i, :tpl.shape[0]] = tpl
                if tpl.shape[0] == 1:
                    templates[i, 1:] = tpl[0]
                model_orientation = antenna._MODEL_ORIENTATION
            else:
                # detector orientation expressed relative to the SIMULATED
                # antenna frame stored in the pickle (antennapattern.py:1197)
                model_orientation = table.orientation
            rot[i] = antenna.antenna_rotation_matrix(
                ch.orientation_theta[i], ch.orientation_phi[i],
                ch.rotation_theta[i], ch.rotation_phi[i],
                model_orientation=model_orientation)

        antenna_table = None
        if any(t is not None for t in tables):
            if not all(t is not None for t in tables):
                raise NotImplementedError(
                    "mixing tabulated and analytic antenna models in one "
                    "station is not supported yet")
            shapes = {t.h_theta.shape for t in tables}
            grids = {(tuple(np.asarray(t.freqs)), tuple(np.asarray(t.thetas)),
                      tuple(np.asarray(t.phis))) for t in tables}
            if len(shapes) != 1 or len(grids) != 1:
                raise NotImplementedError(
                    "tabulated antenna models of one station must share the "
                    "same (freq, theta, phi) grid")
            from nuradiomc_tpu.sim.pipeline import AntennaTableParams
            t0 = tables[0]
            _cdt = np.float64 if jnp.dtype(self.dtype) == jnp.float64 else np.float32
            _ctp = np.complex128 if _cdt == np.float64 else np.complex64
            antenna_table = AntennaTableParams(
                freqs=np.asarray(t0.freqs, dtype=_cdt),
                thetas=np.asarray(t0.thetas, dtype=_cdt),
                phis=np.asarray(t0.phis, dtype=_cdt),
                h_theta=np.stack([np.asarray(t.h_theta, dtype=_ctp)
                                  for t in tables]),
                h_phi=np.stack([np.asarray(t.h_phi, dtype=_ctp)
                                for t in tables]))

        # per-channel response chains (FilterStage.channels subsets)
        ids = [int(c) for c in ch.channel_ids]
        filter_response = np.stack([
            self._chain_response_for(freqs_base, cid, self.filter_chain)
            for cid in ids])
        filter_response_int = np.stack([
            self._chain_response_for(freqs_int, cid, self.filter_chain)
            for cid in ids])
        trigger_filter_response = None
        if self.trigger_filter_chain is not None:
            trigger_filter_response = np.stack([
                self._chain_response_for(freqs_base, cid,
                                         self.trigger_filter_chain)
                for cid in ids])

        # per-channel Vrms from each channel's own bandwidth (the reference's
        # _Vrms_per_channel table, simulation.py:1331-1389); the table built
        # at init covers the primary station — extend it for other stations
        ff_cal = np.linspace(0, 0.5 * self.internal_rate, 10000)
        for cid in ids:
            if cid not in self.bandwidth_per_channel:
                filt = self._chain_response_for(ff_cal, cid, self.filter_chain)
                bw = np.trapezoid(np.abs(filt) ** 2, ff_cal)
                self.bandwidth_per_channel[cid] = bw
                self.Vrms_per_channel[cid] = self.Vrms * np.sqrt(
                    bw / self.bandwidth)
        vrms_ch = np.array([self.Vrms_per_channel[cid] for cid in ids])
        bw_ch = np.array([self.bandwidth_per_channel[cid] for cid in ids])

        station_pos = station.absolute_position
        # host numpy leaves: static to the single-device jits, so the
        # pipeline can skip the candidate-cut round trip when the cut is off
        # (pipeline cut_statically_off)
        cdt = np.float64 if jnp.dtype(self.dtype) == jnp.float64 else np.float32
        ctype = np.complex128 if cdt == np.float64 else np.complex64
        return ChannelParams(
            positions=np.asarray(ch.positions + station_pos, dtype=cdt),
            cable_delays=np.asarray(ch.cable_delay, dtype=cdt),
            rot=np.asarray(rot, dtype=cdt),
            kind=np.asarray(kind),
            templates=np.asarray(templates, dtype=ctype),
            filter_response=np.asarray(filter_response, dtype=ctype),
            filter_response_int=np.asarray(filter_response_int, dtype=ctype),
            threshold_high=np.full((C,), trigger.threshold_high_sigma * self.Vrms, dtype=cdt),
            threshold_low=np.full((C,), trigger.threshold_low_sigma * self.Vrms, dtype=cdt),
            # noise is generated white up to Nyquist and scaled so the
            # post-filter RMS equals each channel's Vrms (simulation.py:595-600)
            noise_amplitude=np.asarray(
                vrms_ch / np.sqrt(bw_ch / (0.5 * self.internal_rate)),
                dtype=cdt),
            min_efield_amplitude=np.full(
                (C,), float(cfg["speedup"]["min_efield_amplitude"]) * self.Vrms_efield,
                dtype=cdt),
            trigger_filter_response=(
                np.asarray(trigger_filter_response, dtype=ctype)
                if trigger_filter_response is not None else None),
            antenna_table=antenna_table,
        )

    # ------------------------------------------------------------------
    def _build_batches(self):
        """Pad per-shower rows into [G, S_max] arrays (native batch builder)."""
        from nuradiomc_tpu import native

        inp = self.input
        group_ids, start, count, order = native.group_showers(inp.event_group_ids)

        # split each group's showers into sub-events when their vertex times
        # gap by more than split_event_time_diff (group_into_events,
        # simulation.py:906-1016 — the reference splits on voltage-trace
        # start times; vertex time is the dominant term for track
        # secondaries, which are the only multi-time sources)
        split_gap = float(self.config.get("split_event_time_diff", 1e6))
        if np.any(count > 1):
            from nuradiomc_tpu.sim.evtgen import group_into_events
            new_order, new_start, new_count, new_gids = [], [], [], []
            pos = 0
            for g in range(len(group_ids)):
                rows = order[start[g]:start[g] + count[g]]
                sub = group_into_events(inp.vertex_times[rows], split_gap)
                for s_idx in np.unique(sub):
                    sel = rows[sub == s_idx]
                    new_order.append(sel)
                    new_start.append(pos)
                    new_count.append(len(sel))
                    new_gids.append(group_ids[g])
                    pos += len(sel)
            order = np.concatenate(new_order)
            start = np.asarray(new_start, dtype=start.dtype)
            count = np.asarray(new_count, dtype=count.dtype)
            group_ids = np.asarray(new_gids, dtype=group_ids.dtype)

        G = len(group_ids)
        S = int(count.max())
        dt = np.float64 if jnp.dtype(self.dtype) == jnp.float64 else np.float32

        pad_src = {"xx": inp.xx, "yy": inp.yy, "zz": inp.zz,
                   "energies": inp.shower_energies,
                   "is_em": (inp.shower_type == "em").astype(float),
                   "zeniths": inp.zeniths, "azimuths": inp.azimuths,
                   "vertex_times": inp.vertex_times}
        if getattr(self, "emitter_mode", False):
            em = inp.emitter or {}
            n = inp.n_showers
            pad_src["emitter_polarization"] = np.asarray(
                em.get("emitter_polarization", np.full(n, 0.5)), dtype=float)
            pad_src["emitter_frequency"] = np.asarray(
                em.get("emitter_frequency", np.zeros(n)), dtype=float)
            if "emitter_time" in em:
                pad_src["vertex_times"] = np.asarray(em["emitter_time"],
                                                     dtype=float)
        cols, mask = native.pad_columns(pad_src, order, start, count, S)

        def padded(name):
            return cols[name].astype(dt)

        vert = np.stack([padded("xx"), padded("yy"), padded("zz")], axis=-1)
        energies = padded("energies")
        is_em = cols["is_em"] > 0.5
        # skip zero-energy padding showers
        mask = mask & (energies > 0)

        zen = padded("zeniths")
        az = padded("azimuths")
        # propagation direction = -axis (simulation.py:174)
        axis = np.stack([np.sin(zen) * np.cos(az), np.sin(zen) * np.sin(az),
                         np.cos(zen)], axis=-1)
        prop_dir = -axis

        # per-shower Alvarez2009 k_L (persisted shower realization,
        # simulation.py:235-242) — pre-drawn on the host, or reused from the
        # input file when a previous run persisted it (simulation.py:737-740)
        rng = np.random.default_rng(np.random.Philox(int(self.config["seed"])))
        k_L = askaryan.draw_alvarez2009_k_L(
            np.maximum(energies, 1.0), is_em, rng).astype(dt)
        if inp.shower_realization_Alvarez2009 is not None:
            reuse, _ = native.pad_columns(
                {"k_L": inp.shower_realization_Alvarez2009.astype(float)},
                order, start, count, S)
            k_L = reuse["k_L"].astype(dt)

        vertex_times = padded("vertex_times")
        profile_idx = None
        if self.arz_library is not None:
            # per-shower library pick, persisted like shower_realization_ARZ
            n_em = max(int(self.arz_library.ce_em.shape[0]), 1)
            n_had = max(int(self.arz_library.ce_had.shape[0]), 1)
            profile_np = np.where(
                is_em, rng.integers(0, n_em, is_em.shape),
                rng.integers(0, n_had, is_em.shape)).astype(np.int32)
            if inp.shower_realization_ARZ is not None:
                reuse, _ = native.pad_columns(
                    {"iN": inp.shower_realization_ARZ.astype(float)},
                    order, start, count, S)
                profile_np = reuse["iN"].astype(np.int32)
            profile_idx = profile_np

        # unpad the drawn/reused realizations back to per-input-row arrays for
        # output persistence (output_writer_hdf5.py:182-184)
        self._realizations = {}
        model = self.config["signal"]["model"]
        if model == "Alvarez2009" or model.startswith("ARZ"):
            flat = np.zeros(inp.n_showers,
                            dtype=np.int64 if model.startswith("ARZ") else float)
            src = np.asarray(profile_idx) if model.startswith("ARZ") else np.asarray(k_L)
            for g in range(G):
                rows = order[start[g]:start[g] + count[g]]
                flat[rows] = src[g, :count[g]]
            key_name = ("shower_realization_ARZ" if model.startswith("ARZ")
                        else "shower_realization_Alvarez2009")
            self._realizations[key_name] = flat
        emitter_pol = None
        if getattr(self, "emitter_mode", False):
            # emitter runs: k_L carries the per-row emitter frequency
            # (cw/tone_burst); no Askaryan realizations
            k_L = cols["emitter_frequency"].astype(dt)
            emitter_pol = cols["emitter_polarization"].astype(dt)
            self._realizations = {}
        batch = ShowerBatch(
            vertices=vert.astype(dt), energies=energies,
            is_em=is_em, shower_mask=mask,
            prop_dir=prop_dir.astype(dt), k_L=k_L,
            vertex_times=vertex_times, profile_idx=profile_idx,
            emitter_polarization=emitter_pol)
        return group_ids, start, count, order, batch

    def _weights(self, group_ids, start, count, order):
        """Per-group earth-absorption weight (simulation.py:852 -> get_weight)."""
        inp = self.input
        if getattr(self, "emitter_mode", False):
            return np.ones(len(group_ids))
        first = order[start]
        mode = self.config["weights"]["weight_mode"]
        xsec = self.config["weights"]["cross_section_type"]
        vertices = np.c_[inp.xx[first], inp.yy[first], inp.zz[first]]
        return earth_attenuation.get_weight(
            inp.zeniths[first], inp.energies[first], inp.flavors[first],
            mode=mode, cross_section_type=xsec,
            vertex_position=vertices, phi_nu=inp.azimuths[first])

    def _packed_step_for(self, station_id):
        """Single-device executor program: slice the DEVICE-RESIDENT padded
        batch at ``offset`` in-jit, run the pipeline, and return TWO packed
        arrays — per-group summary and flattened per-solution observables —
        so one chunk costs two host fetches and zero per-chunk uploads.

        Why: the per-chunk executor costs ~18 fetches + ~15 uploads per
        chunk; packing removes the per-chunk host-to-device copies and
        leaves two device-to-host syncs. Returns (jit_fn, spec) where spec["layout"] (captured
        at trace time, when shapes are static) maps persol columns back to
        named per-solution fields.
        """
        if station_id in self._jit_packed_by_station:
            return self._jit_packed_by_station[station_id]
        from nuradiomc_tpu.utils import geometry as geo
        chp = self.channel_params_per_station[station_id]
        cs = self.chunk_size
        spec = {}

        def step(batch_dev, offset, key):
            chunk = jax.tree.map(
                lambda a: jax.lax.dynamic_slice_in_dim(a, offset, cs, 0),
                batch_dev)
            out = simulate_batch(chunk, chp, self.settings, noise_key=key,
                                 arz_library=self.arz_library,
                                 emitter=self._emitter)
            rd = out.trigger_time.dtype

            def flat(x):
                return x.reshape(cs, -1).astype(rd)

            summary = jnp.concatenate(
                [flat(out.triggered), flat(out.trigger_time),
                 flat(out.max_amplitude), flat(out.triggered_per),
                 flat(out.trigger_times_per)], axis=1)
            # cartesian polarization at the antenna (HDF5_structure.rst):
            # rotated on-device so the drain needs no extra dispatch
            rec = out.receive_vector
            zen = jnp.arccos(jnp.clip(rec[..., 2], -1.0, 1.0))
            az = jnp.arctan2(rec[..., 1], rec[..., 0])
            pol_cart = geo.onsky_to_ground(out.polarization, zen, az)
            fields = {
                "max_amp_shower_and_ray": out.max_amp_per_solution,
                "ray_tracing_C0": out.c0,
                "ray_tracing_C1": out.c1,
                "ray_tracing_solution_type": out.sol_type,
                "ray_tracing_reflection": out.reflection,
                "ray_tracing_reflection_case": out.refl_case,
                "focusing_factor": out.focusing,
                "launch_vectors": out.launch_vector,
                "receive_vectors": out.receive_vector,
                "polarization": pol_cart,
                "travel_times": out.travel_time,
                "travel_distances": out.path_length,
                "sol_mask": out.sol_mask,
            }
            spec["layout"] = [(k, tuple(int(d) for d in v.shape[1:]))
                              for k, v in fields.items()]
            persol = jnp.concatenate([flat(v) for v in fields.values()],
                                     axis=1)
            return summary, persol

        entry = (jax.jit(step), spec)
        self._jit_packed_by_station[station_id] = entry
        return entry

    def _device_batch(self, batch, g_pad):
        """Upload the FULL (padded) batch once per run; chunks are sliced
        on-device. Cached across stations (run() clears the cache)."""
        key = (id(batch), g_pad)
        if (self._dev_batch_cache is not None
                and self._dev_batch_cache[0] == key):
            return self._dev_batch_cache[1]
        G = batch.energies.shape[0]

        def _pad_full(a):
            a = np.asarray(a)
            return np.pad(a, [(0, g_pad - G)] + [(0, 0)] * (a.ndim - 1))

        t0 = time.perf_counter()
        dev = jax.jit(lambda b: b)(jax.tree.map(_pad_full, batch))
        self.exec_timing["batch_upload_s"] += time.perf_counter() - t0
        self._dev_batch_cache = (key, dev)
        return dev

    def _run_station(self, station_id, batch, seed_offset=0):
        """Chunked pipeline over all groups for one station.

        With a mesh set, every chunk is placed with a NamedSharding over the
        event axis and the channel constants are sharded/replicated once; the
        jitted program then runs SPMD across all devices (GSPMD inserts the
        trigger-count AllReduce)."""
        from nuradiomc_tpu.parallel import mesh as mesh_util

        G = batch.energies.shape[0]
        chp = self.channel_params_per_station[station_id]
        if self.mesh is not None:
            chp = mesh_util.shard_channels(chp, self.mesh)
        key = jax.random.PRNGKey(int(self.config["seed"]) + seed_offset)
        T = len(self.triggers)
        triggered = np.zeros(G, dtype=bool)
        max_amp = np.zeros((G, len(self.det.get_channel_ids(station_id))))
        trigger_times = np.zeros(G)
        trig_per = np.zeros((G, T), dtype=bool)
        tt_per = np.zeros((G, T))

        # per-solution observables of triggered groups for the station output
        station_rows = {k: [] for k in (
            "g_idx", "max_amp_shower_and_ray", "ray_tracing_C0", "ray_tracing_C1",
            "ray_tracing_solution_type", "ray_tracing_reflection",
            "ray_tracing_reflection_case", "focusing_factor", "launch_vectors",
            "receive_vectors", "polarization", "travel_times", "travel_distances",
            "time_shower_and_ray", "sol_mask")}

        n_chunks = (G + self.chunk_size - 1) // self.chunk_size

        # double-buffered executor: jax dispatch is async, so keeping a small
        # in-flight window lets host-side packing of chunk i+1 overlap the
        # device computing chunk i; results are fetched one window behind
        # (the blocking np.asarray is what forces the sync)
        in_flight = []
        MAX_IN_FLIGHT = 2

        if self.mesh is None:
            # ---- packed single-device executor: one batch upload per run,
            # on-device chunk slicing, two fetches per chunk ---------------
            step_fn, spec = self._packed_step_for(station_id)
            dev_batch = self._device_batch(batch, n_chunks * self.chunk_size)
            C = max_amp.shape[1]
            cd = np.asarray(chp.cable_delays)

            def dispatch(i):
                nonlocal key
                t0 = time.perf_counter()
                sl = slice(i * self.chunk_size,
                           min((i + 1) * self.chunk_size, G))
                key, sub = jax.random.split(key)
                summary, persol = step_fn(
                    dev_batch, np.int32(i * self.chunk_size), sub)
                in_flight.append((sl, summary, persol))
                dt = time.perf_counter() - t0
                self.exec_timing["pack_dispatch_s"] += dt
                # per-chunk attribution: chunk 0 carries the lazy jit
                # compile; steady-state dispatch is the tail of this list
                self.exec_timing["dispatch_chunk_s"].append(dt)

            def drain_one():
                t0 = time.perf_counter()
                sl, summary, persol = in_flight.pop(0)
                n_real = sl.stop - sl.start
                S = np.asarray(summary)[:n_real]
                trig = S[:, 0] > 0.5
                triggered[sl] = trig
                trigger_times[sl] = S[:, 1]
                max_amp[sl] = S[:, 2:2 + C]
                trig_per[sl] = S[:, 2 + C:2 + C + T] > 0.5
                tt_per[sl] = S[:, 2 + C + T:2 + C + 2 * T]
                idx = np.where(trig)[0]
                if len(idx):
                    # second fetch only when the chunk has triggered rows
                    P = np.asarray(persol)[:n_real][idx]
                    station_rows["g_idx"].append(idx + sl.start)
                    off = 0
                    for name, shape in spec["layout"]:
                        w = int(np.prod(shape)) if shape else 1
                        col = P[:, off:off + w].reshape(
                            (len(idx),) + shape)
                        off += w
                        if name in ("ray_tracing_solution_type",
                                    "ray_tracing_reflection_case"):
                            col = np.rint(col).astype(np.int32)
                        elif name == "sol_mask":
                            col = col > 0.5
                        station_rows[name].append(col)
                        if name == "travel_times":
                            station_rows["time_shower_and_ray"].append(
                                col + cd[None, None, :, None])
                dt = time.perf_counter() - t0
                self.exec_timing["drain_fetch_s"] += dt
                self.exec_timing["drain_chunk_s"].append(dt)

            for i in range(n_chunks):
                dispatch(i)
                if len(in_flight) >= MAX_IN_FLIGHT:
                    drain_one()
            while in_flight:
                drain_one()
            return (triggered, max_amp, trigger_times, station_rows,
                    trig_per, tt_per)

        def dispatch(i):
            nonlocal key
            t0 = time.perf_counter()
            sl = slice(i * self.chunk_size, min((i + 1) * self.chunk_size, G))
            n_pad = self.chunk_size - (sl.stop - sl.start)
            chunk = jax.tree.map(
                lambda a: np.pad(np.asarray(a)[sl],
                                 [(0, n_pad)] + [(0, 0)] * (a.ndim - 1)),
                batch)
            if self.mesh is not None:
                chunk = mesh_util.shard_batch(chunk, self.mesh)
            key, sub = jax.random.split(key)
            out, _ = self._jit_pipeline_ch(chunk, sub, chp,
                                           station_id=station_id)
            in_flight.append((sl, out))
            # host-side pack + async dispatch time (executor timing split;
            # drain_one's blocking fetch accounts the device-bound wait)
            self.exec_timing["pack_dispatch_s"] += time.perf_counter() - t0

        def drain_one():
            t0 = time.perf_counter()
            sl, out = in_flight.pop(0)
            n_real = sl.stop - sl.start
            trig = np.asarray(out.triggered)[:n_real]
            triggered[sl] = trig
            max_amp[sl] = np.asarray(out.max_amplitude)[:n_real]
            trigger_times[sl] = np.asarray(out.trigger_time)[:n_real]
            trig_per[sl] = np.asarray(out.triggered_per)[:n_real]
            tt_per[sl] = np.asarray(out.trigger_times_per)[:n_real]

            idx = np.where(trig)[0]
            if len(idx):
                station_rows["g_idx"].append(idx + sl.start)
                station_rows["max_amp_shower_and_ray"].append(
                    np.asarray(out.max_amp_per_solution)[idx])
                station_rows["ray_tracing_C0"].append(np.asarray(out.c0)[idx])
                station_rows["ray_tracing_C1"].append(np.asarray(out.c1)[idx])
                station_rows["ray_tracing_solution_type"].append(
                    np.asarray(out.sol_type)[idx])
                station_rows["ray_tracing_reflection"].append(
                    np.asarray(out.reflection)[idx])
                station_rows["ray_tracing_reflection_case"].append(
                    np.asarray(out.refl_case)[idx])
                station_rows["focusing_factor"].append(np.asarray(out.focusing)[idx])
                station_rows["launch_vectors"].append(np.asarray(out.launch_vector)[idx])
                station_rows["receive_vectors"].append(np.asarray(out.receive_vector)[idx])
                # cartesian polarization at the antenna: on-sky components
                # rotated with the receive direction (HDF5_structure.rst)
                from nuradiomc_tpu.utils import geometry as geo
                rec = np.asarray(out.receive_vector)[idx]
                zen = np.arccos(np.clip(rec[..., 2], -1, 1))
                az = np.arctan2(rec[..., 1], rec[..., 0])
                pol = np.asarray(jax.jit(geo.onsky_to_ground)(
                    jnp.asarray(np.asarray(out.polarization)[idx]),
                    jnp.asarray(zen), jnp.asarray(az)))
                station_rows["polarization"].append(pol)
                station_rows["travel_times"].append(np.asarray(out.travel_time)[idx])
                station_rows["travel_distances"].append(np.asarray(out.path_length)[idx])
                tt = np.asarray(out.travel_time)[idx]
                cd = np.asarray(chp.cable_delays)
                station_rows["time_shower_and_ray"].append(
                    tt + cd[None, None, :, None])
                station_rows["sol_mask"].append(np.asarray(out.sol_mask)[idx])
            self.exec_timing["drain_fetch_s"] += time.perf_counter() - t0

        for i in range(n_chunks):
            dispatch(i)
            if len(in_flight) >= MAX_IN_FLIGHT:
                drain_one()
        while in_flight:
            drain_one()

        return triggered, max_amp, trigger_times, station_rows, trig_per, tt_per

    def run(self, keep_traces: bool = False):
        """Run the full simulation over all stations; OR of station triggers
        (output_writer_hdf5.py:350-381 aggregation semantics)."""
        group_ids, start, count, order, batch = self._build_batches()
        G = batch.energies.shape[0]
        self._dev_batch_cache = None    # fresh upload per run (id() reuse)
        weights = self._weights(group_ids, start, count, order)

        T = len(self.triggers)
        per_station = {}
        triggered = np.zeros(G, dtype=bool)
        trigger_times = np.full(G, np.inf)
        multiple_triggers = np.zeros((G, T), dtype=bool)
        trigger_times_per = np.full((G, T), np.inf)
        for k, sid in enumerate(self.det.get_station_ids()):
            trig_s, amp_s, tt_s, rows_s, trigper_s, ttper_s = \
                self._run_station(sid, batch, k)
            per_station[sid] = (trig_s, amp_s, tt_s, rows_s, trigper_s)
            triggered |= trig_s
            trigger_times = np.where(trig_s, np.minimum(trigger_times, tt_s),
                                     trigger_times)
            multiple_triggers |= trigper_s
            trigger_times_per = np.where(
                trigper_s, np.minimum(trigger_times_per, ttper_s),
                trigger_times_per)
        trigger_times = np.where(np.isfinite(trigger_times), trigger_times, 0.0)
        # per-trigger times are nan where the trigger did not fire
        # (output_writer_hdf5.py:355 trigger_times init to nan)
        trigger_times_per = np.where(np.isfinite(trigger_times_per),
                                     trigger_times_per, np.nan)
        triggered_primary, max_amp, _, station_rows, _ = \
            per_station[self.station_id]

        # minimum-weight speedup cut (simulation.py:1476) is applied as a
        # zero-weight contribution, not by skipping, so results are identical
        min_weight = float(self.config["speedup"]["minimum_weight_cut"])
        eff_weights = np.where(weights < min_weight, 0.0, weights)

        n_events = int(self.input.attrs["n_events"])
        volume = float(self.input.attrs.get("volume", np.nan))
        # aggregate sub-events (time-gap splits) back to their parent event
        # group so each primary contributes its weight at most once
        # (output_writer_hdf5.py:350-381 per-shower OR semantics)
        uniq, inv = np.unique(group_ids, return_inverse=True)
        trig_parent = np.zeros(len(uniq), dtype=bool)
        np.logical_or.at(trig_parent, inv, triggered)
        w_parent = np.zeros(len(uniq))
        w_parent[inv] = eff_weights
        veff = volume * float(np.sum(w_parent * trig_parent)) / n_events

        # per-trigger-name Veff (the quantity utilities/Veff.py:335-338
        # computes per multiple_triggers column)
        veff_per_trigger = {}
        for iT, name in enumerate(self.trigger_names):
            tp = np.zeros(len(uniq), dtype=bool)
            np.logical_or.at(tp, inv, multiple_triggers[:, iT])
            veff_per_trigger[name] = volume * float(
                np.sum(w_parent * tp)) / n_events

        results = {
            "group_ids": group_ids,
            "triggered": triggered,
            "weights": weights,
            "max_amplitude": max_amp,
            "trigger_times": trigger_times,
            "multiple_triggers": multiple_triggers,
            "trigger_times_per_trigger": trigger_times_per,
            "trigger_names": list(self.trigger_names),
            "veff": veff,
            "veff_per_trigger": veff_per_trigger,
            "n_triggered": int(np.sum(trig_parent)),
        }

        if self.outputfilename is not None:
            # map group-level triggers back to per-shower rows
            trig_shower = np.zeros(self.input.n_showers, dtype=bool)
            w_shower = np.zeros(self.input.n_showers)
            tt_shower = np.full((self.input.n_showers, T), np.nan)
            mt_shower = np.zeros((self.input.n_showers, T), dtype=bool)
            for g in range(G):
                rows = order[start[g]:start[g] + count[g]]
                trig_shower[rows] = triggered[g]
                w_shower[rows] = weights[g]
                tt_shower[rows] = trigger_times_per[g]
                mt_shower[rows] = multiple_triggers[g]

            # station groups (schema: HDF5_structure.rst:150-182) for
            # showers of triggered event groups, one group per station
            station_groups = {}
            for sid, (trig_s, amp_s, tt_s, rows_s, trigper_s) in per_station.items():
                station_groups[sid] = self._station_group(
                    rows_s, amp_s, tt_s, group_ids, start, count, order,
                    trigper_s)

            ch = self.det.get_station(self.station_id).channels
            io_hdf5.write_output_hdf5(
                self.outputfilename, self.input,
                {"triggered": trig_shower, "weights": w_shower,
                 "multiple_triggers": mt_shower,
                 "trigger_times": tt_shower,
                 **getattr(self, "_realizations", {}),
                 **{f"station_{sid}": grp
                    for sid, grp in station_groups.items()}},
                {"Veff": veff, "n_triggered": results["n_triggered"],
                 "Vrms": self.Vrms, "bandwidth": self.bandwidth,
                 "trigger_names": np.array(self.trigger_names, dtype="S"),
                 "antenna_positions": ch.positions,
                 "n_samples": int(ch.n_samples[0]),
                 "sampling_rate": float(ch.sampling_frequency[0]),
                 "config": str(self.config)})

        if self.nur_outputfilename is not None:
            self._write_nur(group_ids, start, count, order, batch, triggered,
                            trigger_times, multiple_triggers,
                            trigger_times_per)

        return results


    def _station_group(self, station_rows, max_amp, trigger_times,
                       group_ids, start, count, order, trig_per=None):
        """Build one station's output group from collected per-solution rows."""
        if not station_rows["g_idx"]:
            return {}
        if trig_per is None:
            trig_per = np.zeros((len(group_ids), len(self.triggers)), dtype=bool)
        g_sel = np.concatenate(station_rows["g_idx"])
        m_rows = []
        sh_ids = []
        eg_ids = []
        for j, g in enumerate(g_sel):
            rows = order[start[g]:start[g] + count[g]]
            for s_idx, r in enumerate(rows):
                m_rows.append((j, s_idx))
                sh_ids.append(self.input.shower_ids[r])
                eg_ids.append(group_ids[g])
        jj = np.array([m[0] for m in m_rows])
        ss = np.array([m[1] for m in m_rows])

        def gather(key):
            arr = np.concatenate(station_rows[key])
            return arr[jj, ss]

        mask = gather("sol_mask")

        def nanify(key):
            a = np.array(gather(key), dtype=float)
            a[~mask] = np.nan
            return a

        from nuradiomc_tpu.utils import geometry as geo
        return {
            "event_group_ids": np.array([group_ids[g] for g in g_sel]),
            "event_ids": np.zeros(len(g_sel), dtype=int),
            "event_group_id_per_shower": np.array(eg_ids),
            "event_id_per_shower": np.zeros(len(sh_ids), dtype=int),
            "shower_id": np.array(sh_ids),
            "triggered": np.ones(len(sh_ids), dtype=bool),
            "triggered_per_event": np.ones(len(g_sel), dtype=bool),
            # per-trigger-name columns (output_writer_hdf5.py:350-381)
            "multiple_triggers": trig_per[g_sel][jj],
            "multiple_triggers_per_event": trig_per[g_sel],
            "maximum_amplitudes": max_amp[g_sel],
            "maximum_amplitudes_envelope": max_amp[g_sel],
            "trigger_times": trigger_times[g_sel][:, None][jj],
            "trigger_times_per_event": trigger_times[g_sel][:, None],
            "max_amp_shower_and_ray": nanify("max_amp_shower_and_ray"),
            "ray_tracing_C0": nanify("ray_tracing_C0"),
            "ray_tracing_C1": nanify("ray_tracing_C1"),
            "ray_tracing_solution_type": nanify("ray_tracing_solution_type"),
            "ray_tracing_reflection": nanify("ray_tracing_reflection"),
            "ray_tracing_reflection_case": nanify("ray_tracing_reflection_case"),
            "focusing_factor": nanify("focusing_factor"),
            "travel_times": nanify("travel_times"),
            "travel_distances": nanify("travel_distances"),
            "time_shower_and_ray": nanify("time_shower_and_ray"),
            "launch_vectors": np.concatenate(station_rows["launch_vectors"])[jj, ss],
            "receive_vectors": np.concatenate(station_rows["receive_vectors"])[jj, ss],
            "polarization": np.concatenate(station_rows["polarization"])[jj, ss],
        }

    def _write_nur(self, group_ids, start, count, order, batch, triggered,
                   trigger_times, multiple_triggers=None,
                   trigger_times_per=None):
        """Write triggered events with waveforms to a .nur-style file
        (the reference's outputfilenameNuRadioReco path, eventWriter.run;
        channel traces downsampled to the detector sampling rate)."""
        from nuradiomc_tpu.framework import parameters as par
        from nuradiomc_tpu.framework.event import (Channel, Event, Shower,
                                                   Station, Trigger)
        from nuradiomc_tpu.sim import io_nur

        idx = np.where(triggered)[0]
        if len(idx) == 0:
            w = io_nur.EventWriter(self.nur_outputfilename)
            w.end()
            return

        sub = jax.tree.map(lambda a: a[idx] if a is not None else None, batch)
        out = jax.jit(lambda b, key: simulate_batch(
            b, self.channel_params, self.settings, noise_key=key,
            keep_traces=True, arz_library=self.arz_library))(
                sub, jax.random.PRNGKey(int(self.config["seed"]) + 1))

        traces = np.asarray(out.traces)          # [n, C, n_base]
        base_t0 = np.asarray(out.base_t0)
        ch_det = self.det.get_station(self.station_id).channels
        shp = par.showerParameters
        inp = self.input

        writer = io_nur.EventWriter(self.nur_outputfilename)
        for j, g in enumerate(idx):
            evt = Event(0, int(group_ids[g]))
            station = Station(self.station_id)
            for ci, cid in enumerate(ch_det.channel_ids):
                ch = Channel(int(cid))
                ch.set_trace(traces[j, ci], self.internal_rate,
                             trace_start_time=float(base_t0[j]))
                # downsample to the detector readout rate
                ch.resample(float(ch_det.sampling_frequency[ci]))
                station.add_channel(ch)
            for iT, spec in enumerate(self.triggers):
                fired = (bool(multiple_triggers[g, iT])
                         if multiple_triggers is not None else True)
                cids = (list(spec.channels) if spec.channels
                        else list(ch_det.channel_ids))
                trig = Trigger(spec.name, cids, spec.trigger_type)
                trig.set_triggered(fired)
                if fired:
                    tt = (float(trigger_times_per[g, iT])
                          if trigger_times_per is not None
                          else float(trigger_times[g]))
                    trig.set_trigger_time(tt)
                station.set_trigger(trig)
            evt.set_station(station)
            rows = order[start[g]:start[g] + count[g]]
            for r in rows:
                sh = Shower(int(inp.shower_ids[r]))
                sh[shp.energy] = float(inp.shower_energies[r])
                sh[shp.zenith] = float(inp.zeniths[r])
                sh[shp.azimuth] = float(inp.azimuths[r])
                sh[shp.vertex] = np.array([inp.xx[r], inp.yy[r], inp.zz[r]])
                sh[shp.type] = str(inp.shower_type[r])
                evt.add_sim_shower(sh)
            writer.run(evt)
        writer.end()
