"""Webinar part 2: running the simulation
(counterpart of NuRadioMC/examples/06_webinar/W02RunSimulation.py).

Where the reference subclasses ``simulation.simulation`` and overrides
``_detector_simulation_filter_amp`` / ``_detector_simulation_trigger``,
this framework expresses the same two hooks declaratively: the
filter chain is a list of `FilterStage` and the trigger(s) a list of
`TriggerSpec` — everything the hooks did per event now compiles into ONE
fused XLA program over the whole batch.

Usage:
    python W02_run_simulation.py [--inputfilename input/input_1e18.hdf5]
        [--outputfilename results/NuMC_output.hdf5]
        [--outputfilenameNuRadioReco results/NuMC_output.nur]
"""
import argparse
import os

import jax.numpy as jnp

from nuradiomc_tpu.sim.simulation import FilterStage, Simulation, TriggerSpec
from nuradiomc_tpu.utils import units

parser = argparse.ArgumentParser(description="Run NuRadioMC simulation")
parser.add_argument("--inputfilename", type=str,
                    default="input/input_1e18.hdf5")
parser.add_argument("--outputfilename", type=str,
                    default="results/NuMC_output.hdf5")
parser.add_argument("--outputfilenameNuRadioReco", type=str, default=None,
                    help="optional .nur event file (heavy; skip for large "
                         "productions)")
args = parser.parse_args()
os.makedirs(os.path.dirname(args.outputfilename) or ".", exist_ok=True)

# The webinar detector: four downward-pointing bicones between -90 m and
# -97.5 m on one string (06_webinar/detector.json). The tabulated
# bicone_v8_inf_n1.78 pattern is a data-server download, so this example
# substitutes the analytic VPol dipole — the same substitution the
# conformance goldens use.
def channel(cid, z):
    return {"adc_n_samples": 256, "adc_sampling_frequency": 2.0,
            "ant_orientation_phi": 0.0, "ant_orientation_theta": 0.0,
            "ant_position_x": 0.0, "ant_position_y": 0.0,
            "ant_position_z": z,
            "ant_rotation_phi": 90.0, "ant_rotation_theta": 90.0,
            "ant_type": "bicone_v8_inf_n1.78", "amp_type": "",
            "cab_time_delay": 0.0, "adc_nbits": None,
            "channel_id": cid, "station_id": 101}

detector = {
    "channels": {str(i + 1): channel(i, -90.0 - 2.5 * i) for i in range(4)},
    "stations": {"1": {"station_id": 101, "pos_altitude": 0,
                       "pos_easting": 0, "pos_northing": 0,
                       "pos_site": "greenland"}},
}

sim = Simulation(
    args.inputfilename, detector,
    # 06_webinar/config.yaml: noise on, Alvarez2009, Greenland ice + GL1
    # attenuation, the minimum-weight and min-efield-amplitude speedups
    config={"sampling_rate": 2.0, "noise": True,
            "propagation": {"ice_model": "greenland_simple",
                            "attenuation_model": "GL1"},
            "signal": {"model": "Alvarez2009"},
            "speedup": {"minimum_weight_cut": 1e-5,
                        "min_efield_amplitude": 2},
            "trigger": {"noise_temperature": 300},
            "weights": {"weight_mode": "core_mantle_crust_simple",
                        "cross_section_type": "ctw"}},
    # _detector_simulation_filter_amp: a 10th-order low-pass at 700 MHz and
    # an 8th-order high-pass at 150 MHz (W02RunSimulation.py:76-80)
    filter_chain=[
        FilterStage((1 * units.MHz, 700 * units.MHz), "butter",
                    {"order": 10}),
        FilterStage((150 * units.MHz, 800 * units.GHz), "butter",
                    {"order": 8}),
    ],
    # _detector_simulation_trigger: a 2/4-coincidence high-low trigger at
    # +-5 sigma within 40 ns, plus a simple 3-sigma threshold for
    # comparison — both evaluated in one fused pass
    triggers=[
        TriggerSpec(name="hilo_2of4_5sigma", threshold_high_sigma=5.0,
                    threshold_low_sigma=-5.0, highlow_coincidence=40.0,
                    number_of_coincidences=2, channels=(0, 1, 2, 3)),
        TriggerSpec(name="simple_3sigma", trigger_type="simple_threshold",
                    threshold_high_sigma=3.0),
    ],
    antenna_replacements={"bicone_v8_inf_n1.78": "analytic_VPol"},
    outputfilename=args.outputfilename,
    nur_outputfilename=args.outputfilenameNuRadioReco,
    dtype=jnp.float64)

res = sim.run()
print(f"simulated {len(res['triggered'])} events; "
      f"{int(res['n_triggered'])} triggered; Veff = "
      f"{res['veff'] / units.km ** 3:.4g} km^3 (x 4pi sr for water "
      f"equivalent comparisons)")
