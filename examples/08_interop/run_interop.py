"""Interoperability demo: event files and trigger modules.

1. Simulate a few events with the production pipeline and write a
   REFERENCE-format .nur file (readable by NuRadioReco's NuRadioRecoio).
2. Read it back with the transparent reader (works for files written by
   either framework) and run the module-level trigger chain on the events.

Run: JAX_PLATFORMS=cpu PYTHONPATH=/root/repo python run_interop.py [n_events]
"""
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import jax.numpy as jnp
import numpy as np

from nuradiomc_tpu.sim import evtgen, io_nur, io_nur_reference
from nuradiomc_tpu.sim.simulation import FilterStage, Simulation, TriggerSpec
from nuradiomc_tpu.reco import trigger_modules as tm
from nuradiomc_tpu.detector.detector import Detector
from nuradiomc_tpu.utils import units

n_events = int(sys.argv[1]) if len(sys.argv) > 1 else 120
tmp = tempfile.mkdtemp(prefix="interop_")

DETECTOR = {
    "channels": {str(i + 1): {
        "adc_n_samples": 256, "adc_sampling_frequency": 1.0,
        "ant_orientation_phi": 0.0, "ant_orientation_theta": 0.0,
        "ant_position_x": 0.0, "ant_position_y": 0.0,
        "ant_position_z": -100.0 - 10.0 * i,
        "ant_rotation_phi": 90.0, "ant_rotation_theta": 90.0,
        "ant_type": "analytic_VPol", "amp_type": "", "cab_time_delay": 0.0,
        "adc_nbits": None, "channel_id": i, "station_id": 101,
    } for i in range(4)},
    "stations": {"1": {"pos_altitude": 0, "pos_easting": 0, "pos_northing": 0,
                       "pos_site": "southpole", "station_id": 101}},
}

infile = os.path.join(tmp, "in.hdf5")
evtgen.generate_eventlist_cylinder(
    infile, n_events, 1e18, 1e18,
    {"fiducial_rmin": 0, "fiducial_rmax": 3 * units.km,
     "fiducial_zmin": -2.7 * units.km, "fiducial_zmax": 0}, seed=7)

own_nur = os.path.join(tmp, "events.nur")
sim = Simulation(
    infile, DETECTOR,
    config={"sampling_rate": 2.0,
            "propagation": {"ice_model": "southpole_2015"},
            "signal": {"model": "Alvarez2000"},
            "weights": {"weight_mode": "core_mantle_crust_simple",
                        "cross_section_type": "ctw"}},
    filter_chain=[FilterStage((80 * units.MHz, 1000 * units.GHz), "butter",
                              {"order": 2}),
                  FilterStage((0, 500 * units.MHz), "butter", {"order": 10})],
    trigger=TriggerSpec(threshold_high_sigma=2.0, threshold_low_sigma=-2.0),
    chunk_size=128, dtype=jnp.float64, nur_outputfilename=own_nur)
res = sim.run()
print(f"simulated {n_events} events, {res['n_triggered']} triggered")

# re-export the triggered events in the REFERENCE .nur format
ref_nur = os.path.join(tmp, "events_reference_format.nur")
writer = io_nur_reference.eventWriter()
writer.begin(ref_nur)
events = list(io_nur.EventReader(own_nur).run())
for evt in events:
    writer.run(evt)
writer.end()
print(f"wrote {len(events)} events in reference .nur format -> {ref_nur}")

# read back through the transparent reader + run the trigger-module chain
det = Detector(DETECTOR)
reader = io_nur.EventReader(ref_nur)     # auto-detects the reference format
high_low = tm.triggerSimulatorHighLow()
n_trig = 0
for evt in reader.run():
    station = evt.get_station(101)
    fired = high_low.run(evt, station, det,
                         threshold_high=2 * sim.Vrms,
                         threshold_low=-2 * sim.Vrms,
                         number_concidences=1)
    n_trig += bool(fired)
print(f"module-level high/low re-trigger on re-imported events: "
      f"{n_trig}/{len(events)} fired")
assert n_trig == len(events)   # the exported events were the triggered ones
print("interop roundtrip OK")
