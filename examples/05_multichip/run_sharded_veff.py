"""Multi-chip effective-volume production over a (event, channel) device mesh.

On real hardware this runs unchanged over the host's GPUs; here it
demonstrates the sharding on a virtual 8-device CPU mesh:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python run_sharded_veff.py

Event groups are data-parallel over the 'event' axis; detector channels are
model-parallel over the 'channel' axis; the Veff reduction is a cross-device
sum the compiler lowers to a psum across devices.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from __graft_entry__ import _make_settings_and_inputs
from nuradiomc_tpu.parallel import mesh as mesh_util
from nuradiomc_tpu.sim.pipeline import simulate_batch

n_dev = len(jax.devices())
mesh = mesh_util.make_mesh(n_event=max(n_dev // 2, 1),
                           n_channel=2 if n_dev % 2 == 0 else 1)
print(f"devices: {n_dev}, mesh: {dict(mesh.shape)}")

settings, ch, batch = _make_settings_and_inputs(
    n_groups=64, n_showers=2, n_channels=4, n_internal=256, n_base=512)
batch = mesh_util.shard_batch(batch, mesh)
ch = jax.tree.map(lambda a: jax.device_put(
    a, NamedSharding(mesh, P("channel"))), ch)


@jax.jit
def production_step(b, c):
    out = simulate_batch(b, c, settings)
    # global trigger count: XLA inserts the cross-device reduction
    return jnp.sum(out.triggered.astype(jnp.int32)), out.max_amplitude


n_trig, max_amp = jax.block_until_ready(production_step(batch, ch))
print("sharding of max_amplitude:", max_amp.sharding)
print(f"triggered {int(n_trig)} / {batch.energies.shape[0]} groups")

# ---------------------------------------------------------------------------
# The production orchestrator runs over the same mesh directly: pass mesh=
# to Simulation and every chunk is sharded over the event axis (channel
# constants shard over the channel axis when they divide). This is the
# replacement for the reference's file splitting + cluster jobs
# (EvtGen/generator.py:88-199, utilities/runner.py:9-99).
# ---------------------------------------------------------------------------
import tempfile

from nuradiomc_tpu.sim import evtgen
from nuradiomc_tpu.sim.simulation import FilterStage, Simulation, TriggerSpec
from nuradiomc_tpu.utils import units

tmp = tempfile.mkdtemp(prefix="sharded_veff_")
infile = os.path.join(tmp, "in.hdf5")
n_events = int(sys.argv[1]) if len(sys.argv) > 1 else 200
evtgen.generate_eventlist_cylinder(
    infile, n_events, 1e18, 1e18,
    {"fiducial_rmin": 0, "fiducial_rmax": 3 * units.km,
     "fiducial_zmin": -2.7 * units.km, "fiducial_zmax": 0}, seed=21)

detector = {
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

sim = Simulation(
    infile, detector,
    config={"sampling_rate": 2.0,
            "propagation": {"ice_model": "southpole_2015"},
            "signal": {"model": "Alvarez2000"},
            "weights": {"weight_mode": "core_mantle_crust_simple",
                        "cross_section_type": "ctw"}},
    filter_chain=[FilterStage((80 * units.MHz, 1000 * units.GHz), "butter",
                              {"order": 2}),
                  FilterStage((0, 500 * units.MHz), "butter", {"order": 10})],
    trigger=TriggerSpec(threshold_high_sigma=2.0, threshold_low_sigma=-2.0),
    chunk_size=104, dtype=jnp.float64,
    outputfilename=os.path.join(tmp, "out.hdf5"),
    mesh=mesh)
res = sim.run()
print(f"production Simulation over mesh {dict(mesh.shape)}: "
      f"n_triggered={res['n_triggered']} veff={res['veff']:.4g} m^3")
