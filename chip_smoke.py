"""Smoke run of the simulator on NVIDIA GPUs, through the entry points users
call, at the sizes they run.

    python chip_smoke.py               # one card: phases (a)-(d)
    python chip_smoke.py --devices 4   # four cards: the mesh campaign only

One card:

(a) environment: platform, device kind and count, JAX version, the card's
    name and power limit, the compile-cache directory, optional packages;
(b) the reference CI's full-scale Veff campaign (5e4 events at 1e18 eV,
    seed 10; tests/golden/veff_fullscale_reference.npz) through
    ``Simulation.run`` at float64: the triggered set must equal the
    golden's, the weight sum and Veff must agree to rtol 1e-6; prints cold
    seconds (compile included), warm seconds and events/s;
(c) the same campaign at float32: the triggered-set difference to the
    golden may not exceed the CPU float32 run's plus a knife-edge allowance;
(d) the bench cells' float32 conformance probes at the bench widths
    (bench.workload), each against its CPU-pinned per-group decision vector.

Four cards: the float64 campaign over an (event=4, channel=1) and an
(event=2, channel=2) mesh, each equal to a single-device run of the same
input, with proof that all four cards held work.

The script exits non-zero and prints no "ok" line when JAX finds no GPU or
any phase fails. There is no CPU fallback. The last line of its output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

import argparse
import functools
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "tests", "golden", "veff_fullscale_reference.npz")
N_EVENTS = 50000
MIN_WEIGHT = 1e-5
KM3 = 1e9                # units.km ** 3 (lengths are in metres)

# Phase (c): the float32 campaign's triggered-set difference to the float64
# golden, as the same campaign gives it on the CPU at float32 (3 groups:
# tools/device_measure.py campaign float32 with JAX_PLATFORMS=cpu), and the
# knife-edge allowance on top of it for device rounding. The allowance
# scales the headline bench bound (bench.VECTOR_PINS: 56 flips on 9766
# triggered groups) to this campaign's 203 triggered groups (1.2 groups)
# and rounds up with headroom for shadow-boundary solver flips. An NVIDIA
# H100 80GB HBM3 at 700 W gives 4 (PERF.md).
CPU_F32_DELTA = 3
KNIFE_EDGE_ALLOWANCE = 3

# T02RunSimulation.py detector/trigger (the same workflow tests/test_e2e.py
# runs at 3000 events)
DETECTOR = {
    "channels": {"1": {
        "adc_n_samples": 256, "adc_sampling_frequency": 1.0,
        "ant_orientation_phi": 0.0, "ant_orientation_theta": 0.0,
        "ant_position_x": 0.0, "ant_position_y": 0.0, "ant_position_z": -100.0,
        "ant_rotation_phi": 90.0, "ant_rotation_theta": 90.0,
        "ant_type": "XFDTD_Vpol_CrossFeed_150mmHole_n1.78",
        "amp_type": "300", "cab_time_delay": 19.8, "adc_nbits": None,
        "channel_id": 0, "station_id": 101,
    }},
    "stations": {"1": {
        "pos_altitude": 0, "pos_easting": 0, "pos_northing": 0,
        "pos_site": "southpole", "station_id": 101,
    }},
}


def emit(**record):
    print(json.dumps(record), flush=True)


def input_sha1(data_sets):
    """sha1 of an event list, as tests/test_veff_fullscale._input_sha1
    computes it from the written file (sorted datasets, strings as bytes)."""
    h = hashlib.sha1()
    for k in sorted(data_sets):
        arr = np.asarray(data_sets[k])
        if arr.dtype.kind in "OU":
            arr = arr.astype("S")
        h.update(k.encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def fullscale_input(n_events=N_EVENTS, expect_sha1=None):
    """The campaign's event list, generated in memory (no file)."""
    from nuradiomc_tpu.sim import evtgen, io_hdf5
    from nuradiomc_tpu.utils import units

    data, attrs = evtgen.generate_eventlist_cylinder(
        None, n_events, 1e18 * units.eV, 1e18 * units.eV,
        {"fiducial_rmin": 0, "fiducial_rmax": 4 * units.km,
         "fiducial_zmin": -2.7 * units.km, "fiducial_zmax": 0},
        seed=10, cross_sections_model="ctw")
    if expect_sha1 is not None and input_sha1(data) != expect_sha1:
        raise AssertionError("seed-exact event generation diverged from the "
                             "reference input")
    return io_hdf5.event_input(data, attrs)


def fullscale_simulation(event_input, dtype, mesh=None, outputfilename=None):
    """The reference CI campaign's Simulation (test/Veff/1e18eV with the
    analytic_VPol stand-in for the XFDTD pickle)."""
    from nuradiomc_tpu.sim.simulation import (FilterStage, Simulation,
                                              TriggerSpec)
    from nuradiomc_tpu.utils import units

    return Simulation(
        event_input, DETECTOR,
        config={"sampling_rate": 2.0,
                "propagation": {"ice_model": "southpole_2015"},
                "signal": {"model": "Alvarez2000"},
                "weights": {"weight_mode": "core_mantle_crust_simple",
                            "cross_section_type": "ctw"}},
        filter_chain=[
            FilterStage((80 * units.MHz, 1000 * units.GHz), "butter",
                        {"order": 2}),
            FilterStage((0, 500 * units.MHz), "butter", {"order": 10}),
        ],
        trigger=TriggerSpec(threshold_high_sigma=2.0,
                            threshold_low_sigma=-2.0),
        antenna_replacements={
            "XFDTD_Vpol_CrossFeed_150mmHole_n1.78": "analytic_VPol"},
        chunk_size=2048, dtype=dtype, outputfilename=outputfilename,
        mesh=mesh)


def compare_to_golden(res, golden):
    """(triggered-set symmetric difference, weight sum, golden weight sum,
    Veff, golden Veff) of a campaign result against the golden."""
    sel = res["triggered"] & (res["weights"] >= MIN_WEIGHT)
    mine = set(int(g) for g in res["group_ids"][sel])
    ref = set(int(g) for g in np.unique(
        golden["group_ids"][golden["triggered"]]))
    _, first = np.unique(golden["group_ids"], return_index=True)
    ref_sum = float(golden["weights"][first][golden["triggered"][first]].sum())
    wsum = float(res["weights"][sel].sum())
    veff = float(golden["volume"]) * 4 * np.pi * wsum / int(golden["n_events"])
    return sorted(mine ^ ref), wsum, ref_sum, veff, float(golden["veff"])


def timed_campaign(event_input, dtype, mesh=None):
    """Cold run (compile included) and warm rerun in the same process; HDF5
    output is written where h5py is installed."""
    outdir = None
    try:
        import h5py  # noqa: F401
        outdir = tempfile.TemporaryDirectory()
    except ImportError:
        pass
    out = os.path.join(outdir.name, "out.hdf5") if outdir else None
    try:
        t0 = time.perf_counter()
        sim = fullscale_simulation(event_input, dtype, mesh, out)
        res = sim.run()
        cold = time.perf_counter() - t0
        t1 = time.perf_counter()
        res = sim.run()
        warm = time.perf_counter() - t1
    finally:
        if outdir:
            outdir.cleanup()
    return res, cold, warm


def phase_environment(n_devices, cache_dir):
    import jax

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    print("\n".join(smi[:n_devices]), flush=True)

    def importable(name):
        try:
            __import__(name)
            return True
        except ImportError:
            return False

    d = jax.devices()
    emit(phase="a", platform=d[0].platform, kind=d[0].device_kind,
         count=len(d), jax=jax.__version__, nvidia_smi=smi[:n_devices],
         compile_cache=cache_dir, h5py=importable("h5py"),
         yaml=importable("yaml"))


def phase_f64(golden, event_input):
    import jax.numpy as jnp

    res, cold, warm = timed_campaign(event_input, jnp.float64)
    delta, wsum, ref_sum, veff, ref_veff = compare_to_golden(res, golden)
    emit(phase="b", dtype="float64", n_events=N_EVENTS,
         n_triggered=int((res["triggered"]
                          & (res["weights"] >= MIN_WEIGHT)).sum()),
         triggered_set_delta=delta, weight_sum=wsum, golden_weight_sum=ref_sum,
         veff_km3sr=veff / KM3, golden_veff_km3sr=ref_veff / KM3,
         cold_s=cold, warm_s=warm, events_per_s=N_EVENTS / warm)
    if delta:
        raise AssertionError(f"float64 triggered set differs from the "
                             f"golden in {len(delta)} groups: {delta[:20]}")
    np.testing.assert_allclose(wsum, ref_sum, rtol=1e-6)
    np.testing.assert_allclose(veff, ref_veff, rtol=1e-6)


def phase_f32(golden, event_input):
    import jax.numpy as jnp

    res, cold, warm = timed_campaign(event_input, jnp.float32)
    delta, _, _, veff, ref_veff = compare_to_golden(res, golden)
    bound = CPU_F32_DELTA + KNIFE_EDGE_ALLOWANCE
    emit(phase="c", dtype="float32", triggered_set_delta=delta,
         n_delta=len(delta), cpu_f32_delta=CPU_F32_DELTA, bound=bound,
         veff_km3sr=veff / KM3, golden_veff_km3sr=ref_veff / KM3,
         cold_s=cold, warm_s=warm, events_per_s=N_EVENTS / warm)
    if len(delta) > bound:
        raise AssertionError(f"float32 triggered set differs from the golden "
                             f"in {len(delta)} groups (bound {bound})")


def phase_probes():
    import jax

    import bench

    failed = []
    for cell in ("veff_f32", "pa_noiseless", "pa", "raytrace", "gen2"):
        t0 = time.perf_counter()
        step, arg, n_items, _ = bench.workload(cell)
        with jax.enable_x64(False):    # the pins' (and the bench's) mode
            vec = np.asarray(bench.probe(step)(arg))
        pinned = cell in bench.VECTOR_PINS
        emit(phase="d", cell=cell, n_items=n_items, count=int(vec.sum()),
             flips=bench.count_flips(cell, vec)[0] if pinned else None,
             flip_bound=bench.VECTOR_PINS[cell][2] if pinned else None,
             seconds_incl_compile=time.perf_counter() - t0)
        try:
            bench._conformance_check(cell, lambda _: vec, None)
        except AssertionError:
            failed.append(cell)
    if failed:
        raise AssertionError(f"conformance probes failed: {failed}")


def phase_mesh(golden, event_input):
    import jax
    import jax.numpy as jnp

    from nuradiomc_tpu.parallel import mesh as mesh_util

    single, cold, _ = timed_campaign(event_input, jnp.float64)
    delta = compare_to_golden(single, golden)[0]
    emit(phase="mesh", mesh="single", cold_s=cold, triggered_set_delta=delta,
         n_triggered=int(single["triggered"].sum()))
    for n_event, n_channel in ((4, 1), (2, 2)):
        mesh = mesh_util.make_mesh(n_event=n_event, n_channel=n_channel)
        device_sets = set()
        shard_batch = mesh_util.shard_batch

        @functools.wraps(shard_batch)
        def recording(batch, mesh_):
            placed = shard_batch(batch, mesh_)
            device_sets.update(
                len(a.sharding.device_set)
                for a in jax.tree.leaves(placed))
            return placed

        mesh_util.shard_batch = recording
        try:
            res, cold, warm = timed_campaign(event_input, jnp.float64, mesh)
        finally:
            mesh_util.shard_batch = shard_batch
        peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use", 0)
                 for d in jax.devices()]
        emit(phase="mesh", mesh=dict(mesh.shape), cold_s=cold, warm_s=warm,
             n_triggered=int(res["triggered"].sum()),
             chunk_device_sets=sorted(device_sets), peak_bytes_in_use=peaks)
        if not (res["triggered"] == single["triggered"]).all():
            raise AssertionError(f"mesh {dict(mesh.shape)}: triggered differs "
                                 "from the single-device run")
        if not (res["multiple_triggers"]
                == single["multiple_triggers"]).all():
            raise AssertionError(f"mesh {dict(mesh.shape)}: per-trigger "
                                 "matrix differs from the single-device run")
        np.testing.assert_allclose(res["veff"], single["veff"], rtol=1e-9)
        if device_sets != {len(jax.devices())}:
            raise AssertionError(f"chunk inputs spread over {device_sets} "
                                 "devices, not all of them")
        if not all(peaks):
            raise AssertionError(f"a device held no work: peaks {peaks}")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--devices", type=int, default=1, choices=(1, 4),
                        help="1: phases (a)-(d); 4: the mesh campaign only")
    n_devices = parser.parse_args().devices

    import jax

    # JAX falls back to the CPU silently when its CUDA plugin fails to
    # start: check the platform before anything else
    devices = jax.devices()
    if devices[0].platform != "gpu" or len(devices) < n_devices:
        print(f"chip_smoke: needs {n_devices} GPU(s), JAX found "
              f"{len(devices)} {devices[0].platform} device(s)",
              file=sys.stderr)
        return 1
    jax.config.update("jax_enable_x64", True)    # the production dtype
    from nuradiomc_tpu.utils import compile_cache

    cache_dir = compile_cache.enable()

    golden = np.load(GOLDEN)
    phases = [("a", lambda: phase_environment(n_devices, cache_dir))]
    state = {}

    def make_input():
        state["input"] = fullscale_input(
            expect_sha1=golden["input_sha1"].item().decode())

    phases.append(("input", make_input))
    if n_devices == 1:
        phases += [("b", lambda: phase_f64(golden, state["input"])),
                   ("c", lambda: phase_f32(golden, state["input"])),
                   ("d", phase_probes)]
    else:
        phases.append(("mesh", lambda: phase_mesh(golden, state["input"])))

    failed = []
    for name, fn in phases:
        try:
            fn()
        except Exception:    # report every phase, fail at the end
            traceback.print_exc()
            failed.append(name)
            if name == "input":
                break
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
