"""End-to-end conformance: run the full pipeline on the committed
3000-event 1e18 eV input and compare against the golden output of the
REFERENCE simulation (tests/golden/generate_e2e_golden.py — same input, same
config, same analytic_VPol antenna):

* identical triggered event set (above the minimum-weight cut),
* identical weight sum -> identical Veff,
* per-solution observables (C0, launch vectors, travel times, amplitudes)
  of the triggered events.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest

from nuradiomc_tpu.sim.simulation import FilterStage, Simulation, TriggerSpec
from nuradiomc_tpu.utils import units

HERE = os.path.dirname(__file__)
GOLDEN = os.path.join(HERE, "golden", "e2e_reference.npz")
INPUT = os.path.join(HERE, "data", "1e18_n3000.hdf5")
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


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.fixture(scope="module")
def results():
    sim = Simulation(
        INPUT, DETECTOR,
        config={"sampling_rate": 2.0,
                "propagation": {"ice_model": "southpole_2015"},
                "signal": {"model": "Alvarez2000"},
                "weights": {"weight_mode": "core_mantle_crust_simple",
                            "cross_section_type": "ctw"}},
        filter_chain=[
            FilterStage((80 * units.MHz, 1000 * units.GHz), "butter", {"order": 2}),
            FilterStage((0, 500 * units.MHz), "butter", {"order": 10}),
        ],
        trigger=TriggerSpec(threshold_high_sigma=2.0, threshold_low_sigma=-2.0),
        antenna_replacements={
            "XFDTD_Vpol_CrossFeed_150mmHole_n1.78": "analytic_VPol"},
        chunk_size=512,
        dtype=jnp.float64,
    )
    return sim, sim.run()


def test_vrms_matches_reference(golden, results):
    sim, _ = results
    np.testing.assert_allclose(sim.Vrms, float(golden["Vrms"]), rtol=1e-12)
    np.testing.assert_allclose(sim.bandwidth, float(golden["bandwidth"]), rtol=1e-12)


def test_triggered_set_matches_reference(golden, results):
    sim, res = results
    # reference skips events below the weight cut entirely; compare the
    # triggered set above the cut
    min_w = 1e-5
    mine = set(res["group_ids"][(res["triggered"]) & (res["weights"] >= min_w)])
    ref_groups = set(np.unique(golden["group_ids"]))
    assert mine == ref_groups, (sorted(mine), sorted(ref_groups))


def test_weight_sum_and_veff(golden, results):
    sim, res = results
    gid = golden["group_ids"]
    _, first = np.unique(gid, return_index=True)
    ref_sum = golden["weights"][first].sum()
    min_w = 1e-5
    sel = (res["triggered"]) & (res["weights"] >= min_w)
    my_sum = res["weights"][sel].sum()
    np.testing.assert_allclose(my_sum, ref_sum, rtol=1e-6)


def test_per_solution_observables(golden, results):
    """C0 / travel time / launch vectors / per-ray amplitudes of the showers
    of triggered events match the reference output HDF5."""
    sim, res = results
    # rebuild the padded batch to rerun the pipeline for the triggered groups
    group_ids, start, count, order, batch = sim._build_batches()
    import jax
    out, _ = sim._jit_pipeline(
        jax.tree.map(lambda a: a, batch), jax.random.PRNGKey(0))

    gid_to_idx = {g: i for i, g in enumerate(group_ids)}
    inp = sim.input

    c0 = np.asarray(out.c0)            # [G, S, C, 2]
    tt = np.asarray(out.travel_time)
    pl = np.asarray(out.path_length)
    lv = np.asarray(out.launch_vector)
    amp = np.asarray(out.max_amp_per_solution)
    mask = np.asarray(out.sol_mask)

    ref_shower_ids = golden["st_shower_id"]
    for j, sid in enumerate(ref_shower_ids):
        row = int(np.where(inp.shower_ids == sid)[0][0])
        g = gid_to_idx[inp.event_group_ids[row]]
        # shower position inside the group
        rows = order[start[g]:start[g] + count[g]]
        s_idx = int(np.where(rows == row)[0][0])

        ref_c0 = golden["st_ray_tracing_C0"][j, 0]
        ref_tt = golden["st_travel_times"][j, 0]
        ref_pl = golden["st_travel_distances"][j, 0]
        ref_lv = golden["st_launch_vectors"][j, 0]
        ref_amp = golden["st_max_amp_shower_and_ray"][j, 0]

        have = ~np.isnan(ref_c0)
        got_mask = mask[g, s_idx, 0]
        np.testing.assert_array_equal(got_mask, have, err_msg=f"shower {sid}")
        np.testing.assert_allclose(c0[g, s_idx, 0][have], ref_c0[have], rtol=1e-7)
        np.testing.assert_allclose(tt[g, s_idx, 0][have], ref_tt[have], rtol=1e-6)
        np.testing.assert_allclose(pl[g, s_idx, 0][have], ref_pl[have], rtol=1e-6)
        np.testing.assert_allclose(lv[g, s_idx, 0][have], ref_lv[have], atol=1e-6)
        # amplitudes: the reference integrates the attenuation with
        # scipy.quad epsrel=1e-2 (get_attenuation_along_path), so ~1% is the
        # reference's own accuracy floor
        np.testing.assert_allclose(amp[g, s_idx, 0][have], ref_amp[have], rtol=2e-2)


def test_benchmark_settings_reproduce_golden(golden):
    """The benchmark configuration (bench.py: float32, n_freq_attenuation=16,
    attenuation_steps=8 Gauss-Legendre, n_bisect=28) must reproduce the reference-golden
    triggered set — keeping the published throughput number tied to a
    conformance-validated physics configuration.

    Exactness caveat (documented, measured): event group 1272's negative lobe
    sits 2.2% BELOW the -2sigma low threshold at float64 (it does not
    trigger) and 2.3% ABOVE it at float32 (cancellation point between two ray
    contributions) — a genuine borderline case independent of the fast
    solver settings (it flips identically at full accuracy float32). The
    float32 bench config must find every golden event and may pick up at
    most this one documented borderline extra; the float64 production path
    (test_triggered_set_matches_reference) stays exact."""
    sim = Simulation(
        INPUT, DETECTOR,
        config={"sampling_rate": 2.0,
                "propagation": {"ice_model": "southpole_2015", "n_freq": 16,
                                "attenuation_steps": 8, "n_bisect": 28},
                "signal": {"model": "Alvarez2000"},
                "weights": {"weight_mode": "core_mantle_crust_simple",
                            "cross_section_type": "ctw"}},
        filter_chain=[
            FilterStage((80 * units.MHz, 1000 * units.GHz), "butter", {"order": 2}),
            FilterStage((0, 500 * units.MHz), "butter", {"order": 10}),
        ],
        trigger=TriggerSpec(threshold_high_sigma=2.0, threshold_low_sigma=-2.0),
        antenna_replacements={
            "XFDTD_Vpol_CrossFeed_150mmHole_n1.78": "analytic_VPol"},
        chunk_size=512,
        dtype=jnp.float32,
    )
    res = sim.run()
    min_w = 1e-5
    mine = set(res["group_ids"][(res["triggered"]) & (res["weights"] >= min_w)])
    ref_groups = set(np.unique(golden["group_ids"]))
    assert ref_groups <= mine, sorted(ref_groups - mine)
    extras = mine - ref_groups
    assert extras <= {1272}, sorted(extras)

    # bf16 DFT matmuls (`bench.py bf16`; inputs bf16, accumulation f32 via
    # preferred_element_type) must hold the SAME golden set + borderline
    # budget — this test is what licenses flipping matmul_dtype
    import dataclasses
    sim.settings = dataclasses.replace(sim.settings, matmul_dtype="bfloat16")
    sim._jit_step_by_station = {}
    res_b = sim.run()
    mine_b = set(res_b["group_ids"][(res_b["triggered"])
                                    & (res_b["weights"] >= min_w)])
    assert ref_groups <= mine_b, sorted(ref_groups - mine_b)
    assert (mine_b - ref_groups) <= {1272}, sorted(mine_b - ref_groups)

    # band-limited compute (PipelineSettings.band_limit_eps=1e-2): dropping
    # efield-grid rows the order-10 chain suppresses below 1e-2 (K_int
    # 208/257, K_base 816/1025) must hold the SAME golden set + borderline
    # budget — this licenses bench.py enabling it on the headline
    sim.settings = dataclasses.replace(sim.settings, matmul_dtype="float32",
                                       band_limit_eps=1e-2)
    sim._jit_step_by_station = {}
    res_bl = sim.run()
    mine_bl = set(res_bl["group_ids"][(res_bl["triggered"])
                                      & (res_bl["weights"] >= min_w)])
    assert ref_groups <= mine_bl, sorted(ref_groups - mine_bl)
    assert (mine_bl - ref_groups) <= {1272}, sorted(mine_bl - ref_groups)
