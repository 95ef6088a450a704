"""Attribute the gen2 device-vs-CPU station-count flips to measured
borderline trigger margins (companion to tools/attribute_bench_flips.py,
which covers the headline mode; same two-population claim).

A past use found a real bug this way: flips that were NOT knife-edges
(margins up to |1.8|, NaN margins) came from an f32-catastrophic
birefringence eigenvector formula (fixed in ops/birefringence.py
_eigensystem_2x2, regression test
tests/test_birefringence.py::test_propagation_is_unitary_at_float32).
The tool measures:

1. per-(group, station) triggered DECISIONS from the EXACT bench
   configuration on each backend;
2. per-(group, station) high-low MARGINS margin = (M - T)/T with
   M = max over 5-ns windows of min(window max V, -window min V)
   (tools/margin_audit.py definition) on the trusted keep_traces path
   (band limiting disabled — identical code on both backends), plus the per-station ray-solution-count fingerprint
   (shadow-boundary f32 bisection flips add/remove whole pulses).

`compare` classifies every flipped (group, station) as a threshold
knife-edge (|cpu margin| inside the measured cross-backend rounding
envelope), a solution-existence flip (nsol differs), or UNEXPLAINED —
only the last is a real numerics bug.

Usage (two processes — backend selection is process-wide):

    python -u tools/attribute_gen2_flips.py run gen2_device.npz
    python -u tools/attribute_gen2_flips.py run gen2_cpu.npz --cpu
    python tools/attribute_gen2_flips.py compare gen2_device.npz gen2_cpu.npz
"""
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run(out_path, cpu=False):
    import jax

    if cpu:
        jax.config.update("jax_platforms", "cpu")
    from bench import _gen2_setup
    from nuradiomc_tpu.utils import compile_cache
    compile_cache.enable()

    import jax.numpy as jnp

    from nuradiomc_tpu.sim.pipeline import simulate_batch

    settings, chps, batch = _gen2_setup()
    G = batch.energies.shape[0]
    n_st = len(chps)

    # --- decisions: the exact bench probe configuration -------------------
    @jax.jit
    def probe(b):
        return jnp.stack([simulate_batch(b, chp, settings).triggered
                          .astype(jnp.int32) for chp in chps], axis=1)

    trig = np.asarray(probe(batch))                      # [G, n_st]
    print(f"decisions: station-count sum {int(trig.sum())} / {G} groups",
          flush=True)

    # --- margins + nsol fingerprint: trusted trace path -------------------
    window_bins = max(int(round(settings.highlow_coincidence
                                / (1.0 / settings.sampling_rate))), 1)

    @jax.jit
    def margin_all(b):
        ms, ns = [], []
        for chp in chps:
            out = simulate_batch(b, chp, settings, keep_traces=True)
            tr = out.traces                              # [g, C, n_base]
            win_hi = jax.lax.reduce_window(
                tr, -jnp.inf, jax.lax.max, (1, 1, window_bins), (1, 1, 1),
                "valid")
            win_lo = jax.lax.reduce_window(
                tr, jnp.inf, jax.lax.min, (1, 1, window_bins), (1, 1, 1),
                "valid")
            m = jnp.minimum(win_hi, -win_lo)
            thr = jnp.asarray(chp.threshold_high)[None, :, None]
            ms.append(jnp.max(m / thr - 1.0, axis=(1, 2)))
            ns.append(jnp.sum(out.sol_mask.astype(jnp.int32),
                              axis=(1, 2, 3)))
        return jnp.stack(ms, axis=1), jnp.stack(ns, axis=1)

    m, n = margin_all(batch)
    margins, nsols = np.asarray(m), np.asarray(n)        # [G, n_st]
    print(f"margins: done ({n_st} stations)", flush=True)

    np.savez(out_path, trig=trig, margins=margins, nsols=nsols,
             backend=("cpu" if cpu else jax.devices()[0].platform))
    print(f"wrote {out_path}", flush=True)


def compare(chip_path, cpu_path):
    a, b = np.load(chip_path), np.load(cpu_path)
    trig_chip, trig_cpu = a["trig"].astype(bool), b["trig"].astype(bool)
    m_chip, m_cpu = a["margins"], b["margins"]
    nsol_diff = a["nsols"].astype(int) != b["nsols"].astype(int)

    flips = np.argwhere(trig_chip != trig_cpu)           # [(g, s)]
    flip_groups = sorted(set(int(g) for g, _ in flips))
    same_sol = ~nsol_diff
    non_flip = np.ones(trig_cpu.shape, bool)
    non_flip[tuple(flips.T)] = False

    d = np.abs(m_chip - m_cpu)
    d_same = d[same_sol]
    p99 = float(np.quantile(d_same, 0.99)) if d_same.size else 0.0
    env = 4.0 * max(p99, 1e-3)

    thr_flips = [(int(g), int(s)) for g, s in flips if not nsol_diff[g, s]]
    sol_flips = [(int(g), int(s)) for g, s in flips if nsol_diff[g, s]]
    unexplained = [(g, s) for g, s in thr_flips if abs(m_cpu[g, s]) > env]

    out = {
        "n_groups": int(trig_cpu.shape[0]),
        "station_count_chip": int(trig_chip.sum()),
        "station_count_cpu": int(trig_cpu.sum()),
        "n_flipped_station_decisions": int(len(flips)),
        "n_flipped_groups": len(flip_groups),
        "n_solution_existence_flips": len(sol_flips),
        "n_threshold_flips": len(thr_flips),
        "threshold_flip_cpu_margins": [round(float(m_cpu[g, s]), 5)
                                       for g, s in thr_flips],
        "rounding_envelope": round(env, 6),
        "samesol_margin_perturbation_p50": round(float(np.median(d_same)), 6),
        "samesol_margin_perturbation_p99": round(p99, 6),
        "samesol_margin_perturbation_max": (
            round(float(np.max(d_same)), 6) if d_same.size else None),
        "min_abs_nonflip_samesol_margin": round(float(np.min(
            np.abs(m_cpu[non_flip & same_sol]))), 5),
        "n_within_envelope_of_threshold": int(np.sum(np.abs(m_cpu) < env)),
        "UNEXPLAINED_flips": unexplained,
    }
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    if sys.argv[1] == "run":
        run(sys.argv[2], cpu="--cpu" in sys.argv)
    else:
        compare(sys.argv[2], sys.argv[3])
