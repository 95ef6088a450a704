"""Attribute the device-vs-CPU headline decision flips to measured
borderline trigger margins.

bench.py bounds the per-group flips on the headline configuration with the
ARGUMENT that device f32 rounding (fma contraction, transcendental
implementations, matmul accumulation order) only flips knife-edge threshold
crossings.  This tool closes the argument with data:

1. per-group triggered DECISIONS from the EXACT bench configuration
   (band_limit_eps=1e-2) on each backend — the groups where they differ are THE flips inside
   bench.py's tolerance;
2. per-group high-low trigger MARGINS margin = (M - T)/T with
   M = max over 5-ns windows of min(window max V, -window min V)
   (the tools/margin_audit.py definition, computed on-device from the
   assembled traces) on each backend.

`compare` then asserts every flipped group sits inside the borderline
band (|cpu margin| below the cross-backend margin perturbation p99-ish
bound) and that the closest NON-flipped group is far outside it.

Usage (two processes — backend selection is process-wide):

    python -u tools/attribute_bench_flips.py run flips_device.npz
    python -u tools/attribute_bench_flips.py run flips_cpu.npz --cpu
    python tools/attribute_bench_flips.py compare flips_device.npz flips_cpu.npz
"""
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CHUNK = 8192          # margin pass keeps [CHUNK, C, n_base] traces on device


def run(out_path, cpu=False):
    import jax

    if cpu:
        jax.config.update("jax_platforms", "cpu")
    from bench import _veff_settings_and_inputs
    from nuradiomc_tpu.utils import compile_cache
    compile_cache.enable()

    import jax.numpy as jnp

    from nuradiomc_tpu.sim.pipeline import simulate_batch

    # --- decisions: the EXACT headline bench configuration ----------------
    settings, ch, batch = _veff_settings_and_inputs()
    G = batch.energies.shape[0]

    @jax.jit
    def probe(b):
        out = simulate_batch(b, ch, settings)
        return out.triggered.astype(jnp.int32)

    triggered = np.asarray(probe(batch))
    print(f"decisions: {int(triggered.sum())} triggered / {G}", flush=True)

    # --- margins: trusted trace path (keep_traces disables band limiting
    # — IDENTICAL code path on both backends, so the cross-backend margin
    # perturbation is pure backend rounding) -------------------------------
    thr = float(np.asarray(ch.threshold_high)[0])
    window_bins = max(int(round(settings.highlow_coincidence
                                / (1.0 / settings.sampling_rate))), 1)

    @jax.jit
    def margin_chunk(b):
        out = simulate_batch(b, ch, settings, keep_traces=True)
        tr = out.traces                              # [g, C, n_base]
        win_hi = jax.lax.reduce_window(
            tr, -jnp.inf, jax.lax.max, (1, 1, window_bins), (1, 1, 1),
            "valid")
        win_lo = jax.lax.reduce_window(
            tr, jnp.inf, jax.lax.min, (1, 1, window_bins), (1, 1, 1),
            "valid")
        m = jnp.minimum(win_hi, -win_lo)             # both crossings in-window
        margin = jnp.max(m, axis=(1, 2)) / thr - 1.0     # [g]
        # solution-existence fingerprint: which (shower, channel, ray)
        # slots found a ray — backends can disagree at the shadow boundary
        # (f32 bisection), which adds/removes WHOLE pulses (flips with
        # arbitrarily large trigger margins, unlike threshold knife-edges)
        nsol = jnp.sum(out.sol_mask.astype(jnp.int32), axis=(1, 2, 3))
        return margin, nsol

    margins = np.zeros(G, np.float32)
    nsols = np.zeros(G, np.int32)
    for i0 in range(0, G, CHUNK):
        sl = slice(i0, min(i0 + CHUNK, G))
        chunk = jax.tree.map(lambda a: np.asarray(a)[sl], batch)
        m, n = margin_chunk(chunk)
        margins[sl] = np.asarray(m)
        nsols[sl] = np.asarray(n)
        print(f"margins: {sl.stop}/{G}", flush=True)

    np.savez(out_path, triggered=triggered, margins=margins, nsols=nsols,
             backend=("cpu" if cpu else jax.devices()[0].platform))
    print(f"wrote {out_path}", flush=True)


def stability(out_path, cpu=True, scales=(1e-6, 3e-6, 1e-5)):
    """CPU-only instability fingerprint: which groups flip their decision
    under tiny relative input perturbations ON THE SAME BACKEND?

    The set of perturbation-unstable groups is the backend-independent
    definition of 'knife-edge'; the attribution claim for cross-backend
    flips is that they live inside this set (plus the solution-existence
    boundary set). Scales bracket the f32 ulp (~6e-8 relative) by 1-2
    orders — a group stable at 1e-5 relative cannot legitimately flip
    from backend rounding.
    """
    import jax

    if cpu:
        jax.config.update("jax_platforms", "cpu")
    from bench import _veff_settings_and_inputs
    from nuradiomc_tpu.utils import compile_cache
    compile_cache.enable()

    import jax.numpy as jnp

    from nuradiomc_tpu.sim.pipeline import simulate_batch

    settings, ch, batch = _veff_settings_and_inputs()

    @jax.jit
    def probe(b, eps):
        bb = b._replace(energies=b.energies * (1.0 + eps))
        out = simulate_batch(bb, ch, settings)
        return out.triggered.astype(jnp.int32)

    base = np.asarray(probe(batch, np.float32(0.0)))
    unstable = np.zeros(len(base), bool)
    for s in scales:
        for sign in (+1.0, -1.0):
            v = np.asarray(probe(batch, np.float32(sign * s)))
            unstable |= v != base
            print(f"eps={sign * s:+.0e}: {int((v != base).sum())} flips "
                  f"(cum {int(unstable.sum())})", flush=True)
    np.savez(out_path, base=base, unstable=unstable)
    print(f"wrote {out_path}", flush=True)


def compare(chip_path, cpu_path):
    a = np.load(chip_path)
    b = np.load(cpu_path)
    trig_chip, m_chip = a["triggered"].astype(bool), a["margins"]
    trig_cpu, m_cpu = b["triggered"].astype(bool), b["margins"]
    has_nsol = "nsols" in a and "nsols" in b

    flips = np.where(trig_chip != trig_cpu)[0]
    # two distinct f32 boundary populations:
    #  * threshold knife-edges — same ray solutions, |margin| ~ rounding
    #  * solution-existence knife-edges — the backends disagree whether a
    #    shadow-boundary ray EXISTS (same family as the raytrace probe's
    #    mask flips), so a whole pulse (dis)appears and the margin jumps
    #    arbitrarily. Identified by nsol_chip != nsol_cpu.
    if has_nsol:
        nsol_diff = a["nsols"].astype(int) != b["nsols"].astype(int)
    else:
        nsol_diff = np.zeros(len(m_cpu), bool)
    same_sol = ~nsol_diff
    d = np.abs(m_chip - m_cpu)
    non_flip = np.ones(len(m_cpu), bool)
    non_flip[flips] = False

    thr_flips = [i for i in flips if not nsol_diff[i]]
    sol_flips = [i for i in flips if nsol_diff[i]]
    # rounding envelope measured ONLY over same-solution groups
    d_same = d[same_sol]
    p99 = float(np.quantile(d_same, 0.99)) if d_same.size else 0.0
    env = 4.0 * max(p99, 1e-3)

    out = {
        "n_groups": int(len(m_cpu)),
        "triggered_chip": int(trig_chip.sum()),
        "triggered_cpu": int(trig_cpu.sum()),
        "n_decision_flips": int(len(flips)),
        "n_solution_existence_flips": len(sol_flips),
        "n_threshold_flips": len(thr_flips),
        "n_groups_nsol_differs": int(nsol_diff.sum()),
        "threshold_flip_cpu_margins": [round(float(m_cpu[i]), 5)
                                       for i in thr_flips],
        "max_abs_threshold_flip_margin": (
            round(float(max(abs(m_cpu[i]) for i in thr_flips)), 5)
            if thr_flips else None),
        "min_abs_nonflip_samesol_margin": round(float(np.min(
            np.abs(m_cpu[non_flip & same_sol]))), 5),
        "samesol_margin_perturbation_p50": round(
            float(np.median(d_same)), 6),
        "samesol_margin_perturbation_p99": round(p99, 6),
        "samesol_margin_perturbation_max": round(
            float(np.max(d_same)), 6) if d_same.size else None,
        "n_within_1pct": int(np.sum(np.abs(m_cpu) < 0.01)),
        "attribution_envelope": round(env, 6),
    }
    # instability fingerprint (run `stability` first): flips must live in
    # the CPU-only perturbation-unstable set or the solution-boundary set
    stab_path = os.path.join(os.path.dirname(cpu_path), "stability_cpu.npz")
    if os.path.exists(stab_path):
        st = np.load(stab_path)
        unstable = st["unstable"].astype(bool)
        out["n_unstable_groups_cpu"] = int(unstable.sum())
        unattributed = [int(i) for i in flips
                        if not unstable[i] and not nsol_diff[i]]
        out["flips_not_unstable_and_samesol"] = unattributed
        out["attributed"] = not unattributed
    else:
        # fallback: every same-solution flip within the rounding envelope
        out["attributed"] = bool(all(
            abs(float(m_cpu[i])) < env for i in thr_flips))
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    if sys.argv[1] == "run":
        run(sys.argv[2], cpu="--cpu" in sys.argv)
    elif sys.argv[1] == "stability":
        stability(sys.argv[2])
    else:
        compare(sys.argv[2], sys.argv[3])
