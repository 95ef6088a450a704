"""Per-group device-vs-CPU attribution for the PA-noiseless and raytrace
bench conformance probes (companion to tools/attribute_bench_flips.py,
which covers the headline high-low mode with full margin dumps).

The PA bench batch is the 3000-event e2e input TILED ~5.5x to 16384
groups, so ONE borderline source event flips ~5-6 copies at once — the
flip granularity is the tiling factor. Raytrace flips are f32
bisection-mask flips at the shadow boundary.

This tool dumps the per-group decisions / per-pair solution counts on
each backend and reports how many SOURCE events (mod the tiling) differ,
so the bench tolerances can assert at the right granularity.

    python -u tools/attribute_probe_deltas.py run probe_device.npz
    python -u tools/attribute_probe_deltas.py run probe_cpu.npz --cpu
    python tools/attribute_probe_deltas.py compare probe_device.npz probe_cpu.npz
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
    from bench import _pa_setup
    from nuradiomc_tpu.utils import compile_cache
    compile_cache.enable()

    import dataclasses

    import jax.numpy as jnp

    from nuradiomc_tpu.models import ice as ice_models
    from nuradiomc_tpu.ops import raytrace
    from nuradiomc_tpu.sim.pipeline import simulate_batch

    # --- pa_noiseless per-group decisions (the exact bench probe) ---------
    settings, ch, batch, _ = _pa_setup()
    settings = dataclasses.replace(settings, band_limit_eps=1e-3,
                                   add_noise=False)

    @jax.jit
    def probe_pa(b):
        out = simulate_batch(b, ch, settings)
        return out.triggered.astype(jnp.int32)

    pa_trig = np.asarray(probe_pa(batch))
    print(f"pa_noiseless: {int(pa_trig.sum())} / {len(pa_trig)}", flush=True)

    # --- raytrace per-pair solution counts (the exact bench probe) --------
    ice = ice_models.southpole_simple
    n_pairs = 262144
    rng = np.random.default_rng(3)
    rr = rng.triangular(50.0, 3000.0, 3000.0, n_pairs)
    x1y = np.zeros(n_pairs, np.float32)
    x1z = rng.uniform(-3000.0, 0.0, n_pairs).astype(np.float32)
    x2y = rr.astype(np.float32)
    x2z = np.full(n_pairs, -5.0, np.float32)

    @jax.jit
    def probe_rt(a, b, c, d):
        sols = jax.vmap(lambda w, x, y, z: raytrace.find_solutions(
            w, x, y, z, ice, n_bisect=28))(a, b, c, d)
        return jnp.sum(sols.mask.astype(jnp.int32), axis=-1)

    rt_n = np.asarray(probe_rt(x1y, x1z, x2y, x2z))
    print(f"raytrace: {int(rt_n.sum())} solutions", flush=True)

    np.savez(out_path, pa_trig=pa_trig, rt_n=rt_n, rt_x2y=x2y, rt_x1z=x1z)
    print(f"wrote {out_path}", flush=True)


def compare(chip_path, cpu_path, g0=None):
    a, b = np.load(chip_path), np.load(cpu_path)

    # PA: collapse the tiling — source event s = group index mod g0.
    # The noiseless probe is deterministic, so the CPU decision vector is
    # EXACTLY periodic with the tiling period; recover it directly.
    pa_c, pa_h = b["pa_trig"].astype(bool), a["pa_trig"].astype(bool)
    if g0 is None:
        for p in range(1, len(pa_c)):
            if (pa_c[p:] == pa_c[:-p]).all():
                g0 = p
                break
    flips = np.where(pa_c != pa_h)[0]
    flip_sources = sorted(set(int(i % g0) for i in flips)) if g0 else None

    d = a["rt_n"].astype(int) - b["rt_n"].astype(int)
    rt_diff = np.where(d != 0)[0]

    out = {
        "pa_triggered_chip": int(pa_h.sum()),
        "pa_triggered_cpu": int(pa_c.sum()),
        "pa_flipped_groups": [int(i) for i in flips],
        "pa_flipped_source_events": flip_sources,
        "pa_n_flipped_sources": (len(flip_sources)
                                 if flip_sources is not None else None),
        "rt_solutions_chip": int(a["rt_n"].sum()),
        "rt_solutions_cpu": int(b["rt_n"].sum()),
        "rt_n_pairs_differing": int(len(rt_diff)),
        "rt_diff_values": sorted(set(int(v) for v in d[rt_diff])),
        "rt_diff_fraction": round(float(len(rt_diff)) / len(d), 6),
    }
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    if sys.argv[1] == "run":
        run(sys.argv[2], cpu="--cpu" in sys.argv)
    else:
        g0 = int(sys.argv[4]) if len(sys.argv) > 4 else None
        compare(sys.argv[2], sys.argv[3], g0)
