"""Device measurements behind the bench's choices, one subcommand each.

    python tools/device_measure.py precision OUT_DIR
        DFT matmul precision A/B (pipeline.DFT_PRECISION): per-group flips
        of the bench probes against the CPU pins under DEFAULT and under
        HIGHEST, and the veff / pa block rates under each, timed in turns
        (DEFAULT, HIGHEST, HIGHEST, DEFAULT). Decision vectors -> OUT_DIR.
    python tools/device_measure.py trace OUT_DIR
        jax.profiler trace of the veff float32 bench block; prints the top
        device operations and the placement / trigger_irfft shares (named
        scopes in sim/pipeline.py) of device time. Trace + HLO -> OUT_DIR.
        GPU command buffers are turned off for this run: a CUDA graph shows
        in the trace as one event and hides the kernels inside it.
    python tools/device_measure.py rng
        pa block rate with the rbg PRNG key against the default key, in
        turns.
    python tools/device_measure.py campaign float32|float64
        chip_smoke's full-scale Veff campaign on whatever backend JAX
        picks (JAX_PLATFORMS=cpu for the CPU reference), printing its
        triggered-set difference to the golden.

Every line printed is one JSON record; device records carry the device
kind, and on a GPU the card's name and power limit.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PROBE_CELLS = ("veff_f32", "pa_noiseless", "raytrace", "gen2")


def emit(**record):
    print(json.dumps(record), flush=True)


def device_record():
    import jax

    d = jax.devices()[0]
    rec = {"platform": d.platform, "kind": d.device_kind,
           "count": len(jax.devices())}
    if d.platform == "gpu":
        rec["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
    return rec


def block_seconds(fn, arg, n_blocks=3):
    """Best-of-n wall time of one jitted block ending in a host readback."""
    best = np.inf
    for _ in range(n_blocks):
        t0 = time.perf_counter()
        int(fn(arg))
        best = min(best, time.perf_counter() - t0)
    return best


def precision(out_dir):
    import jax

    import bench
    from nuradiomc_tpu.sim import pipeline

    precisions = {"DEFAULT": jax.lax.Precision.DEFAULT,
                  "HIGHEST": jax.lax.Precision.HIGHEST}
    chosen = pipeline.DFT_PRECISION
    blocks = {}
    for name, prec in precisions.items():
        pipeline.DFT_PRECISION = prec       # read at trace time
        for cell in PROBE_CELLS:
            step, arg, _, _ = bench.workload(cell)
            vec = np.asarray(bench.probe(step)(arg))
            np.save(os.path.join(out_dir, f"{cell}_{name}.npy"), vec)
            n_flips, max_delta = bench.count_flips(cell, vec)
            emit(precision=name, cell=cell, count=int(vec.sum()),
                 flips=n_flips, max_delta=max_delta,
                 bound=bench.VECTOR_PINS[cell][2])
        for cell in ("veff_f32", "pa"):
            step, arg, n_items, k = bench.workload(cell)
            fn = bench.timed_block(step, k)
            int(fn(arg))                    # compile under this precision
            blocks[(name, cell)] = (fn, arg, n_items * k)
    for cell in ("veff_f32", "pa"):
        for name in ("DEFAULT", "HIGHEST", "HIGHEST", "DEFAULT"):
            fn, arg, n = blocks[(name, cell)]
            sec = block_seconds(fn, arg)
            emit(precision=name, cell=cell, events_per_s=n / sec,
                 block_s=sec, **device_record())
    pipeline.DFT_PRECISION = chosen


def _op_names(hlo_text):
    """HLO instruction name -> op_name metadata of what it computes (for a
    fusion, every op_name inside its fused computation)."""
    import re

    names, comp_ops, calls = {}, {}, {}
    comp = None
    for line in hlo_text.splitlines():
        m = re.match(r"^\s*(?:ENTRY\s+)?(%?[\w.\-]+)\s.*\{\s*$", line)
        if m and "=" not in line.split("{")[0]:
            comp = m.group(1).lstrip("%")
            comp_ops[comp] = set()
            continue
        m = re.match(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=", line)
        if not m:
            continue
        inst = m.group(1)
        op = re.search(r'op_name="([^"]*)"', line)
        ops = {op.group(1)} if op else set()
        names[inst] = ops
        if comp is not None:
            comp_ops[comp] |= ops
        c = re.search(r"calls=%?([\w.\-]+)", line)
        if c:
            calls[inst] = c.group(1)
    for inst, c in calls.items():
        names[inst] = names[inst] | comp_ops.get(c, set())
    return names


def trace(out_dir):
    import jax

    import bench

    step, arg, n_items, _ = bench.workload("veff_f32")
    k = 3
    fn = bench.timed_block(step, k)
    int(fn(arg))                                      # compile + warm
    with open(os.path.join(out_dir, "veff_block.hlo.txt"), "w") as f:
        f.write(fn.lower(arg).compile().as_text())
    trace_dir = os.path.join(out_dir, "trace")
    with jax.profiler.trace(trace_dir):
        t0 = time.perf_counter()
        int(fn(arg))
        wall = time.perf_counter() - t0
    emit(what="traced_block", k_steps=k, wall_s=wall,
         events_per_s=n_items * k / wall, **device_record())
    reduce_trace(trace_dir,
                 os.path.join(out_dir, "veff_block.hlo.txt"), k)


def reduce_trace(trace_dir, hlo_path, k_steps, top=25):
    """Top device operations and per-scope shares of device time."""
    import glob

    from jax.profiler import ProfileData

    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    prof = ProfileData.from_file(path)
    names = _op_names(open(hlo_path).read())
    device_lines = [(plane.name, line) for plane in prof.planes
                    if plane.name.startswith("/device:")
                    for line in plane.lines]
    for plane_name, line in device_lines:
        evs = list(line.events)
        emit(what="trace_line", plane=plane_name, line=line.name,
             n_events=len(evs),
             total_ms=sum(e.duration_ns for e in evs) / 1e6)
    # per-kernel events: the "XLA Ops" line where the trace has one,
    # otherwise the stream lines
    wanted = ([ln for _, ln in device_lines if ln.name == "XLA Ops"]
              or [ln for _, ln in device_lines
                  if "stream" in ln.name.lower()])
    by_op, total, t_min, t_max = {}, 0.0, np.inf, -np.inf
    for line in wanted:
        for ev in line.events:
            hlo_op = str(dict(ev.stats).get("hlo_op", ev.name))
            by_op[hlo_op] = by_op.get(hlo_op, 0.0) + ev.duration_ns
            total += ev.duration_ns
            t_min = min(t_min, ev.start_ns)
            t_max = max(t_max, ev.start_ns + ev.duration_ns)
    if not total:
        raise RuntimeError(f"no device kernel events in {path}")
    scopes = {"placement": 0.0, "trigger_irfft": 0.0}
    for op, ns in by_op.items():
        ops = names.get(op, set())
        for scope in scopes:
            if any(f"/{scope}/" in o for o in ops):
                scopes[scope] += ns
                break
    emit(what="device_time", total_ms=total / 1e6,
         per_step_ms=total / 1e6 / k_steps,
         window_ms=(t_max - t_min) / 1e6,
         shares={s: v / total for s, v in scopes.items()})
    for op, ns in sorted(by_op.items(), key=lambda kv: -kv[1])[:top]:
        emit(what="top_op", op=op, ms=ns / 1e6, share=ns / total,
             op_names=sorted(names.get(op, set()))[:3])


def rng():
    import dataclasses

    import jax
    import jax.numpy as jnp

    import bench
    from nuradiomc_tpu.sim.pipeline import simulate_batch

    settings, ch, batch, _ = bench._pa_setup()
    settings = dataclasses.replace(settings, band_limit_eps=1e-3)
    n = batch.energies.shape[0]
    fns = {}
    for impl in ("rbg", "default"):
        key = jax.random.key(0, impl="rbg") if impl == "rbg" \
            else jax.random.key(0)

        def step(b, i, key=key):
            return simulate_batch(b, ch, settings,
                                  noise_key=jax.random.fold_in(key, i)
                                  ).triggered.astype(jnp.int32)
        fns[impl] = bench.timed_block(step, 25)
        int(fns[impl](batch))
    for impl in ("rbg", "default", "default", "rbg"):
        sec = block_seconds(fns[impl], batch)
        emit(what="pa_rng", impl=impl, events_per_s=n * 25 / sec,
             block_s=sec, **device_record())


def campaign(dtype_name):
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    import chip_smoke

    golden = np.load(chip_smoke.GOLDEN)
    inp = chip_smoke.fullscale_input(
        expect_sha1=golden["input_sha1"].item().decode())
    t0 = time.perf_counter()
    res = chip_smoke.fullscale_simulation(
        inp, getattr(jnp, dtype_name)).run()
    delta, wsum, ref_sum, veff, ref_veff = chip_smoke.compare_to_golden(
        res, golden)
    km3 = chip_smoke.KM3
    emit(what="campaign", dtype=dtype_name, triggered_set_delta=delta,
         n_delta=len(delta), weight_sum=wsum, golden_weight_sum=ref_sum,
         veff_km3sr=veff / km3, golden_veff_km3sr=ref_veff / km3,
         seconds=time.perf_counter() - t0, **device_record())


def main():
    if sys.argv[1] == "trace":     # before the backend starts
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_gpu_enable_command_buffer=")
    from nuradiomc_tpu.utils import compile_cache

    compile_cache.enable()
    what, args = sys.argv[1], sys.argv[2:]
    if what in ("precision", "trace"):
        os.makedirs(args[0], exist_ok=True)
    {"precision": precision, "trace": trace, "rng": rng,
     "campaign": campaign}[what](*args)


if __name__ == "__main__":
    main()
