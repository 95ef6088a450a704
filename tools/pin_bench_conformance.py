"""Pin what bench.py's device-side conformance probes assert.

Runs each deterministic bench cell (bench.workload) for ONE unperturbed
step on the CPU backend — the trusted path: the same code the golden e2e
tests validate against the reference — and either prints the triggered
counts (bench.EXPECTED_COUNTS) or writes the per-group decision vectors
(bench.VECTOR_PINS, tests/golden/bench_pins.npz):

* veff_trig   [65536]  u8  — headline decisions
* pa_nl_trig  [16384]  u8  — noiseless PA decisions (+ pa_g0, the tiling
                             period: flips are counted per SOURCE event)
* rt_nsol     [262144] u32 — solutions found per ray-trace pair
* gen2_trig   [256]    u8  — stations triggered per composed-workload group

Every vector run also prints its flips against the committed pins, so a
re-pin states how many groups it moves.

    python tools/pin_bench_conformance.py counts [cell ...]
    python tools/pin_bench_conformance.py vectors [OUT.npz [CHUNK]]
"""

import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PIN_DTYPES = {"veff_trig": np.uint8, "pa_nl_trig": np.uint8,
              "rt_nsol": np.uint32, "gen2_trig": np.uint8}


def decisions(cell, chunk=None):
    """The CPU decision vector of one bench cell's unperturbed step,
    evaluated ``chunk`` items at a time when given (every item's decision
    is independent of the others; chunks bound the host memory)."""
    import jax

    import bench

    step, arg, n, _ = bench.workload(cell)
    fn = bench.probe(step)
    chunk = chunk or n
    return np.concatenate([
        np.asarray(fn(jax.tree.map(lambda a: a[i:i + chunk], arg)))
        for i in range(0, n, chunk)])


def write_vector_pins(out, chunk=None):
    import bench

    pins = {}
    for cell, (key, _, _) in bench.VECTOR_PINS.items():
        vec = decisions(cell, chunk)
        n_flips, max_delta = bench.count_flips(cell, vec)
        print(json.dumps({"cell": cell, "sum": int(vec.sum()),
                          "flips_vs_committed": n_flips,
                          "max_delta": max_delta}), flush=True)
        pins[key] = vec.astype(PIN_DTYPES[key])
        if key == "pa_nl_trig":
            # tiling period = source-event count (decisions are periodic)
            for p in range(1, len(vec)):
                if (vec[p:] == vec[:-p]).all():
                    pins["pa_g0"] = np.asarray(p)
                    break
    np.savez_compressed(out, **pins)
    print("wrote", out, flush=True)


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    from nuradiomc_tpu.utils import compile_cache

    compile_cache.enable()
    what = sys.argv[1] if len(sys.argv) > 1 else "counts"
    if what == "vectors":
        write_vector_pins(
            sys.argv[2] if len(sys.argv) > 2 else os.path.join(
                ROOT, "tests", "golden", "bench_pins.npz"),
            int(sys.argv[3]) if len(sys.argv) > 3 else None)
        return
    import bench

    cells = sys.argv[2:] or [c for c, (n, _) in bench.EXPECTED_COUNTS.items()
                             if n is not None]
    print(json.dumps({c: int(decisions(c).sum()) for c in cells}),
          flush=True)


if __name__ == "__main__":
    main()
