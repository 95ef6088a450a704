"""Cumulative stop-after ladder: attribute the REAL full step exactly.

Isolated stage timings do not compose — XLA overlaps copies with
compute and removes output-only work,
so the only attribution that adds up is a ladder of truncated versions of
the REAL bench program (PipelineSettings.stop_after), each keeping
everything up to its anchor live and everything later dead. Successive
differences = the marginal cost of each stage IN CONTEXT.

Measurement: all 14 programs (7 anchors x k in {1, 5}) are compiled/
loaded up front (they hit the persistent executable cache), then timed
in ROUND-ROBIN interleaved blocks so device drift hits every anchor
equally; per-program minima are differenced. Anchors:
ray -> spec -> attquad -> scalars -> placement -> filter -> full.

    python -u tools/profile_ladder.py [n_blocks] [band_limit_eps]

(pass band_limit_eps=1e-2 to profile the published band-limited headline
configuration; default 0 = the exact full-width step)
"""
import dataclasses
import json
import sys
import time

import numpy as np

sys.path.insert(0, ".")

from nuradiomc_tpu.utils import compile_cache

compile_cache.enable()

import jax
import jax.numpy as jnp

from __graft_entry__ import _make_settings_and_inputs
from nuradiomc_tpu.sim.pipeline import simulate_batch

K_HI, K_LO = 5, 1
ANCHORS = ["ray", "spec", "attquad", "scalars", "placement", "filter", ""]


def main():
    n_blocks = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    settings, ch, batch = _make_settings_and_inputs(
        n_groups=65536, n_showers=2, n_channels=1,
        n_internal=512, n_base=2048)
    eps = float(sys.argv[2]) if len(sys.argv) > 2 else 0.0
    settings = dataclasses.replace(settings, band_limit_eps=eps)

    def make(s, k):
        def block(b):
            def body(i, acc):
                bb = b._replace(energies=b.energies *
                                (1.0 + 1e-7 * i.astype(b.energies.dtype)))
                out = simulate_batch(bb, ch, s)
                return acc + jnp.sum(out.triggered.astype(jnp.int32))
            return jax.lax.fori_loop(0, k, body, jnp.int32(0))
        return block

    fns = {}
    for anchor in ANCHORS:
        s = dataclasses.replace(settings, stop_after=anchor)
        for k in (K_LO, K_HI):
            fn = jax.jit(make(s, k))
            t0 = time.perf_counter()
            int(fn(batch))           # compile/load + warm
            print(json.dumps({"warm": anchor or "full", "k": k,
                              "sec": round(time.perf_counter() - t0, 1)}),
                  flush=True)
            fns[(anchor, k)] = fn

    best = {key: np.inf for key in fns}
    for blk in range(n_blocks):
        for key, fn in fns.items():
            t0 = time.perf_counter()
            int(fn(batch))
            best[key] = min(best[key], time.perf_counter() - t0)
        print(json.dumps({"block": blk}), flush=True)

    prev = 0.0
    for anchor in ANCHORS:
        t = (best[(anchor, K_HI)] - best[(anchor, K_LO)]) / (K_HI - K_LO)
        print(json.dumps({"through": anchor or "full",
                          "cumulative_ms": round(t * 1e3, 2),
                          "marginal_ms": round((t - prev) * 1e3, 2)}),
              flush=True)
        prev = t


if __name__ == "__main__":
    main()
