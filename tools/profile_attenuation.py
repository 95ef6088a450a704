"""Decompose the attenuation stage's device cost by config ablation.

This script varies the two knobs that scale the two halves of the stage
independently:

* ``attenuation_steps`` (quadrature nodes) scales the SP1 moment
  quadrature (transcendental-bound elementwise work);
* ``n_freq_attenuation`` scales the sparse grid width (the att-interp
  matmul and its input row).

    python -u tools/profile_attenuation.py
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

K_HI, K_LO, N_BLOCKS = 5, 1, 3


def block_time(settings, batch, ch):
    def make(k):
        def block(b):
            def body(i, acc):
                bb = b._replace(energies=b.energies *
                                (1.0 + 1e-7 * i.astype(b.energies.dtype)))
                out = simulate_batch(bb, ch, settings)
                return acc + jnp.sum(out.triggered.astype(jnp.int32))
            return jax.lax.fori_loop(0, k, body, jnp.int32(0))
        return block

    times = {}
    for k in (K_LO, K_HI):
        fn = jax.jit(make(k))
        int(fn(batch))
        best = np.inf
        for _ in range(N_BLOCKS):
            t0 = time.perf_counter()
            int(fn(batch))
            best = min(best, time.perf_counter() - t0)
        times[k] = best
    return (times[K_HI] - times[K_LO]) / (K_HI - K_LO)


def main():
    settings, ch, batch = _make_settings_and_inputs(
        n_groups=65536, n_showers=2, n_channels=1,
        n_internal=512, n_base=2048)
    variants = [
        ("baseline steps=8 nfreq=16", {}),
        ("noatt", {"attenuate_ice": False}),
        ("steps=2", {"attenuation_steps": 2}),
        ("steps=16", {"attenuation_steps": 16}),
        ("nfreq=4", {"n_freq_attenuation": 4}),
        ("nfreq=32", {"n_freq_attenuation": 32}),
    ]
    for name, kw in variants:
        s = dataclasses.replace(settings, **kw)
        t = block_time(s, batch, ch)
        print(json.dumps({"variant": name, "ms_per_step": round(t * 1e3, 2)}),
              flush=True)


if __name__ == "__main__":
    main()
