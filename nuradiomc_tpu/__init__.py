"""nuradiomc_tpu — a batch-first JAX Monte-Carlo framework for in-ice radio
neutrino detectors.

A ground-up JAX/XLA re-design with the capabilities of
nu-radio/NuRadioMC + NuRadioReco: neutrino event generation, Askaryan signal
generation, batched analytic in-ice ray tracing, detector response, triggers,
and effective-volume bookkeeping — all as struct-of-arrays batches over
[event x station x channel x solution] running as jitted SPMD pipelines over
a `jax.sharding.Mesh`.

Top-level layout
----------------
``utils``     units / fft conventions / config / geometry
``models``    ice models, detector descriptions
``ops``       device kernels: ray tracing, askaryan, attenuation, antenna,
              filters, noise, triggers
``sim``       host-side orchestration: event generation, pipeline, Veff, I/O
``parallel``  mesh + sharding helpers
"""

__version__ = "0.1.0"
