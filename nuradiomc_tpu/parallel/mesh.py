"""Device mesh and sharding helpers.

The reference scales by file splitting + cluster batch jobs
(SURVEY.md 2.9; generator.py:88-199, utilities/runner.py). The batch-first
equivalent is SPMD over a `jax.sharding.Mesh`:

* ``event`` axis — data parallelism over event groups (the physics MC's
  embarrassingly parallel axis; replaces file splitting),
* ``channel`` axis — model-parallel-style sharding over detector channels
  for very large arrays (phased arrays, LOFAR-scale stations); trigger
  majority reductions become XLA collectives over this axis.

``Simulation(..., mesh=...)`` runs the production orchestrator over the
mesh: every chunk is placed with a NamedSharding over the event axis, the
channel constants are replicated (or channel-sharded when they divide), and
the per-chunk trigger count is reduced with a device-side psum inside the
jitted program. Multi-host extends the same program via
``initialize_distributed()`` + per-host input reading.
"""

from __future__ import annotations

import logging
import warnings

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

logger = logging.getLogger("nuradiomc_tpu.parallel")


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, **kwargs):
    """Initialize multi-host JAX (jax.distributed.initialize wrapper).

    With no arguments, relies on the environment auto-detection that JAX
    ships for SLURM / Open MPI clusters. Safe to call twice (the second
    call is a no-op with a warning). Single-process setups can skip this
    entirely.
    """
    try:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id, **kwargs)
    except RuntimeError as e:           # already initialized
        warnings.warn(f"jax.distributed already initialized: {e}")
    return jax.process_index(), jax.process_count()


def make_mesh(n_event: int | None = None, n_channel: int = 1,
              devices=None) -> Mesh:
    """Build a (event, channel) mesh over the available devices.

    If the requested shape does not match the device count, the mesh falls
    back to the largest (event, channel<=2) factorization that fits — with a
    warning, since silently changing the requested parallelism can mask a
    misconfigured job.
    """
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if n_event is None:
        n_event = n // n_channel
    if n_event * n_channel != n:
        requested = (n_event, n_channel)
        n_channel = 2 if (n % 2 == 0 and n >= 2) else 1
        n_event = n // n_channel
        warnings.warn(
            f"requested mesh {requested} does not match {n} visible devices; "
            f"using ({n_event}, {n_channel}) instead")
    dev_array = np.array(devices).reshape(n_event, n_channel)
    return Mesh(dev_array, axis_names=("event", "channel"))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for ShowerBatch leaves: shard the leading group axis."""
    return NamedSharding(mesh, P("event"))


def channel_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for ChannelParams leaves: shard the leading channel axis."""
    return NamedSharding(mesh, P("channel"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_groups(n_groups: int, mesh: Mesh) -> int:
    """Smallest multiple of the event-axis size >= n_groups."""
    n_ev = mesh.shape["event"]
    return ((n_groups + n_ev - 1) // n_ev) * n_ev


def shard_batch(batch, mesh: Mesh):
    """Place a ShowerBatch with its group axis split over the event axis.

    The group axis must be divisible by the event-axis size (pad with
    ``pad_groups`` first).
    """
    s = batch_sharding(mesh)
    n_ev = mesh.shape["event"]

    def place(a):
        if a is None:
            return None
        if a.shape[0] % n_ev:
            raise ValueError(
                f"group axis {a.shape[0]} not divisible by event axis {n_ev}; "
                "pad the batch first (mesh.pad_groups)")
        return jax.device_put(a, s)

    return jax.tree.map(place, batch)


def shard_channels(ch, mesh: Mesh):
    """Place ChannelParams split over the channel axis when it divides,
    replicated otherwise."""
    n_ch = mesh.shape["channel"]
    C = ch.positions.shape[0]
    if n_ch > 1 and C % n_ch == 0:
        s = channel_sharding(mesh)
    else:
        if n_ch > 1:
            logger.info("channel count %d not divisible by channel axis %d; "
                        "replicating channel constants", C, n_ch)
        s = replicated(mesh)
    return jax.tree.map(lambda a: jax.device_put(a, s), ch)
