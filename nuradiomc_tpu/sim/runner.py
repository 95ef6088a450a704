"""Production job runner.

Replaces the reference batch model (utilities/runner.py:9-99
NuRadioMCRunner — N worker processes each running a full simulation until a
trigger-count/time budget is reached; cluster scaling via file splitting,
documentation running_on_a_cluster.rst:8). Here the equivalent is:

* one process per host (one JAX client), the event axis sharded over the
  local mesh (parallel.mesh); multi-host via ``jax.distributed.initialize``;
* the runner streams input batches through the jitted pipeline until a
  trigger-count or wall-time budget is exhausted, checkpointing the
  accumulated Veff sums so a preempted job resumes where it left off.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Optional

import numpy as np


@dataclasses.dataclass
class RunnerState:
    """Resumable accumulator (the checkpoint payload)."""

    n_events_processed: int = 0
    n_triggered: int = 0
    weight_sum_triggered: float = 0.0
    n_batches: int = 0

    def save(self, path: str):
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f)

    @classmethod
    def load(cls, path: str):
        if not os.path.exists(path):
            return cls()
        with open(path) as f:
            return cls(**json.load(f))


class Runner:
    """Run simulation batches until a trigger-count or time budget is hit.

    Parameters
    ----------
    make_batch : callable(i_batch, rng) -> (batch_inputs, weights)
        Produces the next event batch (e.g. from evtgen or an input file).
    run_batch : callable(batch_inputs) -> (triggered bool array, aux dict)
        Typically a jitted pipeline invocation.
    n_triggers_max : int
        Stop after this many triggered events (runner.py:17 semantics).
    max_runtime : float
        Wall-time budget in seconds.
    checkpoint_path : str, optional
        Where to persist the resumable state after every batch.
    max_crashes : int
        Tolerated consecutive batch failures (runner.py:17 `max_crashes`).
    """

    def __init__(self, make_batch: Callable, run_batch: Callable,
                 n_triggers_max: int = int(1e9),
                 max_runtime: float = 3600.0,
                 checkpoint_path: Optional[str] = None,
                 max_crashes: int = 10,
                 seed: int = 0):
        self.make_batch = make_batch
        self.run_batch = run_batch
        self.n_triggers_max = n_triggers_max
        self.max_runtime = max_runtime
        self.checkpoint_path = checkpoint_path
        self.max_crashes = max_crashes
        self.state = (RunnerState.load(checkpoint_path)
                      if checkpoint_path else RunnerState())
        self._rng = np.random.default_rng(np.random.Philox(seed))

    def run(self):
        t0 = time.time()
        crashes = 0
        while (self.state.n_triggered < self.n_triggers_max
               and time.time() - t0 < self.max_runtime):
            try:
                batch, weights = self.make_batch(self.state.n_batches, self._rng)
                if batch is None:
                    break
                triggered, aux = self.run_batch(batch)
                triggered = np.asarray(triggered)
                weights = np.asarray(weights)
                self.state.n_events_processed += len(triggered)
                self.state.n_triggered += int(triggered.sum())
                self.state.weight_sum_triggered += float(weights[triggered].sum())
                self.state.n_batches += 1
                crashes = 0
                if self.checkpoint_path:
                    self.state.save(self.checkpoint_path)
            except Exception:
                crashes += 1
                if crashes > self.max_crashes:
                    raise
        return self.state
