"""Fault-tolerance runtime: straggler watchdog, failure simulation hooks,
and elastic re-meshing policy (pure Python: the port keeps its own copy
of the JAX package's `train/fault_tolerance.py`).

On a real multi-pod deployment these hooks sit around the train loop:
  * `StragglerWatchdog` flags steps slower than `threshold` x the rolling
    median — the scheduler can then exclude the slow host and trigger an
    elastic re-mesh.
  * `plan_elastic_mesh` recomputes the largest (data, model)-consistent
    mesh from the surviving device count; checkpoint.restore_resharded
    re-places the state onto it.  Training resumes from the last complete
    manifest with the deterministic data pipeline skipped ahead.
"""
from __future__ import annotations

import dataclasses
import statistics
import time


@dataclasses.dataclass
class StragglerWatchdog:
    threshold: float = 2.0      # x median step time
    window: int = 32
    _times: list = dataclasses.field(default_factory=list)
    _t0: float | None = None

    def step_start(self):
        self._t0 = time.monotonic()

    def step_end(self) -> bool:
        """Record a step; returns True if the step was a straggler."""
        dt = time.monotonic() - self._t0
        straggler = False
        if len(self._times) >= 8:
            med = statistics.median(self._times[-self.window:])
            straggler = dt > self.threshold * med
        self._times.append(dt)
        del self._times[:-self.window]
        return straggler

    @property
    def median(self) -> float:
        return statistics.median(self._times) if self._times else 0.0


def plan_elastic_mesh(n_devices: int, model_parallel: int
                      ) -> tuple[int, int]:
    """Largest (data, model) mesh from surviving devices.

    Keeps model_parallel fixed (parameters are sharded that way on disk);
    drops data-parallel replicas to the largest multiple that fits.  A
    512-chip job losing one 8-chip host re-meshes 63x... -> (63*8/model).
    """
    if n_devices < model_parallel:
        raise ValueError(f"{n_devices} devices cannot hold a model-parallel "
                         f"group of {model_parallel}")
    data = n_devices // model_parallel
    return data, model_parallel


@dataclasses.dataclass
class FailureInjector:
    """Deterministic failure simulation for integration tests."""
    fail_at_steps: tuple = ()

    def check(self, step: int):
        if step in self.fail_at_steps:
            raise RuntimeError(f"injected node failure at step {step}")
