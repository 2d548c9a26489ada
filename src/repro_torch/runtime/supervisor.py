"""Step supervisor: failure recovery and straggler detection.

Counterpart of `repro.runtime.supervisor`, plain Python. A device failure
surfaces as a `RuntimeError` (a CUDA error, or a lost peer). The
supervisor's contract:

  1. every step runs under the supervisor;
  2. on failure it calls `rebuild()` (on hardware: re-enumerate the
     survivors); in tests a FaultInjector raises at a chosen step;
  3. it restores the latest checkpoint and replays: the stateless data
     streams (`data.speech.batch_at`) regenerate the in-flight batches
     exactly.

Straggler mitigation: a per-step wall-time EWMA; a step slower than
`straggler_factor` x EWMA is recorded and the `on_straggler` hook fires.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional


class SimulatedDeviceFailure(RuntimeError):
  """Stands in for a device error (a CUDA RuntimeError) in tests."""


@dataclasses.dataclass
class FaultInjector:
  """Deterministic fault plan for tests: {step_index: exception}."""
  fail_at: dict = dataclasses.field(default_factory=dict)
  delays: dict = dataclasses.field(default_factory=dict)
  fired: set = dataclasses.field(default_factory=set)

  def check(self, step: int) -> None:
    if step in self.delays:
      time.sleep(self.delays[step])
    if step in self.fail_at and step not in self.fired:
      self.fired.add(step)
      raise SimulatedDeviceFailure(f"injected failure at step {step}")


@dataclasses.dataclass
class SupervisorEvents:
  failures: list = dataclasses.field(default_factory=list)
  recoveries: list = dataclasses.field(default_factory=list)
  stragglers: list = dataclasses.field(default_factory=list)


class Supervisor:

  def __init__(self, *, restore: Callable[[], None],
               rebuild: Optional[Callable[[], None]] = None,
               max_retries: int = 3,
               straggler_factor: float = 3.0,
               ewma_alpha: float = 0.2,
               on_straggler: Optional[Callable[[int, float], None]] = None,
               injector: Optional[FaultInjector] = None):
    self.restore = restore
    self.rebuild = rebuild or (lambda: None)
    self.max_retries = max_retries
    self.straggler_factor = straggler_factor
    self.ewma_alpha = ewma_alpha
    self.on_straggler = on_straggler or (lambda step, t: None)
    self.injector = injector
    self.events = SupervisorEvents()
    self._ewma: Optional[float] = None

  def run_step(self, step: int, fn: Callable[[], Any]) -> Any:
    """Execute one supervised step with recovery."""
    for attempt in range(self.max_retries + 1):
      t0 = time.perf_counter()
      try:
        if self.injector is not None:
          self.injector.check(step)
        out = fn()
        self._track_time(step, time.perf_counter() - t0)
        return out
      except (SimulatedDeviceFailure, RuntimeError) as e:  # CUDA errors
        self.events.failures.append((step, repr(e)))
        if attempt >= self.max_retries:
          raise
        self.rebuild()        # re-enumerate survivors
        self.restore()        # reload the last checkpoint
        self.events.recoveries.append((step, attempt + 1))
    raise RuntimeError("unreachable")

  def _track_time(self, step: int, dt: float) -> None:
    if self._ewma is None:
      self._ewma = dt
      return
    if dt > self.straggler_factor * self._ewma:
      self.events.stragglers.append((step, dt, self._ewma))
      self.on_straggler(step, dt)
    self._ewma = (1 - self.ewma_alpha) * self._ewma + self.ewma_alpha * dt
