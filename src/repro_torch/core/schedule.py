"""Two-stage training schedule (paper §3.2.2–3.2.3).

Counterpart of `repro.core.schedule`. Stage 1: full-rank factored model
with trace-norm (or l2) regularization. Stage 2: truncated-SVD
warmstart, regularization off. The transition can come well before
stage-1 convergence, and the learning-rate schedule continues across it
as if one model were trained (§3.2.3); §3.2.2's alternative restarts
stage 2 at 3x the final stage-1 rate.

The learning-rate schedules are functions of an int step that return a
float.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

from repro_torch.core.svd import TruncationSpec
from repro_torch.core.tracenorm import RegularizerConfig


@dataclasses.dataclass(frozen=True)
class TwoStageSchedule:
  total_steps: int
  transition_step: int                  # stage-1 -> stage-2 switch
  regularizer: RegularizerConfig        # applied during stage 1 only
  truncation: TruncationSpec            # rank rule at the transition
  # LR policy: "continue" (paper §3.2.3) or "restart_3x" (paper §3.2.2)
  lr_policy: str = "continue"

  def stage(self, step: int) -> int:
    return 1 if step < self.transition_step else 2

  def regularizer_at(self, step: int) -> RegularizerConfig:
    if self.stage(step) == 1:
      return self.regularizer
    return RegularizerConfig(kind="none")

  def stage2_lr_scale(self) -> float:
    return 1.0 if self.lr_policy == "continue" else 3.0


def linear_warmup_exp_decay(base_lr: float, warmup: int, decay: float,
                            decay_every: int) -> Callable[[int], float]:
  """The DS2 learning-rate schedule: linear warmup, then a stepwise
  exponential decay ("anneal by a constant factor each epoch")."""
  def lr(step: int) -> float:
    warm = min(step / max(warmup, 1), 1.0)
    n_decays = math.floor(max(step - warmup, 0.0) / decay_every)
    return base_lr * warm * decay ** n_decays
  return lr


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1) -> Callable[[int], float]:
  """Cosine decay with linear warmup."""
  def lr(step: int) -> float:
    warm = min(step / max(warmup, 1), 1.0)
    t = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + math.cos(math.pi * t))
    return base_lr * warm * cos
  return lr
