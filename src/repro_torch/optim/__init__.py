"""Optimizers — counterpart of `repro.optim`, as far as AdamW.

  adamw — f32-moment AdamW, FactoredLinear-transparent
"""
from repro_torch.optim import adamw
from repro_torch.optim.adamw import (AdamState, AdamWConfig,
                                     clip_by_global_norm, global_norm)

__all__ = ["adamw", "AdamState", "AdamWConfig", "clip_by_global_norm",
           "global_norm", "make_optimizer"]


def make_optimizer(kind: str):
  """kind: 'adamw' -> (init, apply) pair."""
  if kind == "adamw":
    return adamw.init, adamw.apply
  if kind == "q_adam":
    raise NotImplementedError(
        "q_adam (int8 moments) is not ported yet: ROADMAP, "
        "\"Distribution\"")
  raise ValueError(f"unknown optimizer {kind}")
