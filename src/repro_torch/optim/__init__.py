"""Optimizers and distributed-optimization tricks — counterpart of
`repro.optim`.

  adamw     — f32-moment AdamW, FactoredLinear-transparent
  q_adam    — int8-moment Adam (fits deepseek-v3-671b's optimizer state)
  compress  — int8 error-feedback gradient compression (pod axis)
"""
from repro_torch.optim import adamw, compress, q_adam
from repro_torch.optim.adamw import (AdamState, AdamWConfig,
                                     clip_by_global_norm, global_norm)
from repro_torch.optim.q_adam import QAdamState, QTensor

__all__ = ["adamw", "compress", "q_adam", "AdamState", "AdamWConfig",
           "clip_by_global_norm", "global_norm", "QAdamState", "QTensor",
           "make_optimizer"]


def make_optimizer(kind: str):
  """kind: 'adamw' | 'q_adam' -> (init, apply) pair."""
  if kind == "adamw":
    return adamw.init, adamw.apply
  if kind == "q_adam":
    return q_adam.init, q_adam.apply
  raise ValueError(f"unknown optimizer {kind}")
