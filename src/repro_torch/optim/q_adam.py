"""Int8-quantized-state Adam — counterpart of `repro.optim.q_adam`, the
optimizer state that lets deepseek-v3-671b's moments fit (2 bytes a
parameter against AdamW's 8).

Both moments are stored as int8 with per-row (last-axis) f32 scales:
   m ~ q_m * scale_m,   one scale per leading index, symmetric, amax/127.
Each step dequantizes, applies the Adam update in f32, and requantizes.
Weight decay applies to params with ndim >= 2 only. A scalar param is
kept as a (1,) moment, as the reference's.

State cost: 2 bytes/param + scales (4 / last_dim bytes a param).

On DTensors (a mesh) the same code runs on every rank: a moment has its
parameter's layout, its scale the layout with the last axis whole, and
the per-row amax of a column-split parameter is a max across the model
ranks, so every scale equals the unsharded one.
"""
from __future__ import annotations

from typing import Mapping, NamedTuple

import torch

from repro_torch.optim.adamw import (AdamWConfig, Params, _tree,
                                     clip_by_global_norm)


class QTensor(NamedTuple):
  q: torch.Tensor          # int8, the param's shape
  scale: torch.Tensor      # f32, param.shape[:-1] + (1,)


class QAdamState(NamedTuple):
  step: int
  m: dict                  # {path: QTensor}
  v: dict


def _quantize(x: torch.Tensor) -> QTensor:
  amax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
  scale = torch.clamp(amax, min=1e-12) / 127.0
  q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
  return QTensor(q=q, scale=scale)


def _dequantize(t: QTensor) -> torch.Tensor:
  return t.q.to(torch.float32) * t.scale


def _zeros(p: torch.Tensor) -> QTensor:
  if p.ndim == 0:
    return QTensor(q=torch.zeros((1,), dtype=torch.int8, device=p.device),
                   scale=torch.zeros((1,), dtype=torch.float32,
                                     device=p.device))
  q = torch.zeros_like(p, dtype=torch.int8,
                       memory_format=torch.contiguous_format)
  # the scale: the param's layout with the last axis whole
  return QTensor(q=q, scale=torch.amax(q.float(), dim=-1, keepdim=True))


def init(params: Params) -> QAdamState:
  tree = _tree(params)
  return QAdamState(step=0, m={k: _zeros(p) for k, p in tree.items()},
                    v={k: _zeros(p) for k, p in tree.items()})


def state_bytes(state: QAdamState) -> int:
  """Bytes of the moments (payloads and scales), on this rank."""
  def nbytes(t):
    t = getattr(t, "_local_tensor", t)
    return t.numel() * t.element_size()
  return sum(nbytes(x.q) + nbytes(x.scale)
             for mom in (state.m, state.v) for x in mom.values())


@torch.no_grad()
def apply(params: Params, grads: Mapping[str, torch.Tensor],
          state: QAdamState, lr: float, cfg: AdamWConfig
          ) -> tuple[Params, QAdamState, dict]:
  """One update of `params` in place; returns (params, the new state,
  metrics). `grads` is keyed like the params."""
  tree = _tree(params)
  metrics = {}
  if cfg.max_grad_norm > 0:
    grads, gnorm = clip_by_global_norm(grads, cfg.max_grad_norm)
    metrics["grad_norm"] = gnorm
  step = state.step + 1
  b1c = 1.0 - cfg.b1 ** step
  b2c = 1.0 - cfg.b2 ** step
  new_m, new_v = {}, {}
  for k, p in tree.items():
    g = grads[k].float()
    squeeze = g.ndim == 0
    if squeeze:
      g = g[None]
    m = cfg.b1 * _dequantize(state.m[k]) + (1 - cfg.b1) * g
    v = cfg.b2 * _dequantize(state.v[k]) + (1 - cfg.b2) * g * g
    delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
    if squeeze:
      delta = delta[0]
    p32 = p.float()
    if cfg.weight_decay and p.ndim >= 2:
      delta = delta + cfg.weight_decay * p32
    p.copy_(p32 - lr * delta)
    new_m[k], new_v[k] = _quantize(m), _quantize(v)
  return params, QAdamState(step=step, m=new_m, v=new_v), metrics
