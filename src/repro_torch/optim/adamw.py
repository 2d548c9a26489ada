"""AdamW over a model's parameters — counterpart of `repro.optim.adamw`.

Parameters and moments are dicts keyed by the reference's path strings
(`core.factored.param_tree`), so FactoredLinear factors need no special
case and the state checkpoints under the reference's keys
("opt/m/grus/gru0/rec/u"). Moments are f32 whatever the param dtype; the
decoupled weight decay skips params with ndim < 2 (norms, biases).
The update runs in place under `torch.no_grad()`, on DTensor params (a
mesh) block by block. (`torch.optim.AdamW` keeps its moments in the
param dtype and decays biases too.)
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, NamedTuple, Union

import torch
from torch import nn

from repro_torch.core.factored import param_tree
from repro_torch.dist.sharding import assign, is_dtensor, local_block

Params = Union[nn.Module, Mapping[str, torch.Tensor]]


class AdamState(NamedTuple):
  step: int
  m: dict
  v: dict


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
  b1: float = 0.9
  b2: float = 0.999
  eps: float = 1e-8
  weight_decay: float = 0.0
  max_grad_norm: float = 0.0        # 0 = no clipping


def _tree(params: Params) -> Mapping[str, torch.Tensor]:
  return param_tree(params) if isinstance(params, nn.Module) else params


def init(params: Params) -> AdamState:
  # zeros_like: a DTensor param (a mesh) gets moments of its layout
  zeros = {k: torch.zeros_like(p, dtype=torch.float32,
                               memory_format=torch.contiguous_format)
           for k, p in _tree(params).items()}
  return AdamState(step=0, m=zeros,
                   v={k: torch.zeros_like(z) for k, z in zeros.items()})


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
  """sqrt of the sum of squares over every tensor, in f32."""
  sq = [torch.sum(torch.square(x.float())) for x in tree.values()]
  return torch.sqrt(torch.sum(torch.stack(sq)))


def clip_by_global_norm(grads: Mapping[str, torch.Tensor], max_norm: float
                        ) -> tuple[dict, torch.Tensor]:
  """Scale every gradient by min(1, max_norm / global norm); each keeps
  its dtype."""
  norm = global_norm(grads)
  scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
  return {k: (g.float() * scale).to(g.dtype) for k, g in grads.items()}, norm


@torch.no_grad()
def apply(params: Params, grads: Mapping[str, torch.Tensor],
          state: AdamState, lr: float, cfg: AdamWConfig
          ) -> tuple[Params, AdamState, dict]:
  """One AdamW update of `params` in place; returns (params, the new
  state, metrics). `grads` is keyed like the params."""
  tree = _tree(params)
  metrics = {}
  if cfg.max_grad_norm > 0:
    grads, gnorm = clip_by_global_norm(grads, cfg.max_grad_norm)
    metrics["grad_norm"] = gnorm
  step = state.step + 1
  b1c = 1.0 - cfg.b1 ** step
  b2c = 1.0 - cfg.b2 ** step
  for k, param in tree.items():
    g = grads[k].float()
    m, v = state.m[k], state.v[k]
    # elementwise in the moments' layout: on a mesh each rank its block;
    # a parameter laid out otherwise (TP-resident under "zero1") takes
    # its new value back by its own placements
    work = m if is_dtensor(m) else param
    p, g, m, v = (local_block(t, work) for t in (param, g, m, v))
    m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
    v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
    delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
    p32 = p.float()
    if cfg.weight_decay and p.ndim >= 2:
      delta = delta + cfg.weight_decay * p32
    new = p32 - lr * delta
    if _same_layout(param, work):
      p.copy_(new)
    else:
      from torch.distributed.tensor import DTensor
      assign(param, DTensor.from_local(new, work.device_mesh,
                                       work.placements, shape=work.shape,
                                       stride=work.stride()))
  return params, AdamState(step=step, m=state.m, v=state.v), metrics


def _same_layout(a: torch.Tensor, b: torch.Tensor) -> bool:
  return a is b or not is_dtensor(a) or \
      list(a.placements) == list(b.placements)
