"""Mixture-of-Experts FFN with grouped capacity dispatch — counterpart of
`repro.layers.moe`.

Tokens are split into `dispatch_groups` groups; each group routes and
scatters into its own (E, C, D) buffer slice through a per-group cumsum
over the flattened (token, choice) order. Entries past an expert's
capacity C are dropped (standard capacity-factor semantics): a dropped
entry adds zeros at slot C - 1, which leaves the slot's value as it is.
C = max(8, ceil8(int(capacity_factor * T_group * top_k / E))), the
reference's rule, so at decode every expert also runs 8 slots.

The routed experts are stacked (E, m, n) contractions (`torch.einsum`),
outside the 2-D GEMM regimes, as in the reference: no kernel computes
them, and a factored or quantized expert stack is multiplied out at every
use (`_w`). Only the shared experts' SwiGLU consults `policy`.

Routing is the reference's: an f32 router, softmax, top-k, the weights
renormalized, and the Switch load-balance loss on each token's primary
choice. `torch.topk` promises no order among exactly tied probabilities
(`jax.lax.top_k` puts them in index order); with continuous inputs an
exact tie does not occur.

`record_routes()` is test instrumentation: inside it every MoE call
logs each token's top-k experts and the margin between its k-th and
(k+1)-th probability (also as a logit gap, ln(p_k / p_(k+1))), the
quantity that says whether a route that differs between two runs was a
near-tie. It changes no result. `replay_routes(log)` is its other half:
inside it every MoE call takes its top-k experts from a recorded log
instead of choosing them, so two runs whose routes would part at a
near-tie can be held to each other's arithmetic.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.factored import acc_dtype, dense, normal
from repro_torch.layers.common import ModelConfig, MoEConfig
from repro_torch.layers.ffn import SwiGLU, init_swiglu, swiglu_forward


class MoE(nn.Module):
  """`router` (d, E) f32 (a raw array, not a GEMM leaf), the expert
  stacks `w_gate`, `w_up` (E, d, f) and `w_down` (E, f, d), and the
  shared experts' `shared` SwiGLU (d -> f * num_shared); layer-stacked
  in a model."""

  def __init__(self, router: torch.Tensor, w_gate: nn.Module,
               w_up: nn.Module, w_down: nn.Module,
               shared: Optional[SwiGLU] = None):
    super().__init__()
    self.router = nn.Parameter(router, requires_grad=False)
    self.w_gate, self.w_up, self.w_down = w_gate, w_up, w_down
    self.shared = shared


def init_moe(cfg: ModelConfig, *, layer_prefix: str, stack: tuple = (),
             generator: torch.Generator, device) -> MoE:
  m = cfg.moe
  d, fe = cfg.d_model, m.d_expert
  experts = tuple(stack) + (m.num_experts,)
  kw = dict(dtype=cfg.dtype, generator=generator, device=device)
  # the router is small and stays in f32 (standard practice for stability)
  router = normal(tuple(stack) + (d, m.num_experts), (1.0 / d) ** 0.5,
                  generator, torch.float32, device)
  w_gate = dense(d, fe, name=f"{layer_prefix}/expert_gate", stack=experts,
                 **kw)
  w_up = dense(d, fe, name=f"{layer_prefix}/expert_up", stack=experts, **kw)
  w_down = dense(fe, d, name=f"{layer_prefix}/expert_down", stack=experts,
                 **kw)
  shared = None
  if m.num_shared:
    shared = init_swiglu(d, fe * m.num_shared,
                         layer_prefix=f"{layer_prefix}/shared", stack=stack,
                         **kw)
  return MoE(router, w_gate, w_up, w_down, shared)


# ----------------------------------------------------------------------------
# Route log (test instrumentation).
# ----------------------------------------------------------------------------

_ROUTE_LOGS: list = []


@contextlib.contextmanager
def record_routes():
  """Log every MoE call made inside the context, in call order: one
  {"experts": (T, k) int64, "margin": (T,) f32, "logit_gap": (T,) f32,
  "logits": (T, E) f32} entry a call (T the call's tokens, groups
  flattened; numpy on the host once the context closes): margin = p_(k)
  - p_(k+1), the gap between the last chosen and the first unchosen
  probability, logit_gap = ln(p_(k) / p_(k+1)) (both inf when k = E),
  and the router's logits."""
  log: list = []
  _ROUTE_LOGS.append(log)
  try:
    yield log
  finally:
    for i in range(len(_ROUTE_LOGS) - 1, -1, -1):
      if _ROUTE_LOGS[i] is log:
        del _ROUTE_LOGS[i]
        break
    for ent in log:
      for key, val in ent.items():
        if isinstance(val, torch.Tensor):
          ent[key] = val.cpu().numpy()


_REPLAYS: list = []


@contextlib.contextmanager
def replay_routes(log: list):
  """Inside the context the i-th MoE call routes each token to the
  experts of `log[i]["experts"]` (a `record_routes` log of a run that
  made the same calls), weighted by this call's own probabilities at
  those experts, renormalized; the aux loss counts the replayed primary
  choices. Raises if the calls outnumber the log or a call's tokens
  differ from its entry's."""
  _REPLAYS.append(iter(log))
  try:
    yield
  finally:
    _REPLAYS.pop()


def _replayed(probs: torch.Tensor, m: MoEConfig) -> torch.Tensor:
  """The next recorded call's experts, (G, T, k), for this call's probs."""
  ent = next(_REPLAYS[-1], None)
  if ent is None:
    raise RuntimeError("replay_routes: more MoE calls than recorded ones")
  tope = torch.as_tensor(ent["experts"], device=probs.device)
  if tope.shape != (probs.shape[0] * probs.shape[1], m.top_k):
    raise RuntimeError(f"replay_routes: a call of {tuple(probs.shape[:2])} "
                       f"tokens against a recorded {tuple(tope.shape)}")
  return tope.reshape(probs.shape[0], probs.shape[1], m.top_k)


def _log_routes(logits: torch.Tensor, probs: torch.Tensor, tope: torch.Tensor,
                k: int) -> None:
  with torch.no_grad():
    e = probs.shape[-1]
    top = torch.topk(probs.detach().float(), min(k + 1, e), dim=-1).values
    if k < e:
      margin = top[..., k - 1] - top[..., k]
      gap = torch.log(top[..., k - 1]) - torch.log(top[..., k])
    else:
      margin = gap = torch.full(top.shape[:-1], float("inf"),
                                device=probs.device)
    ent = {"experts": tope.detach().reshape(-1, k).clone(),
           "margin": margin.reshape(-1).clone(),
           "logit_gap": gap.reshape(-1).clone(),
           "logits": logits.detach().reshape(-1, e).clone()}
  for log in _ROUTE_LOGS:
    log.append(dict(ent))


# ----------------------------------------------------------------------------
# Routing, dispatch and combine.
# ----------------------------------------------------------------------------

def _route(router_w: torch.Tensor, x: torch.Tensor, m: MoEConfig):
  """Top-k routing per group (inside `replay_routes`, the recorded
  experts). x: (G, T, D) -> weights (G, T, k) f32, experts (G, T, k),
  aux (G,) f32; logged inside `record_routes`."""
  logits = torch.einsum("gtd,de->gte", x.float(), router_w.float())
  probs = torch.softmax(logits, dim=-1)
  if _REPLAYS:
    tope = _replayed(probs, m)
  else:
    tope = torch.topk(probs, m.top_k, dim=-1).indices
  if _ROUTE_LOGS:
    _log_routes(logits, probs, tope, m.top_k)
  topw = probs.gather(-1, tope)
  topw = topw / torch.clamp_min(topw.sum(-1, keepdim=True), 1e-9)
  # Switch-style load-balance loss: E * sum_e f_e * p_e, f_e over each
  # token's primary choice
  f = F.one_hot(tope[..., 0], m.num_experts).float().mean(dim=1)
  pbar = probs.mean(dim=1)
  aux = m.num_experts * (f * pbar).sum(-1)
  return topw, tope, aux


def capacity(m: MoEConfig, tokens: int) -> int:
  """Slots an expert has in a group of `tokens` tokens."""
  cap = int(m.capacity_factor * tokens * m.top_k / m.num_experts)
  return max(8, (cap + 7) // 8 * 8)


def _dispatch(xg: torch.Tensor, tope: torch.Tensor, m: MoEConfig, cap: int):
  """Group-local scatter. xg (G, T, D) -> buf (G, E, C, D) and the
  bookkeeping (flat_e, safe_pos, keep), each (G, T*k). An entry's slot
  is its 1-based count among the entries of its expert in flattened
  (token, choice) order, minus one; entries at or past C are dropped,
  adding zeros at slot C - 1."""
  g, t, d = xg.shape
  flat_e = tope.reshape(g, t * m.top_k)
  onehot = F.one_hot(flat_e, m.num_experts)
  pos_in_e = (torch.cumsum(onehot, dim=1) * onehot).sum(-1) - 1
  keep = pos_in_e < cap
  safe_pos = torch.where(keep, pos_in_e, cap - 1)
  tok = xg.repeat_interleave(m.top_k, dim=1)                # (G, T*k, D)
  vals = torch.where(keep[..., None], tok, torch.zeros((), dtype=xg.dtype,
                                                       device=xg.device))
  gidx = torch.arange(g, device=xg.device)[:, None].expand_as(flat_e)
  buf = torch.zeros((g, m.num_experts, cap, d), dtype=xg.dtype,
                    device=xg.device)
  buf = buf.index_put((gidx, flat_e, safe_pos), vals, accumulate=True)
  return buf, (gidx, flat_e, safe_pos, keep)


def _combine(out_buf: torch.Tensor, book, topw: torch.Tensor, t: int,
             k: int, dtype: torch.dtype) -> torch.Tensor:
  """out_buf (G, E, C, D) -> (G, T, D): each token's kept entries
  weighted by their routing weight (in `dtype`) and summed over its k
  choices."""
  gidx, flat_e, safe_pos, keep = book
  gathered = out_buf[gidx, flat_e, safe_pos]                # (G, T*k, D)
  gathered = torch.where(keep[..., None], gathered,
                         torch.zeros((), dtype=gathered.dtype,
                                     device=gathered.device))
  combined = gathered * topw.reshape(topw.shape[0], -1)[..., None].to(dtype)
  return combined.reshape(topw.shape[0], t, k, -1).sum(dim=2)


def _w(leaf) -> torch.Tensor:
  """An expert stack as its float (E, m, n) array: factored stacks are
  multiplied out at every use, quantized ones dequantized."""
  return leaf.product() if hasattr(leaf, "product") else leaf


def moe_forward(p, x: torch.Tensor, cfg: ModelConfig,
                policy=None) -> tuple[torch.Tensor, torch.Tensor]:
  """x: (b, s, d) -> (y (b, s, d), aux loss () f32). `p` maps "router"
  to (d, E), "w_gate", "w_up", "w_down" to (E, m, n) leaves and
  "shared" to the shared SwiGLU's 2-D leaves."""
  m = cfg.moe
  b, s, d = x.shape
  t = b * s
  g = max(1, m.dispatch_groups)
  if t % g:
    g = 1
  tg = t // g
  xg = x.reshape(g, tg, d)
  topw, tope, aux = _route(p["router"], xg, m)
  aux = aux.mean()
  cap = capacity(m, tg)
  buf, book = _dispatch(xg, tope, m, cap)

  # the experts' SwiGLU, batched over (group, expert); weights (E, m, n)
  acc = acc_dtype(x)
  wg, wu, wd = (_w(p[k]).to(acc) for k in ("w_gate", "w_up", "w_down"))
  xe = buf.to(acc)
  gate = torch.einsum("gecd,edf->gecf", xe, wg).to(x.dtype)
  up = torch.einsum("gecd,edf->gecf", xe, wu).to(x.dtype)
  h = F.silu(gate.float()).to(x.dtype) * up
  out_buf = torch.einsum("gecf,efd->gecd", h.to(acc), wd).to(x.dtype)

  y = _combine(out_buf, book, topw, tg, m.top_k, x.dtype).reshape(t, d)
  if m.num_shared:
    y = y + swiglu_forward(p["shared"], x.reshape(t, d), policy)
  return y.reshape(b, s, d), aux.float()
