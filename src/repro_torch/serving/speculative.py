"""Self-speculative decoding: the paper's low-rank model as a free draft —
counterpart of `repro.serving.speculative`.

The paper trains truncated-SVD low-rank versions of every large GEMM
because they are cheap at small batch (§3.2, §4). The same compressed
model drafts for the full one: `make_draft_params` builds the stage-2
truncated-SVD copy of the params being served; the draft proposes `k`
tokens; the target checks all of them in one `ModelApi.decode_window`;
greedy verification accepts exactly the tokens vanilla greedy would have
produced.

The pure, engine-independent pieces:

  make_draft_params      — params -> low-rank draft params (the matched
                           GEMM leaves factored at the draft rank, every
                           other tensor shared with the target)
  accept_longest_prefix  — greedy acceptance: longest agreeing draft
                           prefix + one bonus token per slot
  accept_sampled         — temperature > 0 acceptance: speculative
                           rejection sampling
  RankController         — online draft-rank walk against a target
                           accept-rate band
  merge_rewind           — carry leaves from the pre-draft snapshot, the
                           rest from the post-window state

The engine's loop lives in `serving.engine.LMEngine`.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Optional

import numpy as np
from torch import nn

from repro_torch.core import svd
from repro_torch.core.compress import FactorizationPlan
from repro_torch.core.factored import FactoredLinear
from repro_torch.core.svd import TruncationSpec

__all__ = ["RankController", "accept_longest_prefix", "accept_sampled",
           "make_draft_params", "merge_rewind"]


def _share_structure(mod: nn.Module) -> nn.Module:
  """A new module tree of `mod`'s structure whose parameters and buffers
  are `mod`'s own tensor objects (nothing is copied)."""
  new = copy.copy(mod)
  new._parameters = dict(mod._parameters)
  new._buffers = dict(mod._buffers)
  new._modules = {k: None if c is None else
                  c if isinstance(c, FactoredLinear) else _share_structure(c)
                  for k, c in mod._modules.items()}
  return new


def make_draft_params(params: nn.Module, *, rank: Optional[int] = None,
                      variance: Optional[float] = None,
                      plan: Optional[FactorizationPlan] = None) -> nn.Module:
  """Build the self-speculative draft: a stage-2 truncated-SVD copy.

  `rank` pins every matching GEMM to one rank (the `--draft-rank` knob);
  otherwise `variance` (default 0.9) picks each rank by explained
  variance, the paper's truncation rule. A custom `plan` overrides both.
  The draft's factors are made from the target's weights without copying
  them first; every leaf the plan does not match (embedding, norms,
  small GEMMs, a MoE's router, which is not a GEMM leaf) is the target's
  own tensor, so the draft costs only its factors. A stacked leaf (a
  layer stack's (L, m, n), a MoE's (L, E, m, n) experts) is truncated at
  one rank for the whole stack. Raises if nothing matched: a "draft"
  that is the target itself would claim a perfect accept rate.
  """
  if plan is None:
    spec = TruncationSpec(
        fixed_rank=rank,
        variance_threshold=0.9 if variance is None else variance)
    plan = FactorizationPlan(truncation=spec)
  draft = _share_structure(params)
  matched = 0
  for parent in list(draft.modules()):
    for key, child in list(parent.named_children()):
      if isinstance(child, FactoredLinear) and plan.matches(child):
        setattr(parent, key, svd.truncate_leaf(child, plan.truncation))
        matched += 1
  if not matched:
    raise ValueError(
        "draft plan matched no GEMM leaf — the draft would be the target "
        "itself (params may be quantized, or min_dim too high; pass an "
        "explicit plan or build the draft from the float params)")
  return draft


def accept_longest_prefix(draft_toks, target_argmax
                          ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
  """Greedy speculative acceptance: longest agreeing prefix + one bonus.

  draft_toks (b, k): the draft's proposals d_1..d_k.
  target_argmax (b, k+1): the target's greedy choices g_1..g_{k+1} from
    the verify window over [t_0, d_1..d_k].

  Returns (accept_len (b,), tokens (b, k+1), out_len (b,)):
    accept_len[i] in [0, k] — longest prefix with d_j == g_j;
    tokens[i, :out_len[i]] — the accepted drafts followed by exactly one
      bonus token g_{accept+1}, so out_len = accept_len + 1 in [1, k+1].
      Entries past out_len are 0.

  Every emitted token is, by construction, what vanilla greedy decode
  would have emitted: acceptance changes how many tokens a step yields,
  never their values.
  """
  draft = np.asarray(draft_toks)
  tgt = np.asarray(target_argmax)
  if draft.ndim != 2 or tgt.shape != (draft.shape[0], draft.shape[1] + 1):
    raise ValueError(
        f"draft (b, k) and target (b, k+1) required, got {draft.shape} "
        f"and {tgt.shape}")
  b, k = draft.shape
  rows = np.arange(b)
  if k:
    match = draft == tgt[:, :k]
    # np.argmin finds the first False; all-True rows accept everything
    accept = np.where(match.all(axis=1), k, np.argmin(match, axis=1))
  else:
    accept = np.zeros((b,), np.int64)
  out = np.zeros((b, k + 1), tgt.dtype)
  if k:
    keep = np.arange(k)[None, :] < accept[:, None]
    out[:, :k] = np.where(keep, draft, 0)
  out[rows, accept] = tgt[rows, accept]
  return accept.astype(np.int64), out, (accept + 1).astype(np.int64)


def accept_sampled(draft_toks, draft_probs, target_probs,
                   rng: np.random.Generator
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
  """Speculative rejection sampling (Leviathan et al. 2022; Chen et al.
  2023), the temperature > 0 counterpart of `accept_longest_prefix`.

  draft_toks (b, k): draft proposals d_1..d_k, each sampled from q_j.
  draft_probs (b, k, v): q_j, the distribution each d_j was drawn from.
  target_probs (b, k+1, v): p_j, the target distribution at every window
    position (position k+1 is the bonus distribution).

  Per slot, walking j = 1..k: accept d_j with probability
  min(1, p_j(d_j) / q_j(d_j)); on the first rejection draw the
  replacement from the residual max(0, p_j - q_j) (renormalized) and
  stop. If every draft survives, draw one bonus token from p_{k+1}.
  Returns `accept_longest_prefix`'s triple. Every emitted token is
  distributed exactly as vanilla sampling from the target, for any
  draft. Pure numpy; the caller owns the generator's seeding.
  """
  draft = np.asarray(draft_toks)
  q = np.asarray(draft_probs, np.float64)
  p = np.asarray(target_probs, np.float64)
  if draft.ndim != 2:
    raise ValueError(f"draft (b, k) required, got {draft.shape}")
  b, k = draft.shape
  if q.shape[:2] != (b, k) or p.shape[:2] != (b, k + 1):
    raise ValueError(
        f"draft_probs (b, k, v) and target_probs (b, k+1, v) required, "
        f"got {q.shape} and {p.shape}")
  v = p.shape[-1]
  accept = np.zeros((b,), np.int64)
  out = np.zeros((b, k + 1), np.int32)
  for i in range(b):
    a = k
    extra = None
    for j in range(k):
      d = int(draft[i, j])
      # u*q < p <=> u < p/q without the 0/0; p >= q always accepts
      if rng.uniform() * q[i, j, d] < p[i, j, d]:
        out[i, j] = d
        continue
      res = np.maximum(p[i, j] - q[i, j], 0.0)
      z = res.sum()
      # z == 0 means p == q, and the rejection had probability 0:
      # numerically, fall back to p
      pr = res / z if z > 0.0 else p[i, j] / p[i, j].sum()
      a, extra = j, int(rng.choice(v, p=pr))
      break
    if extra is None:                       # full accept: bonus from p_{k+1}
      extra = int(rng.choice(v, p=p[i, k] / p[i, k].sum()))
    accept[i] = a
    out[i, a] = extra
    out[i, a + 1:] = 0
  return accept, out, (accept + 1).astype(np.int64)


@dataclasses.dataclass
class RankController:
  """Online draft-rank controller: walk the draft's truncated-SVD rank so
  the measured accept rate sits inside a target band. Every `interval`
  engine iterations:

    rate < band[0]  ->  rank + step   (draft too weak: buy agreement)
    rate > band[1]  ->  rank - step   (draft too strong: shed work)

  clamped to [min_rank, max_rank]. The engine rebuilds the draft through
  `make_draft_params(params, rank=...)`; the draft's decode state carries
  over (factoring weights never changes state shapes). Pure decision
  logic.
  """
  band: tuple = (0.5, 0.85)
  step: int = 16
  min_rank: int = 8
  max_rank: Optional[int] = None
  interval: int = 8       # engine iterations per measurement window

  def __post_init__(self):
    lo, hi = self.band
    if not (0.0 <= lo < hi <= 1.0):
      raise ValueError(f"band must satisfy 0 <= lo < hi <= 1, got "
                       f"{self.band}")
    if self.step < 1 or self.min_rank < 1 or self.interval < 1:
      raise ValueError("step, min_rank and interval must be >= 1")
    if self.max_rank is not None and self.max_rank < self.min_rank:
      raise ValueError(f"max_rank {self.max_rank} < min_rank "
                       f"{self.min_rank}")

  def propose(self, rank: int, accept_rate: Optional[float]) -> int:
    """Next draft rank given the current rank and the accept rate
    measured over the last window (None = nothing drafted: hold)."""
    if accept_rate is None:
      return rank
    lo, hi = self.band
    if accept_rate < lo:
      rank = rank + self.step
    elif accept_rate > hi:
      rank = rank - self.step
    rank = max(self.min_rank, rank)
    if self.max_rank is not None:
      rank = min(self.max_rank, rank)
    return rank


def merge_rewind(window_state, snapshot, carry):
  """Per-leaf rewind split over nested dicts: carry leaves (`carry`
  True) come from the pre-draft `snapshot`, the others (KV rows, whose
  rewind is the position counter alone) from the post-window state. The
  port's decode steps write their state in place, so `snapshot` must be
  a copy (`clone()`) taken before the draft, not the state itself."""
  if isinstance(carry, dict):
    return {k: merge_rewind(window_state[k], snapshot[k], c)
            for k, c in carry.items()}
  return snapshot if carry else window_state
