"""Truncated-SVD warmstarting (paper §3, stage 1 -> stage 2).

Counterpart of `repro.core.svd`:
  * the Lemma-1 balanced split W = (U sqrt(S)) (sqrt(S) V^T), which
    attains equality in the variational characterization — used to
    factor an unfactored model into the stage-1 form;
  * explained-variance rank truncation ("retain only as many singular
    values as required to explain a specified percentage of the
    variance", Prabhavalkar et al. 2016);
  * the whole-model passes: stage-1 (full-rank factored, trace-norm
    trained) -> stage-2 (rank-truncated factored) models.

SVDs run in f32 on the tensor's own device (`torch.linalg.svd`); ranks
are picked in numpy f64 from the f32 singular values, as the reference
picks them. The activation-weighted split (`activation_split`, LiteASR)
is numpy and takes a Gram matrix; collecting one is calibration's work.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from repro_torch.core.factored import FactoredLinear, map_factored_leaves


def balanced_split(w: torch.Tensor, rank: Optional[int] = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
  """Factor w (m, n) into u (m, r) = U sqrt(S), v (r, n) = sqrt(S) V^T.

  This attains equality in Lemma 1 — ||u||_F^2 = ||v||_F^2 = ||w||_T at
  full rank — so a stage-1 model warmstarted this way starts at the
  variational minimum of the penalty."""
  if w.ndim != 2:
    raise ValueError(f"balanced_split expects 2D, got {tuple(w.shape)}")
  r = min(w.shape) if rank is None else rank
  uu, s, vt = torch.linalg.svd(w.detach().float(), full_matrices=False)
  sq = torch.sqrt(s[:r])
  u = (uu[:, :r] * sq[None, :]).to(w.dtype)
  v = (sq[:, None] * vt[:r, :]).to(w.dtype)
  return u, v


def explained_variance_rank(s, threshold: float) -> int:
  """Smallest r with sum_{i<r} s_i^2 >= threshold * sum s_i^2."""
  s = np.asarray(s, dtype=np.float64)
  cum = np.cumsum(s * s)
  total = cum[-1]
  if total <= 0:
    return 1
  return int(np.searchsorted(cum / total, threshold) + 1)


@dataclasses.dataclass(frozen=True)
class TruncationSpec:
  """How to pick the stage-2 rank of each GEMM."""
  variance_threshold: Optional[float] = 0.9   # the paper's knob (Fig. 3/4)
  fixed_rank: Optional[int] = None            # override: exact rank
  max_rank: Optional[int] = None              # cap (latency budget)
  round_to: int = 8                           # rank rounding, part of the rule

  def pick(self, s: np.ndarray) -> int:
    if self.fixed_rank is not None:
      return self.clamp(self.fixed_rank, len(s))
    return self.clamp(explained_variance_rank(s, self.variance_threshold),
                      len(s))

  def clamp(self, r: int, n: int) -> int:
    """Rank r capped at max_rank, rounded up to round_to, capped at n =
    min(m, n) of the GEMM."""
    if self.max_rank is not None:
      r = min(r, self.max_rank)
    r = max(self.round_to, int(np.ceil(r / self.round_to)) * self.round_to)
    return min(r, n)


def _whitener(cov: np.ndarray, eps: float = 1e-6) -> np.ndarray:
  """Cholesky factor L of a symmetrized, trace-regularized Gram matrix
  E[x x^T] (m, m); the regularization keeps it defined when calibration
  saw fewer rows than m."""
  m = cov.shape[0]
  c = np.asarray(cov, np.float64)
  c = 0.5 * (c + c.T)
  c = c + (eps * np.trace(c) / m + 1e-12) * np.eye(m)
  return np.linalg.cholesky(c)


def _numpy(w: torch.Tensor) -> np.ndarray:
  return w.detach().float().cpu().numpy().astype(np.float64)


def activation_split(w: torch.Tensor, cov: np.ndarray, spec: TruncationSpec
                     ) -> tuple[torch.Tensor, torch.Tensor, np.ndarray]:
  """Activation-weighted truncated split of one 2-D GEMM (LiteASR).

  The output error E||xW - xUV||^2 = ||L^T (W - UV)||_F^2, L the
  Cholesky factor of E[x x^T], is minimized by the truncated SVD of the
  whitened L^T W = U' S V'^T mapped back through L^{-T}:
  u = L^{-T} U'_r sqrt(S_r), v = sqrt(S_r) V'_r^T, with the rank picked
  from the whitened spectrum S. Returns (u, v, S), u and v on w's device
  in w's dtype."""
  lch = _whitener(cov)
  uu, s, vt = np.linalg.svd(lch.T @ _numpy(w), full_matrices=False)
  r = spec.pick(s)
  sq = np.sqrt(s[:r])
  u = np.linalg.solve(lch.T, uu[:, :r] * sq[None, :])
  v = sq[:, None] * vt[:r, :]
  back = dict(dtype=w.dtype, device=w.device)
  return (torch.from_numpy(u.astype(np.float32)).to(**back),
          torch.from_numpy(v.astype(np.float32)).to(**back), s)


def _svals(w: torch.Tensor) -> np.ndarray:
  return torch.linalg.svdvals(w.detach().float()).cpu().numpy()


def _pick(spec: TruncationSpec, w: torch.Tensor) -> int:
  """`spec`'s rank for the 2-D weight w. A fixed rank needs only
  min(m, n), so no singular values are computed for it."""
  if spec.fixed_rank is not None:
    return spec.clamp(spec.fixed_rank, min(w.shape[-2:]))
  return spec.pick(_svals(w))


def _restack(w: torch.Tensor, uvs: list) -> tuple[torch.Tensor, torch.Tensor]:
  """(u, v) of a stacked leaf from its layers' (u, v) splits, the stack
  axes of w leading."""
  lead = tuple(w.shape[:-2])
  return (torch.stack([u for u, _ in uvs]).reshape(lead + uvs[0][0].shape),
          torch.stack([v for _, v in uvs]).reshape(lead + uvs[0][1].shape))


def truncate_leaf(leaf: FactoredLinear, spec: TruncationSpec,
                  cov: Optional[np.ndarray] = None) -> FactoredLinear:
  """Stage-2 warmstart of one GEMM: truncated balanced SVD of product().

  With `cov` (the input Gram matrix E[x x^T]: (m, m), or (L, m, m) a
  layer for a stacked leaf, or (m, m) broadcast over the stack) the
  split is activation-weighted (`activation_split`). A stacked (L, m, n)
  leaf gets one rank for the whole stack (the max over its layers)."""
  with torch.no_grad():
    w = leaf.product()
    kw = dict(name=leaf.name, group=leaf.group)
    if w.ndim == 2:
      if cov is not None:
        u, v, _ = activation_split(w, np.asarray(cov), spec)
        return FactoredLinear(u=u, v=v, **kw)
      u, v = balanced_split(w, _pick(spec, w))
      return FactoredLinear(u=u, v=v, **kw)
    flat = w.reshape((-1,) + tuple(w.shape[-2:]))
    if cov is not None:
      covs = np.asarray(cov, np.float64)
      if covs.ndim == 2:
        covs = np.broadcast_to(covs, (flat.shape[0],) + covs.shape)
      else:
        covs = covs.reshape((-1,) + covs.shape[-2:])
      if covs.shape[0] != flat.shape[0]:
        raise ValueError(
            f"leaf {leaf.name!r}: {flat.shape[0]} stacked layers but "
            f"calibration has {covs.shape[0]} Gram matrices — per-layer "
            f"stats are required")
      if spec.fixed_rank is not None:     # no spectrum needed for it
        r = spec.clamp(spec.fixed_rank, min(flat.shape[-2:]))
      else:
        r = max(spec.pick(np.linalg.svd(_whitener(c).T @ _numpy(m),
                                        compute_uv=False))
                for m, c in zip(flat, covs))
      fixed = dataclasses.replace(spec, fixed_rank=r, round_to=1)
      uvs = [activation_split(m, c, fixed)[:2] for m, c in zip(flat, covs)]
    else:
      r = max(_pick(spec, m) for m in flat)
      uvs = [balanced_split(m, r) for m in flat]
    u, v = _restack(w, uvs)
    return FactoredLinear(u=u, v=v, **kw)


def factorize_leaf(leaf: FactoredLinear, rank: Optional[int] = None
                   ) -> FactoredLinear:
  """Stage-1 form: full-rank balanced split of an unfactored GEMM."""
  if leaf.is_factored:
    return leaf
  with torch.no_grad():
    w = leaf.w
    if w.ndim == 2:
      u, v = balanced_split(w, rank)
    else:
      flat = w.reshape((-1,) + tuple(w.shape[-2:]))
      u, v = _restack(w, [balanced_split(m, rank) for m in flat])
  return FactoredLinear(u=u, v=v, name=leaf.name, group=leaf.group)


def collapse_leaf(leaf: FactoredLinear) -> FactoredLinear:
  """Inverse of factorize: materialize W = UV as an unfactored leaf."""
  if not leaf.is_factored:
    return leaf
  with torch.no_grad():
    return FactoredLinear(w=leaf.product(), name=leaf.name, group=leaf.group)


# -- whole-model passes ------------------------------------------------------

def warmstart_tree(params: nn.Module, spec: TruncationSpec) -> nn.Module:
  """Stage-1 -> stage-2: truncate every factored GEMM of the model."""
  return map_factored_leaves(lambda leaf: truncate_leaf(leaf, spec), params)


def factorize_tree(params: nn.Module) -> nn.Module:
  """Unfactored -> stage-1 full-rank factored (balanced SVD split)."""
  return map_factored_leaves(factorize_leaf, params)


def collapse_tree(params: nn.Module) -> nn.Module:
  """Factored -> unfactored (before export or re-factorization)."""
  return map_factored_leaves(collapse_leaf, params)
