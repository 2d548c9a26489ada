"""Variational trace-norm regularization (paper §3.1, Lemma 1).

Counterpart of `repro.core.tracenorm`. The trace norm ||W||_T = sum_i
sigma_i(W) equals min over W = UV of (||U||_F^2 + ||V||_F^2) / 2, so the
penalty on a factored GEMM's factors is an exact surrogate for an l1
penalty on its singular values: it drives W toward low rank without
fixing the rank in advance.

Also the paper's nondimensional trace norm coefficient nu(W)
(Definition 1) and singular-value diagnostics. Scalars come back as 0-d
f32 tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import torch
from torch import nn

from repro_torch.core.factored import iter_factored_leaves


def frobenius_sq(x: torch.Tensor) -> torch.Tensor:
  """||x||_F^2 in f32 whatever the param dtype."""
  x = x.float()
  return torch.sum(x * x)


def variational_trace_norm_penalty(u: torch.Tensor,
                                   v: torch.Tensor) -> torch.Tensor:
  """(||U||_F^2 + ||V||_F^2) / 2 — eq. (3)'s penalty for one factored
  GEMM."""
  return 0.5 * (frobenius_sq(u) + frobenius_sq(v))


def l2_penalty(w: torch.Tensor) -> torch.Tensor:
  """The paper's baseline regularizer: ||W||_F^2 / 2."""
  return 0.5 * frobenius_sq(w)


@dataclasses.dataclass(frozen=True)
class RegularizerConfig:
  """Regularization strengths, split into recurrent and non-recurrent
  groups as in paper §3.2.1."""
  kind: str = "none"             # "none" | "trace" | "l2"
  lambda_rec: float = 0.0        # strength on recurrent-group weights
  lambda_nonrec: float = 0.0     # strength on non-recurrent-group weights

  def strength_for(self, group: str) -> float:
    return self.lambda_rec if group == "rec" else self.lambda_nonrec


def regularization_loss(params: nn.Module,
                        cfg: RegularizerConfig) -> torch.Tensor:
  """The regularization term of a model: over its FactoredLinear leaves,
  the variational trace-norm penalty (kind="trace") or the Frobenius
  penalty of the factors (kind="l2"). An unfactored GEMM gets the
  Frobenius penalty under "l2" and is skipped under "trace": its exact
  trace norm would need an SVD under grad, and the FactorizationPlan
  left it out on purpose (the paper's "each *large* GEMM" scope)."""
  total = torch.zeros((), dtype=torch.float32)
  for leaf in iter_factored_leaves(params):
    lam = cfg.strength_for(leaf.group)
    if cfg.kind == "none" or lam == 0.0:
      continue
    if leaf.is_factored:
      if cfg.kind == "trace":
        term = variational_trace_norm_penalty(leaf.u, leaf.v)
      else:  # l2 on the factors of UV
        term = l2_penalty(leaf.u) + l2_penalty(leaf.v)
    elif cfg.kind == "l2":
      term = l2_penalty(leaf.w)
    else:
      continue
    total = total.to(term.device) + lam * term
  return total


# --------------------------------------------------------------------------
# Diagnostics: singular values, nu(W), rank at an explained variance.
# --------------------------------------------------------------------------

def singular_values(w: torch.Tensor) -> torch.Tensor:
  """Singular values of a 2-D matrix, descending, f32."""
  if w.ndim != 2:
    raise ValueError(f"expected 2D matrix, got shape {tuple(w.shape)}")
  return torch.linalg.svdvals(w.detach().float())


def nu_from_sigma(sigma: torch.Tensor) -> torch.Tensor:
  """nu from a precomputed singular value vector."""
  d = sigma.shape[0]
  l1 = torch.sum(sigma)
  l2 = torch.sqrt(torch.sum(sigma * sigma))
  return (l1 / l2 - 1.0) / (d ** 0.5 - 1.0)


def nu_coefficient(w: torch.Tensor) -> torch.Tensor:
  """Nondimensional trace norm coefficient nu(W) — paper Definition 1:

      nu(W) = (||sigma||_1 / ||sigma||_2 - 1) / (sqrt(d) - 1),  d = min(m, n)

  Scale-invariant, in [0, 1], 0 iff rank 1, 1 iff maximal rank with all
  singular values equal. Smaller nu: better low-rank approximability."""
  sigma = singular_values(w)
  if sigma.shape[0] < 2:
    raise ValueError("nu(W) requires min(m, n) >= 2")
  return nu_from_sigma(sigma)


def rank_for_variance(sigma: torch.Tensor, threshold: float) -> torch.Tensor:
  """Smallest k with sum_{i<=k} sigma_i^2 >= threshold * sum sigma_i^2,
  clamped to [1, d] (the paper's SVD truncation rule)."""
  var = sigma * sigma
  cum = torch.cumsum(var, dim=0)
  frac = cum / torch.clamp(cum[-1], min=1e-30)
  return torch.clamp(torch.sum(frac < threshold) + 1, 1, sigma.shape[0])


def trace_norm_metrics(params: nn.Module) -> Mapping[str, dict]:
  """Per-factored-GEMM diagnostics {name -> {nu, trace_norm, frobenius,
  rank90}}; a layer-stacked leaf gives one entry a layer, "name[i]".
  Runs SVDs: call it at eval cadence, not every step."""
  out = {}
  with torch.no_grad():
    for leaf in iter_factored_leaves(params):
      w = leaf.product()
      mats = ([(leaf.name, w)] if w.ndim == 2 else
              [(f"{leaf.name}[{i}]", m) for i, m in
               enumerate(w.reshape((-1,) + tuple(w.shape[-2:])))])
      for name, m in mats:
        sigma = singular_values(m)
        out[name] = {
            "nu": nu_from_sigma(sigma),
            "trace_norm": torch.sum(sigma),
            "frobenius": torch.sqrt(torch.sum(sigma * sigma)),
            "rank90": rank_for_variance(sigma, 0.90),
        }
  return out
