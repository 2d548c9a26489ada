"""Token embedding and output head (optionally tied) — counterpart of
`repro.layers.embedding`.

`Embedding` holds `table` (vocab, d) and, untied, `head` (a
`FactoredLinear` named "lm_head"), so `state_dict()` keys are the
reference's paths `embedding/table` and `embedding/head/w`.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.core.factored import FactoredLinear, dense, matmul_ref, normal
from repro_torch.layers.common import gemm


class Embedding(nn.Module):

  def __init__(self, table: torch.Tensor,
               head: Optional[FactoredLinear] = None):
    super().__init__()
    self.table = nn.Parameter(table, requires_grad=False)
    self.head = head


def init_embedding(vocab: int, d: int, *, dtype: torch.dtype, tie: bool,
                   prefix: str = "", generator: torch.Generator,
                   device) -> Embedding:
  table = normal((vocab, d), 0.02, generator, dtype, device)
  head = None if tie else dense(d, vocab, name=f"{prefix}lm_head",
                                dtype=dtype, generator=generator,
                                device=device)
  return Embedding(table, head)


def embed(p: Embedding, tokens: torch.Tensor) -> torch.Tensor:
  return p.table[tokens]


def logits(p: Embedding, x: torch.Tensor, policy=None) -> torch.Tensor:
  if p.head is not None:
    return gemm(p.head, x, policy)
  # Tied head: a kernel would need a transposed copy of the model's
  # largest weight on every step, so the tied path stays plain unless a
  # policy override names "lm_head_tied" (the reference's rule).
  if policy is not None and policy.override_for("lm_head_tied"):
    from repro_torch.kernels import dispatch
    return dispatch.gemm(p.table.T, x, policy, name="lm_head_tied")
  return matmul_ref(x, p.table.T)
