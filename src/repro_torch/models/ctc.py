"""CTC loss on tensors (log-space forward algorithm, a loop over time).

Counterpart of `repro.models.ctc`: blank id 0, padded logit frames and
padded label sequences handled through their lengths. Unreachable
states hold the same finite `NEG` as the reference, not -inf: torch's
`logaddexp(-inf, -inf)` has a NaN gradient.
"""
from __future__ import annotations

import torch

NEG = -1e30


def ctc_loss(log_probs: torch.Tensor, logit_lengths: torch.Tensor,
             labels: torch.Tensor, label_lengths: torch.Tensor,
             blank: int = 0) -> torch.Tensor:
  """Mean negative log likelihood over the batch.

  log_probs: (b, t, v) log-softmaxed; logit_lengths: (b,);
  labels: (b, l) padded with anything; label_lengths: (b,).
  """
  b, t, _ = log_probs.shape
  l = labels.shape[1]
  s = 2 * l + 1    # extended sequence: blank label blank label ... blank
  dev = log_probs.device
  logit_lengths = logit_lengths.to(dev)
  label_lengths = label_lengths.to(dev)

  # extended labels: ext[2i] = blank, ext[2i+1] = labels[i]
  ext = torch.full((b, s), blank, dtype=torch.long, device=dev)
  ext[:, 1::2] = labels.to(device=dev, dtype=torch.long)
  pos = torch.arange(s, device=dev)[None, :]
  ext_valid = pos < (2 * label_lengths[:, None] + 1)

  # transitions: from j-1 always; from j-2 only if ext[j] != blank and
  # ext[j] != ext[j-2]
  ext_prev2 = torch.cat([torch.full((b, 2), -1, dtype=torch.long,
                                    device=dev), ext[:, :-2]], dim=1)
  allow_skip = (ext != blank) & (ext != ext_prev2)

  neg = torch.tensor(NEG, dtype=log_probs.dtype, device=dev)
  lp0 = log_probs[:, 0]
  alpha = neg.expand(b, s).clone()
  alpha[:, 0] = lp0[:, blank]
  if s > 1:
    first_lab = torch.gather(lp0, 1, ext[:, 1:2])[:, 0]
    alpha[:, 1] = torch.where(label_lengths > 0, first_lab, neg)
  pad1, pad2 = neg.expand(b, 1), neg.expand(b, 2)
  for ti in range(1, t):
    prev1 = torch.cat([pad1, alpha[:, :-1]], dim=1)
    prev2 = torch.where(allow_skip, torch.cat([pad2, alpha[:, :-2]], dim=1),
                        neg)
    merged = torch.logaddexp(torch.logaddexp(alpha, prev1), prev2)
    new = merged + torch.gather(log_probs[:, ti], 1, ext)
    new = torch.where(ext_valid, new, neg)
    # frames beyond logit_lengths: freeze alpha
    alpha = torch.where((ti < logit_lengths)[:, None], new, alpha)

  # final: alpha at the last two valid extended positions
  last = (2 * label_lengths).long()           # blank after the last label
  a_last = torch.gather(alpha, 1, last[:, None])[:, 0]
  a_prev = torch.gather(alpha, 1, (last - 1).clamp(min=0)[:, None])[:, 0]
  a_prev = torch.where(label_lengths > 0, a_prev, neg)
  return -torch.logaddexp(a_last, a_prev).mean()


def ctc_greedy_decode(log_probs: torch.Tensor, logit_lengths: torch.Tensor,
                      blank: int = 0) -> torch.Tensor:
  """Best-path decode: argmax per frame, collapse repeats, drop blanks.
  Returns (b, t) int64 sequences padded with -1."""
  b, t, _ = log_probs.shape
  path = log_probs.argmax(dim=-1)                              # (b, t)
  prev = torch.cat([torch.full((b, 1), -1, dtype=path.dtype,
                               device=path.device), path[:, :-1]], dim=1)
  frame = torch.arange(t, device=path.device)[None, :]
  keep = (path != blank) & (path != prev) & \
      (frame < logit_lengths.to(path.device)[:, None])
  # stable compaction: kept frames first, each group in frame order
  order = torch.argsort(torch.where(keep, frame, t + frame), dim=1)
  return torch.gather(torch.where(keep, path, -1), 1, order)
