"""GRU layer with the paper's partially joint factorization (App. B.2).

Counterpart of `repro.layers.gru`. The three non-recurrent matrices
W_{z,r,h} are one GEMM leaf `nonrec` (batchable across time, paper §4);
the three recurrent ones U_{z,r,h} are one leaf `rec` (sequential).

Cell (paper eq. 10) — not `torch.nn.GRU`, which orders its gates r, z, n
and puts r inside the whole candidate pre-activation:
    z_t = sigmoid(W_z x_t + U_z h_{t-1} + b_z)
    r_t = sigmoid(W_r x_t + U_r h_{t-1} + b_r)
    hcand = tanh(W_h x_t + r_t * (U_h h_{t-1}) + b_h)
    h_t = (1 - z_t) h_{t-1} + z_t hcand
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.factored import dense
from repro_torch.kernels import dispatch
from repro_torch.layers.common import gemm


class GRU(nn.Module):
  """One GRU layer: `nonrec` (in, 3H), `rec` (H, 3H) GEMM leaves and an
  f32 `bias` (3H,) — the reference's {"nonrec", "rec", "bias"} dict."""

  def __init__(self, nonrec: nn.Module, rec: nn.Module, bias: torch.Tensor):
    super().__init__()
    self.nonrec = nonrec
    self.rec = rec
    self.bias = nn.Parameter(bias, requires_grad=False)

  @property
  def hidden(self) -> int:
    return self.rec.in_dim


def init_gru(in_dim: int, hidden: int, *, layer_prefix: str,
             dtype: torch.dtype = torch.float32,
             generator: torch.Generator, device) -> GRU:
  return GRU(
      nonrec=dense(in_dim, 3 * hidden, name=f"{layer_prefix}/nonrec",
                   group="nonrec", dtype=dtype, generator=generator,
                   device=device),
      rec=dense(hidden, 3 * hidden, name=f"{layer_prefix}/rec", group="rec",
                dtype=dtype, generator=generator, device=device),
      bias=torch.zeros((3 * hidden,), dtype=torch.float32, device=device))


def gru_cell(xw: torch.Tensor, h: torch.Tensor, rec: nn.Module,
             bias: torch.Tensor, hidden: int, policy=None) -> torch.Tensor:
  """One step given the precomputed non-recurrent projection xw (b, 3H).

  Under a kernel policy the whole step runs as the fused `gru_cell`
  kernel; where it declines (factored or quantized `rec`, hidden < 128)
  the plain gate math below runs, its recurrent GEMM still routed."""
  if policy is not None:
    fused = dispatch.maybe_gru_cell(xw, h, rec, bias, policy)
    if fused is not None:
      return fused
  hu = gemm(rec, h, policy).float()                 # (b, 3H)
  g = xw.float() + hu + bias
  gz, gr, gh = g[:, :hidden], g[:, hidden:2 * hidden], g[:, 2 * hidden:]
  hu_h = hu[:, 2 * hidden:]
  z = torch.sigmoid(gz)
  r = torch.sigmoid(gr)
  hcand = torch.tanh(gh - hu_h + r * hu_h)          # r gates U_h h only
  h1 = (1.0 - z) * h.float() + z * hcand
  return h1.to(h.dtype)


def gru_forward(p: GRU, x: torch.Tensor, policy=None) -> torch.Tensor:
  """Forward-only GRU over a sequence. x: (b, t, in) -> (b, t, hidden)."""
  b, t, _ = x.shape
  hidden = p.hidden
  xw = gemm(p.nonrec, x, policy)        # batched across time (paper §4)
  h = torch.zeros((b, hidden), dtype=x.dtype, device=x.device)
  hs = []
  with dispatch.scanned():              # the reference's time scan
    for i in range(t):
      h = gru_cell(xw[:, i], h, p.rec, p.bias, hidden, policy)
      hs.append(h)
  return torch.stack(hs, dim=1)


def gru_decode(p: GRU, x_t: torch.Tensor, h: torch.Tensor,
               policy=None) -> torch.Tensor:
  """Streaming step: x_t (b, in), h (b, hidden) -> h' (b, hidden)."""
  xw = gemm(p.nonrec, x_t, policy)
  return gru_cell(xw, h, p.rec, p.bias, h.shape[-1], policy)
