"""Mamba2 (SSD) block — counterpart of `repro.layers.mamba2`: the
chunked state-space scan for training and prefill, a constant-size
(heads, head_dim, d_state) carry for decode.

`init_mamba2` returns the reference's leaves as a dict, which `Mamba2`
(or a model's stack class built on it) holds: the GEMM leaves `in_zx`
(d, 2 * d_inner), `in_bcdt` (d, 2 * d_state + heads) and `out_proj`
(d_inner, d) in cfg.dtype, and f32 `conv_w` (CONV_WIDTH, d_inner),
`A_log`, `D`, `dt_bias` (heads,), `norm` (d_inner,) and `norm_in` (d,),
each with the stack's leading axes.

The SSD scan has no kernel in the reference (it is jnp there), so it is
plain PyTorch here, all of it in f32. Its three-operand contractions are
written as two products each, in an order whose intermediates stay at
the size of the decay kernel L (b, chunks, heads, CHUNK, CHUNK) or of x;
`torch.einsum` would contract them left to right. A prompt longer than
CHUNK must be a multiple of it (the reference reshapes s into chunks);
`ssd_chunked` raises a `ValueError` naming CHUNK otherwise.

`mamba2_decode` and `mamba2_decode_window` write the new carry into
`state` in place (each rank its own block of a DTensor state) and return
the same dict.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.factored import dense, normal
from repro_torch.dist import sharding as shd
from repro_torch.layers.common import (Constraint, ModelConfig, gemm,
                                      identity_constraint)
from repro_torch.layers.norms import rms_norm

HEAD_DIM = 64        # mamba2 default P
CONV_WIDTH = 4
CHUNK = 256


class Mamba2(nn.Module):
  """One Mamba2 block's params (see the module docstring); layer-stacked
  in a model."""

  def __init__(self, in_zx: nn.Module, in_bcdt: nn.Module,
               out_proj: nn.Module, conv_w: torch.Tensor,
               A_log: torch.Tensor, D: torch.Tensor, dt_bias: torch.Tensor,
               norm: torch.Tensor, norm_in: torch.Tensor):
    super().__init__()
    self.in_zx, self.in_bcdt, self.out_proj = in_zx, in_bcdt, out_proj
    for key, t in (("conv_w", conv_w), ("A_log", A_log), ("D", D),
                   ("dt_bias", dt_bias), ("norm", norm),
                   ("norm_in", norm_in)):
      setattr(self, key, nn.Parameter(t, requires_grad=False))


def init_mamba2(cfg: ModelConfig, *, layer_prefix: str, stack: tuple = (),
                expand: int = 2, generator: torch.Generator,
                device) -> dict:
  """The leaves of a Mamba2 block (of `stack` blocks) as a dict, the
  reference's init: LeCun-normal GEMMs, conv_w ~ N(0, 0.1^2), A_log 0
  (A = -1), D 1, dt_bias 0, unit norms."""
  d = cfg.d_model
  d_inner = expand * d
  nheads = d_inner // HEAD_DIM
  n = cfg.ssm_state
  stack = tuple(stack)
  kw = dict(dtype=cfg.dtype, stack=stack, generator=generator, device=device)
  f32 = dict(dtype=torch.float32, device=device)
  return {
      "in_zx": dense(d, 2 * d_inner, name=f"{layer_prefix}/ssm_in_zx", **kw),
      "in_bcdt": dense(d, 2 * n + nheads, name=f"{layer_prefix}/ssm_in_bcdt",
                       **kw),
      "out_proj": dense(d_inner, d, name=f"{layer_prefix}/ssm_out", **kw),
      "conv_w": normal(stack + (CONV_WIDTH, d_inner), 0.1, generator,
                       torch.float32, device),
      "A_log": torch.zeros(stack + (nheads,), **f32),   # A = -exp(A_log)
      "D": torch.ones(stack + (nheads,), **f32),
      "dt_bias": torch.zeros(stack + (nheads,), **f32),
      "norm": torch.ones(stack + (d_inner,), **f32),
      "norm_in": torch.ones(stack + (d,), **f32),        # pre-norm
  }


def _split_proj(p, xin: torch.Tensor, cfg: ModelConfig, expand: int = 2,
                policy=None):
  d_inner = expand * cfg.d_model
  nheads = d_inner // HEAD_DIM
  n = cfg.ssm_state
  zx = gemm(p["in_zx"], xin, policy)
  bcdt = gemm(p["in_bcdt"], xin, policy)
  z, x = zx[..., :d_inner], zx[..., d_inner:]
  B, C, dt = bcdt[..., :n], bcdt[..., n:2 * n], bcdt[..., 2 * n:]
  return z, x, B, C, dt, d_inner, nheads


def _causal_conv(x: torch.Tensor, w: torch.Tensor, state=None):
  """Depthwise causal conv of width CONV_WIDTH. x: (b, s, c), w: (k, c).
  The taps sum in x's dtype and silu runs in f32, as the reference.
  With `state` (b, k-1, c) it is the streaming update (decode). Returns
  (silu(conv) in x.dtype, the last k-1 inputs (b, k-1, c))."""
  b, s, c = x.shape
  k = w.shape[0]
  if state is None:
    pad = x.new_zeros((b, k - 1, c))
  else:
    pad = state.to(x.dtype)
  xp = torch.cat([pad, x], dim=1)
  out = sum(xp[:, i:i + s] * w[i].to(x.dtype) for i in range(k))
  return F.silu(out.float()).to(x.dtype), xp[:, -(k - 1):]


def _segsum(log_a: torch.Tensor) -> torch.Tensor:
  """segsum(x)[..., i, j] = sum_{j < k <= i} x_k, -inf above the
  diagonal (masked before any exp, so no inf * 0 reaches a gradient)."""
  t = log_a.shape[-1]
  cs = torch.cumsum(log_a, dim=-1)
  diff = cs[..., :, None] - cs[..., None, :]
  mask = torch.ones((t, t), dtype=torch.bool, device=log_a.device).tril()
  return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, chunk: int = CHUNK):
  """Chunked SSD. x: (b, s, h, p); dt: (b, s, h); A: (h,); B, C:
  (b, s, n); `chunk` must divide s. Returns y (b, s, h, p) and the final
  state (b, h, n, p), both f32."""
  b, s, h, p = x.shape
  n = B.shape[-1]
  if s % chunk:
    raise ValueError(
        f"ssd_chunked: {s} positions do not split into chunks of {chunk} "
        f"(CHUNK = {CHUNK}; the reference reshapes s into s // chunk "
        "chunks): a sequence longer than CHUNK must be a multiple of it")
  nc = s // chunk
  f32 = torch.float32
  xc = (x.to(f32) * dt.to(f32)[..., None]).reshape(b, nc, chunk, h, p)
  da = (dt.to(f32) * A.to(f32)).reshape(b, nc, chunk, h)   # log decay
  Bc = B.to(f32).reshape(b, nc, chunk, n)
  Cc = C.to(f32).reshape(b, nc, chunk, n)
  da_cs = torch.cumsum(da, dim=2)                          # (b, nc, Q, h)
  da_total = da_cs[:, :, -1]                               # (b, nc, h)

  # intra-chunk: y_i = sum_j L_ij (C_i . B_j) x_j, L = exp(segsum(da))
  L = torch.exp(_segsum(da.permute(0, 1, 3, 2)))           # (b, nc, h, Q, Q)
  scores = torch.matmul(Cc, Bc.transpose(-1, -2))          # (b, nc, Q, Q)
  xh = xc.permute(0, 1, 3, 2, 4)                           # (b, nc, h, Q, p)
  y_intra = torch.matmul(L * scores[:, :, None], xh)       # (b, nc, h, Q, p)

  # each chunk's state: S_c = sum_j exp(da_total - da_cs_j) B_j x_j
  decay_tail = torch.exp(da_total[:, :, None] - da_cs)     # (b, nc, Q, h)
  xs = (xc * decay_tail[..., None]).reshape(b, nc, chunk, h * p)
  S = torch.matmul(Bc.transpose(-1, -2), xs)               # (b, nc, n, h*p)
  S = S.reshape(b, nc, n, h, p).permute(0, 1, 3, 2, 4)     # (b, nc, h, n, p)

  # inter-chunk recurrence: the state entering each chunk
  H = x.new_zeros((b, h, n, p), dtype=f32)
  h_in = []
  for c in range(nc):
    h_in.append(H)
    H = H * torch.exp(da_total[:, c])[..., None, None] + S[:, c]
  Hin = torch.stack(h_in, dim=1)                           # (b, nc, h, n, p)

  # y_i += exp(da_cs_i) C_i . H_in
  y_inter = torch.matmul(Cc[:, :, None], Hin)              # (b, nc, h, Q, p)
  y_inter = y_inter * torch.exp(da_cs).permute(0, 1, 3, 2)[..., None]
  y = (y_intra + y_inter).permute(0, 1, 3, 2, 4).reshape(b, s, h, p)
  return y, H


def _gate_out(p, y: torch.Tensor, xh: torch.Tensor, z: torch.Tensor,
              x: torch.Tensor, cfg: ModelConfig, policy) -> torch.Tensor:
  """y + D x, gated by silu(z), normed and projected: the tail every
  path of the block shares. y, xh: (..., h, p) f32; z: (..., d_inner)."""
  d_inner = z.shape[-1]
  y = y + xh * p["D"].to(torch.float32)[:, None]
  y = y.reshape(z.shape[:-1] + (d_inner,)).to(x.dtype)
  y = y * F.silu(z.to(torch.float32)).to(x.dtype)
  y = rms_norm(y, p["norm"], cfg.norm_eps)
  return gemm(p["out_proj"], y, policy)


def _dt_A(p, dt: torch.Tensor):
  dt = F.softplus(dt.to(torch.float32) + p["dt_bias"].to(torch.float32))
  return dt, -torch.exp(p["A_log"].to(torch.float32))


def mamba2_forward(p, x: torch.Tensor, cfg: ModelConfig, expand: int = 2,
                   policy=None, cs: Constraint = identity_constraint
                   ) -> torch.Tensor:
  """The block over a whole sequence x (b, s, d) (training, prefill); `p`
  maps the leaf names to one layer's leaves. The final SSM state is
  discarded, as the reference's. On DTensors (a mesh) the SSD scan runs
  on each rank's rows and heads; B and C, which every head reads, whole
  on the model axis."""
  b, s, _ = x.shape
  z, xi, B, C, dt, d_inner, nheads = _split_proj(p, x, cfg, expand, policy)
  xi, _ = _causal_conv(xi, p["conv_w"])
  xi = cs(xi, "bsi")
  dt, A = _dt_A(p, dt)
  xh = xi.reshape(b, s, nheads, HEAD_DIM)
  y, _ = shd.split_call(functools.partial(ssd_chunked, chunk=min(CHUNK, s)),
                        (xh, "bsh"), (dt, "bsh"), (A, "h"), (B, "b"),
                        (C, "b"), out=("bsh", "bh"))
  return _gate_out(p, y, xh.to(torch.float32), z, x, cfg, policy)


# -- decode ------------------------------------------------------------------


def init_mamba2_state(cfg: ModelConfig, batch: int, stack: tuple = (),
                      expand: int = 2, device=None) -> dict:
  """{"ssm": (stack, batch, heads, d_state, HEAD_DIM) f32, "conv":
  (stack, batch, CONV_WIDTH - 1, d_inner) in cfg.dtype}, zeros."""
  d_inner = expand * cfg.d_model
  nheads = d_inner // HEAD_DIM
  stack = tuple(stack)
  return {
      "ssm": torch.zeros(stack + (batch, nheads, cfg.ssm_state, HEAD_DIM),
                         dtype=torch.float32, device=device),
      "conv": torch.zeros(stack + (batch, CONV_WIDTH - 1, d_inner),
                          dtype=cfg.dtype, device=device),
  }


def _step_core(dt, A, xh, Bf, Cf, ssm):
  """One position of the recurrence: dt (b, h), A (h,), xh (b, h, p),
  Bf, Cf (b, n), ssm (b, h, n, p) -> (y (b, h, p), ssm')."""
  da = torch.exp(dt * A)                                   # (b, h)
  upd = Bf[:, None, :, None] * (xh * dt[..., None])[:, :, None, :]
  ssm = ssm * da[..., None, None] + upd                    # (b, h, n, p)
  return torch.matmul(Cf[:, None, None, :], ssm)[:, :, 0], ssm


def mamba2_decode(p, x: torch.Tensor, state: dict, cfg: ModelConfig,
                  expand: int = 2, policy=None,
                  cs: Constraint = identity_constraint
                  ) -> tuple[torch.Tensor, dict]:
  """One decode step. x: (b, 1, d); state {"ssm" (b, h, n, p), "conv"
  (b, k-1, d_inner)}, updated in place: h' = exp(dt A) h + dt B x. On
  DTensors (a mesh) the recurrence runs on each rank's rows with every
  head, so the SSM carry, laid out by rows, never moves between ranks
  (the step's inputs, a few values a head, are gathered instead)."""
  b = x.shape[0]
  z, xi, B, C, dt, d_inner, nheads = _split_proj(p, x, cfg, expand, policy)
  xi, conv = _causal_conv(xi, p["conv_w"], state["conv"])
  dt, A = _dt_A(p, dt)
  xh = xi[:, 0].reshape(b, nheads, HEAD_DIM).to(torch.float32)
  y, ssm = shd.split_call(_step_core, (dt[:, 0], "b"), (A, ""), (xh, "b"),
                          (B[:, 0].to(torch.float32), "b"),
                          (C[:, 0].to(torch.float32), "b"),
                          (state["ssm"], "b"), out=("b", "b"))
  shd.assign(state["ssm"], ssm)
  shd.assign(state["conv"], conv)
  return _gate_out(p, y[:, None], xh[:, None], z, x, cfg, policy), state


def _window_core(dt, A, xh, Bf, Cf, ssm):
  """The recurrence over a window: dt (b, W, h), A (h,), xh (b, W, h,
  p), Bf, Cf (b, W, n), ssm (b, h, n, p) -> (y (b, W, h, p), the last
  ssm), position by position in f32."""
  w = xh.shape[1]
  da = torch.exp(dt * A)
  upd = Bf[:, :, None, :, None] * (xh * dt[..., None])[:, :, :, None, :]
  seq = []
  for t in range(w):
    ssm = ssm * da[:, t, :, None, None] + upd[:, t]
    seq.append(ssm)
  seq = torch.stack(seq, dim=1)                            # (b, W, h, n, p)
  return torch.matmul(Cf[:, :, None, None, :], seq)[:, :, :, 0], ssm


def mamba2_decode_window(p, x: torch.Tensor, state: dict, cfg: ModelConfig,
                         expand: int = 2, policy=None,
                         cs: Constraint = identity_constraint
                         ) -> tuple[torch.Tensor, dict]:
  """A W-token decode window, x: (b, W, d), state as `mamba2_decode`'s.
  The GEMMs take all b * W rows in one pass, the conv streams the window
  and the per-position terms batch over it; only the recurrence
  h' = da h + upd runs position by position, in f32. Each row equals W
  sequential `mamba2_decode` steps up to the GEMMs' summation order."""
  b, w, _ = x.shape
  z, xi, B, C, dt, d_inner, nheads = _split_proj(p, x, cfg, expand, policy)
  xi, conv = _causal_conv(xi, p["conv_w"], state["conv"])
  dt, A = _dt_A(p, dt)                                     # (b, W, h)
  xh = xi.reshape(b, w, nheads, HEAD_DIM).to(torch.float32)
  y, ssm = shd.split_call(_window_core, (dt, "b"), (A, ""), (xh, "b"),
                          (B.to(torch.float32), "b"),
                          (C.to(torch.float32), "b"), (state["ssm"], "b"),
                          out=("b", "b"))
  shd.assign(state["ssm"], ssm)
  shd.assign(state["conv"], conv)
  return _gate_out(p, y, xh, z, x, cfg, policy), state
