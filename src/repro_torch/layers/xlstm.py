"""xLSTM blocks — counterpart of `repro.layers.xlstm`: the mLSTM (matrix
memory, chunkwise-parallel) and the sLSTM (scalar memory, a time
recurrence) of Beck et al. 2024, arXiv:2405.04517.

The paper's recurrent / non-recurrent split: the mLSTM's up, q/k/v,
gate and down projections and the sLSTM's input GEMM `wx` are
`nonrec`; the sLSTM's block-diagonal recurrent kernel `rh` (heads, hd,
4 * hd) is the `rec` group, regularised with lambda_rec as DS2's GRU `U`
is.

`init_mlstm` and `init_slstm` return the reference's leaves as dicts,
which `MLSTM` and `SLSTM` (or a model's stack of them) hold. The layer
functions take `p`, one layer's dict of leaves (a stack's per-layer
view). The sLSTM applies `rh` head by head through `gemm`, each head a
2-D leaf (`head_views`), so `kernels.dispatch` routes it as the
reference routes `_head_rh`: with f32 activations over the weight's own
type (bf16 at full width) `decode_matvec` takes it at serving batch, and
a factored `rh` goes to `lowrank_gemm`.

The mLSTM's chunked form works in f32 over (b, CHUNK, CHUNK, heads)
decay tiles with the reference's -1e30 stabiliser starts, and keeps its
operation order, including the bf16 rounding of y and of silu(z) before
their product. A sequence longer than CHUNK must be a multiple of it
(the reference reshapes s into chunks); `mlstm_forward` raises a
`ValueError` naming CHUNK otherwise.

The decode functions write the new carries into `state` in place and
return the same dict.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.factored import dense
from repro_torch.dist import sharding as shd
from repro_torch.kernels import dispatch
from repro_torch.layers.common import ModelConfig, gemm
from repro_torch.layers.norms import rms_norm

CHUNK = 256
#: the stabiliser's start: exp(-1e30 - m) is 0 for any finite m
M_START = -1e30


def _params(mod: nn.Module, tensors: dict) -> None:
  for key, t in tensors.items():
    setattr(mod, key, nn.Parameter(t, requires_grad=False))


class MLSTM(nn.Module):
  """One mLSTM block's params (`init_mlstm`); layer-stacked in a model."""

  def __init__(self, up: nn.Module, qkv: nn.Module, ifg: nn.Module,
               down: nn.Module, norm: torch.Tensor):
    super().__init__()
    self.up, self.qkv, self.ifg, self.down = up, qkv, ifg, down
    _params(self, {"norm": norm})


class SLSTM(nn.Module):
  """One sLSTM block's params (`init_slstm`); layer-stacked in a model."""

  def __init__(self, wx: nn.Module, rh: nn.Module, bias: torch.Tensor,
               out: nn.Module, norm: torch.Tensor):
    super().__init__()
    self.wx, self.rh, self.out = wx, rh, out
    _params(self, {"bias": bias, "norm": norm})


# ----------------------------------------------------------------------------
# mLSTM
# ----------------------------------------------------------------------------

def init_mlstm(cfg: ModelConfig, *, layer_prefix: str, stack: tuple = (),
               pf: float = 2.0, generator: torch.Generator, device) -> dict:
  """`up` (d, 2 di), `qkv` (di, 3 di), `ifg` (di, 2 heads: the input and
  forget gates), `down` (di, d) LeCun-normal in cfg.dtype, and a unit
  f32 `norm` (di,); di = pf * d."""
  d = cfg.d_model
  di = int(pf * d)
  h = cfg.num_heads
  stack = tuple(stack)
  kw = dict(dtype=cfg.dtype, stack=stack, generator=generator, device=device)
  return {
      "up": dense(d, 2 * di, name=f"{layer_prefix}/mlstm_up", **kw),
      "qkv": dense(di, 3 * di, name=f"{layer_prefix}/mlstm_qkv", **kw),
      "ifg": dense(di, 2 * h, name=f"{layer_prefix}/mlstm_ifg", **kw),
      "down": dense(di, d, name=f"{layer_prefix}/mlstm_down", **kw),
      "norm": torch.ones(stack + (di,), dtype=torch.float32, device=device),
  }


def _mlstm_chunk(q, k, v, logf, logi, C0, n0, m0, *, state: bool = True):
  """One chunk of the stabilized chunkwise mLSTM.

  q, k, v: (b, Q, h, p) f32; logf, logi: (b, Q, h); state C0 (b, h, p,
  p), n0 (b, h, p), m0 (b, h). Returns y (b, Q, h, p) and the state at
  the chunk's end, or Nones for it where `state` is False (a chunk
  whose end state nobody reads: the reference's compiler drops its
  update)."""
  b, Q, h, p = q.shape
  scale = p ** 0.5
  Fc = torch.cumsum(logf, dim=1)                         # (b, Q, h)
  # intra-chunk decay D[i, j] = exp(F_i - F_j + logi_j), j <= i
  dmat = Fc[:, :, None, :] - Fc[:, None, :, :] + logi[:, None, :, :]
  tri = torch.ones((Q, Q), dtype=torch.bool, device=q.device).tril()
  dmat = dmat.masked_fill(~tri[None, :, :, None], float("-inf"))
  # inter-chunk carry decay for position i: exp(F_i + m0)
  carry_log = Fc + m0[:, None, :]                        # (b, Q, h)
  m_new = torch.maximum(dmat.amax(dim=2), carry_log)
  m_new = torch.clamp(m_new, min=M_START)

  dexp = torch.exp(dmat - m_new[:, :, None, :])          # (b, i, j, h)
  qh, kh = q.permute(0, 2, 1, 3), k.permute(0, 2, 1, 3)  # (b, h, Q, p)
  s = torch.matmul(qh, kh.transpose(-1, -2)).permute(0, 2, 3, 1) / scale
  w = s * dexp                                           # (b, i, j, h)
  y_intra = torch.matmul(w.permute(0, 3, 1, 2),
                         v.permute(0, 2, 1, 3)).permute(0, 2, 1, 3)
  l_intra = w.sum(dim=2)                                 # (b, i, h)

  cexp = torch.exp(carry_log - m_new)                    # (b, Q, h)
  y_inter = torch.matmul(qh, C0).permute(0, 2, 1, 3) / scale * cexp[..., None]
  l_inter = (torch.matmul(qh, n0[..., None])[..., 0].permute(0, 2, 1)
             / scale * cexp)

  norm = torch.maximum(torch.abs(l_intra + l_inter), torch.exp(-m_new))
  y = (y_intra + y_inter) / torch.clamp(norm[..., None], min=1e-30)
  if not state:
    return y, None, None, None

  # the state at the chunk's end
  Ftot = Fc[:, -1]                                       # (b, h)
  tail = Ftot[:, None] - Fc + logi                       # (b, Q, h)
  m_state = torch.maximum(Ftot + m0, tail.amax(dim=1))
  decay_tail = torch.exp(tail - m_state[:, None])        # (b, Q, h)
  kx = k * decay_tail[..., None]
  carry = torch.exp(Ftot + m0 - m_state)                 # (b, h)
  C1 = C0 * carry[..., None, None] + torch.matmul(
      kx.permute(0, 2, 3, 1), v.permute(0, 2, 1, 3))
  n1 = n0 * carry[..., None] + kx.sum(dim=1)
  return y, C1, n1, m_state


def _qkv_gates(p, x: torch.Tensor, cfg: ModelConfig, pf: float, policy):
  """The non-recurrent half of the block over x (b, W, d): q, k, v
  (b, W, h, hd) f32, logi and logf (b, W, h) f32, and z (b, W, di)."""
  b, w, d = x.shape
  di = int(pf * d)
  h = cfg.num_heads
  up = gemm(p["up"], x, policy)
  xin, z = up[..., :di], up[..., di:]
  qkv = gemm(p["qkv"], xin, policy)
  q, k, v = (t.reshape(b, w, h, di // h).to(torch.float32)
             for t in qkv.split(di, dim=-1))
  gates = gemm(p["ifg"], xin, policy).to(torch.float32).reshape(b, w, 2, h)
  return (q, k, v, gates[:, :, 0],
          shd.pointwise(F.logsigmoid, gates[:, :, 1]), z)


def _mlstm_out(p, y: torch.Tensor, z: torch.Tensor, x: torch.Tensor,
               cfg: ModelConfig, policy) -> torch.Tensor:
  """y (b, W, di) f32 gated by silu(z), each rounded to x's type before
  the product as the reference rounds them, normed and projected."""
  y = y.to(x.dtype) * F.silu(z.to(torch.float32)).to(x.dtype)
  y = rms_norm(y, p["norm"], cfg.norm_eps)
  return gemm(p["down"], y, policy)


def mlstm_forward(p, x: torch.Tensor, cfg: ModelConfig, pf: float = 2.0,
                  policy=None) -> torch.Tensor:
  """The block over a whole sequence x (b, s, d) (training, prefill),
  from the zero state; the final state is discarded, as the
  reference's."""
  b, s, d = x.shape
  di = int(pf * d)
  h = cfg.num_heads
  hd = di // h
  q, k, v, logi, logf, z = _qkv_gates(p, x, cfg, pf, policy)
  Q = min(CHUNK, s)
  if s % Q:
    raise ValueError(
        f"mlstm_forward: {s} positions do not split into chunks of {Q} "
        f"(CHUNK = {CHUNK}; the reference reshapes s into s // CHUNK "
        "chunks): a sequence longer than CHUNK must be a multiple of it")
  y = shd.rows_local(_mlstm_chunks, q, k, v, logf, logi, chunk=Q, heads=h,
                     hd=hd)
  return _mlstm_out(p, y.reshape(b, s, di), z, x, cfg, policy)


def _mlstm_chunks(q, k, v, logf, logi, *, chunk: int, heads: int, hd: int):
  """The chunk scan from the zero state: y (b, s, h, hd) f32."""
  b, s = q.shape[:2]
  f32 = dict(dtype=torch.float32, device=q.device)
  C = torch.zeros((b, heads, hd, hd), **f32)
  n = torch.zeros((b, heads, hd), **f32)
  m = torch.full((b, heads), M_START, **f32)
  ys = []
  n_chunks = s // chunk
  for c in range(n_chunks):               # the reference's chunk scan
    sl = slice(c * chunk, (c + 1) * chunk)
    y, C, n, m = _mlstm_chunk(q[:, sl], k[:, sl], v[:, sl], logf[:, sl],
                              logi[:, sl], C, n, m,
                              state=c < n_chunks - 1)
    ys.append(y)
  return torch.cat(ys, dim=1)


def init_mlstm_state(cfg: ModelConfig, batch: int, stack: tuple = (),
                     pf: float = 2.0, device=None) -> dict:
  """{"C": (stack, batch, h, hd, hd), "n": (stack, batch, h, hd), "m":
  (stack, batch, h)}, f32: zeros, and M_START for m."""
  di = int(pf * cfg.d_model)
  h = cfg.num_heads
  hd = di // h
  lead = tuple(stack) + (batch, h)
  f32 = dict(dtype=torch.float32, device=device)
  return {"C": torch.zeros(lead + (hd, hd), **f32),
          "n": torch.zeros(lead + (hd,), **f32),
          "m": torch.full(lead, M_START, **f32)}


def _mlstm_cell(q, k, v, logi, logf, C, n, m):
  """One position of the matrix-memory recurrence. q, k, v (b, h, hd),
  logi, logf (b, h); returns y (b, h, hd) and the new (C, n, m)."""
  hd = q.shape[-1]
  m1 = torch.maximum(logf + m, logi)
  fe = torch.exp(logf + m - m1)
  ie = torch.exp(logi - m1)
  C1 = C * fe[..., None, None] + ie[..., None, None] * (
      k[..., :, None] * v[..., None, :])
  n1 = n * fe[..., None] + ie[..., None] * k
  num = torch.matmul(q[..., None, :], C1)[..., 0, :] / (hd ** 0.5)
  den = torch.abs((q * n1).sum(dim=-1)) / (hd ** 0.5)
  y = num / torch.maximum(den, torch.exp(-m1))[..., None]
  return y, C1, n1, m1


def mlstm_decode(p, x: torch.Tensor, state: dict, cfg: ModelConfig,
                 pf: float = 2.0, policy=None) -> tuple[torch.Tensor, dict]:
  """One decode step. x: (b, 1, d); state {"C", "n", "m"} (b, ...),
  written in place."""
  return mlstm_decode_window(p, x, state, cfg, pf, policy)


def mlstm_decode_window(p, x: torch.Tensor, state: dict, cfg: ModelConfig,
                        pf: float = 2.0, policy=None
                        ) -> tuple[torch.Tensor, dict]:
  """A W-token decode window, x: (b, W, d). The up/qkv/ifg/down GEMMs
  take all b * W rows in one weight pass; only the matrix-memory
  recurrence runs position by position, each position the decode step's
  operations in its order."""
  b, w, _ = x.shape
  di = int(pf * cfg.d_model)
  q, k, v, logi, logf, z = _qkv_gates(p, x, cfg, pf, policy)
  y, C, n, m = shd.rows_local(_mlstm_steps, q, k, v, logi, logf, state["C"],
                              state["n"], state["m"], n_out=4)
  for key, t in (("C", C), ("n", n), ("m", m)):
    shd.assign(state[key], t)
  return _mlstm_out(p, y.reshape(b, w, di), z, x, cfg, policy), state


def _mlstm_steps(q, k, v, logi, logf, C, n, m):
  """The matrix memory position by position over a window: y (b, W, h,
  hd) and the last (C, n, m)."""
  ys = []
  for t in range(q.shape[1]):
    y, C, n, m = _mlstm_cell(q[:, t], k[:, t], v[:, t], logi[:, t],
                             logf[:, t], C, n, m)
    ys.append(y)
  return torch.stack(ys, dim=1), C, n, m


# ----------------------------------------------------------------------------
# sLSTM
# ----------------------------------------------------------------------------

def init_slstm(cfg: ModelConfig, *, layer_prefix: str, stack: tuple = (),
               generator: torch.Generator, device) -> dict:
  """`wx` (d, 4d: the four gates' input GEMM, the paper's W_cat), `rh`
  (stack + (heads, hd, 4 hd): the block-diagonal recurrent kernel, the
  paper's U_cat, group "rec"), `out` (d, d) in cfg.dtype, and f32 `bias`
  (4d,) zeros and `norm` (d,) ones."""
  d = cfg.d_model
  h = cfg.num_heads
  hd = d // h
  stack = tuple(stack)
  kw = dict(dtype=cfg.dtype, generator=generator, device=device)
  return {
      "wx": dense(d, 4 * d, name=f"{layer_prefix}/slstm_nonrec",
                  group="nonrec", stack=stack, **kw),
      "rh": dense(hd, 4 * hd, name=f"{layer_prefix}/slstm_rec", group="rec",
                  stack=stack + (h,), **kw),
      "bias": torch.zeros(stack + (4 * d,), dtype=torch.float32,
                          device=device),
      "out": dense(d, d, name=f"{layer_prefix}/slstm_out", stack=stack, **kw),
      "norm": torch.ones(stack + (d,), dtype=torch.float32, device=device),
  }


def head_views(rh, heads: int) -> list:
  """The recurrent kernel (h, hd, 4 hd) — a dense, factored or quantized
  GEMM leaf — as the h 2-D leaves of its heads, each sharing storage (the
  reference's `_head_rh`), which `gemm` routes."""
  return [rh.layer(i) for i in range(heads)]


def _slstm_cell(xg: torch.Tensor, hcnm: tuple, heads: list, h_: int,
                hd: int, policy=None) -> tuple:
  """One sLSTM time step. xg: (b, 4d), the precomputed input GEMM;
  hcnm: the (h, c, n, m) carries (b, d) f32; heads: `head_views`. The
  recurrent GEMM takes the hidden state in f32, each head through
  `gemm`."""
  hprev, c, n, m = hcnm
  b = hprev.shape[0]
  hh = hprev.reshape(b, h_, hd).to(torch.float32)
  outs = [gemm(heads[i], hh[:, i, :], policy) for i in range(h_)]
  rg = torch.stack(outs, dim=1).reshape(b, 4 * h_ * hd)
  g = xg.to(torch.float32) + rg
  gz, gi, gf, go = g.reshape(b, 4, h_ * hd).unbind(dim=1)
  z = torch.tanh(gz)
  logi = gi
  logf = F.logsigmoid(gf)
  o = torch.sigmoid(go)
  m1 = torch.maximum(logf + m, logi)
  ie = torch.exp(logi - m1)
  fe = torch.exp(logf + m - m1)
  c1 = fe * c + ie * z
  n1 = fe * n + ie
  h1 = o * c1 / torch.clamp(n1, min=1e-6)
  return (h1, c1, n1, m1)


def _slstm_scan(p, x: torch.Tensor, hcnm: tuple, cfg: ModelConfig, policy
                ) -> tuple[torch.Tensor, tuple]:
  """The input GEMM over all of x (b, W, d) (the paper's Wx batching),
  then the cell position by position from `hcnm`; returns the block's
  output and the last carries. On DTensors (a mesh) the cell runs on
  each rank's rows with `rh` gathered whole once a call, so every head's
  GEMM is one device's."""
  h_ = cfg.num_heads
  hd = cfg.d_model // h_
  xg = gemm(p["wx"], x, policy) + p["bias"].to(x.dtype)
  hs, *hcnm = shd.rows_local(_slstm_steps, xg, *hcnm, whole=(p["rh"],),
                             heads=h_, hd=hd, policy=policy, n_out=5)
  y = rms_norm(hs.to(x.dtype), p["norm"], cfg.norm_eps)
  return gemm(p["out"], y, policy), tuple(hcnm)


def _slstm_steps(xg, h, c, n, m, rh, *, heads: int, hd: int, policy):
  """The sLSTM cell position by position over xg (b, W, 4d) from the
  carries (h, c, n, m), each head's `rh` block a 2-D leaf
  (`head_views`): the hidden states (b, W, d) f32 and the last (h, c, n,
  m)."""
  hcnm, heads = (h, c, n, m), head_views(rh, heads)
  hs = []
  with dispatch.scanned():                # the reference's time scan
    for t in range(xg.shape[1]):
      hcnm = _slstm_cell(xg[:, t], hcnm, heads, len(heads), hd, policy)
      hs.append(hcnm[0])
  return (torch.stack(hs, dim=1),) + tuple(hcnm)


def slstm_forward(p, x: torch.Tensor, cfg: ModelConfig,
                  policy=None) -> torch.Tensor:
  """The block over a whole sequence x (b, s, d), from the zero state."""
  b, _, d = x.shape
  zero = torch.zeros((b, d), dtype=torch.float32, device=x.device)
  y, _ = _slstm_scan(p, x, (zero, zero, zero, torch.full_like(zero, M_START)),
                     cfg, policy)
  return y


def init_slstm_state(cfg: ModelConfig, batch: int, stack: tuple = (),
                     device=None) -> dict:
  """{"h", "c", "n": zeros, "m": M_START}, each (stack, batch, d) f32."""
  shape = tuple(stack) + (batch, cfg.d_model)
  f32 = dict(dtype=torch.float32, device=device)
  return {"h": torch.zeros(shape, **f32), "c": torch.zeros(shape, **f32),
          "n": torch.zeros(shape, **f32), "m": torch.full(shape, M_START, **f32)}


_SLSTM_KEYS = ("h", "c", "n", "m")


def slstm_decode(p, x: torch.Tensor, state: dict, cfg: ModelConfig,
                 policy=None) -> tuple[torch.Tensor, dict]:
  """One decode step. x: (b, 1, d); state {"h", "c", "n", "m"} (b, d),
  written in place."""
  return slstm_decode_window(p, x, state, cfg, policy)


def slstm_decode_window(p, x: torch.Tensor, state: dict, cfg: ModelConfig,
                        policy=None) -> tuple[torch.Tensor, dict]:
  """A W-token decode window, x: (b, W, d): the input GEMM (and out,
  norm) over the whole window, the cell position by position from the
  decode carries, as `slstm_forward` splits it."""
  from repro_torch.dist.sharding import assign
  y, new = _slstm_scan(p, x, tuple(state[k] for k in _SLSTM_KEYS), cfg,
                       policy)
  for key, t in zip(_SLSTM_KEYS, new):
    assign(state[key], t)
  return y, state
