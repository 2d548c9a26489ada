"""Plain PyTorch versions of the five CUDA kernels, plus the int8
quantizers — the counterparts of `repro.kernels.ref`.

Each function is the kernel's mathematical definition with no tiling.
The `ops` wrappers take them for tensors on the CPU; the tests and
`chip_smoke.py` hold the CUDA kernels against them on the card. On a
CUDA tensor the serving path never calls them.
"""
from __future__ import annotations

import torch

f32 = torch.float32


def lowrank_gemm(x: torch.Tensor, u: torch.Tensor,
                 v: torch.Tensor) -> torch.Tensor:
  """y = (x @ u) @ v, the rank intermediate kept in f32; output x.dtype."""
  t = torch.matmul(x.to(f32), u.to(f32))
  return torch.matmul(t, v.to(f32)).to(x.dtype)


def int8_gemm(x_q: torch.Tensor, w_q: torch.Tensor, x_scale: torch.Tensor,
              w_scale: torch.Tensor) -> torch.Tensor:
  """y = (x_q @ w_q) * x_scale[:, None] * w_scale[None, :], f32 output.

  The integer product is taken in float64, which holds every partial sum
  exactly (|sum| <= 127^2 * m << 2^53) on any device — CUDA has no int32
  matmul — so `acc` equals the s32 accumulation of the kernel, and its
  rounding to f32 equals the kernel's int -> f32 conversion."""
  acc = torch.matmul(x_q.to(torch.float64), w_q.to(torch.float64))
  return acc.to(f32) * x_scale[:, None] * w_scale[None, :]


def decode_matvec(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
  """y = x @ w — the paper's low-batch GEMM (b in 1..16); output x.dtype."""
  return torch.matmul(x.to(f32), w.to(f32)).to(x.dtype)


def gru_cell(xw: torch.Tensor, h: torch.Tensor, u: torch.Tensor,
             bias: torch.Tensor) -> torch.Tensor:
  """Fused GRU step (paper eq. 10), given precomputed xw = x @ W_nonrec.

  xw: (b, 3H); h: (b, H); u: (H, 3H); bias: (3H,). Gate order along the
  3H axis: [z, r, hcand]; r gates only the recurrent term U_h h."""
  hidden = h.shape[-1]
  hu = torch.matmul(h.to(f32), u.to(f32))
  g = xw.to(f32) + hu + bias.to(f32)
  gz, gr, gh = g[:, :hidden], g[:, hidden:2 * hidden], g[:, 2 * hidden:]
  hu_h = hu[:, 2 * hidden:]
  z = torch.sigmoid(gz)
  r = torch.sigmoid(gr)
  hcand = torch.tanh(gh - hu_h + r * hu_h)
  h1 = (1.0 - z) * h.to(f32) + z * hcand
  return h1.to(h.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
  """Reference attention. q: (b, s, h, d); k, v: (b, s, h_kv, d) with
  h % h_kv == 0, repeated here so that q head j reads kv head
  j // (h // h_kv) -> (b, s, h, d) in q.dtype. f32 scores over the whole
  S x S matrix, so only for the shapes a test or a check compares at."""
  s, h, d = q.shape[1], q.shape[2], q.shape[-1]
  if k.shape[2] != h:
    k = torch.repeat_interleave(k, h // k.shape[2], dim=2)
    v = torch.repeat_interleave(v, h // v.shape[2], dim=2)
  sc = torch.einsum("bqhd,bkhd->bhqk", q.to(f32), k.to(f32)) / (d ** 0.5)
  if causal:
    mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=q.device))
    sc = torch.where(mask, sc, float("-inf"))
  p = torch.softmax(sc, dim=-1)
  return torch.einsum("bhqk,bkhd->bqhd", p, v.to(f32)).to(q.dtype)


def quantize_rowwise(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
  """Symmetric per-row int8 quantization: returns (q, scale). Divides
  (never multiplies by a reciprocal) and rounds half to even, so q and
  scale equal the reference's bit for bit."""
  amax = torch.amax(torch.abs(x.to(f32)), dim=-1)
  scale = torch.clamp_min(amax, 1e-8) / 127.0
  q = torch.clamp(torch.round(x.to(f32) / scale[..., None]), -127, 127)
  return q.to(torch.int8), scale


def quantize_colwise(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
  """Symmetric per-column int8 quantization (reduction over axis -2):
  returns (q, scale)."""
  amax = torch.amax(torch.abs(w.to(f32)), dim=-2)
  scale = torch.clamp_min(amax, 1e-8) / 127.0
  q = torch.clamp(torch.round(w.to(f32) / scale[..., None, :]), -127, 127)
  return q.to(torch.int8), scale


def quantize_static(x: torch.Tensor, scale: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
  """Symmetric int8 quantization of x (..., m) with a fixed scalar scale
  (a calibrated activation range): returns (q, per-row scales). Values
  past the range saturate at +-127."""
  scale = torch.clamp_min(scale.to(f32), 1e-8 / 127.0)
  q = torch.clamp(torch.round(x.to(f32) / scale), -127, 127)
  return q.to(torch.int8), scale.expand(x.shape[:-1])
