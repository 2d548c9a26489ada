"""Gated FFN (SwiGLU) and the plain GELU FFN (Whisper) — counterpart of
`repro.layers.ffn`."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.factored import dense
from repro_torch.layers.common import Constraint, gemm, identity_constraint


class SwiGLU(nn.Module):
  """w_gate, w_up (d, f) and w_down (f, d); layer-stacked in a model."""

  def __init__(self, w_gate: nn.Module, w_up: nn.Module, w_down: nn.Module):
    super().__init__()
    self.w_gate, self.w_up, self.w_down = w_gate, w_up, w_down


def init_swiglu(d: int, f: int, *, layer_prefix: str, dtype: torch.dtype,
                stack: tuple = (), generator: torch.Generator,
                device) -> SwiGLU:
  kw = dict(dtype=dtype, stack=stack, generator=generator, device=device)
  return SwiGLU(dense(d, f, name=f"{layer_prefix}/ffn_gate", **kw),
                dense(d, f, name=f"{layer_prefix}/ffn_up", **kw),
                dense(f, d, name=f"{layer_prefix}/ffn_down", **kw))


def swiglu_forward(p, x: torch.Tensor, policy=None,
                   cs: Constraint = identity_constraint) -> torch.Tensor:
  """`p` maps "w_gate", "w_up", "w_down" to 2-D leaves. silu runs in
  f32 and rounds to x.dtype before the product with u, as the
  reference rounds in bf16."""
  g = cs(gemm(p["w_gate"], x, policy), "bsf")
  u = cs(gemm(p["w_up"], x, policy), "bsf")
  h = F.silu(g.to(torch.float32)).to(x.dtype) * u
  return gemm(p["w_down"], h, policy)


class GeluFFN(nn.Module):
  """w_in (d, f), w_out (f, d) and their f32 biases b_in (f,), b_out
  (d,); layer-stacked in a model."""

  def __init__(self, w_in: nn.Module, w_out: nn.Module, b_in: torch.Tensor,
               b_out: torch.Tensor):
    super().__init__()
    self.w_in, self.w_out = w_in, w_out
    self.b_in = nn.Parameter(b_in, requires_grad=False)
    self.b_out = nn.Parameter(b_out, requires_grad=False)


def init_gelu_ffn(d: int, f: int, *, layer_prefix: str, dtype: torch.dtype,
                  stack: tuple = (), generator: torch.Generator,
                  device) -> GeluFFN:
  kw = dict(dtype=dtype, stack=stack, generator=generator, device=device)
  zeros = dict(dtype=torch.float32, device=device)
  return GeluFFN(dense(d, f, name=f"{layer_prefix}/ffn_in", **kw),
                 dense(f, d, name=f"{layer_prefix}/ffn_out", **kw),
                 torch.zeros(tuple(stack) + (f,), **zeros),
                 torch.zeros(tuple(stack) + (d,), **zeros))


def gelu_ffn_forward(p, x: torch.Tensor, policy=None,
                     cs: Constraint = identity_constraint) -> torch.Tensor:
  """`p` maps "w_in", "w_out" to 2-D leaves and "b_in", "b_out" to f32
  biases, which are cast to x.dtype before they are added, as the
  reference does. GELU is `jax.nn.gelu`'s default, the tanh
  approximation, in f32, rounded to x.dtype."""
  h = gemm(p["w_in"], x, policy) + p["b_in"].to(x.dtype)
  h = cs(F.gelu(h.to(torch.float32), approximate="tanh").to(x.dtype), "bsf")
  return gemm(p["w_out"], h, policy) + p["b_out"].to(x.dtype)
