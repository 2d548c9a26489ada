"""Factored GEMM parameterization — the paper's W = UV building block.

Counterpart of `repro.core.factored`. A `FactoredLinear` is a small
`nn.Module` holding either `w` (unfactored) or `u`/`v` (factored), plus
the static logical `name` ("gru0/rec", "fc", ...) and `group`
("rec" | "nonrec"). Attribute paths follow the reference's pytree paths,
so `state_dict()` keys are the reference checkpoint paths with "." for
"/" (e.g. `grus.gru0.nonrec.w`).

Weights are `nn.Parameter`s made with `requires_grad=False`, as
serving wants them; `training.Trainer` turns gradients on for every
parameter it trains (`trainable`).

Layer-stacked leaves keep the reference's layout — `w` (L, m, n), as
`dense(..., stack=(L,))` makes it — so their `state_dict()` keys stay the
checkpoint paths. The reference scans over the stack; the port loops
over layers and takes layer i's 2-D leaf from `leaf.layer(i)`.
"""
from __future__ import annotations

import copy
from typing import Any, Iterator, Optional

import torch
from torch import nn


def acc_dtype(x: torch.Tensor) -> torch.dtype:
  """Dot output dtype rule (the reference's single source of truth):
  bf16 inputs emit bf16 (accumulated in f32 inside the GEMM); anything
  else emits f32."""
  return x.dtype if x.dtype == torch.bfloat16 else torch.float32


def matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
  """The framework's plain GEMM: y = x @ w with `acc_dtype` output,
  returned in x.dtype."""
  acc = acc_dtype(x)
  return torch.matmul(x.to(acc), w.to(acc)).to(x.dtype)


def _param(t: Optional[torch.Tensor]) -> Optional[nn.Parameter]:
  return None if t is None else nn.Parameter(t, requires_grad=False)


class FactoredLinear(nn.Module):
  """A GEMM weight, unfactored (w: (m, n)) or factored (u: (m, r) @
  v: (r, n))."""

  def __init__(self, w: Optional[torch.Tensor] = None,
               u: Optional[torch.Tensor] = None,
               v: Optional[torch.Tensor] = None, *, name: str = "gemm",
               group: str = "nonrec", view: bool = False):
    super().__init__()
    if (w is None) == (u is None) or (u is None) != (v is None):
      raise ValueError("FactoredLinear holds either w, or both u and v")
    # a view (`layer`) keeps its tensors as they are, plain attributes:
    # a Parameter made of a slice would cut it from the stacked leaf's
    # autograd graph
    wrap = (lambda t: t) if view else _param
    self.w = wrap(w)
    self.u = wrap(u)
    self.v = wrap(v)
    self.name = name
    self.group = group

  # -- structure ------------------------------------------------------------
  @property
  def is_factored(self) -> bool:
    return self.u is not None

  @property
  def in_dim(self) -> int:
    return self.u.shape[-2] if self.is_factored else self.w.shape[-2]

  @property
  def out_dim(self) -> int:
    return self.v.shape[-1] if self.is_factored else self.w.shape[-1]

  @property
  def rank(self) -> int:
    """Factorization rank (min(m, n) if unfactored)."""
    if self.is_factored:
      return self.u.shape[-1]
    return min(self.w.shape[-2], self.w.shape[-1])

  @property
  def num_params(self) -> int:
    if self.is_factored:
      return self.u.numel() + self.v.numel()
    return self.w.numel()

  @property
  def dtype(self) -> torch.dtype:
    return self.u.dtype if self.is_factored else self.w.dtype

  def extra_repr(self) -> str:
    return f"name={self.name!r}, group={self.group!r}"

  # -- math -----------------------------------------------------------------
  def product(self) -> torch.Tensor:
    """W = UV (or w), batched over leading dims; the product is summed
    in f32 and returned in the factors' dtype."""
    if self.is_factored:
      return torch.matmul(self.u.float(), self.v.float()).to(self.u.dtype)
    return self.w

  def apply(self, x: torch.Tensor, policy=None) -> torch.Tensor:
    """y = x @ W, computed as (x @ U) @ V when factored.

    The plain factored path casts the rank intermediate to x.dtype
    between the two GEMMs, as the reference's jnp path does; the
    `lowrank_gemm` regime keeps it in f32 (the two round differently in
    bf16). `policy` routes through `kernels.dispatch`."""
    if policy is not None:
      from repro_torch.kernels import dispatch
      return dispatch.gemm(self, x, policy)
    if self.is_factored:
      t = matmul_ref(x, self.u)
      return matmul_ref(t, self.v)
    return matmul_ref(x, self.w)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    return self.apply(x)

  def layer(self, i: int) -> "FactoredLinear":
    """Layer i of a layer-stacked leaf, as a 2-D leaf sharing storage: a
    view whose tensors are the stack's slices, so gradients reach the
    stacked parameters through it."""
    if self.is_factored:
      return FactoredLinear(u=self.u[i], v=self.v[i], name=self.name,
                            group=self.group, view=True)
    return FactoredLinear(w=self.w[i], name=self.name, group=self.group,
                          view=True)


# ----------------------------------------------------------------------------
# Constructors.
# ----------------------------------------------------------------------------

def normal(shape: tuple, std: float, generator: torch.Generator,
           dtype: torch.dtype, device) -> torch.Tensor:
  """N(0, std^2) from `generator`. A CPU generator draws f32 on the CPU,
  then the values move: the same seed gives the same weights on every
  device. A CUDA generator draws on its device, straight in `dtype` (a
  full-width LM would need ~32 GB of f32 host draws otherwise)."""
  if generator.device.type == "cpu":
    w = torch.randn(shape, generator=generator, dtype=torch.float32) * std
    return w.to(device=device, dtype=dtype)
  w = torch.randn(shape, generator=generator, dtype=dtype,
                  device=generator.device)
  return w.mul_(std).to(device)


def dense(m: int, n: int, *, name: str, group: str = "nonrec",
          dtype: torch.dtype = torch.float32, scale: Optional[float] = None,
          generator: torch.Generator, device,
          stack: tuple = ()) -> FactoredLinear:
  """Unfactored GEMM with LeCun-normal init (stddev 1/sqrt(m)); `stack`
  prepends layer axes, as the reference's `dense(..., stack=)`."""
  scale = (1.0 / m) ** 0.5 if scale is None else scale
  w = normal(tuple(stack) + (m, n), scale, generator, dtype, device)
  return FactoredLinear(w=w, name=name, group=group)


def factored(m: int, n: int, r: Optional[int] = None, *, name: str,
             group: str = "nonrec", dtype: torch.dtype = torch.float32,
             scale: Optional[float] = None, generator: torch.Generator,
             device) -> FactoredLinear:
  """Factored GEMM, r = min(m, n) by default. U and V each get stddev
  sqrt(scale / sqrt(r)), so W = UV has the variance of the dense init."""
  r = min(m, n) if r is None else r
  scale = (1.0 / m) ** 0.5 if scale is None else scale
  s = (scale / (r ** 0.5)) ** 0.5
  u = normal((m, r), s, generator, dtype, device)
  v = normal((r, n), s, generator, dtype, device)
  return FactoredLinear(u=u, v=v, name=name, group=group)


# ----------------------------------------------------------------------------
# Tree traversal.
# ----------------------------------------------------------------------------

#: GEMM-leaf module types; `repro_torch.quant`'s QuantizedLinear registers
#: itself on import so traversals treat it as a whole GEMM
GEMM_LEAF_TYPES: tuple = (FactoredLinear,)


def register_gemm_leaf(cls) -> type:
  """Register another GEMM-leaf module type (idempotent)."""
  global GEMM_LEAF_TYPES
  if cls not in GEMM_LEAF_TYPES:
    GEMM_LEAF_TYPES = GEMM_LEAF_TYPES + (cls,)
  return cls


def is_gemm_leaf(x: Any) -> bool:
  return isinstance(x, GEMM_LEAF_TYPES)


def iter_gemm_leaves(model: nn.Module) -> Iterator[nn.Module]:
  """Yield every GEMM-leaf module of any registered type, depth-first."""
  for mod in model.modules():
    if is_gemm_leaf(mod):
      yield mod


def iter_factored_leaves(model: nn.Module) -> Iterator[FactoredLinear]:
  """Yield every FactoredLinear module, depth-first."""
  for mod in iter_gemm_leaves(model):
    if isinstance(mod, FactoredLinear):
      yield mod


def param_tree(model: nn.Module) -> dict[str, nn.Parameter]:
  """{reference path: parameter} of a model: `named_parameters()` with
  "/" for "." ("grus/gru0/rec/u", "conv1", ...), the keys the reference's
  checkpoints and optimizer trees use."""
  return {name.replace(".", "/"): p for name, p in model.named_parameters()}


def count_params(model: nn.Module) -> int:
  """Total parameter count, GEMM leaves at their stored (factored or
  quantized) size: every other parameter and buffer counted whole."""
  total = 0
  leaves = list(iter_gemm_leaves(model))
  inside = {id(t) for leaf in leaves for t in
            list(leaf.parameters()) + list(leaf.buffers())}
  for leaf in leaves:
    total += leaf.num_params
  for t in list(model.parameters()) + list(model.buffers()):
    if id(t) not in inside:
      total += t.numel()
  return total


def trainable(model: nn.Module) -> nn.Module:
  """Turn gradients on for every parameter of `model`, in place."""
  for p in model.parameters():
    p.requires_grad_(True)
  return model


def frozen(model: nn.Module) -> nn.Module:
  """Turn gradients off for every parameter of `model`, in place (the
  form the serving path and the kernels take)."""
  for p in model.parameters():
    p.requires_grad_(False)
  return model


def map_factored_leaves(fn, model: nn.Module) -> nn.Module:
  """A copy of `model` with every FactoredLinear replaced by fn(leaf);
  the argument is left untouched, as the reference's tree_map leaves
  its input tree."""
  out = copy.deepcopy(model)
  for parent in list(out.modules()):
    for key, child in list(parent.named_children()):
      if isinstance(child, FactoredLinear):
        setattr(parent, key, fn(child))
  return out
