"""The op walk: every aten op a program runs, with its dispatch scope
and operand provenance.

Counterpart of `repro/analysis/jaxpr_walk.py`, renamed because eager
PyTorch has no jaxpr to walk: the program runs once, on real tensors,
under `OpWalk`, a `TorchDispatchMode` that sees every aten op as it
runs, beside a `TorchFunctionMode` that sees the composite products
(`matmul`, `@`, `linear`, `einsum`) before PyTorch decomposes them, so
that a product's operand shapes are the ones the model wrote (the
reference's `dot_general` shapes: `x @ table.T` of a (2, 1, 128) x is
((2, 1, 128), (128, 512)), not the (2, 128) `mm` it folds into).

What the walk keeps:

* `DotSite` for every product: the composite ones above at the function
  level (the aten products they run inside are not counted again), and
  `mm`, `bmm`, `addmm`, `baddbmm` reached any other way;
* `ConvertSite` for a floating-point result of an int8-parameter-derived
  operand: a `_to_copy` or `copy_` to a float type, or any other op whose
  int8 operand PyTorch promotes to a float result (`w_q * scale`), which
  JAX cannot do without a `convert_element_type`;
* `HostSite` for `_local_scalar_dense` (`.item()`, `float(t)`) and for a
  `_to_copy` or `copy_` that changes device;
* `ScopeSite` for every dispatch scope that closed, with the kernel
  launches (`kernels.ops.LAUNCHES`) made inside it.

Each site carries the dispatch scopes open when it ran (outermost
first, joined by "/": the reference's name-stack form, "" outside every
scope), which the walk keeps from the `scope_opened` / `scope_closed`
calls of `kernels.dispatch.listen_scopes()`.

Provenance ("derived from a parameter", "derived from an int8
parameter") is seeded by tensor identity from the model's parameters
and buffers and flows, as the reference's, only through the unary
structural ops (`TRANSPARENT`, first operand only): a bias-add or a norm
scale does not make its activation parameter-derived, so attention's
activation x cache products stay clean. A float conversion of an int8
value ends its int8 provenance (it was dequantized), as in the
reference.

The CUDA kernels are bound through `ctypes` (`kernels/_build.py`), so no
aten op stands for a launch: inside a kernel-regime scope the walk sees
only the wrapper's reshapes and allocations (the counterpart of the
reference not descending into `pallas_call`), and the scope's launch
count says what ran. On the CPU the wrappers run `kernels/ref.py`,
whose products appear inside their scope: attributable, not a bypass.
The int8 oracle there (`ref.int8_gemm`) takes its integer product in
float64, its exact s32 accumulation; a float64 conversion made by that
function's own frame is marked `oracle=True`, and is the one conversion
of int8 weights `checks.check_quant_integrity` accepts.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Iterable, Optional

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.kernels import dispatch, ops, ref

#: aten ops provenance flows through (first operand only): the
#: counterparts of the reference's unary structural primitives
TRANSPARENT = frozenset({
    "view", "_unsafe_view", "reshape", "t", "transpose", "permute",
    "expand", "squeeze", "unsqueeze", "slice", "select", "_to_copy",
    "clone", "detach", "alias",
})

#: aten products
DOT_OPS = frozenset({"mm", "bmm", "addmm", "baddbmm"})

#: the function-level products, recorded before decomposition
_COMPOSITE_DOTS = frozenset({"matmul", "__matmul__", "__rmatmul__",
                             "linear", "einsum", "mm", "bmm", "addmm",
                             "baddbmm"})

_FLOATS = (torch.float16, torch.bfloat16, torch.float32, torch.float64)

_NOFLAG = (False, False)         # (param_derived, int8_param_derived)


@dataclasses.dataclass(frozen=True)
class DotSite:
  """One product: where it ran and what fed it."""
  name_stack: str
  shapes: tuple                  # ((lhs...), (rhs...))
  param_operands: tuple          # (lhs_from_param, rhs_from_param)
  op: str = ""

  def dispatch_scope(self) -> Optional[tuple]:
    """(regime, call_id) of the first dispatch scope, or None."""
    return _first_scope(self.name_stack)


@dataclasses.dataclass(frozen=True)
class ConvertSite:
  """An int8-parameter-derived value turned into a floating dtype."""
  name_stack: str
  shape: tuple
  dst_dtype: str
  op: str = "_to_copy"
  oracle: bool = False           # ref.int8_gemm's exact f64 product


@dataclasses.dataclass(frozen=True)
class HostSite:
  """A host round trip: a scalar read or a copy across devices."""
  name_stack: str
  op: str


@dataclasses.dataclass(frozen=True)
class ScopeSite:
  """One dispatch scope that closed, and the launches made inside."""
  name: str                      # "dispatch:{regime}:c{id}"
  launches: tuple                # ((kernel, count), ...) nonzero only

  @property
  def regime(self) -> str:
    return self.name.split(":")[1]


@dataclasses.dataclass
class WalkResult:
  dots: list = dataclasses.field(default_factory=list)
  int8_converts: list = dataclasses.field(default_factory=list)
  host_ops: list = dataclasses.field(default_factory=list)
  scopes: list = dataclasses.field(default_factory=list)
  n_ops: int = 0
  #: per op, for `liveness`, when the walk is asked to keep it: (op
  #: name, storage ids it read, storage ids it returned, {storage id:
  #: bytes} of the storages it allocated)
  trace: list = dataclasses.field(default_factory=list)
  #: {storage id: bytes} of the storages first seen as an op's input
  #: (parameters, state, inputs: resident before the program ran)
  resident: dict = dataclasses.field(default_factory=dict)


def _first_scope(stack: str) -> Optional[tuple]:
  head = stack.split("/", 1)[0]
  if not head.startswith("dispatch:"):
    return None
  _, regime, cid = head.split(":")
  return regime, int(cid[1:])


def _tensors(args) -> list:
  out = []
  for a in args:
    if isinstance(a, torch.Tensor):
      out.append(a)
    elif isinstance(a, (list, tuple)):
      out.extend(t for t in a if isinstance(t, torch.Tensor))
  return out


def _in_oracle() -> bool:
  """Whether `ref.int8_gemm` is on the Python stack (the w8a8 oracle's
  float64 accumulation)."""
  code = ref.int8_gemm.__code__
  f = sys._getframe(1)
  while f is not None:
    if f.f_code is code:
      return True
    f = f.f_back
  return False


class _Products(TorchFunctionMode):
  """The function-level half: records the composite products."""

  def __init__(self, walk: "OpWalk"):
    super().__init__()
    self.walk = walk

  def __torch_function__(self, func, types, args=(), kwargs=None):
    kwargs = kwargs or {}
    name = getattr(func, "__name__", "")
    walk = self.walk
    if name not in _COMPOSITE_DOTS or walk.in_product:
      return func(*args, **kwargs)
    ts = _tensors(args)[:2] if name != "addmm" and name != "baddbmm" \
        else _tensors(args)[1:3]
    shapes = tuple(tuple(t.shape) for t in ts)
    if name == "linear" and len(shapes) == 2:
      shapes = (shapes[0], tuple(reversed(shapes[1])))   # as x @ w.T
    walk.result.dots.append(DotSite(
        name_stack=walk.scope_stack(), shapes=shapes,
        param_operands=tuple(walk.flag(t)[0] for t in ts), op=name))
    walk.in_product += 1
    try:
      return func(*args, **kwargs)
    finally:
      walk.in_product -= 1


class OpWalk(TorchDispatchMode):
  """Record every aten op run inside the context (see the module
  docstring). `seeds`: the tensors provenance starts from (a model's
  parameters and buffers, a quantized tree's fields); int8 ones are
  int8-derived. `keep_trace` keeps, for `liveness.estimate`, which
  storages each op read, returned and allocated."""

  def __init__(self, seeds: Iterable[torch.Tensor] = (), *,
               keep_trace: bool = False):
    super().__init__()
    self.prov = WeakIdKeyDictionary()
    for t in seeds:
      self.prov[t] = (True, t.dtype == torch.int8)
    self.result = WalkResult()
    self.keep_trace = keep_trace
    self.in_product = 0
    self._open: list = []          # (scope name, launches at entry)
    self._storages: dict = {}      # data_ptr -> (storage id, weakref)
    self._next_sid = 0
    self._products = _Products(self)
    self._listen = None

  # -- the scope listener -------------------------------------------------
  def scope_opened(self, name: str) -> None:
    self._open.append((name, dict(ops.LAUNCHES)))

  def scope_stack(self) -> str:
    return "/".join(name for name, _ in self._open)

  def scope_closed(self, name: str) -> None:
    opened, before = self._open.pop()
    assert opened == name, (opened, name)
    delta = tuple((k, v - before.get(k, 0)) for k, v in ops.LAUNCHES.items()
                  if v != before.get(k, 0))
    self.result.scopes.append(ScopeSite(name, delta))

  # -- the context --------------------------------------------------------
  def __enter__(self):
    self._listen = dispatch.listen_scopes(self)
    self.log = self._listen.__enter__()
    self._products.__enter__()
    return super().__enter__()

  def __exit__(self, *exc):
    try:
      super().__exit__(*exc)
    finally:
      self._products.__exit__(*exc)
      self._listen.__exit__(*exc)

  # -- provenance ---------------------------------------------------------
  def flag(self, t) -> tuple:
    if not isinstance(t, torch.Tensor):
      return _NOFLAG
    return self.prov.get(t, _NOFLAG)

  def __torch_dispatch__(self, func, types, args=(), kwargs=None):
    kwargs = kwargs or {}
    out = func(*args, **kwargs)
    res = self.result
    res.n_ops += 1
    name = func.overloadpacket.__name__
    stack = self.scope_stack()
    first = args[0] if args else None
    if name in DOT_OPS and not self.in_product:
      ts = _tensors(args)
      ts = ts[1:3] if name in ("addmm", "baddbmm") else ts[:2]
      res.dots.append(DotSite(
          name_stack=stack, shapes=tuple(tuple(t.shape) for t in ts),
          param_operands=tuple(self.flag(t)[0] for t in ts), op=name))
    if name == "_local_scalar_dense":
      res.host_ops.append(HostSite(stack, name))
    elif name in ("_to_copy", "copy_"):
      src = args[1] if name == "copy_" else first
      dst = out if name == "_to_copy" else first
      if isinstance(src, torch.Tensor) and isinstance(dst, torch.Tensor) \
          and src.device != dst.device:
        res.host_ops.append(HostSite(stack, f"{name}:{src.device.type}->"
                                     f"{dst.device.type}"))
    outs = _tensors(out if isinstance(out, (tuple, list)) else (out,))
    # int8 provenance into a float result: a dequantize
    int8_in = [t for t in _tensors(args) if self.flag(t)[1]]
    if int8_in and outs and outs[0].dtype in _FLOATS:
      src = int8_in[0]
      oracle = outs[0].dtype == torch.float64 and _in_oracle()
      res.int8_converts.append(ConvertSite(
          name_stack=stack, shape=tuple(src.shape),
          dst_dtype=str(outs[0].dtype).replace("torch.", ""), op=name,
          oracle=oracle))
      if name in TRANSPARENT and len(outs) == 1:
        self.prov[outs[0]] = (True, False)     # dequantized
    elif name in TRANSPARENT and len(outs) == 1 and \
        isinstance(first, torch.Tensor):
      fl = self.flag(first)
      if fl != _NOFLAG:
        self.prov[outs[0]] = fl
    if self.keep_trace:
      self._trace(name, _tensors(args), outs)
    return out

  def storage_id(self, t: torch.Tensor) -> tuple:
    """(id, bytes, first seen) of `t`'s storage, through a weak
    reference: an address the allocator handed out again after the old
    storage died is a new storage. (None, 0, False) for no storage."""
    from torch.multiprocessing.reductions import StorageWeakRef
    st = t.untyped_storage()
    ptr = st.data_ptr()
    if ptr == 0 or t.device.type == "meta":
      return None, 0, False
    ent = self._storages.get(ptr)
    if ent is not None and not ent[1].expired():
      return ent[0], st.nbytes(), False
    sid = self._next_sid
    self._next_sid += 1
    self._storages[ptr] = (sid, StorageWeakRef(st))
    return sid, st.nbytes(), True

  def _trace(self, name: str, ins: list, outs: list) -> None:
    res = self.result
    read = []
    for t in ins:
      sid, nbytes, new = self.storage_id(t)
      if sid is not None:
        read.append(sid)
        if new:
          res.resident[sid] = nbytes
    wrote, alloc = [], {}
    for t in outs:
      sid, nbytes, new = self.storage_id(t)
      if sid is not None:
        wrote.append(sid)
        if new:
          alloc[sid] = nbytes
    res.trace.append((name, tuple(read), tuple(wrote), alloc))


def param_seeds(*trees) -> list:
  """Every tensor of `trees` (modules' parameters and buffers, dicts,
  lists, GEMM leaves): the seeds of an `OpWalk`."""
  out = []

  def visit(x):
    if isinstance(x, torch.Tensor):
      out.append(x)
    elif isinstance(x, torch.nn.Module):
      out.extend(x.parameters())
      out.extend(x.buffers())
    elif isinstance(x, dict):
      for v in x.values():
        visit(v)
    elif isinstance(x, (list, tuple)):
      for v in x:
        visit(v)
  for t in trees:
    visit(t)
  return out
