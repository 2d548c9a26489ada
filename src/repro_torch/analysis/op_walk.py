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

With `keep_trace=True` the walk also keeps an `OpRecord` per op, for
`liveness` and `dist.hlo_cost`: the storages it read, returned,
allocated and wrote in place, its operands' and results' shapes, dtypes
and bytes, and a collective's group size. A kernel-regime scope is one
record (its operands and result, `scope_io`), and the ops run inside it
are not recorded: the CPU runs the plain version there, the card
nothing the walk can see. A DTensor op is handed back to DTensor
(`NotImplemented`, as `CommDebugMode` does), so the walk records what
it desugars into: each rank's local ops on its local blocks and the
collectives it issues; the ops DTensor's sharding propagation runs on
global shapes to infer its outputs are not recorded. Storages are told
apart by their `StorageImpl` (`_cdata`), which a fake tensor has too
(its `data_ptr()` is 0).

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

from repro_torch.dist import hlo_cost
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


@dataclasses.dataclass(frozen=True)
class OpRecord:
  """One op of a walk kept with `keep_trace=True`."""
  op: str                        # aten name, or the scope's / kernel's
  ns: str                        # "aten", "prim", "_c10d_functional",
                                 # "c10d", "scope" (a kernel scope),
                                 # "launch" (a kernel outside its scope)
  read: tuple                    # storage ids of the tensor operands
  wrote: tuple                   # storage ids of the results
  alloc: dict                    # {storage id: bytes} first returned here
  mutated: tuple = ()            # storage ids written in place
  ins: tuple = ()                # ((shape, dtype name), ...) operands
  outs: tuple = ()               # ((shape, dtype name), ...) results
  in_bytes: int = 0
  out_bytes: int = 0
  group: Optional[int] = None    # a collective's group size
  fields: tuple = ()             # a kernel scope's ((operand, shape), ...)
  free: bool = False             # returns no tensor: a metadata read


@dataclasses.dataclass
class WalkResult:
  dots: list = dataclasses.field(default_factory=list)
  int8_converts: list = dataclasses.field(default_factory=list)
  host_ops: list = dataclasses.field(default_factory=list)
  scopes: list = dataclasses.field(default_factory=list)
  n_ops: int = 0
  #: an `OpRecord` per op, for `liveness` and `dist.hlo_cost`, when the
  #: walk is asked to keep it
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
  int8-derived. `keep_trace` keeps an `OpRecord` per op, for
  `liveness.estimate` and `dist.hlo_cost.analyze_walk`."""

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
    self._kernel_depth = 0         # open kernel-regime scopes
    self._storages: dict = {}      # _cdata -> (storage id, weakref)
    self._next_sid = 0
    self._products = _Products(self)
    self._listen = None
    self._dtensor = None
    self._saw_dtensor = False
    self._launches0: dict = {}
    self._group_sizes: dict = {}   # collective group name -> size

  # -- the scope listener -------------------------------------------------
  def scope_opened(self, name: str) -> None:
    self._open.append((name, dict(ops.LAUNCHES)))
    if name.split(":")[1] in hlo_cost.KERNEL_REGIMES:
      self._kernel_depth += 1

  def scope_stack(self) -> str:
    return "/".join(name for name, _ in self._open)

  def scope_closed(self, name: str) -> None:
    opened, before = self._open.pop()
    assert opened == name, (opened, name)
    delta = tuple((k, v - before.get(k, 0)) for k, v in ops.LAUNCHES.items()
                  if v != before.get(k, 0))
    self.result.scopes.append(ScopeSite(name, delta))
    if name.split(":")[1] in hlo_cost.KERNEL_REGIMES:
      self._kernel_depth -= 1

  def scope_io(self, name: str, args: tuple, out) -> None:
    """A routed call's operands and result (`dispatch._in_scope`): a
    kernel-regime scope becomes one `OpRecord` of the trace."""
    regime = name.split(":")[1]
    if not self.keep_trace or regime not in hlo_cost.KERNEL_REGIMES:
      return
    fields = _scope_fields(regime, args)
    outs = [out] if isinstance(out, torch.Tensor) else _tensors(out)
    self._trace(name, "scope", [t for _, t in fields], outs,
                fields=tuple((f, tuple(t.shape)) for f, t in fields))

  # -- the context --------------------------------------------------------
  def __enter__(self):
    from torch.distributed.tensor import DTensor
    self._dtensor = DTensor
    self._launches0 = dict(ops.LAUNCHES)
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
      if self.keep_trace:
        self._unscoped_launches()

  def _unscoped_launches(self) -> None:
    """Kernel launches made outside every kernel scope: no op stands for
    them, so the trace names them."""
    scoped: dict = {}
    for sc in self.result.scopes:
      if sc.regime in hlo_cost.KERNEL_REGIMES:
        for k, n in sc.launches:
          scoped[k] = scoped.get(k, 0) + n
    for k, v in ops.LAUNCHES.items():
      extra = v - self._launches0.get(k, 0) - scoped.get(k, 0)
      for _ in range(max(extra, 0)):
        self.result.trace.append(OpRecord(k, "launch", (), (), {}))

  # -- provenance ---------------------------------------------------------
  def flag(self, t) -> tuple:
    if not isinstance(t, torch.Tensor):
      return _NOFLAG
    return self.prov.get(t, _NOFLAG)

  def __torch_dispatch__(self, func, types, args=(), kwargs=None):
    kwargs = kwargs or {}
    if any(issubclass(t, self._dtensor) for t in types):
      # let DTensor desugar the op: its local ops and collectives come
      # back through this mode
      self._saw_dtensor = True
      return NotImplemented
    out = func(*args, **kwargs)
    if not isinstance(func, torch._ops.OpOverload):
      return out      # a higher-order op: its body's ops came through here
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
    if self.keep_trace and not self._kernel_depth and \
        not (self._saw_dtensor and _in_propagation()):
      self._trace(name, func.namespace,
                  _tensors(args) + _tensors(kwargs.values()), outs,
                  mutated=_mutated(func, args, kwargs),
                  group=_group_size(args, self._group_sizes)
                  if func.namespace in ("_c10d_functional", "c10d")
                  else None,
                  free=not outs and name not in _READS)
    return out

  def storage_id(self, t: torch.Tensor) -> tuple:
    """(id, bytes, first seen) of `t`'s storage (a DTensor's local
    block's), through a weak reference: a `StorageImpl` address handed
    out again after the old storage died is a new storage. (None, 0,
    False) for a tensor without storage (`meta`)."""
    from torch.multiprocessing.reductions import StorageWeakRef
    t = getattr(t, "_local_tensor", t)
    if t.device.type == "meta":
      return None, 0, False
    st = t.untyped_storage()
    key = st._cdata
    ent = self._storages.get(key)
    if ent is not None and not ent[1].expired():
      return ent[0], st.nbytes(), False
    sid = self._next_sid
    self._next_sid += 1
    self._storages[key] = (sid, StorageWeakRef(st))
    return sid, st.nbytes(), True

  def _trace(self, name: str, ns: str, ins: list, outs: list, *,
             mutated: tuple = (), group=None, fields: tuple = (),
             free: bool = False) -> None:
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
    res.trace.append(OpRecord(
        name, ns, tuple(read), tuple(wrote), alloc,
        mutated=tuple(s for s in (self.storage_id(t)[0] for t in mutated)
                      if s is not None),
        ins=_metas(ins), outs=_metas(outs), in_bytes=_nbytes(ins),
        out_bytes=_nbytes(outs), group=group, fields=fields, free=free))


#: ops that return no tensor but read one
_READS = frozenset({"_local_scalar_dense", "equal", "is_nonzero",
                    "allclose"})


def _metas(ts: list) -> tuple:
  return tuple((tuple(t.shape), hlo_cost.dtype_name(t.dtype)) for t in ts)


def _nbytes(ts: list) -> int:
  return sum(hlo_cost.array_bytes(tuple(t.shape), t.dtype) or 0
             for t in ts)


def _mutated(func, args, kwargs) -> tuple:
  """The tensor arguments `func` writes in place (its schema's `(a!)`)."""
  schema = func._schema
  if not schema.is_mutable:
    return ()
  out = []
  for i, arg in enumerate(schema.arguments):
    info = arg.alias_info
    if info is None or not info.is_write:
      continue
    a = args[i] if i < len(args) else kwargs.get(arg.name)
    out.extend(_tensors([a]))
  return tuple(out)


def _group_size(args, sizes: dict) -> Optional[int]:
  """A collective's group size: `_c10d_functional` names its group (its
  size kept in `sizes`, the walk's), a `c10d` op passes the
  ProcessGroup."""
  import torch.distributed as dist
  for a in args:
    if isinstance(a, str):
      if a not in sizes:
        try:
          sizes[a] = dist.distributed_c10d._resolve_process_group(a).size()
        except (KeyError, RuntimeError, ValueError):
          continue
      return sizes[a]
    size = getattr(a, "size", None)
    if size is not None and not isinstance(a, torch.Tensor) and \
        callable(size):
      try:
        return int(size())
      except (TypeError, RuntimeError):
        continue
  return None


def _propagation_code():
  from torch.distributed.tensor._sharding_prop import ShardingPropagator
  return ShardingPropagator._propagate_tensor_meta_non_cached.__code__


def _in_propagation() -> bool:
  """Whether DTensor's sharding propagation is on the Python stack (the
  op runs on global shapes to infer an output's metadata)."""
  code = _propagation_code()
  f = sys._getframe(1)
  while f is not None:
    if f.f_code is code:
      return True
    f = f.f_back
  return False


def _scope_fields(regime: str, args: tuple) -> list:
  """(operand name, tensor) of a kernel scope's routed call: the gemm
  route's `(regime, leaf, x, policy)`, `_gru_cell`'s `(xw, h, rec,
  bias)`, flash's `(q, k, v)`."""
  if regime == "flash_attention":
    return list(zip("qkv", args[:3]))
  if regime == "gru_cell":
    xw, h, rec, bias = args[:4]
    return [("xw", xw), ("h", h), ("w", rec.w), ("bias", bias)]
  leaf, x = args[1], args[2]
  from repro_torch.dist.sharding import _leaf_fields
  fields = _leaf_fields(leaf)
  if not fields:
    return [("x", x), ("w", leaf)]
  return [("x", x)] + [(f, getattr(leaf, f)) for f in fields]


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
