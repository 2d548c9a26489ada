"""Named sharding rules over the FactoredLinear logical namespace, laid
out on DTensor.

Counterpart of `repro.dist.sharding`. Sharding is declared once, here, by
logical name — the `"*/rec"` / `"*/nonrec"` / `"layers/attn_q"`
namespace `FactorizationPlan` matches on — and consumed everywhere: the
trainer and the serving engine get their constraint callable from
`make_constraint(mesh, cfg, batch, decode=...)`, and their layouts from
`param_shardings` / `state_shardings` / `batch_shardings`.

Two namespaces, with the reference's tables copied verbatim:

* **Parameter rules** match a GEMM leaf's logical `name` with glob
  patterns (PARAM_RULES). Unfactored weights get the Megatron split:
  up-projections column-parallel (None, "model"), down/out projections
  row-parallel ("model", None), expert stacks expert-parallel on their E
  axis. Factored nodes shard U on m and V on n, so the rank axis stays
  local: the only collective in (x@U)@V is one all-reduce of the skinny
  (b, r) term, and stage-2 truncation (a change of r) never reshards.

* **Activation rules** (ACTIVATION_RULES) match the logical names models
  pass to `cs(x, name)`: "bsd", "bsv", "bsf", "bt3h", ... "data" expands
  to the mesh's (pod, data) axes.

Every rule is divisibility-gated against the concrete shape: an axis
whose mesh degree does not divide the dimension is dropped (to None), so
decode batches of 1 and small smoke dims degrade to replication.

A spec is a `P`, a per-dimension tuple that mirrors jax's
`PartitionSpec` (and prints as one); `placements(spec, mesh)` turns it
into DTensor placements: a tensor dim over ("pod", "data") becomes
`Shard(d)` on both mesh dims. Parameter trees are the port's `nn.Module`s:
a `FactoredLinear` is matched by logical name, a `QuantizedLinear` by
field, every other leaf by its path tokens, which are the reference's
`_path_tokens` for the same bridged tree (the `state_dict()` key with
"/" for "."). `RuleMesh` answers "how would this tree shard" with no
process group at all.
"""
from __future__ import annotations

import copy
import dataclasses
import fnmatch
import math
from typing import Any, Iterator, Optional, Sequence

import torch
from torch import nn

from repro_torch.core.factored import FactoredLinear, is_gemm_leaf
from repro_torch.dist.mesh import MODEL_AXIS, axis_names, axis_sizes, dp_axes
# The contract types live in the module model code already imports;
# re-exported here so dist.sharding stays the one public constraint surface.
from repro_torch.layers.common import Constraint, identity_constraint
from repro_torch.quant.leaf import QuantizedLinear

__all__ = ["Constraint", "identity_constraint", "make_constraint",
           "param_shardings", "state_shardings", "batch_shardings",
           "replicated", "_path_tokens", "ACTIVATION_RULES", "PARAM_RULES",
           "RuleMesh", "rule_coverage", "P", "NamedSharding", "placements",
           "distribute_params", "distribute_tree", "gather_tree"]


# ---------------------------------------------------------------------------
# Rule tables. "data" expands to the mesh's dp axes, "model" to MODEL_AXIS.
# ---------------------------------------------------------------------------

# activation logical name -> per-dimension axis roles
ACTIVATION_RULES: dict[str, tuple] = {
    "bsd": ("data", None, None),             # residual stream (b, s, d)
    "bsv": ("data", None, "model"),          # logits (b, s, vocab)
    "bsf": ("data", None, "model"),          # FFN hidden (b, s, d_ff)
    "bsi": ("data", None, "model"),          # mamba inner (b, s, d_inner)
    "bt3h": ("data", None, "model"),         # GRU gates (b, t, 3h)
    "bshd_q": ("data", None, "model", None),   # q heads
    "bshd_kv": ("data", None, "model", None),  # kv heads (GQA: may gate off)
    "gecd": ("data", "model", None, None),   # MoE dispatch buffer (G,E,C,D)
    "gecf": ("data", "model", None, None),   # MoE expert hidden (G,E,C,F)
}

# parameter logical-name globs -> rule kind, first match wins
PARAM_RULES: tuple[tuple[str, str], ...] = (
    ("*/expert_*", "expert"),    # stacked (E, m, n) expert weights -> EP
    ("*/attn_o", "row"),
    ("*/xattn_o", "row"),
    ("*/mla_o", "row"),
    ("*/ffn_down", "row"),
    ("*/ffn_out", "row"),
    ("*/mlstm_down", "row"),
    ("*/slstm_out", "row"),
    ("*/ssm_out", "row"),
    ("out", "row"),              # DS2 CTC output head (fc_dim, vocab) stays
                                 # row-split: vocab ~ 32 never divides TP
    ("*", "col"),                # q/k/v, gates, ups, rec/nonrec, lm_head, ...
)

#: QuantizedLinear array fields, in dataclass order
_QUANT_FIELDS = ("w_q", "w_scale", "u_q", "u_scale", "v_q", "v_scale",
                 "act_scale")


class P(tuple):
  """A per-dimension sharding spec: each entry None, one mesh axis name,
  or a tuple of them (outermost first). Prints as jax's PartitionSpec."""

  def __new__(cls, *entries):
    return super().__new__(cls, entries)

  def __repr__(self) -> str:
    return "PartitionSpec" + tuple.__repr__(self)

  __str__ = __repr__


def placements(spec: Sequence, mesh) -> list:
  """DTensor placements of `spec` on `mesh`: `Shard(d)` on every mesh dim
  whose axis shards tensor dim d, `Replicate()` elsewhere. DTensor splits
  a dim shared by several mesh dims in mesh-dim order, outermost first,
  as a PartitionSpec's axis tuple does."""
  from torch.distributed.tensor import Replicate, Shard
  names = axis_names(mesh)
  out = [Replicate() for _ in names]
  for d, entry in enumerate(spec):
    if entry is None:
      continue
    for a in (entry if isinstance(entry, tuple) else (entry,)):
      out[names.index(a)] = Shard(d)
  return out


@dataclasses.dataclass(frozen=True)
class NamedSharding:
  """A spec on a mesh: the port's counterpart of jax's NamedSharding."""
  mesh: Any
  spec: P

  @property
  def placements(self) -> list:
    return placements(self.spec, self.mesh)


def _expand(role, mesh) -> tuple[str, ...]:
  """Axis role -> concrete mesh axes (only those present on the mesh)."""
  if role is None:
    return ()
  if role == "data":
    return dp_axes(mesh)
  if role == "model":
    return (MODEL_AXIS,) if MODEL_AXIS in axis_names(mesh) else ()
  return (role,) if role in axis_names(mesh) else ()


def _gate(template: Sequence, shape: Sequence[int], mesh) -> Optional[P]:
  """Divisibility-gate a role template against a concrete shape.

  Returns None when the template rank does not match the array rank
  (caller replicates / passes through)."""
  if len(template) != len(shape):
    return None
  sizes = axis_sizes(mesh)
  spec = []
  for role, dim in zip(template, shape):
    axes = _expand(role, mesh)
    size = math.prod(sizes[a] for a in axes) if axes else 1
    if axes and size > 1 and dim % size == 0:
      spec.append(axes if len(axes) > 1 else axes[0])
    else:
      spec.append(None)
  return P(*spec)


# ---------------------------------------------------------------------------
# Parameter rules.
# ---------------------------------------------------------------------------

def _param_rule(name: str) -> str:
  for pat, kind in PARAM_RULES:
    if fnmatch.fnmatch(name, pat):
      return kind
  return "col"


def _weight_template(kind: str, ndim: int, field: str) -> tuple:
  """Role template for one FactoredLinear field (w | u | v).

  Unfactored w follows the Megatron split of its rule. Factored u/v use
  the uniform rank-local layout: u (m, r) chops m, v (r, n) chops n —
  both leave r unsharded."""
  lead = (None,) * max(ndim - 2, 0)
  if kind == "expert":
    # (..., E, m, n): expert-parallel over the E axis, factors alike
    if ndim < 3:
      return _weight_template("col", ndim, field)
    return (None,) * (ndim - 3) + ("model", None, None)
  if field == "u":
    return lead + ("model", None)
  if field == "v":
    return lead + (None, "model")
  if kind == "row":
    return lead + ("model", None)
  return lead + (None, "model")                    # "col"


def _quant_field_template(kind: str, field: str, ndim: int) -> tuple:
  """Role template for one QuantizedLinear field.

  int8 payloads (w_q/u_q/v_q) shard exactly like the float field they
  were quantized from. Per-column scale vectors ride with their weight's
  column axis, so the dequantize stays device-local; a stacked ([L,] n)
  scale keeps its leading layer axes unsharded like the payload's.
  u_scale is per-rank and the rank axis is always local; act_scale is a
  scalar."""
  if field.endswith("_q"):
    return _weight_template(kind, ndim, field[0])
  if field in ("w_scale", "v_scale"):
    return ((None,) * (ndim - 1)
            + (_weight_template(kind, 2, field[0])[-1],))
  return (None,) * ndim            # u_scale (rank-local), act_scale ()


def _with_fsdp(spec: P, shape: Sequence[int], mesh) -> P:
  """Add the dp axes to the first unsharded dimension they divide (for
  stacked per-layer weights, the leading layer axis: the ZeRO/FSDP
  layout)."""
  axes = dp_axes(mesh)
  sizes = axis_sizes(mesh)
  size = math.prod(sizes[a] for a in axes) if axes else 1
  if size <= 1:
    return spec
  entries = list(spec) + [None] * (len(shape) - len(spec))
  for i, (e, dim) in enumerate(zip(entries, shape)):
    if e is None and dim % size == 0 and dim > 1:
      entries[i] = axes if len(axes) > 1 else axes[0]
      return P(*entries)
  return spec


def _leaf_spec(shape: Sequence[int], mesh, *, name: Optional[str] = None,
               field: str = "w", path: Sequence[str] = (),
               fsdp: bool = False, expert_2d: bool = False) -> P:
  """Spec for one array leaf — a FactoredLinear field (by logical name)
  or a raw array (by tree path)."""
  ndim = len(shape)
  if name is not None:
    kind = _param_rule(name)
    spec = _gate(_weight_template(kind, ndim, field), shape, mesh) or P()
    if expert_2d and kind == "expert" and ndim >= 3:
      spec = _with_fsdp(spec, shape, mesh)         # 2D EP for serving
  elif path and path[-1] == "table" and ndim == 2:
    # embedding table (vocab, d): vocab-sharded; gathers are tiny
    spec = _gate(("model", None), shape, mesh) or P()
  else:
    spec = P()            # router / norm scales / biases / step counters
  if fsdp:
    spec = _with_fsdp(spec, shape, mesh)
  return spec


def _quant_spec(leaf: QuantizedLinear, field: str, shape, mesh) -> P:
  return _gate(_quant_field_template(_param_rule(leaf.name), field,
                                     len(shape)), shape, mesh) or P()


def _path_tokens(key: str) -> list[str]:
  """A `state_dict()` key (or a "/"-joined path) -> the reference's path
  tokens ("moe_layers", "attn", "wq", "u", ...)."""
  return key.replace(".", "/").split("/") if key else []


def _leaves(params: nn.Module) -> Iterator[tuple]:
  """(path tokens, owning GEMM leaf or None, field, tensor) for every
  array of a model, in `state_dict()` order: the arrays of a GEMM leaf
  carry its node path and their field name."""
  mods = dict(params.named_modules())
  for key, t in params.state_dict(keep_vars=True).items():
    toks = _path_tokens(key)
    owner = mods.get(".".join(toks[:-1]))
    if owner is not None and is_gemm_leaf(owner):
      yield toks[:-1], owner, toks[-1], t
    else:
      yield toks, None, toks[-1], t


def _spec_of(toks, owner, field, shape, mesh, fsdp=False,
             expert_2d=False) -> P:
  if isinstance(owner, FactoredLinear):
    return _leaf_spec(shape, mesh, name=owner.name, field=field, fsdp=fsdp,
                      expert_2d=expert_2d)
  if isinstance(owner, QuantizedLinear):
    # serving artifact: no FSDP axis (that is a training layout)
    return _quant_spec(owner, field, shape, mesh)
  return _leaf_spec(shape, mesh, path=toks, fsdp=fsdp, expert_2d=expert_2d)


def param_shardings(params: nn.Module, mesh, *, fsdp: bool = False,
                    expert_2d: bool = False) -> dict:
  """{state_dict key: NamedSharding} for every array of `params` (real
  or `meta` tensors): GEMM leaves by logical name, raw arrays by path."""
  out = {}
  for toks, owner, field, t in _leaves(params):
    spec = _spec_of(toks, owner, field, tuple(t.shape), mesh, fsdp,
                    expert_2d)
    out[".".join(toks + ([field] if owner is not None else []))] = \
        NamedSharding(mesh, spec)
  return out


def _tree_map(fn, tree):
  """fn over the leaves of nested dicts."""
  if isinstance(tree, dict):
    return {k: _tree_map(fn, v) for k, v in tree.items()}
  return fn(tree)


def batch_shardings(batch: Any, mesh, shape) -> Any:
  """Inputs shard their leading (global batch) dimension over the dp
  axes; `shape` is a `ShapeConfig` (its `global_batch` is read)."""
  def f(leaf):
    if leaf.ndim and leaf.shape[0] == shape.global_batch:
      spec = _gate(("data",) + (None,) * (leaf.ndim - 1),
                   tuple(leaf.shape), mesh)
      return NamedSharding(mesh, spec or P())
    return NamedSharding(mesh, P())
  return _tree_map(f, batch)


def state_shardings(state: Any, mesh, shape) -> Any:
  """Decode-state rules: batch dim -> dp axes, max_len dim -> model axis.

  Length-sharding the KV cache is what keeps 500k-token contexts on
  chip: each model shard owns 1/TP of the sequence axis."""
  def f(leaf):
    roles: list = [None] * leaf.ndim
    # the length axis sits after the batch axis in every cache layout, so
    # match it last-first: a batch dim equal to max_len must not steal
    # the model-axis role
    len_dim = None
    for i in range(leaf.ndim - 1, -1, -1):
      if leaf.shape[i] == shape.seq_len and leaf.shape[i] > 1:
        len_dim = i
        roles[i] = "model"
        break
    for i, dim in enumerate(leaf.shape):
      if i != len_dim and dim == shape.global_batch and dim > 1:
        roles[i] = "data"
        break
    return NamedSharding(mesh, _gate(tuple(roles), tuple(leaf.shape), mesh)
                         or P())
  return _tree_map(f, state)


def replicated(mesh) -> NamedSharding:
  return NamedSharding(mesh, P())


# ---------------------------------------------------------------------------
# Laying tensors out, and gathering them back.
# ---------------------------------------------------------------------------

def is_dtensor(x) -> bool:
  from torch.distributed.tensor import DTensor
  return isinstance(x, DTensor)


def rows_placements(mesh, rows: int) -> list:
  """Rows of a batch-leading tensor on the data axes (where they divide
  them), whole on the model axis: the layout of per-row work."""
  return placements(_gate(("data",), (rows,), mesh), mesh)


def rows_local(fn, *args, n_out: int = 1, whole: Sequence = (), **kwargs):
  """`fn(*args, *whole, **kwargs)` on each rank's rows of the
  batch-leading `args`, whole on the model axis; `whole` (tensors or
  GEMM leaves: weights) whole on every rank, a weight's gradient partial
  over the axes that split the rows. fn's results (`n_out` of them) are
  laid out as the rows. For per-row work that no DTensor op rule covers:
  the CTC recursion, the DS2 convolutions, the xLSTM loops."""
  return split_call(fn, *[(a, "b") for a in args],
                    *[(w, "") for w in whole],
                    out="b" if n_out == 1 else ("b",) * n_out, **kwargs)


def heads_local(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                *rows: torch.Tensor, **kwargs) -> torch.Tensor:
  """Attention `fn(q, k, v, *rows, **kwargs)` on each rank's rows and
  heads: q (b, s, h, hd), k and v (b, t, kv, hd) with the batch on the
  data axes and the heads on the model axis where the model degree
  divides both h and kv (so every local q head finds its GQA kv head
  locally); `rows` (per-row tensors: positions) on the rows alone. The
  output carries q's layout."""
  return split_call(fn, (q, "bsh"), (k, "bsh"), (v, "bsh"),
                    *[(r, "b") for r in rows], out="bsh", **kwargs)


def contiguous_stride(shape) -> tuple:
  """The strides of a contiguous tensor of `shape`."""
  stride, acc = [], 1
  for d in reversed(tuple(shape)):
    stride.append(acc)
    acc *= d
  return tuple(reversed(stride))


def local_offsets(x: torch.Tensor) -> tuple:
  """(global offset per dim) of this rank's local block of a DTensor
  whose sharded dims its mesh degrees divide (what `_gate` guarantees);
  nested splits of one dim go outermost first."""
  mesh = x.device_mesh
  coord = mesh.get_coordinate()
  size, off = list(x.shape), [0] * x.ndim
  for i, p in enumerate(x.placements):
    if p.is_shard():
      d = p.dim % x.ndim
      size[d] //= mesh.size(i)
      off[d] += coord[i] * size[d]
  return tuple(off)


def distribute_tensor_local(x: torch.Tensor, mesh, pl) -> torch.Tensor:
  """A full tensor, which every rank holds whole, as a DTensor of
  placements `pl`: each rank keeps its own slice, no communication. A
  replicated one keeps `x` itself as its local tensor, strides and all
  (a transposed factor stays transposed, so a mesh of one runs the very
  GEMMs one device runs)."""
  from torch.distributed.tensor import DTensor, distribute_tensor
  if all(p.is_replicate() for p in pl):
    x = x.detach()
    if x.device.type != mesh.device_type:
      x = x.to(mesh.device_type)
    return DTensor.from_local(x, mesh, pl, run_check=False)
  return distribute_tensor(x.detach(), mesh, pl, src_data_rank=None)


def lay_out(x: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
  """`x` as a DTensor laid out by `sharding`: a DTensor is redistributed;
  a full tensor, which every rank holds whole, keeps each rank's own
  slice (no communication)."""
  pl = sharding.placements
  if is_dtensor(x):
    if x.device_mesh == sharding.mesh and list(x.placements) == pl:
      return x
    if x.device_mesh == sharding.mesh:
      return x.redistribute(sharding.mesh, pl)
    x = x.full_tensor()
  return distribute_tensor_local(x, sharding.mesh, pl)


def distribute_params(params: nn.Module, shardings: dict) -> nn.Module:
  """Lay every parameter and buffer of `params` out by `shardings`
  (`param_shardings`' keys), in place; parameters keep `requires_grad`."""
  mods = dict(params.named_modules())
  for key, sh in shardings.items():
    prefix, _, attr = key.rpartition(".")
    mod = mods[prefix]
    t = getattr(mod, attr)
    d = lay_out(t.data if isinstance(t, nn.Parameter) else t, sh)
    if isinstance(t, nn.Parameter):
      mod._parameters[attr] = nn.Parameter(d, requires_grad=t.requires_grad)
    else:
      mod._buffers[attr] = d
  for mod in mods.values():
    if hasattr(mod, "_views"):
      mod._views = None         # a stack's kept layer views are stale now
  return params


def distribute_sharing(params: nn.Module, source: nn.Module,
                       laid: nn.Module, mesh) -> nn.Module:
  """A copy of `params` laid out by `param_shardings`, in which each
  tensor that is one of `source`'s own is `laid`'s tensor of the same
  name instead (`laid` being `source` laid out): a draft made from a
  target keeps sharing with the laid-out target every tensor it shared
  with the target, and only its own tensors are laid out."""
  import itertools

  def named(m):
    return itertools.chain(m.named_parameters(remove_duplicate=False),
                           m.named_buffers(remove_duplicate=False))
  laid_t = dict(named(laid))
  memo = {id(t): laid_t[n] for n, t in named(source) if n in laid_t}
  new = copy.deepcopy(params, memo)
  mods = dict(new.named_modules())
  own = {k: sh for k, sh in param_shardings(new, mesh).items()
         if not is_dtensor(getattr(mods[k.rpartition(".")[0]],
                                   k.rpartition(".")[2]))}
  return distribute_params(new, own)


def distribute_tree(tree: Any, shardings: Any) -> Any:
  """A nested dict of tensors laid out by a matching tree of shardings."""
  if isinstance(tree, dict):
    return {k: distribute_tree(v, shardings[k]) for k, v in tree.items()}
  return lay_out(tree, shardings)


def gather_tree(tree: Any) -> Any:
  """A nested dict of tensors with every DTensor gathered whole."""
  return _tree_map(lambda x: x.full_tensor() if is_dtensor(x) else x, tree)


def _whole_on(x: torch.Tensor, dim: int) -> list:
  """x's placements with tensor dim `dim` whole (not split)."""
  from torch.distributed.tensor import Replicate
  return [Replicate() if p.is_shard() and p.dim % x.ndim == dim else p
          for p in x.placements]


def _local_like(t: torch.Tensor, x: torch.Tensor, pl: list) -> torch.Tensor:
  """This rank's block of `t` laid out `pl` on x's mesh: a DTensor is
  redistributed, a whole tensor sliced (no communication)."""
  mesh = x.device_mesh
  return (t.redistribute(mesh, pl) if is_dtensor(t) else
          distribute_tensor_local(t, mesh, pl)).to_local()


def write_slot(x: torch.Tensor, s: torch.Tensor, ax: int, slot: int) -> None:
  """x.narrow(ax, slot, 1).copy_(s) in place, for a batch-1 `s` (the slot
  surgery of a decode state). On a DTensor `x` each rank writes its own
  block and nothing is gathered: `s` is laid out as `x` with the slot
  axis whole (for a slot state laid out by `state_shardings`, as the
  engine's is, nothing moves), and the rank whose block holds `slot`
  copies its part in."""
  if not is_dtensor(x):
    x.narrow(ax, slot, 1).copy_(s.full_tensor() if is_dtensor(s) else s)
    return
  s = _local_like(s, x, _whole_on(x, ax))
  local = x.to_local()
  i = slot - local_offsets(x)[ax]
  if 0 <= i < local.shape[ax]:
    local.narrow(ax, i, 1).copy_(s)


def slot_of(x: torch.Tensor, ax: int, slot: int) -> torch.Tensor:
  """x.narrow(ax, slot, 1) for a batch axis `ax`. On a DTensor `x` the
  result is a DTensor with `ax` whole and every other axis as x lays it
  out: the rank whose block holds `slot` contributes its rows, the other
  ranks of its data group zeros, and one reduction of the slot's size
  over that group (exact: a value plus zeros) hands them all the slot."""
  if not is_dtensor(x):
    return x.narrow(ax, slot, 1)
  from torch.distributed.tensor import DTensor, Partial
  local = x.to_local()
  i = slot - local_offsets(x)[ax]
  split = [p.is_shard() and p.dim % x.ndim == ax for p in x.placements]
  if not any(split):
    return DTensor.from_local(local.narrow(ax, slot, 1), x.device_mesh,
                              x.placements)
  piece = (local.narrow(ax, i, 1) if 0 <= i < local.shape[ax] else
           local.new_zeros(local.shape[:ax] + (1,) + local.shape[ax + 1:]))
  pl = [Partial() if s else p for s, p in zip(split, x.placements)]
  return DTensor.from_local(piece, x.device_mesh, pl).redistribute(
      x.device_mesh, _whole_on(x, ax))


class LocalCut:
  """This rank's part of rows [0, length) along an axis of a DTensor
  leaf: the rows its own block holds (a KV leaf's length axis lies on
  the model axis), so a prefix snapshot of a sharded state is taken and
  spliced back with nothing moving between ranks. `shape` is the global
  shape of the cut, `nbytes` its global bytes: what the same cut weighs
  on one device, which the prefix cache charges."""

  def __init__(self, local: torch.Tensor, shape: tuple):
    self.local, self.shape = local, tuple(shape)

  @property
  def nbytes(self) -> int:
    return math.prod(self.shape) * self.local.element_size()


def cut_prefix(x: torch.Tensor, ax: int, length: int):
  """A copy of rows [0, length) along `ax`: a tensor, or of a DTensor a
  `LocalCut` of this rank's block."""
  if not is_dtensor(x):
    return x.narrow(ax, 0, length).clone()
  local = x.to_local()
  keep = min(max(length - local_offsets(x)[ax], 0), local.shape[ax])
  shape = list(x.shape)
  shape[ax] = length
  return LocalCut(local.narrow(ax, 0, keep).clone(), shape)


def splice_cut(f: torch.Tensor, s, ax: int) -> None:
  """Write a `cut_prefix` `s` into rows [0, len) along `ax` of `f`, in
  place; a `LocalCut` into this rank's block of a DTensor `f` laid out
  as the cut's source."""
  if isinstance(s, LocalCut):
    n = s.local.shape[ax]
    f.to_local().narrow(ax, 0, n).copy_(s.local)
    return
  f.narrow(ax, 0, s.shape[ax]).copy_(s)


def write_rows(cache: torch.Tensor, new: torch.Tensor,
               pos: torch.Tensor) -> None:
  """cache[i, pos[i, t]] = new[i, t] in place on a DTensor cache (b, S,
  ...) whose rows are on the data axes and positions on the model axis
  (`state_shardings`): each rank writes the rows and positions its local
  block holds; a position at or past S is dropped. No mask selects the
  writes (no data-dependent shape, no host sync): each of the W steps
  writes one row of every batch row, a dropped one its own value back."""
  off = local_offsets(cache)
  local = cache.to_local()
  lb, ls = local.shape[:2]
  # the new rows split as the cache's block, whole along the length
  new = _local_like(new, cache, _whole_on(cache, 1)).to(local.dtype)
  pos = (pos.full_tensor() if is_dtensor(pos) else pos)[off[0]:off[0] + lb]
  rows = pos - off[1]
  keep = (pos < cache.shape[1]) & (rows >= 0) & (rows < ls)
  rows = rows.clamp(0, ls - 1)
  bidx = torch.arange(lb, device=local.device)
  for t in range(pos.shape[1]):
    r = rows[:, t]
    k = keep[:, t].reshape((lb,) + (1,) * (new.ndim - 2))
    local[bidx, r] = torch.where(k, new[:, t], local[bidx, r])


def gather_params(params: nn.Module) -> nn.Module:
  """A copy of `params` with every DTensor parameter and buffer gathered
  whole (each rank holds the full model); the argument is untouched."""
  memo = {}
  for t in list(params.parameters()) + list(params.buffers()):
    if is_dtensor(t):
      full = t.full_tensor().detach().clone()   # strides kept
      memo[id(t)] = (nn.Parameter(full, requires_grad=t.requires_grad)
                     if isinstance(t, nn.Parameter) else full)
  return copy.deepcopy(params, memo)


def lay_out_like(tree: Any, like: Any) -> Any:
  """`tree` (whole tensors) with each tensor laid out as the DTensor at
  the same place in `like` (mappings and NamedTuples walked alike)."""
  if isinstance(like, dict):
    return {k: lay_out_like(tree[k], v) for k, v in like.items()}
  if isinstance(like, tuple) and hasattr(like, "_fields"):
    return type(like)(*(lay_out_like(getattr(tree, f), getattr(like, f))
                        for f in like._fields))
  if is_dtensor(like):
    return distribute_tensor_local(tree, like.device_mesh, like.placements)
  return tree


def mesh_device(mesh) -> torch.device:
  """The device this rank's shards live on."""
  if mesh.device_type == "cuda":
    return torch.device("cuda", torch.cuda.current_device())
  return torch.device(mesh.device_type)


def replicated_plain(enabled: bool = True):
  """A context in which plain tensors meeting DTensors are taken as
  replicated (`implicit_replication`): the tensors a model makes inside
  a sharded step (zeros, aranges, masks) are whole on every rank."""
  import contextlib
  if not enabled:
    return contextlib.nullcontext()
  from torch.distributed.tensor.experimental import implicit_replication
  return implicit_replication()


def check_mesh(mesh) -> None:
  """Raise unless `mesh` is a `DeviceMesh` (`dist.make_mesh`)."""
  from torch.distributed.device_mesh import DeviceMesh
  if not isinstance(mesh, DeviceMesh):
    raise TypeError("mesh= takes a torch DeviceMesh (dist.make_mesh), got "
                    f"{type(mesh).__name__}")


def _grad_placements(pl: list, work_pl: list) -> list:
  """The placements of the gradient of an input laid out `pl` for work
  split as `work_pl`: partial on a mesh dim where the input is whole but
  the work is split (each rank used all of it for its own part)."""
  from torch.distributed.tensor import Partial
  return [Partial() if p.is_replicate() and w.is_shard() else p
          for p, w in zip(pl, work_pl)]


class _DenseGrad(torch.autograd.Function):
  """The identity, whose backward hands on a contiguous gradient.

  `to_local`'s backward wraps the local gradient as a DTensor of the
  forward's global strides (contiguous); a local gradient laid out
  otherwise (an einsum's backward can give (b, hd, s) strides for a
  (b, s, hd) block) then fails the next `view` DTensor decomposes a
  reshape into, as zamba2-7b's smoke attention did on a (1, 4) mesh."""

  @staticmethod
  def forward(ctx, x):
    return x.view_as(x)

  @staticmethod
  def backward(ctx, g):
    return g.contiguous()


def split_heads(y: torch.Tensor, heads: int, head_dim: int) -> torch.Tensor:
  """A projection's output (..., heads * head_dim) as (..., heads,
  head_dim). On a DTensor whose model axis splits the columns, each rank
  must hold whole heads: where the model degree does not divide `heads`
  (2 kv heads on 4 ranks) the columns are first gathered on the model
  axis, as the reference's `_gate` leaves such an activation unsharded
  ("bshd_kv" replicates a kv axis the degree does not divide) and its
  weight's split is resharded by XLA. Where the degree divides `heads`,
  an even split of the columns already gives each rank whole heads."""
  if is_dtensor(y):
    names = axis_names(y.device_mesh)
    if MODEL_AXIS in names:
      md = names.index(MODEL_AXIS)
      p = y.placements[md]
      if p.is_shard() and p.dim % y.ndim == y.ndim - 1 and \
          heads % y.device_mesh.size(md):
        from torch.distributed.tensor import Replicate
        pl = list(y.placements)
        pl[md] = Replicate()
        y = y.redistribute(y.device_mesh, pl)
  return y.reshape(*y.shape[:-1], heads, head_dim)


class _ColumnsWholeGrad(torch.autograd.Function):
  """The identity, whose backward gathers the gradient's last dim on the
  model axis (see `merge_heads`)."""

  @staticmethod
  def forward(ctx, x):
    return x.view_as(x)

  @staticmethod
  def backward(ctx, g):
    from torch.distributed.tensor import Replicate
    md = axis_names(g.device_mesh).index(MODEL_AXIS)
    p = g.placements[md]
    if p.is_shard() and p.dim % g.ndim == g.ndim - 1:
      pl = list(g.placements)
      pl[md] = Replicate()
      g = g.redistribute(g.device_mesh, pl)
    return g


def merge_heads(y: torch.Tensor, heads: int) -> torch.Tensor:
  """(..., heads, head_dim) as (..., heads * head_dim), the inverse of
  `split_heads`. On a DTensor whose model degree does not divide
  `heads` (whisper-small's 12 heads on 16 ranks), the gradient coming
  back through a row-split projection is split on the merged columns,
  which cannot be viewed as heads; it is gathered on the model axis
  first, as `split_heads` gathers the forward's columns."""
  out = y.reshape(*y.shape[:-2], heads * y.shape[-1])
  if is_dtensor(out) and out.requires_grad:
    names = axis_names(out.device_mesh)
    if MODEL_AXIS in names and \
        heads % out.device_mesh.size(names.index(MODEL_AXIS)):
      out = _ColumnsWholeGrad.apply(out)
  return out


def local_call(fn, mesh, inputs: Sequence, outputs, **kwargs):
  """`fn` on this rank's blocks, by placements; with no DTensor among
  the inputs, `fn` on them as they are.

  `inputs` are (tensor, placements) pairs: a DTensor is redistributed to
  `placements` and handed to `fn` as its local block, differentiably
  (its gradient partial where it is whole but the first output is
  split); a plain tensor, whole on every rank, is sliced to the same
  block (a whole one is handed over as it is). `outputs` gives, for each
  of fn's results (one, or a tuple), the placements its local value is
  wrapped in as a DTensor (the global shape follows from them), or None
  to hand it back local."""
  if not any(is_dtensor(t) for t, _ in inputs):
    return fn(*(t for t, _ in inputs), **kwargs)
  from torch.distributed.tensor import DTensor
  pls = (outputs,) if not isinstance(outputs, tuple) else outputs
  work = next(pl for pl in pls if pl is not None)
  local = []
  for t, pl in inputs:
    if not is_dtensor(t):
      local.append(t if all(p.is_replicate() for p in pl) else
                   distribute_tensor_local(t, mesh, pl).to_local())
      continue
    t = t if list(t.placements) == list(pl) else t.redistribute(mesh, pl)
    t = t.to_local(grad_placements=_grad_placements(pl, work))
    local.append(_DenseGrad.apply(t) if t.requires_grad else t)
  out = fn(*local, **kwargs)
  single = not isinstance(out, tuple)
  wrapped = tuple(o if pl is None else DTensor.from_local(o, mesh, pl)
                  for o, pl in zip((out,) if single else out, pls))
  return wrapped[0] if single else wrapped


def _leaf_fields(leaf) -> tuple:
  """The tensor fields of a GEMM leaf (a FactoredLinear's or a
  QuantizedLinear's), or () for a tensor."""
  if isinstance(leaf, FactoredLinear):
    return tuple(f for f in "wuv" if getattr(leaf, f) is not None)
  if isinstance(leaf, QuantizedLinear):
    return tuple(f for f in _QUANT_FIELDS if getattr(leaf, f) is not None)
  return ()


def _rebuild_leaf(leaf, tensors: dict):
  if isinstance(leaf, FactoredLinear):
    return FactoredLinear(**tensors, name=leaf.name, group=leaf.group,
                          view=True)
  return QuantizedLinear(**tensors, name=leaf.name, group=leaf.group,
                         orig_dtype=leaf.orig_dtype)


def split_call(fn, *inputs, out, **kwargs):
  """`fn` on this rank's blocks of `inputs`, the port's `shard_map` by
  named layouts; with no DTensor among them, `fn` on them as they are.

  Each input is a (tensor, layout) pair, or a (GEMM leaf, "") pair for a
  weight every rank reads whole. A layout's letters name leading dims:
  "b" the batch (its rows on the data axes where their degree divides
  them), "h" a head axis (on the model axis where the model degree
  divides every "h" dim of the inputs), "l" a cache's length (on the
  model axis where the model degree divides it, as `state_shardings`
  lays a cache out), any other letter a dim whole on every rank; dims
  past the layout are whole. `out` is the layout of each of fn's results
  (a string, or a tuple of them with None for a result handed back
  local). Where an input has an "l" dim, `fn` also gets `group` (the
  model axis's process group where "l" is split, else None) and
  `offset` (the global index of this rank's first "l" row). The local
  op is the op one device runs: on a mesh of one every result is bit
  for bit the unsharded one."""
  tensors = [t for x, _ in inputs for t in
             ([getattr(x, f) for f in _leaf_fields(x)] or [x])]
  lead = next((t for t in tensors if is_dtensor(t)), None)
  has_len = any("l" in lay for _, lay in inputs)
  if has_len:
    kwargs = dict(kwargs, group=None, offset=0)
  if lead is None:
    return fn(*(x for x, _ in inputs), **kwargs)
  from torch.distributed.tensor import Replicate, Shard
  mesh = lead.device_mesh
  names = axis_names(mesh)
  model = names.index(MODEL_AXIS) if MODEL_AXIS in names else None
  degree = mesh.size(model) if model is not None else 1

  def dims(letter):
    return [x.shape[i] for x, lay in inputs for i, c in enumerate(lay)
            if c == letter]
  rows = dims("b")
  rows_pl = (rows_placements(mesh, rows[0]) if rows else
             [Replicate()] * mesh.ndim)
  on_model = {c for c in "hl" if dims(c) and degree > 1
              and all(n % degree == 0 for n in dims(c))}
  if len(on_model) > 1:
    raise ValueError("split_call: heads and a length both on the model "
                     "axis")

  def pl_of(layout: str) -> list:
    pl = [Replicate()] * mesh.ndim
    for i, c in enumerate(layout):
      if c == "b":
        pl = [Shard(i) if r.is_shard() else p for r, p in zip(rows_pl, pl)]
      elif c in on_model:
        pl[model] = Shard(i)
    return pl
  if "l" in on_model:
    size = dims("l")[0] // degree
    kwargs.update(group=mesh.get_group(MODEL_AXIS),
                  offset=mesh.get_coordinate()[model] * size)
  flat = []
  for x, lay in inputs:
    fields = _leaf_fields(x)
    if not fields:
      flat.append((x, pl_of(lay)))
      continue
    flat += [(getattr(x, f), pl_of(lay)) for f in fields]
  outs = out if isinstance(out, tuple) else (out,)
  out_pls = tuple(None if o is None else pl_of(o) for o in outs)

  def run(*local):
    it = iter(local)
    args = []
    for x, _ in inputs:
      fields = _leaf_fields(x)
      args.append(_rebuild_leaf(x, {f: next(it) for f in fields})
                  if fields else next(it))
    return fn(*args, **kwargs)
  return local_call(run, mesh, flat,
                    out_pls if isinstance(out, tuple) else out_pls[0])


def pointwise(fn, x: torch.Tensor) -> torch.Tensor:
  """An elementwise `fn` (one with no DTensor rule, such as logsigmoid's
  backward) on each rank's block of `x`, laid out as x (a partial sum
  reduced first); a plain x goes straight to fn."""
  if not is_dtensor(x):
    return fn(x)
  from torch.distributed.tensor import Replicate
  pl = [Replicate() if p.is_partial() else p for p in x.placements]
  return local_call(fn, x.device_mesh, [(x, pl)], pl)


def gather_whole(x: torch.Tensor) -> torch.Tensor:
  """A DTensor replicated on every mesh dim, differentiably (a plain
  tensor as it is)."""
  if not is_dtensor(x):
    return x
  from torch.distributed.tensor import Replicate
  return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def local_block(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
  """This rank's block of `t` laid out as the DTensor `like` (a DTensor
  redistributed where its layout differs, a whole tensor sliced); where
  `like` is a plain tensor, `t` itself."""
  if not is_dtensor(like):
    return t
  if is_dtensor(t) and list(t.placements) == list(like.placements):
    return t.to_local()
  return _local_like(t, like, list(like.placements))


def assign(dst: torch.Tensor, src: torch.Tensor) -> None:
  """dst.copy_(src) in place; on a DTensor `dst` each rank writes its
  own block (src laid out as dst first), nothing else moves."""
  if not is_dtensor(dst):
    dst.copy_(src.full_tensor() if is_dtensor(src) else src)
    return
  dst.to_local().copy_(local_block(src, dst))


# ---------------------------------------------------------------------------
# Coverage introspection.
# ---------------------------------------------------------------------------

class RuleMesh:
  """Axis-names/sizes-only stand-in for a mesh.

  The rule logic reads only `.axis_names` and `.shape`, so this answers
  "how WOULD this tree shard on a (data=2, model=4) mesh" with no process
  group: what rule-coverage auditing needs. Not usable where a real
  DeviceMesh is required (`placements` on tensors)."""

  def __init__(self, **axes: int):
    self.shape = dict(axes)

  @property
  def axis_names(self) -> tuple:
    return tuple(self.shape)


def rule_coverage(params: nn.Module, mesh=None) -> list:
  """Per-array-leaf rule attribution over a model (real or `meta`
  tensors) — the introspection half of `param_shardings`, entry for
  entry the reference's for the same bridged tree:

    name     logical GEMM name, or None for path-matched leaves
    field    GEMM-leaf field ("w"/"u"/"v"/"w_q"/"u_scale"/...) or last
             path token
    path     "/"-joined path (a GEMM leaf's node path)
    rule     PARAM_RULES kind, "embedding_table", or None (replicated)
    matches  how many PARAM_RULES globs match the name (0 for
             path-matched leaves)
    shape / size / bytes / spec / sharded   the gated outcome on `mesh`
    shard_factor   how many devices split this leaf

  `mesh` defaults to RuleMesh(data=2, model=4)."""
  mesh = RuleMesh(data=2, model=4) if mesh is None else mesh
  sizes = axis_sizes(mesh)
  entries: list = []

  def n_matches(name: str) -> int:
    return sum(1 for pat, _ in PARAM_RULES if fnmatch.fnmatch(name, pat))

  def spec_factor(spec: P) -> int:
    f = 1
    for e in spec:
      if e is None:
        continue
      for a in (e if isinstance(e, tuple) else (e,)):
        f *= int(sizes[a])
    return f

  for toks, owner, field, t in _leaves(params):
    shape = tuple(t.shape)
    size = int(math.prod(shape))
    spec = _spec_of(toks, owner, field, shape, mesh)
    if owner is not None:
      kw = dict(name=owner.name, field=field, rule=_param_rule(owner.name),
                matches=n_matches(owner.name))
    else:
      rule = ("embedding_table" if toks and toks[-1] == "table"
              and len(shape) == 2 else None)
      kw = dict(name=None, field=toks[-1] if toks else "", rule=rule,
                matches=0)
    entries.append(dict(
        shape=shape, size=size, bytes=size * t.element_size(),
        spec=str(spec), sharded=any(e is not None for e in spec),
        shard_factor=spec_factor(spec), path="/".join(toks), **kw))
  return entries


# ---------------------------------------------------------------------------
# The constraint callable — the one execution surface.
# ---------------------------------------------------------------------------

def _relay(x: torch.Tensor, spec: P, mesh) -> torch.Tensor:
  if not is_dtensor(x):
    return x
  want = placements(spec, mesh)
  return x if list(x.placements) == want else x.redistribute(mesh, want)


def _constrain_layer_params(tree: Any, mesh) -> Any:
  """cs(lp, "layer_params"): re-lay one layer's view (the dict of a
  stack's layer i: GEMM leaves and raw tensors) in the TP-resident
  layout: weights keep their model-axis split, small arrays replicate.
  Under FSDP this is where a layer's gather happens; on a tree laid out
  by `param_shardings(fsdp=False)` every leaf already has its layout and
  the view comes back as it was."""
  if isinstance(tree, dict):
    out = {k: _constrain_layer_params(v, mesh) for k, v in tree.items()}
    return tree if all(out[k] is tree[k] for k in tree) else out
  if isinstance(tree, FactoredLinear):
    new = {f: _relay(getattr(tree, f), _leaf_spec(
        tuple(getattr(tree, f).shape), mesh, name=tree.name, field=f), mesh)
           for f in "wuv" if getattr(tree, f) is not None}
    if all(new[f] is getattr(tree, f) for f in new):
      return tree
    return FactoredLinear(**new, name=tree.name, group=tree.group, view=True)
  if isinstance(tree, QuantizedLinear):
    new = {f: _relay(getattr(tree, f), _quant_spec(
        tree, f, tuple(getattr(tree, f).shape), mesh), mesh)
           for f in _QUANT_FIELDS if getattr(tree, f) is not None}
    if all(new[f] is getattr(tree, f) for f in new):
      return tree
    return QuantizedLinear(**new, name=tree.name, group=tree.group,
                           orig_dtype=tree.orig_dtype)
  return _relay(tree, P(), mesh)


def make_constraint(mesh, cfg, global_batch: int, *, decode: bool = False,
                    rule_overrides: Optional[dict] = None) -> Constraint:
  """Build the `cs(x, logical_name) -> x` constraint callable.

  The only constraint entry point: the trainer and the serving engine
  both call it, so a sharding decision is made once per logical name.
  With mesh=None it returns `identity_constraint`. Otherwise `cs(x,
  name)` redistributes a DTensor `x` to the placements its rule gates to
  (a plain tensor passes through); "layer_params" re-lays a layer's
  weights; unknown names pass through.

  Args:
    mesh: the DeviceMesh (or None for single-device identity).
    cfg: the ModelConfig the step runs (kept for rules that specialise
      per family).
    global_batch: the step's global batch (the divisibility gate drops
      the data axis of a batch it does not divide).
    decode: True for cached serve steps (kept for rule specialisation).
    rule_overrides: {logical name: role template or P} — alternative
      layouts without touching model code ("layer_params", a tree of
      GEMM leaves, takes none).
  """
  del cfg, global_batch, decode   # rules are name+shape driven today
  if mesh is None:
    return identity_constraint
  if rule_overrides and "layer_params" in rule_overrides:
    raise NotImplementedError("an override of \"layer_params\"")
  rules = dict(ACTIVATION_RULES)
  if rule_overrides:
    rules.update(rule_overrides)

  def _apply_rule(x, rule):
    if not is_dtensor(x):
      return x
    spec = rule if isinstance(rule, P) else _gate(rule, tuple(x.shape), mesh)
    if spec is None:
      return x
    want = placements(spec, mesh)
    if list(x.placements) == want:
      return x
    return x.redistribute(mesh, want)

  def cs(x, name: str):
    if name == "layer_params":
      return _constrain_layer_params(x, mesh)
    rule = rules.get(name)
    if rule is None:
      return x                    # unknown logical names pass through
    return _apply_rule(x, rule)

  return cs
