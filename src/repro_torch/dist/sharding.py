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


def _batch_placements(mesh, rows: int) -> list:
  """Rows on the data axes (where they divide them), whole elsewhere."""
  return placements(_gate(("data",), (rows,), mesh), mesh)


def rows_local(fn, *args, **kwargs):
  """Run `fn` on each rank's rows of the batch-leading tensors `args`.

  Every DTensor argument is laid out with its leading (batch) dim on the
  data axes and whole on the others, and handed to `fn` as its local
  tensor; a plain tensor argument is sliced to the same rows. Returns
  (fn's result on the local rows, `whole`): `whole(x)` gathers a
  per-row result of the local rows into a replicated DTensor of all the
  rows, differentiably (a DTensor, so that autograd keeps a DTensor
  boundary where it meets the other DTensors of a loss). For per-row
  work with in-place updates (the CTC recursion) that no DTensor op rule
  covers."""
  from torch.distributed.tensor import DTensor, Replicate
  mesh = next(a.device_mesh for a in args if is_dtensor(a))
  rows = args[0].shape[0]
  pl = _batch_placements(mesh, rows)
  local = []
  for a in args:
    if not is_dtensor(a):
      a = distribute_tensor_local(a, mesh, pl)
    local.append(a.redistribute(mesh, pl).to_local())
  out = fn(*local, **kwargs)

  def whole(x):
    return DTensor.from_local(x, mesh, pl).redistribute(
        mesh, [Replicate()] * len(pl))
  return out, whole


def rows_apply(fn, x: torch.Tensor, *weights: torch.Tensor, **kwargs):
  """fn(x, *weights, **kwargs) on each rank's rows of the batch-leading x,
  for a per-row op (the DS2 convolutions) whose DTensor rule is narrower
  than the op: x is laid out with its rows on the data axes and whole
  elsewhere, each weight whole, and the result is a DTensor of x's rows.
  A weight's gradient comes back partial over the data axes (each rank
  saw its own rows), to be reduced where the gradient meets its
  parameter's placements."""
  from torch.distributed.tensor import DTensor, Partial, Replicate
  mesh = next(t.device_mesh for t in (x,) + weights if is_dtensor(t))
  pl = _batch_placements(mesh, x.shape[0])
  xl = (x if is_dtensor(x) else distribute_tensor_local(x, mesh, pl))
  xl = xl.redistribute(mesh, pl).to_local()
  whole = [Replicate()] * mesh.ndim
  grad_pl = [Partial() if p.is_shard() else Replicate() for p in pl]
  wl = [w.redistribute(mesh, whole).to_local(grad_placements=grad_pl)
        if is_dtensor(w) else w for w in weights]
  return DTensor.from_local(fn(xl, *wl, **kwargs), mesh, pl)


def heads_local(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                **kwargs) -> torch.Tensor:
  """Attention `fn(q, k, v, **kwargs)` on each rank's rows and heads.

  q (b, s, h, hd), k and v (b, s, kv, hd) are laid out by the "bshd_q" /
  "bshd_kv" rules (batch on the data axes, heads on the model axis),
  the head split kept only where the model degree divides both h and kv,
  so that every local q head finds its GQA kv head locally. `fn` runs
  on the local tensors (the kernel or the plain route, as it would on
  one device); the output carries q's layout."""
  from torch.distributed.tensor import DTensor
  mesh = q.device_mesh
  m = axis_sizes(mesh).get(MODEL_AXIS, 1)
  head = "model" if q.shape[2] % m == 0 and k.shape[2] % m == 0 else None
  local, pl_q = [], None
  for t in (q, k, v):
    pl = placements(_gate(("data", None, head, None), tuple(t.shape), mesh),
                    mesh)
    pl_q = pl_q or pl
    local.append(t.redistribute(mesh, pl).to_local())
  out = fn(*local, **kwargs)
  return DTensor.from_local(out, mesh, pl_q, shape=q.shape,
                            stride=contiguous_stride(q.shape))


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
    return DTensor.from_local(x.detach().to(mesh.device_type), mesh, pl,
                              run_check=False)
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


def write_rows(cache: torch.Tensor, new: torch.Tensor,
               pos: torch.Tensor) -> None:
  """cache[i, pos[i, t]] = new[i, t] in place on a DTensor cache (b, S,
  ...) whose rows are on the data axes and positions on the model axis
  (`state_shardings`): each rank writes the rows and positions its local
  block holds; a position at or past S is dropped."""
  off = local_offsets(cache)
  local = cache.to_local()
  lb, ls = local.shape[:2]
  # the new rows split as the cache's block, whole along the length
  new = _local_like(new, cache, _whole_on(cache, 1))
  pos = (pos.full_tensor() if is_dtensor(pos) else pos)[off[0]:off[0] + lb]
  rows = pos - off[1]
  keep = (pos < cache.shape[1]) & (rows >= 0) & (rows < ls)
  bidx = torch.arange(lb, device=local.device)[:, None].expand_as(pos)
  local[bidx[keep], rows[keep]] = new[keep].to(local.dtype)


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


#: families whose sharded execution is ported (`Trainer(mesh=)`,
#: `LMEngine(mesh=)`); the others wait for ROADMAP.md A6b
MESH_FAMILIES = ("transformer", "deepspeech")


def check_mesh_family(cfg) -> None:
  """Raise for a config whose sharded execution is not ported yet."""
  if cfg.family not in MESH_FAMILIES or cfg.moe is not None or \
      cfg.mla is not None:
    raise NotImplementedError(
        f"{cfg.name}: sharded execution (mesh=) of this family is not "
        "ported yet: ROADMAP.md A6b (only the dense transformer and "
        "deepspeech2 run under a mesh)")


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
