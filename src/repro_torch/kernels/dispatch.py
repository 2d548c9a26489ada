"""KernelPolicy — the execution policy routing GEMMs to the CUDA kernels.

Counterpart of `repro.kernels.dispatch`, with the same rules and the same
regime names, so the two packages' routing logs compare by equality:

  decode_matvec — unfactored weight, flattened batch <= decode_batch_max
  lowrank_gemm  — factored W = UV leaf -> (x @ U) @ V, t kept in f32
  int8_gemm     — w8a8: a QuantizedLinear classifies here by type
                  (stored int8 weights and scales consumed directly); an
                  override on a float leaf re-quantizes per call
  gru_cell      — the fused recurrent step, routed by `maybe_gru_cell`
  flash_attention — the prefill's causal attention and Whisper's
                  non-causal encoder attention, routed by
                  `maybe_flash_attention`
  jnp           — everything else and degenerate shapes: the plain
                  PyTorch path (`torch.matmul`), named after the
                  reference's plain regime

`maybe_flash_attention` has no counterpart in the reference's
dispatcher: the reference's models run the jnp twin of its Pallas
flash_attention (`repro.layers.attention.flash_attention`, documented
as that kernel's oracle) and record no attention decision. The port
wires in the kernel the reference ships, on the path whose jnp form is
its oracle; the outputs agree within tolerance, so it adds no
behaviour. A routing log compared with the reference's therefore drops
the ("layers/attn", "flash_attention") entry.

Classification keeps the reference's 128-lane gate (no dimension below
128 goes to a kernel) even though the CUDA kernels take any shape: the
gate is part of the routing contract the two packages share.

PyTorch runs eagerly, so a decision is made — and recorded by
`record_dispatch()` — at every call, not once per trace. Under
`listen_scopes()` (the analysis op walk) each routed call also runs
inside its `dispatch:{regime}:c{id}` scope, the counterpart
of the reference's `jax.named_scope`; with no recorder or listener a
call pays one check of an empty list.

The calibration observers (`observe_gemm_inputs`, `observe_gemm_moments`,
`calibration_layer`) see every GEMM routed through `gemm()`, under any
policy. The reference's observers skip traced activations, which in an
eager calibration forward means every GEMM inside a `lax.scan`: the GRU
time loop, the layer stacks of the transformer and of Whisper's
`encode`/`decode_*`. The port runs those loops in Python, so each of
them is marked with `scanned()`, inside which the observers see nothing:
the two packages' calibration dicts then hold the same keys.

DTensor operands (a mesh, `dist.sharding`). The kernels take raw
pointers, so a DTensor never reaches one: the regime is classified on
the global shapes, as on one device, and each kernel runs on local
shards where the weight's layout makes the product local, with rows
sharded over the data axes staying where they are:

  gemm, a column-parallel w (n split on "model"): x whole on the model
    axis, one launch on the local columns, y split the same way;
  gemm, a row-parallel w (m split): x split along m (a local slice),
    one launch gives a partial sum, all-reduced over the model axis;
  gemm, a factored leaf in the rank-local layout (u split on m, v on
    n): x split along m, `decode_matvec` for x @ u (a partial (b, r)
    term), its all-reduce, then `decode_matvec` for t @ v on the local
    columns: two launches around one collective, which `lowrank_gemm`'s
    single fused launch cannot hold; past the decode bound the factors
    are gathered and `lowrank_gemm` runs whole;
  gemm, a quantized leaf: a column-parallel w_q (with its w_scale split
    alike) runs locally; a row-split or factored one is gathered first
    (a row's activation scale is its amax over the whole of m);
  maybe_gru_cell: U's 3h gate axis is [r | z | g], so an even column
    split gives no rank whole units: U is gathered, xw and h taken whole
    on the model axis, and the fused step runs on the local rows;
  flash_attention: its caller (`layers.attention.flash_attention`)
    hands this entry point each rank's rows and heads as plain tensors
    (`dist.sharding.heads_local`).

Everywhere else (the "jnp" regime) the plain path runs on the DTensors
as they are.
"""
from __future__ import annotations

import contextlib
import dataclasses
import fnmatch
import itertools
import math
from typing import Optional

import torch

from repro_torch.core.factored import FactoredLinear, matmul_ref
from repro_torch.dist.sharding import contiguous_stride, is_dtensor
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_supported
from repro_torch.quant.leaf import QuantizedLinear, kernel_apply

#: every regime a policy (or override) may name
REGIMES = ("jnp", "decode_matvec", "lowrank_gemm", "int8_gemm", "gru_cell",
           "flash_attention")

#: smallest dimension classify() routes to a kernel (the reference's
#: MXU-lane gate, kept so routing stays identical)
LANE = 128


@dataclasses.dataclass(frozen=True)
class KernelPolicy:
  """Which kernel each GEMM regime runs.

  mode: "jnp_only" — every call site takes the plain path (the default);
        "decode"   — shape-specialized routing to the kernels.
  overrides: ((glob, regime), ...) over logical GEMM names, first match
    wins, consulted before the shape rules; still gated by shape.
  decode_batch_max: largest flattened batch routed to decode_matvec.
  """
  mode: str = "jnp_only"
  decode_batch_max: int = ops.DECODE_BATCH_MAX
  overrides: tuple = ()

  def __post_init__(self):
    if self.mode not in ("jnp_only", "decode"):
      raise ValueError(f"unknown KernelPolicy mode: {self.mode!r}")
    if not 1 <= self.decode_batch_max <= ops.DECODE_BATCH_MAX:
      raise ValueError(
          f"decode_batch_max must be in [1, {ops.DECODE_BATCH_MAX}], got "
          f"{self.decode_batch_max}")
    for pat, regime in self.overrides:
      if regime not in REGIMES:
        raise ValueError(f"override {pat!r} names unknown regime {regime!r}")

  def override_for(self, name: Optional[str]) -> Optional[str]:
    if name is None:
      return None
    for pat, regime in self.overrides:
      if fnmatch.fnmatch(name, pat):
        return regime
    return None


JNP_ONLY = KernelPolicy()


def decode_policy(batch_size: Optional[int] = None, *, window: int = 1,
                  overrides: tuple = ()) -> KernelPolicy:
  """The serving policy. `batch_size` narrows decode_matvec's bound to
  min(16, batch_size * window): a per-step GEMM has flattened batch
  == batch_size, so anything wider is not the decode regime."""
  bmax = ops.DECODE_BATCH_MAX
  if batch_size is not None:
    bmax = min(bmax, max(1, batch_size) * max(1, window))
  return KernelPolicy(mode="decode", decode_batch_max=bmax,
                      overrides=tuple(overrides))


def resolve_policy(policy, batch_size: Optional[int] = None, *,
                   window: int = 1) -> Optional[KernelPolicy]:
  """Accept a KernelPolicy, None, or the serving names "plain" (the
  plain PyTorch path, the reference's "jnp") and "cuda" (the kernels,
  the reference's "pallas")."""
  if policy is None or isinstance(policy, KernelPolicy):
    return policy
  if policy == "plain":
    return JNP_ONLY
  if policy == "cuda":
    return decode_policy(batch_size, window=window)
  raise ValueError(f"unknown kernel policy: {policy!r}")


# ---------------------------------------------------------------------------
# Instrumentation.
# ---------------------------------------------------------------------------

class DispatchRecord(tuple):
  """A recorded dispatch decision: equals (and unpacks as) the pair
  `(logical_name, regime)`, with one attribute more, `call_id`, the
  serial of the `dispatch:{regime}:c{call_id}` scope that `gemm()`,
  `maybe_gru_cell` and `maybe_flash_attention` open around the routed
  computation while a scope listener (`listen_scopes`, the analysis op
  walk) is active; the auditor joins each op's open scope back to its
  record through that id."""

  def __new__(cls, name: str, regime: str, call_id: int):
    self = tuple.__new__(cls, (name, regime))
    self.call_id = call_id
    return self

  @property
  def name(self) -> str:
    return self[0]

  @property
  def regime(self) -> str:
    return self[1]


#: the recorders' logs and the scope listeners' (one list, so that with
#: nothing listening a routed call pays one check of it)
_RECORDERS: list = []
#: the scope listeners (each also has a log in _RECORDERS): objects with
#: `scope_opened(name)` and `scope_closed(name)`
_LISTENERS: list = []
_CALL_IDS = itertools.count()


@contextlib.contextmanager
def record_dispatch():
  """Capture a DispatchRecord — `(logical_name, regime)` plus its
  `.call_id` — for every dispatch decision made inside the context.
  Reentrant: contexts nest and unwind correctly."""
  log: list = []
  _RECORDERS.append(log)
  try:
    yield log
  finally:
    _remove(_RECORDERS, log)


@contextlib.contextmanager
def listen_scopes(listener):
  """Record dispatch decisions (as `record_dispatch`) and run every
  routed call inside its dispatch scope ("dispatch:{regime}:c{id}")
  while the context is open: `listener` (the analysis op walk) gets
  `scope_opened(name)` and `scope_closed(name)` around each. Costs
  nothing once closed."""
  _LISTENERS.append(listener)
  try:
    with record_dispatch() as log:
      yield log
  finally:
    _remove(_LISTENERS, listener)


def _record(name: Optional[str], regime: str) -> int:
  cid = next(_CALL_IDS)
  for log in _RECORDERS:
    log.append(DispatchRecord(name or "<unnamed>", regime, cid))
  return cid


@contextlib.contextmanager
def _scope(regime: str, cid: int):
  name = f"dispatch:{regime}:c{cid}"
  for listener in _LISTENERS:
    listener.scope_opened(name)
  try:
    yield
  finally:
    for listener in _LISTENERS:
      listener.scope_closed(name)


def _in_scope(regime: str, cid: int, fn, *args, **kwargs):
  """`fn(*args, **kwargs)`, inside its dispatch scope while a listener
  is active; a listener with a `scope_io(name, args, out)` also gets the
  call's operands and result before the scope closes."""
  if not _LISTENERS:
    return fn(*args, **kwargs)
  with _scope(regime, cid):
    out = fn(*args, **kwargs)
    for listener in _LISTENERS:
      io = getattr(listener, "scope_io", None)
      if io is not None:
        io(f"dispatch:{regime}:c{cid}", args, out)
    return out


def _remove(stack: list, item) -> None:
  # by identity: two empty logs compare equal
  for i in range(len(stack) - 1, -1, -1):
    if stack[i] is item:
      del stack[i]
      return


# ---------------------------------------------------------------------------
# Calibration observers.
# ---------------------------------------------------------------------------

_OBSERVERS: list = []
_MOMENT_OBSERVERS: list = []
_CAL_LAYER: list = []
_SCANNED: list = []


@contextlib.contextmanager
def observe_gemm_inputs():
  """Capture {logical name: max |x| seen} (amax in f32) for every GEMM
  routed through `gemm()` inside the context, the tap
  `quant.calibrate_activation_ranges` builds on. Under
  `calibration_layer(i)` the key is "name@L{i}"; inside `scanned()`
  nothing is observed."""
  log: dict = {}
  _OBSERVERS.append(log)
  try:
    yield log
  finally:
    _remove(_OBSERVERS, log)


@contextlib.contextmanager
def calibration_layer(index: int):
  """Tag every GEMM observed inside as belonging to layer `index` of a
  stacked leaf: observers key it "name@L{index}" (the innermost index
  wins). `models.whisper.encode_unrolled` wraps each encoder layer in
  it."""
  _CAL_LAYER.append(int(index))
  try:
    yield
  finally:
    _CAL_LAYER.pop()


@contextlib.contextmanager
def scanned():
  """Mark a loop that the reference runs as a `lax.scan`. Its GEMMs'
  activations are tracers there, which the reference's observers skip;
  inside this context the port's observers skip them too."""
  _SCANNED.append(True)
  try:
    yield
  finally:
    _SCANNED.pop()


@contextlib.contextmanager
def observe_gemm_moments():
  """Capture per-GEMM input second moments for activation-calibrated
  low-rank truncation (LiteASR): for every observed input x (rows
  flattened to (N, m))

      {key: {"xtx": sum_n x_n x_n^T (m, m) float64, "count": N rows,
             "amax": max |x|}}

  keyed as `observe_gemm_inputs` keys. The Gram matrix accumulates in
  float64 on x's device; when the context closes each "xtx" becomes a
  numpy array (what `core.svd.activation_split` takes)."""
  log: dict = {}
  _MOMENT_OBSERVERS.append(log)
  try:
    yield log
  finally:
    _remove(_MOMENT_OBSERVERS, log)
    for ent in log.values():
      if isinstance(ent["xtx"], torch.Tensor):
        ent["xtx"] = ent["xtx"].cpu().numpy()


def _obs_key(name: Optional[str]) -> str:
  key = name or "<unnamed>"
  if _CAL_LAYER:
    key = f"{key}@L{_CAL_LAYER[-1]}"
  return key


def _observe(name: Optional[str], x: torch.Tensor) -> None:
  if (not _OBSERVERS and not _MOMENT_OBSERVERS) or _SCANNED:
    return
  key = _obs_key(name)
  with torch.no_grad():
    amax = float(x.detach().float().abs().max())
    for log in _OBSERVERS:
      log[key] = max(log.get(key, 0.0), amax)
    if _MOMENT_OBSERVERS:
      rows = x.detach().reshape(-1, x.shape[-1]).double()
      xtx = rows.T @ rows
      for log in _MOMENT_OBSERVERS:
        ent = log.get(key)
        if ent is None:
          log[key] = {"xtx": xtx.clone(), "count": rows.shape[0],
                      "amax": amax}
        else:
          ent["xtx"] += xtx
          ent["count"] += rows.shape[0]
          ent["amax"] = max(ent["amax"], amax)


# ---------------------------------------------------------------------------
# Classification.
# ---------------------------------------------------------------------------

def _flat_batch(x: torch.Tensor) -> int:
  return math.prod(x.shape[:-1]) if x.ndim > 1 else 1


def classify(leaf, x: torch.Tensor, policy: Optional[KernelPolicy],
             name: Optional[str] = None) -> str:
  """Pick the regime for one GEMM from shapes and leaf metadata — rule
  for rule the reference's `classify`."""
  if policy is None or policy.mode == "jnp_only":
    return "jnp"
  if name is None:
    name = getattr(leaf, "name", None)
  if isinstance(leaf, QuantizedLinear):
    # quantized storage classifies by type: there is no float weight to
    # run another regime on; a "jnp" override takes its w8a8 oracle
    return "jnp" if policy.override_for(name) == "jnp" else "int8_gemm"
  factored = isinstance(leaf, FactoredLinear) and leaf.is_factored
  regime = policy.override_for(name)
  if regime in ("gru_cell", "flash_attention"):
    # these regimes exist only at their own call sites, not at a GEMM
    regime = "jnp"
  if regime is None:
    if factored:
      regime = "lowrank_gemm"
    elif _flat_batch(x) <= policy.decode_batch_max:
      regime = "decode_matvec"
    else:
      regime = "jnp"
  if regime == "lowrank_gemm":
    if not factored or leaf.u.ndim != 2 or \
        min(leaf.u.shape[-2], leaf.u.shape[-1], leaf.v.shape[-1]) < LANE:
      regime = "jnp"
  elif regime in ("decode_matvec", "int8_gemm"):
    w = leaf.w if isinstance(leaf, FactoredLinear) else leaf
    if factored or w is None or w.ndim != 2 or min(w.shape) < LANE or \
        (regime == "decode_matvec" and
         _flat_batch(x) > policy.decode_batch_max):
      regime = "jnp"
  return regime


# ---------------------------------------------------------------------------
# The GEMM entry point.
# ---------------------------------------------------------------------------

def _plain_gemm(leaf, x: torch.Tensor) -> torch.Tensor:
  if isinstance(leaf, (FactoredLinear, QuantizedLinear)):
    return leaf.apply(x)
  return matmul_ref(x, leaf)


def gemm(leaf, x: torch.Tensor, policy: Optional[KernelPolicy],
         name: Optional[str] = None) -> torch.Tensor:
  """y[..., n] = x[..., m] @ W(m, n), routed by `policy`."""
  regime = classify(leaf, x, policy, name)
  if _RECORDERS:
    return _recorded_gemm(regime, leaf, x, policy, name)
  if _OBSERVERS or _MOMENT_OBSERVERS:
    _observe(name or getattr(leaf, "name", None), x)
  return _route(regime, leaf, x, policy)


def _recorded_gemm(regime: str, leaf, x: torch.Tensor,
                   policy: Optional[KernelPolicy],
                   name: Optional[str]) -> torch.Tensor:
  """`gemm` with a recorder or a scope listener active: the decision is
  recorded and, for a listener, the routed computation runs inside its
  dispatch scope."""
  name = name or getattr(leaf, "name", None)
  cid = _record(name, regime)
  _observe(name, x)
  return _in_scope(regime, cid, _route, regime, leaf, x, policy)


def _route(regime: str, leaf, x: torch.Tensor,
           policy: Optional[KernelPolicy]) -> torch.Tensor:
  if regime == "jnp":
    return _plain_gemm(leaf, x)
  w = _weight_of(leaf)
  if is_dtensor(x) or is_dtensor(w):
    x = _as_dtensor(x, (x if is_dtensor(x) else w).device_mesh)
    return _sharded_gemm(regime, leaf, x, policy)
  return _kernel_gemm(regime, leaf, x)


def _weight_of(leaf) -> torch.Tensor:
  """A GEMM leaf's first weight tensor (a raw tensor is its own)."""
  if isinstance(leaf, QuantizedLinear):
    return leaf.u_q if leaf.is_factored else leaf.w_q
  if isinstance(leaf, FactoredLinear):
    return leaf.u if leaf.is_factored else leaf.w
  return leaf


def _kernel_gemm(regime: str, leaf, x: torch.Tensor) -> torch.Tensor:
  lead = x.shape[:-1]
  x2 = x.reshape(-1, x.shape[-1])
  if regime == "lowrank_gemm":
    y = ops.lowrank_gemm(x2, leaf.u, leaf.v)
  elif regime == "decode_matvec":
    w = leaf.w if isinstance(leaf, FactoredLinear) else leaf
    y = ops.decode_matvec(x2, w)
  elif regime == "int8_gemm":
    if isinstance(leaf, QuantizedLinear):
      y = kernel_apply(leaf, x2)
    else:
      w = leaf.w if isinstance(leaf, FactoredLinear) else leaf
      y = ops.quantized_matmul(x2, w)
  else:  # pragma: no cover — REGIMES is closed above
    raise ValueError(f"unroutable regime {regime!r}")
  return y.reshape(lead + (y.shape[-1],)).to(x.dtype)


# ---------------------------------------------------------------------------
# DTensor operands: kernels on local shards.
# ---------------------------------------------------------------------------

def _model_dim(mesh) -> Optional[int]:
  from repro_torch.dist.mesh import MODEL_AXIS
  names = mesh.mesh_dim_names or ()
  return names.index(MODEL_AXIS) if MODEL_AXIS in names else None


def _on_model(t: torch.Tensor, md: Optional[int]):
  """The placement of DTensor `t` on the model mesh dim (None: whole)."""
  if md is None or not is_dtensor(t):
    return None
  p = t.placements[md]
  return p.dim % t.ndim if p.is_shard() else None


def _with_model(pl: list, md: Optional[int], p) -> list:
  if md is not None:
    pl = list(pl)
    pl[md] = p
  return pl


def _local(t: torch.Tensor, pl: list) -> torch.Tensor:
  return t.redistribute(t.device_mesh, pl).to_local()


def _as_dtensor(t: torch.Tensor, mesh) -> torch.Tensor:
  """A plain `t` (whole on every rank) as a replicated DTensor."""
  if is_dtensor(t):
    return t
  from torch.distributed.tensor import Replicate
  from repro_torch.dist.sharding import distribute_tensor_local
  return distribute_tensor_local(t, mesh, [Replicate()] * mesh.ndim)


def _whole(t, md):
  """`t` whole on the model axis (its data split kept), local."""
  from torch.distributed.tensor import Replicate
  if not is_dtensor(t):
    return t
  return _local(t, _with_model(t.placements, md, Replicate()))


def _sharded_gemm(regime: str, leaf, x: torch.Tensor,
                  policy: KernelPolicy) -> torch.Tensor:
  from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
  mesh = x.device_mesh
  md = _model_dim(mesh)
  last = x.ndim - 1
  rows_pl = _with_model(x.placements, md, Replicate())
  lead = []                   # the local leading dims of x's rows

  def wrap(y2, n, out_model):
    y = y2.reshape(tuple(lead[0]) + (y2.shape[-1],))
    pl = _with_model(rows_pl, md, out_model)
    return DTensor.from_local(y, mesh, pl, shape=x.shape[:-1] + (n,),
                              stride=contiguous_stride(x.shape[:-1] + (n,)))

  def x_rows(model_pl):
    """This rank's rows of x, (rows, m or its local part), laid out
    `model_pl` on the model axis."""
    t = _local(x, _with_model(rows_pl, md, model_pl))
    lead[:] = [t.shape[:-1]]
    return t.reshape(-1, t.shape[-1])

  x_whole = x_rows(Replicate())
  if regime == "lowrank_gemm":
    u, v = leaf.u, leaf.v
    if _on_model(u, md) == 0 and _on_model(v, md) == 1 and \
        x_whole.shape[0] <= policy.decode_batch_max:
      x_split = x_rows(Shard(last))
      t = ops.decode_matvec(x_split.to(u.dtype), u.to_local())
      t = DTensor.from_local(t.float(), mesh,
                             _with_model(rows_pl, md, Partial()))
      t = _local(t, rows_pl)
      y = ops.decode_matvec(t, v.to_local())
      return wrap(y, v.shape[-1], Shard(last)).to(x.dtype)
    y = ops.lowrank_gemm(x_whole, _whole(u, md), _whole(v, md))
    return wrap(y, v.shape[-1], Replicate()).to(x.dtype)
  if isinstance(leaf, QuantizedLinear):
    if not leaf.is_factored and _on_model(leaf.w_q, md) == 1:
      local = QuantizedLinear(
          w_q=leaf.w_q.to_local(), w_scale=leaf.w_scale.to_local(),
          act_scale=_whole(leaf.act_scale, md), name=leaf.name,
          group=leaf.group, orig_dtype=leaf.orig_dtype)
      return wrap(kernel_apply(local, x_whole), leaf.out_dim,
                  Shard(last)).to(x.dtype)
    from repro_torch.quant.leaf import _FIELDS
    whole = QuantizedLinear(
        **{f: _whole(getattr(leaf, f), md) for f in _FIELDS},
        name=leaf.name, group=leaf.group, orig_dtype=leaf.orig_dtype)
    return wrap(kernel_apply(whole, x_whole), leaf.out_dim,
                Replicate()).to(x.dtype)
  w = leaf.w if isinstance(leaf, FactoredLinear) else leaf
  split = _on_model(w, md)
  op = ops.decode_matvec if regime == "decode_matvec" else \
      ops.quantized_matmul
  if split == 1:                         # column-parallel
    return wrap(op(x_whole, w.to_local()), w.shape[-1],
                Shard(last)).to(x.dtype)
  if split == 0 and regime == "decode_matvec":       # row-parallel
    y = wrap(op(x_rows(Shard(last)), w.to_local()), w.shape[-1], Partial())
    return y.redistribute(mesh, rows_pl).to(x.dtype)
  return wrap(op(x_whole, _whole(w, md)), w.shape[-1],
              Replicate()).to(x.dtype)


# ---------------------------------------------------------------------------
# The recurrent-step entry point (layers/gru).
# ---------------------------------------------------------------------------

def maybe_gru_cell(xw: torch.Tensor, h: torch.Tensor, rec,
                   bias: torch.Tensor, policy: Optional[KernelPolicy]
                   ) -> Optional[torch.Tensor]:
  """Route one GRU step to the fused kernel, or return None to decline
  (the caller then runs the plain gate math, whose recurrent GEMM still
  consults the policy)."""
  if policy is None or policy.mode == "jnp_only":
    return None
  name = getattr(rec, "name", None)
  override = policy.override_for(name)
  if override is not None and override != "gru_cell":
    return None
  unfactored = isinstance(rec, FactoredLinear) and not rec.is_factored \
      and rec.w.ndim == 2
  if not unfactored or h.shape[-1] < LANE:
    # no record here: the fallback's gemm() records the real decision
    return None
  cid = _record(name, "gru_cell")
  return _in_scope("gru_cell", cid, _gru_cell, xw, h, rec, bias)


def _gru_cell(xw: torch.Tensor, h: torch.Tensor, rec,
              bias: torch.Tensor) -> torch.Tensor:
  if any(is_dtensor(t) for t in (xw, h, rec.w)):
    from torch.distributed.tensor import DTensor, Replicate
    mesh = next(t.device_mesh for t in (h, xw, rec.w) if is_dtensor(t))
    md = _model_dim(mesh)
    h = _as_dtensor(h, mesh)
    pl = _with_model(h.placements, md, Replicate())
    xw = _as_dtensor(xw, mesh)
    out = ops.gru_cell(_local(xw, _with_model(xw.placements, md,
                                              Replicate())),
                       _local(h, pl), _whole(rec.w, md), _whole(bias, md))
    return DTensor.from_local(out, mesh, pl, shape=h.shape,
                              stride=contiguous_stride(h.shape))
  return ops.gru_cell(xw, h, rec.w, bias)


# ---------------------------------------------------------------------------
# The attention entry point (layers/attention).
# ---------------------------------------------------------------------------

def maybe_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          policy: Optional[KernelPolicy], name: str, *,
                          causal: bool = True) -> Optional[torch.Tensor]:
  """Route one attention (q: (b, s, h, d); k, v: (b, s, h_kv, d), kv
  heads not repeated), causal or not, to the flash_attention kernel, or
  return None to decline (the caller then runs its plain blockwise
  body). The decision is recorded under `name` ("layers/attn": the
  causal prefill; "enc/attn": Whisper's non-causal encoder), which an
  override can also pin. It declines, recording nothing, wherever the kernel
  would refuse the operands (`flash_attention.flash_supported`: a head
  width it is not built for), as the reference's wrapper declines below
  its block sizes; a direct call of the kernel's wrapper still raises
  there."""
  if policy is None or policy.mode == "jnp_only":
    return None
  override = policy.override_for(name)
  if override is not None and override != "flash_attention":
    return None
  if not flash_supported(q, k, v):
    return None
  cid = _record(name, "flash_attention")
  return _in_scope("flash_attention", cid, ops.flash_attention, q, k, v,
                   causal=causal)
