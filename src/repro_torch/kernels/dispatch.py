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
`record_dispatch()` — at every call, not once per trace.

The calibration observers (`observe_gemm_inputs`, `observe_gemm_moments`,
`calibration_layer`) see every GEMM routed through `gemm()`, under any
policy. The reference's observers skip traced activations, which in an
eager calibration forward means every GEMM inside a `lax.scan`: the GRU
time loop, the layer stacks of the transformer and of Whisper's
`encode`/`decode_*`. The port runs those loops in Python, so each of
them is marked with `scanned()`, inside which the observers see nothing:
the two packages' calibration dicts then hold the same keys.
"""
from __future__ import annotations

import contextlib
import dataclasses
import fnmatch
import math
from typing import Optional

import torch

from repro_torch.core.factored import FactoredLinear, matmul_ref
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

_RECORDERS: list = []


@contextlib.contextmanager
def record_dispatch():
  """Capture `(logical_name, regime)` for every dispatch decision made
  inside the context. Reentrant: contexts nest and unwind correctly."""
  log: list = []
  _RECORDERS.append(log)
  try:
    yield log
  finally:
    _remove(_RECORDERS, log)


def _record(name: Optional[str], regime: str) -> None:
  for log in _RECORDERS:
    log.append((name or "<unnamed>", regime))


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
  _record(name or getattr(leaf, "name", None), regime)
  _observe(name or getattr(leaf, "name", None), x)
  if regime == "jnp":
    return _plain_gemm(leaf, x)
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
  _record(name, "gru_cell")
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
  _record(name, "flash_attention")
  return ops.flash_attention(q, k, v, causal=causal)
