"""KernelPolicy — the execution policy routing GEMMs to the CUDA kernels.

Counterpart of `repro.kernels.dispatch`, with the same rules and the same
regime names, so the two packages' routing logs compare by equality:

  decode_matvec — unfactored weight, flattened batch <= decode_batch_max
  lowrank_gemm  — factored W = UV leaf -> (x @ U) @ V, t kept in f32
  int8_gemm     — w8a8: a QuantizedLinear classifies here by type
                  (stored int8 weights and scales consumed directly); an
                  override on a float leaf re-quantizes per call
  gru_cell      — the fused recurrent step, routed by `maybe_gru_cell`
  flash_attention — the prefill's causal attention, routed by
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
`record_dispatch()` — at every call, not once per trace. The
calibration observers of the reference come with a later slice.
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
    # by identity: two empty logs compare equal
    for i in range(len(_RECORDERS) - 1, -1, -1):
      if _RECORDERS[i] is log:
        del _RECORDERS[i]
        break


def _record(name: Optional[str], regime: str) -> None:
  for log in _RECORDERS:
    log.append((name or "<unnamed>", regime))


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
                          policy: Optional[KernelPolicy],
                          name: str) -> Optional[torch.Tensor]:
  """Route one causal attention (q: (b, s, h, d); k, v: (b, s, h_kv, d),
  kv heads not repeated) to the flash_attention kernel, or return None to
  decline (the caller then repeats the kv heads and runs the plain
  blockwise body). It declines, recording nothing, wherever the kernel
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
  return ops.flash_attention(q, k, v, causal=True)
