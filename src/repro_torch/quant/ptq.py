"""Post-training quantization: one-shot float model -> quantized model.

Counterpart of `repro.quant.ptq`. `quantize_params` replaces every
`FactoredLinear` the plan matches with a `QuantizedLinear` (symmetric
per-column int8) and leaves the rest untouched.

Optional activation-range calibration: run the float model over a few
batches inside `calibrate_activation_ranges` and pass the resulting
{name: amax} dict as `calib`. Calibrated leaves quantize activations
with a static scale (amax / 127) instead of the dynamic per-row max;
leaves without an entry keep dynamic quantization. Those are, as in the
reference, the GEMMs that it runs inside a `lax.scan` (the GRU
recurrence, the layer stacks): the port marks those loops
(`kernels.dispatch.scanned`) and its observers skip them.
`calibrate_activation_stats` collects the per-GEMM input Gram matrices
that `core.compress.to_stage2(calib=...)` truncates with (LiteASR).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Mapping, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.core.compress import FactorizationPlan
from repro_torch.core.factored import FactoredLinear, map_factored_leaves
from repro_torch.kernels import ref
from repro_torch.quant.leaf import QuantizedLinear

#: default PTQ scope: every GEMM leaf, whatever its size
DEFAULT_PLAN = FactorizationPlan(min_dim=1)


def quantize_leaf(leaf: FactoredLinear,
                  act_amax: Optional[float] = None) -> QuantizedLinear:
  """Symmetric per-column int8 quantization of one GEMM leaf; a stacked
  (L, m, n) leaf per (layer, column). `act_amax` gives a static f32
  activation scale max(act_amax, 1e-8) / 127, shared by every layer."""
  dev = (leaf.u if leaf.is_factored else leaf.w).device
  act_scale = None
  if act_amax is not None:
    act_scale = torch.tensor(max(float(act_amax), 1e-8) / 127.0,
                             dtype=torch.float32, device=dev)
  kw = dict(act_scale=act_scale, name=leaf.name, group=leaf.group,
            orig_dtype=leaf.dtype)
  if leaf.is_factored:
    u_q, u_s = ref.quantize_colwise(leaf.u.detach())
    v_q, v_s = ref.quantize_colwise(leaf.v.detach())
    return QuantizedLinear(u_q=u_q, u_scale=u_s, v_q=v_q, v_scale=v_s, **kw)
  w_q, w_s = ref.quantize_colwise(leaf.w.detach())
  return QuantizedLinear(w_q=w_q, w_scale=w_s, **kw)


def quantize_params(model: nn.Module,
                    plan: Optional[FactorizationPlan] = None, *,
                    calib: Optional[Mapping[str, float]] = None
                    ) -> nn.Module:
  """A copy of `model` with every FactoredLinear the plan matches
  replaced by its QuantizedLinear (default: all of them). `calib`:
  {logical name: activation amax} from `calibrate_activation_ranges`;
  matched leaves get a static activation scale."""
  plan = DEFAULT_PLAN if plan is None else plan

  def f(leaf: FactoredLinear):
    if not plan.matches(leaf):
      return leaf
    amax = calib.get(leaf.name) if calib else None
    return quantize_leaf(leaf, act_amax=amax)
  return map_factored_leaves(f, model)


def is_quantized(model: nn.Module) -> bool:
  """True if any GEMM leaf of the model is a QuantizedLinear."""
  return any(isinstance(m, QuantizedLinear) for m in model.modules())


def _no_observation(fn_name: str) -> RuntimeError:
  return RuntimeError(
      f"{fn_name} observed zero GEMM activations: apply_fn must run the "
      "model with a KernelPolicy threaded (dispatch.JNP_ONLY works), so "
      "that its GEMMs route through kernels.dispatch.gemm, and outside "
      "the loops the reference scans (dispatch.scanned), whose GEMMs the "
      "observers skip")


def calibrate_activation_ranges(apply_fn, batches: Iterable[Any]
                                ) -> dict[str, float]:
  """Record per-GEMM activation ranges by running the float model.

  `apply_fn(batch)` runs the model forward with a KernelPolicy threaded
  (`dispatch.JNP_ONLY` keeps the plain numerics), so every GEMM routes
  through `kernels.dispatch.gemm`, whose input observer this taps.
  Returns {logical GEMM name: max |x| over all batches}; "name@L{i}"
  entries (from `dispatch.calibration_layer`) also fold into their base
  name by max, the key `quantize_params` looks up."""
  from repro_torch.kernels import dispatch
  ran = False
  with dispatch.observe_gemm_inputs() as log:
    for batch in batches:
      ran = True
      apply_fn(batch)
  if ran and not log:
    raise _no_observation("calibrate_activation_ranges")
  out = dict(log)
  for key, amax in log.items():
    base = _split_layer_key(key)[0]
    if base != key:
      out[base] = max(out.get(base, 0.0), amax)
  return out


def _split_layer_key(key: str) -> tuple[str, Optional[int]]:
  base, sep, idx = key.rpartition("@L")
  if sep and idx.isdigit():
    return base, int(idx)
  return key, None


@dataclasses.dataclass
class ActivationStats:
  """Calibrated input statistics for one GEMM leaf.

  second_moment — E[x x^T]: (m, m), or (L, m, m) stacked a layer when
  the forward tagged layers with `dispatch.calibration_layer`; numpy
  float64. count/amax aggregate over layers.
  `core.compress.to_stage2(calib=...)` consumes the second moment."""
  second_moment: np.ndarray
  count: int
  amax: float


def calibrate_activation_stats(apply_fn, batches: Iterable[Any]
                               ) -> dict[str, ActivationStats]:
  """Collect per-GEMM input Gram matrices for calibrated truncation.

  Same contract as `calibrate_activation_ranges`, tapping
  `dispatch.observe_gemm_moments`. Entries tagged "name@L{i}" (stacked
  leaves observed layer by layer, as `models.whisper.encode_unrolled`
  does) become ONE `ActivationStats` per base name, its second moment
  stacked (L, m, m) in layer order; the layer indices must be contiguous
  from 0."""
  from repro_torch.kernels import dispatch
  ran = False
  with dispatch.observe_gemm_moments() as log:
    for batch in batches:
      ran = True
      apply_fn(batch)
  if ran and not log:
    raise _no_observation("calibrate_activation_stats")
  flat: dict[str, dict] = {}
  layered: dict[str, dict[int, dict]] = {}
  for key, ent in log.items():
    base, idx = _split_layer_key(key)
    if idx is None:
      flat[base] = ent
    else:
      layered.setdefault(base, {})[idx] = ent
  out: dict[str, ActivationStats] = {}
  for name, ent in flat.items():
    out[name] = ActivationStats(
        second_moment=ent["xtx"] / max(ent["count"], 1),
        count=ent["count"], amax=ent["amax"])
  for name, by_layer in layered.items():
    n = len(by_layer)
    if sorted(by_layer) != list(range(n)):
      raise RuntimeError(
          f"leaf {name!r}: calibration saw layer indices "
          f"{sorted(by_layer)}, expected contiguous 0..{n - 1}: some "
          "layer never ran under calibration_layer")
    stack = np.stack([by_layer[i]["xtx"] / max(by_layer[i]["count"], 1)
                      for i in range(n)])
    out[name] = ActivationStats(
        second_moment=stack,
        count=sum(by_layer[i]["count"] for i in range(n)),
        amax=max(by_layer[i]["amax"] for i in range(n)))
  return out
