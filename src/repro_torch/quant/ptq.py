"""Post-training quantization: one-shot float model -> quantized model.

Counterpart of `repro.quant.ptq` (`quantize_leaf`, `quantize_params`).
Activation-range calibration comes with a later slice.
"""
from __future__ import annotations

from typing import Optional

from torch import nn

from repro_torch.core.compress import FactorizationPlan
from repro_torch.core.factored import FactoredLinear, map_factored_leaves
from repro_torch.kernels import ref
from repro_torch.quant.leaf import QuantizedLinear

#: default PTQ scope: every GEMM leaf, whatever its size
DEFAULT_PLAN = FactorizationPlan(min_dim=1)


def quantize_leaf(leaf: FactoredLinear) -> QuantizedLinear:
  """Symmetric per-column int8 quantization of one GEMM leaf."""
  kw = dict(name=leaf.name, group=leaf.group, orig_dtype=leaf.dtype)
  if leaf.is_factored:
    u_q, u_s = ref.quantize_colwise(leaf.u.detach())
    v_q, v_s = ref.quantize_colwise(leaf.v.detach())
    return QuantizedLinear(u_q=u_q, u_scale=u_s, v_q=v_q, v_scale=v_s, **kw)
  w_q, w_s = ref.quantize_colwise(leaf.w.detach())
  return QuantizedLinear(w_q=w_q, w_scale=w_s, **kw)


def quantize_params(model: nn.Module,
                    plan: Optional[FactorizationPlan] = None) -> nn.Module:
  """A copy of `model` with every FactoredLinear the plan matches
  replaced by its QuantizedLinear (default: all of them)."""
  plan = DEFAULT_PLAN if plan is None else plan
  return map_factored_leaves(
      lambda leaf: quantize_leaf(leaf) if plan.matches(leaf) else leaf,
      model)
