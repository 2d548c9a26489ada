"""int8 post-training quantization (paper §4): the QuantizedLinear leaf
and the one-shot PTQ pass."""
from repro_torch.quant.leaf import QuantizedLinear, kernel_apply, ref_apply
from repro_torch.quant.ptq import DEFAULT_PLAN, quantize_leaf, quantize_params

__all__ = ["DEFAULT_PLAN", "QuantizedLinear", "kernel_apply",
           "quantize_leaf", "quantize_params", "ref_apply"]
