"""int8 post-training quantization (paper §4): the QuantizedLinear leaf,
the one-shot PTQ pass and its activation calibration."""
from repro_torch.quant.leaf import QuantizedLinear, kernel_apply, ref_apply
from repro_torch.quant.ptq import (DEFAULT_PLAN, ActivationStats,
                                   calibrate_activation_ranges,
                                   calibrate_activation_stats, is_quantized,
                                   quantize_leaf, quantize_params)

__all__ = ["DEFAULT_PLAN", "ActivationStats", "QuantizedLinear",
           "calibrate_activation_ranges", "calibrate_activation_stats",
           "is_quantized", "kernel_apply", "quantize_leaf",
           "quantize_params", "ref_apply"]
