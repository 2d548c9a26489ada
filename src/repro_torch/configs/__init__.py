"""Architecture registry of the port: the paper's deepspeech2-wsj, the
dense transformers (chameleon-34b, llama3-8b, glm4-9b, stablelm-3b,
qwen3-4b), the Mamba2 hybrid zamba2-7b, xlstm-350m, the DeepSeek family
(deepseek-v2-lite, deepseek-v3-671b) and whisper-small, in the
reference's order.

  get_config(name)  — full config
  get_smoke(name)   — reduced same-family config (CPU-runnable)
  shapes_for(name)  — the assigned ShapeConfigs minus each config's
                      SKIP_SHAPES
"""
from __future__ import annotations

from repro_torch.configs import (chameleon_34b, deepseek_v2_lite,
                                 deepseek_v3_671b, deepspeech2_wsj, glm4_9b,
                                 llama3_8b, qwen3_4b, stablelm_3b,
                                 whisper_small, xlstm_350m, zamba2_7b)
from repro_torch.configs.specs import (decode_state_specs, input_specs,
                                       param_specs)
from repro_torch.layers.common import SHAPES, ModelConfig, ShapeConfig

_MODULES = {
    "chameleon-34b": chameleon_34b,
    "llama3-8b": llama3_8b,
    "glm4-9b": glm4_9b,
    "stablelm-3b": stablelm_3b,
    "qwen3-4b": qwen3_4b,
    "zamba2-7b": zamba2_7b,
    "xlstm-350m": xlstm_350m,
    "deepseek-v2-lite": deepseek_v2_lite,
    "deepseek-v3-671b": deepseek_v3_671b,
    "whisper-small": whisper_small,
    "deepspeech2-wsj": deepspeech2_wsj,
}

ARCH_NAMES = list(_MODULES)
ASSIGNED = [n for n in ARCH_NAMES if n != "deepspeech2-wsj"]

__all__ = ["ARCH_NAMES", "ASSIGNED", "SHAPES", "ModelConfig", "ShapeConfig",
           "decode_state_specs", "input_specs", "param_specs", "get_config",
           "get_smoke", "shapes_for"]


def get_config(name: str) -> ModelConfig:
  return _MODULES[name].CONFIG


def get_smoke(name: str) -> ModelConfig:
  return _MODULES[name].SMOKE


def shapes_for(name: str) -> list[ShapeConfig]:
  skips = _MODULES[name].SKIP_SHAPES
  out = []
  for sname, shape in SHAPES.items():
    if sname in skips:
      continue
    if name == "deepspeech2-wsj" and sname not in ("train_4k", "decode_32k"):
      # the paper's arch has its own serving benchmark (streaming frames);
      # the LM-pool prefill cell does not apply to a CTC model
      continue
    out.append(shape)
  return out
