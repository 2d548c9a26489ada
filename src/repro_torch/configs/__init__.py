"""Architecture registry of the port: the paper's deepspeech2-wsj, the
dense transformers (chameleon-34b, llama3-8b, glm4-9b, stablelm-3b,
qwen3-4b), the Mamba2 hybrid zamba2-7b, the DeepSeek family
(deepseek-v2-lite, deepseek-v3-671b) and whisper-small, in the
reference's order.

  get_config(name)  — full config
  get_smoke(name)   — reduced same-family config (CPU-runnable)
"""
from __future__ import annotations

from repro_torch.configs import (chameleon_34b, deepseek_v2_lite,
                                 deepseek_v3_671b, deepspeech2_wsj, glm4_9b,
                                 llama3_8b, qwen3_4b, stablelm_3b,
                                 whisper_small, zamba2_7b)
from repro_torch.layers.common import ModelConfig

_MODULES = {
    "chameleon-34b": chameleon_34b,
    "llama3-8b": llama3_8b,
    "glm4-9b": glm4_9b,
    "stablelm-3b": stablelm_3b,
    "qwen3-4b": qwen3_4b,
    "zamba2-7b": zamba2_7b,
    "deepseek-v2-lite": deepseek_v2_lite,
    "deepseek-v3-671b": deepseek_v3_671b,
    "whisper-small": whisper_small,
    "deepspeech2-wsj": deepspeech2_wsj,
}

ARCH_NAMES = list(_MODULES)

__all__ = ["ARCH_NAMES", "ModelConfig", "get_config", "get_smoke"]


def get_config(name: str) -> ModelConfig:
  return _MODULES[name].CONFIG


def get_smoke(name: str) -> ModelConfig:
  return _MODULES[name].SMOKE
