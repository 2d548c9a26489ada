"""Architecture registry of the port (deepspeech2-wsj and llama3-8b).

  get_config(name)  — full config
  get_smoke(name)   — reduced same-family config (CPU-runnable)
"""
from __future__ import annotations

from repro_torch.configs import deepspeech2_wsj, llama3_8b
from repro_torch.layers.common import ModelConfig

_MODULES = {
    "deepspeech2-wsj": deepspeech2_wsj,
    "llama3-8b": llama3_8b,
}

ARCH_NAMES = list(_MODULES)

__all__ = ["ARCH_NAMES", "ModelConfig", "get_config", "get_smoke"]


def get_config(name: str) -> ModelConfig:
  return _MODULES[name].CONFIG


def get_smoke(name: str) -> ModelConfig:
  return _MODULES[name].SMOKE
