"""Architecture registry of the port (the DS2 slice: one architecture).

  get_config(name)  — full config
  get_smoke(name)   — reduced same-family config (CPU-runnable)
"""
from __future__ import annotations

from repro_torch.configs import deepspeech2_wsj
from repro_torch.layers.common import ModelConfig

_MODULES = {
    "deepspeech2-wsj": deepspeech2_wsj,
}

ARCH_NAMES = list(_MODULES)

__all__ = ["ARCH_NAMES", "ModelConfig", "get_config", "get_smoke"]


def get_config(name: str) -> ModelConfig:
  return _MODULES[name].CONFIG


def get_smoke(name: str) -> ModelConfig:
  return _MODULES[name].SMOKE
