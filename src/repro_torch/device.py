"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
  """`None` means the GPU. A CUDA request with no GPU present raises; the
  CPU is used only when the caller names it (the tests do)."""
  dev = torch.device("cuda" if device is None else device)
  if dev.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError(
        "no CUDA device is available; pass device='cpu' to run the plain "
        "PyTorch path on the CPU")
  return dev
