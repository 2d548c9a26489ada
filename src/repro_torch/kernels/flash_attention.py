"""flash_attention — launcher of `csrc/flash_attention.cu` (blockwise
online-softmax attention, causal or not, f32 statistics, output in the
input dtype).

Replaces the Pallas kernel `repro/kernels/flash_attention.py:62`. The
(b, s, h, d) layout is read in place (the TPU wrapper's transpose to
(b*h, s, d) is a full copy) and ragged sequence lengths are masked in
the kernel, so no length needs to divide a block. The design note heads
the CUDA source.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

#: head widths the kernel is instantiated for
HEAD_DIMS = (64, 128)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
  """q, k, v: (b, s, h, d) of one float type (f32 or bf16) on one CUDA
  device, kv heads already repeated; d in HEAD_DIMS."""
  _build.require("flash_attention", q, k, v)
  code = _build.dtype_code("flash_attention", q, k, v)
  if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
    raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k "
                     f"{tuple(k.shape)}, v {tuple(v.shape)}")
  b, s, h, d = q.shape
  if d not in HEAD_DIMS:
    raise ValueError(f"flash_attention: head width {d} not in {HEAD_DIMS}")
  # the kernel reads 16-byte vectors: a view off a 16-byte boundary is
  # copied to a fresh (aligned) buffer
  q, k, v = (t if t.is_contiguous() and t.data_ptr() % 16 == 0
             else t.contiguous().clone() for t in (q, k, v))
  out = torch.empty_like(q)
  with torch.cuda.device(q.device):
    err = _build.library().rk_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h, d,
        int(causal), code, _build.stream(q))
  _build.check(err, "flash_attention")
  return out
