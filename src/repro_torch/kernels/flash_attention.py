"""flash_attention — launcher of `csrc/flash_attention.cu` (blockwise
online-softmax attention, causal or not, f32 statistics, output in the
input dtype).

Replaces the Pallas kernel `repro/kernels/flash_attention.py:62`. The
(b, s, h, d) layout is read in place (the TPU wrapper's transpose to
(b*h, s, d) is a full copy), GQA kv heads are read in place (q head j
reads kv head j // (h // h_kv); nothing is repeated), and ragged
sequence lengths are masked in the kernel, so no length needs to divide a
block. The bf16 kernel loads through TMA, which wants 16-byte aligned
bases: a bf16 operand that does not start on one is copied into a fresh
buffer first, as a non-contiguous operand is. The f32 kernel reads
scalars and takes any contiguous operand. The design note heads
the CUDA source.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

#: head widths the kernel is instantiated for (80: stablelm-3b; 112:
#: zamba2-7b's shared attention block)
HEAD_DIMS = (64, 80, 112, 128)


def flash_supported(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> bool:
  """Whether `flash_attention` is built for these operands: a head width
  in HEAD_DIMS. The routing decision of
  `kernels.dispatch.maybe_flash_attention`; a pure function of shapes, so
  the CPU can test it."""
  return q.shape[-1] in HEAD_DIMS


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
  """q: (b, s, h, d); k, v: (b, s, h_kv, d) with h % h_kv == 0 (GQA: q
  head j reads kv head j // (h // h_kv)); one float type (f32 or bf16),
  one CUDA device; d in HEAD_DIMS. Returns (b, s, h, d) in q's type."""
  _build.require("flash_attention", q, k, v)
  code = _build.dtype_code("flash_attention", q, k, v)
  if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape or \
      k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3] or \
      q.shape[2] % k.shape[2]:
    raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k "
                     f"{tuple(k.shape)}, v {tuple(v.shape)}")
  b, s, h, d = q.shape
  if d not in HEAD_DIMS:
    raise ValueError(f"flash_attention: head width {d} not in {HEAD_DIMS}")
  # TMA (bf16) wants 16-byte aligned bases; a fresh buffer has one
  q, k, v = (t.clone() if t.is_contiguous() and t.dtype == torch.bfloat16
             and t.data_ptr() % 16 else t.contiguous() for t in (q, k, v))
  out = torch.empty_like(q)
  with torch.cuda.device(q.device):
    err = _build.library().rk_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h,
        k.shape[2], d, int(causal), code, _build.stream(q))
  _build.check(err, "flash_attention")
  return out
