"""Public wrappers of the CUDA kernels — the counterparts of
`repro.kernels.ops`.

Each wrapper looks at where its tensors lie:
  * on the CPU it runs the kernel's plain version (`kernels.ref`);
  * on a CUDA device it launches the kernel, or raises — there is no
    fallback that hides a failed build or launch.

Each keeps a launch count in `LAUNCHES`, raised by one where the wrapper
launches its kernel and nowhere else, so a run can show that its main
path went through the kernels (`reset_launches()` zeroes them).

No kernel has a backward pass (nor has the reference's), so every
wrapper refuses, on either device, an operand that requires grad while
grad mode is on: a kernel policy inside training would otherwise cut the
autograd graph without a word. Training runs with no policy.

Unlike the reference there is no block table, no (8, 128) padding and no
small-shape fallback: those are TPU tiling. The CUDA kernels take any
shape and mask their own ragged edges.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.decode_matvec import decode_matvec as _decode_matvec
from repro_torch.kernels.flash_attention import \
    flash_attention as _flash_attention
from repro_torch.kernels.gru_cell import gru_cell as _gru_cell
from repro_torch.kernels.int8_gemm import int8_gemm as _int8_gemm
from repro_torch.kernels.lowrank_gemm import lowrank_gemm as _lowrank_gemm

#: decode_matvec's regime contract (paper §4: batch 1..16), which
#: `kernels.dispatch` enforces when it routes
DECODE_BATCH_MAX = 16

#: kernel name -> launches since the last reset_launches()
LAUNCHES: dict[str, int] = {
    "gru_cell": 0, "decode_matvec": 0, "lowrank_gemm": 0, "int8_gemm": 0,
    "flash_attention": 0}


def reset_launches() -> None:
  for name in LAUNCHES:
    LAUNCHES[name] = 0


def _check_no_grad(*tensors: torch.Tensor) -> None:
  if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
    raise RuntimeError(
        "kernel wrappers have no backward: an operand requires grad under "
        "grad mode (train with policy=None, or serve under torch.no_grad())")


def _on_cpu(*tensors: torch.Tensor) -> bool:
  kinds = {t.device.type for t in tensors}
  if kinds == {"cpu"}:
    return True
  if kinds == {"cuda"}:
    return False
  raise ValueError(f"operands on mixed or unsupported devices: {kinds}")


def lowrank_gemm(x: torch.Tensor, u: torch.Tensor,
                 v: torch.Tensor) -> torch.Tensor:
  """y = (x @ U) @ V, rank intermediate in f32; x: (b, m), u: (m, r),
  v: (r, n)."""
  _check_no_grad(x, u, v)
  if _on_cpu(x, u, v):
    return ref.lowrank_gemm(x, u, v)
  y = _lowrank_gemm(x, u, v)
  LAUNCHES["lowrank_gemm"] += 1
  return y


def int8_gemm(x_q: torch.Tensor, w_q: torch.Tensor, x_scale: torch.Tensor,
              w_scale: torch.Tensor) -> torch.Tensor:
  """w8a8 GEMM with fused dequant; returns f32 (b, n)."""
  _check_no_grad(x_q, w_q, x_scale, w_scale)
  if _on_cpu(x_q, w_q, x_scale, w_scale):
    return ref.int8_gemm(x_q, w_q, x_scale, w_scale)
  y = _int8_gemm(x_q, w_q, x_scale, w_scale)
  LAUNCHES["int8_gemm"] += 1
  return y


def quantized_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
  """w8a8 of a float weight: quantize both operands, then int8_gemm.
  The regime an "int8_gemm" override on a float leaf takes; it
  re-quantizes the weight per call (a numerics regime, not a fast one —
  PTQ'd leaves consume stored scales instead)."""
  x_q, x_s = ref.quantize_rowwise(x)
  w_q, w_s = ref.quantize_colwise(w)
  return int8_gemm(x_q, w_q, x_s, w_s).to(x.dtype)


def decode_matvec(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
  """Low-batch y = x @ w; x: (b, m), w: (m, n)."""
  _check_no_grad(x, w)
  if _on_cpu(x, w):
    return ref.decode_matvec(x, w)
  y = _decode_matvec(x, w)
  LAUNCHES["decode_matvec"] += 1
  return y


def gru_cell(xw: torch.Tensor, h: torch.Tensor, u: torch.Tensor,
             bias: torch.Tensor) -> torch.Tensor:
  """Fused GRU step; xw: (b, 3H), h: (b, H), u: (H, 3H), bias: (3H,)."""
  _check_no_grad(xw, h, u, bias)
  if _on_cpu(xw, h, u, bias):
    return ref.gru_cell(xw, h, u, bias)
  y = _gru_cell(xw, h, u, bias)
  LAUNCHES["gru_cell"] += 1
  return y


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
  """Online-softmax attention; q: (b, s, h, d), k, v: (b, s, h_kv, d)
  with h % h_kv == 0 (GQA: the kernel reads kv head j // (h // h_kv) for
  q head j in place; the plain version repeats)."""
  _check_no_grad(q, k, v)
  if _on_cpu(q, k, v):
    return ref.flash_attention(q, k, v, causal=causal)
  y = _flash_attention(q, k, v, causal=causal)
  LAUNCHES["flash_attention"] += 1
  return y
