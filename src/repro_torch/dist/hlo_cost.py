"""Cost accounting from the op walk: FLOPs, HBM traffic, collective bytes.

Counterpart of `repro/dist/hlo_cost.py`, with its names. The reference
parses compiled HLO; eager PyTorch has none, so `analyze_walk` builds
the same `CostReport` from the ops an `analysis.op_walk.OpWalk(
keep_trace=True)` recorded while the program ran once (its
`OpRecord`s). A loop runs its body once an iteration, so the walk sees
it unrolled: a microbatched train step or a prompt of decode steps
comes out counted k times, as the reference's trip-count
multiplication does.

Accounting model:
  flops        — dot FLOPs (2 * out_elems * contraction: `mm`, `bmm`,
                 `addmm`, `baddbmm`, the products `einsum` and
                 `matmul` decompose to), convolution FLOPs
                 (`_conv_flops`'s rule); elementwise ops count none.
  hbm_bytes    — operand + result bytes of every op that materialises;
                 views (`FREE_OPS`) and metadata reads are free. Eager
                 mode sends every other op to memory, so this is larger
                 than XLA's fused count for the same program.
  kernel scope — a `dispatch:{regime}:c{id}` scope of a kernel regime
                 is one op: the products its `kernels/ref.py` version
                 computes at the scope's shapes, and its operands' and
                 results' bytes. The ops inside it (the CPU's plain
                 version; nothing on the card, whose kernels are bound
                 through ctypes) are not counted, so a coordinate reads
                 alike on both.
  collectives  — the ops DTensor issues (`_c10d_functional`, and the
                 `c10d` ops of direct `torch.distributed` calls):
                 payload bytes and wire bytes, the payload scaled by
                 `_wire_factor` for the op's group size. Under DTensor
                 the walk sees each rank's local ops, so every figure is
                 per device.
  unknown_ops  — what could not be accounted, by name: a dtype missing
                 from `_DTYPE_BITS` (its arrays count 0 bytes), an op
                 whose FLOPs are not modelled (linear algebra, FFTs), an
                 op of an unknown namespace, a kernel launched outside
                 its scope (ctypes: no op stands for it).

`roofline_from_report` turns a CostReport into the three roofline time
terms under the card below and names the dominant one.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Optional

# The card the roofline is drawn for: one NVIDIA H100 80GB HBM3 (SXM5)
# at its 700 W power limit, the peaks of NVIDIA's H100 datasheet (dense,
# no sparsity) — the same as the kernels' bounds in PERF.md §6.
PEAK_FLOPS = 989e12          # FLOP/s, bf16 tensor cores
HBM_BANDWIDTH = 3.35e12      # B/s, HBM3
NVLINK_BANDWIDTH = 450e9     # B/s a direction: NVLink 4's 900 GB/s total

# Sizes are in *bits* so sub-byte dtypes (int4, uint4) stay integral:
# each array's bit volume is rounded up to whole bytes once, per array,
# the way a packed buffer is actually allocated (the reference's
# `_shape_bytes` rule; `array_bytes`).
_DTYPE_BITS = {
    "bool": 8, "uint8": 8, "int8": 8, "int16": 16, "uint16": 16,
    "int32": 32, "uint32": 32, "int64": 64, "uint64": 64,
    "float16": 16, "bfloat16": 16, "float32": 32, "float64": 64,
    "complex64": 64, "complex128": 128, "int4": 4, "uint4": 4,
    "quint4x2": 4, "quint2x4": 2,
    "float8_e4m3fn": 8, "float8_e5m2": 8, "float8_e4m3fnuz": 8,
    "float8_e5m2fnuz": 8,
}

#: op name -> collective kind, for `_c10d_functional` and `c10d`
COLLECTIVE_KIND = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce", "allreduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "broadcast": "collective-broadcast", "broadcast_": "collective-broadcast",
}

#: ops that neither move HBM bytes nor compute: views, allocations that
#: write nothing, metadata, and a collective's wait
FREE_OPS = frozenset({
    "view", "_unsafe_view", "t", "transpose", "permute", "expand",
    "squeeze", "unsqueeze", "slice", "select", "detach", "alias",
    "as_strided", "unbind", "split", "split_with_sizes", "chunk",
    "narrow", "diagonal", "view_as_real", "view_as_complex", "unfold",
    "expand_as", "view_as", "_reshape_alias", "lift_fresh",
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "wait_tensor", "device", "sym_size",
    "sym_stride", "sym_numel", "sym_storage_offset", "is_contiguous",
    "_has_compatible_shallow_copy_type", "record_stream",
})

#: aten products: (lhs, rhs) operand positions
DOT_OPERANDS = {"mm": (0, 1), "bmm": (0, 1), "addmm": (1, 2),
                "baddbmm": (1, 2), "_int_mm": (0, 1), "mv": (0, 1),
                "addmv": (1, 2), "dot": (0, 1)}

#: namespaces whose ops the model above covers
_KNOWN_NS = ("aten", "prim", "_c10d_functional", "c10d")

#: the kernel regimes (one CUDA kernel each)
KERNEL_REGIMES = ("decode_matvec", "lowrank_gemm", "int8_gemm", "gru_cell",
                  "flash_attention")


def dtype_name(dtype) -> str:
  return str(dtype).replace("torch.", "")


def array_bytes(shape, dtype) -> Optional[int]:
  """Whole bytes of one array of `shape` and `dtype` (a torch dtype or
  its name); None where the dtype has no entry in `_DTYPE_BITS`."""
  bits = _DTYPE_BITS.get(dtype if isinstance(dtype, str)
                         else dtype_name(dtype))
  if bits is None:
    return None
  return (math.prod(shape) * bits + 7) // 8


def _wire_factor(kind: str, group_size: int) -> float:
  """Per-device wire bytes per payload byte on a ring of `group_size`."""
  if group_size <= 1:
    return 0.0
  n = float(group_size)
  if "all-reduce" in kind:
    return 2.0 * (n - 1.0) / n
  if "all-gather" in kind or "reduce-scatter" in kind:
    return (n - 1.0) / n
  return 1.0                       # all-to-all / permutes / broadcast


def dot_flops(out_shape, lhs_shape, contracting=(-1,)) -> float:
  """2 * out_elems * contraction: the reference's `_dot_flops` rule, the
  contraction being the product of lhs's `contracting` dims."""
  contract = 1.0
  for i in contracting:
    contract *= lhs_shape[i]
  return 2.0 * math.prod(out_shape) * contract


def conv_flops(out_shape, kernel_shape, o_index: int = 0) -> float:
  """2 * out_elems * (kernel_elems / output features): the reference's
  `_conv_flops` rule. torch's weights are OIHW, so `o_index` is 0."""
  o_dim = kernel_shape[o_index] if kernel_shape else 1
  return 2.0 * math.prod(out_shape) * (math.prod(kernel_shape)
                                       / max(o_dim, 1))


# ---------------------------------------------------------------------------
# Report dataclasses.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CostReport:
  flops: float = 0.0
  dot_flops: float = 0.0
  hbm_bytes: float = 0.0
  collective_bytes: float = 0.0
  collective_wire_bytes: float = 0.0
  n_collectives: int = 0
  collective_by_kind: dict = dataclasses.field(default_factory=dict)
  #: {token: count} of what could not be fully accounted (see the module
  #: docstring): audit tooling surfaces it so gaps are visible instead of
  #: silently under-counting
  unknown_ops: dict = dataclasses.field(default_factory=dict)

  def add(self, other: "CostReport") -> None:
    self.flops += other.flops
    self.dot_flops += other.dot_flops
    self.hbm_bytes += other.hbm_bytes
    self.collective_bytes += other.collective_bytes
    self.collective_wire_bytes += other.collective_wire_bytes
    self.n_collectives += other.n_collectives
    for k, v in other.collective_by_kind.items():
      self.collective_by_kind[k] = self.collective_by_kind.get(k, 0.0) + v
    for k, v in other.unknown_ops.items():
      self.unknown_ops[k] = self.unknown_ops.get(k, 0) + v

  def unknown(self, key: str) -> None:
    self.unknown_ops[key] = self.unknown_ops.get(key, 0) + 1


@dataclasses.dataclass(frozen=True)
class Roofline:
  compute_s: float
  memory_s: float
  collective_s: float
  dominant: str                    # "compute" | "memory" | "collective"
  useful_flop_fraction: float
  roofline_fraction: float


def roofline_from_report(rep: CostReport,
                         model_flops: Optional[float] = None) -> Roofline:
  """The three roofline time terms under the card's peaks.

  `model_flops` (the analytic 6ND/2ND estimate, per device) feeds
  useful_flop_fraction — how much of the executed FLOP volume is model
  math rather than remat/overhead."""
  compute_s = rep.flops / PEAK_FLOPS
  memory_s = rep.hbm_bytes / HBM_BANDWIDTH
  collective_s = rep.collective_wire_bytes / NVLINK_BANDWIDTH
  terms = {"compute": compute_s, "memory": memory_s,
           "collective": collective_s}
  dominant = max(terms, key=terms.get)
  total = compute_s + memory_s + collective_s
  useful = (model_flops / rep.flops if model_flops and rep.flops
            else (rep.dot_flops / rep.flops if rep.flops else 0.0))
  return Roofline(
      compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
      dominant=dominant,
      useful_flop_fraction=useful,
      roofline_fraction=terms[dominant] / total if total else 0.0)


# ---------------------------------------------------------------------------
# Per-op rules.
# ---------------------------------------------------------------------------

def _rows(shape) -> int:
  return math.prod(shape[:-1])


def scope_flops(regime: str, fields: dict) -> float:
  """The products a kernel scope's `kernels/ref.py` version computes at
  its shapes (`fields`: {operand name: shape}):

    decode_matvec, int8_gemm   2 m k n (w or w_q), or 2 m (k r + r n)
                               for factored int8 (u_q, v_q)
    lowrank_gemm               2 m (k r + r n)
    gru_cell                   2 b H 3H, the recurrent h @ U
    flash_attention            4 b h s t d, its two products
  """
  if regime == "flash_attention":
    b, s, h, d = fields["q"]
    t = fields["k"][1]
    return 4.0 * b * h * s * t * d
  if regime == "gru_cell":
    k, n = fields["w"]
    return 2.0 * _rows(fields["h"]) * k * n
  m = _rows(fields["x"])
  u = fields.get("u", fields.get("u_q"))
  if u is not None:
    v = fields.get("v", fields.get("v_q"))
    return 2.0 * m * (u[0] * u[1] + v[0] * v[1])
  w = fields.get("w", fields.get("w_q"))
  return 2.0 * m * w[0] * w[1]


def _op_flops(rec) -> tuple[float, float]:
  """(flops, dot_flops) of one aten op record."""
  name = rec.op
  if name in DOT_OPERANDS:
    li, _ = DOT_OPERANDS[name]
    lhs = rec.ins[li][0]
    out = rec.outs[0][0] if rec.outs else ()
    f = dot_flops(out, lhs) if lhs else 0.0
    return f, f
  if name == "convolution":
    return conv_flops(rec.outs[0][0], rec.ins[1][0]), 0.0
  if name == "convolution_backward":
    grad_out, inp, weight = (s for s, _ in rec.ins[:3])
    per = conv_flops(grad_out, weight)
    n = sum(1 for s, _ in rec.outs if s in (inp, weight))
    return per * n, 0.0
  return 0.0, 0.0


def _uncosted(rec) -> bool:
  """An op that computes but whose FLOPs are not modelled."""
  n = rec.op
  return (rec.ns == "aten" and (n.startswith(("_linalg", "linalg_", "_fft",
                                              "fft_"))
                                or n in ("cholesky", "triangular_solve")))


def op_cost(rec) -> CostReport:
  """The CostReport of one `OpRecord` of the walk."""
  rep = CostReport()
  for _, dtype in rec.ins + rec.outs:
    if dtype not in _DTYPE_BITS:
      rep.unknown(f"dtype:{dtype}")
  if rec.ns == "scope":
    regime = rec.op.split(":")[1]
    f = scope_flops(regime, dict(rec.fields))
    rep.flops = rep.dot_flops = f
    rep.hbm_bytes = rec.in_bytes + rec.out_bytes
    return rep
  if rec.ns == "launch":
    rep.unknown(f"launch:{rec.op}")
    return rep
  if rec.ns not in _KNOWN_NS:
    rep.unknown(f"op:{rec.ns}.{rec.op}")
  elif _uncosted(rec):
    rep.unknown(f"op:{rec.ns}.{rec.op}")
  kind = COLLECTIVE_KIND.get(rec.op) if rec.ns in ("_c10d_functional",
                                                   "c10d") else None
  if kind is not None:
    payload = max(rec.in_bytes, rec.out_bytes)
    wire = payload * _wire_factor(kind, rec.group or 1)
    rep.collective_bytes = payload
    rep.collective_wire_bytes = wire
    rep.n_collectives = 1
    rep.collective_by_kind[kind] = wire
  if rec.op in FREE_OPS or rec.free:
    return rep
  rep.flops, rep.dot_flops = _op_flops(rec)
  rep.hbm_bytes = rec.in_bytes + rec.out_bytes
  return rep


def analyze_walk(records: Iterable) -> CostReport:
  """The CostReport of a walked program: `records` are the `OpRecord`s
  of an `OpWalk(keep_trace=True)`'s `result.trace`. Under DTensor every
  figure is per device (the walk records each rank's local ops)."""
  total = CostReport()
  for rec in records:
    total.add(op_cost(rec))
  return total
