#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

  python3 chip_smoke.py          # from the repository root; needs one GPU

1. Prints the card (`nvidia-smi` name and power limit), the torch and CUDA
   versions, and builds the five CUDA kernels from `src/repro_torch/
   kernels/csrc/` (nvcc, one process per source, into `build/kernels/`).
2. Holds each kernel against its plain PyTorch version (`kernels/ref.py`)
   on the card at every full-width `deepspeech2-wsj` shape the serving
   path launches it with, at batch 1, 4 and 16 in bf16 (and once in f32);
   `decode_matvec` and `lowrank_gemm` also at ragged shapes (m and n off
   every tile and vector width) at batch 1, 4, 5, 16 and 17 in bf16 and
   f32, `lowrank_gemm` there also with a plan forced to several waves of
   blocks, alone and beside a long product on a second stream (its ticket
   order cannot deadlock), `int8_gemm` at ragged and unaligned shapes (m
   off every quad, n off every lane's columns, w_q rows off a 16-byte
   boundary), `gru_cell` at ragged H (200 off its unit tile; 333 and 1030
   off a 16-byte row of U) at batch 1, 4, 5, 16 and 17 in bf16 and f32,
   also with k ranges of 8 rows, alone and beside a busy stream, every
   `gru_cell` case called twice (the calls must agree bit for bit: its
   split-K sums run in a fixed order); `decode_matvec` at the full-width
   `llama3-8b` decode shapes at batch 4, and `flash_attention` at the
   prefill's grouped-kv (1, 4096, 32 q / 8 kv heads, 128) (k and v not
   repeated; the plain version repeats them), at (1, 4096, 32, 128), at (1, 32768, 32, 128)
   (its plain version by query-row chunks) and at (1, 1024, 32, 128)
   causal bf16, once causal in f32 and once non-causal at a ragged
   (1, 1500, 12, 64) in bf16: bf16 within atol = rtol = 1e-2 (one bf16
   rounding of the output is 2^-8 relative), f32 within 1e-4 (summation
   order), int8 bit for bit; `flash_attention` also row by row against
   each row's own scale (`FLASH_ROW_RTOL`). Times the kernel, the plain
   version and the PyTorch library call (`torch.matmul`,
   `scaled_dot_product_attention` on the (b, h, s, d) transpose, with
   `enable_gqa` for grouped kv heads, ...) with CUDA events (median of
   20-50 launches, queued behind a device sleep so the host does not
   starve the card) and prints one JSON line per kernel and shape;
   `int8_gemm` has no one-call library equivalent at b <= 16 and gets a
   yardstick instead, `torch._int_mm` on x_q zero-padded to 32 rows, no
   dequant (`int_mm_padded_ms`), and `gru_cell` (no PyTorch call has its
   gate order) `torch.matmul(h, U)`, the recurrent product without the
   gates (`matmul_h_u_ms`). Then it traces one `lowrank_gemm` call
   at the largest factored leaf with `torch.profiler` and requires exactly
   one device kernel (the fused launch). Weights
   that fit stay warm in the 50 MB L2 across those launches; at the
   `llama3-8b` decode shapes `decode_matvec` and `torch.matmul` are also
   timed cold, with the L2 evicted before every timed call by reading a
   256 MB buffer (outside the events), as a real decode step finds them;
   so are `gru_cell` and its yardstick at the DS2 shapes at batch 4.
3. Serves the full-width config (bf16, random weights from seed 0) with
   4 slots and 8 utterances of 17..64 frames, through
   `StreamingSpeechServer`, three times: dense, factored (rank 256 on
   every leaf `FactorizationPlan()` matches) and PTQ'd int8 — each with
   the "cuda" policy and again with the "plain" policy on the card. It
   requires every expected kernel's launch count to rise and no other,
   the routing log to equal the expected table, the per-frame log-probs
   of the two policies to agree (dense/factored within atol 0.05, see
   `SERVE_ATOL`; PTQ'd exactly) and PTQ'd labels to be equal.
4. Prefill: full-width `llama3-8b` (bf16, random weights from a seeded
   CUDA generator), `transformer.forward(last_only=True)` on one
   4096-token prompt under the "cuda" and the "plain" policy. Requires
   exactly 32 `flash_attention` launches (one a layer) and one
   `decode_matvec` (the head at the last position; the layers' GEMMs have
   a flat batch of 4096 and stay plain) for the kernel run, none for the
   plain run, last-position log-probs within
   `PREFILL_ATOL`, and equal greedy tokens unless the plain run's top-2
   gap is below that tolerance. Prints prefill tokens/s for each.
5. Serving: `LMEngine` on the same weights, 4 slots, 8 requests with
   prompts of 4..16 tokens and budgets of 1..16 drawn as `launch.serve`
   draws them, greedy. Correctness: a recorded "plain" run, and a
   recorded "cuda" run fed the plain run's sampled tokens (teacher
   forcing), so every call of both sees the same inputs; every call's
   live log-probs must agree within `LM_SERVE_ATOL`, and their argmax may
   differ only where the plain run's top-2 gap is below it. Requires every
   GEMM of the "cuda" runs to route to `decode_matvec` (225 launches a
   step: 32 layers x 7 GEMMs and the head) and no launch under "plain".
   Then one run of each policy with no hooks prints tok/s and TTFT p50:
   smoke readings of a tiny mix, not serving metrics. Last, it times a
   batch-4 decode step with `LayerStack.layers()`'s per-layer views kept
   and with them rebuilt, and `layers()` alone.
6. Prints `{"kernels": [...]}` with each kernel's numbers, all measured
   in this run but the computed bounds, then, as the last line,
   `{"ok": true, "device": {...}}`. Any failure raises: the script exits
   non-zero and prints no result line.

On an H100 the build takes about 30 s (nvcc, the five sources in
parallel) and phases 2-5 under a minute.
"""
from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

#: published H100 SXM peaks (NVIDIA data sheet; dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12,
                  torch.int8: 1979e12}
BATCHES = (1, 4, 16)
SERVE_BATCH = 4
#: per-frame log-prob agreement of the "cuda" and "plain" policies in
#: bf16. The two round at different places (the kernels keep hu and the
#: rank intermediate in f32; the plain path rounds them to bf16) and the
#: difference travels through the recurrence (measured: <= 5e-3 on an
#: H100 at full width, 8 utterances).
SERVE_ATOL = 0.05
TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
#: flash_attention is also held row by row to the row's own scale: a late
#: causal row averages thousands of rows of v, so its outputs are tens of
#: times smaller than an early row's, and TOL's absolute part says little
#: there. Each output row (one query position of one head) must have max_d |err|
#: <= FLASH_ROW_RTOL * max_d |want|. In bf16 both sides round their f32
#: result once, which differs by at most one ulp of the row's largest
#: value (<= 2^-7 of it); the limit allows a second ulp for the f32 sums
#: (the kernel rounds P to bf16 for the PV product, the plain version
#: does not). Measured on an H100: 2^-7 in every bf16 case, 2e-6 in f32.
FLASH_ROW_RTOL = {torch.bfloat16: 2.0 ** -6, torch.float32: 1e-4}
LM_ARCH = "llama3-8b"
PREFILL_LEN = 4096
#: last-position log-prob agreement of the prefill under the "cuda"
#: (flash kernel) and "plain" (blockwise) policies in bf16: the kernel
#: rounds P to bf16 for the PV product and the plain path does not, and a
#: one-ulp flip travels through 32 layers (measured: 0.086 on an H100 at
#: full width, one 4096-token prompt)
PREFILL_ATOL = 0.25
#: per-call log-prob agreement of the LMEngine under both policies in
#: bf16, both fed the same tokens: the decode_matvec kernel sums in f32 in
#: another order than cuBLAS, and each step's KV rows carry the difference
#: forward (measured: 0.117 on an H100 at full width over all 100 calls)
LM_SERVE_ATOL = 0.25
#: (b, s, h, h_kv, d, causal, dtype, timed): the prefill's shape first
#: (llama3-8b's 8 kv heads, read in place), the same with repeated heads
#: (the shape of the kernel's first version), then the reference's
#: prefill_32k length (its plain version by row chunks)
FLASH_CASES = [(1, PREFILL_LEN, 32, 8, 128, True, torch.bfloat16, True),
               (1, PREFILL_LEN, 32, 32, 128, True, torch.bfloat16, True),
               (1, 32768, 32, 32, 128, True, torch.bfloat16, True),
               (1, 1024, 32, 32, 128, True, torch.bfloat16, True),
               (1, 1500, 12, 12, 64, False, torch.bfloat16, True),
               (1, 512, 8, 8, 128, True, torch.float32, False)]
#: (m, n) and (m, r, n) off every tile and vector width, at RAGGED_BATCHES
RAGGED_MATVEC = [(1000, 700), (4100, 1030), (333, 130)]
RAGGED_LOWRANK = [(1000, 130, 700), (333, 72, 1030)]
RAGGED_INT8 = [(37, 13), (640, 2304), (1536, 32), (37, 2304), (1536, 13)]
#: gru_cell's hidden sizes off the unit tile (200) and off a 16-byte row
#: of U (333, 1030: scalar loads)
RAGGED_GRU = (200, 333, 1030)
RAGGED_BATCHES = (1, 4, 5, 16, 17)
#: rows x_q is zero-padded to for int8_gemm's torch._int_mm yardstick
#: (it refuses 16 rows or fewer)
INT_MM_ROWS = 32
#: the L2 is evicted before each cold timed call by reading this many bytes
L2_FLUSH_BYTES = 256 << 20
LM_GEMMS = ("attn_q", "attn_k", "attn_v", "attn_o", "ffn_gate", "ffn_up",
            "ffn_down")
KERNELS = {
    # name: (CUDA source, the TPU kernel it replaces)
    "gru_cell": ("src/repro_torch/kernels/csrc/gru_cell.cu",
                 "src/repro/kernels/gru_cell.py:36"),
    "decode_matvec": ("src/repro_torch/kernels/csrc/decode_matvec.cu",
                      "src/repro/kernels/decode_matvec.py:38"),
    "lowrank_gemm": ("src/repro_torch/kernels/csrc/lowrank_gemm.cu",
                     "src/repro/kernels/lowrank_gemm.py:44"),
    "int8_gemm": ("src/repro_torch/kernels/csrc/int8_gemm.cu",
                  "src/repro/kernels/int8_gemm.py:41"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:62"),
}


def fail(msg: str) -> None:
  raise RuntimeError(msg)


def card_line() -> str:
  out = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      capture_output=True, text=True, check=True, timeout=60)
  return out.stdout.strip().splitlines()[0]


_FLUSH = []


def flush_l2() -> None:
  """Evict the L2 (50 MB on an H100) by reading a larger buffer: what
  stays is clean lines of that buffer, so the next kernel's reads come
  from device memory and cause no write-backs."""
  if not _FLUSH:
    _FLUSH.append(torch.ones(L2_FLUSH_BYTES // 4, device="cuda"))
  torch.amax(_FLUSH[0])


def time_ms(fn, reps: int = 50, cold: bool = False) -> float:
  """Median device time of one call of `fn`, by CUDA events around each
  of `reps` calls. The calls are queued behind a device sleep, so the
  card runs them back to back instead of waiting on the host. cold:
  evict the L2 before each call (outside the events)."""
  fn()
  torch.cuda.synchronize()
  ev = [(torch.cuda.Event(enable_timing=True),
         torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
  torch.cuda._sleep(100_000_000)
  for start, end in ev:
    if cold:
      flush_l2()
    start.record()
    fn()
    end.record()
  torch.cuda.synchronize()
  return statistics.median(s.elapsed_time(e) for s, e in ev)


def bound_ms(nbytes: int, ops: int, dtype) -> tuple[float, str]:
  t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
  t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
  return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def randn(shape, gen, dtype, scale=1.0):
  return (torch.randn(shape, generator=gen) * scale).to("cuda", dtype)


# ---------------------------------------------------------------------------
# Phase 2: each kernel against its plain version.
# ---------------------------------------------------------------------------

def case(kernel, label, b, dtype, fn, plain, lib=None, nbytes=0, ops=0,
         exact=False, path=None, weight=1, reps=50, cold=False,
         yardstick=None, stable=False):
  """One comparison. `path` names the main path whose per-step sums the
  case feeds ("ds2" frame step, "lm_decode" step, "lm_prefill" call);
  `weight` is its launches in one step; nbytes/ops give the bound; `reps`
  the timed calls of each version; `cold` also times the kernel, the
  library call and the yardstick with the L2 evicted before each call;
  `yardstick` is (name, fn): a PyTorch call timed beside the kernel that
  does not compute the same function, reported as `<name>_ms`
  (int8_gemm's `torch._int_mm` at 32 rows, no dequant: "int_mm_padded";
  gru_cell's `torch.matmul(h, U)`, the product without the gates:
  "matmul_h_u"); `stable`: a second call must give the same bits."""
  return dict(kernel=kernel, label=label, batch=b, dtype=dtype, fn=fn,
              plain=plain, lib=lib, nbytes=nbytes, ops=ops, exact=exact,
              path=path, weight=weight, reps=reps, cold=cold,
              yardstick=yardstick, stable=stable)


_BUSY: list = []


def beside_busy_stream(fn):
  """fn() on the current stream while a second stream runs eight f32
  4096 x 4096 products (tens of ms on every SM) that it does not wait
  for."""
  if not _BUSY:
    _BUSY.append((torch.cuda.Stream(), torch.ones(4096, 4096, device="cuda")))
  side, a = _BUSY[0]
  side.wait_stream(torch.cuda.current_stream())
  with torch.cuda.stream(side):
    for _ in range(8):
      a @ a
  return fn()


def chunked_attention(q, k, v, rows: int = 2048):
  """`ref.flash_attention` (causal) by query-row chunks: row block
  [r0, r1) against keys [0, r1), each block's f32 scores whole. At
  s = 32768 the unchunked score matrix would take 137 GB. k and v have
  as many heads as q."""
  s, d = q.shape[1], q.shape[-1]
  out = torch.empty_like(q)
  pos = torch.arange(s, device=q.device)
  for r0 in range(0, s, rows):
    r1 = min(s, r0 + rows)
    sc = torch.einsum("bqhd,bkhd->bhqk", q[:, r0:r1].float(),
                      k[:, :r1].float()) / (d ** 0.5)
    sc = sc.masked_fill(pos[None, :r1] > pos[r0:r1, None], float("-inf"))
    out[:, r0:r1] = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(sc, -1),
                                 v[:, :r1].float()).to(q.dtype)
  return out


def kernel_cases(dense, fact, quant, lm, gen):
  """Every full-width shape of the paths, for each kernel."""
  from repro_torch.core.factored import iter_factored_leaves, iter_gemm_leaves
  from repro_torch.kernels import ref
  from repro_torch.kernels.decode_matvec import decode_matvec
  from repro_torch.kernels.flash_attention import flash_attention
  from repro_torch.kernels.gru_cell import _launch as gru_launch
  from repro_torch.kernels.gru_cell import gru_cell
  from repro_torch.kernels.gru_cell import plan as gru_plan
  from repro_torch.kernels.int8_gemm import int8_gemm
  from repro_torch.kernels.lowrank_gemm import _launch as lowrank_launch
  from repro_torch.kernels.lowrank_gemm import lowrank_gemm, lowrank_plan

  bf16 = torch.bfloat16
  leaves = {leaf.name: leaf for leaf in iter_factored_leaves(dense)}
  cases = []
  for b in BATCHES:
    path = "ds2" if b == SERVE_BATCH else None
    for name, leaf in leaves.items():
      if name.endswith("/rec") or name == "out":
        continue                       # rec -> gru_cell; out -> plain
      w = leaf.w
      m, n = w.shape
      x = randn((b, m), gen, bf16)
      cases.append(case("decode_matvec", f"{name} {m}x{n}", b, bf16,
                        lambda x=x, w=w: decode_matvec(x, w),
                        lambda x=x, w=w: ref.decode_matvec(x, w),
                        lambda x=x, w=w: torch.matmul(x, w),
                        2 * (b * m + m * n + b * n), 2 * b * m * n,
                        path=path))
    for i in range(3):
      u = dense.grus[f"gru{i}"].rec.w
      hid = u.shape[0]
      xw = randn((b, 3 * hid), gen, bf16)
      h = randn((b, hid), gen, bf16, 0.5)
      bias = randn((3 * hid,), gen, torch.float32, 0.1)
      # no PyTorch call computes the gates; the yardstick is the
      # recurrent product alone
      cases.append(case("gru_cell", f"gru{i}/rec {hid}x{3 * hid}", b, bf16,
                        lambda a=(xw, h, u, bias): gru_cell(*a),
                        lambda a=(xw, h, u, bias): ref.gru_cell(*a), None,
                        2 * (b * 3 * hid + 2 * b * hid + 3 * hid * hid)
                        + 4 * 3 * hid, 6 * b * hid * hid, path=path,
                        cold=b == SERVE_BATCH, stable=True,
                        yardstick=("matmul_h_u",
                                   lambda h=h, u=u: torch.matmul(h, u))))
    for leaf in iter_factored_leaves(fact):
      if not leaf.is_factored:
        continue
      u, v = leaf.u, leaf.v
      (m, r), n = u.shape, v.shape[1]
      x = randn((b, m), gen, bf16)
      cases.append(case("lowrank_gemm", f"{leaf.name} {m}x{r}x{n}", b, bf16,
                        lambda a=(x, u, v): lowrank_gemm(*a),
                        lambda a=(x, u, v): ref.lowrank_gemm(*a),
                        lambda x=x, u=u, v=v: torch.matmul(torch.matmul(x, u),
                                                           v),
                        2 * (b * m + m * r + r * n + b * n),
                        2 * b * r * (m + n), path=path))
    for leaf in iter_gemm_leaves(quant):
      wq, ws = leaf.w_q, leaf.w_scale
      m, n = wq.shape
      xq, xs = ref.quantize_rowwise(randn((b, m), gen, bf16))
      # torch._int_mm refuses batch <= 16: its yardstick pads x_q to 32
      # zero rows (outside the timed call) and leaves out the dequant
      xq32 = torch.zeros((INT_MM_ROWS, m), dtype=torch.int8, device="cuda")
      xq32[:b] = xq
      cases.append(case("int8_gemm", f"{leaf.name} {m}x{n}", b, torch.int8,
                        lambda a=(xq, wq, xs, ws): int8_gemm(*a),
                        lambda a=(xq, wq, xs, ws): ref.int8_gemm(*a), None,
                        b * m + m * n + 4 * (b + n + b * n), 2 * b * m * n,
                        exact=True, path=path,
                        yardstick=("int_mm_padded",
                                   lambda a=xq32, w=wq: torch._int_mm(a, w))))
  # decode_matvec at the LM's decode shapes: layer 0's GEMMs (the other 31
  # layers have the same shapes) and the head, at the engine's batch
  b = SERVE_BATCH
  layers = lm.dense_layers.layers()
  n_layers = len(layers)
  layer0 = [layers[0]["attn"][k] for k in ("wq", "wk", "wv", "wo")] + [
      layers[0]["ffn"][k] for k in ("w_gate", "w_up", "w_down")]
  lm_leaves = [(f"layers/{g}", leaf.w, n_layers)
               for g, leaf in zip(LM_GEMMS, layer0)]
  lm_leaves.append(("lm_head", lm.embedding.head.w, 1))
  for name, w, weight in lm_leaves:
    m, n = w.shape
    x = randn((b, m), gen, bf16)
    cases.append(case("decode_matvec", f"{name} {m}x{n}", b, bf16,
                      lambda x=x, w=w: decode_matvec(x, w),
                      lambda x=x, w=w: ref.decode_matvec(x, w),
                      lambda x=x, w=w: torch.matmul(x, w),
                      2 * (b * m + m * n + b * n), 2 * b * m * n,
                      path="lm_decode", weight=weight, cold=True))
  # ragged shapes (not timed): every lane width, tile edge and batch tile
  for dtype in (bf16, torch.float32):
    for b in RAGGED_BATCHES:
      for m, n in RAGGED_MATVEC:
        x, w = randn((b, m), gen, dtype), randn((m, n), gen, dtype, 0.05)
        cases.append(case("decode_matvec", f"ragged {m}x{n}", b, dtype,
                          lambda x=x, w=w: decode_matvec(x, w),
                          lambda x=x, w=w: ref.decode_matvec(x, w)))
      for m, r, n in RAGGED_LOWRANK:
        x = randn((b, m), gen, dtype)
        u, v = randn((m, r), gen, dtype, 0.05), randn((r, n), gen, dtype, 0.1)
        cases.append(case("lowrank_gemm", f"ragged {m}x{r}x{n}", b, dtype,
                          lambda a=(x, u, v): lowrank_gemm(*a),
                          lambda a=(x, u, v): ref.lowrank_gemm(*a)))
        # several waves of blocks (k ranges of 8 rows), alone and while a
        # long product holds SMs on a second stream: the ticket order
        # keeps the fused launch from deadlocking
        p = dataclasses.replace(
            lowrank_plan(b, m, r, n, w_bytes=x.element_size()),
            split1=math.ceil(m / 8), kper1=8, split2=math.ceil(r / 8),
            kper2=8)
        cases.append(case("lowrank_gemm", f"oversubscribed {m}x{r}x{n}", b,
                          dtype, lambda a=(x, u, v), p=p: lowrank_launch(*a,
                                                                        p),
                          lambda a=(x, u, v): ref.lowrank_gemm(*a)))
        cases.append(case("lowrank_gemm", f"beside a busy stream {m}x{r}x{n}",
                          b, dtype,
                          lambda a=(x, u, v), p=p: beside_busy_stream(
                              lambda: lowrank_launch(*a, p)),
                          lambda a=(x, u, v): ref.lowrank_gemm(*a)))
      for hid in RAGGED_GRU:
        g = (randn((b, 3 * hid), gen, dtype), randn((b, hid), gen, dtype, 0.5),
             randn((hid, 3 * hid), gen, dtype, 0.05),
             randn((3 * hid,), gen, torch.float32, 0.1))
        cases.append(case("gru_cell", f"ragged H={hid}", b, dtype,
                          lambda g=g: gru_cell(*g),
                          lambda g=g: ref.gru_cell(*g), stable=True))
        # k ranges of 8 rows (several waves of blocks at the larger H
        # and batches), alone and beside a long product on a second
        # stream: no block waits on another
        p = dataclasses.replace(gru_plan(b, hid, w_bytes=g[1].element_size()),
                                lanes=8, split=math.ceil(hid / 8),
                                k_per_split=8)
        cases.append(case("gru_cell", f"k ranges of 8 rows H={hid}", b,
                          dtype, lambda g=g, p=p: gru_launch(*g, p),
                          lambda g=g: ref.gru_cell(*g), stable=True))
        cases.append(case("gru_cell", f"beside a busy stream H={hid}", b,
                          dtype, lambda g=g, p=p: beside_busy_stream(
                              lambda: gru_launch(*g, p)),
                          lambda g=g: ref.gru_cell(*g), stable=True))
    # int8_gemm at ragged shapes: m off every quad, n off every lane's
    # columns, rows of w_q off a 16-byte boundary (a view one byte in)
    for b in RAGGED_BATCHES:
      for m, n in RAGGED_INT8:
        xq, xs = ref.quantize_rowwise(randn((b, m), gen, torch.float32))
        wq, ws = ref.quantize_colwise(randn((m, n), gen, torch.float32))
        flat = torch.zeros(m * n + 1, dtype=torch.int8, device="cuda")
        flat[1:] = wq.flatten()
        for label, w in (("ragged", wq), ("unaligned", flat[1:].view(m, n))):
          cases.append(case("int8_gemm", f"{label} {m}x{n}", b, torch.int8,
                            lambda a=(xq, w, xs, ws): int8_gemm(*a),
                            lambda a=(xq, wq, xs, ws): ref.int8_gemm(*a),
                            exact=True))
  for b, s, h, h_kv, d, causal, dtype, timed in FLASH_CASES:
    q = randn((b, s, h, d), gen, dtype)
    k, v = (randn((b, s, h_kv, d), gen, dtype) for _ in range(2))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    pairs = s * (s + 1) // 2 if causal else s * s
    size = torch.finfo(dtype).bits // 8
    long = s > PREFILL_LEN
    heads = f"{h}" if h == h_kv else f"{h}/{h_kv}"
    cases.append(case(
        "flash_attention",
        f"{'causal' if causal else 'non-causal'} ({b}, {s}, {heads}, {d})",
        b, dtype, lambda a=(q, k, v), c=causal: flash_attention(*a, causal=c),
        (lambda a=(q, k, v): chunked_attention(*a)) if long else
        (lambda a=(q, k, v), c=causal: ref.flash_attention(*a, causal=c)),
        lambda a=(qt, kt, vt), c=causal, g=h != h_kv:
        F.scaled_dot_product_attention(*a, is_causal=c, enable_gqa=g),
        2 * b * s * (h + h_kv) * d * size if timed else 0,
        4 * b * h * d * pairs,
        path="lm_prefill" if s == PREFILL_LEN and h_kv < h else None,
        weight=n_layers, reps=5 if long else 20))
  # f32 once per GEMM kernel: the kernels take f32 as well as bf16
  f32 = torch.float32
  x, w = randn((4, 640), gen, f32), randn((640, 2304), gen, f32, 0.04)
  u, v = randn((640, 256), gen, f32, 0.06), randn((256, 2304), gen, f32, 0.06)
  g = (randn((4, 2304), gen, f32), randn((4, 768), gen, f32, 0.5),
       randn((768, 2304), gen, f32, 0.04), randn((2304,), gen, f32, 0.1))
  cases += [
      case("decode_matvec", "f32 640x2304", 4, f32, lambda: decode_matvec(x, w),
           lambda: ref.decode_matvec(x, w)),
      case("lowrank_gemm", "f32 640x256x2304", 4, f32,
           lambda: lowrank_gemm(x, u, v), lambda: ref.lowrank_gemm(x, u, v)),
      case("gru_cell", "f32 768x2304", 4, f32, lambda: gru_cell(*g),
           lambda: ref.gru_cell(*g), stable=True),
  ]
  return cases


def check_kernels(dense, fact, quant, lm) -> list[dict]:
  gen = torch.Generator().manual_seed(1)
  rows = []
  for c in kernel_cases(dense, fact, quant, lm, gen):
    kernel, label, b, dtype = c["kernel"], c["label"], c["batch"], c["dtype"]
    got, want = c["fn"](), c["plain"]()
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
      fail(f"{kernel} {label} b={b}: {got.shape}/{got.dtype} vs "
           f"{want.shape}/{want.dtype}")
    err = (got.float() - want.float()).abs()
    max_err = float(err.max())
    row = dict(kernel=kernel, shape=label, batch=b, dtype=str(dtype),
               max_abs_err=max_err, path=c["path"], weight=c["weight"])
    if c["stable"]:
      again = c["fn"]()
      if not torch.equal(got, again):
        fail(f"{kernel} {label} b={b} {dtype}: two calls differ")
      del again
    if c["exact"]:
      ok = torch.equal(got, want)
    else:
      tol = TOL[dtype]
      ok = bool(torch.isfinite(got.float()).all()) and \
          bool((err <= tol + tol * want.float().abs()).all())
    if kernel == "flash_attention":   # (b, s, h, d): rows of d values
      ratio = float((err.amax(-1) / want.float().abs().amax(-1)).max())
      row["max_row_err_ratio"] = ratio
      if ratio > FLASH_ROW_RTOL[dtype]:
        fail(f"{kernel} {label} {dtype}: a row's max |err| is {ratio:.3g} "
             f"of its max |value| (limit {FLASH_ROW_RTOL[dtype]:.3g})")
    del got, want, err
    if not ok:
      fail(f"{kernel} {label} b={b} {dtype}: disagrees with its plain "
           f"version (max |err| {max_err:.3g})")
    if c["nbytes"]:                     # the paths' shapes: timed
      reps = c["reps"]
      bnd, by = bound_ms(c["nbytes"], c["ops"], dtype)
      row.update(kernel_ms=time_ms(c["fn"], reps),
                 plain_ms=time_ms(c["plain"], reps),
                 library_ms=(time_ms(c["lib"], reps) if c["lib"] is not None
                             else None),
                 bound_ms=bnd, bound_by=by)
      if c["cold"]:
        row["kernel_cold_ms"] = time_ms(c["fn"], reps, cold=True)
        if c["lib"] is not None:
          row["library_cold_ms"] = time_ms(c["lib"], reps, cold=True)
      if c["yardstick"] is not None:
        name, fn = c["yardstick"]
        row["yardstick"] = name
        row[f"{name}_ms"] = time_ms(fn, reps)
        if c["cold"]:
          row[f"{name}_cold_ms"] = time_ms(fn, reps, cold=True)
    print(json.dumps(row), flush=True)
    rows.append(row)
  return rows


def check_one_lowrank_launch(fact) -> dict:
  """One lowrank_gemm call at the largest factored DS2 leaf, batch 4,
  bf16, traced with torch.profiler: the fused kernel must be the call's
  only device activity (kernel, memset or memcpy)."""
  from torch.profiler import ProfilerActivity, profile

  from repro_torch.core.factored import iter_factored_leaves
  from repro_torch.kernels.lowrank_gemm import lowrank_gemm
  leaf = max((lf for lf in iter_factored_leaves(fact) if lf.is_factored),
             key=lambda lf: lf.u.numel() + lf.v.numel())
  gen = torch.Generator().manual_seed(2)
  x = randn((SERVE_BATCH, leaf.u.shape[0]), gen, torch.bfloat16)
  lowrank_gemm(x, leaf.u, leaf.v)     # its counters exist before the trace
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    lowrank_gemm(x, leaf.u, leaf.v)
    torch.cuda.synchronize()
  trace = ROOT / "build" / "lowrank_gemm_trace.json"
  trace.parent.mkdir(parents=True, exist_ok=True)
  prof.export_chrome_trace(str(trace))
  device = [(e.get("cat"), e.get("name")) for e in
            json.loads(trace.read_text())["traceEvents"]
            if e.get("cat") in ("kernel", "gpu_memset", "gpu_memcpy")]
  if len(device) != 1 or device[0][0] != "kernel" or \
      "lowrank" not in device[0][1]:
    fail(f"lowrank_gemm {leaf.name}: {len(device)} device activities in one "
         f"call, not one fused kernel: {device}")
  out = dict(lowrank_gemm_one_call=leaf.name,
             shape=[SERVE_BATCH, *leaf.u.shape, leaf.v.shape[1]],
             device_activities=len(device), kernel=device[0][1])
  print(json.dumps(out), flush=True)
  return out


# ---------------------------------------------------------------------------
# Phase 3: the main path — the streaming server at full width.
# ---------------------------------------------------------------------------

EXPECTED_ROUTES = {
    "dense": lambda name: ("gru_cell" if name.endswith("/rec") else
                           "jnp" if name == "out" else "decode_matvec"),
    "factored": lambda name: "jnp" if name == "out" else "lowrank_gemm",
    "int8": lambda name: "int8_gemm",
}
EXPECTED_KERNELS = {"dense": {"gru_cell", "decode_matvec"},
                    "factored": {"lowrank_gemm"}, "int8": {"int8_gemm"}}


def utterances(cfg) -> list[np.ndarray]:
  """8 utterances of 17..64 frames, drawn as `launch.serve` draws them."""
  from repro_torch.data.speech import SpeechDataConfig, batch_at
  dc = SpeechDataConfig(vocab_size=cfg.vocab_size, feat_dim=cfg.feat_dim,
                        global_batch=SERVE_BATCH)
  rng = np.random.RandomState(0)
  out = []
  for i in range(2 * SERVE_BATCH):
    row = batch_at(dc, i)["feats"][i % SERVE_BATCH]
    out.append(row[:int(rng.randint(17, min(64, row.shape[0]) + 1))])
  return out


def serve(cfg, params, utts, policy: str):
  """One fleet run; returns (results, per-step (mask, log-probs), seconds,
  launches, routing log)."""
  from repro_torch.kernels import dispatch, ops
  from repro_torch.serving.engine import StreamingSpeechServer
  srv = StreamingSpeechServer(cfg, params, batch_size=SERVE_BATCH,
                              kernel_policy=policy)
  srv.submit(utts[0][:24])              # warm-up: cuDNN, allocator, build
  srv.run(chunk_frames=16)
  steps = []
  step = srv._frame_step

  def recording_step(x, active):
    lp = step(x, active)
    steps.append((active, lp))
    return lp
  srv._frame_step = recording_step
  for u in utts:
    srv.submit(u)
  torch.cuda.synchronize()
  ops.reset_launches()
  with dispatch.record_dispatch() as log:
    t0 = time.perf_counter()
    results = srv.run(chunk_frames=16)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
  launches = dict(ops.LAUNCHES)
  return results, steps, dt, launches, set(log)


def check_serving(cfg, forms: dict, card: str) -> dict:
  utts = utterances(cfg)
  frames = sum(len(u) for u in utts)
  total = {k: 0 for k in KERNELS}
  for form, params in forms.items():
    res_k, steps_k, dt_k, launches, routes = serve(cfg, params, utts, "cuda")
    res_p, steps_p, dt_p, plain_launches, _ = serve(cfg, params, utts,
                                                    "plain")
    # routing and launches
    names = {name for name, _ in routes}
    want_routes = {(n, EXPECTED_ROUTES[form](n)) for n in names}
    if routes != want_routes or len(names) != 8:
      fail(f"{form}: routing {sorted(routes)} != {sorted(want_routes)}")
    for k, n in launches.items():
      if (n > 0) != (k in EXPECTED_KERNELS[form]):
        fail(f"{form}: kernel {k} launched {n} times on the main path")
      total[k] += n
    if any(plain_launches.values()):
      fail(f"{form}: the plain policy launched {plain_launches}")
    # outputs
    if len(res_k) != len(utts) or len(steps_k) != len(steps_p):
      fail(f"{form}: {len(res_k)} results, {len(steps_k)} vs "
           f"{len(steps_p)} steps")
    max_diff = 0.0
    for (mk, lk), (mp, lp) in zip(steps_k, steps_p):
      if not torch.equal(mk, mp) or lk.shape != (SERVE_BATCH, cfg.vocab_size):
        fail(f"{form}: step masks or shapes differ")
      a, b = lk[mk], lp[mp]
      if not bool(torch.isfinite(a).all()):
        fail(f"{form}: non-finite log-probs")
      max_diff = max(max_diff, float((a - b).abs().max()))
    atol = 0.0 if form == "int8" else SERVE_ATOL
    if max_diff > atol:
      fail(f"{form}: per-frame log-probs differ by {max_diff:.3g} > {atol}")
    lab_k = {r.uid: r.labels for r in res_k}
    lab_p = {r.uid: r.labels for r in res_p}
    same = sum(lab_k[u] == lab_p[u] for u in lab_k)
    if form == "int8" and same != len(lab_k):
      fail(f"int8: labels differ between policies ({same}/{len(lab_k)})")
    print(json.dumps(dict(
        serve=form, card=card, utterances=len(utts), frames=frames,
        decode_steps=len(steps_k), launches=launches,
        cuda_streams_per_s=len(utts) / dt_k, cuda_frames_per_s=frames / dt_k,
        plain_streams_per_s=len(utts) / dt_p,
        plain_frames_per_s=frames / dt_p,
        max_logprob_diff=max_diff, labels_equal=f"{same}/{len(lab_k)}")),
        flush=True)
  return total


def build_forms(cfg):
  from repro_torch.core.compress import FactorizationPlan
  from repro_torch.core.factored import factored, map_factored_leaves
  from repro_torch.models.deepspeech import init_model
  from repro_torch.quant import quantize_params
  gen = torch.Generator().manual_seed(0)
  dense = init_model(cfg, generator=gen, device="cuda")
  plan = FactorizationPlan()

  def to_rank_256(leaf):
    if not plan.matches(leaf):
      return leaf
    return factored(leaf.in_dim, leaf.out_dim, 256, name=leaf.name,
                    group=leaf.group, dtype=cfg.dtype, generator=gen,
                    device="cuda")
  return {"dense": dense, "factored": map_factored_leaves(to_rank_256, dense),
          "int8": quantize_params(dense)}


# ---------------------------------------------------------------------------
# Phase 4: the prefill — full-width llama3-8b through the flash kernel.
# ---------------------------------------------------------------------------

def build_lm(cfg):
  from repro_torch.models.transformer import init_lm
  gen = torch.Generator(device="cuda").manual_seed(0)
  return init_lm(cfg, generator=gen, device="cuda")


def check_prefill(lm, cfg, card) -> dict:
  """forward(last_only=True) on one 4096-token prompt under both
  policies; returns the kernel run's launches."""
  from repro_torch.kernels import dispatch, ops
  from repro_torch.models.transformer import forward
  toks = torch.from_numpy(np.random.RandomState(0).randint(
      1, cfg.vocab_size, size=(1, PREFILL_LEN))).to("cuda")
  runs = {}
  for policy in ("cuda", "plain"):
    pol = dispatch.resolve_policy(policy)
    forward(lm, toks[:, :256], cfg, last_only=True, policy=pol)  # warm-up
    torch.cuda.synchronize()
    ops.reset_launches()
    with dispatch.record_dispatch() as log:
      t0 = time.perf_counter()
      logits = forward(lm, toks, cfg, last_only=True, policy=pol)
      torch.cuda.synchronize()
      dt = time.perf_counter() - t0
    runs[policy] = (torch.log_softmax(logits[0, -1].float(), dim=-1), dt,
                    dict(ops.LAUNCHES), set(log))
  (lp_k, dt_k, launches, routes), (lp_p, dt_p, plain_launches, _) = \
      runs["cuda"], runs["plain"]
  # one flash call a layer; the layer GEMMs (flat batch 4096) stay plain,
  # and the head, narrowed to the last position, is a batch-1 GEMM
  want = {k: 0 for k in launches}
  want.update(flash_attention=cfg.num_layers, decode_matvec=1)
  if launches != want:
    fail(f"prefill: launches {launches} != {want}")
  if any(plain_launches.values()):
    fail(f"prefill: the plain policy launched {plain_launches}")
  want_routes = {(f"layers/{g}", "jnp") for g in LM_GEMMS} | {
      ("lm_head", "decode_matvec"), ("layers/attn", "flash_attention")}
  if routes != want_routes:
    fail(f"prefill: routing {sorted(routes)}")
  if lp_k.shape != (cfg.vocab_size,) or not bool(torch.isfinite(lp_k).all()):
    fail("prefill: log-probs of the wrong shape or not finite")
  diff = float((lp_k - lp_p).abs().max())
  if diff > PREFILL_ATOL:
    fail(f"prefill: last-position log-probs differ by {diff:.3g} > "
         f"{PREFILL_ATOL}")
  top2 = torch.topk(lp_p, 2).values
  gap = float(top2[0] - top2[1])
  tok_k, tok_p = int(lp_k.argmax()), int(lp_p.argmax())
  if tok_k != tok_p and gap >= PREFILL_ATOL:
    fail(f"prefill: greedy tokens {tok_k} != {tok_p} at a top-2 gap of "
         f"{gap:.3g}")
  print(json.dumps(dict(
      prefill=cfg.name, card=card, tokens=PREFILL_LEN, launches=launches,
      cuda_prefill_s=dt_k, cuda_prefill_tokens_per_s=PREFILL_LEN / dt_k,
      plain_prefill_s=dt_p, plain_prefill_tokens_per_s=PREFILL_LEN / dt_p,
      max_logprob_diff=diff, plain_top2_gap=gap, greedy_cuda=tok_k,
      greedy_plain=tok_p)), flush=True)
  return launches


# ---------------------------------------------------------------------------
# Phase 5: LMEngine on the same weights.
# ---------------------------------------------------------------------------

def lm_requests(cfg) -> list:
  """8 requests: prompts of 4..16 tokens, budgets of 1..16, drawn as
  `launch.serve` draws them (mean prompt length 8, --steps 16)."""
  rng = np.random.RandomState(0)
  reqs = []
  for _ in range(2 * SERVE_BATCH):
    prompt = rng.randint(1, cfg.vocab_size, size=(rng.randint(4, 17),))
    reqs.append((prompt, int(rng.randint(1, 17))))
  return reqs


def lm_engine(lm, cfg, policy: str):
  """An LMEngine at SERVE_BATCH slots, warmed up and reset."""
  from repro_torch.serving.engine import LMEngine
  eng = LMEngine(cfg, lm, batch_size=SERVE_BATCH, max_len=64,
                 kernel_policy=policy, device=lm.final_norm.device)
  eng.submit(np.arange(1, 5), max_new_tokens=2)
  eng.run()
  eng.reset()
  return eng


def timed_run(eng, reqs):
  """One greedy run with no hooks; returns (finished, seconds, launches).
  The launch counts are zeroed just before the run and read just after."""
  from repro_torch.kernels import ops
  for prompt, budget in reqs:
    eng.submit(prompt, max_new_tokens=budget)
  torch.cuda.synchronize()
  ops.reset_launches()
  t0 = time.perf_counter()
  finished = eng.run(temperature=0.0)
  torch.cuda.synchronize()
  dt = time.perf_counter() - t0
  launches = dict(ops.LAUNCHES)
  eng.reset()
  return finished, dt, launches


def recorded_run(eng, reqs, forced=None):
  """One greedy run that keeps each `decode_step` call's (tokens,
  positions, log-probs) and each sampled batch. With `forced` (another
  run's sampled batches) the engine is fed those instead of its own
  (teacher forcing), so every call sees the other run's inputs. Returns
  (calls, sampled, launches, routing log)."""
  from repro_torch.kernels import dispatch, ops
  calls, sampled = [], []
  step, sample = eng._step, eng._sample

  def rec_step(state, tokens, positions):
    logits, state = step(state, tokens, positions)
    calls.append((tokens, positions,
                  torch.log_softmax(logits[:, -1].float(), dim=-1)))
    return logits, state

  def rec_sample(logits, temperature):
    sampled.append(sample(logits, temperature))
    return sampled[-1] if forced is None else forced[len(sampled) - 1]
  eng._step, eng._sample = rec_step, rec_sample
  for prompt, budget in reqs:
    eng.submit(prompt, max_new_tokens=budget)
  ops.reset_launches()
  try:
    with dispatch.record_dispatch() as log:
      eng.run(temperature=0.0)
  finally:
    del eng._step, eng._sample
  launches = dict(ops.LAUNCHES)
  eng.reset()
  return calls, sampled, launches, set(log)


def time_layer_views(lm, cfg, reps: int = 10) -> dict:
  """Host cost of the per-layer views that `LayerStack.layers()` keeps:
  a batch-4 decode step under the "cuda" policy with the views kept, and
  with them dropped before the step (which then builds 7 x 32 leaf
  modules again), alternated; and `layers()` alone. Medians, ms."""
  from repro_torch.kernels import dispatch
  from repro_torch.models.transformer import decode_step, init_decode_state
  pol = dispatch.resolve_policy("cuda", SERVE_BATCH)
  state = init_decode_state(cfg, SERVE_BATCH, 64, device="cuda")
  tok = torch.ones((SERVE_BATCH, 1), dtype=torch.int64, device="cuda")
  pos = torch.arange(4, 4 + SERVE_BATCH, device="cuda")
  stack = lm.dense_layers
  out = {"step_views_kept": [], "step_views_rebuilt": [], "build_views": []}
  decode_step(lm, state, tok, pos, cfg, pol)
  for _ in range(reps):
    for key in out:
      if key != "step_views_kept":
        stack._views = None           # as if the views were not kept
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      if key == "build_views":
        stack.layers()
      else:
        decode_step(lm, state, tok, pos, cfg, pol)
      torch.cuda.synchronize()
      out[key].append((time.perf_counter() - t0) * 1e3)
  return {f"{k}_ms": statistics.median(v) for k, v in out.items()}


def check_lm_serving(lm, cfg, card) -> dict:
  """Correctness: a recorded plain run, and a recorded kernel run fed the
  plain run's tokens, compared call by call. Throughput: one run of each
  policy with no hooks. Returns the hook-free kernel run's launches."""
  reqs = lm_requests(cfg)
  eng_k, eng_p = lm_engine(lm, cfg, "cuda"), lm_engine(lm, cfg, "plain")
  calls_p, sampled_p, plain_launches, plain_routes = recorded_run(eng_p, reqs)
  calls_k, _, forced_launches, routes = recorded_run(eng_k, reqs,
                                                     forced=sampled_p)
  fin_k, dt_k, launches = timed_run(eng_k, reqs)
  fin_p, dt_p, plain_launches_t = timed_run(eng_p, reqs)
  names = {f"layers/{g}" for g in LM_GEMMS} | {"lm_head"}
  if routes != {(n, "decode_matvec") for n in names}:
    fail(f"LM serving: routing {sorted(routes)}")
  if plain_routes != {(n, "jnp") for n in names}:
    fail(f"LM serving: plain routing {sorted(plain_routes)}")
  per_step = cfg.num_layers * len(LM_GEMMS) + 1
  for what, got in (("recorded", forced_launches), ("timed", launches)):
    want = {k: per_step * len(calls_p) if k == "decode_matvec" else 0
            for k in got}
    if got != want:
      fail(f"LM serving ({what}): launches {got} != {want} "
           f"({len(calls_p)} steps)")
  if any(plain_launches.values()) or any(plain_launches_t.values()):
    fail(f"LM serving: the plain policy launched "
         f"{plain_launches} / {plain_launches_t}")
  # every call, both runs fed the same tokens: log-probs agree, and the
  # argmax may differ only at a near-tie of the plain run
  if len(calls_k) != len(calls_p):
    fail(f"LM serving: {len(calls_k)} vs {len(calls_p)} calls")
  max_diff, flips = 0.0, 0
  for i, ((tk, pk, lk), (tp, pp, lp)) in enumerate(zip(calls_k, calls_p)):
    if not (torch.equal(tk, tp) and torch.equal(pk, pp)):
      fail(f"LM serving: call {i} was fed other tokens or positions")
    # prefill steps (batch 1) are live; a decode step's idle slots sit at
    # position 0, every live one past its prompt
    live = pk > 0 if tk.shape[0] > 1 else torch.ones_like(pk, dtype=bool)
    a, b = lk[live], lp[live]
    if not bool(torch.isfinite(a).all()):
      fail(f"LM serving: non-finite log-probs at call {i}")
    max_diff = max(max_diff, float((a - b).abs().max()))
    if max_diff > LM_SERVE_ATOL:
      fail(f"LM serving: call {i} log-probs differ by {max_diff:.3g}")
    flip = a.argmax(-1) != b.argmax(-1)
    if bool(flip.any()):
      top2 = torch.topk(b[flip], 2, dim=-1).values
      gap = float((top2[:, 0] - top2[:, 1]).max())
      if gap >= LM_SERVE_ATOL:
        fail(f"LM serving: argmax differs at call {i} at a top-2 gap of "
             f"{gap:.3g}")
      flips += int(flip.sum())
  toks_k = {f.uid: f.tokens.tolist() for f in fin_k}
  toks_p = {f.uid: f.tokens.tolist() for f in fin_p}
  if len(fin_k) != len(reqs) or sorted(toks_k) != sorted(toks_p):
    fail("LM serving: not every request finished")
  same = sum(toks_k[u] == toks_p[u] for u in toks_k)

  def ttft_p50(fin):
    t = sorted(f.ttft_s for f in fin)
    return t[len(t) // 2] * 1e3

  n_k = sum(len(t) for t in toks_k.values())
  n_p = sum(len(t) for t in toks_p.values())
  print(json.dumps(dict(
      serve=cfg.name, card=card, requests=len(reqs), slots=SERVE_BATCH,
      steps=len(calls_p), launches=launches,
      cuda_tokens=n_k, cuda_tok_per_s=n_k / dt_k,
      cuda_ttft_p50_ms=ttft_p50(fin_k), plain_tokens=n_p,
      plain_tok_per_s=n_p / dt_p, plain_ttft_p50_ms=ttft_p50(fin_p),
      max_logprob_diff=max_diff, argmax_flips=flips,
      tokens_equal=f"{same}/{len(toks_k)}",
      **time_layer_views(lm, cfg))), flush=True)
  return launches


def _sums(rows: list[dict]) -> dict:
  """Per-step sums of timed rows, each row counted `weight` times (and
  the cold times' sums where every row has them)."""
  libs = [r["library_ms"] for r in rows]
  out = dict(
      ms=sum(r["kernel_ms"] * r["weight"] for r in rows),
      plain_ms=sum(r["plain_ms"] * r["weight"] for r in rows),
      bound_ms=sum(r["bound_ms"] * r["weight"] for r in rows),
      bound_by="bytes" if all(r["bound_by"] == "bytes" for r in rows)
      else "operations",
      library_ms=(sum(x * r["weight"] for x, r in zip(libs, rows))
                  if libs and None not in libs else None))
  if rows and all("kernel_cold_ms" in r for r in rows):
    out["cold_ms"] = sum(r["kernel_cold_ms"] * r["weight"] for r in rows)
    out["library_cold_ms"] = (
        sum(r["library_cold_ms"] * r["weight"] for r in rows)
        if all("library_cold_ms" in r for r in rows) else None)
  names = {r.get("yardstick") for r in rows}
  if len(names) == 1 and None not in names:   # one yardstick for every row
    name = names.pop()
    for key in (f"{name}_ms", f"{name}_cold_ms"):
      if all(key in r for r in rows):
        out[key] = sum(r[key] * r["weight"] for r in rows)
  return out


def ds2_step_ms_by_batch(rows: list[dict], kernel: str,
                         key: str = "kernel_ms") -> dict:
  """`kernel`'s time a deepspeech2-wsj frame step at each timed batch
  (BATCHES): the sum of its timed rows' `key` (or "library_ms") at the
  serving path's shapes. Also takes the rows of an earlier version's
  run, one JSON object a line."""
  out: dict = {}
  for r in rows:
    if r.get("kernel") == kernel and r.get(key) is not None and \
        r.get("path") in (None, "ds2"):
      out[r["batch"]] = out.get(r["batch"], 0.0) + r[key]
  return out


def summarize(rows: list[dict], launches: dict, by_path: dict) -> list[dict]:
  """One entry per kernel, its largest error over every compared shape
  and its launches on the main paths. Times: the DS2 kernels' per frame
  step at the server's batch (summed over the step's launches);
  flash_attention's per call at the prefill's (1, 4096, 32/8, 128), with
  the repeated-heads (1, 4096, 32, 128) beside it; the DS2 kernels add
  their frame step at every timed batch (`ms_by_batch`), decode_matvec
  the llama3-8b decode step at batch 4, warm and cold."""
  out = []
  for name, (source, replaces) in KERNELS.items():
    mine = [r for r in rows if r["kernel"] == name]
    if name == "flash_attention":
      main = [dict(r, weight=1) for r in mine if r["path"] == "lm_prefill"]
      per = ("one call, causal bf16 (1, 4096, 32 q / 8 kv heads, 128); 32 "
             "a prefill")
    else:
      main = [r for r in mine if r["path"] == "ds2"]
      per = "one deepspeech2-wsj frame step at batch 4"
    entry = dict(name=name, route="cuda", source=source, replaces=replaces,
                 launches=launches[name],
                 max_abs_err=max(r["max_abs_err"] for r in mine),
                 **_sums(main), per=per, shapes=len(main),
                 launches_by_path={p: n[name] for p, n in by_path.items()})
    if name == "flash_attention":
      mha = [r for r in mine if r["shape"] == f"causal (1, {PREFILL_LEN}, "
             "32, 128)"]
      entry["repeated_heads_ms"] = mha[0]["kernel_ms"]
    else:
      entry["ms_by_batch"] = ds2_step_ms_by_batch(rows, name)
      for y in sorted({r["yardstick"] for r in mine if "yardstick" in r}):
        entry[f"{y}_ms_by_batch"] = ds2_step_ms_by_batch(rows, name,
                                                         f"{y}_ms")
    lm_step = [r for r in mine if r["path"] == "lm_decode"]
    if lm_step:
      entry["llama3_8b_decode_step"] = _sums(lm_step)
    out.append(entry)
  return out


def main() -> int:
  if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device", file=sys.stderr)
    return 2
  from repro_torch import configs
  from repro_torch.kernels import _build

  t_start = time.perf_counter()
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  card = card_line()
  print(f"card: {card}", flush=True)
  print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}", flush=True)
  _build.library()
  print(f"kernel build: {_build.BUILD_INFO['seconds']:.1f}s -> "
        f"{_build.BUILD_INFO['library']}", flush=True)
  log = _build.BUILD_INFO["log"].splitlines()
  regs = [int(ln.split("Used ")[1].split()[0]) for ln in log
          if "Used " in ln and "registers" in ln]
  spills = [ln.strip() for ln in log
            if "spill stores" in ln and not ln.strip().startswith("0 bytes")]
  print(f"ptxas: {len(regs)} kernel variants, at most {max(regs, default=0)}"
        f" registers a thread, {len(spills)} with spills", flush=True)
  for ln in log:
    if "flash" in ln and ("registers" in ln or "spill" in ln or
                          "Compiling" in ln):
      print(f"ptxas (flash_attention): {ln.strip()}", flush=True)

  cfg = configs.get_config("deepspeech2-wsj")
  lm_cfg = configs.get_config(LM_ARCH)
  forms = build_forms(cfg)
  lm = build_lm(lm_cfg)
  phases = {}
  t0 = time.perf_counter()
  rows = check_kernels(forms["dense"], forms["factored"], forms["int8"], lm)
  phases["2_kernels"] = time.perf_counter() - t0
  print(json.dumps({"kernels_checked": sorted(KERNELS)}), flush=True)
  check_one_lowrank_launch(forms["factored"])
  by_path = {}
  t0 = time.perf_counter()
  by_path["ds2_serving"] = check_serving(cfg, forms, card)
  phases["3_ds2_serving"] = time.perf_counter() - t0
  t0 = time.perf_counter()
  by_path["lm_prefill"] = check_prefill(lm, lm_cfg, card)
  phases["4_prefill"] = time.perf_counter() - t0
  t0 = time.perf_counter()
  by_path["lm_serving"] = check_lm_serving(lm, lm_cfg, card)
  phases["5_lm_serving"] = time.perf_counter() - t0
  launches = {k: sum(n[k] for n in by_path.values()) for k in KERNELS}
  if not all(n > 0 for n in launches.values()):
    fail(f"a kernel never launched on the main paths: {launches}")
  if not all(math.isfinite(r["max_abs_err"]) for r in rows):
    fail("non-finite kernel error")
  phases["total"] = time.perf_counter() - t_start
  print(json.dumps({"phase_seconds": phases}), flush=True)
  print(card, flush=True)
  print(json.dumps({"kernels": summarize(rows, launches, by_path)}),
        flush=True)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
