#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

  python3 chip_smoke.py          # from the repository root; needs one GPU

1. Prints the card (`nvidia-smi` name and power limit), the torch and CUDA
   versions, and builds the four CUDA kernels from `src/repro_torch/
   kernels/csrc/` (nvcc, one process per source, into `build/kernels/`).
2. Holds each kernel against its plain PyTorch version (`kernels/ref.py`)
   on the card at every full-width `deepspeech2-wsj` shape the serving
   path launches it with, at batch 1, 4 and 16 in bf16 (and once in f32):
   bf16 within atol = rtol = 1e-2 (one bf16 rounding of the output is
   2^-8 relative), f32 within 1e-4 (summation order), int8 bit for bit.
   Times the kernel, the plain version and the PyTorch library call with
   CUDA events (median of 50 launches, queued behind a device sleep so
   the host does not starve the card; weights warm in the 50 MB L2, as in
   the frame step, whose ~39 MB of weights fit there) and prints one JSON
   line per kernel and shape.
3. Serves the full-width config (bf16, random weights from seed 0) with
   4 slots and 8 utterances of 17..64 frames, through
   `StreamingSpeechServer`, three times: dense, factored (rank 256 on
   every leaf `FactorizationPlan()` matches) and PTQ'd int8 — each with
   the "cuda" policy and again with the "plain" policy on the card. It
   requires every expected kernel's launch count to rise and no other,
   the routing log to equal the expected table, the per-frame log-probs
   of the two policies to agree (dense/factored within atol 0.05, see
   `SERVE_ATOL`; PTQ'd exactly) and PTQ'd labels to be equal.
4. Prints `{"kernels": [...]}` with each kernel's numbers, then, as the
   last line, `{"ok": true, "device": {...}}`. Any failure raises: the
   script exits non-zero and prints no result line.
"""
from __future__ import annotations

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
}


def fail(msg: str) -> None:
  raise RuntimeError(msg)


def card_line() -> str:
  out = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      capture_output=True, text=True, check=True, timeout=60)
  return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 50) -> float:
  """Median device time of one call of `fn`, by CUDA events around each
  of `reps` calls. The calls are queued behind a device sleep, so the
  card runs them back to back instead of waiting on the host."""
  fn()
  torch.cuda.synchronize()
  ev = [(torch.cuda.Event(enable_timing=True),
         torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
  torch.cuda._sleep(100_000_000)
  for start, end in ev:
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

def kernel_cases(dense, fact, quant, gen):
  """(kernel, shape label, batch, dtype, kernel fn, plain fn, library fn
  or None, bytes, ops, exact) for every full-width shape of the path."""
  from repro_torch.core.factored import iter_factored_leaves, iter_gemm_leaves
  from repro_torch.kernels import ref
  from repro_torch.kernels.decode_matvec import decode_matvec
  from repro_torch.kernels.gru_cell import gru_cell
  from repro_torch.kernels.int8_gemm import int8_gemm
  from repro_torch.kernels.lowrank_gemm import lowrank_gemm

  bf16 = torch.bfloat16
  leaves = {leaf.name: leaf for leaf in iter_factored_leaves(dense)}
  cases = []
  for b in BATCHES:
    for name, leaf in leaves.items():
      if name.endswith("/rec") or name == "out":
        continue                       # rec -> gru_cell; out -> plain
      w = leaf.w
      m, n = w.shape
      x = randn((b, m), gen, bf16)
      cases.append(("decode_matvec", f"{name} {m}x{n}", b, bf16,
                    lambda x=x, w=w: decode_matvec(x, w),
                    lambda x=x, w=w: ref.decode_matvec(x, w),
                    lambda x=x, w=w: torch.matmul(x, w),
                    2 * (b * m + m * n + b * n), 2 * b * m * n, False))
    for i in range(3):
      u = dense.grus[f"gru{i}"].rec.w
      hid = u.shape[0]
      xw = randn((b, 3 * hid), gen, bf16)
      h = randn((b, hid), gen, bf16, 0.5)
      bias = randn((3 * hid,), gen, torch.float32, 0.1)
      cases.append(("gru_cell", f"gru{i}/rec {hid}x{3 * hid}", b, bf16,
                    lambda a=(xw, h, u, bias): gru_cell(*a),
                    lambda a=(xw, h, u, bias): ref.gru_cell(*a), None,
                    2 * (b * 3 * hid + 2 * b * hid + 3 * hid * hid)
                    + 4 * 3 * hid, 6 * b * hid * hid, False))
    for leaf in iter_factored_leaves(fact):
      if not leaf.is_factored:
        continue
      u, v = leaf.u, leaf.v
      (m, r), n = u.shape, v.shape[1]
      x = randn((b, m), gen, bf16)
      cases.append(("lowrank_gemm", f"{leaf.name} {m}x{r}x{n}", b, bf16,
                    lambda a=(x, u, v): lowrank_gemm(*a),
                    lambda a=(x, u, v): ref.lowrank_gemm(*a),
                    lambda x=x, u=u, v=v: torch.matmul(torch.matmul(x, u), v),
                    2 * (b * m + m * r + r * n + b * n),
                    2 * b * r * (m + n), False))
    for leaf in iter_gemm_leaves(quant):
      wq, ws = leaf.w_q, leaf.w_scale
      m, n = wq.shape
      xq, xs = ref.quantize_rowwise(randn((b, m), gen, bf16))

      def int_mm(xq=xq, wq=wq):
        return torch._int_mm(xq, wq)
      try:
        int_mm()
      except RuntimeError:             # _int_mm refuses batch <= 16
        int_mm = None
      cases.append(("int8_gemm", f"{leaf.name} {m}x{n}", b, torch.int8,
                    lambda a=(xq, wq, xs, ws): int8_gemm(*a),
                    lambda a=(xq, wq, xs, ws): ref.int8_gemm(*a), int_mm,
                    b * m + m * n + 4 * (b + n + b * n), 2 * b * m * n, True))
  # f32 once per float kernel: the kernels take f32 as well as bf16
  f32 = torch.float32
  x, w = randn((4, 640), gen, f32), randn((640, 2304), gen, f32, 0.04)
  u, v = randn((640, 256), gen, f32, 0.06), randn((256, 2304), gen, f32, 0.06)
  g = (randn((4, 2304), gen, f32), randn((4, 768), gen, f32, 0.5),
       randn((768, 2304), gen, f32, 0.04), randn((2304,), gen, f32, 0.1))
  cases += [
      ("decode_matvec", "f32 640x2304", 4, f32, lambda: decode_matvec(x, w),
       lambda: ref.decode_matvec(x, w), None, 0, 0, False),
      ("lowrank_gemm", "f32 640x256x2304", 4, f32,
       lambda: lowrank_gemm(x, u, v), lambda: ref.lowrank_gemm(x, u, v),
       None, 0, 0, False),
      ("gru_cell", "f32 768x2304", 4, f32, lambda: gru_cell(*g),
       lambda: ref.gru_cell(*g), None, 0, 0, False),
  ]
  return cases


def check_kernels(dense, fact, quant) -> list[dict]:
  gen = torch.Generator().manual_seed(1)
  rows = []
  for (kernel, label, b, dtype, fn, plain, lib, nbytes, ops,
       exact) in kernel_cases(dense, fact, quant, gen):
    got, want = fn(), plain()
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
      fail(f"{kernel} {label} b={b}: {got.shape}/{got.dtype} vs "
           f"{want.shape}/{want.dtype}")
    err = (got.float() - want.float()).abs()
    max_err = float(err.max())
    if exact:
      ok = torch.equal(got, want)
    else:
      tol = TOL[dtype]
      ok = bool(torch.isfinite(got.float()).all()) and \
          bool((err <= tol + tol * want.float().abs()).all())
    if not ok:
      fail(f"{kernel} {label} b={b} {dtype}: disagrees with its plain "
           f"version (max |err| {max_err:.3g})")
    row = dict(kernel=kernel, shape=label, batch=b, dtype=str(dtype),
               max_abs_err=max_err)
    if nbytes:                          # the path's shapes: timed
      bnd, by = bound_ms(nbytes, ops, dtype)
      row.update(kernel_ms=time_ms(fn), plain_ms=time_ms(plain),
                 library_ms=time_ms(lib) if lib is not None else None,
                 bound_ms=bnd, bound_by=by)
    print(json.dumps(row), flush=True)
    rows.append(row)
  return rows


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


def summarize(rows: list[dict], launches: dict) -> list[dict]:
  """One entry per kernel: the times of one frame step at the server's
  batch (the sum over the kernel's launches in that step), the largest
  error over every compared shape, and the main path's launch count."""
  out = []
  for name, (source, replaces) in KERNELS.items():
    mine = [r for r in rows if r["kernel"] == name]
    step = [r for r in mine if r["batch"] == SERVE_BATCH and "kernel_ms" in r]
    libs = [r["library_ms"] for r in step]
    out.append(dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=launches[name],
        max_abs_err=max(r["max_abs_err"] for r in mine),
        ms=sum(r["kernel_ms"] for r in step),
        plain_ms=sum(r["plain_ms"] for r in step),
        bound_ms=sum(r["bound_ms"] for r in step),
        bound_by="bytes" if all(r["bound_by"] == "bytes" for r in step)
        else "operations",
        library_ms=sum(libs) if libs and None not in libs else None,
        shapes_per_step=len(step)))
  return out


def main() -> int:
  if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device", file=sys.stderr)
    return 2
  from repro_torch import configs
  from repro_torch.kernels import _build

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

  cfg = configs.get_config("deepspeech2-wsj")
  forms = build_forms(cfg)
  rows = check_kernels(forms["dense"], forms["factored"], forms["int8"])
  print(json.dumps({"kernels_checked": sorted(KERNELS)}), flush=True)
  launches = check_serving(cfg, forms, card)
  if not all(n > 0 for n in launches.values()):
    fail(f"a kernel never launched on the main path: {launches}")
  if not all(math.isfinite(r["max_abs_err"]) for r in rows):
    fail("non-finite kernel error")
  print(card, flush=True)
  print(json.dumps({"kernels": summarize(rows, launches)}), flush=True)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
