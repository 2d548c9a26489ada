#!/usr/bin/env python3
"""Compare the port's kernels in two trees on one NVIDIA GPU.

  python3 chip_compare.py OLD_TREE [NEW_TREE]   # NEW_TREE: this checkout

A tree is a checkout of this repository, e.g. `git archive <commit>`
unpacked into a directory that `.gitignore` lists (`build/`). The script
runs the trees in turns, OLD, NEW, NEW, OLD, each run a fresh process
(`--run TREE --out FILE`) that imports `repro_torch` from TREE/src and
builds TREE's kernels into TREE/build/kernels. Each run calls the public
wrappers, which both trees share, on inputs drawn from seeds fixed by
the case's name:

- the full-width `deepspeech2-wsj` frame step's shapes (`build_forms`
  of chip_smoke.py: `decode_matvec` on the unfactored leaves,
  `gru_cell` on the three `rec`, `lowrank_gemm` on the rank-256 leaves,
  `int8_gemm` on the PTQ'd ones) at batch 1, 4 and 16, timed warm; the
  `gru_cell` shapes also cold (L2 evicted before each call) with
  `torch.matmul(h, U)` beside them, warm and cold;
- `decode_matvec` at the `llama3-8b` decode GEMMs at batch 4 (random
  weights of their shapes), timed cold;
- the ragged, unaligned and forced-grid shapes of chip_smoke.py's phase
  2, in bf16 and f32, not timed.

Every output is hashed (its bytes). A run of a tree whose `gru_cell` takes
`stamps` also reads %globaltimer stamps of 20 launches at each DS2 shape:
the launch's span, and the split-K tail of the last block of each unit
tile (its end less its partial sums: the gates included).

The comparison prints, for each kernel and batch, the DS2 frame step's
time in each tree (mean of the tree's two runs; medians of 50 launches
by CUDA events inside a run), the llama3-8b step's, and how many outputs
are bit-identical between the trees; it exits 1 if `decode_matvec`,
`lowrank_gemm` or `int8_gemm` differs anywhere, or a tree's two runs
differ. Everything goes to chiprun_out/compare.json as well.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import math
import statistics
import subprocess
import sys
import zlib
from pathlib import Path

import chip_smoke as cs

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"
#: kernels whose outputs must not change between the trees
UNCHANGED = ("decode_matvec", "lowrank_gemm", "int8_gemm")
STAMP_LAUNCHES = 20


def gen_for(label: str):
  import torch
  return torch.Generator().manual_seed(zlib.crc32(label.encode()))


def digest(t) -> str:
  import torch
  raw = t.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy()
  return hashlib.sha256(raw.tobytes()).hexdigest()[:16]


def cases(forms, lm_cfg):
  """(kernel, label, batch, dtype, fn, plain, timing) for every compared
  shape; timing: None, or dict(path=, weight=, cold=, yardstick=)."""
  import torch

  from repro_torch.core.factored import iter_factored_leaves, iter_gemm_leaves
  from repro_torch.kernels import ref
  from repro_torch.kernels.decode_matvec import decode_matvec
  from repro_torch.kernels.gru_cell import gru_cell
  from repro_torch.kernels.int8_gemm import int8_gemm
  from repro_torch.kernels.lowrank_gemm import _launch as lowrank_launch
  from repro_torch.kernels.lowrank_gemm import lowrank_gemm, lowrank_plan
  bf16, f32 = torch.bfloat16, torch.float32
  out = []

  def add(kernel, label, b, dtype, fn, plain, **timing):
    out.append((kernel, label, b, str(dtype), fn, plain, timing or None))

  dense = {leaf.name: leaf for leaf in iter_factored_leaves(forms["dense"])}
  for b in cs.BATCHES:
    for name, leaf in dense.items():
      if name.endswith("/rec") or name == "out":
        continue
      m = leaf.w.shape[0]
      x = cs.randn((b, m), gen_for(f"dm {name} {b}"), bf16)
      add("decode_matvec", name, b, bf16,
          lambda x=x, w=leaf.w: decode_matvec(x, w),
          lambda x=x, w=leaf.w: ref.decode_matvec(x, w), path="ds2")
    for i in range(3):
      u = forms["dense"].grus[f"gru{i}"].rec.w
      hid = u.shape[0]
      g = gen_for(f"gru{i} {b}")
      a = (cs.randn((b, 3 * hid), g, bf16), cs.randn((b, hid), g, bf16, 0.5),
           u, cs.randn((3 * hid,), g, f32, 0.1))
      add("gru_cell", f"gru{i}/rec", b, bf16, lambda a=a: gru_cell(*a),
          lambda a=a: ref.gru_cell(*a), path="ds2", cold=True,
          yardstick=lambda h=a[1], u=u: torch.matmul(h, u))
    for leaf in iter_factored_leaves(forms["factored"]):
      if not leaf.is_factored:
        continue
      x = cs.randn((b, leaf.u.shape[0]), gen_for(f"lr {leaf.name} {b}"), bf16)
      add("lowrank_gemm", leaf.name, b, bf16,
          lambda x=x, u=leaf.u, v=leaf.v: lowrank_gemm(x, u, v),
          lambda x=x, u=leaf.u, v=leaf.v: ref.lowrank_gemm(x, u, v),
          path="ds2")
    for leaf in iter_gemm_leaves(forms["int8"]):
      m = leaf.w_q.shape[0]
      xq, xs = ref.quantize_rowwise(
          cs.randn((b, m), gen_for(f"i8 {leaf.name} {b}"), bf16))
      a = (xq, leaf.w_q, xs, leaf.w_scale)
      add("int8_gemm", leaf.name, b, torch.int8, lambda a=a: int8_gemm(*a),
          lambda a=a: ref.int8_gemm(*a), path="ds2")
  # llama3-8b's decode GEMMs at batch 4: each layer GEMM 32 times a step
  d, hd = lm_cfg.d_model, lm_cfg.resolved_head_dim
  q, kv = lm_cfg.num_heads * hd, lm_cfg.num_kv_heads * hd
  lm_shapes = [("attn_q", d, q), ("attn_k", d, kv), ("attn_v", d, kv),
               ("attn_o", q, d), ("ffn_gate", d, lm_cfg.d_ff),
               ("ffn_up", d, lm_cfg.d_ff), ("ffn_down", lm_cfg.d_ff, d)]
  lm_shapes = [(n, m, k, lm_cfg.num_layers) for n, m, k in lm_shapes]
  lm_shapes.append(("lm_head", d, lm_cfg.vocab_size, 1))
  cuda_gen = torch.Generator(device="cuda").manual_seed(0)
  for name, m, n, weight in lm_shapes:
    w = (torch.randn((m, n), generator=cuda_gen, device="cuda", dtype=bf16)
         * m ** -0.5)
    x = cs.randn((cs.SERVE_BATCH, m), gen_for(f"lm {name}"), bf16)
    add("decode_matvec", f"llama3-8b {name}", cs.SERVE_BATCH, bf16,
        lambda x=x, w=w: decode_matvec(x, w),
        lambda x=x, w=w: ref.decode_matvec(x, w), path="lm_decode",
        weight=weight, cold=True, yardstick=lambda x=x, w=w: x @ w)
  # ragged, unaligned and forced shapes (not timed)
  for dtype in (bf16, f32):
    for b in cs.RAGGED_BATCHES:
      for m, n in cs.RAGGED_MATVEC:
        g = gen_for(f"ragged dm {m} {n} {b} {dtype}")
        x, w = cs.randn((b, m), g, dtype), cs.randn((m, n), g, dtype, 0.05)
        add("decode_matvec", f"ragged {m}x{n}", b, dtype,
            lambda x=x, w=w: decode_matvec(x, w),
            lambda x=x, w=w: ref.decode_matvec(x, w))
      for m, r, n in cs.RAGGED_LOWRANK:
        g = gen_for(f"ragged lr {m} {r} {n} {b} {dtype}")
        a = (cs.randn((b, m), g, dtype), cs.randn((m, r), g, dtype, 0.05),
             cs.randn((r, n), g, dtype, 0.1))
        add("lowrank_gemm", f"ragged {m}x{r}x{n}", b, dtype,
            lambda a=a: lowrank_gemm(*a), lambda a=a: ref.lowrank_gemm(*a))
        p = dataclasses.replace(
            lowrank_plan(b, m, r, n, w_bytes=a[0].element_size()),
            split1=math.ceil(m / 8), kper1=8, split2=math.ceil(r / 8), kper2=8)
        add("lowrank_gemm", f"oversubscribed {m}x{r}x{n}", b, dtype,
            lambda a=a, p=p: lowrank_launch(*a, p),
            lambda a=a: ref.lowrank_gemm(*a))
      for hid in cs.RAGGED_GRU:
        g = gen_for(f"ragged gru {hid} {b} {dtype}")
        a = (cs.randn((b, 3 * hid), g, dtype), cs.randn((b, hid), g, dtype, 0.5),
             cs.randn((hid, 3 * hid), g, dtype, 0.05),
             cs.randn((3 * hid,), g, f32, 0.1))
        add("gru_cell", f"ragged H={hid}", b, dtype, lambda a=a: gru_cell(*a),
            lambda a=a: ref.gru_cell(*a))
  for b in cs.RAGGED_BATCHES:
    for m, n in cs.RAGGED_INT8:
      g = gen_for(f"ragged i8 {m} {n} {b}")
      xq, xs = ref.quantize_rowwise(cs.randn((b, m), g, f32))
      wq, ws = ref.quantize_colwise(cs.randn((m, n), g, f32))
      flat = torch.zeros(m * n + 1, dtype=torch.int8, device="cuda")
      flat[1:] = wq.flatten()
      for label, w in (("ragged", wq), ("unaligned", flat[1:].view(m, n))):
        add("int8_gemm", f"{label} {m}x{n}", b, torch.int8,
            lambda a=(xq, w, xs, ws): int8_gemm(*a),
            lambda a=(xq, wq, xs, ws): ref.int8_gemm(*a))
  return out


def gru_stamps(forms) -> list[dict]:
  """Per DS2 shape and batch: medians over STAMP_LAUNCHES launches of the
  span (last end less first start) and of the tail of each unit tile's
  last block (end less partial sums), in µs."""
  import torch

  from repro_torch.kernels import gru_cell as gc
  rows = []
  for b in cs.BATCHES:
    for i in range(3):
      u = forms["dense"].grus[f"gru{i}"].rec.w
      hid = u.shape[0]
      g = gen_for(f"gru{i} {b}")
      a = (cs.randn((b, 3 * hid), g, torch.bfloat16),
           cs.randn((b, hid), g, torch.bfloat16, 0.5), u,
           cs.randn((3 * hid,), g, torch.float32, 0.1))
      p = gc.plan(b, hid, w_bytes=2, sms=gc.sm_count(0))
      spans, tails, exposed = [], [], []
      for _ in range(STAMP_LAUNCHES):
        st = torch.zeros(3 * p.blocks, dtype=torch.int64, device="cuda")
        gc._launch(*a, p, stamps=st)
        torch.cuda.synchronize()
        st = st.view(p.grid[2], p.split, p.grid[0], 3).cpu()
        span = int(st[..., 2].max() - st[..., 0].min())
        # a unit tile's 3 * split blocks: columns x = 3 t + gate
        per_tile = st.view(p.grid[2], p.split, p.unit_tiles, 3, 3)
        tail = (per_tile[..., 2] - per_tile[..., 1]).amax(dim=(1, 3))
        spans.append(span / 1e3)
        tails.append(float(tail.float().median()) / 1e3)
        exposed.append(int(st[..., 2].max() - st[..., 1].max()) / 1e3)
      rows.append(dict(stamps="gru_cell", shape=f"gru{i}/rec", batch=b,
                       lanes=p.lanes, split=p.split, blocks=p.blocks,
                       span_us=statistics.median(spans),
                       last_block_tail_us=statistics.median(tails),
                       tail_after_last_partials_us=statistics.median(exposed)))
  return rows


def run(tree: Path, out: Path) -> None:
  sys.path.insert(0, str(tree / "src"))
  import inspect

  import torch

  import repro_torch
  if not Path(repro_torch.__file__).resolve().is_relative_to(tree):
    raise RuntimeError(f"repro_torch came from {repro_torch.__file__}")
  from repro_torch import configs
  from repro_torch.kernels import _build
  from repro_torch.kernels import gru_cell as gc
  torch.backends.cuda.matmul.allow_tf32 = False
  _build.library()
  forms = cs.build_forms(configs.get_config("deepspeech2-wsj"))
  rows = []
  for kernel, label, b, dtype, fn, plain, timing in cases(
      forms, configs.get_config(cs.LM_ARCH)):
    got, want = fn(), plain()
    torch.cuda.synchronize()
    row = dict(kernel=kernel, label=label, batch=b, dtype=dtype,
               digest=digest(got),
               max_abs_err=float((got.float() - want.float()).abs().max()))
    if timing:
      row.update(path=timing["path"], weight=timing.get("weight", 1),
                 ms=cs.time_ms(fn))
      if timing.get("cold"):
        row["cold_ms"] = cs.time_ms(fn, cold=True)
      if timing.get("yardstick"):
        row["yardstick_ms"] = cs.time_ms(timing["yardstick"])
        if timing.get("cold"):
          row["yardstick_cold_ms"] = cs.time_ms(timing["yardstick"],
                                                cold=True)
    rows.append(row)
  if hasattr(gc, "_launch") and \
      "stamps" in inspect.signature(gc._launch).parameters:
    rows += gru_stamps(forms)
  out.parent.mkdir(parents=True, exist_ok=True)
  out.write_text("".join(json.dumps(r) + "\n" for r in rows))


def step_sums(rows: list[dict]) -> dict:
  """(kernel, path, batch) -> summed ms (and cold / yardstick ms) of one
  step, each row `weight` times."""
  sums: dict = {}
  for r in rows:
    if "ms" not in r:
      continue
    key = f"{r['kernel']} {r['path']} b={r['batch']}"
    s = sums.setdefault(key, {})
    for k in ("ms", "cold_ms", "yardstick_ms", "yardstick_cold_ms"):
      if k in r:
        s[k] = s.get(k, 0.0) + r[k] * r["weight"]
  return sums


def compare(old: Path, new: Path) -> int:
  runs = []
  for i, (tag, tree) in enumerate((("old", old), ("new", new), ("new", new),
                                   ("old", old))):
    out = ROOT / "build" / "compare" / f"run{i}_{tag}.jsonl"
    subprocess.run([sys.executable, str(Path(__file__).resolve()), "--run",
                    str(tree), "--out", str(out)], check=True, timeout=900)
    runs.append((tag, [json.loads(ln) for ln in out.read_text().splitlines()]))
  by_tag: dict = {"old": [], "new": []}
  for tag, rows in runs:
    by_tag[tag].append(rows)
  result = dict(card=cs.card_line(), old=str(old), new=str(new))
  # outputs: a tree's two runs agree; the unchanged kernels across trees
  ok = True
  same = {}
  for tag, (r1, r2) in by_tag.items():
    if [r.get("digest") for r in r1] != [r.get("digest") for r in r2]:
      ok = False
      result[f"{tag}_runs_differ"] = True
  keyed = {tag: {(r["kernel"], r["label"], r["batch"], r["dtype"]): r
                 for r in rows[0] if "digest" in r}
           for tag, rows in by_tag.items()}
  for key, r in keyed["new"].items():
    o = keyed["old"].get(key)
    if o is None:
      continue
    n_same, n = same.get(key[0], (0, 0))
    same[key[0]] = (n_same + (o["digest"] == r["digest"]), n + 1)
  result["bit_identical_shapes"] = {k: f"{a}/{n}" for k, (a, n) in same.items()}
  if any(a != n for k, (a, n) in same.items() if k in UNCHANGED):
    ok = False
  result["max_abs_err"] = {
      tag: {k: max(r["max_abs_err"] for r in rows[0] if r.get("kernel") == k)
            for k in {r.get("kernel") for r in rows[0] if "digest" in r}}
      for tag, rows in by_tag.items()}
  # times: the mean of each tree's two runs
  steps = {}
  for tag, rows2 in by_tag.items():
    a, b = step_sums(rows2[0]), step_sums(rows2[1])
    for key in a:
      for k in a[key]:
        steps.setdefault(key, {})[f"{tag}_{k}"] = (a[key][k] + b[key][k]) / 2
  for s in steps.values():
    if "old_ms" in s and "new_ms" in s:
      s["new_over_old"] = s["new_ms"] / s["old_ms"]
  result["steps"] = steps
  result["stamps"] = [r for rows2 in by_tag["new"] for r in rows2
                      if "stamps" in r]
  OUT_DIR.mkdir(parents=True, exist_ok=True)
  (OUT_DIR / "compare.json").write_text(json.dumps(
      dict(result, rows={f"run{i}_{tag}": rows
                         for i, (tag, rows) in enumerate(runs)}), indent=1))
  for key, s in sorted(steps.items()):
    print(json.dumps(dict(step=key, **s)), flush=True)
  for r in result["stamps"]:
    print(json.dumps(r), flush=True)
  print(json.dumps({k: v for k, v in result.items()
                    if k not in ("steps", "stamps")}), flush=True)
  print(json.dumps({"ok": ok}), flush=True)
  return 0 if ok else 1


def main() -> int:
  ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  ap.add_argument("old", nargs="?", type=Path)
  ap.add_argument("new", nargs="?", type=Path, default=ROOT)
  ap.add_argument("--run", type=Path, help="one run of one tree")
  ap.add_argument("--out", type=Path)
  args = ap.parse_args()
  import torch
  if not torch.cuda.is_available():
    print("chip_compare: no CUDA device", file=sys.stderr)
    return 2
  if args.run:
    run(args.run.resolve(), args.out)
    return 0
  if args.old is None:
    ap.error("give the old tree")
  return compare(args.old.resolve(), args.new.resolve())


if __name__ == "__main__":
  sys.exit(main())
