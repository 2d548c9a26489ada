"""The invariant registry: per-program checks over the op walk, and
parameter rule coverage.

Counterpart of `repro/analysis/checks.py`. Each checker takes a
`targets.RunTarget` (its `WalkResult`) and returns Findings;
`run_target_checks` is the per-program entry point;
`check_sharding_coverage` runs once per config over the *production*
param specs (meta tensors), where divisibility against the audit mesh
shows rule gaps.

dispatch_coverage — a product (`DotSite`) with a parameter-derived
  operand must run inside a `dispatch:{regime}:c{id}` scope whose id is
  a DispatchRecord of the same regime from the same run; an unscoped
  product of activations alone (attention scores, SSM scans) is
  intrinsic math, not a weight GEMM. Keys are the reference's
  (`unrouted:{scope}:{shapes}`, the scope "" outside every one), so the
  two packages' findings compare by ident.

quant_integrity — in a PTQ'd program no value derived from an int8
  weight may become a float: a `ConvertSite` to f32, bf16 or f16 (an
  explicit conversion, or PyTorch's promotion of `w_q * scale`) is a
  dequantize. One exception, kept narrow: the w8a8 oracle
  `kernels/ref.int8_gemm` (the CPU's plain version of the int8 kernel)
  takes its integer product in float64, which holds every s32 partial
  sum exactly; a float64 conversion made inside that function
  (`ConvertSite.oracle`) is its accumulation, not a dequantize. A
  float64 conversion anywhere else is one.

transfer_lint — four checks in place of the reference's HLO ones:
  (a) no `HostSite` in a program: a scalar read (`.item()`, `float(t)`,
      `bool(t)`) or a copy across devices inside a step;
  (b) the torch form of donation: every decode-state tensor keeps its
      shape, dtype and storage across a step, so the KV cache and the
      carries are written in place, not rebuilt;
  (c) on the card, a warmed step raises nothing under
      `torch.cuda.set_sync_debug_mode("error")`;
  (d) the reference's `hlo-unknown:{token}`, one finding for each entry
      of the cost ledger's `unknown_ops` (`dist.hlo_cost`): a dtype,
      an op or a kernel launched outside its scope that the ledger
      could not account, so no count is dropped silently.
  The reference's optimized-HLO host ops have no counterpart: there is
  no HLO.

sharding_coverage — every param leaf must resolve to an explicit
  PARAM_RULES kind (or the embedding-table path rule) that actually
  shards it on the audit mesh (`dist.sharding.rule_coverage`, entry for
  entry the reference's), with the reference's keys.
"""
from __future__ import annotations

from typing import List

from repro_torch.analysis.report import Finding, stable_key
from repro_torch.analysis.targets import RunTarget
from repro_torch.dist.hlo_cost import KERNEL_REGIMES
from repro_torch.dist.sharding import rule_coverage

#: replicated param leaves at or above this many elements are findings
BIG_PARAM_ELEMS = 1 << 16

#: conversions of int8 weights that are dequantizes everywhere
DEQUANT_DTYPES = ("float32", "bfloat16", "float16")



def _f(target: RunTarget, check: str, key: str, detail: str) -> Finding:
  return Finding(check=check, config=target.config, policy=target.policy,
                 quant=target.quant, program=target.program,
                 key=stable_key(key), detail=detail)


def check_dispatch_coverage(target: RunTarget) -> List[Finding]:
  if target.policy == "-":
    return []        # train programs thread no policy: nothing to correlate
  by_id = {r.call_id: r for r in target.dispatch_log}
  out = []
  for dot in target.walk.dots:
    scope = dot.dispatch_scope()
    if scope is not None:
      regime, cid = scope
      rec = by_id.get(cid)
      if rec is None:
        out.append(_f(
            target, "dispatch_coverage",
            f"uncorrelated:{dot.name_stack}:{dot.shapes}",
            f"product under dispatch scope c{cid} but no DispatchRecord "
            f"with that id was recorded in the run"))
      elif rec.regime != regime:
        out.append(_f(
            target, "dispatch_coverage",
            f"regime-mismatch:{dot.name_stack}:{dot.shapes}",
            f"scope says {regime!r} but the recorded decision for "
            f"{rec.name!r} (c{cid}) was {rec.regime!r}"))
    elif any(dot.param_operands):
      out.append(_f(
          target, "dispatch_coverage",
          f"unrouted:{dot.name_stack}:{dot.shapes}",
          f"parameter-consuming product {dot.op} {dot.shapes} outside any "
          f"dispatch scope: this GEMM bypasses kernels.dispatch.gemm and "
          f"can never route to the paper's serving kernels"))
  return out


def check_quant_integrity(target: RunTarget) -> List[Finding]:
  if target.quant != "int8":
    return []
  return [
      _f(target, "quant_integrity",
         f"dequantize:{c.name_stack}:{c.shape}->{c.dst_dtype}",
         f"int8 weight turned into {c.dst_dtype} by {c.op} (shape "
         f"{c.shape}): a dequantize in the PTQ'd hot path — the "
         f"stored-scale w8a8 contract requires weights to stay int8 "
         f"until accumulation")
      for c in target.walk.int8_converts
      if not c.oracle and (c.dst_dtype in DEQUANT_DTYPES
                           or c.dst_dtype == "float64")
  ]


def check_transfer_lint(target: RunTarget) -> List[Finding]:
  out = [
      _f(target, "transfer_lint", f"host-op:{h.op}:{h.name_stack}",
         f"host round trip {h.op!r} inside the program: a device<->host "
         f"transfer (a sync on the card) in the hot loop")
      for h in target.walk.host_ops
  ]
  for path, (before, after) in sorted(target.state.items()):
    if before is None or after is None:
      out.append(_f(
          target, "transfer_lint", f"state-structure:{path}",
          f"decode-state leaf {path!r} is {'new' if before is None else 'gone'}"
          f" after the step: the state's structure changed"))
    elif before[:2] != after[:2]:
      out.append(_f(
          target, "transfer_lint", f"state-signature:{path}",
          f"decode-state leaf {path!r} went from {before[:2]} to "
          f"{after[:2]} across the step"))
    elif before[2] != after[2]:
      out.append(_f(
          target, "transfer_lint", f"state-rebuilt:{path}",
          f"decode-state leaf {path!r} {before[0]} came back in a new "
          f"storage: the step rebuilt it instead of writing it in place "
          f"(the reference donates the state to the step)"))
  if target.sync_error is not None:
    out.append(_f(
        target, "transfer_lint", "cuda-sync",
        f"a warmed step synchronized under set_sync_debug_mode('error'): "
        f"{target.sync_error}"))
  if target.cost is not None:
    for token, count in sorted(target.cost.unknown_ops.items()):
      out.append(_f(
          target, "transfer_lint", f"hlo-unknown:{token}",
          f"hlo_cost could not fully account {count} op(s) ({token}): "
          f"cost figures for this program under-count"))
  return out


def check_sharding_coverage(config: str, params,
                            quant: str = "float") -> List[Finding]:
  """Rule coverage over one config's (production-scale) param tree."""
  out = []
  for e in rule_coverage(params):
    big = e["size"] >= BIG_PARAM_ELEMS and len(e["shape"]) >= 2
    if e["name"] is not None:
      if big and not e["sharded"]:
        out.append(Finding(
            check="sharding_coverage", config=config, quant=quant,
            program="params",
            key=f"unsharded:{e['name']}:{e['field']}:{e['shape']}",
            detail=(f"GEMM leaf {e['name']!r} ({e['field']}, shape "
                    f"{e['shape']}, rule {e['rule']!r}) replicates on the "
                    f"audit mesh: its split was divisibility-gated off")))
    elif e["rule"] is None and big:
      out.append(Finding(
          check="sharding_coverage", config=config, quant=quant,
          program="params",
          key=f"unruled:{e['path']}:{e['shape']}",
          detail=(f"raw param leaf {e['path']!r} (shape {e['shape']}, "
                  f"{e['size']} elems) matches no PARAM_RULES glob or "
                  f"path rule and replicates everywhere")))
    elif e["rule"] is not None and big and not e["sharded"]:
      out.append(Finding(
          check="sharding_coverage", config=config, quant=quant,
          program="params",
          key=f"unsharded:{e['path']}:{e['shape']}",
          detail=(f"path-ruled leaf {e['path']!r} ({e['rule']}) "
                  f"replicates on the audit mesh (divisibility)")))
  return out


def check_scope_launches(target: RunTarget) -> List[Finding]:
  """On the card: a kernel-regime scope that launched nothing, or a
  kernel not its own, is a dispatch decision the kernels did not carry
  out (reported under dispatch_coverage)."""
  if target.device != "cuda":
    return []
  out = []
  for s in target.walk.scopes:
    got = dict(s.launches)
    if s.regime in KERNEL_REGIMES:
      if got.get(s.regime, 0) < 1 or set(got) != {s.regime}:
        out.append(_f(target, "dispatch_coverage",
                      f"launches:{s.name}:{sorted(got.items())}",
                      f"kernel scope {s.name} launched {got}, not its "
                      f"{s.regime} kernel"))
    elif got:
      out.append(_f(target, "dispatch_coverage",
                    f"launches:{s.name}:{sorted(got.items())}",
                    f"plain scope {s.name} launched kernels {got}"))
  return out


def run_target_checks(target: RunTarget) -> tuple:
  """All per-program checks for one target. Returns (findings, info)
  where info is the target's report metadata (coverage counts, scope
  launches)."""
  walk = target.walk
  findings: List[Finding] = []
  findings.extend(check_dispatch_coverage(target))
  findings.extend(check_scope_launches(target))
  findings.extend(check_quant_integrity(target))
  findings.extend(check_transfer_lint(target))
  scoped = sum(1 for d in walk.dots if d.dispatch_scope() is not None)
  info = dict(target.coord)
  info.update(
      n_ops=walk.n_ops, n_dots=len(walk.dots), n_dots_scoped=scoped,
      n_dispatch_records=len(target.dispatch_log),
      regimes=sorted({r.regime for r in target.dispatch_log}),
      n_findings=len(findings), device=target.device)
  launches = {}
  for s in walk.scopes:
    for k, n in s.launches:
      launches[k] = launches.get(k, 0) + n
  if launches:
    info["launches"] = launches
  return findings, info
