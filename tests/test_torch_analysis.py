"""The port's auditor (`repro_torch.analysis`) against the reference's
(`repro.analysis`).

The compression ledger and the sharding-coverage idents are computed by
both packages on meta/abstract trees at production scale and must be
equal; the dispatch-coverage and quant-integrity idents of the qwen3-4b
and whisper-small decode programs, both policies and quants, must be
the reference's `run_target_checks` ones (whisper's tied head
`x @ table.T` is a bypass in both). The reference's jaxpr walk reads
`jax.core.Literal`, which this JAX moved to `jax._src.core`: the test
hands its module that namespace (the JAX package is not edited), and
skips the reference's lowering and compiling, which its checks of those
two names do not read.

Then each check fires on a program built to violate it (a raw `x @ w`
on a parameter, a `.float()` of an int8 weight, an `.item()` in a step,
a state rebuilt per step, and a planted fault for each lifecycle
check), the report's baseline mechanics, and the CLI's exit codes.
Torch runs on one thread.
"""
import json

import numpy as np
import pytest
import torch

import repro_torch.analysis as analysis
from repro_torch.analysis import (checks, compression, lifecycle, op_walk,
                                  report, targets)
from repro_torch.analysis.__main__ import main
from repro_torch.kernels import dispatch, ref

CONFIGS = list(targets.DEFAULT_CONFIGS)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Against the reference.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("config", CONFIGS)
def test_compression_ledger_equals_the_reference(config):
  from repro.analysis import compression as jcompression
  want = jcompression.compression_ledger(config)
  got = compression.compression_ledger(config)
  assert got == want
  assert compression.strictness_violations(got) == []


def test_compression_ledger_figures():
  """Two of the reference's figures, as numbers."""
  ds2 = compression.compression_ledger("deepspeech2-wsj")["variants"]
  assert ds2["float"]["param_count"] == 19_871_840
  assert ds2["float"]["param_bytes"] == 39_762_112
  qwen = compression.compression_ledger("qwen3-4b")["variants"]
  assert qwen["lowrank_int8"]["param_bytes"] == 2_105_257_984


def test_sharding_coverage_idents_equal_the_reference():
  import jax
  from repro import configs as jconfigs
  from repro.analysis import checks as jchecks
  from repro.configs import specs as jspecs
  from repro.quant.ptq import quantize_params as jquantize
  want = set()
  for name in CONFIGS:
    params = jspecs.param_specs(jconfigs.get_config(name))
    want |= {f.ident for f in jchecks.check_sharding_coverage(name, params)}
    q = jax.eval_shape(jquantize, params)
    want |= {f.ident for f in jchecks.check_sharding_coverage(name, q,
                                                              "int8")}
  rep = report.AuditReport()
  analysis._sharding_findings(CONFIGS, rep)
  assert {f.ident for f in rep.findings} == want
  assert len(want) == 21


@pytest.fixture(scope="module")
def reference_decode_idents():
  """The reference's dispatch_coverage and quant_integrity idents of the
  qwen3-4b and whisper-small decode programs."""
  import jax._src.core as jcore
  from repro.analysis import checks as jchecks
  from repro.analysis import jaxpr_walk
  from repro.analysis import targets as jtargets
  trace = jtargets._trace
  saved = jaxpr_walk.core
  jaxpr_walk.core = jcore
  jtargets._trace = lambda fn, args, **kw: trace(fn, args)
  try:
    out = {}
    for t in jtargets.iter_targets(["qwen3-4b", "whisper-small"],
                                   programs=("decode",)):
      found, _ = jchecks.run_target_checks(t)
      out[(t.config, t.policy, t.quant)] = {
          f.ident for f in found
          if f.check in ("dispatch_coverage", "quant_integrity")}
    return out
  finally:
    jaxpr_walk.core = saved
    jtargets._trace = trace


def test_decode_dispatch_and_quant_idents_equal_the_reference(
    reference_decode_idents):
  got = {}
  for t in targets.iter_targets(["qwen3-4b", "whisper-small"],
                                programs=("decode",), device="cpu"):
    found, info = checks.run_target_checks(t)
    got[(t.config, t.policy, t.quant)] = {
        f.ident for f in found
        if f.check in ("dispatch_coverage", "quant_integrity")}
    assert info["n_dots_scoped"] > 0
  assert got == reference_decode_idents
  assert len(got) == 8
  assert got[("whisper-small", "pallas", "int8")] == {
      "whisper-small|pallas|int8|decode|dispatch_coverage|"
      "unrouted::((2, 1, 128), (128, 512))"}


# ---------------------------------------------------------------------------
# Planted faults: every check fires on a program built to violate it.
# ---------------------------------------------------------------------------

def _target(fn, seeds, *, quant="float", policy="jnp", state=None):
  _, walk, log = targets.run_program(fn, seeds)
  return targets.RunTarget("seeded", "test", policy, quant, "decode",
                           walk.result, log, state or {}, None, "cpu")


def _idents(t, check=None):
  return [f.key for f in checks.run_target_checks(t)[0]
          if check in (None, f.check)]


def test_unrouted_parameter_product_is_flagged():
  w = torch.nn.Parameter(torch.randn(16, 32), requires_grad=False)
  x = torch.randn(4, 16)
  assert _idents(_target(lambda: x @ w, [w])) == [
      "unrouted::((4, 16), (16, 32))"]
  # activation x activation contractions are intrinsic math
  assert _idents(_target(lambda: x @ x.T, [w])) == []
  # the same product routed through kernels.dispatch is clean
  t = _target(lambda: dispatch.gemm(w, x, dispatch.JNP_ONLY), [w])
  assert _idents(t) == [] and t.dispatch_log == [("<unnamed>", "jnp")]
  assert t.walk.dots[0].dispatch_scope()[0] == "jnp"


def test_dequantize_of_an_int8_weight_is_flagged():
  w8 = torch.randint(-127, 127, (16, 32), dtype=torch.int8)
  scale = torch.rand(32)
  x = torch.randn(4, 16)
  q = "quant_integrity"
  keys = _idents(_target(lambda: x @ w8.float(), [w8], quant="int8"), q)
  assert keys == ["dequantize::(16, 32)->float32"]
  # PyTorch's promotion of w_q * scale is a dequantize too
  keys = _idents(_target(lambda: w8 * scale, [w8], quant="int8"), q)
  assert keys == ["dequantize::(16, 32)->float32"]
  # int8 -> int32 widening is the legitimate accumulation
  assert _idents(_target(lambda: w8.to(torch.int32).sum(), [w8],
                         quant="int8"), q) == []
  # so is the w8a8 oracle's float64 product, and only there
  x8 = torch.randint(-127, 127, (4, 16), dtype=torch.int8)
  t = _target(lambda: ref.int8_gemm(x8, w8, torch.ones(4), scale), [w8],
              quant="int8")
  assert _idents(t, q) == [] and t.walk.int8_converts[0].oracle
  assert _idents(_target(lambda: w8.double(), [w8], quant="int8"), q) == [
      "dequantize::(16, 32)->float64"]


def test_a_host_read_in_a_step_is_flagged():
  x = torch.randn(4)
  keys = _idents(_target(lambda: x * x.sum().item(), []))
  assert keys == ["host-op:_local_scalar_dense:"]


def test_an_op_the_cost_ledger_cannot_account_is_flagged():
  """The reference's `hlo-unknown:{token}`: every entry of the cost
  ledger's `unknown_ops` is a finding; a costed program gives none."""
  from repro_torch.dist import hlo_cost

  def costed(fn):
    _, walk, log = targets.run_program(fn, [], keep_trace=True)
    return targets.RunTarget(
        "seeded", "test", "jnp", "float", "decode", walk.result, log, {},
        None, "cpu", cost=hlo_cost.analyze_walk(walk.result.trace))
  x = torch.randn(16, 16)
  assert _idents(costed(lambda: torch.linalg.svdvals(x)),
                 "transfer_lint") == ["hlo-unknown:op:aten._linalg_svd"]
  assert _idents(costed(lambda: x @ x.T), "transfer_lint") == []


def test_a_state_rebuilt_per_step_is_flagged():
  def run(step):
    state = {"h": torch.zeros(2, 8)}
    before = targets.state_signature(state)
    new = step(state)
    after = targets.state_signature(new)
    return _target(lambda: None, [], state={
        k: (before[k], after.get(k)) for k in before})

  def in_place(s):
    s["h"].add_(1.0)
    return s
  assert _idents(run(in_place)) == []
  assert _idents(run(lambda s: {"h": s["h"] + 1.0})) == [
      "state-rebuilt:h"]


def _clone_tree(x):
  if isinstance(x, dict):
    return {k: _clone_tree(v) for k, v in x.items()}
  return x.clone() if isinstance(x, torch.Tensor) else x


def _rebuilt_step(monkeypatch):
  step = lifecycle.LMEngine._step

  def rebuilt(self, state, tokens, positions):
    logits, new = step(self, state, tokens, positions)
    return logits, _clone_tree(new)
  monkeypatch.setattr(lifecycle.LMEngine, "_step", rebuilt)


def _cold_splice(monkeypatch):
  monkeypatch.setattr(lifecycle.LMEngine, "_splice",
                      lambda self, snapshot: self._init_state(1))


def _frozen_rank(monkeypatch):
  monkeypatch.setattr(lifecycle.LMEngine, "_maybe_adapt_rank",
                      lambda self: None)


def _swapped_slots(monkeypatch):
  step = lifecycle.StreamingSpeechServer._frame_step

  def swapped(self, x, active):
    out = step(self, x, active)
    return out.flip(0) if self.batch > 1 else out
  monkeypatch.setattr(lifecycle.StreamingSpeechServer, "_frame_step",
                      swapped)


@pytest.mark.parametrize("check, config, plant, key", [
    ("retrace_stability", "qwen3-4b", _rebuilt_step, "state-storage:"),
    ("prefix_splice_stability", "qwen3-4b", _cold_splice, "token-parity"),
    ("spec_window_stability", "qwen3-4b", _frozen_rank, "no-rank-walk"),
    ("speech_fleet_stability", "deepspeech2-wsj", _swapped_slots,
     "fleet-serial-divergence"),
])
def test_lifecycle_checks_pass_and_catch_their_planted_fault(
    monkeypatch, check, config, plant, key):
  fn = getattr(lifecycle, f"check_{check}")
  found, infos = fn([config], ["jnp"], device="cpu")
  assert found == [] and len(infos) == 1
  plant(monkeypatch)
  found, _ = fn([config], ["jnp"], device="cpu")
  assert found and all(f.check == check for f in found)
  assert any(f.key.startswith(key) for f in found), found


# ---------------------------------------------------------------------------
# The walk, the dispatch scopes, liveness.
# ---------------------------------------------------------------------------

def test_dispatch_records_keep_their_pair_and_scopes_close():
  w = torch.randn(16, 16)
  x = torch.randn(2, 16)
  with dispatch.record_dispatch() as log:
    dispatch.gemm(w, x, dispatch.JNP_ONLY, name="a")
  assert log == [("a", "jnp")] and isinstance(log[0].call_id, int)
  assert dispatch._LISTENERS == []
  walk = op_walk.OpWalk([w])
  with walk:
    dispatch.gemm(w, x, dispatch.JNP_ONLY, name="a")
  assert dispatch._LISTENERS == [] and walk.scope_stack() == ""
  (scope,) = walk.result.scopes
  assert scope.regime == "jnp" and scope.launches == ()
  assert walk.log[0].call_id == int(scope.name.split(":c")[1])


def test_liveness_counts_allocations_not_in_place_writes():
  cache = torch.zeros(64, 64)
  x = torch.randn(64, 64)

  def step():
    y = x * 2.0                  # 16 KiB, dies after the next line
    z = y + 1.0                  # 16 KiB, returned
    cache.add_(z)                # in place: nothing new
    return z
  walk = op_walk.OpWalk([], keep_trace=True)
  with walk:
    z = step()
  from repro_torch.analysis import liveness
  rep = liveness.estimate(walk.result, walk, outputs=[z])
  assert rep.transient_bytes == 2 * 64 * 64 * 4
  assert rep.output_bytes == 64 * 64 * 4
  assert rep.input_bytes == 2 * 64 * 64 * 4


# ---------------------------------------------------------------------------
# Report and baseline mechanics, the CLI.
# ---------------------------------------------------------------------------

def test_stable_key_masks_call_ids():
  assert report.stable_key("dispatch:jnp:c42/dot") == "dispatch:jnp:c*/dot"
  f1 = report.Finding(check="dispatch_coverage", config="c",
                      key=report.stable_key("site:c7"))
  f2 = report.Finding(check="dispatch_coverage", config="c",
                      key=report.stable_key("site:c9001"))
  assert f1.ident == f2.ident
  with pytest.raises(ValueError, match="unknown check"):
    report.Finding(check="vibes", config="c", key="k")
  assert report.CHECKS == __import__(
      "repro.analysis.report", fromlist=["CHECKS"]).CHECKS


def test_baseline_partition_and_stale(tmp_path):
  f = report.Finding(check="transfer_lint", config="c", key="k")
  rep = report.AuditReport(findings=[f])
  rep.apply_baseline({"allow": []})
  assert not rep.ok and rep.new == [f]
  rep.apply_baseline({"allow": [{"ident": f.ident},
                                {"ident": "gone|-|-|-|transfer_lint|x"}]})
  assert rep.ok and rep.allowed == [f]
  assert rep.stale == ["gone|-|-|-|transfer_lint|x"]
  path = str(tmp_path / "base.json")
  report.write_baseline(rep, path)
  assert {e["ident"] for e in report.load_baseline(path)["allow"]} == \
      {f.ident}
  assert report.load_baseline(str(tmp_path / "missing.json")) == \
      {"allow": []}
  # every entry of the committed baseline gives its reason
  assert all(e.get("reason") for e in report.load_baseline()["allow"])


def test_cli_exit_codes(tmp_path, capsys):
  common = ["audit", "--configs", "deepspeech2_wsj", "--device", "cpu"]
  rep_path = str(tmp_path / "report.json")
  assert main(common + ["--report", rep_path]) == 0
  saved = json.loads(open(rep_path).read())
  assert saved["ok"] and saved["targets"] and not saved[
      "stale_baseline_entries"]
  # the budgets ran by default, every DS2 coordinate ledgered
  assert "deepspeech2-wsj|jnp|float|decode" in saved["meta"]["budgets"][
      "programs"]
  # DS2's unruled conv kernel is a known debt: against an EMPTY
  # baseline it turns the exit code red
  empty = str(tmp_path / "empty.json")
  lean = common + ["--no-lifecycle", "--programs", "decode", "--quants",
                   "float", "--policies", "jnp"]
  assert main(lean + ["--baseline", empty]) == 1
  assert "NEW" in capsys.readouterr().out
  assert main(lean + ["--baseline", empty, "--write-baseline"]) == 0
  assert main(lean + ["--baseline", empty]) == 0


def test_grid_audits_clean_on_the_baseline():
  """The carry families on the CPU, every program: nothing new (the
  transformer's and Whisper's decode are held to the reference's idents
  above, DS2's whole audit by the CLI)."""
  rep = analysis.run_audit(["zamba2-7b", "xlstm-350m"], device="cpu",
                           run_lifecycle=False, run_sharding=False)
  rep.apply_baseline(analysis.load_baseline())
  assert rep.ok, "\n" + rep.summary()
  decode = [t for t in rep.targets if t["program"] == "decode"]
  assert decode and all(t["n_dots_scoped"] > 0 for t in decode)
  assert any(t["quant"] == "int8" for t in decode)
  assert np.all([t["n_ops"] > 0 for t in rep.targets])
