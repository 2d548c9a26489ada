"""The port's budget auditor (`repro_torch.analysis.budgets`): the
reference's band, ratchet, dominant-flip, unbudgeted, merge and
round-trip semantics, a widened state and a doctored number tripping the
gate, the committed `budgets.json` green over the default grid, the
CLI's exit codes, and the cross-check of the port's ledgers against the
reference's committed `src/repro/analysis/budgets.json`.

The reference's budget tests are red on this JAX (its jaxpr walk and its
cost parser, `tests/test_budgets.py`), so its committed numbers, written
under JAX 0.4.37, are the oracle: their dot FLOPs check out against hand
arithmetic (DS2's decode step at batch 2 is its three GRUs' products,
the FC and the output, 578,560).
"""
import json
import os

import pytest
from threadpoolctl import threadpool_limits

torch = pytest.importorskip("torch")

from repro_torch.analysis import (budgets, compression, liveness,  # noqa: E402
                                  targets)
from repro_torch.analysis.__main__ import main  # noqa: E402
from repro_torch.dist import hlo_cost  # noqa: E402

REFERENCE_BUDGETS = os.path.join(os.path.dirname(__file__), "..", "src",
                                 "repro", "analysis", "budgets.json")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  with threadpool_limits(1):
    yield
  torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# Tolerance-band diff semantics (the reference's cases).
# ---------------------------------------------------------------------------

_COORD = dict(config="c", policy="jnp", quant="float", program="decode")
_KEY = "c|jnp|float|decode"


def _committed(**over):
  base = dict(flops=1000.0, hbm_bytes=1000.0, peak_live_bytes=1000,
              input_bytes=100, dominant="memory")
  base.update(over)
  return {_KEY: base}


def test_band_inside_is_silent():
  led = dict(flops=1040.0, hbm_bytes=1090.0, peak_live_bytes=1040,
             input_bytes=100, dominant="memory")
  f, w = budgets.diff_program(_COORD, led, _committed())
  assert f == [] and w == []


def test_band_regression_is_red():
  led = dict(flops=1060.0, hbm_bytes=1200.0, peak_live_bytes=1060,
             input_bytes=101, dominant="memory")
  f, w = budgets.diff_program(_COORD, led, _committed())
  assert w == []
  assert {x.key for x in f} == {
      "over-budget:flops", "over-budget:hbm_bytes",
      "over-budget:peak_live_bytes", "over-budget:input_bytes"}
  by_key = {x.key: x for x in f}
  assert by_key["over-budget:flops"].check == "cost_budget"
  assert by_key["over-budget:input_bytes"].check == "memory_budget"


def test_band_improvement_is_ratchet_stale_not_red():
  led = dict(flops=900.0, hbm_bytes=800.0, peak_live_bytes=900,
             input_bytes=100, dominant="memory")
  f, w = budgets.diff_program(_COORD, led, _committed())
  assert f == []
  assert {x["metric"] for x in w} == {"flops", "hbm_bytes",
                                      "peak_live_bytes"}
  assert all("--update" in x["note"] for x in w)


def test_dominant_flip_is_red():
  led = dict(flops=1000.0, hbm_bytes=1000.0, peak_live_bytes=1000,
             input_bytes=100, dominant="compute")
  f, _ = budgets.diff_program(_COORD, led, _committed())
  assert [x.key for x in f] == ["dominant-flip:memory->compute"]
  assert f[0].check == "cost_budget"


def test_unbudgeted_coordinate_is_red_per_check():
  led = dict(flops=1.0, hbm_bytes=1.0, peak_live_bytes=1, input_bytes=1)
  f, _ = budgets.diff_program(_COORD, led, {})
  assert sorted(x.check for x in f) == ["cost_budget", "memory_budget"]
  assert all(x.key == "unbudgeted" for x in f)
  f2, _ = budgets.diff_program(_COORD, dict(peak_live_bytes=1,
                                            input_bytes=1), {})
  assert [x.check for x in f2] == ["memory_budget"]


def test_merge_budgets_is_fieldwise():
  committed = {"meta": {"torch_version": "old"},
               "programs": {_KEY: dict(flops=5.0, peak_live_bytes=10)},
               "compression": {"c": {"variants": {}}}}
  fresh = {"meta": {"torch_version": "new"},
           "programs": {_KEY: dict(peak_live_bytes=12),
                        "d|jnp|float|decode": dict(peak_live_bytes=1)},
           "compression": {}}
  out = budgets.merge_budgets(committed, fresh)
  assert out["programs"][_KEY] == dict(flops=5.0, peak_live_bytes=12)
  assert "d|jnp|float|decode" in out["programs"]
  assert out["compression"] == {"c": {"variants": {}}}
  assert out["meta"]["torch_version"] == "new"


def test_budgets_io_roundtrip(tmp_path):
  path = str(tmp_path / "b.json")
  assert budgets.load_budgets(path) == {"meta": {}, "programs": {},
                                        "compression": {}}
  budgets.write_budgets({"meta": {}, "programs": {_KEY: {"flops": 1}},
                         "compression": {}}, path)
  assert budgets.load_budgets(path)["programs"][_KEY] == {"flops": 1}
  (tmp_path / "bad.json").write_text('{"programs": []}')
  with pytest.raises(ValueError, match="programs"):
    budgets.load_budgets(str(tmp_path / "bad.json"))


# ---------------------------------------------------------------------------
# Seeded regressions: a widened decode state, a doctored number.
# ---------------------------------------------------------------------------

def _seeded_decode(dtype) -> targets.RunTarget:
  """A toy decode step whose state dominates the footprint, written in
  place."""
  w = torch.randn(64, 64, generator=torch.Generator().manual_seed(0))
  state = {"s": torch.zeros(256, 64, dtype=dtype)}

  def step():
    s2 = (state["s"].float() @ w).to(dtype)
    state["s"].copy_(s2)
    return s2.sum(-1), state
  out, walk, log = targets.run_program(step, [w], keep_trace=True)
  return targets.RunTarget(
      "seeded", "test", "jnp", "float", "decode", walk.result, log, {},
      None, "cpu", cost=hlo_cost.analyze_walk(walk.result.trace),
      live=liveness.estimate(walk.result, walk, outputs=out,
                             inputs=(w, state), donated=state))


def test_widened_state_trips_memory_budget_red():
  narrow = budgets.program_ledger(_seeded_decode(torch.bfloat16))
  committed = {"seeded|jnp|float|decode": narrow}
  wide = budgets.program_ledger(_seeded_decode(torch.float32))
  assert wide["input_bytes"] > narrow["input_bytes"]
  assert wide["credited_bytes"] == wide["donated_bytes"] == 256 * 64 * 4
  f, _ = budgets.diff_program(
      dict(config="seeded", policy="jnp", quant="float",
           program="decode"), wide, committed)
  assert "over-budget:input_bytes" in {x.key for x in f}
  assert {x.check for x in f} <= {"cost_budget", "memory_budget"}
  assert any(x.check == "memory_budget" for x in f)


def test_doctored_committed_number_trips_cost_budget_red():
  t = _seeded_decode(torch.float32)
  ledger = budgets.program_ledger(t)
  doctored = dict(ledger, hbm_bytes=int(ledger["hbm_bytes"] * 0.8))
  f, _ = budgets.diff_program(t.coord, ledger,
                              {"seeded|jnp|float|decode": doctored})
  assert [x.key for x in f] == ["over-budget:hbm_bytes"]
  assert f[0].check == "cost_budget"
  inflated = dict(ledger, hbm_bytes=int(ledger["hbm_bytes"] * 1.25))
  f2, w2 = budgets.diff_program(t.coord, ledger,
                                {"seeded|jnp|float|decode": inflated})
  assert f2 == []
  assert [x["metric"] for x in w2] == ["hbm_bytes"]


@pytest.mark.parametrize("config", targets.DEFAULT_CONFIGS)
def test_compression_ledger_drift_free(config):
  ledger = compression.compression_ledger(config)
  assert compression.strictness_violations(ledger) == []
  committed = budgets.load_budgets()["compression"]
  assert budgets.diff_compression(config, ledger, committed) == []
  broken = json.loads(json.dumps(ledger))
  broken["variants"]["int8"]["param_bytes"] += 1
  keys = {f.key for f in budgets.diff_compression(config, broken,
                                                  committed)}
  assert "drift:int8:param_bytes" in keys


# ---------------------------------------------------------------------------
# The committed budgets.json, the default grid, the CLI.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def grid():
  """The whole default grid, walked once on the CPU and diffed against
  the committed budgets.json."""
  audit = budgets.BudgetAudit(budgets.load_budgets())
  for t in targets.iter_targets(device="cpu", ledgers=True):
    audit.add_target(t)
  return audit


def test_committed_budgets_green_on_the_default_grid(grid):
  assert grid.findings == [], [f.ident for f in grid.findings]
  assert grid.warnings == []
  assert set(grid.programs) == set(budgets.load_budgets()["programs"])
  assert len(grid.programs) == 61
  for key, led in grid.programs.items():
    if "|decode" in key or "|window" in key:
      # every decode state is written in place: all of it credited
      if not key.startswith("whisper-small"):
        assert led["credited_bytes"] == led["donated_bytes"] > 0, key
    assert led["dominant"] in ("compute", "memory", "collective")


def test_a_scoped_coordinate_is_green():
  audit = budgets.BudgetAudit(budgets.load_budgets())
  (target,) = list(targets.iter_targets(
      ["xlstm-350m"], ["jnp"], ["float"], ["decode"], device="cpu",
      ledgers=True))
  ledger = audit.add_target(target)
  assert audit.findings == [] and audit.warnings == []
  assert ledger["credited_bytes"] == ledger["donated_bytes"]


def _held(key: str) -> bool:
  config, policy, quant, program = key.split("|")
  return ((policy == "jnp" and program in ("decode", "window"))
          or (policy, quant, program) == ("-", "float", "train"))


#: The port's input_bytes against the reference's committed ones: each
#: difference named. The reference's jaxpr closes over constants (its
#: constvars): the RoPE tables of the attention families (two (16,) f32
#: arrays, 128 B) and, under JAX 0.4.37, 60 B in DS2's CTC loss, where the
#: port reads one scalar constant (`lift_fresh`, 4 B). The port's token
#: ids and positions are int64 (the reference's int32), and its DS2
#: frames f32 (the reference's are cfg.dtype, bf16).
def _input_delta(key: str) -> int:
  config, _, _, program = key.split("|")
  rope = -128 if config in ("qwen3-4b", "zamba2-7b", "whisper-small") \
      else 0
  if program == "train":
    return rope + (4 - 60 if config == "deepspeech2-wsj" else 0)
  rows = targets.BATCH * (1 if program == "decode" else targets.WINDOW)
  positions = targets.BATCH * (8 - 4)
  if config == "deepspeech2-wsj":
    frames = rows * 160 * (4 - 2)
    return frames + positions
  return rope + rows * (8 - 4) + positions


def test_the_reference_committed_numbers_cross_check(grid):
  """Against the reference's committed budgets.json: dot FLOPs of every
  jnp decode and window coordinate and of every train coordinate within
  the reference's own band (5%); input_bytes equal up to the named
  differences. The pallas coordinates are not held: the reference's
  interpret-mode Pallas pads to the TPU's (8, 128) tiles, the port does
  not (DS2's decode reads 1,504,256 there against 578,560). The prefill
  coordinates are compared but not held: the reference traces the
  engine's fused prefill, the port runs PROMPT_LEN decode steps."""
  with open(REFERENCE_BUDGETS) as f:
    ref = json.load(f)["programs"]
  held = sorted(k for k in ref if _held(k))
  assert len(held) == 5 * 2 * 2 + 5      # (decode, window) x quant; train
  for key in held:
    got, want = grid.programs[key], ref[key]
    rel = abs(got["dot_flops"] - want["dot_flops"]) / want["dot_flops"]
    assert rel <= budgets.TOLERANCES["dot_flops"], (key, got["dot_flops"],
                                                   want["dot_flops"])
    assert got["input_bytes"] - want["input_bytes"] == _input_delta(key), \
        (key, got["input_bytes"], want["input_bytes"])
  assert grid.programs["deepspeech2-wsj|jnp|float|decode"]["dot_flops"] \
      == ref["deepspeech2-wsj|jnp|float|decode"]["dot_flops"] == 578_560
  assert ref["deepspeech2-wsj|pallas|float|decode"]["dot_flops"] == \
      1_504_256


def test_budgets_cli_exit_codes(tmp_path, capsys):
  scoped = ["budgets", "--configs", "deepspeech2_wsj", "--device", "cpu",
            "--policies", "jnp", "--programs", "decode,train"]
  rep_path = str(tmp_path / "budgets_report.json")
  assert main(scoped + ["--report", rep_path]) == 0
  saved = json.loads(open(rep_path).read())
  assert saved["ok"] and saved["programs"] and saved["compression"]
  assert saved["findings"] == []
  # a copy whose hbm_bytes were lowered 20% turns it red
  doctored = budgets.load_budgets()
  for led in doctored["programs"].values():
    led["hbm_bytes"] *= 0.8
  path = str(tmp_path / "doctored.json")
  budgets.write_budgets(doctored, path)
  assert main(scoped + ["--budgets", path]) == 1
  assert "over-budget:hbm_bytes" in capsys.readouterr().out
  # the bootstrap state: an empty file is red, --update admits the run
  empty = str(tmp_path / "empty.json")
  assert main(scoped + ["--budgets", empty]) == 1
  assert "unbudgeted" in capsys.readouterr().out
  assert main(scoped + ["--budgets", empty, "--update"]) == 0
  assert main(scoped + ["--budgets", empty, "--shallow"]) == 0
