"""The port's training path against the reference's, at the DS2 smoke
config in f32: the step-0 loss and gradients, one AdamW step, a 6-step
two-stage run (trace norm, transition at step 3) started from a
checkpoint the reference's `Trainer` saved, checkpoints crossing between
the packages both ways, microbatching, and `Supervisor` recovery.

Tolerances: the step-0 loss within 1e-5 relative and each leaf's
gradient within 1e-4 relative in norm (f32 forward and backward, summed
in another order); AdamW params and moments within 1e-6; the two-stage
losses within 1e-3 relative of the reference's at every step (Adam
divides each gradient by its own scale, so the step-0 differences grow
a little each step); ranks and checkpoints exactly."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import path_arrays  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.checkpoint import CheckpointManager as JManager  # noqa: E402
from repro.core import compress as jcompress  # noqa: E402
from repro.core import schedule as jschedule  # noqa: E402
from repro.core import svd as jsvd  # noqa: E402
from repro.core import tracenorm as jtn  # noqa: E402
from repro.models import deepspeech as jds  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.training import TrainConfig as JTrainConfig  # noqa: E402
from repro.training import Trainer as JTrainer  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.checkpoint.manager import flatten, to_host  # noqa: E402
from repro_torch.core import compress, schedule, svd, tracenorm  # noqa: E402
from repro_torch.core.factored import (count_params,  # noqa: E402
                                       iter_factored_leaves, param_tree)
from repro_torch.data import speech  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime import FaultInjector, Supervisor  # noqa: E402
from repro_torch.training import TrainConfig, Trainer  # noqa: E402

STEPS, TRANSITION, BATCH = 6, 3, 8
LAMBDA = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
  """Torch on one thread: the suite runs files in parallel workers."""
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(n)


def jcfg():
  return jconfigs.get_smoke("deepspeech2-wsj").with_(dtype=jnp.float32)


def tcfg():
  return tconfigs.get_smoke("deepspeech2-wsj").with_(dtype=torch.float32)


def batches():
  dc = speech.SpeechDataConfig(vocab_size=32, feat_dim=80,
                               global_batch=BATCH, seed=0)
  return [speech.batch_at(dc, i) for i in range(STEPS)]


def port_trainer(ckpt_dir=None, **kw):
  sched = schedule.TwoStageSchedule(
      total_steps=STEPS, transition_step=TRANSITION,
      regularizer=tracenorm.RegularizerConfig(kind="trace", lambda_rec=LAMBDA,
                                              lambda_nonrec=LAMBDA),
      truncation=svd.TruncationSpec(variance_threshold=0.9))
  tc = TrainConfig(lr=schedule.cosine_schedule(1e-3, 0, STEPS),
                   checkpoint_dir=ckpt_dir, async_checkpoint=False, **kw)
  return Trainer(tcfg(), tc, schedule=sched, device="cpu",
                 plan=compress.FactorizationPlan(min_dim=32,
                                                 exclude=("*embed*",)))


def tree_np(tree) -> dict:
  """{path: np.ndarray} of a port checkpoint tree."""
  return {p: to_host(x)[0] for p, x in flatten(tree)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
  """Both trainers through the same 6 steps. The reference's Trainer
  saves step 0; the port's Trainer restores it and trains on; after 3
  steps (still stage 1) the port saves, and the reference restores that
  checkpoint into its own template."""
  ref_dir = str(tmp_path_factory.mktemp("ref_ckpt"))
  port_dir = str(tmp_path_factory.mktemp("port_ckpt"))
  jsched = jschedule.TwoStageSchedule(
      total_steps=STEPS, transition_step=TRANSITION,
      regularizer=jtn.RegularizerConfig(kind="trace", lambda_rec=LAMBDA,
                                        lambda_nonrec=LAMBDA),
      truncation=jsvd.TruncationSpec(variance_threshold=0.9))
  jtr = JTrainer(jcfg(), JTrainConfig(
      lr=jschedule.cosine_schedule(1e-3, 0, STEPS), checkpoint_dir=ref_dir,
      async_checkpoint=False), schedule=jsched,
      plan=jcompress.FactorizationPlan(min_dim=32, exclude=("*embed*",)))
  jtr.save(blocking=True)
  out = {"ref_step0": path_arrays(jtr.params), "batches": batches(),
         "ref_dir": ref_dir}

  # the reference's step-0 loss and gradients, regularizer on
  reg = jsched.regularizer

  def jloss(p, b):
    return jds.loss_fn(p, b, jcfg())[0] + jtn.regularization_loss(p, reg)
  b0 = {k: jnp.asarray(v) for k, v in out["batches"][0].items()}
  loss, grads = jax.jit(jax.value_and_grad(jloss))(jtr.params, b0)
  out["ref_loss0"], out["ref_grads0"] = float(loss), path_arrays(grads)

  ptr = port_trainer(port_dir)
  ptr.ckpt = CheckpointManager(ref_dir)
  ptr.restore()
  ptr.ckpt = CheckpointManager(port_dir)
  out["port_restored"] = tree_np(ptr.params)
  loss, metrics, grads = ptr._step_fn.grads_of(ptr.params, out["batches"][0])
  out["port_loss0"], out["port_metrics0"] = float(loss), metrics
  out["port_grads0"] = {k: g.numpy() for k, g in grads.items()}

  out["ref"], out["port"] = [], []
  for i, b in enumerate(out["batches"]):
    out["ref"].append(jtr.train_step(b))
    out["port"].append(ptr.train_step(b))
    if i == TRANSITION - 1:
      ptr.save(blocking=True)
      out["port_saved"] = tree_np({"params": ptr.params,
                                   "opt": ptr.opt_state})
      tree, extra = JManager(port_dir).restore(
          {"params": jtr.params, "opt": jtr.opt_state})
      out["ref_loaded"], out["ref_loaded_extra"] = path_arrays(tree), extra
  out["ref_ranks"] = {leaf.name: leaf.rank for leaf in
                      jcompress.iter_factored_leaves(jtr.params)}
  out["port_ranks"] = {leaf.name: leaf.rank
                       for leaf in iter_factored_leaves(ptr.params)}
  out["port_trainer"] = ptr
  return out


def test_port_restores_the_reference_checkpoint_bit_for_bit(runs):
  got = runs["port_restored"]
  want = {f"{k}": v for k, v in runs["ref_step0"].items()}
  assert sorted(got) == sorted(want)
  for k, v in want.items():
    np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_step0_loss_and_gradients_match_reference(runs):
  np.testing.assert_allclose(runs["port_loss0"], runs["ref_loss0"],
                             rtol=1e-5)
  assert runs["port_metrics0"]["reg"] > 0
  got, want = runs["port_grads0"], runs["ref_grads0"]
  assert sorted(got) == sorted(want) and len(got) == 21
  for k, g in want.items():
    rel = np.linalg.norm(got[k] - g) / max(np.linalg.norm(g), 1e-30)
    assert rel < 1e-4, (k, rel)


def test_two_stage_run_tracks_reference(runs):
  ref, port = runs["ref"], runs["port"]
  assert [m["stage"] for m in port] == [m["stage"] for m in ref] == \
      [1] * TRANSITION + [2] * (STEPS - TRANSITION)
  for r, p in zip(ref, port):
    np.testing.assert_allclose(p["loss"], r["loss"], rtol=1e-3)
    np.testing.assert_allclose(p["lr"], r["lr"], rtol=1e-6)
    assert np.isfinite(p["grad_norm"])
  assert runs["port_ranks"] == runs["ref_ranks"]
  assert all(r % 8 == 0 for r in runs["port_ranks"].values())


def test_reference_restores_the_port_checkpoint_bit_for_bit(runs):
  got, want = runs["ref_loaded"], runs["port_saved"]
  assert sorted(got) == sorted(want)
  for k, v in want.items():
    np.testing.assert_array_equal(got[k], v, err_msg=k)
  assert runs["ref_loaded_extra"] == {"step": TRANSITION, "stage": 1}


def test_a_stage2_checkpoint_restores_into_a_fresh_trainer(runs, tmp_path):
  """The structure comes from the stored shapes: a fresh (stage-1)
  trainer takes a stage-2 checkpoint, and then steps as the saver does."""
  ptr = runs["port_trainer"]
  ptr.ckpt = CheckpointManager(str(tmp_path))
  ptr.save(blocking=True)
  fresh = port_trainer(str(tmp_path))
  assert fresh.stage == 1
  fresh.restore()
  assert (fresh.step, fresh.stage) == (ptr.step, 2)
  want = tree_np({"params": ptr.params, "opt": ptr.opt_state})
  got = tree_np({"params": fresh.params, "opt": fresh.opt_state})
  assert sorted(got) == sorted(want)
  for k in want:
    np.testing.assert_array_equal(got[k], want[k], err_msg=k)
  b = runs["batches"][0]
  np.testing.assert_allclose(fresh.train_step(b)["loss"],
                             ptr.train_step(b)["loss"], rtol=0)


def test_adamw_step_matches_reference():
  rng = np.random.RandomState(0)
  shapes = {"a/w": (6, 5), "a/bias": (5,), "conv": (3, 2, 1, 4)}
  p = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
  g = {k: rng.randn(*s).astype(np.float32) * 3 for k, s in shapes.items()}
  cfg = dict(weight_decay=0.1, max_grad_norm=1.0)
  jp = {k: jnp.asarray(v) for k, v in p.items()}
  jst = jadamw.init(jp)
  tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
  tst = adamw.init(tp)
  for step in range(3):
    gs = {k: v * (step + 1) for k, v in g.items()}
    jp, jst, jm = jadamw.apply(jp, {k: jnp.asarray(v) for k, v in gs.items()},
                               jst, jnp.float32(1e-2), jadamw.AdamWConfig(**cfg))
    tp, tst, tm = adamw.apply(tp, {k: torch.from_numpy(v) for k, v in
                                   gs.items()}, tst, 1e-2,
                              adamw.AdamWConfig(**cfg))
  assert tst.step == int(jst.step) == 3
  np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                             rtol=1e-6)
  for k in shapes:
    for got, want in ((tp[k], jp[k]), (tst.m[k], jst.m[k]),
                      (tst.v[k], jst.v[k])):
      assert got.dtype == torch.float32
      np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                 err_msg=k)


def test_bf16_checkpoints_cross_load_both_ways(tmp_path):
  """bf16 leaves go to disk as their uint16 view and "bfloat16": each
  package restores the other's bit for bit."""
  bits = np.random.RandomState(0).randint(0, 2 ** 16, size=(3, 5)).astype(
      np.uint16)
  bits[(bits & 0x7F80) == 0x7F80] = 0x3F80      # no NaN/inf patterns
  w16 = torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)
  CheckpointManager(str(tmp_path / "port")).save(
      1, {"params": {"w": w16}, "opt": adamw.AdamState(7, {}, {})})
  tree, _ = JManager(str(tmp_path / "port")).restore(
      {"params": {"w": jnp.zeros((3, 5), jnp.bfloat16)},
       "opt": {"step": jnp.zeros((), jnp.int32)}})
  assert tree["params"]["w"].dtype == jnp.bfloat16
  np.testing.assert_array_equal(
      np.asarray(tree["params"]["w"]).view(np.uint16), bits)
  assert int(tree["opt"]["step"]) == 7
  JManager(str(tmp_path / "ref")).save(2, {"params": {"w": tree["params"]["w"]}})
  back, _ = CheckpointManager(str(tmp_path / "ref")).restore(
      {"params": {"w": torch.zeros(3, 5, dtype=torch.bfloat16)}})
  assert back["params"]["w"].dtype == torch.bfloat16
  assert torch.equal(back["params"]["w"].view(torch.int16),
                     w16.view(torch.int16))


def test_adamw_decays_matrices_only_and_keeps_f32_moments():
  p = {"w": torch.ones(3, 3, dtype=torch.bfloat16),
       "b": torch.ones(3, dtype=torch.bfloat16)}
  st = adamw.init(p)
  assert all(m.dtype == torch.float32 for m in st.m.values())
  zero = {k: torch.zeros_like(v) for k, v in p.items()}
  adamw.apply(p, zero, st, 0.5, adamw.AdamWConfig(weight_decay=0.5))
  assert float(p["w"][0, 0]) == 0.75 and float(p["b"][0]) == 1.0
  from repro_torch.optim import make_optimizer
  assert make_optimizer("adamw") == (adamw.init, adamw.apply)
  with pytest.raises(NotImplementedError, match="Distribution"):
    make_optimizer("q_adam")


def test_microbatches_match_full_batch():
  """k = 2 microbatches average to the full batch's loss and gradients."""
  b = batches()[0]
  t1, t2 = port_trainer(), port_trainer(microbatches=2)
  l1, _, g1 = t1._step_fn.grads_of(t1.params, b)
  l2, m2, g2 = t2._step_fn.grads_of(t2.params, b)
  np.testing.assert_allclose(float(l1), float(l2), rtol=1e-5)
  assert set(m2) == {"ctc", "reg"}
  for k in g1:
    assert g2[k].dtype == torch.float32
    torch.testing.assert_close(g2[k], g1[k].float(), rtol=1e-4, atol=1e-6)


def test_supervisor_recovers_from_an_injected_fault(tmp_path):
  """A fault at step 4 (stage 2): the supervisor restores the latest
  checkpoint (step 2, stage 1), and the replay through the stateless
  batches crosses the transition again and ends where an unfaulted run
  ends."""
  bs = batches()
  clean = port_trainer()
  for b in bs:
    clean.train_step(b)
  tr = port_trainer(str(tmp_path), checkpoint_every=2)
  sup = Supervisor(restore=tr.restore,
                   injector=FaultInjector(fail_at={4: True}), max_retries=2)
  while tr.step < STEPS:
    sup.run_step(tr.step, lambda: tr.train_step(bs[tr.step]))
  assert len(sup.events.failures) == 1 and len(sup.events.recoveries) == 1
  assert tr.stage == 2
  assert [m["step"] for m in tr.metrics_history] == [0, 1, 2, 3, 4, 5]
  assert tr.metrics_history[-1]["loss"] == clean.metrics_history[-1]["loss"]
  assert count_params(tr.params) == count_params(clean.params)


def test_supervisor_gives_up_and_flags_stragglers():
  calls = {"n": 0}

  def always_fails():
    calls["n"] += 1
    raise RuntimeError("hard failure")
  sup = Supervisor(restore=lambda: None, max_retries=2)
  with pytest.raises(RuntimeError):
    sup.run_step(0, always_fails)
  assert calls["n"] == 3
  slow = Supervisor(restore=lambda: None, straggler_factor=5.0,
                    injector=FaultInjector(delays={6: 0.2}))
  for i in range(7):
    slow.run_step(i, lambda: sum(range(1000)))
  assert [s[0] for s in slow.events.stragglers] == [6]


def test_checkpoint_manager_layout_async_gc_and_errors(tmp_path):
  mgr = CheckpointManager(str(tmp_path), keep=2)
  tree = {"params": {"a/w": torch.arange(6, dtype=torch.bfloat16).view(2, 3),
                     "b": torch.ones(4)},
          "opt": adamw.AdamState(step=5, m={"x": torch.zeros(2)}, v={})}
  for step in (1, 2, 3):
    mgr.save(step, tree, extra={"step": step}, blocking=step != 2)
    tree["params"]["b"].add_(1.0)      # the async copy was taken already
  mgr.wait()
  assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
  man = mgr.manifest(2)
  assert man["leaves"]["params/a/w"] == {
      "file": "params_a_w.npy", "dtype": "bfloat16", "shape": [2, 3]}
  assert man["leaves"]["opt/step"]["dtype"] == "int32"
  back, extra = mgr.restore(tree, step=2)
  assert extra == {"step": 2} and back["opt"].step == 5
  assert back["params"]["a/w"].dtype == torch.bfloat16
  torch.testing.assert_close(back["params"]["b"], torch.full((4,), 2.0))
  with pytest.raises(KeyError, match="missing leaf"):
    mgr.restore({"params": {"c": torch.ones(1)}})
  with pytest.raises(ValueError, match="shape mismatch"):
    mgr.restore({"params": {"b": torch.ones(5)}})
  with pytest.warns(UserWarning, match="NOT restored"):
    mgr.restore({"params": {"b": torch.ones(4)}})


def test_params_tree_keys_are_reference_paths(runs):
  keys = set(param_tree(runs["port_trainer"].params))
  assert "grus/gru0/rec/u" in keys and "conv1" in keys
  assert keys == {k for k in runs["ref_grads0"]}


def test_bridge_reads_checkpoints_and_round_trips_bf16(runs):
  """`load_checkpoint` builds the model stored in the reference's
  checkpoint directory; `to_reference` hands a model back as
  path-keyed arrays that `from_reference` rebuilds bit for bit (bf16 as
  its uint16 view)."""
  model = bridge.load_checkpoint(runs["ref_dir"], tcfg(), step=0,
                                 device="cpu")
  arrays = bridge.to_reference(model)
  assert sorted(arrays) == sorted(runs["ref_step0"])
  for k, v in runs["ref_step0"].items():
    np.testing.assert_array_equal(arrays[k], v, err_msg=k)
  half = tcfg().with_(dtype=torch.bfloat16)
  m16 = bridge.from_reference(arrays, half, device="cpu")
  m16 = m16.to(torch.bfloat16)
  dtypes = {k: "bfloat16" for k, x in flatten(m16)
            if x.dtype == torch.bfloat16}
  assert dtypes["conv1"] == "bfloat16"
  back = bridge.from_reference(bridge.to_reference(m16), half,
                               dtypes=dtypes, device="cpu")
  for (k, a), (_, b) in zip(m16.state_dict().items(),
                            back.state_dict().items()):
    assert a.dtype == b.dtype and torch.equal(a, b), k


def test_loss_decreases_and_the_l2_baseline_trains():
  """A few steps on one batch lower the loss (the update goes downhill);
  the paper's l2 baseline (unfactored, no schedule) reports its penalty."""
  b = batches()[0]
  tr = Trainer(tcfg(), TrainConfig(lr=3e-3), device="cpu")
  first = tr.train_step(b)["loss"]
  for _ in range(7):
    last = tr.train_step(b)["loss"]
  assert last < first - 1.0, (first, last)
  l2 = Trainer(tcfg(), TrainConfig(lr=1e-3, regularizer=tracenorm.
                                   RegularizerConfig(kind="l2", lambda_rec=1e-4,
                                                     lambda_nonrec=1e-4)),
               device="cpu")
  assert not any(leaf.is_factored for leaf in iter_factored_leaves(l2.params))
  m = l2.train_step(b)
  assert m["reg"] > 0 and m["stage"] == 0


def test_quantized_model_checkpoint_roundtrips_bit_identical(tmp_path):
  """A PTQ'd model (int8 weights and f32 scales as buffers) is a
  deployable checkpoint: it round-trips bit for bit."""
  from repro_torch.models.deepspeech import init_model
  from repro_torch.quant import quantize_params
  q = quantize_params(init_model(tcfg(), device="cpu",
                                 generator=torch.Generator().manual_seed(1)))
  mgr = CheckpointManager(str(tmp_path))
  mgr.save(0, {"params": q})
  assert mgr.manifest()["leaves"]["params/fc/w_q"]["dtype"] == "int8"
  back, _ = mgr.restore({"params": q})
  for (k, a), (_, b) in zip(q.state_dict().items(),
                            back["params"].state_dict().items()):
    assert a.dtype == b.dtype and torch.equal(a, b), k
