"""The port's transformer training path against the reference's, on the
CPU at the `qwen3-4b` SMOKE config (2 layers, d 128, qk-norm) in f32:
the synthetic LM stream (`data/lm.py`) bit for bit, `loss_fn` and its
gradients under each remat policy, the per-layer views across training
steps, a 6-step two-stage run (trace norm, transition at step 3) started
from a checkpoint the reference's `Trainer` saved, checkpoints crossing
between the packages both ways, and `launch/train.py` end to end.

Tolerances: the loss within 1e-5 relative and each leaf's gradient
within 1e-4 relative in norm (f32 forward and backward, summed in
another order); the two-stage losses within 1e-3 relative of the
reference's at every step (as `tests/test_torch_training.py` for DS2:
Adam divides each gradient by its own scale, so the step-0 differences
grow a little each step); batches, ranks and checkpoints exactly."""
import copy
import json

import numpy as np
from threadpoolctl import threadpool_limits
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
from repro.data import lm as jlm  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.training import TrainConfig as JTrainConfig  # noqa: E402
from repro.training import Trainer as JTrainer  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.checkpoint.manager import flatten, to_host  # noqa: E402
from repro_torch.core import compress, schedule, svd, tracenorm  # noqa: E402
from repro_torch.core.factored import (iter_factored_leaves,  # noqa: E402
                                       param_tree, trainable)
from repro_torch.data import lm  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.training import TrainConfig, Trainer  # noqa: E402
from repro_torch.training.trainer import make_train_step  # noqa: E402

ARCH = "qwen3-4b"
STEPS, TRANSITION, BATCH, SEQ = 6, 3, 4, 32
LAMBDA = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
  """Torch and the BLAS pools on one thread: the suite runs files in
  parallel workers, where spinning pool threads slow every worker."""
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  with threadpool_limits(limits=1):   # the BLAS pools of host SVDs
    yield
  torch.set_num_threads(n)


def jcfg():
  return jconfigs.get_smoke(ARCH).with_(dtype=jnp.float32)


def tcfg(**kw):
  return tconfigs.get_smoke(ARCH).with_(dtype=torch.float32, **kw)


def data_cfg(seed=0):
  return lm.LMDataConfig(vocab_size=512, seq_len=SEQ, global_batch=BATCH,
                         seed=seed)


def plan():
  return compress.FactorizationPlan(min_dim=32, exclude=("*embed*",))


def port_trainer(ckpt_dir=None):
  sched = schedule.TwoStageSchedule(
      total_steps=STEPS, transition_step=TRANSITION,
      regularizer=tracenorm.RegularizerConfig(kind="trace", lambda_rec=LAMBDA,
                                              lambda_nonrec=LAMBDA),
      truncation=svd.TruncationSpec(variance_threshold=0.9))
  tc = TrainConfig(lr=schedule.cosine_schedule(1e-3, 0, STEPS),
                   checkpoint_dir=ckpt_dir, async_checkpoint=False)
  return Trainer(tcfg(), tc, schedule=sched, plan=plan(), device="cpu")


def tree_np(tree) -> dict:
  return {p: to_host(x)[0] for p, x in flatten(tree)}


# ----------------------------------------------------------------------------
# Data.
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("seed,step", [(0, 0), (0, 5), (3, 17)])
def test_batch_at_is_bit_equal_to_reference(seed, step):
  want = jlm.batch_at(jlm.LMDataConfig(vocab_size=512, seq_len=SEQ,
                                       global_batch=BATCH, seed=seed), step)
  got = lm.batch_at(data_cfg(seed), step)
  assert sorted(got) == sorted(want) == ["targets", "tokens"]
  for k in want:
    assert got[k].dtype == np.int32
    np.testing.assert_array_equal(got[k], want[k])
  np.testing.assert_array_equal(got["targets"][:, :-1], got["tokens"][:, 1:])
  streamed = lm.stream(data_cfg(seed), start_step=step)
  np.testing.assert_array_equal(next(streamed)["tokens"], want["tokens"])


def test_shard_batch_places_int64_tensors():
  batch = lm.batch_at(data_cfg(), 1)
  placed = lm.shard_batch(batch, "cpu")
  for k, v in batch.items():
    assert placed[k].dtype == torch.int64 and placed[k].device.type == "cpu"
    np.testing.assert_array_equal(placed[k].numpy(), v)


# ----------------------------------------------------------------------------
# The loss and its gradients.
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_grads():
  """The reference's params, loss and gradients on one batch."""
  jp = jtf.init_lm(jax.random.PRNGKey(0), jcfg())
  batch = lm.batch_at(data_cfg(), 0)

  def loss(p):
    return jtf.loss_fn(p, {k: jnp.asarray(v) for k, v in batch.items()},
                       jcfg())[0]
  value, grads = jax.jit(jax.value_and_grad(loss))(jp)
  return jp, batch, float(value), path_arrays(grads)


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_loss_and_gradients_match_reference(reference_grads, remat):
  """The port's loss_fn and autograd against jax.value_and_grad of the
  reference's, at each remat policy (the reference's smoke config has
  none; a checkpointed layer must give the same gradients)."""
  jp, batch, want_loss, want_grads = reference_grads
  cfg = tcfg(remat=remat)
  params = trainable(bridge.from_reference(path_arrays(jp), cfg,
                                           device="cpu"))
  loss, metrics = transformer.loss_fn(params, batch, cfg)
  assert float(metrics["moe_aux"]) == 0.0 and metrics["xent"] is loss
  np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-5)
  tree = param_tree(params)
  grads = dict(zip(tree, torch.autograd.grad(loss, list(tree.values()))))
  assert sorted(grads) == sorted(want_grads)
  for k, g in want_grads.items():
    rel = np.linalg.norm(grads[k].numpy() - g) / max(np.linalg.norm(g), 1e-30)
    assert rel < 1e-4, (k, rel)


def test_layer_views_carry_each_steps_graph(reference_grads):
  """`LayerStack.layers()` under autograd: fresh views on every call,
  each reaching the stacked leaves, so two AdamW steps with no
  regularizer (where a leaf reached only through a stale or detached
  view would get no gradient) give every leaf a nonzero gradient both
  times; frozen serving keeps its views."""
  jp = reference_grads[0]
  cfg = tcfg()
  params = trainable(bridge.from_reference(path_arrays(jp), cfg,
                                           device="cpu"))
  stack = params.dense_layers
  assert stack.layers() is not stack.layers()
  assert stack.layers()[1]["attn"]["wq"].w.grad_fn is not None
  with torch.no_grad():
    assert stack.layers() is stack.layers()
  opt_init, step_fn = make_train_step(
      cfg, TrainConfig(lr=1e-3), reg=tracenorm.RegularizerConfig())
  opt = opt_init(params)
  losses = []
  for i in range(2):
    batch = lm.shard_batch(lm.batch_at(data_cfg(), i), "cpu")
    _, _, grads = step_fn.grads_of(params, batch)
    assert all(float(g.abs().max()) > 0 for g in grads.values()), \
        [k for k, g in grads.items() if not float(g.abs().max())]
    params, opt, metrics = step_fn(params, opt, batch, i)
    losses.append(float(metrics["loss"]))
  assert all(np.isfinite(losses))
  served = copy.deepcopy(params)
  for p in served.parameters():
    p.requires_grad_(False)
  views = served.dense_layers.layers()
  assert served.dense_layers.layers() is views


# ----------------------------------------------------------------------------
# The two-stage recipe from the reference's own checkpoint.
# ----------------------------------------------------------------------------

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
  batches = [lm.batch_at(data_cfg(), i) for i in range(STEPS)]
  out = {"ref_step0": path_arrays(jtr.params), "ref_dir": ref_dir}
  ptr = port_trainer(port_dir)
  ptr.ckpt = CheckpointManager(ref_dir)
  ptr.restore()
  ptr.ckpt = CheckpointManager(port_dir)
  out["port_restored"] = tree_np(ptr.params)
  out["ref"], out["port"] = [], []
  for i, b in enumerate(batches):
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
  return out


def test_port_restores_the_reference_checkpoint_bit_for_bit(runs):
  got, want = runs["port_restored"], runs["ref_step0"]
  assert sorted(got) == sorted(want)
  assert "dense_layers/attn/q_norm" in got and \
      "dense_layers/attn/wq/u" in got
  for k, v in want.items():
    np.testing.assert_array_equal(got[k], v, err_msg=k)
  loaded = tree_np(bridge.load_checkpoint(runs["ref_dir"], tcfg(), step=0,
                                          device="cpu"))
  assert sorted(loaded) == sorted(want)
  for k, v in want.items():
    np.testing.assert_array_equal(loaded[k], v, err_msg=k)


def test_two_stage_run_tracks_reference(runs):
  ref, port = runs["ref"], runs["port"]
  assert [m["stage"] for m in port] == [m["stage"] for m in ref] == \
      [1] * TRANSITION + [2] * (STEPS - TRANSITION)
  for r, p in zip(ref, port):
    np.testing.assert_allclose(p["loss"], r["loss"], rtol=1e-3)
    np.testing.assert_allclose(p["lr"], r["lr"], rtol=1e-6)
    assert np.isfinite(p["grad_norm"])
  assert runs["port_ranks"] == runs["ref_ranks"]
  assert len(runs["port_ranks"]) == 8          # 7 stacked GEMMs + the head
  assert all(r % 8 == 0 for r in runs["port_ranks"].values())


def test_reference_restores_the_port_checkpoint_bit_for_bit(runs):
  got, want = runs["ref_loaded"], runs["port_saved"]
  assert sorted(got) == sorted(want)
  for k, v in want.items():
    np.testing.assert_array_equal(got[k], v, err_msg=k)
  assert runs["ref_loaded_extra"] == {"step": TRANSITION, "stage": 1}


# ----------------------------------------------------------------------------
# The entry point.
# ----------------------------------------------------------------------------

def test_launch_train_runs_both_stages(capsys):
  """`launch.train --arch qwen3-4b --device cpu --two-stage` end to end:
  loss lines for both stages, the trace-norm diagnostics, a finite final
  loss."""
  out = train_cli.main(["--arch", ARCH, "--device", "cpu", "--steps", "4",
                        "--batch", "4", "--seq", "16", "--two-stage",
                        "--transition", "2"])
  text = capsys.readouterr().out
  assert "stage 1" in text and "stage 2" in text
  assert "trace-norm diagnostics" in text and "rank90=" in text
  assert json.loads(text.strip().splitlines()[-1]) == out
  assert np.isfinite(out["final_loss"])
