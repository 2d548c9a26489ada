"""The DeepSeek family's two-stage training against the reference's, on
the CPU at the `deepseek-v2-lite` SMOKE config in f32: a 6-step run
(trace norm on every GEMM of at least 32 wide, the expert stacks
included; transition at step 3) started from a checkpoint the
reference's `Trainer` saved, its stage-2 checkpoint loaded back, and the
trained tree served. (`loss_fn` and its gradients, and `launch/train.py`,
are in `test_torch_deepseek_loss.py`.)

Tolerances: the losses and cross-entropies within 1e-3 relative at every
step (as `test_torch_lm_training.py`: Adam divides each gradient by its
own scale, so the step-0 differences grow a little each step); the MoE
aux loss within 1e-5 in stage 1 and 1e-2 in stage 2 (it counts discrete
routes, and after the truncated SVDs a near-tie may flip); ranks and
checkpoints exactly. Routes are continuous draws
with no exact ties (see `test_torch_deepseek.py`).
"""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_parity import path_arrays, reference_tree  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.core import compress as jcompress  # noqa: E402
from repro.core import schedule as jschedule  # noqa: E402
from repro.core import svd as jsvd  # noqa: E402
from repro.core import tracenorm as jtn  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.training import TrainConfig as JTrainConfig  # noqa: E402
from repro.training import Trainer as JTrainer  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.checkpoint.manager import flatten, to_host  # noqa: E402
from repro_torch.core import compress, schedule, svd, tracenorm  # noqa: E402
from repro_torch.core.factored import (frozen,  # noqa: E402
                                       iter_factored_leaves)
from repro_torch.data import lm  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serving import LMEngine  # noqa: E402
from repro_torch.training import TrainConfig, Trainer  # noqa: E402

STEPS, TRANSITION, BATCH, SEQ = 6, 3, 4, 32
LAMBDA = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
  """Torch on one thread: the suite runs files in parallel workers."""
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(n)


def jcfg(arch):
  return jconfigs.get_smoke(arch).with_(dtype=jnp.float32)


def tcfg(arch):
  return tconfigs.get_smoke(arch).with_(dtype=torch.float32)


def data_cfg(seed=0):
  return lm.LMDataConfig(vocab_size=512, seq_len=SEQ, global_batch=BATCH,
                         seed=seed)


def tree_np(tree) -> dict:
  return {p: to_host(x)[0] for p, x in flatten(tree)}


# ----------------------------------------------------------------------------
# The two-stage recipe from the reference's own checkpoint.
# ----------------------------------------------------------------------------

ARCH = "deepseek-v2-lite"


def port_trainer(ckpt_dir=None):
  sched = schedule.TwoStageSchedule(
      total_steps=STEPS, transition_step=TRANSITION,
      regularizer=tracenorm.RegularizerConfig(kind="trace", lambda_rec=LAMBDA,
                                              lambda_nonrec=LAMBDA),
      truncation=svd.TruncationSpec(variance_threshold=0.9))
  tc = TrainConfig(lr=schedule.cosine_schedule(1e-3, 0, STEPS),
                   checkpoint_dir=ckpt_dir, async_checkpoint=False)
  return Trainer(tcfg(ARCH), tc, schedule=sched, device="cpu",
                 plan=compress.FactorizationPlan(min_dim=32,
                                                 exclude=("*embed*",)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
  """Both trainers through the same 6 steps: the reference's Trainer
  saves step 0, the port's Trainer restores it and trains on, and saves
  at the end, which the bridge loads back into the reference's paths."""
  ref_dir = str(tmp_path_factory.mktemp("ref_ckpt"))
  port_dir = str(tmp_path_factory.mktemp("port_ckpt"))
  jsched = jschedule.TwoStageSchedule(
      total_steps=STEPS, transition_step=TRANSITION,
      regularizer=jtn.RegularizerConfig(kind="trace", lambda_rec=LAMBDA,
                                        lambda_nonrec=LAMBDA),
      truncation=jsvd.TruncationSpec(variance_threshold=0.9))
  # the reference's Trainer draws its dense model from the port's seeded
  # weights (`reference_tree`: no JAX init is run, which eagerly costs
  # ~10 s alone and far more beside the suite's other workers), then
  # factors it (stage 1) with its own SVDs and saves step 0
  start = reference_tree(
      transformer.init_lm(tcfg(ARCH), device="cpu",
                          generator=torch.Generator().manual_seed(0)),
      lambda k: jtf.init_lm(k, jcfg(ARCH)))
  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(jtf, "init_lm", lambda key, cfg: start)
    jtr = JTrainer(jcfg(ARCH), JTrainConfig(
        lr=jschedule.cosine_schedule(1e-3, 0, STEPS), checkpoint_dir=ref_dir,
        async_checkpoint=False), schedule=jsched,
        plan=jcompress.FactorizationPlan(min_dim=32, exclude=("*embed*",)))
  jtr.save(blocking=True)
  out = {"ref_step0": path_arrays(jtr.params)}
  ptr = port_trainer(port_dir)
  ptr.ckpt = CheckpointManager(ref_dir)
  ptr.restore()
  ptr.ckpt = CheckpointManager(port_dir)
  out["port_restored"] = tree_np(ptr.params)
  out["ref"], out["port"] = [], []
  for i in range(STEPS):
    b = lm.batch_at(data_cfg(), i)
    out["ref"].append(jtr.train_step(b))
    out["port"].append(ptr.train_step(b))
  ptr.save(blocking=True)
  out["port_final"] = tree_np(ptr.params)
  out["port_loaded"] = tree_np(bridge.load_checkpoint(port_dir, tcfg(ARCH),
                                                      device="cpu"))
  out["ref_ranks"] = {leaf.name: leaf.rank for leaf in
                      jcompress.iter_factored_leaves(jtr.params)}
  out["port_ranks"] = {leaf.name: leaf.rank
                       for leaf in iter_factored_leaves(ptr.params)}
  out["port_params"] = ptr.params
  return out


def test_port_restores_the_reference_checkpoint_bit_for_bit(runs):
  """The stage-1 tree: factored expert stacks (L, E, m, r), the raw
  router, MLA's factored leaves."""
  got, want = runs["port_restored"], runs["ref_step0"]
  assert sorted(got) == sorted(want)
  assert {"moe_layers/moe/router", "moe_layers/moe/w_gate/u",
          "dense_layers/attn/w_uk/u"} <= set(got)
  assert got["moe_layers/moe/w_gate/u"].shape == (2, 8, 128, 64)
  for k, v in want.items():
    np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_two_stage_run_tracks_reference(runs):
  ref, port = runs["ref"], runs["port"]
  assert [m["stage"] for m in port] == [m["stage"] for m in ref] == \
      [1] * TRANSITION + [2] * (STEPS - TRANSITION)
  for r, p in zip(ref, port):
    for k in ("loss", "xent"):
      np.testing.assert_allclose(p[k], r[k], rtol=1e-3, err_msg=k)
    # the aux loss counts each token's primary route: from the same
    # stage-1 weights it agrees as the loss does; after the transition
    # the two packages' SVDs (LAPACK, torch) differ in the last bits, a
    # near-tie may flip, and each flip moves it by E (p_a - p_b) / T
    np.testing.assert_allclose(p["moe_aux"], r["moe_aux"],
                               rtol=1e-5 if p["stage"] == 1 else 1e-2)
    assert np.isfinite(p["grad_norm"])
  assert runs["port_ranks"] == runs["ref_ranks"]
  assert all(r % 8 == 0 for r in runs["port_ranks"].values())
  assert "layers/expert_gate" in runs["port_ranks"]


def test_trained_checkpoint_loads_and_serves(runs):
  """The stage-2 checkpoint loads through the bridge bit for bit, and
  the trained (factored) tree decodes: expert stacks multiplied out per
  use, w_uk / w_uv absorbed as products."""
  got, want = runs["port_loaded"], runs["port_final"]
  assert sorted(got) == sorted(want)
  for k, v in want.items():
    np.testing.assert_array_equal(got[k], v, err_msg=k)
  params = frozen(copy.deepcopy(runs["port_params"]))
  eng = LMEngine(tcfg(ARCH), params, batch_size=2, max_len=16,
                 device="cpu")
  res = eng.generate(np.array([[3, 4, 5], [6, 7, 8]]), steps=4)
  assert res.tokens.shape == (2, 4)
